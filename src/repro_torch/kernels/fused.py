"""Small-batch latency path: one read kernel per tick, merged-commit inserts.

``fused_search``
    Reads. ``fused_probe`` (``csrc/fused.cu``) walks each lane's target
    bucket, probing bucket and active stash rows in one launch and returns
    (found, value): route, fingerprint probe, key verify and value select
    fused. Each lane is addressed by its own segment id and the kernel
    reads the table's natural planes in place — no per-segment tiles.
    ``fused_probe_plain`` is the same function in PyTorch; the wrapper takes
    it for CPU tensors only. Configs outside the kernel's span take
    ``_fused_search_direct``, a one-gather dense compare.

``fused_insert``
    Writes. Segment routing (``ops.route_writes``), then per lane step the
    dense uniqueness probe and the Alg. 1/2 decision applied as masked
    single-element scatters (``engine._insert_core``), updating the planes
    in place.

Differential contract: both are identical to the reference engines
(``batching="vmap"`` reads, ``batching="scan"`` writes) for every config
they accept. The dense stash probe checks every *active* stash row instead
of walking overflow-fingerprint indications, so it relies on the metadata
invariant (every stash record is ofp-indicated or covered by a nonzero
overflow count) that insert/delete maintain.

With fingerprints off the read follows the per-key search: slots are
compared on alloc and key only. (The reference's routed TPU path,
``repro.kernels.fused._fused_search_routed``, zeroes the fp plane but still
feeds real fingerprint bytes, and so misses nearly every key in that
config.)
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core import engine, hashing, layout
from repro_torch.core import bucket as bk
from repro_torch.core.layout import (DROPPED, SLOT_MASK, DashConfig, DashState,
                                     u32, word)
from . import _build, ops
from .hashmix import bulk_hash

#: kernel launches made by :func:`fused_probe`
LAUNCHES = 0


# ---------------------------------------------------------------------------
# eligibility
# ---------------------------------------------------------------------------

def fused_search_eligible(cfg: DashConfig) -> bool:
    """Some fused read path covers every ported config."""
    return True


def fused_kernel_eligible(cfg: DashConfig) -> bool:
    """Configs the read kernel spans: inline keys and a 2-bucket window
    (balanced pairs, or probe_len <= 2)."""
    return not cfg.pointer_mode and (cfg.use_balanced or cfg.probe_len <= 2)


def fused_insert_eligible(cfg: DashConfig) -> bool:
    """Balanced two-bucket inserts (with or without displacement / stash /
    overflow metadata / fingerprints); tiny tables where the b-1/b+2
    displacement neighbors alias are excluded."""
    return cfg.use_balanced and not cfg.pointer_mode and cfg.num_buckets >= 4


# ---------------------------------------------------------------------------
# fused read — direct-addressed dense lowering (configs outside the kernel)
# ---------------------------------------------------------------------------

def _candidate_columns(cfg: DashConfig, b):
    """(Q, W) bucket rows per query: the probe window in order, then every
    stash row — the same visit order as ``probe_in_segment``."""
    NB = cfg.num_buckets
    cols = [(b + w) & (NB - 1) for w in range(cfg.probe_window)]
    cols += [torch.full_like(b, NB + s) for s in range(cfg.num_stash)]
    return torch.stack(cols, 1)


def _fused_search_direct(cfg: DashConfig, mode: str, state: DashState,
                         keys_hi, keys_lo, words=None):
    """One gather of all candidate rows per query + one dense compare.
    Pointer mode folds the (Q, W) key ``words`` into the identity pair and
    compares the heap rows the candidate slots point at."""
    SL, ns, window = cfg.num_slots, cfg.num_stash, cfg.probe_window
    if cfg.pointer_mode:
        keys_hi, keys_lo = hashing.key_identity_from_words(words)
    h1, h2, _ = bulk_hash(keys_hi, keys_lo)
    fpv = hashing.fingerprint(h2)
    seg, b = ops.locate_batch(cfg, mode, state, h1)
    bx = _candidate_columns(cfg, b)                      # (Q, W)
    segb = seg[:, None]
    slots = torch.arange(SL, device=seg.device)
    alloc = layout.meta_alloc(state.meta[segb, bx])      # (Q, W)
    m = ((alloc[..., None] >> slots) & 1) == 1           # (Q, W, SL)
    if cfg.use_fingerprints:
        m = m & (state.fp[segb, bx, :SL] == fpv[:, None, None])
    m = m & (state.key_hi[segb, bx] == keys_hi[:, None, None])
    if cfg.pointer_mode:
        rows = bk.heap_rows(cfg, state, state.key_lo[segb, bx])   # (Q, W, SL, KW)
        m = m & (rows == words[:, None, None, :]).all(-1)
    else:
        m = m & (state.key_lo[segb, bx] == keys_lo[:, None, None])
    if ns:
        active = state.stash_active[seg]
        col_ok = torch.cat(
            [torch.ones((seg.shape[0], window), dtype=torch.bool, device=seg.device),
             torch.arange(ns, device=seg.device)[None, :] < active[:, None]], 1)
        m = m & col_ok[..., None]
    okw, slot = bk.first_true(m)                             # first matching slot
    vw = torch.gather(state.val[segb, bx], -1, slot[..., None])[..., 0]
    found = torch.zeros(seg.shape, dtype=torch.bool, device=seg.device)
    value = torch.zeros(seg.shape, dtype=torch.int32, device=seg.device)
    for w in range(bx.shape[1]):                         # window/stash priority
        value = torch.where(okw[:, w] & ~found, vw[:, w], value)
        found = found | okw[:, w]
    return found, value


# ---------------------------------------------------------------------------
# fused read — the kernel
# ---------------------------------------------------------------------------

def fused_probe_plain(fp, meta, key_hi, key_lo, val, stash_active,
                      q_seg, q_fp, q_b, q_pb, q_hi, q_lo, *, nb: int, ns: int,
                      use_fp: bool):
    """(found int32, value int32 word) per (N,) lane: the lowest allocated
    slot matching (fp when ``use_fp``, key_hi, key_lo) in the target
    bucket, then the probing bucket, then stash rows below
    ``stash_active[seg]``. Lanes with ``q_b < 0`` (or a segment id outside
    [0, S)) are padding; a negative ``q_pb`` reads row 0, as the
    reference's clipped gather does."""
    S, BT, SL = key_hi.shape
    seg_ok = (q_seg >= 0) & (q_seg < S)
    s = q_seg.clamp(0, S - 1).long()
    live = (q_b >= 0) & seg_ok
    slots = torch.arange(SL, device=key_hi.device)
    active = stash_active[s].clamp(max=ns)

    def hits(row, gate):
        r = row.long().clamp(0, BT - 1)
        alloc = u32(meta[s, r]) & SLOT_MASK
        m = (((alloc[:, None] >> slots) & 1) == 1) & (key_hi[s, r] == q_hi[:, None]) & (
            key_lo[s, r] == q_lo[:, None])
        if use_fp:
            m = m & (fp[s, r, :SL].long() == q_fp.long()[:, None])
        ok, j = bk.first_true(m & (gate & live & (row < BT))[:, None])
        return ok, val[s, r, j]

    found = torch.zeros(s.shape, dtype=torch.bool, device=s.device)
    value = torch.zeros(s.shape, dtype=torch.int32, device=s.device)
    cands = [(q_b, True), (q_pb.clamp(min=0), True)]
    cands += [(torch.full_like(q_b, nb + i), i < active) for i in range(ns)]
    for row, gate in cands:
        ok, v = hits(row, gate)
        value = torch.where(ok & ~found, v, value)
        found = found | ok
    return found.to(torch.int32), value


class _Planes(ctypes.Structure):
    """The kernel's plane record (``FusedPlanes`` in ``csrc/fused.cu``)."""
    _fields_ = [("fp", ctypes.c_void_p), ("meta", ctypes.c_void_p),
                ("key_hi", ctypes.c_void_p), ("key_lo", ctypes.c_void_p),
                ("val", ctypes.c_void_p), ("stash_active", ctypes.c_void_p),
                ("num_segments", ctypes.c_longlong), ("bt", ctypes.c_int),
                ("sl", ctypes.c_int), ("nb", ctypes.c_int), ("ns", ctypes.c_int),
                ("use_fp", ctypes.c_int)]


_PLANES = (("fp", torch.uint8, 3), ("meta", torch.int32, 2),
           ("key_hi", torch.int32, 3), ("key_lo", torch.int32, 3),
           ("val", torch.int32, 3), ("stash_active", torch.int32, 1))


def _plane_key(planes):
    """Everything the plane checks read: pointer, shape, dtype, layout and
    device of each plane."""
    return tuple((t.data_ptr(), t.shape, t.dtype, t.is_contiguous(), t.device)
                 for t in planes)


@functools.lru_cache(maxsize=16)
def _checked_planes(key, nb: int, ns: int, use_fp: bool) -> _Planes:
    """Validate a plane set once (by its :func:`_plane_key`) and return the
    kernel's record of it; an edit of any plane's pointer, shape, dtype or
    layout gives a new key and a new check."""
    for (ptr, shape, dtype, contiguous, device), (name, want, ndim) in zip(key, _PLANES):
        if dtype != want or len(shape) != ndim:
            raise TypeError(f"{name}: expected {ndim}-d {want}, got {len(shape)}-d {dtype}")
        if not contiguous:
            raise ValueError(f"{name}: must be contiguous")
        if device != key[0][4]:
            raise ValueError(f"{name} on {device}, expected {key[0][4]}")
    S, BT, SL = key[2][1]
    if (key[0][1] != (S, BT, 16) or key[1][1] != (S, BT) or key[3][1] != key[2][1]
            or key[4][1] != key[2][1] or key[5][1] != (S,) or SL > 16
            or not 0 <= nb <= nb + ns <= BT):
        raise ValueError("fused_probe: plane shapes disagree")
    return _Planes(*(k[0] for k in key), S, BT, SL, nb, ns, int(use_fp))


def fused_probe(fp, meta, key_hi, key_lo, val, stash_active,
                q_seg, q_fp, q_b, q_pb, q_hi, q_lo, *, nb: int, ns: int,
                use_fp: bool):
    """The read kernel over the natural planes (fp (S, BT, 16) uint8; meta
    (S, BT), key_hi/key_lo/val (S, BT, SL) and stash_active (S,) int32) and
    (N,) int32 lanes; see :func:`fused_probe_plain`."""
    global LAUNCHES
    planes = _checked_planes(_plane_key((fp, meta, key_hi, key_lo, val, stash_active)),
                             nb, ns, use_fp)
    lanes = (q_seg, q_fp, q_b, q_pb, q_hi, q_lo)
    shape, device = q_seg.shape, fp.device
    if len(shape) != 1 or any(t.dtype != torch.int32 or t.shape != shape or t.device != device
                              or not t.is_contiguous() for t in lanes):
        _check_lanes(lanes, device)
    if device.type == "cpu":
        return fused_probe_plain(fp, meta, key_hi, key_lo, val, stash_active, *lanes,
                                 nb=nb, ns=ns, use_fp=use_fp)
    _build.require_cuda(fp)
    out = torch.empty((2, shape[0]), dtype=torch.int32, device=device)
    _build.check(_build.load().dash_fused_probe(
        ctypes.addressof(planes), *(t.data_ptr() for t in lanes), shape[0],
        out.data_ptr(), _build.stream(fp)), "fused_probe")
    LAUNCHES += 1
    return out[0], out[1]


def _check_lanes(lanes, device):
    """Raise, naming the first lane tensor the kernel cannot take."""
    names = ("q_seg", "q_fp", "q_b", "q_pb", "q_hi", "q_lo")
    _build.require(lanes[0], names[0], torch.int32, 1)
    for name, t in zip(names[1:], lanes[1:]):
        _build.require(t, name, torch.int32, 1, like=lanes[0])
    raise ValueError(f"lanes on {lanes[0].device}, planes on {device}")


def _probe_state(cfg: DashConfig, state: DashState, q_seg, q_fp, q_b, q_pb,
                 q_hi, q_lo):
    return fused_probe(state.fp, state.meta, state.key_hi, state.key_lo,
                       state.val, state.stash_active, q_seg, q_fp, q_b, q_pb,
                       q_hi, q_lo, nb=cfg.num_buckets, ns=cfg.num_stash,
                       use_fp=cfg.use_fingerprints)


def _fused_search_routed(cfg: DashConfig, mode: str, state: DashState,
                         keys_hi, keys_lo, capacity: int):
    """The reference's TPU read path: route queries to (S, C) lanes, run the
    kernel over them, scatter results back by max; capacity-overflow lanes
    fall back to ``_fused_search_direct``."""
    S, NB = cfg.max_segments, cfg.num_buckets
    h1, _, fp = bulk_hash(keys_hi, keys_lo)
    seg, b = ops.locate_batch(cfg, mode, state, h1)
    (q_fp, q_b, q_hi, q_lo, q_valid), src, keep = ops.route_lanes(
        seg, (fp, b.int(), keys_hi, keys_lo, seg >= 0), S, capacity,
        (0, -1, 0, 0, False))
    q_b = torch.where(q_valid, q_b, -1)
    q_pb = torch.where(q_valid, (q_b + 1) & (NB - 1), -1)
    q_seg = torch.arange(S, dtype=torch.int32, device=seg.device)[:, None]
    f, v = _probe_state(cfg, state, q_seg.expand(S, capacity).reshape(-1),
                        torch.where(q_valid, q_fp, -1).reshape(-1),
                        q_b.reshape(-1), q_pb.reshape(-1),
                        q_hi.reshape(-1), q_lo.reshape(-1))
    n = keys_hi.shape[0]
    srcf = src.reshape(-1)
    safe = srcf.clamp(min=0)
    found = torch.zeros(n, dtype=torch.int64, device=f.device)
    found.scatter_reduce_(0, safe, torch.where(srcf >= 0, f.long(), 0), "amax")
    val = torch.zeros(n, dtype=torch.int64, device=f.device)
    val.scatter_reduce_(0, safe, torch.where(srcf >= 0, u32(v), 0), "amax")
    d_found, d_val = _fused_search_direct(cfg, mode, state, keys_hi, keys_lo)
    return (torch.where(keep, found != 0, d_found),
            torch.where(keep, word(val), d_val))


def fused_search(cfg: DashConfig, mode: str, state: DashState,
                 keys_hi, keys_lo, words=None):
    """One-kernel batched lookup over direct-addressed lanes. Returns
    (found, values as int32 words), identical to
    ``engine.search_batch(batching="vmap")``. Configs outside the kernel
    (pointer mode: pass the (Q, W) key ``words``) take the dense lowering."""
    if not fused_kernel_eligible(cfg):
        return _fused_search_direct(cfg, mode, state, keys_hi, keys_lo, words)
    h1, _, fp = bulk_hash(keys_hi, keys_lo)
    seg, b = ops.locate_batch(cfg, mode, state, h1)
    pb = (b + 1) & (cfg.num_buckets - 1)
    f, v = _probe_state(cfg, state, seg.int(), fp, b.int(), pb.int(),
                        keys_hi, keys_lo)
    return f != 0, v


# ---------------------------------------------------------------------------
# fused insert — merged-commit write path
# ---------------------------------------------------------------------------

def _merged_insert_body(cfg: DashConfig, state: DashState, ln):
    """One lane step (one lane per segment): the dense window + active-stash
    uniqueness probe, then the Alg. 1/2 decision and its masked commit."""
    NB, SL = cfg.num_buckets, cfg.num_slots
    seg, b = ln["seg"], ln["b"]
    fpv = hashing.fingerprint(ln["h2"])
    slots = torch.arange(SL, device=seg.device)

    def probe_bucket(bx):
        cand = ((layout.meta_alloc(state.meta[seg, bx])[:, None] >> slots) & 1) == 1
        if cfg.use_fingerprints:
            cand = cand & (state.fp[seg, bx, :SL] == fpv[:, None])
        return (cand & (state.key_hi[seg, bx] == ln["hi"][:, None])
                & (state.key_lo[seg, bx] == ln["lo"][:, None])).any(-1)

    exists = probe_bucket(b) | probe_bucket((b + 1) & (NB - 1))
    active = state.stash_active[seg]
    for s in range(cfg.num_stash):
        exists = exists | (probe_bucket(NB + s) & (s < active))
    return engine._insert_core(cfg, state, seg, b, ln["h2"], ln["hi"], ln["lo"],
                               ln["val"], ln["valid"], exists=exists)


def fused_insert(cfg: DashConfig, mode: str, state: DashState,
                 keys_hi, keys_lo, vals, valid=None,
                 capacity: int | None = None):
    """Batch insert through the merged commit, in place. Returns (state,
    statuses, any_stash_activation) with the exact semantics of
    ``engine.insert_batch`` — the scan engine for configs outside
    ``fused_insert_eligible``."""
    n = keys_hi.shape[0]
    valid = engine._default_valid(keys_hi, valid)
    if not fused_insert_eligible(cfg):
        return engine.insert_batch(cfg, mode, state, keys_hi, keys_lo, vals,
                                   valid, batching="scan")
    cap = min(capacity or engine._pow2_at_least(n), engine._pow2_at_least(n))
    statuses, (acts,) = engine._routed(
        cfg, mode, state, (keys_hi, keys_lo, vals, valid), cap,
        lambda st, ln: _merged_insert_body(cfg, st, ln), (DROPPED, False))
    return state, statuses, acts.any()
