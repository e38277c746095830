"""Routing and the fingerprint read paths around the Dash kernels.

Routing is the shared MoE-style dispatcher: ``group_ranks``/``route_lanes``
group items by segment into (groups, capacity) lane planes with a stable
sort, which is what keeps the segment-parallel write engine sequentially
consistent. ``route_writes`` carries full key/value lanes for that engine
over the segments the batch touches; ``route_queries`` builds the
reference's (S, C) read lanes.

``probe_direct`` is the default large-batch read: every query is a lane of
the fingerprint kernel (``probe.fingerprint_probe``) addressed by its own
segment id, then keys are compared only on fingerprint hits (the paper's
"amortized one key load") and the stash rows by a dense compare.
``probe_routed`` runs the same stages over the (S, C) routed lanes and
scatters results back, as the reference's TPU path does.
"""
from __future__ import annotations

import torch

from repro_torch.core import engine, layout
from repro_torch.core.layout import DashConfig, DashState, u32, word
from . import probe as probe_kernel
from .hashmix import bulk_hash

#: the kernel masks its ragged edge, so no BLOCK padding is needed here
bulk_hash_padded = bulk_hash


# ---------------------------------------------------------------------------
# shared MoE-style dispatcher
# ---------------------------------------------------------------------------

def group_ranks(group_ids):
    """Rank of each item within its group, preserving input order (stable
    argsort + run-start cummax: O(Q log Q) whatever the number of groups)."""
    n = group_ids.shape[0]
    idx = torch.arange(n, device=group_ids.device)
    if n == 0:
        return idx
    order = torch.argsort(group_ids, stable=True)
    sorted_ids = group_ids[order]
    is_start = torch.ones(n, dtype=torch.bool, device=idx.device)
    is_start[1:] = sorted_ids[1:] != sorted_ids[:-1]
    run_start = torch.cummax(torch.where(is_start, idx, 0), 0).values
    rank = torch.empty_like(idx)
    rank[order] = idx - run_start
    return rank


def route_lanes(group_ids, payloads, num_groups: int, capacity: int, fills):
    """Scatter per-item payloads into (num_groups, capacity) lane planes.

    Items past ``capacity`` in their group (or outside [0, num_groups)) go
    to trash slots past the end of the flat buffer, one per item, which are
    dropped: no two items store to one element (duplicate stores are
    nondeterministic on CUDA). Returns (planes, src, keep): ``src`` maps
    lanes back to batch positions (-1 = empty), ``keep[i]`` is True iff item
    i received a lane."""
    n = group_ids.shape[0]
    gids = group_ids.long()
    rank = group_ranks(gids)
    keep = (rank < capacity) & (gids >= 0) & (gids < num_groups)
    lanes = num_groups * capacity
    items = torch.arange(n, device=gids.device)
    dst = torch.where(keep, gids * capacity + rank, lanes + items)
    outs = []
    for p, fill in zip(payloads, fills):
        flat = torch.full((lanes + n,) + tuple(p.shape[1:]), fill, dtype=p.dtype,
                          device=p.device)
        flat[dst] = p
        outs.append(flat[:lanes].reshape((num_groups, capacity) + tuple(p.shape[1:])))
    src = torch.full((lanes + n,), -1, dtype=torch.int64, device=gids.device)
    src[dst] = items
    return outs, src[:lanes].reshape(num_groups, capacity), keep


def locate_batch(cfg: DashConfig, mode: str, state: DashState, h1):
    """Vectorized (seg, bucket) addressing — one copy of the EH/LH rules."""
    return engine.locate(cfg, mode, state, h1)


def route_queries(cfg: DashConfig, state: DashState, keys_hi, keys_lo,
                  capacity: int, mode: str = "eh"):
    """Group a query batch by segment with fixed capacity. Returns (q_fp,
    q_b, q_pb, q_src, keep): (S, C) int32 planes; q_src maps back to batch
    positions (-1 = empty lane); ``keep`` is False for capacity-dropped
    queries."""
    h1, _, fp = bulk_hash(keys_hi, keys_lo)
    seg, b = locate_batch(cfg, mode, state, h1)
    pb = (b + 1) & (cfg.num_buckets - 1)
    (q_fp, q_b, q_pb), q_src, keep = route_lanes(
        seg, (fp, b.int(), pb.int()), cfg.max_segments, capacity, (0, -1, -1))
    return q_fp, q_b, q_pb, q_src, keep


# ---------------------------------------------------------------------------
# fingerprint read paths
# ---------------------------------------------------------------------------

def _verify(cfg: DashConfig, state: DashState, seg, bx, bits, hi, lo):
    """(ok, value as u32 int64) from the fingerprint candidates ``bits`` of
    bucket ``bx``: key compares only on candidate slots."""
    safe_b = bx.long().clamp(0, cfg.buckets_total - 1)
    slots = torch.arange(cfg.num_slots, device=bits.device)
    cand = ((bits.long()[:, None] >> slots) & 1) == 1
    m = (cand & (state.key_hi[seg, safe_b] == hi[:, None])
         & (state.key_lo[seg, safe_b] == lo[:, None]))
    val = torch.where(m, u32(state.val[seg, safe_b]), 0).amax(-1)
    return m.any(-1), val


def _stash_hits(cfg: DashConfig, state: DashState, seg, hi, lo, q_fp, live):
    """Dense compare of every lane against its segment's stash rows.
    Alloc-bitmap gating subsumes the stash_active check: a never-activated
    stash bucket has no allocated slots."""
    NB, ns, SL = cfg.num_buckets, cfg.num_stash, cfg.num_slots
    rows = slice(NB, NB + ns)
    slots = torch.arange(SL, device=seg.device)
    alloc = layout.meta_alloc(state.meta[seg, rows])              # (N, ns)
    m = ((alloc[..., None] >> slots) & 1) == 1                    # (N, ns, SL)
    m = (m & (state.key_hi[seg, rows] == hi[:, None, None])
         & (state.key_lo[seg, rows] == lo[:, None, None]) & live[:, None, None])
    if cfg.use_fingerprints:
        m = m & (state.fp[seg, rows, :SL].long() == q_fp.long()[:, None, None])
    val = torch.where(m, u32(state.val[seg, rows]), 0).amax((1, 2))
    return m.any((1, 2)), val


def _probe_lanes(cfg: DashConfig, state: DashState, seg, q_fp, q_b, q_pb,
                 hi, lo, live):
    """Kernel bitmaps -> key verify -> stash compare for flat lanes."""
    bits_b, bits_pb, _, _ = probe_kernel.fingerprint_probe(
        state.fp, state.meta, seg.int(), q_fp, q_b, q_pb)
    ok_b, val_b = _verify(cfg, state, seg, q_b, bits_b, hi, lo)
    ok_p, val_p = _verify(cfg, state, seg, q_pb, bits_pb, hi, lo)
    ok = ok_b | ok_p
    val = torch.where(ok_b, val_b, val_p)
    if cfg.num_stash > 0:
        ok_s, val_s = _stash_hits(cfg, state, seg, hi, lo, q_fp, live)
        val = torch.where(ok, val, val_s)
        ok = ok | ok_s
    return ok, val


def probe_direct(cfg: DashConfig, state: DashState, keys_hi, keys_lo,
                 mode: str = "eh"):
    """Batched search through the fingerprint kernel, one lane per query
    addressed by its own segment (no routing, no capacity overflow).
    Returns (found, values as int32 words). Requires inline keys,
    fingerprints and a <=2 bucket window (``engine.pallas_search_eligible``)."""
    h1, _, fp = bulk_hash(keys_hi, keys_lo)
    seg, b = locate_batch(cfg, mode, state, h1)
    pb = (b + 1) & (cfg.num_buckets - 1)
    live = torch.ones(seg.shape, dtype=torch.bool, device=seg.device)
    ok, val = _probe_lanes(cfg, state, seg, fp, b.int(), pb.int(),
                           keys_hi, keys_lo, live)
    return ok, word(val)


def probe_routed(cfg: DashConfig, state: DashState, keys_hi, keys_lo,
                 capacity: int = 256, mode: str = "eh"):
    """Batched search over (S, C) routed lanes, flattened with each lane's
    row as its segment id. Returns (found, values, keep) aligned with the
    batch; ``keep=False`` lanes overflowed the routing capacity and come
    back not found."""
    q_fp, q_b, q_pb, q_src, keep = route_queries(cfg, state, keys_hi, keys_lo,
                                                 capacity, mode)
    S, C = q_fp.shape
    seg = torch.arange(S, device=q_fp.device)[:, None].expand(S, C).reshape(-1)
    src = q_src.reshape(-1)
    live = src >= 0
    safe = src.clamp(min=0)
    hi = torch.where(live, keys_hi[safe], 0)
    lo = torch.where(live, keys_lo[safe], 0)
    ok, val = _probe_lanes(cfg, state, seg, q_fp.reshape(-1), q_b.reshape(-1),
                           q_pb.reshape(-1), hi, lo, live)
    n = keys_hi.shape[0]
    found = torch.zeros(n, dtype=torch.int64, device=ok.device)
    found.scatter_reduce_(0, safe, (ok & live).long(), "amax")
    values = torch.zeros(n, dtype=torch.int64, device=ok.device)
    values.scatter_reduce_(0, safe, torch.where(ok & live, val, 0), "amax")
    return found.bool(), word(values), keep


def route_writes(cfg: DashConfig, mode: str, state: DashState,
                 payload, capacity: int, with_hints: bool = False):
    """Route a write batch by segment, carrying full key/value lanes.

    ``payload`` is (keys_hi, keys_lo, vals, valid). Lanes are grouped over
    the G segments the batch touches (the reference groups over all S; the
    empty rows change nothing): returns ``(lanes, src, keep)`` where lanes
    holds (G, C) planes hi/lo/val/b/h1/h2/valid plus ``seg``, each row's
    segment id.

    With ``with_hints=True`` the lanes also go through the fingerprint
    kernel, returning per-lane (match_bits_b, match_bits_pb, free_slots_b,
    free_slots_pb) as a fourth value. The free-slot bitmaps are advisory
    (pre-batch state): for host-side admission and capacity prechecks,
    never for the commit decision."""
    keys_hi, keys_lo, vals, valid = payload
    S = cfg.max_segments
    h1, h2, _ = bulk_hash(keys_hi, keys_lo)
    seg, b = locate_batch(cfg, mode, state, h1)
    live = (seg >= 0) & (seg < S)
    segs, gid = torch.unique(torch.where(live, seg, S), return_inverse=True)
    G = int((segs < S).sum())                 # unique() sorts: S comes last
    planes, src, keep = route_lanes(
        gid, (keys_hi, keys_lo, vals, b, h1, h2, valid & live),
        G, capacity, (0, 0, 0, 0, 0, 0, False))
    lanes = dict(zip(("hi", "lo", "val", "b", "h1", "h2", "valid"), planes))
    lanes["seg"] = segs[:G, None].expand(G, capacity)
    if not with_hints:
        return lanes, src, keep
    q_fp = (lanes["h2"] & 0xFF).reshape(-1)
    q_b = torch.where(lanes["valid"], lanes["b"], -1).int().reshape(-1)
    q_pb = torch.where(lanes["valid"], (lanes["b"] + 1) & (cfg.num_buckets - 1),
                       -1).int().reshape(-1)
    hints = probe_kernel.fingerprint_probe(
        state.fp, state.meta, lanes["seg"].int().reshape(-1), q_fp.contiguous(),
        q_b, q_pb)
    return lanes, src, keep, tuple(h.reshape(G, capacity) for h in hints)
