"""Crash simulation + instant/lazy recovery (paper Sec. 4.8).

Instant recovery is a *constant* amount of work: read the ``clean`` marker
and possibly bump the global version ``V``. All real work (clearing locks,
removing duplicate records left by in-flight displacements, rebuilding the
non-persisted overflow metadata, finishing or rolling back SMOs) is
deferred to the first access of each segment (``seg_version != V``).

The crash simulator leaves exactly the artifact classes the paper's
recovery handles: locked buckets, duplicated records (displacement step 1
done, step 2 lost), wiped overflow metadata, and an in-flight SMO (a
segment SPLITTING with a NEW side-linked neighbor).

Ported from ``repro.core.recovery``. The reference recovers one segment at
a time; here steps 1-3 run over a set of segments at once
(:func:`recover_segments`, lanes = segments), while step 4 (finishing or
rolling back an in-flight SMO) runs first on the host for the few
SPLITTING/NEW segments, in the reference's visit order.
:func:`recover_segment_host` keeps the per-segment form. Planes are updated
IN PLACE.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from . import bucket as bk
from . import engine, hashing, layout
from .layout import (SEG_NEW, SEG_NORMAL, SEG_SPLITTING, DashConfig, DashState,
                     u32, word)

#: segments per dedupe compare: (chunk, NB, SL, SL) booleans at a time
DEDUPE_CHUNK = 4096


# ---------------------------------------------------------------------------
# instant restart — O(1) regardless of table size
# ---------------------------------------------------------------------------

def instant_restart(state: DashState):
    """Read ``clean``; bump ``V`` if the shutdown was dirty. Nothing else:
    one scalar read, no whole-plane op. The restarted state is marked
    dirty-serving (``clean=False``)."""
    t0 = time.perf_counter()
    was_clean = bool(state.clean)
    state.clean.fill_(False)
    if not was_clean:
        state.gver.copy_(word(u32(state.gver) + 1))
    return state, {"clean": was_clean, "seconds": time.perf_counter() - t0}


# ---------------------------------------------------------------------------
# lazy recovery: steps 1-3 over a set of segments
# ---------------------------------------------------------------------------

def _dedupe_meta(cfg: DashConfig, state: DashState, segs):
    """Step 2 for segments ``segs``: a displaced record can sit in adjacent
    buckets (b, b+1); the copy in b+1 goes. Meta words are repacked from
    the surviving alloc/membership bits."""
    NB, SL = cfg.num_buckets, cfg.num_slots
    nxt = (torch.arange(NB, device=segs.device) + 1) % NB
    slots = torch.arange(SL, device=segs.device)
    for c in range(0, segs.numel(), DEDUPE_CHUNK):
        s = segs[c:c + DEDUPE_CHUNK]
        hi, lo, meta = state.key_hi[s], state.key_lo[s], state.meta[s]
        alloc = ((layout.meta_alloc(meta)[..., None] >> slots) & 1) == 1   # (C, BT, SL)
        member = ((layout.meta_member(meta)[..., None] >> slots) & 1) == 1
        eq = ((hi[:, :NB, :, None] == hi[:, nxt, None, :])
              & (lo[:, :NB, :, None] == lo[:, nxt, None, :])
              & alloc[:, :NB, :, None] & alloc[:, nxt, None, :])
        dup = torch.zeros_like(alloc)
        dup[:, nxt] = eq.any(2)                   # dup in bucket nxt[b], slot j
        alloc, member = alloc & ~dup, member & ~dup
        state.meta[s] = layout.meta_pack((alloc.long() << slots).sum(-1),
                                         (member.long() << slots).sum(-1),
                                         alloc.sum(-1))


def _rebuild_overflow_meta(cfg: DashConfig, mode: str, state: DashState, segs):
    """Step 3 for segments ``segs``: zero ometa/ofp, then re-register every
    stash record in stash order (stash bucket, then slot) — the order
    decides which overflow-fingerprint slot a record takes. One step per
    stash slot, all segments at once; steps no segment uses are skipped."""
    NB, SL, NS = cfg.num_buckets, cfg.num_slots, cfg.num_stash
    state.ometa[segs] = 0
    state.ofp[segs] = 0
    if NS == 0:
        return
    slots = torch.arange(SL, device=segs.device)
    alloc = ((layout.meta_alloc(state.meta[segs, NB:])[..., None] >> slots) & 1) == 1
    h1, h2 = engine.record_hashes(cfg, state, state.key_hi[segs, NB:],
                                  state.key_lo[segs, NB:])          # (M, NS, SL)
    b = layout.bucket_index(cfg, h1) if mode == "eh" else layout.lh_bucket_index(cfg, h1)
    pb = (b + 1) & (NB - 1)
    fpv = hashing.fingerprint(h2)
    used = alloc.reshape(-1, NS * SL).any(0).tolist()
    for j in (j for j in range(NS * SL) if used[j]):
        s_j, sl = divmod(j, SL)
        a = alloc[:, s_j, sl]
        ok1 = bk.ofp_try_set(cfg, state, segs, b[:, s_j, sl], fpv[:, s_j, sl], s_j,
                             False, a)
        m2 = a & ~ok1
        ok2 = bk.ofp_try_set(cfg, state, segs, pb[:, s_j, sl], fpv[:, s_j, sl], s_j,
                             True, m2)
        bk.ovf_count_add(state, segs, b[:, s_j, sl], 1, m2 & ~ok2)


def recover_segments(cfg: DashConfig, mode: str, state: DashState, segs):
    """Steps 1-3 of Sec. 4.8 for the distinct segments ``segs``: clear lock
    bits, dedupe displaced records, rebuild overflow metadata; then mark
    them recovered. Segments are independent, so they run together.

    ``n_items`` stays put: crash duplicates were never counted, so removing
    them restores the meta counts to agree with the incrementally
    maintained total."""
    segs = torch.as_tensor(segs, dtype=torch.int64, device=state.dir.device).reshape(-1)
    if segs.numel() == 0:
        return state
    state.version[segs] = word((u32(state.version[segs]) & ~1) + 2)
    _dedupe_meta(cfg, state, segs)
    _rebuild_overflow_meta(cfg, mode, state, segs)
    state.seg_version[segs] = state.gver
    return state


def _continue_smo(cfg: DashConfig, mode: str, state: DashState, seg: int,
                  seg_state: np.ndarray, side: np.ndarray):
    """Step 4: finish or roll back an in-flight EH split touching ``seg``.
    A NEW segment is recovered from its SPLITTING source, which redoes the
    rehash (phase 2 with uniqueness checks, idempotent); a SPLITTING
    segment without a NEW neighbor rolls back. Returns (state, the segment
    whose steps 1-3 run next)."""
    from . import dash_eh
    if mode != "eh":
        return state, seg
    if seg_state[seg] == SEG_NEW:
        srcs = np.nonzero((side == seg) & (seg_state == SEG_SPLITTING))[0]
        if srcs.size:
            seg = int(srcs[0])
    if seg_state[seg] == SEG_SPLITTING:
        nbr = int(side[seg])
        if nbr >= 0 and seg_state[nbr] == SEG_NEW:
            state, ok = dash_eh.split_phase2(cfg, state, seg, nbr, True)
            if not ok:
                raise AssertionError("split redo failed to refit records")
        else:
            state.seg_state[seg] = SEG_NORMAL
            state.local_depth[seg] -= 1
    return state, seg


def recover_segment_host(cfg: DashConfig, mode: str, state: DashState, seg: int):
    """The per-segment form: step 4 orchestration, then steps 1-3."""
    state, seg = _continue_smo(cfg, mode, state, int(seg),
                               state.seg_state.cpu().numpy(),
                               state.side_link.cpu().numpy())
    return recover_segments(cfg, mode, state, [seg])


def _recover_list(cfg: DashConfig, mode: str, state: DashState, segs: list):
    """``recover_segment_host`` over ``segs`` in order, batched: a segment
    in an SMO state is handled at its turn (step 4, then its steps 1-3);
    every other segment's steps 1-3 run in one set at the end. That
    commutes: steps 1-3 touch only their own segment, and a segment found
    NORMAL at its turn is never rebuilt by a later step 4 (SMO states only
    return to NORMAL during recovery)."""
    if mode == "eh" and segs:
        seg_state = state.seg_state.cpu().numpy()
        if np.isin(seg_state[segs], (SEG_SPLITTING, SEG_NEW)).any():
            side = state.side_link.cpu().numpy()
            plain = []
            for seg in segs:
                if seg_state[seg] == SEG_NORMAL:
                    plain.append(seg)
                    continue
                state, src = _continue_smo(cfg, mode, state, seg, seg_state, side)
                state = recover_segments(cfg, mode, state, [src])
                seg_state = state.seg_state.cpu().numpy()
                side = state.side_link.cpu().numpy()
            segs = plain
    return recover_segments(cfg, mode, state, segs)


def recover_all(cfg: DashConfig, mode: str, state: DashState):
    """Eager full recovery of every allocated segment (the 'CCEH-style'
    contrast, and a way for tests to reach a known-good state)."""
    return _recover_list(cfg, mode, state, list(range(int(state.watermark))))


def dirty_touched_segments(state: DashState, touched) -> list:
    """Which of the ``touched`` segment ids (a tensor) still owe post-crash
    recovery (their ``seg_version`` lags the recovery generation)? Sorted."""
    touched = touched[touched >= 0].long()
    lag = state.seg_version[touched] != state.gver
    if not bool(lag.any()):
        return []
    return torch.unique(touched[lag]).tolist()


def lazy_recover_touched(cfg: DashConfig, mode: str, state: DashState,
                         touched, note=None):
    """Recover exactly the dirty segments among ``touched`` (Sec. 4.8:
    recovery work proportional to data *accessed*, not data stored).

    ``note(segs, affected)``, if given, is called once BEFORE the repair
    with the dirty segment ids and every segment id the repair may rewrite
    (those segments, their side-links, and any segment side-linked to
    them). Returns ``(state, recovered_ids)``."""
    dirty = dirty_touched_segments(state, touched)
    if not dirty:
        return state, []
    if note is not None:
        side = state.side_link.cpu().numpy()
        d = np.asarray(dirty)
        affected = np.union1d(np.union1d(d, side[d]), np.nonzero(np.isin(side, d))[0])
        note(dirty, affected[affected >= 0].tolist())
    return _recover_list(cfg, mode, state, dirty), dirty


# ---------------------------------------------------------------------------
# crash simulation (host-side numpy surgery on the planes)
# ---------------------------------------------------------------------------

def simulate_crash(cfg: DashConfig, mode: str, state: DashState,
                   rng: np.random.Generator, lock_frac: float = 0.05,
                   n_dups: int = 4, wipe_overflow: bool = True,
                   interrupt_smo: bool = False) -> DashState:
    """Leave crash artifacts in ``state`` (in place): held locks, records
    duplicated by half-done displacements, wiped overflow metadata and,
    for EH with pool room, an interrupted split (phase 1 only). Draws from
    ``rng`` in the reference's order, so one seed leaves the same
    artifacts in both packages."""
    from repro_torch import interop
    from . import dash_eh

    planes = interop.state_to_numpy(state)
    wm = int(planes["watermark"])
    NB, SL = cfg.num_buckets, cfg.num_slots

    version = planes["version"]
    n_lock = max(1, int(lock_frac * wm * cfg.buckets_total))
    segs = rng.integers(0, wm, n_lock)
    bks = rng.integers(0, cfg.buckets_total, n_lock)
    version[segs, bks] |= 1                     # locks left held

    fp, key_hi, key_lo = planes["fp"], planes["key_hi"], planes["key_lo"]
    val, meta = planes["val"], planes["meta"]
    made = 0
    for _ in range(n_dups * 20):
        if made >= n_dups:
            break
        s = int(rng.integers(0, wm))
        b = int(rng.integers(0, NB))
        alloc = int(meta[s, b]) & layout.SLOT_MASK
        occupied = [i for i in range(SL) if alloc >> i & 1]
        if not occupied:
            continue
        i = occupied[int(rng.integers(0, len(occupied)))]
        nb = (b + 1) % NB
        alloc_n = int(meta[s, nb]) & layout.SLOT_MASK
        free = [j for j in range(SL) if not (alloc_n >> j & 1)]
        if not free:
            continue
        j = free[0]
        # displacement step 1 done (copy to neighbor, membership set),
        # step 2 (delete from source) lost in the crash:
        key_hi[s, nb, j] = key_hi[s, b, i]
        key_lo[s, nb, j] = key_lo[s, b, i]
        val[s, nb, j] = val[s, b, i]
        fp[s, nb, j] = fp[s, b, i]
        m = int(meta[s, nb])
        alloc_n |= 1 << j
        memb = ((m >> layout.MEMBER_SHIFT) & layout.SLOT_MASK) | (1 << j)
        cnt = ((m >> layout.COUNT_SHIFT) & 0xF) + 1
        meta[s, nb] = (alloc_n | (memb << layout.MEMBER_SHIFT)
                       | (cnt << layout.COUNT_SHIFT))
        made += 1

    for name in ("version", "fp", "key_hi", "key_lo", "val", "meta"):
        a = planes[name]
        getattr(state, name).copy_(torch.from_numpy(
            a.view(np.int32) if a.dtype == np.uint32 else a))
    state.clean.fill_(False)
    if wipe_overflow:
        state.ometa.zero_()
        state.ofp.zero_()
    if interrupt_smo and mode == "eh" and wm < cfg.max_segments:
        depths = planes["local_depth"]
        candidates = [s for s in range(wm) if depths[s] < cfg.dir_depth_max]
        if candidates:
            victim = int(rng.choice(candidates))
            state, _ = dash_eh.split_phase1(cfg, state, victim)
    return state
