"""Dash-EH: extendible hashing with Dash building blocks (paper Sec. 4).

Segment split is the paper's three-step SMO (Sec. 4.7) as two phases with
a crash-recoverable boundary between them:

  phase 1 (allocate + initialize + link): mark S SPLITTING, allocate N at
      the pool watermark, chain side links, set both local depths, mark N NEW.
  phase 2 (rehash + publish): redistribute records by the (ld+1)-th MSB,
      point the directory prefix range at N, clear SMO states.

A merge (the shrink SMO) is the inverse: a buddy pair's records rebuild
into the keeper, the victim's directory range points back at it and both
drop one depth level. Ported from ``repro.core.dash_eh``. Planes are
updated IN PLACE.
"""
from __future__ import annotations

import numpy as np
import torch

from . import engine, layout
from .layout import (DROPPED, NEED_SPLIT, SEG_NEW, SEG_NORMAL, SEG_SPLITTING,
                     DashConfig, DashState, u32, word)


def split_phase1(cfg: DashConfig, state: DashState, old_seg: int,
                 new_seg: int | None = None):
    """Allocate + initialize the new segment (default: the pool watermark);
    returns (state, new_seg)."""
    if new_seg is None:
        new_seg = int(state.watermark)
    ld = state.local_depth[old_seg].clone()
    state.seg_state[old_seg] = SEG_SPLITTING
    state.seg_state[new_seg] = SEG_NEW
    state.side_link[new_seg] = state.side_link[old_seg].clone()
    state.side_link[old_seg] = new_seg
    state.local_depth[old_seg] = ld + 1
    state.local_depth[new_seg] = ld + 1
    state.seg_version[new_seg] = state.gver
    state.stash_active[new_seg] = cfg.num_stash
    state.watermark.clamp_(min=new_seg + 1)
    return state, new_seg


def _clear_segment(cfg: DashConfig, state: DashState, seg: int):
    """Zero a segment's fingerprints and metadata words (its records become
    unreachable; the key planes keep their stale bytes, as in the reference)."""
    for plane in (state.fp, state.ofp, state.meta, state.ometa):
        plane[seg] = 0


def reinsert(cfg: DashConfig, state: DashState, seg, b, h2, hi, lo, val, valid,
             check_unique: bool = False) -> bool:
    """Insert records one by one into their destination segments ``seg``,
    in record order — the per-record scan of the reference SMOs. Records
    bound for different segments form independent sequences, stepped
    together one record per segment (``engine._segment_parallel``), which
    gives the sequential scan's result. Returns True iff every valid
    record fit."""
    from repro_torch.kernels import ops
    keep = valid.nonzero()[:, 0]
    if keep.numel() == 0:
        return True
    seg, b, h2, hi, lo, val = (x[keep] for x in (seg, b, h2, hi, lo, val))
    segs, gid = torch.unique(seg, return_inverse=True)
    G = segs.numel()
    cap = int(torch.bincount(gid).max())
    (l_hi, l_lo, l_val, l_h2, l_b, l_valid), _, _ = ops.route_lanes(
        gid, (hi, lo, val, h2, b, torch.ones_like(hi, dtype=torch.bool)), G, cap,
        (0, 0, 0, 0, 0, False))
    lanes = dict(hi=l_hi, lo=l_lo, val=l_val, h2=l_h2, b=l_b, valid=l_valid,
                 seg=segs[:, None].expand(G, cap))
    # pointer mode: records move with their heap handles; a uniqueness probe
    # compares against all-zero key words, as the reference's rehash does
    zero_words = torch.zeros((G, cfg.key_heap_words), dtype=torch.int32,
                             device=hi.device)
    (statuses,) = engine._segment_parallel(
        state, lanes,
        lambda st, ln: engine._insert_core(
            cfg, st, ln["seg"], ln["b"], ln["h2"], ln["hi"], ln["lo"],
            ln["val"], ln["valid"], check_unique=check_unique,
            q_words=zero_words, heap_append=False)[:1],
        (DROPPED,))
    return not bool((statuses == NEED_SPLIT).any())


def split_phase2_scan(cfg: DashConfig, state: DashState, old_seg: int,
                      new_seg: int, check_unique: bool = False):
    """Per-record rehash + directory publish: the reference SMO path, kept
    as the fallback for packings the vectorized rebuild does not fit.
    Records are re-inserted in slot order (:func:`reinsert`). Returns
    (state, all_refit)."""
    n0 = state.n_items.clone()             # splits move records: net zero
    ld_new = int(state.local_depth[old_seg])
    hi, lo, val, valid = engine.segment_records(cfg, state, old_seg)
    hi, lo, val = hi.clone(), lo.clone(), val.clone()
    h1, h2 = engine.record_hashes(cfg, state, hi, lo)
    move = ((u32(h1) >> (32 - ld_new)) & 1) == 1

    _clear_segment(cfg, state, old_seg)
    fits = reinsert(cfg, state, torch.where(move, new_seg, old_seg),
                    layout.bucket_index(cfg, h1), h2, hi, lo, val, valid,
                    check_unique)

    # directory publish: among entries owned by old_seg, the half whose
    # (ld+1)-th MSB is 1 now points at new_seg (contiguous under MSB indexing)
    idx = torch.arange(cfg.dir_size, device=hi.device)
    take = (state.dir == old_seg) & (((idx >> (cfg.dir_depth_max - ld_new)) & 1) == 1)
    state.dir[take] = new_seg

    gd = int(state.global_depth)
    state.global_depth.fill_(max(gd, ld_new))
    state.n_doublings.add_(int(ld_new > gd))
    state.n_splits.add_(1)
    for s in (old_seg, new_seg):
        state.seg_state[s] = SEG_NORMAL
        state.seg_version[s] = state.gver
        state.version[s] = word(u32(state.version[s]) + 2)
    state.n_items.copy_(n0)     # incremental accounting: a split never changes the count
    return state, fits


def split_phase2(cfg: DashConfig, state: DashState, old_seg: int, new_seg: int,
                 check_unique: bool = False):
    """Rehash + publish through the vectorized SMO engine; falls back to the
    scan rehash for packings the rebuild does not cover. Returns
    (state, all_refit)."""
    from . import smo
    if not smo.rebuild_eligible(cfg):
        return split_phase2_scan(cfg, state, old_seg, new_seg, check_unique)
    dev = state.dir.device
    old = torch.tensor([old_seg], dtype=torch.int32, device=dev)
    new = torch.tensor([new_seg], dtype=torch.int32, device=dev)
    state, ok = smo.bulk_split_phase2(cfg, state, old, new,
                                      torch.ones(1, dtype=torch.bool, device=dev),
                                      check_unique)
    if not bool(ok[0]):
        return split_phase2_scan(cfg, state, old_seg, new_seg, check_unique)
    return state, True


def split_segment(cfg: DashConfig, state: DashState, old_seg: int,
                  new_seg: int | None = None, impl: str = "rebuild"):
    """Full SMO = phase 1 + phase 2. ``impl="scan"`` forces the per-record
    reference rehash. Returns (state, all_refit)."""
    state, new_seg = split_phase1(cfg, state, old_seg, new_seg)
    phase2 = split_phase2_scan if impl == "scan" else split_phase2
    return phase2(cfg, state, old_seg, new_seg)


# ---------------------------------------------------------------------------
# merge (the shrink SMO of Sec. 4.7: "when the load factor drops below a
# threshold, segments can be merged to save space")
# ---------------------------------------------------------------------------

def merge_segments_scan(cfg: DashConfig, state: DashState, keep_seg: int,
                        victim_seg: int):
    """Per-record scan merge of ``victim`` into its buddy ``keep`` (same
    parent prefix, same local depth) — the reference path, kept as the
    fallback of the bulk merge. The caller guarantees the pair is a buddy
    pair and that the combined records fit. The victim's directory range
    points back at ``keep`` and the keeper drops one depth level — the
    inverse of a split. Returns (state, all_refit)."""
    n0 = state.n_items.clone()
    hi, lo, val, valid = engine.segment_records(cfg, state, victim_seg)
    hi, lo, val = hi.clone(), lo.clone(), val.clone()
    h1, h2 = engine.record_hashes(cfg, state, hi, lo)
    fits = reinsert(cfg, state, torch.full_like(h1, keep_seg, dtype=torch.int64),
                    layout.bucket_index(cfg, h1), h2, hi, lo, val, valid)
    _clear_segment(cfg, state, victim_seg)

    state.dir[state.dir == victim_seg] = keep_seg
    state.local_depth[keep_seg] -= 1
    state.side_link[keep_seg] = state.side_link[victim_seg].clone()
    state.seg_state[victim_seg] = SEG_NORMAL
    # both rebuilt segments bump: the cleared victim planes must be as
    # version-visible as the repacked keeper (COW dirtiness contract)
    for s in (keep_seg, victim_seg):
        state.version[s] = word(u32(state.version[s]) + 2)
    state.n_items.copy_(n0)     # a merge never changes the count
    return state, fits


def merge_segments(cfg: DashConfig, state: DashState, keep_seg: int,
                   victim_seg: int):
    """Merge through the vectorized SMO engine (one-pass rebuild of the
    combined record set); the scan merge is the fallback."""
    from . import smo
    if not smo.rebuild_eligible(cfg):
        return merge_segments_scan(cfg, state, keep_seg, victim_seg)
    dev = state.dir.device
    keep = torch.tensor([keep_seg], dtype=torch.int32, device=dev)
    victim = torch.tensor([victim_seg], dtype=torch.int32, device=dev)
    state, ok = smo.bulk_merge(cfg, state, keep, victim,
                               torch.ones(1, dtype=torch.bool, device=dev))
    if not bool(ok[0]):
        return merge_segments_scan(cfg, state, keep_seg, victim_seg)
    return state, True


def find_buddy(cfg: DashConfig, state: DashState, seg: int):
    """The buddy of ``seg``: the segment owning the sibling prefix at the
    same local depth (its directory range is adjacent), or None
    (``smo.find_buddy_pairs`` is the all-pairs version)."""
    dirv = state.dir.cpu().numpy()
    depths = state.local_depth.cpu().numpy()
    ld = int(depths[seg])
    if ld == 0:
        return None
    first = int(np.argmax(dirv == seg))
    if dirv[first] != seg:                   # seg owns no directory range
        return None
    prefix = first >> (cfg.dir_depth_max - ld)
    sib_first = (prefix ^ 1) << (cfg.dir_depth_max - ld)
    buddy = int(dirv[sib_first])
    if buddy == seg or int(depths[buddy]) != ld:
        return None
    return buddy
