"""Dash-LH: linear hashing with Dash building blocks (paper Sec. 5).

Linear hashing always splits the segment at ``Next`` (not the overflowing
one). ``(level, Next)`` live packed in one 32-bit word; advancing the word
*is* the split's publish point, after which addressing routes re-hashed
keys with the next round's mask.

Stash chaining (Sec. 5.1): each segment owns ``num_stash`` preallocated
stash buckets of which ``stash_active[seg]`` are live; activating one
beyond the base ``lh_base_stash`` emits the split signal that the table
turns into a stride expansion at Next (``smo.bulk_split_next``).

Ported from ``repro.core.dash_lh``. Planes are updated IN PLACE.
"""
from __future__ import annotations

import torch

from . import engine, layout
from .dash_eh import _clear_segment, reinsert
from .layout import DashConfig, DashState, u32, word


def rehash_segment_scan(cfg: DashConfig, state: DashState, seg: int):
    """Scan rehash of one segment, the tail of ``split_next_scan`` and the
    fallback for a lane of a bulk expansion whose vectorized rebuild did
    not fit (the (level, Next) word is already advanced): extract the
    segment's records, clear it, re-insert every record through *current*
    LH addressing. ``n_items`` is restored (a rehash moves records). The
    whole cleared segment's version rows bump: rows a record moved OUT of
    change content without a bucket write. Returns (state, ok)."""
    n0 = state.n_items.clone()
    hi, lo, val, valid = engine.segment_records(cfg, state, seg)
    hi, lo, val = hi.clone(), lo.clone(), val.clone()
    h1, h2 = engine.record_hashes(cfg, state, hi, lo)
    _clear_segment(cfg, state, seg)
    state.version[seg] = word(u32(state.version[seg]) + 2)
    dseg = state.lh_dir[layout.lh_logical_segment(cfg, h1, state.lh_word)].long()
    fits = reinsert(cfg, state, dseg, layout.lh_bucket_index(cfg, h1), h2,
                    hi, lo, val, valid)
    state.n_items.copy_(n0)
    return state, fits


def split_next_scan(cfg: DashConfig, state: DashState):
    """Split the segment at Next with the per-record scan rehash and
    advance (level, Next); returns (state, ok). The reference path, kept
    for differential testing against the vectorized SMO engine."""
    level, nxt = (int(x) for x in layout.lh_level_next(state.lh_word))
    round_size = (1 << cfg.lh_base_log2) << level
    old_phys = int(state.lh_dir[nxt])
    new_phys = int(state.watermark)
    base = min(cfg.num_stash, cfg.lh_base_stash)

    # advance the packed word FIRST (the atomic publish of Sec. 5.3): from
    # now on, keys in the old logical bucket re-hash with the next round's mask
    wrap = nxt + 1 >= round_size
    state.lh_word.copy_(layout.lh_pack(torch.tensor(level + wrap),
                                       torch.tensor(0 if wrap else nxt + 1)))
    state.lh_dir[round_size + nxt] = new_phys
    state.watermark.add_(1)
    state.stash_active[old_phys] = base
    state.stash_active[new_phys] = base
    state.seg_version[new_phys] = state.gver

    state, fits = rehash_segment_scan(cfg, state, old_phys)
    state.n_splits.add_(1)
    return state, fits


def split_next(cfg: DashConfig, state: DashState):
    """Split the segment at Next through the vectorized SMO engine
    (``smo.bulk_split_next`` with a stride of 1); scan fallback for configs
    or packings the rebuild does not cover. Returns (state, ok)."""
    from . import smo
    if not smo.rebuild_eligible(cfg):
        return split_next_scan(cfg, state)
    state, ok, old_phys = smo.bulk_split_next(cfg, state, 1)
    if not bool(ok[0]):
        return rehash_segment_scan(cfg, state, int(old_phys[0]))
    return state, True


def lh_active_segments(cfg: DashConfig, state: DashState) -> int:
    """Number of live logical segments."""
    level, nxt = (int(x) for x in layout.lh_level_next(state.lh_word))
    return (1 << cfg.lh_base_log2) * (1 << level) + nxt


def hybrid_expansion_directory(n_segments: int, stride: int = 8,
                               first_array: int = 64, entry_bytes: int = 8):
    """Paper Sec. 5.2 hybrid expansion accounting: directory entries point
    to segment ARRAYS; after every ``stride`` fixed-size expansions the
    array size doubles. Returns (entries, directory_bytes, largest_array).

    With 16KB segments, a 64-segment first array and stride 4-8, TB-scale
    data is indexed by a sub-KB, L1-resident directory."""
    entries = 0
    covered = 0
    array_size = first_array
    while covered < n_segments:
        for _ in range(stride):
            entries += 1
            covered += array_size
            if covered >= n_segments:
                return entries, entries * entry_bytes, array_size
        array_size *= 2
    return entries, entries * entry_bytes, array_size
