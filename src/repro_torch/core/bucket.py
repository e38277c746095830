"""Bucket-level primitives for Dash (probe / insert / displace / stash math).

The reference's helpers (``repro.core.bucket``) work on one ``(seg, b)``;
these take (L,) lane vectors of segment ids, buckets and slots and work on
all lanes at once. Reads return (L, ...) tensors. Writes update the state's
planes IN PLACE (the reference returns a new state and XLA reuses donated
buffers; here the caller owns the only copy) and take a ``mask`` of lanes
that really write: a masked-out lane stores back what its element already
held. The lanes of one call must address distinct elements — the engines
guarantee it by handing each call at most one lane per segment.

Per the paper's persistence discipline (Alg. 2) record slots are written
first and the packed metadata word last. Version discipline: EVERY mutation
of a bucket row — record slots, the packed metadata word, overflow
fingerprints, the packed overflow word — bumps that bucket's version word
by 2 (bit 0 stays the lock bit), so "content changed implies version
changed" holds for the snapshot verify and copy-on-write publish paths.
"""
from __future__ import annotations

import torch

from . import layout
from .layout import DashConfig, DashState, u32, word


def masked_set(plane, idx, value, mask):
    """``plane[idx] = value`` on the lanes where ``mask`` holds."""
    if mask is None:
        plane[idx] = value
    else:
        plane[idx] = torch.where(mask, value, plane[idx])


def first_true(m):
    """(any, index of the first True) along the last axis."""
    if m.shape[-1] == 0:
        z = torch.zeros(m.shape[:-1], dtype=torch.int64, device=m.device)
        return z.bool(), z
    return m.any(-1), m.to(torch.uint8).argmax(-1)


def _bits(bitmap, n: int):
    """(L, n) bool: bit j of each int64 bitmap."""
    ids = torch.arange(n, device=bitmap.device)
    return ((bitmap[:, None] >> ids) & 1) == 1


def slot_fp_matches(cfg: DashConfig, state: DashState, seg, b, fpv):
    """(L, SLOTS) bool — allocated slots whose fingerprint matches.

    With fingerprinting disabled every allocated slot is a candidate."""
    allocated = _bits(layout.meta_alloc(state.meta[seg, b]), cfg.num_slots)
    if not cfg.use_fingerprints:
        return allocated
    return allocated & (state.fp[seg, b, :cfg.num_slots] == fpv[:, None])


def heap_rows(cfg: DashConfig, state: DashState, handles):
    """Pointer mode: the key-heap rows (..., W) the handles point at."""
    return state.key_heap[u32(handles) % max(cfg.key_heap_size, 1)]


def keys_equal(cfg: DashConfig, state: DashState, seg, b, q_hi, q_lo,
               q_words=None):
    """(L, SLOTS) bool — full key comparison for every slot. Inline mode
    compares the (hi, lo) pair; pointer mode treats ``key_lo`` as a
    key-heap handle and compares the heap row with the lane's ``q_words``
    (L, W) — the 'dereference the pointer' path of paper Sec. 4.5."""
    s_hi = state.key_hi[seg, b]
    if not cfg.pointer_mode:
        return (s_hi == q_hi[:, None]) & (state.key_lo[seg, b] == q_lo[:, None])
    rows = heap_rows(cfg, state, state.key_lo[seg, b])       # (L, SLOTS, W)
    return (s_hi == q_hi[:, None]) & (rows == q_words[:, None, :]).all(-1)


def bucket_probe(cfg: DashConfig, state: DashState, seg, b, fpv, q_hi, q_lo,
                 q_words=None):
    """Search one bucket per lane. Returns (found, slot, value)."""
    eq = slot_fp_matches(cfg, state, seg, b, fpv) & keys_equal(
        cfg, state, seg, b, q_hi, q_lo, q_words)
    found, slot = first_true(eq)
    return found, slot, state.val[seg, b, slot]


def first_free_slot(cfg: DashConfig, state: DashState, seg, b):
    """(has_free, slot) — lowest clear bit of the alloc bitmap."""
    return first_true(~_bits(layout.meta_alloc(state.meta[seg, b]), cfg.num_slots))


def bucket_count(state: DashState, seg, b):
    return layout.meta_count(state.meta[seg, b])


def bump_version(state: DashState, seg, b, mask=None):
    """+2 keeps the lock bit (bit 0) clear — release+version-increment analog."""
    masked_set(state.version, (seg, b), word(u32(state.version[seg, b]) + 2), mask)


def bucket_write(cfg: DashConfig, state: DashState, seg, b, slot,
                 k_hi, k_lo, v, fpv, member, mask=None):
    """Write a record into a known-free slot and publish the metadata word:
    (1) slot payload, (2) fingerprint, (3) one store of alloc|membership|
    count, (4) version bump (Alg. 2 bucket::insert)."""
    masked_set(state.key_hi, (seg, b, slot), k_hi, mask)
    masked_set(state.key_lo, (seg, b, slot), k_lo, mask)
    masked_set(state.val, (seg, b, slot), v, mask)
    masked_set(state.fp, (seg, b, slot), fpv, mask)
    meta = state.meta[seg, b]
    bit = torch.ones_like(slot) << slot
    alloc = layout.meta_alloc(meta) | bit
    memb = layout.meta_member(meta) | (bit * member)
    count = layout.meta_count(meta) + 1
    masked_set(state.meta, (seg, b), layout.meta_pack(alloc, memb, count), mask)
    bump_version(state, seg, b, mask)


def bucket_clear_slot(cfg: DashConfig, state: DashState, seg, b, slot,
                      mask=None):
    """Delete = clear alloc + membership bit and decrement count in one
    packed-word store."""
    meta = state.meta[seg, b]
    bit = torch.ones_like(slot) << slot
    alloc = layout.meta_alloc(meta) & ~bit
    memb = layout.meta_member(meta) & ~bit
    count = layout.meta_count(meta) - 1
    masked_set(state.meta, (seg, b), layout.meta_pack(alloc, memb, count), mask)
    bump_version(state, seg, b, mask)


def find_movable_slot(cfg: DashConfig, state: DashState, seg, b,
                      want_member_set: bool):
    """Displacement helper (Alg. 2): an allocated slot whose membership bit
    equals ``want_member_set``, from the bitmaps alone (no key loads)."""
    meta = state.meta[seg, b]
    allocated = _bits(layout.meta_alloc(meta), cfg.num_slots)
    mset = _bits(layout.meta_member(meta), cfg.num_slots)
    return first_true(allocated & (mset == want_member_set))


def read_slot(state: DashState, seg, b, slot):
    return (state.key_hi[seg, b, slot], state.key_lo[seg, b, slot],
            state.val[seg, b, slot], state.fp[seg, b, slot])


# ---- overflow (stash) metadata on the home bucket --------------------------

def ofp_try_set(cfg: DashConfig, state: DashState, seg, b, fpv, stash_idx,
                member: bool, mask=None):
    """Try to record an overflow fingerprint on bucket ``b``; returns ok (L,).
    A successful set writes the word, the fingerprint and bumps the version."""
    if cfg.num_ofp == 0:
        return torch.zeros(seg.shape, dtype=torch.bool, device=seg.device)
    om = state.ometa[seg, b]
    oa = layout.ometa_ofp_alloc(om)
    ok, slot = first_true(~_bits(oa, cfg.num_ofp))
    bit = torch.ones_like(slot) << slot
    new_omem = layout.ometa_ofp_member(om) | (bit if member else 0)
    om2 = u32(om) & ~((0xF << layout.OFPA_SHIFT) | (0xF << layout.OFPM_SHIFT))
    om2 = om2 | ((oa | bit) << layout.OFPA_SHIFT) | (new_omem << layout.OFPM_SHIFT)
    om2 = layout.ometa_set_stash_idx(om2, slot, stash_idx)
    om2 = om2 | (1 << layout.OVFB_SHIFT)
    w = ok if mask is None else ok & mask
    masked_set(state.ometa, (seg, b), word(om2), w)
    masked_set(state.ofp, (seg, b, slot), fpv, w)
    bump_version(state, seg, b, w)
    return ok


def ovf_count_add(state: DashState, seg, b, delta: int, mask=None):
    """Adjust the overflow counter (stash records with no ofp slot).
    Version-bumped like every metadata write."""
    om = state.ometa[seg, b]
    cnt = layout.ometa_ovf_count(om) + delta
    om2 = (u32(om) & ~(0x7F << layout.OVFC_SHIFT)) | ((cnt & 0x7F) << layout.OVFC_SHIFT)
    om2 = om2 | (1 << layout.OVFB_SHIFT)
    masked_set(state.ometa, (seg, b), word(om2), mask)
    bump_version(state, seg, b, mask)


def ofp_matches(cfg: DashConfig, state: DashState, seg, b, fpv,
                want_member: bool):
    """(L, NOFP) bool — overflow fingerprints on bucket ``b`` that match
    ``fpv`` and whose membership equals ``want_member`` (Sec. 4.3)."""
    om = state.ometa[seg, b]
    allocated = _bits(layout.ometa_ofp_alloc(om), cfg.num_ofp)
    mset = _bits(layout.ometa_ofp_member(om), cfg.num_ofp)
    fps = state.ofp[seg, b, :cfg.num_ofp] == fpv[:, None]
    return allocated & (mset == want_member) & fps


def ofp_clear(cfg: DashConfig, state: DashState, seg, b, slot, mask=None):
    om = state.ometa[seg, b]
    bit = torch.ones_like(slot) << slot
    oa = layout.ometa_ofp_alloc(om) & ~bit
    omem = layout.ometa_ofp_member(om) & ~bit
    om2 = u32(om) & ~((0xF << layout.OFPA_SHIFT) | (0xF << layout.OFPM_SHIFT))
    om2 = om2 | (oa << layout.OFPA_SHIFT) | (omem << layout.OFPM_SHIFT)
    masked_set(state.ometa, (seg, b), word(om2), mask)
    bump_version(state, seg, b, mask)
