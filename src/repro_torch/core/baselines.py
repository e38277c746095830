"""Baselines the paper compares against (port of ``repro.core.baselines``).

* CCEH-like — a ``DashConfig`` of the shared engine (``cceh_config``):
  4-slot buckets, linear probing of 4 buckets, no fingerprints, no balanced
  insert / displacement, no stash; split on probe-window exhaustion.
  ``bucketized_config`` is Fig. 11's 'Bucketized' point. Both run through
  the tables and kernels the port already has.

* Level hashing — a two-level scheme with its own structure (this module):
  a top level of 2^k 4-slot buckets, a bottom level of 2^(k-1); each key
  has two candidate buckets per level (two hash functions); one movement
  attempt in the top level; a **full-table rehash** on resize (new top =
  2^(k+1), old top becomes the bottom) — the blocking rehash the paper
  contrasts with dynamic schemes (Sec. 2.2, Fig. 8's insert collapse).

The reference runs each insert batch as one jitted ``lax.scan`` over
``level_insert_one``; here a batch is one launch of the ``level_scan`` CUDA
kernel (``kernels/level.py``), whose plain version steps
:func:`level_insert_one` through the keys in order. Planes are updated in
place. uint32 planes are int32 tensors holding the same bits, as in
``DashState``.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from . import hashing, layout
from .bucket import first_true
from .layout import (EXISTS, INSERTED, MASK32, NEED_SPLIT, NOT_FOUND,
                     DashConfig, u32, word)


def cceh_config(max_segments: int = 64, dir_depth_max: int = 12) -> DashConfig:
    """CCEH as a feature-flag point of the Dash engine (Sec. 2.3)."""
    return DashConfig(
        num_buckets=64, num_stash=0, num_slots=4, num_ofp=0,
        max_segments=max_segments, dir_depth_max=dir_depth_max,
        use_fingerprints=False, use_balanced=False, use_displacement=False,
        probe_len=4,
    )


def bucketized_config(**kw) -> DashConfig:
    """Fig. 11 'Bucketized': no probing, no balancing, no stash."""
    return DashConfig(num_stash=0, use_fingerprints=True, use_balanced=False,
                      use_displacement=False, probe_len=1, **kw)


# ---------------------------------------------------------------------------
# Level hashing
# ---------------------------------------------------------------------------

SLOTS = 4


@dataclasses.dataclass(frozen=True)
class LevelConfig:
    max_log2: int = 14          # max top-level log2 (pool is 2^max + 2^(max-1))
    init_log2: int = 6


class LevelState(NamedTuple):
    key_hi: torch.Tensor   # (CAP, 4) int32 words (the reference's uint32)
    key_lo: torch.Tensor
    val: torch.Tensor
    alloc: torch.Tensor    # (CAP,) int32 word: 4-bit slot bitmap
    k: torch.Tensor        # () int32 — top level is 2^k buckets
    n_items: torch.Tensor  # () int32
    n_rehashes: torch.Tensor


def _cap(cfg: LevelConfig) -> int:
    return (1 << cfg.max_log2) + (1 << (cfg.max_log2 - 1))


def level_make_state(cfg: LevelConfig, device=None) -> LevelState:
    dev = layout.resolve_device(device)
    CAP = _cap(cfg)

    def zeros(*shape):
        return torch.zeros(shape, dtype=torch.int32, device=dev)

    return LevelState(
        key_hi=zeros(CAP, SLOTS), key_lo=zeros(CAP, SLOTS), val=zeros(CAP, SLOTS),
        alloc=zeros(CAP),
        k=torch.tensor(cfg.init_log2, dtype=torch.int32, device=dev),
        n_items=zeros(), n_rehashes=zeros())


def _low_mask(n):
    """``(1 << n) - 1`` in uint32 for a uint32 shift ``n`` (int64 tensor),
    with XLA's rule that a shift by 32 or more gives 0."""
    n = n & MASK32
    return (torch.where(n < 32, 1 << n.clamp(max=31), 0) - 1) & MASK32


def _buckets_for(cfg: LevelConfig, state: LevelState, h1, h2):
    """The four candidate buckets (int64): two top (offset 0), two bottom
    (offset 2^max_log2)."""
    kt = state.k.long()
    mt, mb = _low_mask(kt), _low_mask(kt - 1)
    boff = 1 << cfg.max_log2
    h1, h2 = u32(h1), u32(h2)
    return (word(h1 & mt).long(), word(h2 & mt).long(),
            boff + word(h1 & mb).long(), boff + word(h2 & mb).long())


def _slot_bits(state: LevelState, b):
    """(..., 4) bool: the alloc bit of every slot of each bucket in ``b``."""
    ids = torch.arange(SLOTS, device=b.device)
    return ((u32(state.alloc[b])[..., None] >> ids) & 1) == 1


def _probe_bucket(state: LevelState, b, q_hi, q_lo):
    """(found, first matching slot) per lane."""
    eq = (_slot_bits(state, b) & (state.key_hi[b] == q_hi[:, None])
          & (state.key_lo[b] == q_lo[:, None]))
    return first_true(eq)


def _free_slot(state: LevelState, b):
    """(has a free slot, the first free slot) per bucket."""
    return first_true(~_slot_bits(state, b))


def _count(state: LevelState, b):
    return _slot_bits(state, b).sum(-1)


def _write(state: LevelState, b, slot, hi, lo, v):
    """Write a record into slot ``slot`` of bucket ``b`` (in place)."""
    state.key_hi[b, slot] = hi
    state.key_lo[b, slot] = lo
    state.val[b, slot] = v
    state.alloc[b] |= (torch.ones_like(slot) << slot).to(torch.int32)


def _clear(state: LevelState, b, slot):
    state.alloc[b] &= ~(torch.ones_like(slot) << slot).to(torch.int32)


def level_insert_one(cfg: LevelConfig, state: LevelState, hi, lo, v, h1=None, h2=None):
    """One key's insert, on (1,) word tensors, in place: the reference's
    ``level_insert_one`` and the per-key step of ``level_scan``'s plain
    version (which passes the batch's hashes as ``h1``/``h2``). The four
    candidate buckets are read in one gather; the branch (exists, plain,
    move, resize) is taken on the host. Returns the (1,) int32 status."""
    if h1 is None:
        h1, h2 = hashing.hash1(hi, lo), hashing.hash2(hi, lo)
    cand = torch.cat(_buckets_for(cfg, state, h1, h2))       # ta, tb, ba, bb
    bits = _slot_bits(state, cand)                           # (4, 4)
    exists = (bits & (state.key_hi[cand] == hi) & (state.key_lo[cand] == lo)).any()

    # less-loaded top first (level hashing is 2-choice; top-a on a tie),
    # then the bottom
    cnt = _count(state, cand[:2])
    idx = torch.arange(4, device=cand.device)
    order = idx ^ ((cnt[0] > cnt[1]) & (idx < 2)).long()
    any_free, which = first_true(~bits[order].all(-1))
    code = int(torch.where(exists, EXISTS, torch.where(any_free, INSERTED, NEED_SPLIT)))
    status = torch.full_like(hi, code)
    if code == INSERTED:
        b = cand[order[which]]
        _write(state, b, first_true(~bits[order[which]])[1], hi[0], lo[0], v[0])
    elif code == NEED_SPLIT:
        # movement: evict slot 0 of ta to ITS alternate top bucket
        ta, zero = cand[0], torch.zeros_like(cand[0])
        r_hi, r_lo, r_v = state.key_hi[ta, 0], state.key_lo[ta, 0], state.val[ta, 0]
        mta, mtb, _, _ = _buckets_for(cfg, state, hashing.hash1(r_hi, r_lo),
                                      hashing.hash2(r_hi, r_lo))
        alt = torch.where(mta == ta, mtb, mta)
        mv_ok, mv_slot = _free_slot(state, alt)
        if bool(mv_ok):
            _write(state, alt, mv_slot, r_hi, r_lo, r_v)
            _clear(state, ta, zero)
            _write(state, ta, zero, hi[0], lo[0], v[0])
            status.fill_(INSERTED)
    state.n_items.add_((status == INSERTED).sum().to(torch.int32))
    return status


def level_insert_batch(cfg: LevelConfig, state: LevelState, hi, lo, vals,
                       valid=None):
    """Insert a batch in order, in place: one ``level_scan`` launch on the
    card (its plain version on the CPU). Returns (state, statuses)."""
    from repro_torch.kernels import level
    if valid is None:
        valid = torch.ones(hi.shape, dtype=torch.bool, device=hi.device)
    return state, level.level_scan(cfg, state, hi, lo, vals, valid)


def level_search_batch(cfg: LevelConfig, state: LevelState, hi, lo):
    """(found, value words) per key: the four candidate buckets gathered at
    once, the first hit in the order top-a, top-b, bottom-a, bottom-b."""
    h1, h2 = hashing.hash1(hi, lo), hashing.hash2(hi, lo)
    found = torch.zeros(hi.shape, dtype=torch.bool, device=hi.device)
    value = torch.zeros_like(hi)
    for b in _buckets_for(cfg, state, h1, h2):
        f, slot = _probe_bucket(state, b, hi, lo)
        value = torch.where(f & ~found, state.val[b, slot], value)
        found = found | f
    return found, value


def level_rehash(cfg: LevelConfig, state: LevelState) -> LevelState:
    """Full-table rehash: k -> k+1. The old top becomes the new bottom; the
    old bottom's records are re-inserted through ``level_scan``. This is
    the operation that blocks concurrent queries in level hashing (what
    Fig. 8 punishes). Returns a new state."""
    CAP, boff = _cap(cfg), 1 << cfg.max_log2
    nbot = CAP - boff
    old_k = int(state.k)
    fresh = LevelState(
        *(torch.zeros_like(p) for p in state[:4]), k=state.k + 1,
        n_items=torch.zeros_like(state.n_items), n_rehashes=state.n_rehashes + 1)
    # move old top -> new bottom (bucket index preserved). Rows [0, nbot)
    # are copied whole, as the reference's slice is: only ``alloc`` is
    # zeroed past the 2^old_k buckets that really were the top, so the key
    # and value planes keep the stale bytes the reference keeps.
    for new, old in zip(fresh[:4], state[:4]):
        new[boff:] = old[:nbot]
    fresh.alloc[boff + min(1 << old_k, nbot):] = 0

    # re-insert the old bottom's records (in row-major slot order) through
    # the new geometry; unallocated slots are no-ops, so only the allocated
    # ones go to the scan
    bits = _slot_bits(state, torch.arange(boff, CAP, device=state.alloc.device))
    idx = bits.reshape(-1).nonzero()[:, 0]
    lanes = [p[boff:].reshape(-1)[idx].contiguous() for p in state[:3]]
    level_insert_batch(cfg, fresh, *lanes)

    # recount
    fresh.n_items.copy_(_slot_bits(fresh, torch.arange(CAP, device=idx.device)).sum())
    return fresh


class LevelHashing:
    """Host wrapper mirroring the DashTable API surface. Runs on the card
    unless ``device`` names another."""

    def __init__(self, cfg: LevelConfig = LevelConfig(), device=None):
        self.cfg = cfg
        self.device = layout.resolve_device(device)
        self.state = level_make_state(cfg, self.device)

    def _words(self, a):
        return torch.from_numpy(np.ascontiguousarray(a).view(np.int32)).to(self.device)

    def insert(self, keys, values, max_retries: int = 8):
        """Statuses (numpy int32). A batch that reports NEED_SPLIT rehashes
        and retries its failed keys, padded to a pow2 of at least 8 lanes
        with a ``valid`` mask, as the reference does."""
        hi, lo = hashing.np_split_keys(np.asarray(keys, np.uint64))
        vals = np.asarray(values, np.uint32)
        out = np.full(hi.shape[0], NEED_SPLIT, np.int32)
        pending = np.arange(hi.shape[0])
        first = True
        for _ in range(max_retries):
            if first:
                idx, valid = pending, None
            else:
                n = max(8, 1 << int(np.ceil(np.log2(max(pending.size, 1)))))
                idx = np.concatenate([pending, np.zeros(n - pending.size, np.int64)])
                valid = torch.from_numpy(np.arange(n) < pending.size).to(self.device)
            self.state, st = level_insert_batch(
                self.cfg, self.state, self._words(hi[idx]), self._words(lo[idx]),
                self._words(vals[idx]), valid)
            st = st.cpu().numpy()[:pending.size]
            out[pending] = st
            failed = pending[st == NEED_SPLIT]
            if failed.size == 0:
                return out
            if int(self.state.k) >= self.cfg.max_log2:
                raise RuntimeError("level hashing pool exhausted")
            self.state = level_rehash(self.cfg, self.state)
            pending = failed
            first = False
        raise RuntimeError("level insert retry budget exhausted")

    def search(self, keys):
        """(found bool, values uint32) numpy arrays."""
        hi, lo = hashing.np_split_keys(np.asarray(keys, np.uint64))
        f, v = level_search_batch(self.cfg, self.state, self._words(hi), self._words(lo))
        return f.cpu().numpy(), v.cpu().numpy().view(np.uint32)

    @property
    def n_items(self) -> int:
        return int(self.state.n_items)

    @property
    def load_factor(self) -> float:
        k = int(self.state.k)
        cap = ((1 << k) + (1 << (k - 1))) * SLOTS
        return self.n_items / cap
