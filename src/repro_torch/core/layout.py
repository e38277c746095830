"""Dash table memory layout in PyTorch: packed metadata words + state planes.

The layout is the reference's (``repro.core.layout``) plane for plane: a
bucket has ``num_slots`` record slots, a 16-byte fingerprint row, 4 overflow
fingerprints, one packed metadata word (alloc | membership | count — the
publish point), one packed overflow word and a version word. A segment is
``num_buckets`` normal buckets followed by ``num_stash`` stash buckets; the
EH directory is stored fully expanded at ``2**dir_depth_max`` entries.

Unsigned words. Every uint32 plane is stored as an ``int32`` tensor holding
the same 32 bits, so a plane's bytes equal the reference's byte for byte
(``interop.state_to_numpy`` views them back as uint32). Arithmetic on words
goes through :func:`u32`, which widens to int64 and masks to 32 bits: an
arithmetic right shift of an int32 word would sign-extend every word whose
top bit is set (half of all hashes, and every meta word of a bucket holding
8 or more records). :func:`word` narrows an int64 value back to the int32
bit pattern.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

# Status codes returned by mutating ops.
INSERTED = 0
EXISTS = 1
NEED_SPLIT = 2     # no room even in stash: host must split and retry
DROPPED = 3        # masked-out or capacity-overflow lane
NOT_FOUND = 4      # delete/update of an absent key

# Segment SMO states (paper Sec. 4.7).
SEG_NORMAL = 0
SEG_SPLITTING = 1
SEG_NEW = 2

MASK32 = 0xFFFFFFFF


def u32(t: torch.Tensor) -> torch.Tensor:
    """The unsigned value of a 32-bit word tensor, as int64 in [0, 2**32)."""
    return t.to(torch.int64) & MASK32


def word(t: torch.Tensor) -> torch.Tensor:
    """Narrow an int64 value to the int32 tensor holding its low 32 bits."""
    return (((t & MASK32) ^ 0x80000000) - 0x80000000).to(torch.int32)


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: the card unless the caller asks
    for another. Never falls back to the CPU silently."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device; pass device='cpu' to run on the CPU")
    return torch.device("cuda")


@dataclasses.dataclass(frozen=True)
class DashConfig:
    """Static configuration: the reference's fields, defaults and checks."""
    num_buckets: int = 64          # normal buckets / segment (power of 2)
    num_stash: int = 2             # stash buckets / segment (0 disables stashing)
    num_slots: int = 14            # record slots / bucket
    num_ofp: int = 4               # overflow fingerprint slots / bucket
    max_segments: int = 64         # preallocated segment pool size
    dir_depth_max: int = 12        # fully-expanded directory = 2**this entries
    init_depth: int = 1            # initial global/local depth (EH); init segs = 2**this
    # --- feature flags (paper Fig. 11 ablation stack) ---
    use_fingerprints: bool = True
    use_balanced: bool = True      # balanced insert (b vs b+1, pick emptier)
    use_displacement: bool = True
    use_overflow_meta: bool = True # Fig. 10: off => every probe scans stash
    probe_len: int = 2             # insert/search window when balanced=False
    # --- LH-specific ---
    lh_base_log2: int = 2          # N0 = 2**this initial segments for linear hashing
    lh_base_stash: int = 2         # fixed stash buckets before chaining (Sec. 5.1)
    # --- misc ---
    pointer_mode: bool = False     # variable-length keys: not ported yet
    key_heap_size: int = 0
    key_heap_words: int = 4

    def __post_init__(self):
        if self.num_buckets & (self.num_buckets - 1) != 0:
            raise ValueError("num_buckets must be pow2")
        if not 1 <= self.num_slots <= 14:
            raise ValueError("num_slots must be in [1, 14]")
        if not 0 <= self.num_ofp <= 4:
            raise ValueError("num_ofp must be in [0, 4]")
        if self.init_depth > self.dir_depth_max:
            raise ValueError("init_depth must not exceed dir_depth_max")
        if self.pointer_mode:
            raise NotImplementedError("pointer mode is not ported yet")

    @property
    def buckets_total(self) -> int:
        return self.num_buckets + self.num_stash

    @property
    def bucket_bits(self) -> int:
        return int(np.log2(self.num_buckets))

    @property
    def dir_size(self) -> int:
        return 1 << self.dir_depth_max

    @property
    def probe_window(self) -> int:
        """Buckets a record may land in from its home bucket onward."""
        return 2 if self.use_balanced else max(self.probe_len, 1)

    @property
    def seg_capacity(self) -> int:
        return self.buckets_total * self.num_slots

    def bytes_per_segment(self) -> int:
        bt, ns = self.buckets_total, self.num_slots
        return bt * 16 + self.num_buckets * 4 + bt * ns * 12 + bt * 12


# --- packed word: meta = alloc(14 bits) | membership(14 bits) | count(4 bits) ---
ALLOC_SHIFT, MEMBER_SHIFT, COUNT_SHIFT = 0, 14, 28
SLOT_MASK = (1 << 14) - 1


def meta_alloc(meta):
    return (u32(meta) >> ALLOC_SHIFT) & SLOT_MASK


def meta_member(meta):
    return (u32(meta) >> MEMBER_SHIFT) & SLOT_MASK


def meta_count(meta):
    return (u32(meta) >> COUNT_SHIFT) & 0xF


def meta_pack(alloc, member, count):
    """Pack int64 fields into an int32 word (fields wrap mod 2**32 like the
    reference's uint32 arithmetic)."""
    return word((alloc << ALLOC_SHIFT) | (member << MEMBER_SHIFT)
                | (count << COUNT_SHIFT))


# --- packed word: ometa = ofp_alloc(4) | ofp_member(4) | stash_idx(2b x4) | ovf_cnt(7) | ovf_bit(1) ---
OFPA_SHIFT, OFPM_SHIFT, SIDX_SHIFT, OVFC_SHIFT, OVFB_SHIFT = 0, 4, 8, 16, 23


def ometa_ofp_alloc(om):
    return (u32(om) >> OFPA_SHIFT) & 0xF


def ometa_ofp_member(om):
    return (u32(om) >> OFPM_SHIFT) & 0xF


def ometa_stash_idx(om, slot):
    return (u32(om) >> (SIDX_SHIFT + 2 * slot)) & 0x3


def ometa_ovf_count(om):
    return (u32(om) >> OVFC_SHIFT) & 0x7F


def ometa_ovf_bit(om):
    return (u32(om) >> OVFB_SHIFT) & 1


def ometa_set_stash_idx(om, slot, sidx):
    """int64 ometa value with stash index ``sidx`` stored for ofp ``slot``."""
    sh = SIDX_SHIFT + 2 * slot
    return (u32(om) & ~(0x3 << sh)) | ((sidx & 0x3) << sh)


class DashState(NamedTuple):
    """The whole table as tensors: the reference's field names, shapes and
    byte widths (uint32 planes held as int32 bits, see module docstring)."""
    # record planes: [max_segments, buckets_total, ...]
    fp: torch.Tensor        # (S, BT, 16) uint8 — slot fingerprints (padded)
    ofp: torch.Tensor       # (S, NB, 4)  uint8 — overflow fingerprints
    key_hi: torch.Tensor    # (S, BT, SLOTS) u32
    key_lo: torch.Tensor    # (S, BT, SLOTS) u32
    val: torch.Tensor       # (S, BT, SLOTS) u32
    meta: torch.Tensor      # (S, BT) u32 packed — atomic publish word
    ometa: torch.Tensor     # (S, NB) u32 packed
    version: torch.Tensor   # (S, BT) u32 — bit0 lock, bits1.. version
    # segment metadata
    local_depth: torch.Tensor   # (S,) int32
    seg_state: torch.Tensor     # (S,) int32 {NORMAL, SPLITTING, NEW}
    side_link: torch.Tensor     # (S,) int32 right-neighbor chain (-1 = none)
    seg_version: torch.Tensor   # (S,) u32 lazy-recovery version
    # directory / global metadata
    dir: torch.Tensor           # (2**dir_depth_max,) int32 fully-expanded MSB directory
    global_depth: torch.Tensor  # () int32
    watermark: torch.Tensor     # () int32 — segment pool allocation bump pointer
    clean: torch.Tensor         # () bool — clean-shutdown marker (Sec. 4.8)
    gver: torch.Tensor          # () u32 — global recovery version V
    lh_word: torch.Tensor       # () u32 — LH: level(8) | next(24)
    lh_dir: torch.Tensor        # (S,) int32 — LH logical seg -> physical
    stash_active: torch.Tensor  # (S,) int32 — active stash buckets
    # stats
    n_items: torch.Tensor       # () int32
    n_splits: torch.Tensor      # () int32
    n_doublings: torch.Tensor   # () int32
    key_heap: torch.Tensor      # (1, W) u32 — pointer-mode key storage (unused)
    heap_top: torch.Tensor      # () int32


#: the reference dtype of every plane; "u32" planes are int32 tensors here
PLANE_DTYPES = {
    "fp": "u8", "ofp": "u8", "key_hi": "u32", "key_lo": "u32", "val": "u32",
    "meta": "u32", "ometa": "u32", "version": "u32", "local_depth": "i32",
    "seg_state": "i32", "side_link": "i32", "seg_version": "u32",
    "dir": "i32", "global_depth": "i32", "watermark": "i32", "clean": "bool",
    "gver": "u32", "lh_word": "u32", "lh_dir": "i32", "stash_active": "i32",
    "n_items": "i32", "n_splits": "i32", "n_doublings": "i32",
    "key_heap": "u32", "heap_top": "i32",
}


def make_state(cfg: DashConfig, mode: str = "eh", device=None) -> DashState:
    """Fresh table on ``device`` (the card unless given). mode: 'eh'
    (2**init_depth segments) or 'lh' (N0 segments)."""
    device = resolve_device(device)
    S, BT, NB, NS = cfg.max_segments, cfg.buckets_total, cfg.num_buckets, cfg.num_slots
    if mode == "eh":
        n_init = 1 << cfg.init_depth
        dir0 = np.repeat(np.arange(n_init, dtype=np.int32), cfg.dir_size // n_init)
        gd = cfg.init_depth
    elif mode == "lh":
        n_init = 1 << cfg.lh_base_log2
        dir0 = np.zeros(cfg.dir_size, dtype=np.int32)  # unused by LH addressing
        gd = 0
    else:
        raise ValueError(mode)
    if n_init > S:
        raise ValueError("initial segments exceed max_segments")
    lh_dir = np.full(S, -1, dtype=np.int32)
    lh_dir[:n_init] = np.arange(n_init)

    def z(*shape, dtype=torch.int32):
        return torch.zeros(shape, dtype=dtype, device=device)

    def full(shape, v):
        return torch.full(shape, v, dtype=torch.int32, device=device)

    def scalar(v, dtype=torch.int32):
        return torch.tensor(v, dtype=dtype, device=device)

    return DashState(
        fp=z(S, BT, 16, dtype=torch.uint8),
        ofp=z(S, NB, 4, dtype=torch.uint8),
        key_hi=z(S, BT, NS), key_lo=z(S, BT, NS), val=z(S, BT, NS),
        meta=z(S, BT), ometa=z(S, NB), version=z(S, BT),
        local_depth=full((S,), gd if mode == "eh" else 0),
        seg_state=z(S),
        side_link=full((S,), -1),
        seg_version=full((S,), 1),
        dir=torch.from_numpy(dir0).to(device),
        global_depth=scalar(gd),
        watermark=scalar(n_init),
        clean=scalar(True, torch.bool),
        gver=scalar(1),
        lh_word=scalar(0),
        lh_dir=torch.from_numpy(lh_dir).to(device),
        stash_active=full((S,), min(cfg.num_stash, cfg.lh_base_stash)
                          if mode == "lh" else cfg.num_stash),
        n_items=scalar(0), n_splits=scalar(0), n_doublings=scalar(0),
        key_heap=z(1, cfg.key_heap_words),
        heap_top=scalar(0),
    )


# --- addressing -------------------------------------------------------------

def dir_index(cfg: DashConfig, h1):
    """MSB prefix of h1 at the fully-expanded directory resolution (int64)."""
    return u32(h1) >> (32 - cfg.dir_depth_max)


def bucket_index(cfg: DashConfig, h1):
    """In-segment bucket from the LSBs of h1 (int64)."""
    return u32(h1) & (cfg.num_buckets - 1)


def lh_level_next(lh_word):
    w = u32(lh_word)
    return w >> 24, w & 0xFFFFFF


def lh_pack(level, nxt):
    return word((level << 24) | (nxt & 0xFFFFFF))


def lh_logical_segment(cfg: DashConfig, h1, lh_word):
    """Classic LH addressing with power-of-2 rounds: seg = h mod N0*2^l,
    re-hashed with the next round's mask if already split this round."""
    level, nxt = lh_level_next(lh_word)
    mask_lo = (1 << (cfg.lh_base_log2 + level)) - 1
    h = u32(h1)
    seg = h & mask_lo
    seg2 = h & ((mask_lo << 1) | 1)
    return torch.where(seg < nxt, seg2, seg)


def lh_bucket_index(cfg: DashConfig, h1):
    """LH bucket bits live above the segment bits."""
    return (u32(h1) >> 24) & (cfg.num_buckets - 1)


def load_factor(cfg: DashConfig, state: DashState):
    """records stored / capacity of *allocated* segments (paper's metric)."""
    return state.n_items.to(torch.float32) / (
        state.watermark.to(torch.float32) * cfg.seg_capacity)
