"""Seeded hostile inputs for the two read kernels (``fused_probe``,
``fingerprint_probe``).

:func:`read_kernel_edges` builds small synthetic planes and flat lanes that
exercise every rule the kernels keep, not the inputs a healthy table
produces. The lanes are laid out as the reference's routed (S, C) lanes:
lane i belongs to row i // C, whose segment id is the row's index, unless
the lane's segment id is made hostile (-1 or S). The background is noise
from small alphabets, so fingerprints and key words collide everywhere and
meta words carry random high bits. Every 16th lane position holds one
planted case, named in ``KINDS``; each planted key is unique, so only its
own slots can match it:

- the same key in two rows (b and pb; pb and stash 1), and twice in one
  row, so the first-hit order decides;
- a fingerprint collision with a different key, and the key itself under
  another fingerprint byte;
- a key in stash 1 only, across segments whose ``stash_active`` is 0, 1 and
  ``ns``;
- ``q_pb < 0`` (reads row 0), ``q_b >= BT``, ``q_pb >= BT``, ``q_b < 0``,
  segment ids -1 and S, and a key whose alloc bit is clear.
"""
from __future__ import annotations

import numpy as np
import torch

KINDS = ("noise", "b_and_pb", "pb_and_stash1", "twice_in_b", "stash1_only",
         "fp_collision", "pb_negative", "b_past_bt", "pb_past_bt",
         "seg_negative", "seg_past_end", "b_negative", "alloc_cleared")
#: key words of the background noise: planted keys use none of them
_ALPHABET = np.array([0, 1, 0x80000000, 0xFFFFFFFF], np.uint32)


def read_kernel_edges(seed: int, *, segments: int = 4, nb: int = 64, ns: int = 2,
                      sl: int = 14, cap: int = 128) -> dict:
    """Planes (numpy, the table's dtypes: fp uint8, meta/key/val uint32,
    stash_active int32), lanes (``q_seg``, ``q_fp``, ``q_b``, ``q_pb``
    int32; ``q_hi``, ``q_lo`` uint32) and ``kind``, each lane's index into
    ``KINDS``. Needs ``segments >= 3`` and ``ns >= 2``."""
    if segments < 3 or ns < 2 or cap % 16:
        raise ValueError("read_kernel_edges needs segments >= 3, ns >= 2, cap % 16 == 0")
    rng = np.random.default_rng(seed)
    S, BT, n = segments, nb + ns, segments * cap
    fp = rng.integers(0, 4, (S, BT, 16), dtype=np.uint8)
    meta = rng.integers(0, 2**32, (S, BT), dtype=np.uint64).astype(np.uint32)
    meta[:, ::7] &= np.uint32(~0x3FFF & 0xFFFFFFFF)          # some empty rows
    key_hi = _ALPHABET[rng.integers(0, 4, (S, BT, sl))]
    key_lo = _ALPHABET[rng.integers(0, 4, (S, BT, sl))]
    val = rng.integers(0, 2**32, (S, BT, sl), dtype=np.uint64).astype(np.uint32)
    stash_active = np.resize(np.array([0, 1, ns], np.int32), S)

    q_seg = np.repeat(np.arange(S, dtype=np.int32), cap)
    q_b = rng.integers(0, nb, n).astype(np.int32)
    q_pb = ((q_b + 1) & (nb - 1)).astype(np.int32)
    q_pb[::3] = rng.integers(0, nb, q_pb[::3].size)            # not always b + 1
    q_fp = rng.integers(0, 4, n).astype(np.int32)
    q_hi = _ALPHABET[rng.integers(0, 4, n)]
    q_lo = _ALPHABET[rng.integers(0, 4, n)]
    kind = np.zeros(n, np.int32)
    used = np.zeros((S, BT, sl), bool)                          # planted slots

    def put(s, row, i, fpb, *, alloc=True):
        """Plant lane i's key in a free slot of (s, row); return its value
        (None when the row has no unplanted slot left)."""
        free = np.flatnonzero(~used[s, row])
        if free.size == 0:
            return None
        j = int(rng.choice(free))
        used[s, row, j] = True
        key_hi[s, row, j], key_lo[s, row, j], fp[s, row, j] = q_hi[i], q_lo[i], fpb
        bit = np.uint32(1 << j)
        meta[s, row] = (meta[s, row] | bit) if alloc else (meta[s, row] & ~bit)
        return val[s, row, j]

    for i in range(n):
        k = (i % cap) % 16
        if k == 0 or k >= len(KINDS):
            continue
        s, b, pb, f = int(q_seg[i]), int(q_b[i]), int(q_pb[i]), int(q_fp[i])
        q_hi[i] = np.uint32(0x40000000 | i)                     # unique planted key
        q_lo[i] = np.uint32(rng.integers(0, 2**32))
        name = KINDS[k]
        if name == "b_and_pb":
            ok = put(s, b, i, f) is not None and put(s, pb, i, f) is not None
        elif name == "pb_and_stash1":
            ok = put(s, pb, i, f) is not None and put(s, nb + 1, i, f) is not None
        elif name == "twice_in_b":
            ok = put(s, b, i, f) is not None and put(s, b, i, f) is not None
        elif name == "stash1_only":
            ok = put(s, nb + 1, i, f) is not None
        elif name == "fp_collision":
            lo = q_lo[i]
            q_lo[i] ^= np.uint32(1)                             # decoy: same fp, other key
            ok = put(s, b, i, f) is not None
            q_lo[i] = lo
            ok = ok and put(s, pb, i, (f + 1) % 256) is not None
        elif name == "pb_negative":
            q_b[i] = b = max(b, 1)                              # row 0 only through pb
            q_pb[i] = -1
            ok = put(s, 0, i, f) is not None
        elif name == "b_past_bt":
            q_b[i] = rng.choice([BT, BT + 1, 127, 128, 1000, 1 << 30])
            ok = put(s, pb, i, f) is not None
        elif name == "pb_past_bt":
            q_pb[i] = rng.choice([BT, 200, 1 << 30])
            ok = put(s, nb, i, f) is not None
        elif name in ("seg_negative", "seg_past_end"):
            ok = put(s, b, i, f) is not None
            q_seg[i] = -1 if name == "seg_negative" else S
        elif name == "b_negative":
            q_b[i] = -1
            ok = put(s, pb, i, f) is not None
        else:                                                   # alloc_cleared
            ok = put(s, b, i, f, alloc=False) is not None
        kind[i] = k if ok else 0
    return dict(fp=fp, meta=meta, key_hi=key_hi, key_lo=key_lo, val=val,
                stash_active=stash_active, q_seg=q_seg, q_fp=q_fp, q_b=q_b,
                q_pb=q_pb, q_hi=q_hi, q_lo=q_lo, kind=kind, nb=nb, ns=ns, cap=cap)


def to_torch(case: dict, device) -> tuple:
    """(planes, lanes) as the port's tensors: the fused_probe argument
    order, uint32 words as int32 tensors with the same bits."""
    def t(a):
        a = np.ascontiguousarray(a)
        return torch.from_numpy(a.view(np.int32) if a.dtype == np.uint32 else a).to(device)
    planes = tuple(t(case[k]) for k in ("fp", "meta", "key_hi", "key_lo", "val",
                                         "stash_active"))
    lanes = tuple(t(case[k]) for k in ("q_seg", "q_fp", "q_b", "q_pb", "q_hi", "q_lo"))
    return planes, lanes
