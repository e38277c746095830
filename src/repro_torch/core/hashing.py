"""32-bit-pair hashing for Dash, on tensors and in numpy.

A 64-bit key is carried as a ``(hi, lo)`` uint32 pair and hashed twice:

    h1 = hash_pair(hi, lo, SEED1)   -> segment/bucket addressing (MSB-first)
    h2 = hash_pair(hi, lo, SEED2)   -> fingerprint byte (low 8 bits)

``hash_pair`` is a murmur3 fmix32 of ``lo ^ seed``, a boost-style combine
with ``fmix32(hi + seed)``, and fmix32 again, all mod 2**32. The tensor
functions here are the plain PyTorch version (int64 arithmetic masked to 32
bits); the batch path hashes on the card with the ``bulk_hash`` kernel
(``kernels/hashmix.py``), which these functions pin. The numpy mirrors are
for host tooling and tests.
"""
from __future__ import annotations

import numpy as np
import torch

from .layout import MASK32, u32, word

SEED1 = 0x9E3779B9  # golden-ratio seed for addressing hash
SEED2 = 0x85EBCA6B  # murmur constant seed for fingerprint hash

_C1 = 0x85EBCA6B
_C2 = 0xC2B2AE35
_GOLDEN = 0x9E3779B9


def _mul32(a, c: int):
    """(a * c) mod 2**32 for int64 ``a`` in [0, 2**32), without int64
    overflow: the high half of ``c`` only reaches the low 32 bits through
    16 bits of its partial product."""
    lo = a * (c & 0xFFFF)
    hi = ((a * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & MASK32


def _mix32(h):
    """Murmur3 fmix32 finalizer on int64 values in [0, 2**32)."""
    h = h ^ (h >> 16)
    h = _mul32(h, _C1)
    h = h ^ (h >> 13)
    h = _mul32(h, _C2)
    return h ^ (h >> 16)


def hash_pair(key_hi, key_lo, seed: int):
    """Hash (hi, lo) word tensors into one 32-bit word (int32 bits)."""
    hi, lo = u32(key_hi), u32(key_lo)
    h = _mix32(lo ^ seed)
    h = h ^ ((_mix32((hi + seed) & MASK32) + _GOLDEN + ((h << 6) & MASK32)
              + (h >> 2)) & MASK32)
    return word(_mix32(h))


def hash1(key_hi, key_lo):
    """Addressing hash: directory/segment/bucket bits are drawn MSB-first."""
    return hash_pair(key_hi, key_lo, SEED1)


def hash2(key_hi, key_lo):
    """Fingerprint hash: low byte is the fingerprint (paper Sec. 4.2)."""
    return hash_pair(key_hi, key_lo, SEED2)


def fingerprint(h2):
    """Least-significant byte of the fingerprint hash, as uint8."""
    return (h2 & 0xFF).to(torch.uint8)


# ---------------------------------------------------------------------------
# numpy mirrors (bit-exact)
# ---------------------------------------------------------------------------

def _np_mix32(h):
    h = np.asarray(h, dtype=np.uint64) & MASK32
    h ^= h >> np.uint64(16)
    h = (h * np.uint64(_C1)) & MASK32
    h ^= h >> np.uint64(13)
    h = (h * np.uint64(_C2)) & MASK32
    h ^= h >> np.uint64(16)
    return h & MASK32


def np_hash_pair(key_hi, key_lo, seed):
    key_hi = np.asarray(key_hi, dtype=np.uint64) & MASK32
    key_lo = np.asarray(key_lo, dtype=np.uint64) & MASK32
    seed = np.uint64(int(seed))
    h = _np_mix32(key_lo ^ seed)
    h ^= (_np_mix32((key_hi + seed) & MASK32) + np.uint64(_GOLDEN)
          + ((h << np.uint64(6)) & MASK32) + (h >> np.uint64(2))) & MASK32
    h &= MASK32
    return _np_mix32(h).astype(np.uint32)


def np_hash1(key_hi, key_lo):
    return np_hash_pair(key_hi, key_lo, SEED1)


def np_hash2(key_hi, key_lo):
    return np_hash_pair(key_hi, key_lo, SEED2)


def np_split_keys(keys64: np.ndarray):
    """uint64 keys -> (hi, lo) uint32 arrays."""
    keys64 = np.asarray(keys64, dtype=np.uint64)
    return ((keys64 >> np.uint64(32)).astype(np.uint32),
            (keys64 & np.uint64(MASK32)).astype(np.uint32))


def split_keys(keys64, device) -> tuple:
    """uint64 keys -> (hi, lo) int32 word tensors on ``device``."""
    hi, lo = np_split_keys(keys64)
    return (torch.from_numpy(hi.view(np.int32)).to(device),
            torch.from_numpy(lo.view(np.int32)).to(device))
