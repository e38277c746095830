"""bulk_hash: (h1, h2, fp) for a batch of (hi, lo) keys.

Every insert, search, delete and update batch pays this hash, and the
table's planner derives each key's segment id from its h1, so the port runs
it on the card (``csrc/hashmix.cu``). ``bulk_hash_plain`` is the same
function in PyTorch; the wrapper takes it for CPU tensors only.
"""
from __future__ import annotations

import torch

from repro_torch.core import hashing
from . import _build

#: kernel launches made by :func:`bulk_hash` (not by the plain version)
LAUNCHES = 0


def bulk_hash_plain(key_hi, key_lo):
    """(h1, h2, fp) int32 tensors: h1/h2 hold uint32 bits, fp = h2 & 0xFF."""
    h1 = hashing.hash1(key_hi, key_lo)
    h2 = hashing.hash2(key_hi, key_lo)
    return h1, h2, (h2 & 0xFF).to(torch.int32)


def bulk_hash(key_hi, key_lo):
    """Hash (N,) int32 word tensors on their device; any N."""
    global LAUNCHES
    _build.require(key_hi, "key_hi", torch.int32, 1)
    _build.require(key_lo, "key_lo", torch.int32, 1, like=key_hi)
    if key_hi.device.type == "cpu":
        return bulk_hash_plain(key_hi, key_lo)
    _build.require_cuda(key_hi)
    h1, h2, fp = (torch.empty_like(key_hi) for _ in range(3))
    lib = _build.load()
    _build.check(lib.dash_bulk_hash(
        key_hi.data_ptr(), key_lo.data_ptr(), h1.data_ptr(), h2.data_ptr(),
        fp.data_ptr(), key_hi.numel(), _build.stream(key_hi)), "bulk_hash")
    LAUNCHES += 1
    return h1, h2, fp
