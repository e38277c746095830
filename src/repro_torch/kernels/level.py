"""level_scan: one batch of level-hashing inserts, in batch order.

The reference runs a batch as one jitted ``lax.scan`` over
``level_insert_one`` (``repro/core/baselines.py:192``): a single device
program, but no Pallas kernel. Stepping the keys from Python would cost
about 60 launches and a host round trip per key, and would time the host
rather than level hashing, so the port runs the scan as one launch of a
CUDA kernel (``csrc/level.cu``). ``level_scan_plain`` steps
``core.baselines.level_insert_one`` through the keys; the wrapper takes it
for CPU tensors only. Both update the state's planes and ``n_items`` in
place and return the (n,) int32 statuses.
"""
from __future__ import annotations

import torch

from . import _build

#: kernel launches made by :func:`level_scan` (not by the plain version)
LAUNCHES = 0


def level_scan_plain(cfg, state, hi, lo, vals, valid):
    """One :func:`~repro_torch.core.baselines.level_insert_one` step per
    key, in order; keys with ``valid`` False are ``NOT_FOUND`` and skipped."""
    from repro_torch.core import baselines, hashing
    from repro_torch.core.layout import NOT_FOUND
    status = torch.full(hi.shape, NOT_FOUND, dtype=torch.int32, device=hi.device)
    h1, h2 = hashing.hash1(hi, lo), hashing.hash2(hi, lo)
    for i in valid.cpu().nonzero()[:, 0].tolist():
        s = slice(i, i + 1)
        status[s] = baselines.level_insert_one(cfg, state, hi[s], lo[s], vals[s],
                                               h1[s], h2[s])
    return status


def level_scan(cfg, state, hi, lo, vals, valid):
    """Insert (n,) int32 key words and values, masked by (n,) bool
    ``valid``, into a ``LevelState`` of ``cfg`` on its device."""
    global LAUNCHES
    cap = (1 << cfg.max_log2) + (1 << (cfg.max_log2 - 1))
    _build.require(state.key_hi, "key_hi", torch.int32, 2)
    if tuple(state.key_hi.shape) != (cap, 4):
        raise ValueError(f"key_hi: shape {tuple(state.key_hi.shape)} does not fit "
                         f"max_log2={cfg.max_log2}")
    for name in ("key_lo", "val"):
        _build.require(getattr(state, name), name, torch.int32, 2, like=state.key_hi)
    _build.require(state.alloc, "alloc", torch.int32, 1)
    for name in ("k", "n_items"):
        _build.require(getattr(state, name), name, torch.int32, 0)
    _build.require(hi, "hi", torch.int32, 1)
    _build.require(lo, "lo", torch.int32, 1, like=hi)
    _build.require(vals, "vals", torch.int32, 1, like=hi)
    _build.require(valid, "valid", torch.bool, 1, like=hi)
    _build.same_device(state.key_hi, state.alloc, state.k, state.n_items, hi)
    if state.key_hi.device.type == "cpu":
        return level_scan_plain(cfg, state, hi, lo, vals, valid)
    _build.require_cuda(state.key_hi)
    status = torch.empty_like(hi)
    if hi.numel() == 0:
        return status
    lib = _build.load()
    _build.check(lib.dash_level_scan(
        state.key_hi.data_ptr(), state.key_lo.data_ptr(), state.val.data_ptr(),
        state.alloc.data_ptr(), state.k.data_ptr(), state.n_items.data_ptr(),
        hi.data_ptr(), lo.data_ptr(), vals.data_ptr(), valid.data_ptr(),
        status.data_ptr(), hi.numel(), cfg.max_log2, _build.stream(hi)), "level_scan")
    LAUNCHES += 1
    return status
