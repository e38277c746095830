"""fingerprint_probe: the paper's fingerprint scan (Sec. 4.2) over lanes.

For each lane (a query with its segment id, fingerprint byte, target
bucket ``q_b`` and probing bucket ``q_pb``) the probe returns the 14-bit
bitmap of allocated slots whose fingerprint equals the query's, for both
buckets, and the free-slot bitmaps ``~alloc & 0x3FFF`` of the same buckets.
Keys are verified outside, only on fingerprint hits.

The kernel (``csrc/probe.cu``) reads the table's natural planes in place:
``state.fp`` (S, BT, 16) uint8 and ``state.meta`` (S, BT). Lanes are flat
(N,) vectors; the reference's routed (S, C) lanes flatten into this form
with ``q_seg`` = row index. ``fingerprint_probe_plain`` is the same function
in PyTorch; the wrapper takes it for CPU tensors only.
"""
from __future__ import annotations

import torch

from repro_torch.core.layout import SLOT_MASK, u32
from . import _build

NSLOTS = 14

#: kernel launches made by :func:`fingerprint_probe`
LAUNCHES = 0


def fingerprint_probe_plain(fp, meta, q_seg, q_fp, q_b, q_pb):
    """(bits_b, bits_pb, free_b, free_pb): four (N,) int32 tensors.

    A bucket index < 0 gives 0 (padding); one >= BT reads as an empty row
    (bits 0, free 0x3FFF), like the zero rows of the reference's padded
    tiles; a segment id outside [0, S) marks the lane as padding."""
    S, BT = meta.shape
    seg_ok = (q_seg >= 0) & (q_seg < S)
    s = q_seg.clamp(0, S - 1).long()
    slots = torch.arange(NSLOTS, device=fp.device)
    q = q_fp.long()

    def match(qb):
        r = qb.clamp(0, BT - 1).long()
        alloc = torch.where(qb < BT, u32(meta[s, r]) & SLOT_MASK, 0)
        eq = (fp[s, r, :NSLOTS].long() == q[:, None]) & (
            ((alloc[:, None] >> slots) & 1) == 1)
        bits = (eq.long() << slots).sum(-1)
        free = ~alloc & SLOT_MASK
        live = (qb >= 0) & seg_ok
        return (torch.where(live, bits, 0).to(torch.int32),
                torch.where(live, free, 0).to(torch.int32))

    bb, fb = match(q_b)
    bp, fpb = match(q_pb)
    return bb, bp, fb, fpb


def fingerprint_probe(fp, meta, q_seg, q_fp, q_b, q_pb):
    """Probe (N,) int32 lanes against the fp (S, BT, 16) uint8 and meta
    (S, BT) int32 planes; see :func:`fingerprint_probe_plain`."""
    global LAUNCHES
    _build.require(fp, "fp", torch.uint8, 3)
    _build.require(meta, "meta", torch.int32, 2)
    if fp.shape[:2] != meta.shape or fp.shape[2] != 16:
        raise ValueError(f"fp {tuple(fp.shape)} does not match meta {tuple(meta.shape)}")
    _build.require(q_seg, "q_seg", torch.int32, 1)
    for name, t in (("q_fp", q_fp), ("q_b", q_b), ("q_pb", q_pb)):
        _build.require(t, name, torch.int32, 1, like=q_seg)
    _build.same_device(fp, meta, q_seg)
    if fp.device.type == "cpu":
        return fingerprint_probe_plain(fp, meta, q_seg, q_fp, q_b, q_pb)
    _build.require_cuda(fp)
    if fp.data_ptr() % 16:
        raise ValueError("fp plane must be 16-byte aligned (rows load as uint4)")
    out = torch.empty((4, q_seg.numel()), dtype=torch.int32, device=fp.device)
    _build.check(_build.load().dash_fingerprint_probe(
        fp.data_ptr(), meta.data_ptr(), meta.shape[0], meta.shape[1],
        q_seg.data_ptr(), q_fp.data_ptr(), q_b.data_ptr(), q_pb.data_ptr(),
        q_seg.numel(), out.data_ptr(), _build.stream(fp)), "fingerprint_probe")
    LAUNCHES += 1
    return tuple(out)
