"""Gradient compression for the DP all-reduce: int8 quantization with error
feedback, and the int8 FSDP weight gather — the port of
``repro.parallel.compression`` on ``torch.distributed``.

Per-tensor symmetric int8 quantization cuts a gradient all-reduce's wire
bytes 4x; the quantization error is carried in a residual buffer and
added back next step (error feedback). ``fsdp_gather_int8`` all-gathers an
FSDP weight shard in int8 with per-(shard, out-channel) scales; its
backward is the bf16 reduce-scatter of the output's gradient, widened to
f32 (straight-through across the quantization).

The reference's axis names become the port's groups: ``compressed_psum``
takes an ``AxisGroup`` (``parallel.collectives``) where the reference takes
an axis name; its ``pmax`` is an ``all_reduce(MAX)`` and its int32 ``psum``
an ``all_reduce(SUM)``. Quantize and dequantize are plain torch ops, as
they are ``jnp`` in the reference.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.optim.adamw import leaves
from .collectives import AxisGroup, all_reduce_, gather, reduce_scatter
from .sharding import tree_map


#: the reference's compiled steps scale by the f32 reciprocal of 127: XLA
#: rewrites the division by the constant into this product (it differs
#: from the quotient in the last bit for some inputs)
INV_127 = float(np.float32(1.0) / np.float32(127.0))


def _quantize(x):
    scale = torch.clamp(torch.max(torch.abs(x)), min=1e-12) * INV_127
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def _dequantize(q, scale):
    return q.to(torch.float32) * scale


def compressed_psum(grads, residuals, group: AxisGroup):
    """int8 + error-feedback mean over ``group``.

    Each leaf: e = g + residual; q = int8(e) at the group's largest scale
    (so the integer sum is well-defined); the mean is sum(q) * scale / n
    (wire: 1 byte an element); the new residual is e - dequant(q). Returns
    (means in each gradient's dtype, residuals f32), trees like ``grads``."""
    def one(g, r):
        e = g.to(torch.float32) + r
        _, scale = _quantize(e)
        scale = all_reduce_(scale.clone(), group, torch.distributed.ReduceOp.MAX)
        q = torch.clamp(torch.round(e / scale), -127, 127).to(torch.int8)
        total = all_reduce_(q.to(torch.int32), group)
        mean = total.to(torch.float32) * scale / float(group.size)
        # e - q * scale rounded once, as the reference's compiled step fuses
        # it into one multiply-add: q * scale is exact in f64, and so is the
        # difference (|e - q * scale| <= scale / 2)
        new_r = (e.double() - q.double() * scale.double()).to(torch.float32)
        return mean.to(g.dtype), new_r

    out = tree_map(one, grads, residuals)
    return tree_map(lambda pair: pair[0], out), tree_map(lambda pair: pair[1], out)


def init_residuals(grads):
    return tree_map(lambda g: torch.zeros(g.shape, dtype=torch.float32, device=g.device), grads)


class _GatherInt8(torch.autograd.Function):
    @staticmethod
    def forward(ctx, w_shard, group, gather_axis, out_dtype):
        ctx.group, ctx.axis = group, gather_axis
        scale = torch.amax(torch.abs(w_shard), dim=gather_axis, keepdim=True) * INV_127
        scale = torch.clamp(scale, min=1e-12)
        q = torch.clamp(torch.round(w_shard / scale), -127, 127).to(torch.int8)
        qg = gather(q, group, gather_axis)
        sg = gather(scale.to(torch.float32), group, gather_axis)
        # broadcast each shard's scale over its block of the gathered axis
        sg = torch.repeat_interleave(sg, qg.shape[gather_axis] // sg.shape[gather_axis],
                                     dim=gather_axis)
        return (qg.to(torch.float32) * sg).to(out_dtype)

    @staticmethod
    def backward(ctx, g):
        g_shard = reduce_scatter(g.to(torch.bfloat16), ctx.group, ctx.axis)
        return g_shard.to(torch.float32), None, None, None


def fsdp_gather_int8(w_shard, group: AxisGroup, gather_axis: int, out_dtype):
    """All-gather an FSDP weight shard over ``group`` along ``gather_axis``
    in int8 (4x less wire than f32, 2x less than bf16), dequantized in f32
    with per-(shard, out-channel) scales (the max over the gathered axis)
    and cast to ``out_dtype``. Backward: the reduce-scatter of the output's
    gradient in bf16, widened to f32."""
    return _GatherInt8.apply(w_shard, group, gather_axis, out_dtype)


def wire_bytes(tree, compressed: bool) -> int:
    """Analytic wire bytes of one DP sync (for the perf log)."""
    elems = sum(int(math.prod(x.shape)) for x in leaves(tree))
    return elems * (1 if compressed else 4)
