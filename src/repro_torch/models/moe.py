"""Mixture-of-Experts layer: top-k routing with capacity-based dispatch — the
port of ``repro.models.moe`` off a mesh (``moe_apply``'s last branch).

The dispatch decisions are the reference's, integer for integer: top-k of
the f32 softmax of the router product (ties to the lower expert index),
each batch row's position-in-expert as a cumsum over its S*K assignments in
token-major, k-minor order, and ``keep = slot < cap``. The experts then run
on the rows the dispatch keeps (gather, SwiGLU, scatter-add of the
gate-weighted rows in the compute dtype), not on the reference's
zero-padded (B, E, cap, d) buffer: a dropped or empty slot adds nothing
there either. At decode ``cap`` is at
least 128 for one token, so the buffer form would run E * 128 rows a lane
for K real ones.

The reference's mesh variants (``moe_apply_shardmap``,
``moe_apply_ep_shardmap``, ``moe_apply_dense``) come with the parallel
layer (ROADMAP Queue 1, entry 15c).
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F
from torch import nn

from .layers import _weight, truncated_normal_


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int = 2
    capacity_factor: float = 1.25


def moe_capacity(cfg: MoEConfig, n_tokens: int) -> int:
    cap = int(cfg.capacity_factor * n_tokens * cfg.top_k / cfg.n_experts)
    return max(128, ((cap + 127) // 128) * 128)   # at least 128, a multiple of 128


def route(cfg: MoEConfig, x, router_w, cap: int):
    """The dispatch of (B, S, d) rows: (gates (B, S*K) in x's dtype, experts
    (B, S*K) int64, keep (B, S*K) bool, aux loss f32)."""
    B, S, _ = x.shape
    E, K = cfg.n_experts, cfg.top_k
    probs = torch.softmax((x @ router_w).float(), dim=-1)                  # (B, S, E)
    # top-k by a stable descending sort: equal probabilities (bf16 router
    # products tie often) go to the lower expert index, as in lax.top_k;
    # torch.topk breaks such ties otherwise
    gate_vals, experts = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_vals, experts = gate_vals[..., :K], experts[..., :K]             # (B, S, K)
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True), min=1e-9)
    me = probs.mean(dim=(0, 1))
    ce = F.one_hot(experts[..., 0], E).float().mean(dim=(0, 1))
    aux = E * torch.sum(me * ce)
    flat = experts.reshape(B, S * K)
    onehot = F.one_hot(flat, E)
    slot = ((torch.cumsum(onehot, dim=1) - 1) * onehot).sum(-1)
    return gate_vals.reshape(B, S * K).to(x.dtype), flat, slot < cap, aux


def _moe_math(cfg: MoEConfig, x, router_w, wg, wu, wd, cap: int):
    """Router -> row-local dispatch -> expert SwiGLU on the kept rows ->
    gate-weighted collect. Returns (y (B, S, d), aux loss, experts (B, S*K))."""
    B, S, d = x.shape
    E, K = cfg.n_experts, cfg.top_k
    gates, experts, keep, aux = route(cfg, x, router_w, cap)
    # (token row, expert, gate) of every kept assignment, grouped by expert
    tok = (torch.arange(B, device=x.device)[:, None] * S
           + torch.arange(S, device=x.device).repeat_interleave(K)[None]).reshape(-1)
    e = torch.where(keep, experts, E).reshape(-1)
    order = torch.argsort(e, stable=True)
    counts = torch.bincount(e, minlength=E + 1)[:E].tolist()              # one host sync
    xf = x.reshape(B * S, d)
    y = torch.zeros_like(xf)
    start = 0
    for ei, n in enumerate(counts):
        if n:
            sel = order[start:start + n]
            rows = tok[sel]
            xe = xf[rows]
            ye = (F.silu(xe @ wg[ei]) * (xe @ wu[ei])) @ wd[ei]
            # a token picks K distinct experts: no row repeats within one add
            y.index_add_(0, rows, ye * gates.reshape(-1)[sel, None])
        start += n
    return y.reshape(B, S, d), aux, experts


def moe_apply(w, cfg: MoEConfig, x):
    """x: (B, S, d) -> (B, S, d), plus the aux load-balancing loss. ``w`` is
    an ``MoE``; its ``routed`` keeps the last call's expert ids."""
    y, aux, w.routed = _moe_math(cfg, x, w.router, w.w_gate, w.w_up, w.w_down,
                                 moe_capacity(cfg, x.shape[1]))
    return y, aux


class MoE(nn.Module):
    """router (d, E), w_gate / w_up (E, d, d_ff), w_down (E, d_ff, d), in the
    compute dtype. ``routed``: the (B, S*K) expert ids of the last call."""

    def __init__(self, d: int, d_ff: int, cfg: MoEConfig, dtype, device):
        super().__init__()
        E = cfg.n_experts
        self.cfg = cfg
        self.router = _weight((d, E), dtype, device)
        self.w_gate = _weight((E, d, d_ff), dtype, device)
        self.w_up = _weight((E, d, d_ff), dtype, device)
        self.w_down = _weight((E, d_ff, d), dtype, device)
        self.routed = None

    def init(self, generator):
        """``moe_init``'s distributions (each expert drawn in turn, so the
        f32 draw buffer stays one expert's size)."""
        d, d_ff = self.w_gate.shape[1:]
        truncated_normal_(self.router, 1.0 / math.sqrt(d), generator)
        for w, scale in ((self.w_gate, 1.0 / math.sqrt(d)), (self.w_up, 1.0 / math.sqrt(d)),
                         (self.w_down, 1.0 / math.sqrt(d_ff))):
            for ei in range(w.shape[0]):
                truncated_normal_(w[ei], scale, generator)

    def forward(self, x):
        return moe_apply(self, self.cfg, x)
