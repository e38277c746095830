"""Mixture-of-Experts layer: top-k routing with capacity-based dispatch — the
port of ``repro.models.moe``.

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

On a mesh (``parallel.sharding.use``) ``moe_apply`` chooses among the
reference's variants by the rules' flags, as the reference does: the
dense one (``_moe_dense``: every expert on every token, no dispatch),
``moe_apply_ep_shardmap`` (``_moe_ep``: E/n experts a rank of 'model',
tokens carried to them and back by two all-to-alls) and
``moe_apply_shardmap`` (``_moe_shardmap``: the experts int8-gathered from
their FSDP shards). In the two shard_map variants the MoE's weights are
this rank's f32 master shards and ``x`` holds this rank's batch rows;
capacity comes from the local S, as in the reference. Under the TP + SP
presets the plain and dense forms run on the whole sequence of this
rank's rows (``tp_in``) with this rank's expert (``train_ep``) or ``mlp``
(``train``, ``train_tp*``, ``train_multi_moe``) slice of the weights, and
the partial sums go back over 'model' (``tp_out``); the plain form's aux
fractions are means over the whole batch.
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.parallel import sharding as shd
from repro_torch.parallel.collectives import (all_gather, all_reduce_mean, all_to_all, group_for,
                                              tp_in, tp_out, tp_slice)
from repro_torch.parallel.compression import fsdp_gather_int8
from repro_torch.parallel.sharding import mesh_shape
from .layers import _weight, truncated_normal_


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int = 2
    capacity_factor: float = 1.25


def moe_capacity(cfg: MoEConfig, n_tokens: int) -> int:
    cap = int(cfg.capacity_factor * n_tokens * cfg.top_k / cfg.n_experts)
    return max(128, ((cap + 127) // 128) * 128)   # at least 128, a multiple of 128


def route(cfg: MoEConfig, x, router_w, cap: int, rows=None):
    """The dispatch of (B, S, d) rows: (gates (B, S*K) in x's dtype, experts
    (B, S*K) int64, keep (B, S*K) bool, aux loss f32). ``rows``: the group
    the batch's rows are split over, if any; the aux loss's two fractions
    are then means over the whole batch (averaged over the group before
    their product, as the reference's SPMD computes them)."""
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
    if rows is not None:
        me, ce = all_reduce_mean(me, rows), all_reduce_mean(ce, rows)
    aux = E * torch.sum(me * ce)
    flat = experts.reshape(B, S * K)
    return gate_vals.reshape(B, S * K).to(x.dtype), flat, _slots(flat, E) < cap, aux


def _slots(flat, E: int):
    """Each assignment's position in its expert: a cumsum over the row's
    (B, S*K) assignments."""
    onehot = F.one_hot(flat, E)
    return ((torch.cumsum(onehot, dim=1) - 1) * onehot).sum(-1)


def _moe_math(cfg: MoEConfig, x, router_w, wg, wu, wd, cap: int, e0: int = 0, rows=None):
    """Router -> row-local dispatch -> expert SwiGLU on the kept rows ->
    gate-weighted collect. ``wg``/``wu``/``wd`` hold experts ``e0`` on (all
    of them by default); the others' rows add nothing here. Returns (y (B,
    S, d), aux loss, experts (B, S*K))."""
    B, S, d = x.shape
    E, K = cfg.n_experts, cfg.top_k
    if rows is None:
        gates, experts, keep, aux = route(cfg, x, router_w, cap)
    else:
        gates, experts, keep, aux = route(cfg, x, router_w, cap, rows)
    # (token row, expert, gate) of every kept assignment, grouped by expert
    tok = (torch.arange(B, device=x.device)[:, None] * S
           + torch.arange(S, device=x.device).repeat_interleave(K)[None]).reshape(-1)
    if x.device.type == "meta":
        # no routing to read on the meta device (the dry run): every expert
        # takes ``cap`` rows of each batch row, as the reference's
        # zero-padded (B, E, cap, d) buffer multiplies them
        counts = [B * cap] * E
        order = torch.empty(E * B * cap, dtype=torch.long, device=x.device)
    else:
        e = torch.where(keep, experts, E).reshape(-1)
        order = torch.argsort(e, stable=True)
        counts = torch.bincount(e, minlength=E + 1)[:E].tolist()          # one host sync
    xf = x.reshape(B * S, d)
    y = torch.zeros_like(xf)
    start = 0
    for ei, n in enumerate(counts):
        if n and e0 <= ei < e0 + wg.shape[0]:
            sel = order[start:start + n]
            idx = tok[sel]
            xe = xf[idx]
            j = ei - e0
            ye = (F.silu(xe @ wg[j]) * (xe @ wu[j])) @ wd[j]
            # a token picks K distinct experts: no row repeats within one add
            y.index_add_(0, idx, ye * gates.reshape(-1)[sel, None])
        start += n
    return y.reshape(B, S, d), aux, experts


def _weights(params):
    if isinstance(params, dict):
        return params["router"], params["w_gate"], params["w_up"], params["w_down"]
    return params.router, params.w_gate, params.w_up, params.w_down


def moe_apply_shardmap(params, cfg: MoEConfig, x, mesh, batch_axes, weight_axes=None):
    """Explicit data-parallel MoE (the 'train_dp' layout): this rank owns
    its batch rows ``x`` and an FSDP shard of every expert weight. The
    router shard is cast to the compute dtype and all-gathered (its
    gradient reduce-scatters back); ``w_gate``/``w_up`` are int8-gathered
    on their embed axis (1) and ``w_down`` on its (2) over ``weight_axes``;
    the dispatch and FFN run locally; the aux loss is averaged over
    ``batch_axes``. ``params``: an ``MoE`` or a dict of the four shards."""
    router, wg, wu, wd = _weights(params)
    dt = x.dtype
    wx = group_for(mesh, tuple(weight_axes or batch_axes))
    router = all_gather(router.to(dt), wx, 0)
    wg = fsdp_gather_int8(wg, wx, 1, dt)    # int8 wire, use in dt,
    wu = fsdp_gather_int8(wu, wx, 1, dt)    # backward a bf16 reduce-scatter
    wd = fsdp_gather_int8(wd, wx, 2, dt)
    y, aux, routed = _moe_math(cfg, x, router, wg, wu, wd, moe_capacity(cfg, x.shape[1]))
    if not isinstance(params, dict):
        params.routed = routed
    return y, all_reduce_mean(aux, group_for(mesh, tuple(batch_axes)))


def moe_apply_ep_shardmap(params, cfg: MoEConfig, x, mesh, bx, ep_axis, fsdp_axes):
    """True expert parallelism: each rank of ``ep_axis`` owns E/n experts
    (FSDP-sharded over ``fsdp_axes`` on the embed dim); the rows' dispatch
    buffer goes to the experts' owners in one all-to-all and the results
    come home in another (activations move instead of expert weights).
    Requires n_experts % size(ep_axis) == 0."""
    router, wg, wu, wd = _weights(params)
    Bl, S, d = x.shape
    E = cfg.n_experts
    n_ep = mesh_shape(mesh)[ep_axis]
    if E % n_ep:
        raise ValueError(f"{E} experts over {n_ep} ranks of {ep_axis!r}")
    E_local = E // n_ep
    cap = moe_capacity(cfg, S)
    dt = x.dtype
    fx = group_for(mesh, tuple(fsdp_axes))
    router = all_gather(router.to(dt), fx, 0)
    wg = fsdp_gather_int8(wg, fx, 1, dt)      # (E_local, d, ff)
    wu = fsdp_gather_int8(wu, fx, 1, dt)
    wd = fsdp_gather_int8(wd, fx, 2, dt)

    gates, experts, keep, aux = route(cfg, x, router, cap)
    S_K = experts.shape[1]
    dst = torch.where(keep, experts * cap + _slots(experts, E), E * cap)
    tok = torch.arange(S, device=x.device).repeat_interleave(cfg.top_k)
    buf = x.new_zeros((Bl, E * cap + 1, d))
    buf = buf.index_put((torch.arange(Bl, device=x.device)[:, None].expand(Bl, S_K), dst),
                        x[:, tok])
    buf = buf[:, :E * cap]
    # the experts' blocks to their owners: one all-to-all out ...
    ep = group_for(mesh, (ep_axis,))
    recv = all_to_all(buf.reshape(Bl, n_ep, E_local * cap, d).movedim(1, 0), ep)
    eb = recv.reshape(n_ep * Bl, E_local, cap, d)
    g = torch.einsum("becd,edf->becf", eb, wg)
    u = torch.einsum("becd,edf->becf", eb, wu)
    yb = torch.einsum("becf,efd->becd", F.silu(g) * u, wd)
    # ... and the results home in the inverse one
    back = all_to_all(yb.reshape(n_ep, Bl, E_local * cap, d), ep)
    ysrc = back.movedim(0, 1).reshape(Bl, E * cap, d)
    vals = torch.gather(ysrc, 1, torch.clamp(dst, max=E * cap - 1)[..., None].expand(Bl, S_K, d))
    vals = torch.where(keep[..., None], vals, 0.0) * gates[..., None]
    y = x.new_zeros((Bl, S, d)).index_add(1, tok, vals)
    if not isinstance(params, dict):
        params.routed = experts
    return y, all_reduce_mean(aux, group_for(mesh, tuple(bx)))


def _slices(params, wg):
    """(first expert, whether the experts' output is a partial sum over
    'model') of an ``MoE`` whose weights may be this rank's expert or
    ``mlp`` slice (a dict of weights is whole)."""
    E, d_ff = getattr(params, "n_experts", wg.shape[0]), getattr(params, "d_ff", wg.shape[2])
    return tp_slice(E, wg.shape[0]), wg.shape[0] < E or wg.shape[2] < d_ff


def moe_apply_dense(params, cfg: MoEConfig, x):
    """Dispatch-free MoE (the serving presets, ``train_multi_moe``): EVERY
    expert on every token, gate-weighted (E/k more expert FLOPs, no scatter
    or gather; no token is dropped); the aux loss is 0. Under tensor
    parallelism on the whole sequence and this rank's expert / ``mlp``
    slice, the output a partial sum over 'model'."""
    router, wg, wu, wd = _weights(params)
    x = tp_in(x)
    dt = x.dtype
    e0, partial = _slices(params, wg)
    probs = torch.softmax((x @ router.to(dt)).float(), dim=-1)
    topv = torch.topk(probs, cfg.top_k, dim=-1).values
    gates = torch.where(probs >= topv[..., -1:], probs, 0.0)
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)          # (B, S, E)
    gates = gates[..., e0:e0 + wg.shape[0]]
    g = torch.einsum("bsd,edf->bsef", x, wg.to(dt))
    u = torch.einsum("bsd,edf->bsef", x, wu.to(dt))
    h = (F.silu(g) * u) * gates.to(dt)[..., None]
    y = torch.einsum("bsef,efd->bsd", h, wd.to(dt))
    return tp_out(y, partial), torch.zeros((), dtype=torch.float32, device=x.device)


def mesh_variant(cfg: MoEConfig, d: int, local_rows: int):
    """The variant ``moe_apply`` takes under the active mesh and rules, as
    the reference chooses it (``"dense"``, ``("ep", bx, fx)``,
    ``("shardmap", bx, wx)``), or None for the plain path. ``local_rows``
    is this rank's batch rows: the global batch is split over every batch
    axis the rules map to."""
    mesh = shd.active_mesh()
    if mesh is None:
        return None
    if shd.flag("_moe_dense"):
        return "dense"
    sizes = mesh_shape(mesh)
    B = local_rows * math.prod(sizes[a] for a in shd.batch_axes())
    if shd.flag("_moe_ep") and "model" in sizes and cfg.n_experts % sizes["model"] == 0:
        bx, fx = shd.batch_axes(B), shd.axes_for("embed", d)
        if bx and fx:
            return ("ep", bx, fx)
    if shd.flag("_moe_shardmap"):
        bx, wx = shd.batch_axes(B), shd.axes_for("embed", d)
        if bx and wx:
            return ("shardmap", bx, wx)
    return None


def moe_apply(w, cfg: MoEConfig, x):
    """x: (B, S, d) -> (B, S, d), plus the aux load-balancing loss. ``w`` is
    an ``MoE``; its ``routed`` keeps the last call's expert ids. On a mesh
    the rules' flags pick the variant (``mesh_variant``)."""
    variant = mesh_variant(cfg, x.shape[-1], x.shape[0])
    if variant == "dense":
        return moe_apply_dense(w, cfg, x)
    if variant is not None and variant[0] == "ep":
        return moe_apply_ep_shardmap(w, cfg, x, shd.active_mesh(), variant[1], "model",
                                     variant[2])
    if variant is not None:
        return moe_apply_shardmap(w, cfg, x, shd.active_mesh(), variant[1], variant[2])
    mesh = shd.active_mesh()
    rows = None
    if mesh is not None:
        sizes = mesh_shape(mesh)
        bx = shd.batch_axes(x.shape[0] * math.prod(sizes[a] for a in shd.batch_axes()))
        rows = group_for(mesh, bx) if bx else None
    # the whole sequence (tp_in), this rank's expert / mlp slice
    x = tp_in(x)
    e0, partial = _slices(w, w.w_gate)
    y, aux, w.routed = _moe_math(cfg, x, w.router, w.w_gate, w.w_up, w.w_down,
                                 moe_capacity(cfg, x.shape[1]), e0, rows)
    return tp_out(y, partial), aux


class MoE(nn.Module):
    """router (d, E), w_gate / w_up (E, d, d_ff), w_down (E, d_ff, d), in the
    compute dtype. ``routed``: the (B, S*K) expert ids of the last call."""

    def __init__(self, d: int, d_ff: int, cfg: MoEConfig, dtype, device):
        super().__init__()
        E = cfg.n_experts
        self.cfg = cfg
        self.n_experts, self.d_ff = E, d_ff
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
