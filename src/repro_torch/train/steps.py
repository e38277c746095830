"""Composed steps: train (forward + backward + AdamW), prefill, decode — the
port of ``repro.train.steps``. There is no jit and no buffer donation: a
train step updates the state's tensors in place and returns the same state.

Master weights. The reference keeps f32 parameters and casts them to the
compute dtype at every use. Here ``TrainState.params`` holds those f32
masters in the reference's tree (``blocks_<pi>`` leaves stacked on a
leading layer axis, ``tail_<ti>`` without one), and a train step runs a
working ``Transformer`` bound to them (``bind``): its compute-dtype weights
are the masters rounded to nearest even, refreshed from them at the start
of every step (so a restore into the masters reaches the next step), and
its f32 weights (RMSNorm scales, RG-LRU's ``lam``, RWKV's f32 vectors, and
every weight of an f32 model) are views of the masters themselves. The
serving model class is untouched; only the working model's weights have
``requires_grad`` on.

The gradient is taken with respect to the working weights, so a bf16
weight's gradient is bf16: the reference's gradient of the cast, whose
cotangent is bf16 too before it is widened. AdamW widens it to f32. At
full width the state costs about 16 bytes a parameter on the card: f32
masters, ``m`` and ``v`` (12), and the bf16 working weights and their
gradients (4).

On a mesh (``make_mesh_train_step``, ZeRO-3 under ``train_dp`` and
``train_dp_ep``) a rank holds only its shards of the masters, ``m`` and
``v`` (each leaf's placement from ``param_specs`` and the rules), and the
working model is gathered from them each step: 12 bytes a parameter
divided by the ranks, plus the full working weights and gradients.
"""
from __future__ import annotations

import dataclasses

import math
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.models.moe import mesh_variant
from repro_torch.models.transformer import (ModelConfig, Transformer, forward_train, loss_fn,
                                            param_specs, serve_step)
from repro_torch.optim import adamw
from repro_torch.optim.schedule import cosine_warmup
from repro_torch.parallel import sharding
from repro_torch.parallel.collectives import (all_reduce_, gather, group_for, reduce_scatter,
                                              reserve_staging)
from repro_torch.parallel.sharding import mesh_shape, spec_axes


class TrainState(NamedTuple):
    params: dict
    opt: adamw.AdamWState
    step: torch.Tensor


def param_paths(model: Transformer) -> list:
    """(path, index, parameter) of every weight of ``model``: ``path`` the
    reference's keys (``("blocks_0", "attn", "wq")``), ``index`` the layer
    index in a stacked ``blocks_<pi>`` leaf, or None."""
    out = []
    for name, p in model.named_parameters():
        parts = name.split(".")
        if parts[0] == "blocks":
            out.append(((f"blocks_{parts[1]}",) + tuple(parts[3:]), int(parts[2]), p))
        elif parts[0] == "tails":
            out.append(((f"tail_{parts[1]}",) + tuple(parts[2:]), None, p))
        else:
            out.append((tuple(parts), None, p))
    return out


def _at(tree: dict, path):
    for k in path:
        tree = tree[k]
    return tree


def _put(tree: dict, path, value) -> None:
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = value


def master_meta(cfg: ModelConfig) -> dict:
    """The reference's parameter tree of ``cfg`` as f32 tensors on the meta
    device (shapes, no storage)."""
    tree: dict = {}
    for path, index, p in param_paths(Transformer(cfg, "meta")):
        lead = (cfg.n_blocks,) if index is not None else ()
        _put(tree, path, torch.empty(lead + tuple(p.shape), dtype=torch.float32,
                                     device="meta"))
    return tree


@torch.no_grad()
def _stacked(cfg: ModelConfig, items) -> dict:
    """The reference's tree of f32 copies of ``items`` ((path, index,
    tensor) as ``param_paths`` gives them): ``blocks_<pi>`` leaves stacked
    on a leading layer axis."""
    tree: dict = {}
    for path, index, t in items:
        if index is None:
            _put(tree, path, t.detach().float().clone())
            continue
        if index == 0:
            _put(tree, path, torch.empty((cfg.n_blocks,) + tuple(t.shape),
                                         dtype=torch.float32, device=t.device))
        _at(tree, path)[index].copy_(t)
    return tree


def master_params(model: Transformer) -> dict:
    """f32 copies of ``model``'s weights in the reference's tree, on its
    device."""
    return _stacked(model.cfg, param_paths(model))


def train_state_init(params: dict) -> TrainState:
    """A state at step 0 over the f32 master tree ``params`` (see
    ``master_params``): zero moments, count and step."""
    device = adamw.leaves(params)[0].device
    return TrainState(params=params, opt=adamw.init(params),
                      step=torch.zeros((), dtype=torch.int32, device=device))


def state_to(state: TrainState, device) -> TrainState:
    """``state`` with every tensor on ``device`` (the same tensors where they
    are there already)."""
    return adamw.map_tree(lambda t: t.to(device), state)


class Bound(NamedTuple):
    """A working model over a state's masters: ``model``, and for each of
    its weights (in ``param_paths`` order) the parameter, its master, its
    ``m`` and ``v`` (views of the stacked leaves) and whether it aliases
    its master."""
    model: Transformer
    params: list
    masters: list
    m: list
    v: list
    aliased: list


def bind(cfg: ModelConfig, params: dict, m=None, v=None) -> Bound:
    """A ``Transformer`` in ``cfg``'s dtype on the masters' device whose
    weights hold gradients: f32 weights are views of the masters, the rest
    are filled from them by ``refresh``."""
    device = adamw.leaves(params)[0].device
    model = Transformer(cfg, device)
    ps, masters, ms, vs, aliased = [], [], [], [], []
    for path, index, p in param_paths(model):
        def view(tree):
            if tree is None:
                return None
            t = _at(tree, path)
            return t if index is None else t[index]
        master = view(params)
        if tuple(master.shape) != tuple(p.shape):
            raise ValueError(f"{'/'.join(path)}: master {tuple(master.shape)} for "
                             f"{tuple(p.shape)}")
        same = p.dtype == torch.float32
        if same:
            p.data = master
        p.requires_grad_(True)
        ps.append(p)
        masters.append(master)
        ms.append(view(m))
        vs.append(view(v))
        aliased.append(same)
    return Bound(model, ps, masters, ms, vs, aliased)


@torch.no_grad()
def refresh(b: Bound) -> None:
    """Round the masters into the working model's compute-dtype weights
    (nearest even, as the reference's cast at every use)."""
    for p, master, same in zip(b.params, b.masters, b.aliased):
        if not same:
            p.copy_(master)


def _backward(cfg: ModelConfig, b: Bound, batch):
    refresh(b)
    for p in b.params:
        p.grad = None
    loss, (ce, aux) = loss_fn(b.model, cfg, batch)
    loss.backward()
    grads = [torch.zeros_like(p) if p.grad is None else p.grad for p in b.params]
    return loss.detach(), ce.detach(), torch.as_tensor(aux).detach(), grads


def loss_and_grads(cfg: ModelConfig, params: dict, batch):
    """The twin of ``jax.value_and_grad(loss_fn, has_aux=True)(params, cfg,
    batch)`` over the master tree: (loss, (ce, aux), gradients in the
    reference's tree, f32)."""
    b = bind(cfg, params)
    loss, ce, aux, grads = _backward(cfg, b, batch)
    paths = [(path, index) for path, index, _ in param_paths(b.model)]
    return loss, (ce, aux), _stacked(cfg, [(p, i, g) for (p, i), g in zip(paths, grads)])


def make_train_step(cfg: ModelConfig, opt_cfg: adamw.AdamWConfig = adamw.AdamWConfig(),
                    peak_lr: float = 3e-4):
    """(state, batch) -> (state, metrics): the loss and its gradient through
    the working model, then AdamW on the masters at ``cosine_warmup(step)``;
    ``state`` is updated in place and returned. The working model is made
    on the first call and kept while the state's trees stay the same
    objects. ``metrics``: loss, ce, aux, lr, grad_norm (0-d tensors).

    Under a mesh (``sharding.use(mesh, rules)`` when the step is made) the
    step is ``make_mesh_train_step``'s: the state holds this rank's shards
    and the batch is the global one. Only the ZeRO-3 presets run there."""
    mesh = sharding.active_mesh()
    if mesh is not None:
        return make_mesh_train_step(cfg, mesh, sharding.active_rules_name(), opt_cfg, peak_lr)
    held = {}

    def step(state: TrainState, batch):
        trees = (state.params, state.opt.m, state.opt.v)
        if held.get("trees") is None or any(a is not b for a, b in zip(held["trees"], trees)):
            held["trees"], held["bound"] = trees, bind(cfg, *trees)
        b = held["bound"]
        loss, ce, aux, grads = _backward(cfg, b, batch)
        lr = cosine_warmup(state.step, peak_lr=peak_lr)
        _, _, om = adamw.update(opt_cfg, grads, adamw.AdamWState(b.m, b.v, state.opt.count),
                                b.masters, lr)
        state.step.add_(1)
        return state, {"loss": loss, "ce": ce, "aux": aux, "lr": lr, **om}

    return step


def make_prefill_step(cfg: ModelConfig):
    """Forward-only (inference prefill) of ``params``, a ``Transformer``:
    logits of the full prompt."""

    @torch.no_grad()
    def step(params: Transformer, batch):
        logits, _ = forward_train(params, cfg, batch)
        return logits

    return step


def make_serve_step(cfg: ModelConfig):
    """One decode token against the KV cache / recurrent state."""

    def step(params: Transformer, state, inputs):
        return serve_step(params, cfg, state, inputs)

    return step


# ---------------------------------------------------------------------------
# training on a mesh: ZeRO-3 (train_dp, train_dp_ep)
# ---------------------------------------------------------------------------

def layout_leaves(layout, path=()):
    """(path, placement) of every leaf of ``layout``, keys sorted (the
    order ``adamw.leaves`` walks a tree in)."""
    if isinstance(layout, dict):
        return [x for k in sorted(layout) for x in layout_leaves(layout[k], path + (k,))]
    return [(path, layout)]


def mesh_layout(cfg: ModelConfig, mesh=None, rules=None) -> dict:
    """This rank's ``Placement`` of every leaf of ``cfg``'s master tree on
    ``mesh`` under ``rules`` (default: the active pair), from
    ``param_specs``."""
    return sharding.tree_shardings(param_specs(cfg), mesh, rules, shape_tree=master_meta(cfg))


def take_shard(placement, full, device) -> torch.Tensor:
    """A copy of this rank's shard of ``full`` (a tensor, a numpy array or
    a commit's lazy tensor) on ``device``."""
    if hasattr(full, "get"):
        full = full.get()
    if isinstance(full, np.ndarray):
        idx = tuple(slice(a, a + n) for a, n in placement.slices)
        return torch.from_numpy(np.array(full[idx])).to(device)
    out = torch.empty(placement.local_shape, dtype=full.dtype, device=device)
    return out.copy_(placement.take(full))


def shard_tree(tree, layout, device) -> dict:
    """This rank's shards (copies on ``device``) of a tree of full leaves."""
    return sharding.tree_map(lambda pl, full: take_shard(pl, full, device), layout, tree)


def gather_leaf(shard: torch.Tensor, placement, mesh) -> torch.Tensor:
    """The full leaf from every rank's shard (collective over the leaf's
    sharded axes; no gradient)."""
    for d, entry in enumerate(placement.spec):
        if entry is not None:
            shard = gather(shard, group_for(mesh, spec_axes(entry)), d)
    return shard


def gather_tree(tree, layout, mesh) -> dict:
    """The full leaves of a tree of shards (collective)."""
    return sharding.tree_map(lambda pl, t: gather_leaf(t, pl, mesh), layout, tree)


def init_mesh_state(cfg: ModelConfig, seed: int, mesh, device, layout=None) -> TrainState:
    """This rank's shards of the step-0 state ``trainer.init_state(cfg,
    seed, ...)`` draws: the f32 initialisation is drawn whole on ``device``
    (the same draws on every rank) and only this rank's shards are kept."""
    from repro_torch.models.transformer import init_params
    layout = layout or mesh_layout(cfg, mesh)
    model = init_params(dataclasses.replace(cfg, dtype="float32"), seed, device)
    shards: dict = {}
    flat = dict(layout_leaves(layout))
    for path, index, p in param_paths(model):
        pl = flat[path]
        if index is None:
            _put(shards, path, take_shard(pl, p.detach(), device))
            continue
        one = pl._replace(slices=pl.slices[1:])
        if index == 0:
            _put(shards, path, torch.empty(pl.local_shape, dtype=torch.float32, device=device))
        _at(shards, path)[index].copy_(one.take(p.detach()))
    del model
    return train_state_init(shards)


def _unmentioned(placement, mesh) -> tuple:
    """The mesh axes a leaf is replicated over (in the mesh's order)."""
    used = {a for e in placement.spec for a in spec_axes(e)}
    return tuple(a for a in mesh.mesh_dim_names if a not in used)


class _Leaf:
    """One leaf of the master tree on this rank: its placement, master /
    ``m`` / ``v`` shards, the working model's parameters that use it
    ((index, parameter)), and either a full working buffer gathered from
    the masters each step or, for an MoE shard_map variant's expert
    leaves, none (the parameters are views of the master shard)."""

    def __init__(self, path, placement, master, m, v, variant: bool):
        self.path, self.placement = path, placement
        self.master, self.m, self.v = master, m, v
        self.variant = variant
        self.params: list = []
        self.work = None


class MeshBound(NamedTuple):
    model: Transformer
    leaves: list
    mesh: object
    world: object


def _variant_leaves(cfg: ModelConfig) -> bool:
    """Whether an MoE's weights stay shards under the active rules (the
    variant int8-gathers them itself)."""
    if cfg.n_experts == 0:
        return False
    return mesh_variant(cfg.moe_cfg(), cfg.d_model, 1) not in (None, "dense")


def bind_mesh(cfg: ModelConfig, params: dict, m: dict, v: dict, mesh, layout) -> MeshBound:
    """A full ``Transformer`` on the shards' device whose weights are the
    working copies of the masters: a gathered buffer a leaf (in the
    weight's dtype; ``refresh_mesh`` fills it), except the MoE leaves an
    MoE variant gathers itself, whose weights are the f32 master shards."""
    device = adamw.leaves(params)[0].device
    model = Transformer(cfg, device)
    variant = _variant_leaves(cfg)
    by_path = {}
    for path, pl in layout_leaves(layout):
        by_path[path] = _Leaf(path, pl, _at(params, path), _at(m, path), _at(v, path),
                              variant and "moe" in path)
    for path, index, p in param_paths(model):
        leaf = by_path[path]
        if leaf.variant:
            p.data = leaf.master if index is None else leaf.master[index]
        else:
            if leaf.work is None:
                leaf.work = torch.empty(leaf.placement.shape, dtype=p.dtype, device=device)
            p.data = leaf.work if index is None else leaf.work[index]
        p.requires_grad_(True)
        leaf.params.append((index, p))
    if device.type == "cuda":
        # the largest tensor a step stages: a leaf's full working copy, or
        # its full gradient in the same dtype
        reserve_staging(max(l.work.numel() * l.work.element_size()
                            for l in by_path.values() if l.work is not None))
    return MeshBound(model, list(by_path.values()), mesh,
                     group_for(mesh, tuple(mesh.mesh_dim_names)))


@torch.no_grad()
def refresh_mesh(b: MeshBound) -> None:
    """Each gathered leaf's working buffer from the masters: every shard
    rounded to the weight's dtype (nearest even), then all-gathered."""
    for leaf in b.leaves:
        if not leaf.variant:
            leaf.work.copy_(gather_leaf(leaf.master.to(leaf.work.dtype), leaf.placement, b.mesh))


@torch.no_grad()
def _sync_grads(b: MeshBound) -> list:
    """Each leaf's gradient shard, summed over the ranks: a gathered leaf's
    full gradient reduce-scattered over its sharded axes (in the weight's
    dtype), a variant's shard as its gather's backward left it; then
    all-reduced over the axes the leaf is replicated on."""
    out = []
    for leaf in b.leaves:
        gs = [torch.zeros_like(p) if p.grad is None else p.grad for _, p in leaf.params]
        g = gs[0] if leaf.params[0][0] is None else torch.stack(gs)
        if not leaf.variant:
            for d, entry in enumerate(leaf.placement.spec):
                if entry is not None:
                    g = reduce_scatter(g, group_for(b.mesh, spec_axes(entry)), d)
        rest = _unmentioned(leaf.placement, b.mesh)
        if rest:
            all_reduce_(g, group_for(b.mesh, rest))
        out.append(g)
        for _, p in leaf.params:
            p.grad = None
    return out


@torch.no_grad()
def _mesh_norm(b: MeshBound, grads: list) -> torch.Tensor:
    """The global norm of the gradient with each element counted once: a
    shard's squares over its replicas, summed over the world."""
    sizes = mesh_shape(b.mesh)
    total = sum(torch.sum(torch.square(g.float()))
                / math.prod(sizes[a] for a in _unmentioned(leaf.placement, b.mesh))
                for leaf, g in zip(b.leaves, grads))
    return torch.sqrt(all_reduce_(total.reshape(1), b.world)[0])


def _mesh_loss(model: Transformer, cfg: ModelConfig, batch, world, aux_weight: float = 0.01,
               z_weight: float = 1e-4):
    """This rank's share of the reference's loss over the GLOBAL batch: the
    masked sums over its rows divided by the all-reduced mask count, plus
    its share of the aux loss (the MoE variants average it over the ranks
    already). The shares sum to the loss. Returns (share, (loss, ce, aux)),
    the metrics global."""
    logits, aux = forward_train(model, cfg, batch)
    labels = batch["labels"]
    if cfg.family == "vlm":
        logits = logits[:, -labels.shape[1]:]
    mask = (labels >= 0).float()
    safe = torch.clamp(labels, min=0).long()
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, safe[..., None])[..., 0]
    sums = torch.stack([torch.sum((lse - ll) * mask), torch.sum(torch.square(lse) * mask),
                        mask.sum()])
    totals = all_reduce_(sums.detach().clone(), world)
    n = torch.clamp(totals[2], min=1.0)
    aux = torch.as_tensor(aux, dtype=torch.float32, device=logits.device)
    share = sums[0] / n + aux_weight * aux / world.size + z_weight * sums[1] / n
    ce = totals[0] / n
    loss = ce + aux_weight * aux.detach() + z_weight * (totals[1] / n)
    return share, (loss, ce, aux.detach())


def local_rows(batch: dict, world) -> dict:
    """This rank's rows of the global batch: rows split over every rank, in
    the order of the rank's index over the mesh (the first axis major), as
    the batch axes shard them."""
    B = next(iter(batch.values())).shape[0]
    if B % world.size:
        raise ValueError(f"a global batch of {B} rows does not split over {world.size} ranks")
    n = B // world.size
    return {k: v[world.index * n:(world.index + 1) * n] for k, v in batch.items()}


def make_mesh_train_step(cfg: ModelConfig, mesh, rules: str,
                         opt_cfg: adamw.AdamWConfig = adamw.AdamWConfig(),
                         peak_lr: float = 3e-4):
    """The ZeRO-3 train step on ``mesh`` under ``rules`` (``train_dp`` or
    ``train_dp_ep``): (state of this rank's shards, the global batch) ->
    (state, metrics), updated in place, every rank calling it together.

    Each step gathers the working model from the master shards (each shard
    rounded to the weight's dtype, then all-gathered; an MoE variant's
    expert leaves are int8-gathered inside the variant instead), runs the
    forward and backward on this rank's rows, reduce-scatters each sharded
    leaf's gradient and all-reduces each replicated one, takes the global
    norm over every rank and runs AdamW on the local shards. The metrics
    (loss, ce, aux, lr, grad_norm) are the global ones, the same on every
    rank. ``step.held["grads"]`` keeps the last step's gradient shards.
    Any other preset raises: the TP+SP and serving presets do not run on a
    mesh in the port."""
    if rules not in sharding.MESH_PRESETS:
        raise ValueError(f"preset {rules!r} does not run on a mesh in the port (only "
                         f"{', '.join(sharding.MESH_PRESETS)}: the TP+SP and serving presets "
                         f"are a later slice)")
    with sharding.use(mesh, rules):
        layout = mesh_layout(cfg, mesh)
    held: dict = {}

    def step(state: TrainState, batch):
        with sharding.use(mesh, rules):
            trees = (state.params, state.opt.m, state.opt.v)
            if held.get("trees") is None or any(a is not b for a, b in zip(held["trees"], trees)):
                held["trees"] = trees
                held["bound"] = bind_mesh(cfg, *trees, mesh, layout)
            b = held["bound"]
            rows = local_rows(batch, b.world)
            refresh_mesh(b)
            share, (loss, ce, aux) = _mesh_loss(b.model, cfg, rows, b.world)
            share.backward()
            grads = _sync_grads(b)
            gnorm = _mesh_norm(b, grads)
            lr = cosine_warmup(state.step, peak_lr=peak_lr)
            adamw.update(opt_cfg, grads,
                         adamw.AdamWState([l.m for l in b.leaves], [l.v for l in b.leaves],
                                          state.opt.count),
                         [l.master for l in b.leaves], lr, gnorm=gnorm)
            state.step.add_(1)
            held["grads"] = grads
        return state, {"loss": loss, "ce": ce, "aux": aux, "lr": lr, "grad_norm": gnorm}

    step.held = held
    step.layout = layout
    return step
