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

On a mesh (``make_mesh_train_step``: every preset of
``sharding.presets()``) a rank holds only its shards of the masters,
``m`` and ``v`` (each leaf's placement from ``param_specs`` and the
rules), and the working model is gathered from them each step: 12 bytes a
parameter divided by the ranks, plus the working weights and gradients,
whole under ZeRO-3 (``train_dp``, ``train_dp_ep``) and this rank's slice
over 'model' where the TP + SP presets keep a dim sharded at use
(``use_keep``).

A serve step on a mesh (``make_mesh_serve_step``, the serving presets)
holds this rank's bf16 weight slices once (``mesh_serve_params``) and its
piece of the decode state from step to step (``decode_state_piece``).
"""
from __future__ import annotations

import dataclasses

import math
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.models.layers import vocab_parallel_lse
from repro_torch.models.moe import mesh_variant
from repro_torch.models.transformer import (ModelConfig, Transformer, decode_state_init,
                                            decode_state_specs, forward_train, loss_fn,
                                            param_specs, serve_step)
from repro_torch.optim import adamw
from repro_torch.optim.schedule import cosine_warmup
from repro_torch.parallel import sharding
from repro_torch.parallel.collectives import (all_reduce_, gather, group_for, reduce_scatter,
                                              reserve_staging, seq_shard)
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
    and the batch is the global one. Every preset runs there (``decode``
    trains as ``train_tp_nosp`` does: its cache rule has nothing to
    place)."""
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
    logits of the full prompt. Under a mesh (``sharding.use(mesh, rules)``
    when the step is made) the step is ``make_mesh_prefill_step``'s."""
    mesh = sharding.active_mesh()
    if mesh is not None:
        return make_mesh_prefill_step(cfg, mesh, sharding.active_rules_name())

    @torch.no_grad()
    def step(params: Transformer, batch):
        logits, _ = forward_train(params, cfg, batch)
        return logits

    return step


def make_serve_step(cfg: ModelConfig):
    """One decode token against the KV cache / recurrent state. Under a
    mesh (``sharding.use(mesh, rules)`` when the step is made) the step is
    ``make_mesh_serve_step``'s."""
    mesh = sharding.active_mesh()
    if mesh is not None:
        return make_mesh_serve_step(cfg, mesh, sharding.active_rules_name())

    def step(params: Transformer, state, inputs):
        return serve_step(params, cfg, state, inputs)

    return step


# ---------------------------------------------------------------------------
# training on a mesh: ZeRO-3 (train_dp, train_dp_ep) and TP + SP (train,
# train_tp, train_tp_nosp, train_ep, train_multi_moe, prefill_moe)
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


def gather_leaf(shard: torch.Tensor, placement, mesh, keep=()) -> torch.Tensor:
    """The full leaf from every rank's shard (collective over the leaf's
    sharded axes; no gradient); the dims in ``keep`` stay this rank's
    slice."""
    for d, entry in enumerate(placement.spec):
        if entry is not None and d not in keep:
            shard = gather(shard, group_for(mesh, spec_axes(entry)), d)
    return shard


def gather_tree(tree, layout, mesh) -> dict:
    """The full leaves of a tree of shards (collective)."""
    return sharding.tree_map(lambda pl, t: gather_leaf(t, pl, mesh), layout, tree)


def mesh_shards(model: Transformer, layout, device) -> dict:
    """This rank's shards (f32 copies on ``device``) of ``model``'s weights
    in the reference's tree, under ``layout``."""
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
    return shards


def init_mesh_state(cfg: ModelConfig, seed: int, mesh, device, layout=None) -> TrainState:
    """This rank's shards of the step-0 state ``trainer.init_state(cfg,
    seed, ...)`` draws: the f32 initialisation is drawn whole on ``device``
    (the same draws on every rank) and only this rank's shards are kept."""
    from repro_torch.models.transformer import init_params
    layout = layout or mesh_layout(cfg, mesh)
    model = init_params(dataclasses.replace(cfg, dtype="float32"), seed, device)
    shards = mesh_shards(model, layout, device)
    del model
    return train_state_init(shards)


def _unmentioned(placement, mesh) -> tuple:
    """The mesh axes a leaf is replicated over (in the mesh's order)."""
    used = {a for e in placement.spec for a in spec_axes(e)}
    return tuple(a for a in mesh.mesh_dim_names if a not in used)


#: the dims a weight may keep sharded over 'model' at use (the reference's
#: ``wuse`` names, and the unit a slice must hold whole), by the leaf's
#: last two keys; every other sharded dim is gathered
_USE = {("attn", "wq"): ((-1, "heads"),), ("attn", "wk"): ((-1, "kv"),),
        ("attn", "wv"): ((-1, "kv"),), ("attn", "wo"): ((-2, "heads"),),
        ("mlp", "w_gate"): ((-1, None),), ("mlp", "w_up"): ((-1, None),),
        ("mlp", "w_down"): ((-2, None),),
        ("moe", "w_gate"): ((-3, None), (-1, None)), ("moe", "w_up"): ((-3, None), (-1, None)),
        ("moe", "w_down"): ((-3, None), (-2, None)),
        ("rnn", "w_x"): ((-1, None),), ("rnn", "w_gate"): ((-1, None),),
        ("rnn", "w_out"): ((-2, None),), ("rnn", "conv_w"): ((-1, None),),
        ("rnn", "lam"): ((-1, None),),
        **{("tm", k): ((-1, "rwkv"),) for k in ("w_r", "w_k", "w_v", "w_g", "w_decay",
                                                 "decay_base", "bonus_u")},
        ("tm", "w_o"): ((-2, "rwkv"),), ("tm", "cm_k"): ((-1, None),),
        ("tm", "cm_v"): ((-2, None),),
        ("embed", "table"): ((0, None),), ("lm_head", "w"): ((-1, "vocab"),)}


def use_keep(cfg: ModelConfig, path, placement, mesh) -> tuple:
    """The dims of a leaf that stay this rank's slice over 'model' in the
    working model under the active rules: a dim sharded over 'model' alone
    whose use keeps it so (``_USE``), where the slice holds whole heads
    (query heads; kv heads that split with them; RWKV's 64-wide heads);
    the lm head's vocabulary only without sequence parallelism (the
    reference's logits then carry the sequence over 'model', so the head is
    whole). Nothing stays sliced where the batch is split over 'model'
    (ZeRO-3): the 'model' ranks hold other rows there."""
    if "model" in sharding.batch_axes():
        return ()
    m = mesh_shape(mesh).get("model", 1)
    units = {None: True, "heads": cfg.n_heads % m == 0,
             "kv": cfg.n_heads % m == 0 and cfg.n_kv_heads % m == 0,
             "rwkv": (cfg.d_model // 64) % m == 0, "vocab": not sharding.seq_parallel()}
    n = len(placement.shape)
    return tuple(d % n for d, unit in _USE.get(tuple(path[-2:]), ())
                 if placement.spec[d] == "model" and units[unit])


class _Leaf:
    """One leaf of the master tree on this rank: its placement, the dims
    its working copy keeps sharded (``keep``), master / ``m`` / ``v``
    shards, the working model's parameters that use it ((index,
    parameter)), and either a working buffer gathered from the masters each
    step or, for an MoE shard_map variant's expert leaves, none (the
    parameters are views of the master shard)."""

    def __init__(self, path, placement, keep, master, m, v, variant: bool):
        self.path, self.placement, self.keep = path, placement, keep
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
    """A ``Transformer`` on the shards' device whose weights are the working
    copies of the masters: a gathered buffer a leaf (in the weight's dtype,
    whole but for its ``use_keep`` dims; ``refresh_mesh`` fills it), except
    the MoE leaves an MoE variant gathers itself, whose weights are the f32
    master shards."""
    device = adamw.leaves(params)[0].device
    model = Transformer(cfg, device)
    variant = _variant_leaves(cfg)
    by_path = {}
    for path, pl in layout_leaves(layout):
        by_path[path] = _Leaf(path, pl, use_keep(cfg, path, pl, mesh), _at(params, path),
                              _at(m, path), _at(v, path), variant and "moe" in path)
    for path, index, p in param_paths(model):
        leaf = by_path[path]
        if leaf.variant:
            p.data = leaf.master if index is None else leaf.master[index]
        else:
            if leaf.work is None:
                shape = [n if d in leaf.keep else leaf.placement.shape[d]
                         for d, n in enumerate(leaf.placement.local_shape)]
                leaf.work = torch.empty(shape, dtype=p.dtype, device=device)
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
            leaf.work.copy_(gather_leaf(leaf.master.to(leaf.work.dtype), leaf.placement, b.mesh,
                                        leaf.keep))


@torch.no_grad()
def _sync_grads(b: MeshBound) -> list:
    """Each leaf's gradient shard, summed over the ranks: a working copy's
    gradient reduce-scattered over the axes it was gathered over (in the
    weight's dtype; a kept dim is this rank's already), a variant's shard
    as its gather's backward left it; then all-reduced over the axes the
    leaf is replicated on. Every rank's backward starts from its share of
    the loss, so a replicated leaf's gradient is a partial sum there
    (under sequence parallelism a norm sees this rank's tokens; without it
    this rank's share of each cotangent)."""
    out = []
    for leaf in b.leaves:
        gs = [torch.zeros_like(p) if p.grad is None else p.grad for _, p in leaf.params]
        g = gs[0] if leaf.params[0][0] is None else torch.stack(gs)
        if not leaf.variant:
            for d, entry in enumerate(leaf.placement.spec):
                if entry is not None and d not in leaf.keep:
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
    masked sums over the tokens of its logits' block divided by the
    all-reduced mask count, plus its share of the aux loss (the same on
    every rank: the plain MoE's fractions and the variants' aux are
    averaged over the ranks). A token that several ranks hold whole (every
    'model' rank without sequence parallelism) is in each one's count, so
    each holds its share of it: the shares sum to the loss. Returns (share,
    (loss, ce, aux)), the metrics global. The block is this rank's rows,
    and under sequence parallelism its piece of the sequence (the labels
    cut to it; a vlm's patch positions masked); logits of a vocabulary
    slice (without sequence parallelism) take their logsumexp over
    'model'."""
    logits, aux = forward_train(model, cfg, batch)
    labels = batch["labels"]
    if cfg.family == "vlm":
        labels = F.pad(labels, (batch["patch_embeds"].shape[1], 0), value=-1)
    labels = seq_shard(labels)
    mask = (labels >= 0).float()
    safe = torch.clamp(labels, min=0).long()
    if logits.shape[-1] < cfg.vocab_size:
        lse, ll = vocab_parallel_lse(logits, safe, cfg.vocab_size)
    else:
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


def local_rows(batch: dict, rows) -> dict:
    """This rank's rows of the global batch: rows split over the ranks of
    ``rows`` (the group of the batch axes), in the order of the rank's index
    over them (the first axis major), as the batch axes shard them."""
    B = next(iter(batch.values())).shape[0]
    if B % rows.size:
        raise ValueError(f"a global batch of {B} rows does not split over {rows.size} ranks")
    n = B // rows.size
    return {k: v[rows.index * n:(rows.index + 1) * n] for k, v in batch.items()}


def _row_group(mesh, batch: dict):
    """The group of the batch axes the global batch's rows split over."""
    return group_for(mesh, sharding.batch_axes(next(iter(batch.values())).shape[0]))


def _check_preset(rules) -> None:
    if rules not in sharding.presets():
        raise ValueError(f"preset {rules!r} is not a preset (the presets: "
                         f"{', '.join(sharding.presets())})")


def make_mesh_prefill_step(cfg: ModelConfig, mesh, rules: str):
    """The prefill on ``mesh`` under ``rules`` (``train``, ``prefill_moe``,
    or any train preset): (this rank's shards of the f32 master tree, the
    global batch) -> this rank's block of the f32 logits, every rank
    calling it together: its rows, and under sequence parallelism its piece
    of the sequence with the whole vocabulary (the reference's
    ``("batch", "seq", "vocab")`` block). The working model is gathered
    from the shards at every call and kept between calls in
    ``step.held["bound"]``."""
    _check_preset(rules)
    with sharding.use(mesh, rules):
        layout = mesh_layout(cfg, mesh)
    held: dict = {}

    @torch.no_grad()
    def step(params: dict, batch):
        with sharding.use(mesh, rules):
            if held.get("params") is not params:
                held["params"] = params
                held["bound"] = bind_mesh(cfg, params, params, params, mesh, layout)
            b = held["bound"]
            refresh_mesh(b)
            logits, _ = forward_train(b.model, cfg, local_rows(batch, _row_group(mesh, batch)))
        return logits

    step.held = held
    step.layout = layout
    return step


def make_mesh_train_step(cfg: ModelConfig, mesh, rules: str,
                         opt_cfg: adamw.AdamWConfig = adamw.AdamWConfig(),
                         peak_lr: float = 3e-4):
    """The train step on ``mesh`` under ``rules`` (any of
    ``sharding.presets()``): (state of this rank's shards, the global
    batch) -> (state, metrics), updated in place, every rank calling it
    together.

    Each step gathers the working model from the master shards (each shard
    rounded to the weight's dtype, then all-gathered over the axes it is
    not sharded on at use, ``use_keep``; an MoE variant's expert leaves are
    int8-gathered inside the variant instead), runs the forward and
    backward on this rank's rows (split over the batch axes; under
    sequence parallelism its piece of the sequence between the blocks,
    ``models/transformer.py``), reduce-scatters each leaf's gradient over
    the axes its working copy was gathered over and all-reduces it over
    those it is replicated on, takes the global norm over every rank and
    runs AdamW on the local shards. The metrics (loss, ce, aux, lr,
    grad_norm) are the global ones, the same on every rank.
    ``step.held["grads"]`` keeps the last step's gradient shards. A name
    that is not a preset raises."""
    _check_preset(rules)
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
            refresh_mesh(b)
            share, (loss, ce, aux) = _mesh_loss(b.model, cfg,
                                                local_rows(batch, _row_group(mesh, batch)),
                                                b.world)
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


# ---------------------------------------------------------------------------
# serving on a mesh: decode (the cache's length over 'model'), decode_b1 (over
# 'data')
# ---------------------------------------------------------------------------

def mesh_serve_params(cfg: ModelConfig, mesh, rules: str, source, device=None) -> Transformer:
    """This rank's serving weights on ``mesh`` under ``rules``: a
    ``Transformer`` in ``cfg``'s dtype (its f32 leaves f32) whose weights
    are whole but for the dims the rules keep sharded over 'model' at use
    (``use_keep``: the query heads, kv heads that split with them, ``mlp``,
    ``rnn``, RWKV's heads, the embedding's and the lm head's vocabulary),
    each held once. ``source`` is a whole ``Transformer`` in any dtype
    (sliced here, no collective), or this rank's shards of the f32 master
    tree under the same rules (``TrainState.params`` on the mesh; each
    leaf gathered over the axes it is not kept on, collectively); either is
    rounded to the weight's dtype (nearest even). ``device``: the rank's
    card unless named."""
    from repro_torch.launch.mesh import rank_device
    from repro_torch.models.layers import Attention, rope_frequencies
    device = rank_device(device)
    with sharding.use(mesh, rules):
        layout = mesh_layout(cfg, mesh)
        flat = {path: (pl, use_keep(cfg, path, pl, mesh)) for path, pl in layout_leaves(layout)}
    model = Transformer(cfg, "meta")
    whole = isinstance(source, Transformer)
    full = {(path, index): p for path, index, p in param_paths(source)} if whole else None
    work: dict = {}
    names = [name for name, _ in model.named_parameters()]
    with torch.no_grad():
        for name, (path, index, p) in zip(names, param_paths(model)):
            pl, keep = flat[path]
            if whole:
                t = full[(path, index)].detach()
                lead = 0 if index is None else 1
                for d in keep:
                    t = t.narrow(d - lead, *pl.slices[d])
                t = torch.empty(t.shape, dtype=p.dtype, device=device).copy_(t)
            else:
                if path not in work:
                    shard = _at(source, path)
                    g = gather_leaf(shard.to(p.dtype), pl, mesh, keep)
                    work[path] = g.clone() if g.data_ptr() == shard.data_ptr() else g
                t = work[path] if index is None else work[path][index]
            owner, _, leaf = name.rpartition(".")
            setattr(model.get_submodule(owner), leaf, torch.nn.Parameter(t, requires_grad=False))
    for m in model.modules():
        if isinstance(m, Attention):
            m.freqs = torch.from_numpy(rope_frequencies(m.cfg.head_dim, m.cfg.rope_theta)).to(
                device)
    return model


def decode_layout(cfg: ModelConfig, state, mesh=None, rules=None) -> dict:
    """This rank's ``Placement`` of every leaf of a decode state on ``mesh``
    under ``rules`` (default: the active pair) from ``decode_state_specs``,
    with the reference's divisibility fall-backs (a batch that does not
    split over the batch axes is whole on every rank). ``state`` is the
    whole state, or anything with its leaves' shapes (its twin on the meta
    device: ``decode_state_init(cfg, B, C, device="meta")``). A ring must
    split into equal pieces over the axes the rules give the cache, as
    ``attention_decode`` reads the ring's length off its piece: one that does
    not raises."""
    mesh = mesh or sharding.active_mesh()
    with sharding.use(mesh, rules or sharding.active_rules_name()):
        layout = sharding.tree_shardings(decode_state_specs(cfg), mesh, shape_tree=state)
        want = sharding.spec_for(("cache",))[0]
    for path, pl in layout_leaves(layout):
        if path[-1] in ("k", "v") and pl.spec[-2] != want:
            raise ValueError(f"{'/'.join(path)}: a ring of {pl.shape[-2]} slots does not split "
                             f"over {want}")
    return layout


def decode_state_piece(cfg: ModelConfig, state, mesh, rules=None, device=None) -> dict:
    """This rank's piece of a decode state on ``mesh`` under ``rules``
    (default: the active preset): a copy of its slice of each leaf of the
    whole ``state`` (tensors, cast to the port's dtype of the leaf), or
    zeros where ``state``'s leaves are on the meta device
    (``decode_state_init(..., device="meta")``: no whole state is ever
    made). ``device``: the rank's card unless named."""
    from repro_torch.launch.mesh import rank_device
    device = rank_device(device)
    layout = decode_layout(cfg, state, mesh, rules)
    dtypes = decode_state_init(cfg, 1, 1, device="meta")

    def piece(pl, like, full):
        out = torch.zeros(pl.local_shape, dtype=like.dtype, device=device)
        return out if full.device.type == "meta" else out.copy_(pl.take(full))
    return sharding.tree_map(piece, layout, dtypes, state)


def make_mesh_serve_step(cfg: ModelConfig, mesh, rules: str):
    """The serve step on ``mesh`` under ``rules`` (``decode`` or
    ``decode_b1``, ``sharding.SERVE_PRESETS``): (this rank's serving
    weights, ``mesh_serve_params``; its piece of the decode state,
    ``decode_state_piece``; the GLOBAL inputs, a token a lane or an audio
    model's (B, 1, d) frame embeddings) -> (this rank's block of the f32
    logits, the reference's ``("batch", "vocab")`` block: its lanes (the
    batch split over the batch axes, whole under ``decode_b1``) by its
    vocabulary slice over 'model'; the state, its pieces updated in place
    and ``pos`` one higher), every rank calling it together.

    No rank holds the whole KV cache and none is gathered: each attention
    layer writes the new token only on the rank whose piece holds its slot
    and combines the softmax over the pieces (``models/layers.py``
    ``attention_decode``); the bytes a step hands to collectives do not grow
    with the cache's length."""
    if rules not in sharding.SERVE_PRESETS:
        raise ValueError(f"preset {rules!r} does not serve on a mesh (only "
                         f"{', '.join(sharding.SERVE_PRESETS)}, the presets the reference's dry "
                         f"run lowers its serve step under)")

    @torch.no_grad()
    def step(params: Transformer, state, inputs):
        with sharding.use(mesh, rules):
            return serve_step(params, cfg, state, local_rows(inputs, _row_group(mesh, inputs)))

    return step
