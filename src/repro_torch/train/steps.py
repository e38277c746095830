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
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.models.transformer import (ModelConfig, Transformer, forward_train, loss_fn,
                                            serve_step)
from repro_torch.optim import adamw
from repro_torch.optim.schedule import cosine_warmup


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
    objects. ``metrics``: loss, ce, aux, lr, grad_norm (0-d tensors)."""
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
