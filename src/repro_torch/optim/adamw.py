"""AdamW with decoupled weight decay + global-norm clipping — the port of
``repro.optim.adamw``, in the reference's formula (not ``torch.optim.AdamW``,
which has no global-norm clip, applies the decay as ``p * (1 - lr * wd)``
before the moment step, and keeps its moments in the parameter's dtype).

Optimizer state mirrors the parameters' structure: ``m`` and ``v`` in f32,
and an int32 ``count``. ``update`` walks the leaves one at a time and
updates ``params``, ``m``, ``v`` and ``count`` in place, so the f32
temporaries of one step are one leaf's, not the model's.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0


class AdamWState(NamedTuple):
    m: object
    v: object
    count: torch.Tensor


def leaves(tree) -> list:
    """The tensors of a tree of dicts (keys sorted, as the reference
    flattens them), lists and tuples, in order; None holds no leaf."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [t for sub in tree for t in leaves(sub)]
    return [tree]


def map_tree(fn, tree):
    """``tree`` (dicts, lists, tuples, NamedTuples) with every leaf replaced
    by ``fn(leaf)``."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: map_tree(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(map_tree(fn, v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_tree(fn, v) for v in tree)
    return fn(tree)


def init(params) -> AdamWState:
    """Zero f32 moments shaped like ``params``, on their devices, and a zero
    int32 count."""
    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    device = leaves(params)[0].device
    return AdamWState(m=map_tree(zeros, params), v=map_tree(zeros, params),
                      count=torch.zeros((), dtype=torch.int32, device=device))


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum over every leaf of its squares, in f32."""
    return torch.sqrt(sum(torch.sum(torch.square(g.float())) for g in leaves(tree)))


@torch.no_grad()
def update(cfg: AdamWConfig, grads, state: AdamWState, params, lr, gnorm=None):
    """One AdamW step, in place: ``params`` (f32), ``state.m``, ``state.v``
    and ``state.count`` are updated leaf by leaf. ``grads`` matches
    ``params`` leaf for leaf (any float dtype; used in f32); ``lr`` is an f32
    0-d tensor or a float. ``gnorm``, when given, is the global norm to clip
    by (a sharded state's, counted over every rank); else ``grads``' own.
    Returns (params, state, {"grad_norm"}), the same objects, like the
    reference's (new_params, new_state, metrics)."""
    if gnorm is None:
        gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9), max=1.0)
    state.count.add_(1)
    count = state.count.float()
    c1 = 1.0 - cfg.b1 ** count
    c2 = 1.0 - cfg.b2 ** count
    lr = torch.as_tensor(lr, dtype=torch.float32, device=gnorm.device)
    decay = lr * cfg.weight_decay
    ps, ms, vs, gs = leaves(params), leaves(state.m), leaves(state.v), leaves(grads)
    if not len(ps) == len(ms) == len(vs) == len(gs):
        raise ValueError(f"{len(gs)} gradients, {len(ps)} params, {len(ms)}/{len(vs)} moments")
    for g, m, v, p in zip(gs, ms, vs, ps):
        g = g.float() * scale
        m.mul_(cfg.b1).add_((1 - cfg.b1) * g)
        v.mul_(cfg.b2).add_((1 - cfg.b2) * g * g)
        step = lr * (m / c1) / (torch.sqrt(v / c2) + cfg.eps)
        wd = decay * p
        p.sub_(step).sub_(wd)
    return params, state, {"grad_norm": gnorm}
