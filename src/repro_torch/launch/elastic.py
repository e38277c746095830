"""Elastic resize: rebuild a smaller mesh and reshard state — the port of
``repro.launch.elastic`` on ``torch.distributed``.

The runbook, when a host fails mid-run:
  1. instant-restore the latest commit (manifest only, O(1)),
  2. rebuild the mesh from the surviving ranks (drop a 'data' slice — the
     mesh stays rectangular; the model axis is never shrunk),
  3. bind the step to the new mesh; parameter and optimizer shards resize
     because their placements come from the SAME logical rules on the new
     mesh,
  4. rescale the data plan: keep the global batch by raising the batch a
     host takes (gradient accumulation) or accept a smaller one with an LR
     rescale.

Every function that builds groups is collective over the whole world; a
rank outside the new mesh gets the mesh back and leaves
(``sharding.coordinate(new) is None``).
"""
from __future__ import annotations

import torch

from repro_torch.launch.mesh import build_mesh, rank_device
from repro_torch.parallel import sharding
from repro_torch.train.steps import make_train_step, shard_tree


def shrink_mesh(mesh, axis: str = "data", drop: int = 1, device=None):
    """The rectangular mesh with ``drop`` slices removed from the end of
    ``axis``, with its groups (collective over the world)."""
    names = tuple(mesh.mesh_dim_names)
    idx = names.index(axis)
    ranks = torch.as_tensor(mesh.mesh)
    keep = ranks.shape[idx] - drop
    if keep < 1:
        raise ValueError("cannot shrink an axis to zero")
    return build_mesh(ranks.narrow(idx, 0, keep).clone(), names, device)


def relower_for_mesh(cfg, new_mesh, rules: str = "train", peak_lr: float = 3e-4):
    """The train step bound to a resized mesh (placements re-derived from
    the same logical rules; ``make_mesh_train_step``'s); installs
    (new_mesh, rules) as the active pair. The default preset is the
    reference's, ``train`` (FSDP + TP + SP)."""
    sharding.set_active(new_mesh, rules)
    return make_train_step(cfg, peak_lr=peak_lr)


def reshard_tree(tree, new_mesh, spec_tree, rules: str = "train", device=None):
    """This rank's shards on the resized mesh of a tree of full leaves
    (tensors, numpy arrays, or the lazy tensors of a restored commit),
    copied to ``device`` (the rank's card unless named)."""
    device = rank_device(device)
    with sharding.use(new_mesh, rules):
        layout = sharding.tree_shardings(spec_tree, new_mesh, shape_tree=_shapes(tree))
    return shard_tree(tree, layout, device)


class _Shape:
    def __init__(self, shape):
        self.shape = tuple(shape)


def _shapes(tree):
    if isinstance(tree, dict):
        return {k: _shapes(v) for k, v in tree.items()}
    if hasattr(tree, "get") and not hasattr(tree, "shape"):
        return _Shape(tree.get().shape)
    return _Shape(tree.shape)


def rescale_batch_plan(global_batch: int, old_hosts: int, new_hosts: int):
    """Keep the global batch via per-host microbatching where divisible;
    otherwise return the nearest feasible batch + LR scale factor."""
    per_old = global_batch // old_hosts
    if global_batch % new_hosts == 0:
        return {"global_batch": global_batch,
                "per_host": global_batch // new_hosts,
                "accum_steps": max(1, (global_batch // new_hosts) // per_old),
                "lr_scale": 1.0}
    feasible = (global_batch // new_hosts) * new_hosts
    return {"global_batch": feasible, "per_host": feasible // new_hosts,
            "accum_steps": 1, "lr_scale": feasible / global_batch}
