"""Mesh construction — the port of ``repro.launch.mesh`` on
``torch.distributed``: a ``DeviceMesh`` with ``mesh_dim_names`` over the
current world (the process group must be initialised), plus every axis
group the port's collectives use (``parallel.collectives.axis_groups``).

Functions, not module constants: importing this module touches no device
and no process group.
"""
from __future__ import annotations

import os

import torch
import torch.distributed as dist

from repro_torch.parallel.collectives import axis_groups


def rank_device(device=None) -> torch.device:
    """``device`` if given, else the card of this rank's local index
    (``LOCAL_RANK`` when a launcher sets it, else the rank). Raises without
    a card: pass ``device="cpu"`` for a CPU run."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device; pass device='cpu' to run on the CPU")
    local = int(os.environ.get("LOCAL_RANK", dist.get_rank()))
    if local >= torch.cuda.device_count():
        raise RuntimeError(f"local rank {local} has no card of its own "
                           f"({torch.cuda.device_count()} present); pass device=")
    return torch.device("cuda", local)


def build_mesh(ranks: torch.Tensor, names: tuple, device=None):
    """A ``DeviceMesh`` over ``ranks`` (an integer tensor of world ranks,
    one dim an axis) named ``names``, with its axis groups; collective over
    the whole world. A rank outside ``ranks`` gets the mesh too
    (``sharding.coordinate`` is None there)."""
    from torch.distributed.device_mesh import DeviceMesh
    device = rank_device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)        # before the mesh: it must not pick one
    mesh = DeviceMesh(device.type, ranks, mesh_dim_names=tuple(names))
    axis_groups(mesh)
    return mesh


def make_production_mesh(*, multi_pod: bool = False, device=None):
    """Single pod: (data=16, model=16) = 256 ranks. Multi-pod: (pod=2,
    data=16, model=16) = 512; the 'pod' axis is the outer data-parallel
    axis. The world must have exactly that many ranks."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    n = 512 if multi_pod else 256
    world = dist.get_world_size()
    if world != n:
        raise ValueError(f"the production mesh {dict(zip(axes, shape))} needs {n} ranks; "
                         f"the world has {world}")
    return build_mesh(torch.arange(n).reshape(shape), axes, device)


def make_test_mesh(data: int = 2, model: int = 4, device=None):
    """A (data, model) mesh over a world of ``data * model`` ranks."""
    world = dist.get_world_size()
    if data * model != world:
        raise ValueError(f"a ({data}, {model}) mesh needs {data * model} ranks; the world "
                         f"has {world}")
    return build_mesh(torch.arange(world).reshape(data, model), ("data", "model"), device)
