"""Logical-axis sharding rules (MaxText-style) for params and activations —
the port of ``repro.parallel.sharding`` on ``torch.distributed``.

Params and activations carry *logical* axis names; a rule set maps them to
mesh axes ('pod', 'data', 'model'). The ten presets are the reference's,
flag for flag (see its docstring for why each exists):

  * ``train``, ``train_tp``, ``train_tp_nosp``, ``train_ep``,
    ``train_multi_moe``, ``prefill_moe``: TP + SP layouts;
  * ``train_dp``: pure ZeRO-3, batch over every axis, the ``embed`` dim of
    every parameter over ('data', 'model'); MoE through
    ``moe_apply_shardmap`` (``_moe_shardmap``);
  * ``train_dp_ep``: ZeRO-3 over 'data', experts owned by 'model' ranks;
    MoE through ``moe_apply_ep_shardmap`` (``_moe_ep``);
  * ``decode``, ``decode_b1``: serving (dense MoE, ``_moe_dense``): the
    KV cache's length over 'model' (``decode``; kv heads replicated, the
    batch over 'data') or over 'data' (``decode_b1``: one sequence, the
    batch whole), the projections' heads, ``mlp``, ``rnn`` and the
    vocabulary over 'model'.

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` with
``mesh_dim_names``; anything with ``mesh_dim_names`` and ``shape`` (and
``mesh``, the rank of every coordinate, for the collectives) resolves the
same way. A spec is a plain tuple with one entry a dim: None, an axis name
or a tuple of axis names — the entries of the reference's
``PartitionSpec``.

The active (mesh, rules) pair is process-global, installed by the caller
(``use``). Every preset runs a train step and a prefill on a mesh, the
two serving ones (``SERVE_PRESETS``) a serve step too;
``logical_constraint`` says what the port does at each of the
reference's constraint points. ``tree_shardings`` maps
full leaves to this rank's local shards (``Placement``), the slice JAX's
``addressable_shards`` gives the device at the same mesh coordinate.
"""
from __future__ import annotations

import contextlib
import math
from typing import NamedTuple, Optional

import torch


def _mk(**over):
    base = {
        "batch": ("pod", "data"), "seq": None, "act_embed": None,
        "act_heads": "model", "act_kv": "model", "embed": None,
        "heads": "model", "kv": "model",
        "head_dim": None, "mlp": "model", "vocab": "model", "expert": None,
        "rnn": "model", "layers": None, "kv_heads": None, "cache": None,
    }
    base.update(over)
    return base


_PRESETS = {
    "train": _mk(seq="model", embed="data"),
    "train_tp": _mk(seq="model"),
    "train_tp_nosp": _mk(),
    "train_ep": _mk(seq="model", embed="data", expert="model", mlp=None),
    "train_dp": _mk(batch=("pod", "data", "model"), seq=None,
                    embed=("data", "model"), heads=None, kv=None, mlp=None,
                    vocab=None, rnn=None, act_heads=None, act_kv=None,
                    _moe_shardmap=True),
    "train_dp_ep": _mk(batch=("pod", "data", "model"), seq=None,
                       embed=("data",), expert="model", heads=None, kv=None,
                       mlp=None, vocab=None, rnn=None, act_heads=None,
                       act_kv=None, _moe_ep=True),
    "decode": _mk(cache="model", _moe_dense=True),
    "decode_b1": _mk(batch=None, cache="data", _moe_dense=True),
    "prefill_moe": _mk(seq="model", embed="data", _moe_dense=True),
    "train_multi_moe": _mk(seq="model", embed="data", _moe_dense=True),
}

#: the presets a serve step runs under on a mesh (the reference's dry run
#: lowers its serve step under these alone)
SERVE_PRESETS = ("decode", "decode_b1")

_ACTIVE = {"mesh": None, "rules": _PRESETS["train"], "name": "train"}


def presets():
    return dict(_PRESETS)


def set_active(mesh, rules="train"):
    _ACTIVE["mesh"] = mesh
    _ACTIVE["rules"] = _PRESETS[rules] if isinstance(rules, str) else rules
    _ACTIVE["name"] = rules if isinstance(rules, str) else None


@contextlib.contextmanager
def use(mesh, rules="train"):
    prev = dict(_ACTIVE)
    set_active(mesh, rules)
    try:
        yield
    finally:
        _ACTIVE.update(prev)


def active_mesh():
    return _ACTIVE["mesh"]


def active_rules_name() -> Optional[str]:
    """The active preset's name (None for a rules dict passed directly)."""
    return _ACTIVE["name"]


def flag(name: str) -> bool:
    """Non-axis boolean flags carried in the rules dict (keys start with _)."""
    return bool(_ACTIVE["rules"].get(name, False))


def axes_for(name: str, dim: int | None = None) -> tuple:
    """The mesh axes logical ``name`` resolves to (dims-aware, with the same
    prefix-fallback as tensor sharding)."""
    mesh = _ACTIVE["mesh"]
    if mesh is None:
        return ()
    spec = _resolve((name,), dims=(dim,) if dim is not None else None)
    m = spec[0] if len(spec) else None
    if m is None:
        return ()
    return m if isinstance(m, tuple) else (m,)


def batch_axes(dim: int | None = None) -> tuple:
    """Mesh axes the 'batch' logical axis maps to (dims-aware)."""
    return axes_for("batch", dim)


def mesh_shape(mesh) -> dict:
    """{axis name: size} of ``mesh``."""
    return dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))


def _divisible(dim: Optional[int], n: int) -> bool:
    return dim is None or dim % n == 0


def _resolve(names, rules=None, mesh=None, dims=None) -> tuple:
    """Map logical names -> a spec, dropping axes that are absent from the
    mesh, already used, or that don't divide the tensor dim."""
    rules = rules or _ACTIVE["rules"]
    mesh = mesh or _ACTIVE["mesh"]
    axes = []
    used = set()
    shape = mesh_shape(mesh) if mesh is not None else None
    for i, n in enumerate(names):
        dim = None if dims is None else dims[i]
        if n is None:
            axes.append(None)
            continue
        m = rules.get(n)
        if isinstance(m, tuple):
            m = tuple(a for a in m if (shape is None or a in shape) and a not in used)
            if m and shape is not None:
                # the longest PREFIX whose axis product divides the dim (batch
                # 256 on (pod, data, model) = 512 falls back to (pod, data))
                while m and not _divisible(dim, math.prod(shape[a] for a in m)):
                    m = m[:-1]
            m = m if m else None
        elif m is not None and shape is not None:
            if m not in shape or m in used or not _divisible(dim, shape[m]):
                m = None
        elif m is not None and m in used:
            m = None
        if m is not None:
            used.update(m if isinstance(m, tuple) else [m])
        # a one-axis tuple is the axis itself, as a PartitionSpec holds it
        axes.append(m[0] if isinstance(m, tuple) and len(m) == 1 else m)
    return tuple(axes)


def spec_for(names, rules=None, mesh=None, dims=None) -> tuple:
    """The spec of a tuple of logical axis names."""
    return _resolve(tuple(names), rules, mesh, dims)


def tree_map(fn, tree, *rest):
    """``tree`` (nested dicts) with each leaf replaced by ``fn(leaf, *the
    matching leaves of rest)``; anything but a dict is a leaf (a spec's
    tuple of names, a ``Placement``, a tensor)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    return fn(tree, *rest)


def tree_specs(spec_tree, rules=None, mesh=None, shape_tree=None):
    """Map a tree of logical-name tuples to specs. With ``shape_tree`` (a
    matching tree of tensors or anything with ``shape``), axes that don't
    divide the corresponding dim are dropped (e.g. kv=4 heads on a 16
    axis)."""
    if shape_tree is None:
        return tree_map(lambda names: _resolve(tuple(names), rules, mesh), spec_tree)
    return tree_map(lambda names, arr: _resolve(tuple(names), rules, mesh,
                                                dims=tuple(arr.shape)),
                    spec_tree, shape_tree)


def seq_parallel() -> bool:
    """Whether the active rules shard the activations' sequence over a
    'model' axis of more than one rank (Megatron sequence parallelism:
    ``train``, ``train_tp``, ``train_ep``, ``prefill_moe``,
    ``train_multi_moe``)."""
    mesh = _ACTIVE["mesh"]
    return (mesh is not None and mesh_shape(mesh).get("model", 1) > 1
            and axes_for("seq") == ("model",))


def logical_constraint(x, names):
    """The reference's ``with_sharding_constraint`` by logical names; it
    returns ``x`` unchanged. The port moves activations explicitly where
    the reference constrains them (``parallel.collectives``: ``tp_in``,
    ``tp_out``, ``seq_shard``):

    * the residual stream ``("batch", "seq", "act_embed")`` between blocks:
      this rank's rows (split over the batch axes) and, under sequence
      parallelism, its piece of the sequence (``seq_shard`` after the
      embedding);
    * a block's entry (attention's q/k/v on ``act_heads`` / ``act_kv``, the
      MoE's ``("batch", None, "act_embed")``, likewise the MLP, RG-LRU and
      RWKV inputs): the whole sequence, all-gathered over 'model'
      (``tp_in``); the projections then run on this rank's heads, ``mlp``,
      ``rnn`` or expert slice;
    * a block's output back to ``("batch", "seq", "act_embed")``: a
      row-parallel partial sum reduce-scattered over 'model' along the
      sequence, or all-reduced without sequence parallelism
      (``train_tp_nosp``); a complete output cut to this rank's piece;
    * the logits ``("batch", "seq", "vocab")``: the sequence piece with the
      whole vocabulary under sequence parallelism ('model' is used by
      ``seq``), the vocabulary's slice over the whole sequence without;
    * the decode cache ``("batch", "kv_heads", "cache", "head_dim")``
      under the serving presets: each rank keeps its piece of the ring
      (``models/layers.py`` ``attention_decode``: the new token's K/V
      written only where its slot lies, the softmax combined over the
      cache's axes), never gathered.

    Under the ZeRO-3 presets every activation is local to its rank and
    nothing moves."""
    return x


def shard_specs(axes, tree):
    """Specs for a stacked per-shard tree: every leaf carries the shard
    dimension first and shards over ``axes`` (the distributed DHT's state
    layout)."""
    axes = tuple(axes)
    return tree_map(lambda _: (axes,), tree)


# ---------------------------------------------------------------------------
# a rank's shard of a leaf
# ---------------------------------------------------------------------------

def coordinate(mesh) -> Optional[dict]:
    """{axis: index} of this process's rank on ``mesh``, or None when the
    rank is not on it."""
    import torch.distributed as dist
    hit = (torch.as_tensor(mesh.mesh) == dist.get_rank()).nonzero()
    if hit.numel() == 0:
        return None
    return dict(zip(mesh.mesh_dim_names, hit[0].tolist()))


class Placement(NamedTuple):
    """Where a leaf lives on a mesh: its ``spec``, its full ``shape``, and
    this rank's slice of each dim (start, length)."""
    spec: tuple
    shape: tuple
    slices: tuple

    @property
    def local_shape(self) -> tuple:
        return tuple(n for _, n in self.slices)

    def take(self, full: torch.Tensor) -> torch.Tensor:
        """This rank's shard of the full leaf (a view)."""
        for d, (start, n) in enumerate(self.slices):
            if n != full.shape[d]:
                full = full.narrow(d, start, n)
        return full


def spec_axes(entry) -> tuple:
    """The mesh axes of one spec entry, as a tuple."""
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def placement(spec: tuple, shape, mesh, coord: dict) -> Placement:
    """The placement of a leaf of ``shape`` under ``spec`` at mesh
    coordinate ``coord``: a dim over axes (a1, ..., ak) splits into
    prod(sizes) chunks, and the rank takes chunk a1 * (size2 * ...) + a2 *
    ... (the first axis major), as a NamedSharding does."""
    sizes = mesh_shape(mesh)
    spec = tuple(spec) + (None,) * (len(shape) - len(spec))
    slices = []
    for entry, n in zip(spec, shape):
        idx, parts = 0, 1
        for a in spec_axes(entry):
            idx = idx * sizes[a] + coord[a]
            parts *= sizes[a]
        if n % parts:
            raise ValueError(f"dim {n} does not split into {parts} over {entry}")
        slices.append((idx * (n // parts), n // parts))
    return Placement(spec, tuple(shape), tuple(slices))


def tree_shardings(spec_tree, mesh=None, rules=None, shape_tree=None):
    """This rank's ``Placement`` of every leaf of ``shape_tree`` on ``mesh``
    (default: the active one), from the specs ``tree_specs`` resolves:
    ``placement.take(full)`` is the rank's shard."""
    mesh = mesh or _ACTIVE["mesh"]
    coord = coordinate(mesh)
    if coord is None:
        raise ValueError(f"this rank is not on the mesh {torch.as_tensor(mesh.mesh).tolist()}")
    specs = tree_specs(spec_tree, rules, mesh, shape_tree)
    return tree_map(lambda spec, arr: placement(spec, tuple(arr.shape), mesh, coord),
                    specs, shape_tree)
