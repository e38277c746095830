"""Carry a table across between the JAX package and this one.

A Dash table is all integers, so the carry-across is exact: planes go in as
numpy arrays with the reference's dtypes (``{k: np.asarray(v) for k, v in
ref_state._asdict().items()}``) and come back out the same way, byte for
byte. uint32 planes live here as int32 tensors holding the same bits. A
level-hashing ``LevelState`` crosses the same way. A language model's
weights cross as the reference's parameter tree of numpy arrays
(``model_params_from_jax``), and a whole training state (f32 masters, AdamW
moments and count, step) by the checkpoint's key names
(``train_state_from_jax``, ``train_state_to_numpy``), or straight into this
rank's shards on a mesh (``train_state_to_mesh``). A decode state crosses
as the reference's tree of numpy arrays, whole or as this rank's piece on
a mesh (``decode_state_from_numpy``, ``decode_state_to_numpy``).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.baselines import (LevelConfig, LevelState,
                                        level_make_state)
from repro_torch.core.layout import (NP_DTYPES, PLANE_DTYPES, DashConfig,
                                     DashState, make_state)
from repro_torch.checkpoint.manager import flatten
from repro_torch.models.transformer import ModelConfig, Transformer, decode_state_init
from repro_torch.optim.adamw import AdamWState, map_tree
from repro_torch.train.steps import TrainState, master_meta, mesh_layout, take_shard

#: LevelState planes that hold uint32 words (the rest are int32 scalars)
LEVEL_U32 = ("key_hi", "key_lo", "val", "alloc")


def state_from_numpy(cfg: DashConfig, planes: dict, device) -> DashState:
    """A ``DashState`` on ``device`` from the reference's plane dict. Each
    plane must have the shape ``cfg`` implies."""
    want = make_state(cfg, "eh", device="meta")
    fields = {}
    for name in DashState._fields:
        kind = PLANE_DTYPES[name]
        a = np.array(planes[name], dtype=NP_DTYPES[kind], order="C")
        if a.shape != tuple(getattr(want, name).shape):
            raise ValueError(f"{name}: shape {a.shape} does not fit the config "
                             f"({tuple(getattr(want, name).shape)})")
        if kind == "u32":
            a = a.view(np.int32)
        fields[name] = torch.from_numpy(a).to(device)
    return DashState(**fields)


def state_to_numpy(state: DashState) -> dict:
    """The plane dict with the reference's dtypes (uint8/uint32/int32/bool)."""
    out = {}
    for name in DashState._fields:
        a = getattr(state, name).detach().cpu().numpy()
        out[name] = a.view(np.uint32) if PLANE_DTYPES[name] == "u32" else a
    return out


def config_from_reference(fields: dict) -> DashConfig:
    """``DashConfig`` from ``dataclasses.asdict(ref_cfg)``."""
    return DashConfig(**fields)


def level_state_from_numpy(cfg: LevelConfig, planes: dict, device) -> LevelState:
    """A ``LevelState`` on ``device`` from the reference's plane dict
    (``{k: np.asarray(v) for k, v in ref_state._asdict().items()}``)."""
    want = level_make_state(cfg, "meta")
    fields = {}
    for name in LevelState._fields:
        a = np.array(planes[name], dtype=np.uint32 if name in LEVEL_U32 else np.int32,
                     order="C")
        if a.shape != tuple(getattr(want, name).shape):
            raise ValueError(f"{name}: shape {a.shape} does not fit the config "
                             f"({tuple(getattr(want, name).shape)})")
        fields[name] = torch.from_numpy(a.view(np.int32)).to(device)
    return LevelState(**fields)


def level_state_to_numpy(state: LevelState) -> dict:
    """The plane dict with the reference's dtypes (uint32 planes, int32
    scalars)."""
    out = {}
    for name in LevelState._fields:
        a = getattr(state, name).detach().cpu().numpy()
        out[name] = a.view(np.uint32) if name in LEVEL_U32 else a
    return out


def _load(module: torch.nn.Module, tree: dict, index, loaded: set, prefix: str = ""):
    """Copy the reference's leaves under ``tree`` into the parameters of the
    same names under ``module`` (slice ``index`` of each leaf when the tree
    is stacked). ``copy_`` casts f32 to the parameter's dtype, rounding to
    nearest even like the reference's cast at every use; f32 parameters
    keep the leaf's bits."""
    for name, sub in tree.items():
        if isinstance(sub, dict):
            _load(getattr(module, name), sub, index, loaded, f"{prefix}{name}.")
            continue
        a = np.array(sub if index is None else sub[index], np.float32)
        param = getattr(module, name)
        if tuple(param.shape) != a.shape:
            raise ValueError(f"{prefix}{name}: shape {a.shape} for {tuple(param.shape)}")
        with torch.no_grad():
            param.copy_(torch.from_numpy(a))
        loaded.add(id(param))


def model_params_from_jax(cfg: ModelConfig, params_np: dict, device) -> Transformer:
    """The port's ``Transformer`` on ``device``, in ``cfg``'s compute dtype,
    from the reference's parameter tree as numpy arrays: ``blocks_<pi>``
    leaves stacked on a leading layer axis, ``tail_<ti>`` trees without one,
    no ``embed`` for the audio front. The reference's f32 leaves that it
    uses in f32 (RMSNorm scales, RG-LRU's ``lam``, RWKV's decay, bonus and
    mix vectors) stay f32; the rest are cast once. Every parameter of the
    model must be loaded."""
    model = Transformer(cfg, device)
    loaded: set = set()
    for key, tree in params_np.items():
        if key.startswith("blocks_"):
            for b, blk in enumerate(model.blocks[int(key[7:])]):
                _load(blk, tree, b, loaded, f"{key}[{b}].")
        elif key.startswith("tail_"):
            _load(model.tails[int(key[5:])], tree, None, loaded, f"{key}.")
        else:
            _load(getattr(model, key), tree, None, loaded, f"{key}.")
    missing = [n for n, p in model.named_parameters() if id(p) not in loaded]
    if missing:
        raise ValueError(f"the reference's tree has no leaf for {missing[:8]}")
    return model


def train_state_from_jax(cfg: ModelConfig, tree_np, device) -> TrainState:
    """The port's ``TrainState`` on ``device`` from the reference's: its
    ``TrainState`` of numpy arrays (``jax.tree.map(np.asarray, state)``) or
    the flat dict a commit holds, keyed as the checkpoint keys it
    (``.params/blocks_0/attn/wq``, ``.opt/.m/...``, ``.opt/.v/...``,
    ``.opt/.count``, ``.step``). Every key of ``cfg``'s state must be there
    with its shape and dtype (f32 leaves, int32 count and step)."""
    flat = tree_np if isinstance(tree_np, dict) else flatten(tree_np)
    meta = master_meta(cfg)

    def f32(t):
        return torch.empty(t.shape, dtype=torch.float32, device=device)
    state = TrainState(params=map_tree(f32, meta),
                       opt=AdamWState(m=map_tree(f32, meta), v=map_tree(f32, meta),
                                      count=torch.empty((), dtype=torch.int32, device=device)),
                       step=torch.empty((), dtype=torch.int32, device=device))
    want = flatten(state)
    if set(flat) != set(want):
        raise ValueError(f"keys missing {sorted(set(want) - set(flat))[:8]}, extra "
                         f"{sorted(set(flat) - set(want))[:8]}")
    with torch.no_grad():
        for key, t in want.items():
            a = np.asarray(flat[key])
            if a.shape != tuple(t.shape) or a.dtype != (np.int32 if t.dtype == torch.int32
                                                        else np.float32):
                raise ValueError(f"{key}: {a.dtype}{list(a.shape)} for {t.dtype}"
                                 f"{list(t.shape)}")
            t.copy_(torch.from_numpy(np.array(a)))
    return state


def train_state_to_numpy(state: TrainState) -> dict:
    """The flat dict of numpy arrays a commit of ``state`` holds, keyed by
    the checkpoint's key names."""
    return {k: v.detach().cpu().numpy() for k, v in flatten(state).items()}


def train_state_to_mesh(cfg: ModelConfig, tree_np, mesh, rules=None, device=None) -> TrainState:
    """This rank's shards of the reference's ``TrainState`` on ``mesh``
    under ``rules`` (default: the active preset): the numpy state, its flat
    dict by the checkpoint's keys, or a restored commit's lazy tensors
    (``CheckpointManager.restore_manifest``), each leaf read only where
    this rank's slice lies. ``device``: the rank's card unless named."""
    from repro_torch.launch.mesh import rank_device
    from repro_torch.parallel import sharding
    from repro_torch.train.steps import layout_leaves
    device = rank_device(device)
    flat = tree_np if isinstance(tree_np, dict) else flatten(tree_np)
    if rules is None:
        layout = mesh_layout(cfg, mesh)
    else:
        with sharding.use(mesh, rules):
            layout = mesh_layout(cfg, mesh)
    want = {f"{head}/" + "/".join(path) for path, _ in layout_leaves(layout)
            for head in (".params", ".opt/.m", ".opt/.v")} | {".opt/.count", ".step"}
    if set(flat) != want:
        raise ValueError(f"keys missing {sorted(want - set(flat))[:8]}, extra "
                         f"{sorted(set(flat) - want)[:8]}")

    def tree(head):
        out: dict = {}
        for path, pl in layout_leaves(layout):
            a = flat[f"{head}/" + "/".join(path)]
            shape = a.get().shape if hasattr(a, "get") else a.shape
            if tuple(shape) != pl.shape:
                raise ValueError(f"{head}/{'/'.join(path)}: shape {tuple(shape)} for {pl.shape}")
            node = out
            for k in path[:-1]:
                node = node.setdefault(k, {})
            node[path[-1]] = take_shard(pl, a, device).float()
        return out

    def scalar(key):
        a = flat[key]
        a = np.asarray(a.get() if hasattr(a, "get") else a)
        if a.shape != () or a.dtype != np.int32:
            raise ValueError(f"{key}: {a.dtype}{list(a.shape)} for int32[]")
        return torch.tensor(int(a), dtype=torch.int32, device=device)
    return TrainState(params=tree(".params"),
                      opt=AdamWState(m=tree(".opt/.m"), v=tree(".opt/.v"),
                                     count=scalar(".opt/.count")),
                      step=scalar(".step"))


def decode_state_from_numpy(cfg: ModelConfig, tree_np: dict, device, mesh=None,
                            rules=None) -> dict:
    """The port's decode state on ``device`` from the reference's as numpy
    arrays (``jax.tree.map(np.asarray, state)``: ``blocks_<pi>`` and
    ``tail_<ti>`` dicts of leaves and ``pos``), each leaf cast to the port's
    dtype of it (a bf16 leaf may come as bf16 or as its exact f32
    widening); with ``mesh``, only this rank's piece under ``rules``
    (default: the active preset; ``train.steps.decode_state_piece``). The
    tree must be ``cfg``'s, every leaf with its rank."""
    from repro_torch.models.transformer import decode_state_specs
    from repro_torch.parallel import sharding
    from repro_torch.train.steps import decode_state_piece

    def leaf(names, like, a):
        # a copy: serve_step writes the state in place
        a = np.array(a, dtype=np.int32 if like.dtype == torch.int32 else np.float32, order="C")
        if a.ndim != len(names):
            raise ValueError(f"a leaf of {a.ndim} dims for the axes {names}")
        return torch.from_numpy(a)
    dtypes = decode_state_init(cfg, 1, 1, device="meta")
    if set(tree_np) != set(dtypes):
        raise ValueError(f"decode state keys {sorted(tree_np)} for {sorted(dtypes)}")
    full = sharding.tree_map(leaf, decode_state_specs(cfg), dtypes, tree_np)
    if mesh is not None:
        return decode_state_piece(cfg, full, mesh, rules, device)
    return sharding.tree_map(lambda like, t: t.to(device=device, dtype=like.dtype), dtypes, full)


def decode_state_to_numpy(state: dict) -> dict:
    """A decode state (whole, or a rank's piece) as numpy arrays in the
    reference's tree: bf16 and f16 leaves widened to f32 (exact), the rest
    in their dtype."""
    from repro_torch.parallel import sharding

    def leaf(t):
        t = t.detach().cpu()
        return (t.float() if t.dtype in (torch.bfloat16, torch.float16) else t).numpy().copy()
    return sharding.tree_map(leaf, state)
