"""Carry a table across between the JAX package and this one.

A Dash table is all integers, so the carry-across is exact: planes go in as
numpy arrays with the reference's dtypes (``{k: np.asarray(v) for k, v in
ref_state._asdict().items()}``) and come back out the same way, byte for
byte. uint32 planes live here as int32 tensors holding the same bits. A
level-hashing ``LevelState`` crosses the same way. A language model's
weights cross as the reference's parameter tree of numpy arrays
(``model_params_from_jax``).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.baselines import (LevelConfig, LevelState,
                                        level_make_state)
from repro_torch.core.layout import (NP_DTYPES, PLANE_DTYPES, DashConfig,
                                     DashState, make_state)
from repro_torch.models.transformer import ModelConfig, Transformer

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


def _leaf(a) -> torch.Tensor:
    """One f32 leaf of the reference's parameter tree, as a CPU tensor."""
    return torch.from_numpy(np.array(a, np.float32))


def model_params_from_jax(cfg: ModelConfig, params_np: dict, device) -> Transformer:
    """The port's ``Transformer`` on ``device``, in ``cfg``'s compute dtype,
    from the reference's parameter tree as numpy arrays (``blocks_<pi>``
    leaves stacked on a leading layer axis). The f32 weights are cast once
    (round to nearest even, the reference's cast at every use); RMSNorm
    scales stay f32."""
    model = Transformer(cfg, device)
    model.embed.table.copy_(_leaf(params_np["embed"]["table"]))
    model.norm_f.scale.copy_(_leaf(params_np["norm_f"]["scale"]))
    model.lm_head.w.copy_(_leaf(params_np["lm_head"]["w"]))
    for key, index, blk in model.layers():
        tree = params_np[key]
        for norm in ("norm1", "norm2"):
            getattr(blk, norm).scale.copy_(_leaf(tree[norm]["scale"][index]))
        for name in ("wq", "wk", "wv", "wo"):
            getattr(blk.attn, name).copy_(_leaf(tree["attn"][name][index]))
        for name in ("w_gate", "w_up", "w_down"):
            getattr(blk.mlp, name).copy_(_leaf(tree["mlp"][name][index]))
    return model
