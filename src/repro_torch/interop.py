"""Carry a table across between the JAX package and this one.

A Dash table is all integers, so the carry-across is exact: planes go in as
numpy arrays with the reference's dtypes (``{k: np.asarray(v) for k, v in
ref_state._asdict().items()}``) and come back out the same way, byte for
byte. uint32 planes live here as int32 tensors holding the same bits.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.layout import (NP_DTYPES, PLANE_DTYPES, DashConfig,
                                     DashState, make_state)


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
