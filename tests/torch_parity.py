"""Helpers for the differential tests of the PyTorch port (``repro_torch``)
against the JAX package (``repro``): carry states and keys across as numpy
arrays and compare planes byte for byte."""
import dataclasses

import numpy as np
import torch

from repro_torch import interop


def port_cfg(ref_cfg):
    return interop.config_from_reference(dataclasses.asdict(ref_cfg))


def ref_planes(ref_state) -> dict:
    return {k: np.asarray(v) for k, v in ref_state._asdict().items()}


def ref_copy(ref_state):
    """A fresh copy of a reference state (the reference's tables donate
    their state to their jitted ops)."""
    import jax.numpy as jnp
    return type(ref_state)(*(jnp.array(np.asarray(x)) for x in ref_state))


def to_port(ref_cfg, ref_state, device="cpu"):
    return interop.state_from_numpy(port_cfg(ref_cfg), ref_planes(ref_state), device)


def words(a) -> torch.Tensor:
    """uint32 numpy array -> int32 word tensor with the same bits."""
    return torch.from_numpy(np.array(a, dtype=np.uint32).reshape(np.shape(a))
                            .view(np.int32))


def diverged(ref_state, port_state) -> list:
    """Names of the planes whose bytes differ (dtype included)."""
    a, b = ref_planes(ref_state), interop.state_to_numpy(port_state)
    return [k for k in a if a[k].dtype != b[k].dtype or a[k].shape != b[k].shape
            or a[k].tobytes() != b[k].tobytes()]


def assert_same_state(ref_state, port_state, where=""):
    bad = diverged(ref_state, port_state)
    assert not bad, (where, bad)
