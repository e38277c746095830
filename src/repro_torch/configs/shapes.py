"""The assigned input-shape grid (4 shapes x 10 archs = 40 cells) and
``input_specs`` — the port of ``repro.configs.shapes``: tensors on the meta
device stand in for every model input (shapes and dtypes, no storage).

  train_4k     seq=4096    global_batch=256   a train step
  prefill_32k  seq=32768   global_batch=32    a prefill step (forward only)
  decode_32k   seq=32768   global_batch=128   a serve step (1 token, KV=seq)
  long_500k    seq=524288  global_batch=1     a serve step; only for
                                              sub-quadratic archs (SWA/hybrid/ssm)
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.layout import resolve_device
from repro_torch.models.transformer import ModelConfig, decode_state_init


@dataclasses.dataclass(frozen=True)
class ShapeCase:
    name: str
    seq_len: int
    global_batch: int
    kind: str                   # train | prefill | decode


SHAPES = {
    "train_4k": ShapeCase("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeCase("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeCase("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeCase("long_500k", 524288, 1, "decode"),
}


def shape_applicable(cfg: ModelConfig, shape: str) -> bool:
    """long_500k needs sub-quadratic attention."""
    if shape == "long_500k":
        return cfg.sub_quadratic
    return True


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg: ModelConfig, shape: str) -> dict:
    """Abstract inputs for (arch, shape), in the reference's tree and
    dtypes. For train/prefill this is the token batch (+ the stub
    modality embeddings); for decode it is one token a lane plus the decode
    state (a KV cache of seq_len / the recurrent state,
    ``decode_state_init(..., device="meta")``)."""
    case = SHAPES[shape]
    B, S = case.global_batch, case.seq_len
    d = cfg.d_model

    if case.kind in ("train", "prefill"):
        if cfg.family == "audio":
            batch = {"frame_embeds": _meta((B, S, d), torch.bfloat16),
                     "labels": _meta((B, S), torch.int32)}
        elif cfg.family == "vlm":
            P = cfg.num_patches
            batch = {"tokens": _meta((B, S - P), torch.int32),
                     "patch_embeds": _meta((B, P, d), torch.bfloat16),
                     "labels": _meta((B, S - P), torch.int32)}
        else:
            batch = {"tokens": _meta((B, S), torch.int32),
                     "labels": _meta((B, S), torch.int32)}
        return {"batch": batch}

    state = decode_state_init(cfg, B, S, device="meta")
    if cfg.family == "audio":
        inputs = {"frame_embeds": _meta((B, 1, d), torch.bfloat16)}
    else:
        inputs = {"token": _meta((B,), torch.int32)}
    return {"state": state, "inputs": inputs}


def _map_sorted(fn, tree):
    """``tree`` with each leaf replaced by ``fn(leaf)``, the leaves visited
    with every dict's keys in sorted order (``jax.tree.map``'s order)."""
    if isinstance(tree, dict):
        return {k: _map_sorted(fn, tree[k]) for k in sorted(tree)}
    return fn(tree)


def concrete_inputs(cfg: ModelConfig, shape: str, rng=None, device=None) -> dict:
    """A concrete version of ``input_specs`` (smoke tests, examples), drawn
    from the numpy generator ``rng`` (default ``default_rng(0)``) leaf by
    leaf in the reference's order, so that the same seed draws the same
    values in both packages: integers uniform in [0, max(vocab - 1, 2)),
    floats standard normal in f32 cast to the leaf's dtype (nearest even).
    ``device``: the card unless named."""
    device = resolve_device(device)
    rng = rng or np.random.default_rng(0)

    def realize(spec):
        if not spec.dtype.is_floating_point:
            a = rng.integers(0, max(cfg.vocab_size - 1, 2), tuple(spec.shape), dtype=np.int32)
            return torch.from_numpy(a).to(device)
        a = rng.normal(0, 1, tuple(spec.shape)).astype(np.float32)
        return torch.from_numpy(a).to(device=device, dtype=spec.dtype)

    return _map_sorted(realize, input_specs(cfg, shape))
