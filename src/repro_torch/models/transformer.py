"""Decoder stack for serving: prefill that builds the decode state, and the
one-token serve step — the port of ``repro.models.transformer``.

The stack is declared by ``pattern``, a repeating tuple of block kinds;
``n_layers = len(pattern) * n_blocks + len(tail)``. This slice serves the
``"dense"`` kind (with or without ``sliding_window``), stacks without a
tail:

    dense:  [RMSNorm -> GQA attention -> +] [RMSNorm -> SwiGLU -> +]

The other kinds (``moe``, ``rglru``, ``rwkv``, ``local``), tail layers and
the ``vlm`` / ``audio`` fronts raise ``NotImplementedError`` (ROADMAP Queue
1, entry 15b).

The decode state keeps the reference's layout, so the page pool translates
line for line and states compare leaf by leaf: ``state["blocks_<pi>"]`` holds
``k``/``v`` of shape (n_blocks, B, G, C, hd) for pattern position ``pi``,
and ``state["pos"]`` the (B,) int32 position counter. ``serve_step`` writes the
new token's K/V into that state in place.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch import nn

from repro_torch.core.layout import resolve_device
from . import layers as L

#: block kinds this slice serves
SERVED_KINDS = ("dense",)
_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
           "float16": torch.float16}


def _not_ported(what: str):
    return NotImplementedError(f"{what} is not ported yet (ROADMAP Queue 1, entry 15b)")


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense|moe|hybrid|ssm|vlm|audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0              # 0 -> d_model // n_heads
    rope_theta: float = 1_000_000.0
    sliding_window: Optional[int] = None     # SWA for 'dense' blocks
    pattern: tuple = ("dense",)
    n_experts: int = 0
    top_k: int = 2
    capacity_factor: float = 1.25
    d_rnn: int = 0                 # rglru width (0 -> d_model)
    conv_width: int = 4
    local_window: int = 2048
    norm_eps: float = 1e-6
    dtype: str = "bfloat16"
    remat: str = "dots"            # full | dots | none
    q_chunk: int = 512
    kv_chunk: int = 1024
    num_patches: int = 576         # vlm stub patches (prepended)
    sub_quadratic: bool = False    # may run long_500k

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def n_blocks(self) -> int:
        return self.n_layers // len(self.pattern)

    @property
    def tail(self) -> tuple:
        return self.pattern[: self.n_layers % len(self.pattern)]

    @property
    def compute_dtype(self) -> torch.dtype:
        return _DTYPES[self.dtype]

    def attn_cfg(self, local: bool) -> L.AttnConfig:
        return L.AttnConfig(
            d_model=self.d_model, n_heads=self.n_heads,
            n_kv_heads=self.n_kv_heads, head_dim=self.hd,
            rope_theta=self.rope_theta,
            sliding_window=self.local_window if local else self.sliding_window,
            q_chunk=self.q_chunk, kv_chunk=self.kv_chunk)

    def param_count(self) -> int:
        """Analytic total parameters (for 6ND roofline accounting)."""
        d, ff, hd = self.d_model, self.d_ff, self.hd
        attn = d * self.n_heads * hd * 2 + d * self.n_kv_heads * hd * 2
        mlp = 3 * d * ff
        per = {"dense": attn + mlp, "local": attn + mlp,
               "moe": attn + d * self.n_experts + 3 * d * ff * self.n_experts,
               "rglru": 2 * d * (self.d_rnn or d) + (self.d_rnn or d) * d
                        + 2 * (self.d_rnn or d) ** 2 + mlp,
               "rwkv": 6 * d * d + 3 * d * ff}
        kinds = list(self.pattern) * self.n_blocks + list(self.tail)
        total = sum(per[k] for k in kinds)
        total += self.vocab_size * d                      # embed
        total += d * self.vocab_size                      # lm head
        return total

    def active_param_count(self) -> int:
        """Active params per token (MoE: top_k of n_experts)."""
        if "moe" not in self.pattern:
            return self.param_count()
        d, ff = self.d_model, self.d_ff
        inactive = (self.n_experts - self.top_k) * 3 * d * ff
        n_moe = sum(1 for k in list(self.pattern) * self.n_blocks + list(self.tail)
                    if k == "moe")
        return self.param_count() - n_moe * inactive


def ring_len(cfg: ModelConfig, cache_len: int) -> int:
    """Ring size C of a dense block's KV cache: the context, or the window."""
    if cfg.sliding_window is None:
        return cache_len
    return min(cache_len, cfg.sliding_window)


def check_served(cfg: ModelConfig) -> None:
    """Raise for what this slice does not serve."""
    if cfg.family in ("vlm", "audio"):
        raise _not_ported(f"the {cfg.family} front")
    for kind in cfg.pattern:
        if kind not in SERVED_KINDS:
            raise _not_ported(f"block kind {kind!r}")
    if cfg.tail:
        raise _not_ported("a stack with tail layers")


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

class DenseBlock(nn.Module):
    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        dt = cfg.compute_dtype
        self.norm1 = L.RMSNorm(cfg.d_model, cfg.norm_eps, device)
        self.norm2 = L.RMSNorm(cfg.d_model, cfg.norm_eps, device)
        self.attn = L.Attention(cfg.attn_cfg(False), dt, device)
        self.mlp = L.SwiGLU(cfg.d_model, cfg.d_ff, dt, device)

    def init(self, generator):
        self.attn.init(generator)
        self.mlp.init(generator)

    def prefill(self, x, positions):
        """(x, (k, v)): the block's output and its roped K/V (B, G, S, hd)."""
        a, kv = self.attn(self.norm1(x), positions, return_kv=True)
        x = x + a
        return x + self.mlp(self.norm2(x)), kv

    def decode(self, x, cache_k, cache_v, pos):
        a, _, _ = self.attn.decode(self.norm1(x), cache_k, cache_v, pos)
        x = x + a
        return x + self.mlp(self.norm2(x))


class Transformer(nn.Module):
    """The decoder's weights on one device, in the compute dtype (RMSNorm
    scales in f32). ``blocks[pi][b]`` is block ``b`` of pattern position
    ``pi`` (the reference's stacked ``blocks_<pi>`` leaves, index ``b``).
    Made uninitialised: ``init_params``
    draws the weights, ``interop.model_params_from_jax`` loads them."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        check_served(cfg)
        device = resolve_device(device)
        dt = cfg.compute_dtype
        self.cfg = cfg
        self.embed = L.Embed(cfg.vocab_size, cfg.d_model, dt, device)
        self.blocks = nn.ModuleList(
            nn.ModuleList(DenseBlock(cfg, device) for _ in range(cfg.n_blocks))
            for _ in cfg.pattern)
        self.norm_f = L.RMSNorm(cfg.d_model, cfg.norm_eps, device)
        self.lm_head = L.Unembed(cfg.d_model, cfg.vocab_size, dt, device)

    @property
    def device(self) -> torch.device:
        return self.lm_head.w.device

    def layers(self):
        """(state key, index, block) in the reference's layer order: every
        pattern position of block 0, then of block 1, ..."""
        for b in range(self.cfg.n_blocks):
            for pi in range(len(self.cfg.pattern)):
                yield f"blocks_{pi}", b, self.blocks[pi][b]


def init_params(cfg: ModelConfig, seed: int = 0, device=None) -> Transformer:
    """A ``Transformer`` on ``device`` (the card unless named) with the
    reference's initialisation: truncated normals (±2σ) at its scales, drawn
    from a generator on that device seeded with ``seed``; norms at 1. The
    draws are not the reference's (another generator): parity tests load
    the reference's weights through ``interop.model_params_from_jax``."""
    model = Transformer(cfg, device)
    gen = torch.Generator(device=model.device).manual_seed(seed)
    model.embed.init(gen)
    for _, _, blk in model.layers():
        blk.init(gen)
    model.lm_head.init(gen)
    return model


# ---------------------------------------------------------------------------
# prefill
# ---------------------------------------------------------------------------

def inputs_to_embeddings(params: Transformer, cfg: ModelConfig, batch):
    """(B, S, d) token embeddings + (B, S) int32 positions."""
    check_served(cfg)
    x = params.embed(batch["tokens"])
    B, S = x.shape[0], x.shape[1]
    positions = torch.arange(S, dtype=torch.int32, device=x.device).expand(B, S)
    return x, positions


def ring(k: torch.Tensor, C: int) -> torch.Tensor:
    """Place position p of (B, G, S, hd) K/V at ring slot p % C (decode's
    write discipline): the last min(C, S) positions, zero-padded to C when
    S < C (slots 0..S-1 are then already right), else rolled by S % C."""
    S = k.shape[2]
    last = k[:, :, -min(C, S):]
    if last.shape[2] < C:
        return torch.nn.functional.pad(last, (0, 0, 0, C - last.shape[2]))
    return torch.roll(last, S % C, dims=2)


def forward_prefill(params: Transformer, cfg: ModelConfig, batch, cache_len: int):
    """Full-prompt forward that also builds the decode state (KV ring caches
    at their slots). Returns (logits f32 (B, S, vocab), decode_state)."""
    x, positions = inputs_to_embeddings(params, cfg, batch)
    B, S = x.shape[0], x.shape[1]
    C = ring_len(cfg, cache_len)
    kv = {}
    for key, _, blk in params.layers():
        x, (k, v) = blk.prefill(x, positions)
        kv.setdefault(key, []).append((ring(k, C), ring(v, C)))
    state = {"pos": torch.full((B,), S, dtype=torch.int32, device=x.device)}
    for key, entries in kv.items():
        state[key] = {"k": torch.stack([e[0] for e in entries]),
                      "v": torch.stack([e[1] for e in entries])}
    logits = params.lm_head(params.norm_f(x)).float()
    return logits, state


# ---------------------------------------------------------------------------
# decode (serve_step)
# ---------------------------------------------------------------------------

def decode_state_init(cfg: ModelConfig, batch: int, cache_len: int, device=None):
    """Per-layer KV ring caches (zeros) + the position counter, on ``device``
    (the card unless named)."""
    check_served(cfg)
    device = resolve_device(device)
    dt, G, hd, C = cfg.compute_dtype, cfg.n_kv_heads, cfg.hd, ring_len(cfg, cache_len)
    state = {}
    for pi in range(len(cfg.pattern)):
        shape = (cfg.n_blocks, batch, G, C, hd)
        state[f"blocks_{pi}"] = {"k": torch.zeros(shape, dtype=dt, device=device),
                                 "v": torch.zeros(shape, dtype=dt, device=device)}
    state["pos"] = torch.zeros((batch,), dtype=torch.int32, device=device)
    return state


def serve_step(params: Transformer, cfg: ModelConfig, state, inputs):
    """One decode step: a token per lane in, f32 logits (B, vocab) and the
    state out. The K/V tensors of ``state`` are updated in place and carried
    into the returned state; ``pos`` is a new tensor, one higher."""
    x = params.embed(inputs["token"][:, None])
    pos = state["pos"]
    new_state = dict(state, pos=pos + 1)
    for key, b, blk in params.layers():
        x = blk.decode(x, state[key]["k"][b], state[key]["v"][b], pos)
    logits = params.lm_head(params.norm_f(x)).float()[:, 0]
    return logits, new_state
