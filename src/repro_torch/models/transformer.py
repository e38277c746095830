"""Decoder stack: the training forward and its loss, prefill that builds the
decode state, and the one-token serve step — the port of
``repro.models.transformer``.

The stack is declared by ``pattern``, a repeating tuple of block kinds:

    dense:  [RMSNorm -> GQA attention -> +] [RMSNorm -> SwiGLU -> +]
    local:  same, attention windowed to cfg.local_window
    moe:    attention block + top-k MoE FFN
    rglru:  RG-LRU recurrent block + SwiGLU
    rwkv:   RWKV6 time mix + RWKV6 channel mix

``n_layers = len(pattern) * n_blocks + len(tail)``: the ``n_layers mod
len(pattern)`` tail layers follow the stacked blocks, e.g.
recurrentgemma-9b's 38 = (rglru, rglru, local) x 12 + (rglru, rglru).

Fronts: ``vlm`` prepends (B, P, d) patch embeddings to the token
embeddings (positions run over the whole); ``audio`` takes (B, S, d) frame
embeddings and has no embedding table. Both fronts are stubs, as in the
reference: the embeddings come in precomputed.

The decode state keeps the reference's layout, so the page pool translates
line for line and states compare leaf by leaf. ``state["blocks_<pi>"]``
holds, with a leading n_blocks axis, ``k``/``v`` (B, G, C, hd) for the
attention kinds (C the kind's ring, ``ring_len``), ``h`` (B, d_rnn) f32 and
``conv`` (B, W-1, d_rnn) for ``rglru``, ``shift_tm``/``shift_cm`` (B, 1, d)
and ``wkv`` (B, H, 64, 64) f32 for ``rwkv``; ``state["tail_<ti>"]`` the same
leaves without the layer axis; ``state["pos"]`` the (B,) int32 position
counter. ``serve_step`` writes into those tensors in place.
``decode_state_specs`` names each leaf's logical axes, as the reference
does, for a mesh's pieces.

Training (``forward_train``, ``loss_fn``) runs each block's ``forward``:
the same maths as its prefill without the decode state, plus the MoE's aux
loss, which serving drops. Prefill and serving run with gradients off; a
model's weights hold gradients only where the trainer turns them on
(``train/steps.py``).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.core.layout import resolve_device
from repro_torch.parallel.collectives import seq_shard, tp_group
from repro_torch.parallel.sharding import seq_parallel
from . import layers as L
from . import moe as M
from . import rglru as R
from . import rwkv6 as W

ATTENTION_KINDS = ("dense", "local", "moe")
_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
           "float16": torch.float16}


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

    def moe_cfg(self) -> M.MoEConfig:
        return M.MoEConfig(self.n_experts, self.top_k, self.capacity_factor)

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


def ring_len(cfg: ModelConfig, cache_len: int, kind: str = "dense") -> int:
    """Ring size C of an attention block's KV cache: the context, or the
    window (``local_window`` for ``local`` blocks, ``sliding_window`` for
    the others)."""
    if kind == "local":
        return min(cache_len, cfg.local_window)
    if cfg.sliding_window is None:
        return cache_len
    return min(cache_len, cfg.sliding_window)


def ring(k: torch.Tensor, C: int) -> torch.Tensor:
    """Place position p of (B, G, S, hd) K/V at ring slot p % C (decode's
    write discipline): the last min(C, S) positions, zero-padded to C when
    S < C (slots 0..S-1 are then already right), else rolled by S % C."""
    S = k.shape[2]
    last = k[:, :, -min(C, S):]
    if last.shape[2] < C:
        return torch.nn.functional.pad(last, (0, 0, 0, C - last.shape[2]))
    return torch.roll(last, S % C, dims=2)


# ---------------------------------------------------------------------------
# blocks: prefill emits the block's decode-state entry, decode updates it in
# place
# ---------------------------------------------------------------------------

class AttnBlock(nn.Module):
    """``dense``, ``local`` (the window is ``local_window``) and ``moe`` (an
    MoE FFN in place of the SwiGLU)."""

    def __init__(self, cfg: ModelConfig, kind: str, device):
        super().__init__()
        dt = cfg.compute_dtype
        self.cfg, self.kind = cfg, kind
        self.norm1 = L.RMSNorm(cfg.d_model, cfg.norm_eps, device)
        self.norm2 = L.RMSNorm(cfg.d_model, cfg.norm_eps, device)
        self.attn = L.Attention(cfg.attn_cfg(kind == "local"), dt, device)
        if kind == "moe":
            self.moe = M.MoE(cfg.d_model, cfg.d_ff, cfg.moe_cfg(), dt, device)
        else:
            self.mlp = L.SwiGLU(cfg.d_model, cfg.d_ff, dt, device)

    def init(self, generator):
        self.attn.init(generator)
        (self.moe if self.kind == "moe" else self.mlp).init(generator)

    def ffn(self, h):
        return self.moe(h)[0] if self.kind == "moe" else self.mlp(h)

    def forward(self, x, positions):
        """The training form: (x, the MoE's aux loss, or 0.0)."""
        x = x + self.attn(self.norm1(x), positions)
        h = self.norm2(x)
        if self.kind == "moe":
            y, aux = self.moe(h)
            return x + y, aux
        return x + self.mlp(h), 0.0

    def prefill(self, x, positions, cache_len: int):
        a, (k, v) = self.attn(self.norm1(x), positions, return_kv=True)
        x = x + a
        C = ring_len(self.cfg, cache_len, self.kind)
        return x + self.ffn(self.norm2(x)), {"k": ring(k, C), "v": ring(v, C)}

    def decode(self, x, st, pos):
        a, _, _ = self.attn.decode(self.norm1(x), st["k"], st["v"], pos)
        x = x + a
        return x + self.ffn(self.norm2(x))


class RGLRUBlock(nn.Module):
    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        dt = cfg.compute_dtype
        self.norm1 = L.RMSNorm(cfg.d_model, cfg.norm_eps, device)
        self.norm2 = L.RMSNorm(cfg.d_model, cfg.norm_eps, device)
        self.rnn = R.RGLRU(cfg.d_model, cfg.d_rnn or cfg.d_model, cfg.conv_width, dt, device)
        self.mlp = L.SwiGLU(cfg.d_model, cfg.d_ff, dt, device)

    def init(self, generator):
        self.rnn.init(generator)
        self.mlp.init(generator)

    def forward(self, x, positions):
        x = x + self.rnn(self.norm1(x))
        return x + self.mlp(self.norm2(x)), 0.0

    def prefill(self, x, positions, cache_len: int):
        y, (h, conv) = self.rnn(self.norm1(x), return_state=True)
        x = x + y
        return x + self.mlp(self.norm2(x)), {"h": h, "conv": conv}

    def decode(self, x, st, pos):
        y, h, conv = self.rnn.decode(self.norm1(x), st["h"], st["conv"])
        st["h"].copy_(h)
        st["conv"].copy_(conv)
        x = x + y
        return x + self.mlp(self.norm2(x))


class RWKVBlock(nn.Module):
    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        self.norm1 = L.RMSNorm(cfg.d_model, cfg.norm_eps, device)
        self.norm2 = L.RMSNorm(cfg.d_model, cfg.norm_eps, device)
        self.tm = W.RWKV6(cfg.d_model, cfg.d_ff, cfg.compute_dtype, device)

    def init(self, generator):
        self.tm.init(generator)

    def forward(self, x, positions):
        y, _ = W.rwkv6_time_mix(self.tm, self.norm1(x))
        x = x + y
        y, _ = W.rwkv6_channel_mix(self.tm, self.norm2(x))
        return x + y, 0.0

    def prefill(self, x, positions, cache_len: int):
        y, (shift, wkv) = W.rwkv6_time_mix(self.tm, self.norm1(x))
        x = x + y
        y, shift_cm = W.rwkv6_channel_mix(self.tm, self.norm2(x))
        return x + y, {"shift_tm": shift, "wkv": wkv, "shift_cm": shift_cm}

    def decode(self, x, st, pos):
        y, (shift, wkv) = W.rwkv6_time_mix_decode(self.tm, self.norm1(x), st["shift_tm"],
                                                  st["wkv"])
        x = x + y
        y, shift_cm = W.rwkv6_channel_mix(self.tm, self.norm2(x), st["shift_cm"])
        for f, t in (("shift_tm", shift), ("wkv", wkv), ("shift_cm", shift_cm)):
            st[f].copy_(t)
        return x + y


def make_block(cfg: ModelConfig, kind: str, device) -> nn.Module:
    if kind in ATTENTION_KINDS:
        return AttnBlock(cfg, kind, device)
    if kind == "rglru":
        return RGLRUBlock(cfg, device)
    if kind == "rwkv":
        return RWKVBlock(cfg, device)
    raise ValueError(kind)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

class Transformer(nn.Module):
    """The decoder's weights on one device, in the compute dtype (RMSNorm
    scales and the recurrent kinds' f32 leaves in f32). ``blocks[pi][b]`` is
    block ``b`` of pattern position ``pi`` (the reference's stacked
    ``blocks_<pi>`` leaves, index ``b``); ``tails[ti]`` is ``tail_<ti>``;
    ``embed`` is None for the audio front. Made uninitialised:
    ``init_params`` draws the weights, ``interop.model_params_from_jax``
    loads them."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        device = resolve_device(device)
        dt = cfg.compute_dtype
        self.cfg = cfg
        self.embed = (None if cfg.family == "audio"
                      else L.Embed(cfg.vocab_size, cfg.d_model, dt, device))
        self.blocks = nn.ModuleList(
            nn.ModuleList(make_block(cfg, kind, device) for _ in range(cfg.n_blocks))
            for kind in cfg.pattern)
        self.tails = nn.ModuleList(make_block(cfg, kind, device) for kind in cfg.tail)
        self.norm_f = L.RMSNorm(cfg.d_model, cfg.norm_eps, device)
        self.lm_head = L.Unembed(cfg.d_model, cfg.vocab_size, dt, device)

    @property
    def device(self) -> torch.device:
        return self.lm_head.w.device

    def layers(self):
        """(state key, index, block) in the reference's layer order: every
        pattern position of block 0, then of block 1, ..., then the tail
        layers (index None: their state has no layer axis)."""
        for b in range(self.cfg.n_blocks):
            for pi in range(len(self.cfg.pattern)):
                yield f"blocks_{pi}", b, self.blocks[pi][b]
        for ti, blk in enumerate(self.tails):
            yield f"tail_{ti}", None, blk


def init_params(cfg: ModelConfig, seed: int = 0, device=None) -> Transformer:
    """A ``Transformer`` on ``device`` (the card unless named) with the
    reference's initialisation: truncated normals (±2σ) and uniforms at its
    scales, drawn from a generator on that device seeded with ``seed``;
    norms at 1. The draws are not the reference's (another generator):
    parity tests load the reference's weights through
    ``interop.model_params_from_jax``."""
    model = Transformer(cfg, device)
    gen = torch.Generator(device=model.device).manual_seed(seed)
    if model.embed is not None:
        model.embed.init(gen)
    for _, _, blk in model.layers():
        blk.init(gen)
    model.lm_head.init(gen)
    return model


# ---------------------------------------------------------------------------
# logical-axis specs (parallel/sharding.py maps them to mesh axes)
# ---------------------------------------------------------------------------

EMBED, HEADS, KV, HEAD_DIM, MLP, VOCAB, EXPERT, LAYERS, RNN = (
    "embed", "heads", "kv", "head_dim", "mlp", "vocab", "expert", "layers", "rnn")

_SPECS = {
    "norm": {"scale": (EMBED,)},
    "attn": {"wq": (EMBED, HEADS), "wk": (EMBED, KV), "wv": (EMBED, KV), "wo": (HEADS, EMBED)},
    "mlp": {"w_gate": (EMBED, MLP), "w_up": (EMBED, MLP), "w_down": (MLP, EMBED)},
    "moe": {"router": (EMBED, None), "w_gate": (EXPERT, EMBED, MLP),
            "w_up": (EXPERT, EMBED, MLP), "w_down": (EXPERT, MLP, EMBED)},
    "rnn": {"w_x": (EMBED, RNN), "w_gate": (EMBED, RNN), "w_out": (RNN, EMBED),
            "conv_w": (None, RNN), "w_rg": (RNN, RNN), "w_ig": (RNN, RNN), "lam": (RNN,)},
    "tm": {"w_r": (EMBED, HEADS), "w_k": (EMBED, HEADS), "w_v": (EMBED, HEADS),
           "w_g": (EMBED, HEADS), "w_o": (HEADS, EMBED), "w_decay": (EMBED, HEADS),
           "decay_base": (HEADS,), "bonus_u": (HEADS,), "mix_r": (EMBED,), "mix_kv": (EMBED,),
           "cm_k": (EMBED, MLP), "cm_v": (MLP, EMBED)},
}


def _block_specs(kind: str) -> dict:
    s = {"norm1": _SPECS["norm"], "norm2": _SPECS["norm"]}
    if kind in ATTENTION_KINDS:
        s["attn"] = _SPECS["attn"]
        s["moe" if kind == "moe" else "mlp"] = _SPECS["moe" if kind == "moe" else "mlp"]
    elif kind == "rglru":
        s.update(rnn=_SPECS["rnn"], mlp=_SPECS["mlp"])
    elif kind == "rwkv":
        s["tm"] = _SPECS["tm"]
    else:
        raise ValueError(kind)
    return s


def param_specs(cfg: ModelConfig) -> dict:
    """The reference's spec tree of ``cfg``'s parameters: the parameter
    tree's keys, each leaf a tuple of logical axis names (``blocks_<pi>``
    leaves led by ``"layers"``)."""
    specs: dict = {}
    if cfg.family != "audio":
        specs["embed"] = {"table": (VOCAB, EMBED)}
    for pi, kind in enumerate(cfg.pattern):
        specs[f"blocks_{pi}"] = {k: {n: (LAYERS,) + t for n, t in v.items()}
                                 for k, v in _block_specs(kind).items()}
    for ti, kind in enumerate(cfg.tail):
        specs[f"tail_{ti}"] = _block_specs(kind)
    specs["norm_f"] = _SPECS["norm"]
    specs["lm_head"] = {"w": (EMBED, VOCAB)}
    return specs


# ---------------------------------------------------------------------------
# train forward and loss
# ---------------------------------------------------------------------------

def inputs_to_embeddings(params: Transformer, cfg: ModelConfig, batch):
    """Map the modality front (stubbed for vlm/audio) to (B, S, d) + (B, S)
    int32 positions."""
    dt = cfg.compute_dtype
    if cfg.family == "audio":
        x = batch["frame_embeds"].to(dt)
    elif cfg.family == "vlm":
        x = torch.cat([batch["patch_embeds"].to(dt), params.embed(batch["tokens"])], dim=1)
    else:
        x = params.embed(batch["tokens"])
    B, S = x.shape[0], x.shape[1]
    positions = torch.arange(S, dtype=torch.int32, device=x.device).expand(B, S)
    return x, positions


def forward_train(params: Transformer, cfg: ModelConfig, batch):
    """Full-sequence forward through every layer in the reference's order
    (``params.layers()``: the stacked blocks, then the tail). Returns (f32
    logits (B, S, vocab), the summed MoE aux loss, f32).

    With ``cfg.remat`` other than ``"none"`` each stacked block runs under
    ``torch.utils.checkpoint`` (non-reentrant): its activations are
    recomputed in the backward pass instead of kept. ``"dots"`` and
    ``"full"`` both map onto that; there is no twin of the reference's
    ``checkpoint_dots_with_no_batch_dims`` policy. Remat changes memory,
    never values.

    On a mesh (``parallel.sharding.use``) the layers run on this rank's
    weight slices (``models/layers.py``), the residual stream between them
    on this rank's piece of the sequence under sequence parallelism, and
    the logits are this rank's block: the sequence piece with the whole
    vocabulary, or without sequence parallelism the whole sequence with
    the lm head's vocabulary slice."""
    x, positions = inputs_to_embeddings(params, cfg, batch)
    ag = tp_group()
    if seq_parallel() and x.shape[1] % ag.size:
        raise ValueError(f"a sequence of {x.shape[1]} does not split over {ag.size} 'model' "
                         f"ranks (sequence parallelism)")
    x = seq_shard(x)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for _, index, blk in params.layers():
        if cfg.remat != "none" and index is not None:
            x, a = checkpoint(blk, x, positions, use_reentrant=False)
        else:
            x, a = blk(x, positions)
        aux = aux + a
    logits = params.lm_head(params.norm_f(x)).float()
    return logits, aux


def loss_fn(params: Transformer, cfg: ModelConfig, batch, aux_weight: float = 0.01,
            z_weight: float = 1e-4):
    """Causal-LM cross entropy (+ MoE aux + z-loss); labels < 0 are masked.
    For vlm the labels cover only the text positions (the sequence's suffix).
    Returns (loss, (ce, aux)), all f32 scalars."""
    logits, aux = forward_train(params, cfg, batch)
    labels = batch["labels"]
    if cfg.family == "vlm":
        logits = logits[:, -labels.shape[1]:]
    mask = (labels >= 0).float()
    safe = torch.clamp(labels, min=0).long()
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, safe[..., None])[..., 0]
    n = torch.clamp(mask.sum(), min=1.0)
    ce = torch.sum((lse - ll) * mask) / n
    zl = torch.sum(torch.square(lse) * mask) / n
    return ce + aux_weight * aux + z_weight * zl, (ce, aux)


# ---------------------------------------------------------------------------
# prefill
# ---------------------------------------------------------------------------

@torch.no_grad()
def forward_prefill(params: Transformer, cfg: ModelConfig, batch, cache_len: int):
    """Full-prompt forward that also builds the decode state (KV ring caches
    at their slots, final recurrent states). Returns (logits f32 (B, S,
    vocab), decode_state)."""
    x, positions = inputs_to_embeddings(params, cfg, batch)
    B, S = x.shape[0], x.shape[1]
    state = {"pos": torch.full((B,), S, dtype=torch.int32, device=x.device)}
    stacked = {}
    for key, index, blk in params.layers():
        x, st = blk.prefill(x, positions, cache_len)
        if index is None:
            state[key] = st
        else:
            stacked.setdefault(key, []).append(st)
    for key, entries in stacked.items():
        state[key] = {f: torch.stack([e[f] for e in entries]) for f in entries[0]}
    logits = params.lm_head(params.norm_f(x)).float()
    return logits, state


# ---------------------------------------------------------------------------
# decode (serve_step)
# ---------------------------------------------------------------------------

def _block_state_init(cfg: ModelConfig, kind: str, batch: int, cache_len: int, device):
    """One block's decode state (zeros): the reference's leaves, shapes and
    dtypes."""
    dt = cfg.compute_dtype
    if kind in ATTENTION_KINDS:
        shape = (batch, cfg.n_kv_heads, ring_len(cfg, cache_len, kind), cfg.hd)
        return {"k": torch.zeros(shape, dtype=dt, device=device),
                "v": torch.zeros(shape, dtype=dt, device=device)}
    if kind == "rglru":
        h, conv = R.rglru_state_init(batch, cfg.d_rnn or cfg.d_model, cfg.conv_width, dt,
                                     device)
        return {"h": h, "conv": conv}
    if kind == "rwkv":
        shift, wkv = W.rwkv6_state_init(batch, cfg.d_model, dt, device)
        return {"shift_tm": shift, "wkv": wkv, "shift_cm": torch.zeros_like(shift)}
    raise ValueError(kind)


def decode_state_init(cfg: ModelConfig, batch: int, cache_len: int, device=None):
    """Per-layer decode state (zeros) + the position counter, on ``device``
    (the card unless named)."""
    device = resolve_device(device)

    def zeros(kind, lead):
        return {f: torch.zeros(lead + t.shape, dtype=t.dtype, device=device)
                for f, t in _block_state_init(cfg, kind, batch, cache_len, "meta").items()}
    state = {f"blocks_{pi}": zeros(kind, (cfg.n_blocks,)) for pi, kind in enumerate(cfg.pattern)}
    state.update({f"tail_{ti}": zeros(kind, ()) for ti, kind in enumerate(cfg.tail)})
    state["pos"] = torch.zeros((batch,), dtype=torch.int32, device=device)
    return state


def _block_state_specs(kind: str) -> dict:
    if kind in ATTENTION_KINDS:
        return {"k": ("batch", "kv_heads", "cache", "head_dim"),
                "v": ("batch", "kv_heads", "cache", "head_dim")}
    if kind == "rglru":
        return {"h": ("batch", "rnn"), "conv": ("batch", None, "rnn")}
    if kind == "rwkv":
        return {"shift_tm": ("batch", None, "act_embed"),
                "wkv": ("batch", "heads", None, None),
                "shift_cm": ("batch", None, "act_embed")}
    raise ValueError(kind)


def decode_state_specs(cfg: ModelConfig) -> dict:
    """The logical-axis spec tree of ``decode_state_init``'s state (the
    reference's): ``blocks_<pi>`` leaves led by ``"layers"``."""
    specs = {f"blocks_{pi}": {f: ("layers",) + t for f, t in _block_state_specs(kind).items()}
             for pi, kind in enumerate(cfg.pattern)}
    specs.update({f"tail_{ti}": _block_state_specs(kind) for ti, kind in enumerate(cfg.tail)})
    specs["pos"] = ("batch",)
    return specs


@torch.no_grad()
def serve_step(params: Transformer, cfg: ModelConfig, state, inputs):
    """One decode step: a token (or, for audio, a (B, 1, d) frame embedding)
    per lane in, f32 logits (B, vocab) and the state out. The tensors of
    ``state`` are updated in place and carried into the returned state;
    ``pos`` is a new tensor, one higher.

    On a mesh (``train.steps.make_mesh_serve_step``) ``params`` holds this
    rank's weight slices, ``state`` its piece of the decode state (its
    lanes; its piece of each ring; its ``rnn`` channels and RWKV heads)
    and ``inputs`` its lanes; the embedding and the lm head are vocabulary
    slices, so the logits are this rank's ``("batch", "vocab")`` block."""
    if cfg.family == "audio":
        x = inputs["frame_embeds"].to(cfg.compute_dtype)
    else:
        x = params.embed(inputs["token"][:, None])
    pos = state["pos"]
    for key, index, blk in params.layers():
        st = state[key] if index is None else {f: t[index] for f, t in state[key].items()}
        x = blk.decode(x, st, pos)
    logits = params.lm_head(params.norm_f(x)).float()[:, 0]
    return logits, dict(state, pos=pos + 1)
