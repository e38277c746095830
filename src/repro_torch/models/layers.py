"""Transformer building blocks: RMSNorm, RoPE, GQA attention (full causal,
sliding window with a static KV band), SwiGLU MLP, embedding — the port of
``repro.models.layers``.

Conventions:
  * the maths are plain functions on tensors; ``RMSNorm``, ``Attention``,
    ``SwiGLU``, ``Embed`` and ``Unembed`` are ``nn.Module``s on an explicit
    device that hold the weights and call them;
  * weights are held in the compute dtype, cast once when they are made or
    loaded (the reference keeps f32 weights and casts at every use: the same
    bits); RMSNorm scales stay f32, as in the reference;
  * prefill attention is an online softmax over KV chunks in f32; decode
    attention is a grouped-query product straight against the cache with
    bf16 inputs and f32 results. No fused-attention library: its numerics
    differ from the reference's;
  * on a mesh (tensor parallelism, ``parallel.sharding``) a weight may be
    this rank's slice over 'model' (its heads, ``mlp`` columns or
    vocabulary rows): the training forms read the whole sequence
    (``tp_in``), compute on the slice, and hand a partial sum back to the
    residual stream (``tp_out``). The weights' shapes say which.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.parallel.collectives import (all_reduce_, all_reduce_sum, tp_group, tp_in,
                                              tp_out, tp_slice)


def truncated_normal_(w: torch.Tensor, scale: float, generator) -> torch.Tensor:
    """Fill ``w`` with ``scale`` times a standard normal truncated to ±2σ,
    drawn in f32 from ``generator`` and cast once to ``w``'s dtype."""
    t = torch.empty(w.shape, dtype=torch.float32, device=w.device)
    nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=generator)
    return w.copy_(t.mul_(scale))


def _weight(shape, dtype, device) -> nn.Parameter:
    # serving holds no gradients; the trainer turns them on for its own
    # working model (train/steps.py)
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device),
                        requires_grad=False)


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------

def rmsnorm(scale: torch.Tensor, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return (x * scale).to(dt)


class RMSNorm(nn.Module):
    def __init__(self, d: int, eps: float, device):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(d, dtype=torch.float32, device=device),
                                  requires_grad=False)

    def forward(self, x):
        return rmsnorm(self.scale, x, self.eps)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope_frequencies(head_dim: int, theta: float) -> np.ndarray:
    return 1.0 / (theta ** (np.arange(0, head_dim, 2, dtype=np.float32) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float,
               freqs: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x: (..., S, hd); positions: (..., S) int32. Angles in f32. ``freqs``
    is ``rope_frequencies(hd, theta)`` already on x's device (a copy from the
    host waits for the card's queue, so callers on a hot path keep one)."""
    hd = x.shape[-1]
    if freqs is None:
        freqs = torch.from_numpy(rope_frequencies(hd, theta)).to(x.device)
    angles = positions[..., None].float() * freqs                 # (..., S, hd/2)
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x[..., : hd // 2], x[..., hd // 2:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class AttnConfig:
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    rope_theta: float = 10000.0
    sliding_window: Optional[int] = None   # None = full causal
    q_chunk: int = 512
    kv_chunk: int = 1024


def _chunked_attention(q, k, v, q_start: int, kv_start: int, causal_offset: int,
                       window: Optional[int]):
    """Online softmax over KV chunks of at most 1024 keys for one query block.

    q: (B, H, Tq, hd); k, v: (B, G, Skv, hd) with H % G == 0. Query i sits at
    position q_start + i, key j at kv_start + j; a key is visible when
    key_pos <= query_pos + causal_offset (and inside the window)."""
    B, H, Tq, hd = q.shape
    rep = H // k.shape[1]
    scale = 1.0 / math.sqrt(hd)
    Skv = k.shape[2]
    kc = min(Skv, 1024)
    pad = (-Skv) % kc
    if pad:
        # padded keys sit at positions >= the real length: masked by causality
        k = F.pad(k, (0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, pad))
    q32 = q.float() * scale
    qpos = q_start + torch.arange(Tq, device=q.device)
    m = torch.full((B, H, Tq), -1e30, dtype=torch.float32, device=q.device)
    l = torch.zeros((B, H, Tq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, H, Tq, hd), dtype=torch.float32, device=q.device)
    for ci in range((Skv + pad) // kc):
        ks = k[:, :, ci * kc:(ci + 1) * kc].repeat_interleave(rep, dim=1).float()
        vs = v[:, :, ci * kc:(ci + 1) * kc].repeat_interleave(rep, dim=1).float()
        s = torch.matmul(q32, ks.transpose(-1, -2))
        kpos = kv_start + ci * kc + torch.arange(kc, device=q.device)
        mask = kpos[None, :] <= (qpos[:, None] + causal_offset)
        if window is not None:
            mask &= kpos[None, :] > (qpos[:, None] + causal_offset - window)
        s = torch.where(mask, s, -1e30)
        m2 = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m2[..., None])
        corr = torch.exp(m - m2)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.matmul(p, vs)
        m = m2
    return (acc / l.clamp_min(1e-30)[..., None]).to(q.dtype)


def _project(x, w, n, hd):
    """(B, S, d) @ (d, n*hd) -> (B, n, S, hd)."""
    B, S, _ = x.shape
    return (x @ w).reshape(B, S, n, hd).transpose(1, 2)


def attention_train(w, cfg: AttnConfig, x, positions, return_kv: bool = False):
    """Full-sequence causal attention (prefill). ``w`` is an ``Attention``.

    Sliding-window layers use a static band: each query block visits only
    the KV slice [block_end - band, block_end), so cost is O(S * window).
    The slice start is clamped into the keys, as the reference's
    ``dynamic_slice`` clamps it, and the keys are labelled with that clamped
    start: the reference labels them with the unclamped one, which puts the
    wrong positions on the keys (and the wrong causal and window mask) when
    the query padding pushes the last block past ``S - band``.

    Under tensor parallelism ``wq`` / ``wo`` hold this rank's heads and
    ``wk`` / ``wv`` its kv heads, or all of them where the kv heads do not
    split with the query heads (MQA): the kv heads this rank's query heads
    read are then picked out. The output is a partial sum over 'model'."""
    x = tp_in(x)
    B, S, _ = x.shape
    H, G, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    Hl, Gl = w.wq.shape[1] // hd, w.wk.shape[1] // hd
    q = apply_rope(_project(x, w.wq, Hl, hd), positions[:, None, :], cfg.rope_theta, w.freqs)
    k = apply_rope(_project(x, w.wk, Gl, hd), positions[:, None, :], cfg.rope_theta, w.freqs)
    v = _project(x, w.wv, Gl, hd)
    if Hl < H and Gl == G:
        kv = (tp_slice(H, Hl) + torch.arange(Hl, device=x.device)) // (H // G)
        k, v = k[:, kv], v[:, kv]

    S_real = S
    qc = min(cfg.q_chunk, S)
    qpad = (-S) % qc
    if qpad:
        # pad queries (outputs trimmed) — padded keys are causally invisible
        q = F.pad(q, (0, 0, 0, qpad))
        S = S + qpad
    W = cfg.sliding_window
    outs = []
    if W is not None and W < S:
        band = min(int(2 ** math.ceil(math.log2(W + qc))), S_real)   # static KV band
        for qi in range(S // qc):
            start = min(max(qi * qc + qc - band, 0), S_real - band)
            outs.append(_chunked_attention(q[:, :, qi * qc:(qi + 1) * qc],
                                           k[:, :, start:start + band],
                                           v[:, :, start:start + band],
                                           qi * qc, start, 0, W))
    else:
        for qi in range(S // qc):
            outs.append(_chunked_attention(q[:, :, qi * qc:(qi + 1) * qc], k, v,
                                           qi * qc, 0, 0, W))
    out = torch.cat(outs, dim=2)[:, :, :S_real]
    out = tp_out(out.transpose(1, 2).reshape(B, S_real, Hl * hd) @ w.wo, Hl < H)
    if return_kv:
        return out, (k, v)      # roped K/V (B, G, S, hd) for cache assembly
    return out


def attention_decode(w, cfg: AttnConfig, x, cache_k, cache_v, cache_len):
    """One-token decode against a KV cache, written IN PLACE.

    cache_k/v: (B, G, C, hd) — C is the full context for dense layers or the
    ring window for SWA layers; the new token's K/V go to ring slot
    ``cache_len % C`` of each lane (the reference's where-write). Returns
    (out, cache_k, cache_v)."""
    B = x.shape[0]
    H, G, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    C = cache_k.shape[2]
    pos = cache_len[:, None, None]                      # (B,1,1) true position
    q = apply_rope(_project(x, w.wq, H, hd), pos, cfg.rope_theta, w.freqs)
    k = apply_rope(_project(x, w.wk, G, hd), pos, cfg.rope_theta, w.freqs)
    v = _project(x, w.wv, G, hd)
    lanes = torch.arange(B, device=x.device)
    slot = torch.remainder(cache_len, C).long()
    cache_k[lanes, :, slot] = k[:, :, 0]
    cache_v[lanes, :, slot] = v[:, :, 0]

    # grouped-query product straight against the cache: bf16 inputs, f32
    # results (the upcast is exact; a bf16 matmul would round its output)
    q5 = (q / math.sqrt(hd)).to(cache_k.dtype).reshape(B, G, H // G, hd)
    s = torch.matmul(q5.float(), cache_k.float().transpose(-1, -2))   # (B,G,rep,C)
    # valid = slots < cache_len+1 (ring: all slots valid once wrapped)
    valid = torch.arange(C, device=x.device)[None, :] < torch.clamp(
        cache_len + 1, max=C)[:, None]
    s = torch.where(valid[:, None, None, :], s, -1e30)
    p = torch.softmax(s, dim=-1)
    out = torch.matmul(p.to(cache_v.dtype).float(), cache_v.float()).to(x.dtype)
    return out.reshape(B, 1, H * hd) @ w.wo, cache_k, cache_v


class Attention(nn.Module):
    """GQA attention weights: wq (d, H*hd), wk, wv (d, G*hd), wo (H*hd, d);
    and the RoPE frequencies on the same device."""

    def __init__(self, cfg: AttnConfig, dtype, device):
        super().__init__()
        self.cfg = cfg
        d, H, G, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        self.register_buffer("freqs", torch.from_numpy(
            rope_frequencies(hd, cfg.rope_theta)).to(device), persistent=False)
        self.wq = _weight((d, H * hd), dtype, device)
        self.wk = _weight((d, G * hd), dtype, device)
        self.wv = _weight((d, G * hd), dtype, device)
        self.wo = _weight((H * hd, d), dtype, device)

    def init(self, generator):
        s = 1.0 / math.sqrt(self.cfg.d_model)
        for name in ("wq", "wk", "wv"):
            truncated_normal_(getattr(self, name), s, generator)
        truncated_normal_(self.wo, 1.0 / math.sqrt(self.wo.shape[0]), generator)

    def forward(self, x, positions, return_kv: bool = False):
        return attention_train(self, self.cfg, x, positions, return_kv)

    def decode(self, x, cache_k, cache_v, cache_len):
        return attention_decode(self, self.cfg, x, cache_k, cache_v, cache_len)


# ---------------------------------------------------------------------------
# MLP (SwiGLU)
# ---------------------------------------------------------------------------

def mlp(w, x):
    """SwiGLU; under tensor parallelism on this rank's ``mlp`` columns, the
    output a partial sum over 'model'."""
    x = tp_in(x)
    y = (F.silu(x @ w.w_gate) * (x @ w.w_up)) @ w.w_down
    return tp_out(y, w.w_down.shape[0] < w.d_ff)


class SwiGLU(nn.Module):
    def __init__(self, d: int, d_ff: int, dtype, device):
        super().__init__()
        self.d_ff = d_ff
        self.w_gate = _weight((d, d_ff), dtype, device)
        self.w_up = _weight((d, d_ff), dtype, device)
        self.w_down = _weight((d_ff, d), dtype, device)

    def init(self, generator):
        d, d_ff = self.w_gate.shape
        truncated_normal_(self.w_gate, 1.0 / math.sqrt(d), generator)
        truncated_normal_(self.w_up, 1.0 / math.sqrt(d), generator)
        truncated_normal_(self.w_down, 1.0 / math.sqrt(d_ff), generator)

    def forward(self, x):
        return mlp(self, x)


# ---------------------------------------------------------------------------
# embedding / unembedding
# ---------------------------------------------------------------------------

def embed(table, tokens, vocab: Optional[int] = None):
    """The rows of ``tokens``. A table of fewer than ``vocab`` rows is this
    rank's slice over 'model' (vocab-parallel): it looks up the ids in its
    range, zeros elsewhere, and the pieces are summed over 'model' (exact:
    one term a token is not zero)."""
    n = table.shape[0]
    if vocab is None or n == vocab:
        return table[tokens.long()]
    ids = tokens.long() - tp_slice(vocab, n)
    hit = (ids >= 0) & (ids < n)
    rows = table[torch.where(hit, ids, 0)]
    return all_reduce_sum(torch.where(hit[..., None], rows, torch.zeros_like(rows)), tp_group())


def unembed(w, x, vocab: Optional[int] = None):
    """Logits ``x @ w``; a ``w`` of fewer than ``vocab`` columns is this
    rank's vocabulary slice, over the whole sequence (``tp_in``)."""
    if vocab is not None and w.shape[1] < vocab:
        x = tp_in(x)
    return x @ w


def vocab_parallel_lse(logits, labels, vocab: int):
    """(logsumexp, the label's logit) of f32 logits whose last dim is this
    rank's slice of ``vocab`` over 'model': the max, the sum of
    exponentials and the label's logit combined over 'model'."""
    ag = tp_group()
    n = logits.shape[-1]
    mx = all_reduce_(logits.detach().amax(-1), ag, op=torch.distributed.ReduceOp.MAX)
    lse = mx + torch.log(all_reduce_sum(torch.exp(logits - mx[..., None]).sum(-1), ag))
    ids = labels.long() - tp_slice(vocab, n)
    hit = (ids >= 0) & (ids < n)
    own = torch.gather(logits, -1, torch.where(hit, ids, 0)[..., None])[..., 0]
    return lse, all_reduce_sum(torch.where(hit, own, torch.zeros_like(own)), ag)


class Embed(nn.Module):
    def __init__(self, vocab: int, d: int, dtype, device):
        super().__init__()
        self.vocab = vocab
        self.table = _weight((vocab, d), dtype, device)

    def init(self, generator):
        truncated_normal_(self.table, 1.0, generator)

    def forward(self, tokens):
        return embed(self.table, tokens, self.vocab)


class Unembed(nn.Module):
    def __init__(self, d: int, vocab: int, dtype, device):
        super().__init__()
        self.vocab = vocab
        self.w = _weight((d, vocab), dtype, device)

    def init(self, generator):
        truncated_normal_(self.w, 1.0 / math.sqrt(self.w.shape[0]), generator)

    def forward(self, x):
        return unembed(self.w, x, self.vocab)
