"""RWKV-6 "Finch" block (arXiv:2404.05892): attention-free time mixing with
data-dependent per-channel decay, + squared-ReLU channel mixing — the port
of ``repro.models.rwkv6``.

Time mixing is computed in chunked linear-attention form: within a chunk of
length C the intra-chunk term is a masked (C x C) product weighted by
cumulative decays; across chunks a per-head (hd x hd) state carries,
updated with the chunk's total decay. Decode is the plain recurrence on the
(H, hd, hd) state.

The reference reshapes the sequence into ``S // C`` whole chunks, so a
prompt longer than ``CHUNK`` that is not a multiple of it raises there. Here
the last ``S mod CHUNK`` tokens form a shorter chunk computed by the same
formulas; whole chunks give the reference's numbers unchanged.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.parallel.collectives import tp_in, tp_out
from .layers import _weight, truncated_normal_

HEAD_SIZE = 64
CHUNK = 64
# Per-step log-decay clamp: the chunked form uses exp(-cum) factors whose
# exponents are bounded by |logw| * CHUNK; clamping keeps them inside f32
# range (0.35 * 64 ~ e^22). Decode applies the same clamp.
LOGW_MIN = -0.35

#: the f32 leaves: the reference keeps them f32 and casts only products of
#: them (``(1 - mix)`` is taken in f32, then cast)
F32_LEAVES = ("decay_base", "bonus_u", "mix_r", "mix_kv")


def _token_shift(x, mix, last=None):
    """x_t' = x_t * mix + x_{t-1} * (1 - mix), ``mix`` f32 and both factors
    cast to x's dtype. last: (B, 1, d) carry. Returns (x', the new carry)."""
    if last is None:
        last = torch.zeros_like(x[:, :1])
    prev = torch.cat([last, x[:, :-1]], dim=1)
    return x * mix.to(x.dtype) + prev * (1.0 - mix).to(x.dtype), x[:, -1:]


def _heads(x, H):
    B, S, d = x.shape
    return x.reshape(B, S, H, HEAD_SIZE).transpose(1, 2)   # (B, H, S, hd)


def _wkv_chunk(r, k, v, logw, u, state):
    """One chunk of the chunked WKV. r, k, v, logw: (B, H, C, hd) f32 (logw
    clamped); u: (H, hd); state: (B, H, hd, hd). Returns (out, state)."""
    C = r.shape[2]
    cum = torch.cumsum(logw, dim=2)                     # inclusive decay prefix
    tot = cum[:, :, -1:]                                # (B, H, 1, hd)
    # inter-chunk: r_t decayed into the carried state (decay BEFORE t)
    r_dec = r * torch.exp(cum - logw)
    inter = torch.matmul(r_dec, state)
    # intra-chunk: A[t, s] = sum_c r[t,c] e^{cum_t - logw_t - cum_s} k[s,c], s < t
    k_w = k * torch.exp(-cum)
    A = torch.matmul(r_dec, k_w.transpose(-1, -2))
    A = A * torch.tril(torch.ones((C, C), dtype=torch.float32, device=r.device), diagonal=-1)
    intra = torch.matmul(A, v)
    # current-token bonus: (r_t . (u * k_t)) v_t
    bonus = (r * (u[None, :, None, :] * k)).sum(-1)
    out = inter + intra + bonus[..., None] * v
    # state update: S' = diag(e^{tot}) S + sum_s e^{tot - cum_s} k_s v_s^T
    k_dec = k * torch.exp(tot - cum)
    state = torch.exp(tot).transpose(-1, -2) * state + torch.matmul(k_dec.transpose(-1, -2), v)
    return out, state


def _wkv_chunked(r, k, v, w, u, state0=None):
    """Chunked WKV. r, k, v, w: (B, H, S, hd) f32; w = per-step decay in
    (0, 1); u: (H, hd) bonus. Chunks of ``CHUNK`` tokens, the last one
    ``S mod CHUNK`` long where that is not 0. Returns (out (B, H, S, hd),
    state (B, H, hd, hd))."""
    B, H, S, hd = r.shape
    logw = torch.clamp(torch.log(torch.clamp(w, min=1e-8)), min=LOGW_MIN)
    state = (torch.zeros((B, H, hd, hd), dtype=torch.float32, device=r.device)
             if state0 is None else state0)
    outs = []
    for s0 in range(0, S, CHUNK):
        sl = slice(s0, min(s0 + CHUNK, S))
        out, state = _wkv_chunk(r[:, :, sl], k[:, :, sl], v[:, :, sl], logw[:, :, sl], u,
                                state)
        outs.append(out)
    return torch.cat(outs, dim=2), state


def rwkv6_time_mix(w, x, shift_last=None, wkv_state=None):
    """(B, S, d) -> (B, S, d); returns (out, (shift_last, wkv_state)). Under
    tensor parallelism on the whole sequence (``tp_in``) and this rank's
    heads (``w_r`` ... ``w_decay`` columns, ``decay_base``, ``bonus_u``,
    ``w_o`` rows), the output a partial sum over 'model'."""
    x = tp_in(x)
    B, S, _ = x.shape
    d = w.w_r.shape[1]
    H = d // HEAD_SIZE
    xr, last = _token_shift(x, w.mix_r, shift_last)
    xkv, _ = _token_shift(x, w.mix_kv, shift_last)
    r = _heads(xr @ w.w_r, H).float()
    k = _heads(xkv @ w.w_k, H).float()
    v = _heads(xkv @ w.w_v, H).float()
    g = F.silu(x @ w.w_g)
    # data-dependent decay (v6): w_t = exp(-exp(base + W_d x_t)) in (0, 1)
    dd = (xkv @ w.w_decay).float()
    decay = _heads(torch.exp(-torch.exp(w.decay_base + dd)), H)
    u = w.bonus_u.reshape(H, HEAD_SIZE)
    out, state = _wkv_chunked(r, k, v, decay, u, wkv_state)
    out = out.transpose(1, 2).reshape(B, S, d).to(x.dtype)
    return tp_out((out * g) @ w.w_o, d < w.d), (last, state)


def rwkv6_time_mix_decode(w, x, shift_last, wkv_state):
    """The O(1) recurrence for one token. x: (B, 1, d). Returns (out,
    (x, new wkv state))."""
    B, _, d = x.shape
    H = d // HEAD_SIZE
    xr = x * w.mix_r.to(x.dtype) + shift_last * (1 - w.mix_r).to(x.dtype)
    xkv = x * w.mix_kv.to(x.dtype) + shift_last * (1 - w.mix_kv).to(x.dtype)
    r = _heads(xr @ w.w_r, H)[:, :, 0].float()
    k = _heads(xkv @ w.w_k, H)[:, :, 0].float()
    v = _heads(xkv @ w.w_v, H)[:, :, 0].float()
    g = F.silu(x @ w.w_g)
    dd = (xkv @ w.w_decay).float()
    decay = torch.exp(torch.clamp(-torch.exp(w.decay_base + dd), min=LOGW_MIN))
    decay = _heads(decay, H)[:, :, 0]                                 # (B, H, hd)
    u = w.bonus_u.reshape(H, HEAD_SIZE)
    kv = k[..., :, None] * v[..., None, :]
    out = torch.matmul(r[..., None, :], wkv_state + u[None, :, :, None] * kv)[..., 0, :]
    new_state = decay[..., None] * wkv_state + kv
    out = out.reshape(B, 1, d).to(x.dtype)
    return (out * g) @ w.w_o, (x, new_state)


def rwkv6_channel_mix(w, x, shift_last=None):
    """Squared-ReLU channel mixing; under tensor parallelism on the whole
    sequence and this rank's ``mlp`` columns, the output a partial sum over
    'model'."""
    x = tp_in(x)
    xs, last = _token_shift(x, w.mix_kv, shift_last)
    h = torch.square(torch.relu(xs @ w.cm_k))
    return tp_out(h @ w.cm_v, w.cm_v.shape[0] < w.d_ff), last


def rwkv6_state_init(batch, d, dtype, device):
    H = d // HEAD_SIZE
    return (torch.zeros((batch, 1, d), dtype=dtype, device=device),       # token-shift tail
            torch.zeros((batch, H, HEAD_SIZE, HEAD_SIZE), dtype=torch.float32,
                        device=device))                                    # wkv state


class RWKV6(nn.Module):
    """Time- and channel-mix weights: w_r, w_k, w_v, w_g, w_o, w_decay (d, d),
    cm_k (d, d_ff), cm_v (d_ff, d) in the compute dtype; decay_base,
    bonus_u, mix_r, mix_kv (d,) in f32."""

    def __init__(self, d: int, d_ff: int, dtype, device):
        super().__init__()
        self.d, self.d_ff = d, d_ff
        for name in ("w_r", "w_k", "w_v", "w_g", "w_o", "w_decay"):
            setattr(self, name, _weight((d, d), dtype, device))
        for name in F32_LEAVES:
            setattr(self, name, _weight((d,), torch.float32, device))
        self.cm_k = _weight((d, d_ff), dtype, device)
        self.cm_v = _weight((d_ff, d), dtype, device)

    def init(self, generator):
        """``rwkv6_init``'s distributions."""
        d, d_ff = self.cm_k.shape
        s = 1.0 / math.sqrt(d)
        for name in ("w_r", "w_k", "w_v", "w_g", "w_o"):
            truncated_normal_(getattr(self, name), s, generator)
        truncated_normal_(self.w_decay, 0.1 * s, generator)
        self.decay_base.uniform_(0.0, 1.0, generator=generator).add_(-6.0)
        self.bonus_u.uniform_(0.0, 1.0, generator=generator).mul_(0.5)
        self.mix_r.uniform_(0.0, 1.0, generator=generator)
        self.mix_kv.uniform_(0.0, 1.0, generator=generator)
        truncated_normal_(self.cm_k, s, generator)
        truncated_normal_(self.cm_v, 1.0 / math.sqrt(d_ff), generator)
