"""RG-LRU recurrent block (Griffin / RecurrentGemma, arXiv:2402.19427) — the
port of ``repro.models.rglru``.

The recurrence h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t) is a
first-order linear recurrence over (a, b) pairs. The reference runs
``jax.lax.associative_scan``; here a log-depth doubling scan in f32 (about
log2(S) steps of elementwise products over the whole sequence) computes
the same prefix, so prefill is O(S log S) elementwise work and no Python
step per token.

Block = [conv1d(width 4) -> RG-LRU] on the recurrent branch, gated by a GeLU
branch (the tanh approximation: ``jax.nn.gelu``'s default). Decode carries
(h, conv_tail) per layer: h in f32, the conv tail in the compute dtype.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.parallel.collectives import all_gather, tp_group, tp_in, tp_out, tp_slice
from .layers import _weight, truncated_normal_

C_CONST = 8.0   # Griffin's recurrence sharpness constant


def _causal_conv(w, x, tail=None):
    """Width-W causal depthwise conv. x: (B, S, d); w: (W, d) in x's dtype;
    tail: (B, W-1, d). The taps add in x's dtype in the order
    ((t0 + t1) + t2) + ..., each product rounded first (the reference's
    ``sum``). Returns (out, the new tail)."""
    W = w.shape[0]
    if tail is None:
        tail = x.new_zeros((x.shape[0], W - 1, x.shape[2]))
    xp = torch.cat([tail, x], dim=1)
    S = x.shape[1]
    out = xp[:, 0:S] * w[0]
    for i in range(1, W):
        out = out + xp[:, i:i + S] * w[i]
    return out, xp[:, -(W - 1):]


def _linear_scan(a, b):
    """h_t = a_t * h_{t-1} + b_t from h_{-1} = 0 along axis 1, by doubling:
    after the step with offset k each (a, b) holds the composition of the
    last 2k steps. f32 in, f32 out."""
    S = a.shape[1]
    k = 1
    while k < S:
        b = torch.cat([b[:, :k], a[:, k:] * b[:, :-k] + b[:, k:]], dim=1)
        a = torch.cat([a[:, :k], a[:, k:] * a[:, :-k]], dim=1)
        k *= 2
    return b


def _rg_lru_scan(w, u, h0=None):
    """u: (B, S, d_rnn) post-conv activations; ``w`` holds ``w_rg``,
    ``w_ig`` (compute dtype) and ``lam`` (f32). Returns (y in u's dtype,
    h_last f32). Under tensor parallelism ``u`` and ``lam`` are this rank's
    ``rnn`` channels and the gates' weights whole: the gates read every
    channel (``u`` all-gathered over 'model') and make this rank's."""
    rg, ig = w.w_rg, w.w_ig
    n = u.shape[-1]
    if rg.shape[1] != n:
        c0 = tp_slice(rg.shape[1], n)
        rg, ig = rg[:, c0:c0 + n], ig[:, c0:c0 + n]
        u_all = all_gather(u, tp_group(), u.dim() - 1)
    else:
        u_all = u
    r = torch.sigmoid((u_all @ rg).float())
    i = torch.sigmoid((u_all @ ig).float())
    log_a0 = F.logsigmoid(w.lam.float())                            # (d,)
    log_a = C_CONST * r * log_a0
    a = torch.exp(log_a)
    b = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12)) * (i * u.float())
    if h0 is not None:
        b = torch.cat([b[:, :1] + a[:, :1] * h0.float()[:, None], b[:, 1:]], dim=1)
    h = _linear_scan(a, b)
    return h.to(u.dtype), h[:, -1]


def rglru_train(w, x, return_state: bool = False):
    """Full block over a sequence: (B, S, d) -> (B, S, d); with
    ``return_state`` also (h_last f32, conv tail). Under tensor parallelism
    on the whole sequence (``tp_in``) and this rank's ``rnn`` channels, the
    output a partial sum over 'model'."""
    x = tp_in(x)
    gate = F.gelu(x @ w.w_gate, approximate="tanh")
    u = x @ w.w_x
    u, tail = _causal_conv(w.conv_w, u)
    h, h_last = _rg_lru_scan(w, u)
    out = tp_out((h * gate) @ w.w_out, w.w_out.shape[0] < w.d_rnn)
    if return_state:
        return out, (h_last, tail)
    return out


def rglru_decode(w, x, h_prev, conv_tail):
    """One-step decode. x: (B, 1, d); h_prev: (B, d_rnn) f32; conv_tail:
    (B, W-1, d_rnn). Returns (out, h, conv_tail)."""
    gate = F.gelu(x @ w.w_gate, approximate="tanh")
    u = x @ w.w_x
    u, new_tail = _causal_conv(w.conv_w, u, conv_tail)
    h_seq, h_last = _rg_lru_scan(w, u, h0=h_prev)
    out = (h_seq * gate) @ w.w_out
    return out, h_last, new_tail


def rglru_state_init(batch, d_rnn, conv_width, dtype, device):
    return (torch.zeros((batch, d_rnn), dtype=torch.float32, device=device),
            torch.zeros((batch, conv_width - 1, d_rnn), dtype=dtype, device=device))


class RGLRU(nn.Module):
    """The block's weights: w_x, w_gate (d, d_rnn), w_out (d_rnn, d), conv_w
    (W, d_rnn), w_rg, w_ig (d_rnn, d_rnn) in the compute dtype; lam (d_rnn,)
    in f32, as the reference uses it."""

    def __init__(self, d: int, d_rnn: int, conv_width: int, dtype, device):
        super().__init__()
        self.d_rnn = d_rnn
        self.w_x = _weight((d, d_rnn), dtype, device)
        self.w_gate = _weight((d, d_rnn), dtype, device)
        self.w_out = _weight((d_rnn, d), dtype, device)
        self.conv_w = _weight((conv_width, d_rnn), dtype, device)
        self.w_rg = _weight((d_rnn, d_rnn), dtype, device)
        self.w_ig = _weight((d_rnn, d_rnn), dtype, device)
        self.lam = _weight((d_rnn,), torch.float32, device)

    def init(self, generator):
        """``rglru_init``'s distributions: truncated normals at its scales,
        lam = 0.65 + 0.2 * U[0, 1)."""
        d, d_rnn = self.w_x.shape
        truncated_normal_(self.w_x, 1.0 / math.sqrt(d), generator)
        truncated_normal_(self.w_gate, 1.0 / math.sqrt(d), generator)
        truncated_normal_(self.w_out, 1.0 / math.sqrt(d_rnn), generator)
        truncated_normal_(self.conv_w, 1.0 / math.sqrt(self.conv_w.shape[0]), generator)
        truncated_normal_(self.w_rg, 1.0 / math.sqrt(d_rnn), generator)
        truncated_normal_(self.w_ig, 1.0 / math.sqrt(d_rnn), generator)
        self.lam.uniform_(0.0, 1.0, generator=generator).mul_(0.2).add_(0.65)

    def forward(self, x, return_state: bool = False):
        return rglru_train(self, x, return_state)

    def decode(self, x, h_prev, conv_tail):
        return rglru_decode(self, x, h_prev, conv_tail)
