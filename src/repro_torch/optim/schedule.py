"""LR schedules (cosine with linear warmup) — the port of
``repro.optim.schedule``, computed in f32 tensors as the reference computes
it, so the learning rate of a step carries the reference's f32 rounding."""
from __future__ import annotations

import math

import torch


def cosine_warmup(step, *, peak_lr=3e-4, warmup=100, total=10_000, min_ratio=0.1):
    """The learning rate at ``step`` (an int tensor or int), an f32 0-d
    tensor on the step's device."""
    step = torch.as_tensor(step).float()
    warm = peak_lr * step / max(warmup, 1)
    t = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
    cos = peak_lr * (min_ratio + (1 - min_ratio) * 0.5 * (1 + torch.cos(math.pi * t)))
    return torch.where(step < warmup, warm, cos)
