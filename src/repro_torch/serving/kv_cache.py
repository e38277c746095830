"""Paged KV storage: a page pool per pattern position + gather-based
assembly — the port of ``repro.serving.kv_cache`` for the attention kinds.

A page holds BLOCK tokens of roped K/V for every layer of its pattern
position: (n_blocks, G, BLOCK, hd), so the pool is (num_pages, n_blocks, G,
BLOCK, hd) per K and V, in the compute dtype on the model's device.
Assembling a request's ring cache from its page list is one gather; the
compute saved is the prefill of the cached prefix, which the engine counts.
The recurrent kinds' state snapshots wait for ROADMAP entry 15b.
"""
from __future__ import annotations

import dataclasses
from typing import List

import torch

from repro_torch.core.layout import resolve_device
from repro_torch.models.transformer import ModelConfig
from .prefix_cache import BLOCK

ATTENTION_KINDS = ("dense", "local", "moe")


@dataclasses.dataclass
class PagePoolConfig:
    num_pages: int
    cfg: ModelConfig


def _check_kind(kind: str) -> None:
    if kind not in ATTENTION_KINDS:
        raise NotImplementedError(f"page pool for block kind {kind!r} is not ported "
                                  f"yet (ROADMAP Queue 1, entry 15b)")


class PagePool:
    """Device-resident page pool: ``storage[pi]`` holds ``k``/``v`` of shape
    (num_pages, n_blocks, G, BLOCK, hd) for pattern position ``pi``. On the
    card unless ``device`` names another."""

    def __init__(self, pc: PagePoolConfig, device=None):
        self.pc = pc
        cfg = pc.cfg
        device = resolve_device(device)
        self.storage = {}
        for pi, kind in enumerate(cfg.pattern):
            _check_kind(kind)
            shape = (pc.num_pages, cfg.n_blocks, cfg.n_kv_heads, BLOCK, cfg.hd)
            self.storage[pi] = {
                "k": torch.zeros(shape, dtype=cfg.compute_dtype, device=device),
                "v": torch.zeros(shape, dtype=cfg.compute_dtype, device=device)}

    def store_request(self, pages: List[int], state_entry: dict, pi: int,
                      kind: str, batch_index: int, n_prompt: int):
        """Write a finished prefill's cache into pages (one request): page j
        takes ring slots (j*BLOCK + t) % C, t < BLOCK, of every layer. Pages
        are written in order, so a page listed twice keeps its last write."""
        _check_kind(kind)
        k = state_entry["k"][:, batch_index]          # (L, G, C, hd) ring
        v = state_entry["v"][:, batch_index]
        C = k.shape[2]
        t = torch.arange(BLOCK, device=k.device)
        for j, page in enumerate(pages):
            sl = (j * BLOCK + t) % C
            self.storage[pi]["k"][page] = k[:, :, sl]
            self.storage[pi]["v"][page] = v[:, :, sl]

    def gather_into_cache(self, pages: List[int], pi: int, kind: str,
                          state_entry: dict, batch_index: int):
        """Assemble the cached prefix into lane ``batch_index`` of a decode
        state entry (in place): the pages' tokens, in page order, fill ring
        slots 0.. of every layer, as many as the ring holds."""
        if not pages:
            return state_entry
        _check_kind(kind)
        idx = torch.as_tensor(pages, device=self.storage[pi]["k"].device)
        C = state_entry["k"].shape[3]
        for f in ("k", "v"):
            pk = self.storage[pi][f][idx]                    # (P, L, G, BLOCK, hd)
            P, L, G, _, hd = pk.shape
            flat = pk.permute(1, 2, 0, 3, 4).reshape(L, G, P * BLOCK, hd)
            n = min(flat.shape[2], C)
            state_entry[f][:, batch_index, :, :n] = flat[:, :, :n]
        return state_entry
