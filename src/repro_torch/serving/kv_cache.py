"""Paged KV storage: a page pool per pattern position + gather-based
assembly — the port of ``repro.serving.kv_cache``.

For the attention kinds a page holds BLOCK tokens of roped K/V for every
layer of its pattern position: (n_blocks, G, BLOCK, hd), so the pool is
(num_pages, n_blocks, G, BLOCK, hd) per K and V, in the compute dtype on
the model's device. Assembling a request's ring cache from its page list is
one gather; the compute saved is the prefill of the cached prefix, which
the engine counts.

The recurrent kinds store state snapshots instead: ``rglru`` pages hold
``h`` (n_blocks, d_rnn) f32 and ``conv`` (n_blocks, W-1, d_rnn), ``rwkv``
pages ``shift_tm`` / ``shift_cm`` (n_blocks, 1, d) and ``wkv`` (n_blocks, H,
64, 64) f32. As in the reference, a request's final state goes into its
last page only (a per-block snapshot chain is not kept), and a hit gathers
that page's snapshot.
"""
from __future__ import annotations

import dataclasses
from typing import List

import torch

from repro_torch.core.layout import resolve_device
from repro_torch.models.transformer import ATTENTION_KINDS, ModelConfig, _block_state_init
from .prefix_cache import BLOCK


@dataclasses.dataclass
class PagePoolConfig:
    num_pages: int
    cfg: ModelConfig


def _page_shapes(cfg: ModelConfig, kind: str):
    """{leaf: (shape of one page, dtype)} of a pattern position's pool: BLOCK
    tokens of K/V for the attention kinds, one lane's decode state for the
    recurrent kinds, for every layer of the position."""
    L = cfg.n_blocks
    if kind in ATTENTION_KINDS:
        shape = (L, cfg.n_kv_heads, BLOCK, cfg.hd)
        return {"k": (shape, cfg.compute_dtype), "v": (shape, cfg.compute_dtype)}
    return {f: ((L,) + t.shape[1:], t.dtype)
            for f, t in _block_state_init(cfg, kind, 1, 0, "meta").items()}


class PagePool:
    """Device-resident page pool: ``storage[pi]`` holds, for pattern
    position ``pi``, one (num_pages, ...) tensor per leaf of its kind. On the
    card unless ``device`` names another."""

    def __init__(self, pc: PagePoolConfig, device=None):
        self.pc = pc
        device = resolve_device(device)
        self.storage = {
            pi: {f: torch.zeros((pc.num_pages,) + shape, dtype=dt, device=device)
                 for f, (shape, dt) in _page_shapes(pc.cfg, kind).items()}
            for pi, kind in enumerate(pc.cfg.pattern)}

    def store_request(self, pages: List[int], state_entry: dict, pi: int,
                      kind: str, batch_index: int, n_prompt: int):
        """Write a finished prefill's cache into pages (one request). For the
        attention kinds page j takes ring slots (j*BLOCK + t) % C, t < BLOCK,
        of every layer; pages are written in order, so a page listed twice
        keeps its last write. For the recurrent kinds the final state goes
        into the last page."""
        store = self.storage[pi]
        if kind in ATTENTION_KINDS:
            k = state_entry["k"][:, batch_index]          # (L, G, C, hd) ring
            v = state_entry["v"][:, batch_index]
            C = k.shape[2]
            t = torch.arange(BLOCK, device=k.device)
            for j, page in enumerate(pages):
                sl = (j * BLOCK + t) % C
                store["k"][page] = k[:, :, sl]
                store["v"][page] = v[:, :, sl]
        elif pages:
            for f, page_leaf in store.items():
                page_leaf[pages[-1]] = state_entry[f][:, batch_index]

    def gather_into_cache(self, pages: List[int], pi: int, kind: str,
                          state_entry: dict, batch_index: int):
        """Assemble the cached prefix into lane ``batch_index`` of a decode
        state entry (in place). Attention kinds: the pages' tokens, in page
        order, fill ring slots 0.. of every layer, as many as the ring
        holds. Recurrent kinds: the last page's snapshot."""
        if not pages:
            return state_entry
        store = self.storage[pi]
        if kind not in ATTENTION_KINDS:
            for f, page_leaf in store.items():
                state_entry[f][:, batch_index] = page_leaf[pages[-1]]
            return state_entry
        idx = torch.as_tensor(pages, device=store["k"].device)
        C = state_entry["k"].shape[3]
        for f in ("k", "v"):
            pk = store[f][idx]                               # (P, L, G, BLOCK, hd)
            P, L, G, _, hd = pk.shape
            flat = pk.permute(1, 2, 0, 3, 4).reshape(L, G, P * BLOCK, hd)
            n = min(flat.shape[2], C)
            state_entry[f][:, batch_index, :, :n] = flat[:, :, :n]
        return state_entry
