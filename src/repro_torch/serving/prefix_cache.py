"""Dash-backed prefix cache: the paper's hash table as the serving-side
KV-page directory (vLLM-style prefix caching). Port of
``repro.serving.prefix_cache`` over the port's ``DashEH``.

Keying: token-block chain hashes. A prompt is chunked into BLOCK-token
blocks; block i's key is hash(chain_{i-1}, tokens_i) so a hit at block i
implies the whole prefix matches (content addressing, no tree walk). Each
key maps to a page id in the page pool. Lookups are *negative-search heavy*
(most prompts diverge quickly) — precisely the workload fingerprinting
accelerates (paper Sec. 4.2, Figs. 7/9), which is why Dash-EH is the right
index here. The table lives on the card unless ``device`` names another;
page ids, the free list and the LRU are host state, as in the reference.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np

from repro_torch.core import EXISTS, DashConfig, DashEH
from repro_torch.core.hashing import np_hash_pair

BLOCK = 16          # tokens per cache block


def _chain_hashes(tokens: np.ndarray) -> np.ndarray:
    """64-bit chained block hashes: h_i = mix(h_{i-1}, tokens[i*B:(i+1)*B])."""
    tokens = np.asarray(tokens, np.int64)
    n = tokens.size // BLOCK
    out = np.zeros(n, np.uint64)
    h = np.uint64(0x9E3779B97F4A7C15)
    for i in range(n):
        blk = tokens[i * BLOCK:(i + 1) * BLOCK]
        lo = np.uint32(np.bitwise_and(np.sum(blk * np.arange(1, BLOCK + 1)),
                                      0xFFFFFFFF))
        hi = np.uint32(np.bitwise_and(np.sum((blk + 13) ** 2), 0xFFFFFFFF))
        mixed = np_hash_pair(np.uint32(h >> np.uint64(32)) ^ hi,
                             np.uint32(h & np.uint64(0xFFFFFFFF)) ^ lo, 0xABCD)
        h = (np.uint64(mixed) << np.uint64(32)) | np.uint64(
            np_hash_pair(hi, lo, int(mixed)))
        out[i] = h
    return out


@dataclasses.dataclass
class PrefixCacheStats:
    lookups: int = 0
    hit_blocks: int = 0
    miss_blocks: int = 0
    insertions: int = 0
    evictions: int = 0

    @property
    def hit_rate(self) -> float:
        total = self.hit_blocks + self.miss_blocks
        return self.hit_blocks / total if total else 0.0


class DashPrefixCache:
    """token-block chain hash -> page id, with LRU eviction."""

    def __init__(self, num_pages: int, dash_cfg: Optional[DashConfig] = None,
                 device=None):
        self.table = DashEH(dash_cfg or DashConfig(
            max_segments=256, dir_depth_max=12, num_stash=4), device=device)
        self.num_pages = num_pages
        self.free: List[int] = list(range(num_pages))
        self.lru: dict[int, int] = {}          # page -> last-use tick
        self.page_owner: dict[int, int] = {}   # page -> key (for eviction)
        self.tick = 0
        self.stats = PrefixCacheStats()

    # -- lookup -----------------------------------------------------------

    def match_prefix(self, tokens: np.ndarray) -> Tuple[List[int], int]:
        """Longest cached prefix: returns (page_ids, n_cached_tokens)."""
        self.tick += 1
        self.stats.lookups += 1
        keys = _chain_hashes(tokens)
        if keys.size == 0:
            return [], 0
        found, vals = self.table.search(keys)
        pages = []
        for i in range(keys.size):
            if not found[i]:
                break
            pages.append(int(vals[i]))
            self.lru[int(vals[i])] = self.tick
        self.stats.hit_blocks += len(pages)
        self.stats.miss_blocks += keys.size - len(pages)
        return pages, len(pages) * BLOCK

    # -- admission ---------------------------------------------------------

    def admit(self, tokens: np.ndarray, first_new_block: int = 0) -> List[int]:
        """Insert pages for blocks [first_new_block:]; returns their page ids."""
        keys = _chain_hashes(tokens)[first_new_block:]
        out = []
        for k in np.asarray(keys):
            page = self._alloc_page()
            st = self.table.insert(np.array([k], np.uint64),
                                   np.array([page], np.uint32))
            if int(st[0]) == EXISTS:          # raced/duplicate: reuse existing
                self.free.append(page)
                _, v = self.table.search(np.array([k], np.uint64))
                page = int(v[0])
            else:
                self.stats.insertions += 1
                self.page_owner[page] = int(k)
            self.lru[page] = self.tick
            out.append(page)
        return out

    def _alloc_page(self) -> int:
        if self.free:
            return self.free.pop()
        # LRU eviction: delete the directory entry, recycle the page
        # (``min`` over the dict breaks ties by insertion order)
        victim = min(self.lru, key=self.lru.get)
        key = self.page_owner.pop(victim, None)
        if key is not None:
            self.table.delete(np.array([key], np.uint64))
        self.lru.pop(victim, None)
        self.stats.evictions += 1
        return victim

    @property
    def load_factor(self) -> float:
        return self.table.load_factor
