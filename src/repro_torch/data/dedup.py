"""Dash-LH document dedup: the paper's insert-heavy workload as a real
pipeline stage (port of ``repro.data.dedup``). Key = 64-bit content hash of
the token stream; value = 0. `is_duplicate` = insert; EXISTS -> duplicate.
The table lives on the card unless ``device`` names another.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core import EXISTS, DashConfig, DashLH


def content_hash64(tokens: np.ndarray) -> int:
    """FNV-1a over token bytes, mixed once more for avalanche."""
    h = np.uint64(0xCBF29CE484222325)
    data = np.asarray(tokens, np.int32).tobytes()
    arr = np.frombuffer(data, np.uint8).astype(np.uint64)
    for chunk in np.array_split(arr, max(1, arr.size // 4096)):
        for b in chunk:
            h = (h ^ b) * np.uint64(0x100000001B3)
    return int(h)


def content_hash64_fast(tokens: np.ndarray) -> int:
    """Vectorized polynomial hash (used by default; exact choice orthogonal,
    as the paper notes for hash functions)."""
    t = np.asarray(tokens, np.int64) + 1
    powers = np.power(np.int64(1099511628211), np.arange(t.size) % 31,
                      dtype=np.int64)
    return int(np.uint64(np.sum(t * powers).astype(np.int64)) &
               np.uint64(0xFFFFFFFFFFFFFFFF))


class DedupFilter:
    def __init__(self, cfg: DashConfig = None, batch: int = 256, device=None):
        cfg = cfg or DashConfig(max_segments=512, dir_depth_max=14, num_stash=4)
        self.table = DashLH(cfg, device=device)
        self.batch = batch

    def is_duplicate(self, doc: np.ndarray) -> bool:
        key = content_hash64_fast(doc)
        st = self.table.insert(np.array([key], np.uint64),
                               np.array([0], np.uint32))
        return int(st[0]) == EXISTS

    @property
    def unique_docs(self) -> int:
        return self.table.n_items
