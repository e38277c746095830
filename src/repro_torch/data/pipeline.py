"""Deterministic synthetic data pipeline: sharded corpus -> packed batches.

Production shape: seeded per-shard document streams (so any host can
regenerate its shard deterministically — elastic resharding needs no data
movement), sequence packing to fixed seq_len, checkpointable cursor, and a
Dash-LH dedup stage (data/dedup.py) on document content hashes — the paper's
sustained-insert workload embedded in a real pipeline. numpy only: the port
keeps its own copy of ``repro.data.pipeline``.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, Optional

import numpy as np


@dataclasses.dataclass
class PipelineConfig:
    vocab_size: int
    seq_len: int
    batch_size: int              # per-host batch
    shard_id: int = 0
    num_shards: int = 1
    seed: int = 1234
    doc_len_min: int = 64
    doc_len_max: int = 2048
    dup_fraction: float = 0.0    # synthetic duplicate rate (dedup benchmark)


class SyntheticCorpus:
    """Seeded document stream; documents are reproducible by (shard, index)."""

    def __init__(self, cfg: PipelineConfig):
        self.cfg = cfg

    def doc(self, index: int) -> np.ndarray:
        cfg = self.cfg
        rng = np.random.default_rng(
            (cfg.seed, cfg.shard_id, index if cfg.dup_fraction == 0.0
             else self._dedup_index(index)))
        n = int(rng.integers(cfg.doc_len_min, cfg.doc_len_max))
        return rng.integers(1, cfg.vocab_size, n, dtype=np.int32)

    def _dedup_index(self, index: int) -> int:
        """With dup_fraction > 0, some indices alias earlier documents."""
        cfg = self.cfg
        h = np.random.default_rng((cfg.seed, 7, index)).random()
        if index > 10 and h < cfg.dup_fraction:
            return int(h * 10)   # alias to one of the first docs
        return index


class PackedBatcher:
    """Greedy sequence packing with EOS=0 separators; checkpointable."""

    def __init__(self, cfg: PipelineConfig, corpus: Optional[SyntheticCorpus] = None,
                 dedup=None):
        self.cfg = cfg
        self.corpus = corpus or SyntheticCorpus(cfg)
        self.dedup = dedup
        self.cursor = 0          # next document index
        self.buffer = np.zeros(0, np.int32)
        self.docs_seen = 0
        self.docs_skipped = 0

    def state_dict(self):
        return {"cursor": self.cursor, "buffer": self.buffer.copy(),
                "docs_seen": self.docs_seen, "docs_skipped": self.docs_skipped}

    def load_state_dict(self, s):
        self.cursor = int(s["cursor"])
        self.buffer = np.asarray(s["buffer"], np.int32).copy()
        self.docs_seen = int(s["docs_seen"])
        self.docs_skipped = int(s["docs_skipped"])

    def _fill(self, need: int):
        while self.buffer.size < need:
            doc = self.corpus.doc(self.cursor)
            self.cursor += 1
            self.docs_seen += 1
            if self.dedup is not None and self.dedup.is_duplicate(doc):
                self.docs_skipped += 1
                continue
            self.buffer = np.concatenate([self.buffer, doc, np.zeros(1, np.int32)])

    def next_batch(self) -> dict:
        cfg = self.cfg
        need = cfg.batch_size * (cfg.seq_len + 1)
        self._fill(need)
        flat = self.buffer[:need].reshape(cfg.batch_size, cfg.seq_len + 1)
        self.buffer = self.buffer[need:]
        return {"tokens": flat[:, :-1].copy(),
                "labels": flat[:, 1:].astype(np.int32).copy()}

    def __iter__(self) -> Iterator[dict]:
        while True:
            yield self.next_batch()
