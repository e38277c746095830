"""YCSB-style workload generator for the Dash serving frontend (numpy
only; this package's own copy of ``repro.workloads.ycsb``, producing the
port's ``serving.frontend.Op``).

The paper evaluates Dash under the standard mixed key-value workloads
(Sec. 6, Fig. 7/8/12/13); this module generates the same op mixes as
streams of ``serving.frontend.Op`` so the concurrent frontend — and the
stop-the-world baseline — can be driven end-to-end.

Mix -> paper-figure mapping (what each one stresses):

  =====  ======================  =====================================
  mix    op ratio                paper analog
  =====  ======================  =====================================
  A      50% read / 50% update   Fig. 8 "mixed" scalability runs: the
                                 update-heavy contention case (bucket
                                 version churn -> verify-retry rate)
  B      95% read / 5% update    Fig. 13 optimistic-read regime: reads
                                 dominate, writes still bump versions
  C      100% read               Fig. 7/9 pure probe throughput — the
                                 fingerprint read path alone
  D      95% read / 5% insert,   Fig. 12 load-factor growth: fresh keys
         reads skew to latest    drive fills (and eventually splits)
  E      95% multi-get(scan      range workload; Dash has no ordered
         analog) / 5% insert     scan, so E sends short multi-key
                                 lookup bursts (documented deviation)
  F      50% read / 50% RMW      Alg. 1 insert/update path under
                                 read-modify-write dependencies
  load   100% insert             Fig. 12 fill / split-storm source —
                                 the online-resize benchmark's storm
  =====  ======================  =====================================

Key selection: ``uniform`` or ``zipfian`` (independent-draw approximation
of the YCSB scrambled-zipfian, theta=0.99 by default) over the loaded key
space; workload D draws read keys from the most recently inserted window
("latest" distribution).
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, List, Optional

import numpy as np

from repro_torch.serving.frontend import DELETE, INSERT, READ, RMW, UPDATE, Op

#: kind ratios per mix: (read, update, insert, rmw)
MIXES = {
    "A": {READ: 0.5, UPDATE: 0.5},
    "B": {READ: 0.95, UPDATE: 0.05},
    "C": {READ: 1.0},
    "D": {READ: 0.95, INSERT: 0.05},
    "E": {READ: 0.95, INSERT: 0.05},     # multi-get bursts, see generate()
    "F": {READ: 0.5, RMW: 0.5},
    "load": {INSERT: 1.0},
}

#: YCSB-E scan-analog burst length (keys per multi-get)
SCAN_LEN = 8


@dataclasses.dataclass
class YCSBConfig:
    mix: str = "A"
    n_ops: int = 4096
    distribution: str = "zipfian"      # "uniform" | "zipfian" | "latest"
    zipf_theta: float = 0.99
    seed: int = 0


def zipfian_ranks(rng: np.random.Generator, n: int, size: int,
                  theta: float = 0.99) -> np.ndarray:
    """Independent draws of ranks in [0, n) with the YCSB zipfian weights
    p(r) ~ 1/(r+1)^theta (exact CDF inversion over the finite key space;
    YCSB's scrambled-zipfian then hashes ranks over the space — callers
    index an already-shuffled key array, which is the same scrambling)."""
    if n <= 0:
        return np.zeros(size, dtype=np.int64)
    w = 1.0 / np.power(np.arange(1, n + 1), theta)
    cdf = np.cumsum(w)
    cdf /= cdf[-1]
    return np.searchsorted(cdf, rng.random(size)).clip(0, n - 1)


def load_keys(rng: np.random.Generator, n: int) -> np.ndarray:
    """A shuffled unique key space (shuffling doubles as the scrambled-
    zipfian hash: rank r -> a pseudo-random key)."""
    out = np.unique(rng.integers(1, 2 ** 63, size=int(n * 2.2) + 16,
                                 dtype=np.uint64))
    assert out.size >= n
    keys = out[:n]
    rng.shuffle(keys)
    return keys


def generate(cfg: YCSBConfig, loaded_keys: np.ndarray,
             insert_keys: Optional[np.ndarray] = None) -> List[Op]:
    """Materialize ``cfg.n_ops`` frontend Ops (E's scan bursts count
    toward the budget, so op streams are size-comparable across mixes;
    fewer only if the insert budget and loaded space are both exhausted).

    ``loaded_keys`` is the pre-loaded key space reads/updates draw from
    (may be empty for the pure-insert ``load`` mix); ``insert_keys``
    supplies fresh keys for insert-bearing mixes (D/E/load) in order.
    Workload D reads skew half to the latest inserted window (its YCSB
    definition); ``distribution="latest"`` applies that skew to every
    read. E's "scans" are SCAN_LEN consecutive multi-get reads. Values
    are derived from the key so correctness checks need no side table
    (``expected_value``)."""
    if cfg.mix not in MIXES:
        raise ValueError(f"unknown mix {cfg.mix!r} (have {sorted(MIXES)})")
    rng = np.random.default_rng(cfg.seed)
    ratios = MIXES[cfg.mix]
    kinds = list(ratios)
    probs = np.asarray([ratios[k] for k in kinds])
    draws = rng.choice(len(kinds), size=cfg.n_ops, p=probs / probs.sum())

    n = loaded_keys.size
    if cfg.distribution == "zipfian":
        ranks = zipfian_ranks(rng, n, cfg.n_ops, cfg.zipf_theta)
    else:
        ranks = rng.integers(0, n, cfg.n_ops) if n else np.zeros(
            cfg.n_ops, dtype=np.int64)

    needs_inserts = any(k == INSERT for k in kinds)
    if needs_inserts:
        assert insert_keys is not None, f"mix {cfg.mix} needs insert_keys"
    inserted: List[int] = []
    next_insert = 0
    ops: List[Op] = []
    for i, d in enumerate(draws):
        if len(ops) >= cfg.n_ops:
            break
        kind = kinds[d]
        if kind == INSERT:
            if next_insert >= len(insert_keys):
                kind = READ               # key budget spent: degrade to read
                if n == 0:
                    break                 # nothing loaded to read either
            else:
                key = int(insert_keys[next_insert])
                next_insert += 1
                inserted.append(key)
                ops.append(Op(INSERT, key, expected_value(key)))
                continue
        latest = inserted and (cfg.distribution == "latest"
                               or (cfg.mix == "D" and rng.random() < 0.5))
        if kind == READ and latest:
            # "latest" distribution: reads chase the insert front
            key = inserted[-1 - int(rng.integers(0, min(64, len(inserted))))]
            ops.append(Op(READ, key))
            continue
        if kind == READ and cfg.mix == "E":
            # scan analog: a burst of consecutive keys from the loaded space
            start = int(ranks[i])
            for j in range(min(SCAN_LEN, cfg.n_ops - len(ops))):
                ops.append(Op(READ, int(loaded_keys[(start + j) % n])))
            continue
        key = int(loaded_keys[ranks[i]])
        if kind == READ:
            ops.append(Op(READ, key))
        elif kind == UPDATE:
            ops.append(Op(UPDATE, key, updated_value(key)))
        elif kind == RMW:
            ops.append(Op(RMW, key, updated_value(key)))
        else:                              # pragma: no cover - DELETE unused
            ops.append(Op(DELETE, key))
    return ops


def expected_value(key: int) -> int:
    """Load-phase value for a key (derived, so checks need no side table)."""
    return (key ^ (key >> 17)) & 0x7FFFFFFF or 1


def updated_value(key: int) -> int:
    return (expected_value(key) + 0x9E37) & 0x7FFFFFFF or 1
