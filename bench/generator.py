"""The one traffic generator: YCSB keys, values and query batches, vectorised.

A frozen copy of the port's YCSB arithmetic (``repro_torch.workloads.ycsb``:
``zipfian_ranks``, ``expected_value``), rewritten over whole arrays so that
set-up makes every batch before the window opens and nothing in the window
waits on the generator. Keys are fresh, unique and uniform over 64 bits:
splitmix64 of a counter range that starts at a seeded base, a bijection, so
no sort is needed to make them distinct. The order of the loaded key array
doubles as YCSB's scrambled-zipfian hash: rank r reads ``keys[r]``.

Every stream is drawn from the run's ``--seed``; the same seed gives the same
arrays. A traffic mix is a JSON file of parameters in ``bench/traffic/``.
"""
from __future__ import annotations

import dataclasses

import numpy as np

#: stream ids under one seed (each gets its own child generator)
KEYS, WARMUP_KEYS, ZIPF, SAMPLE = range(4)

_M64 = np.uint64(0xFFFFFFFFFFFFFFFF)


def rng(seed: int, stream: int) -> np.random.Generator:
    """The generator of one stream of a run: any whole ``seed``, negative or
    wider than 64 bits included, maps to a distinct seed sequence."""
    return np.random.default_rng(
        np.random.SeedSequence(int(seed) % (1 << 64), spawn_key=(stream,)))


def splitmix64(x: np.ndarray) -> np.ndarray:
    """splitmix64's finaliser on uint64 words (wrapping arithmetic)."""
    z = np.asarray(x, dtype=np.uint64) + np.uint64(0x9E3779B97F4A7C15)
    z = (z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    z = (z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    return z ^ (z >> np.uint64(31))


def unique_keys(seed: int, n: int, stream: int = KEYS) -> np.ndarray:
    """``n`` distinct uniform 64-bit keys of one stream."""
    base = rng(seed, stream).integers(0, 1 << 64, dtype=np.uint64)
    with np.errstate(over="ignore"):
        return splitmix64(np.arange(n, dtype=np.uint64) + base)


def expected_value(keys: np.ndarray) -> np.ndarray:
    """The value a key is loaded with: YCSB's ``expected_value``, derived from
    the key so that a check needs no side table (never 0)."""
    k = np.asarray(keys, dtype=np.uint64)
    v = ((k ^ (k >> np.uint64(17))) & np.uint64(0x7FFFFFFF)).astype(np.uint32)
    v[v == 0] = 1
    return v


def zipfian_ranks(gen: np.random.Generator, n: int, size: int,
                  theta: float) -> np.ndarray:
    """Independent ranks in [0, n) with YCSB's zipfian weights
    p(r) ~ 1 / (r + 1) ** theta (exact inversion of the finite CDF). The
    uniform draws are inverted in sorted order, which reads the CDF in one
    pass, and the ranks shuffled after: the same distribution, ~3x faster
    than inverting them in draw order."""
    cdf = np.cumsum(1.0 / np.power(np.arange(1, n + 1, dtype=np.float64), theta))
    cdf /= cdf[-1]
    ranks = np.searchsorted(cdf, np.sort(gen.random(size))).clip(0, n - 1)
    gen.shuffle(ranks)
    return ranks


def batch_size(rule: dict, seg_capacity: int, start_segments: int, done: int) -> int:
    """Keys in the next load batch after ``done`` keys: ``per_segment`` keys
    for each segment that a table holding them at ``load_factor`` would
    have (never fewer than it started with), within [``min``, ``max``].
    A function of ``done`` alone, so every seed sends the same batches."""
    segments = max(start_segments, done / (rule["load_factor"] * seg_capacity))
    return int(min(max(rule["min"], rule["per_segment"] * segments), rule["max"]))


@dataclasses.dataclass
class Traffic:
    """Everything a run sends, made in set-up.

    ``keys``/``values``: the records, loaded by a read mix in set-up and
    inserted by a load mix in the window, in order. ``batches``: a read
    mix's distinct lookup batches, cycled through in the window.
    ``sample``: a read mix's draw in [0, 1) a window iteration, deciding
    which answers are kept for the check. ``warmup_keys``: keys of the
    throwaway warm-up tables."""
    keys: np.ndarray
    values: np.ndarray
    warmup_keys: np.ndarray
    batches: list = dataclasses.field(default_factory=list)
    sample: np.ndarray | None = None


def make(mix: dict, records: int, seed: int, warmup_keys: int = 0) -> Traffic:
    """The arrays of one run of ``mix`` over ``records`` records."""
    keys = unique_keys(seed, records)
    out = Traffic(keys=keys, values=expected_value(keys),
                  warmup_keys=unique_keys(seed, warmup_keys, WARMUP_KEYS))
    if mix["op"] == "search":
        ranks = zipfian_ranks(rng(seed, ZIPF), records,
                              mix["batch"] * mix["distinct_batches"], mix["zipf_theta"])
        out.batches = list(keys[ranks].reshape(mix["distinct_batches"], mix["batch"]))
        out.sample = rng(seed, SAMPLE).random(mix["sample_draws"])
    elif mix["op"] != "insert":
        raise ValueError(f"unknown op {mix['op']!r}")
    return out
