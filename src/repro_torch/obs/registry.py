"""Metrics registry: named counters, gauges, log-bucketed latency histograms.

The repo's measured claims (tail latency under split storms, O(dirty) publish
and flush volume, bounded scrub latency) all need the same three primitives,
and before this layer each component grew its own ad-hoc rendering — a dozen
disconnected ``stats()`` dicts and bare ``time.perf_counter`` deltas that
recorded only means. This module is the shared substrate:

``Counter``
    Monotonic count (ops completed, bytes published, health transitions).

``Gauge``
    Last-write-wins level (queue depth, epoch limbo depth, health state).

``Histogram``
    Log-bucketed distribution with cheap hot-path recording and
    p50/p90/p99/max extraction. Buckets are geometric — ``bpo`` buckets per
    octave (power of two), so the worst-case quantile error is the half-
    bucket ratio ``2**(1/(2*bpo)) - 1`` (±2.2% at the default 16/octave —
    comfortably inside the 10% agreement gate the online-resize bench
    asserts against its exact-sample percentiles). ``observe`` is a couple
    of float ops + one array increment; ``observe_many`` takes a vector
    through one ``np.bincount``. This is what turns bench artifacts from
    means into tail rows — the PM range-index evaluation's core lesson
    (PAPERS.md): tails, not means, distinguish designs under load.

``Registry``
    A flat namespace of the above (dotted names: ``frontend.read_sojourn_s``,
    ``wb.flush_bytes``). ``scope(prefix)`` gives a component its own
    namespace over the same store; ``ingest(stats_dict)`` absorbs the
    existing ``stats()`` surfaces (frontend publish/COW counters, writeback
    flush counters, scrubber, fault-plan counters) into gauges WITHOUT
    changing those dict APIs; ``merge`` sums registries — the DHT aggregates
    one registry per shard into a fleet view. ``snapshot()`` /
    ``histogram_rows()`` are the export surface benches stamp into
    ``BENCH_*.json``.

Everything here is plain host Python + numpy — recording never touches a
device or takes a lock (the frontends are cooperative single-thread
schedulers; cross-thread use should shard registries and ``merge``).
"""
from __future__ import annotations

import math
from typing import Dict, Iterable, Optional

import numpy as np

__all__ = ["Counter", "Gauge", "Histogram", "Registry"]

#: default histogram geometry: 16 buckets/octave from 0.1 us to ~7000 s —
#: wide enough for sojourn times, byte counts, and row counts alike
HIST_LO = 1e-7
HIST_OCTAVES = 36
HIST_BPO = 16


class Counter:
    """Monotonic counter. ``inc`` is the only mutator."""

    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value = 0

    def inc(self, n=1):
        self.value += n

    def merge(self, other: "Counter"):
        self.value += other.value


class Gauge:
    """Last-write-wins level."""

    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value = 0

    def set(self, v):
        self.value = v

    def merge(self, other: "Gauge"):
        self.value = other.value


class Histogram:
    """Log-bucketed distribution (see module docstring).

    Values below ``lo`` land in the underflow bucket (index 0 — reported as
    ``lo``); values above the range land in the top bucket. Exact min/max
    are tracked alongside, so ``percentile(100)`` is the true max and
    quantile extraction clamps into the observed [min, max] envelope (the
    clamp is what keeps single-bucket distributions exact)."""

    __slots__ = ("name", "lo", "bpo", "counts", "n", "total", "vmin", "vmax")

    def __init__(self, name: str, lo: float = HIST_LO,
                 octaves: int = HIST_OCTAVES, bpo: int = HIST_BPO):
        self.name = name
        self.lo = float(lo)
        self.bpo = int(bpo)
        self.counts = np.zeros(int(octaves) * self.bpo, np.int64)
        self.n = 0
        self.total = 0.0
        self.vmin = math.inf
        self.vmax = -math.inf

    # -- recording --------------------------------------------------------

    def _index(self, v: float) -> int:
        if v <= self.lo:
            return 0
        i = int(math.log2(v / self.lo) * self.bpo)
        return i if i < self.counts.size else self.counts.size - 1

    def observe(self, v: float):
        """Scalar hot path: two float ops + one increment."""
        v = float(v)
        self.counts[self._index(v)] += 1
        self.n += 1
        self.total += v
        if v < self.vmin:
            self.vmin = v
        if v > self.vmax:
            self.vmax = v

    def observe_many(self, vs):
        """Vectorized batch recording: one log2 + one bincount."""
        vs = np.asarray(vs, np.float64).reshape(-1)
        if vs.size == 0:
            return
        idx = np.zeros(vs.size, np.int64)
        pos = vs > self.lo
        idx[pos] = np.minimum(
            (np.log2(vs[pos] / self.lo) * self.bpo).astype(np.int64),
            self.counts.size - 1)
        self.counts += np.bincount(idx, minlength=self.counts.size)
        self.n += int(vs.size)
        self.total += float(vs.sum())
        self.vmin = min(self.vmin, float(vs.min()))
        self.vmax = max(self.vmax, float(vs.max()))

    # -- extraction -------------------------------------------------------

    def _bucket_value(self, i: int) -> float:
        # geometric midpoint of the bucket — halves the worst-case error
        return self.lo * 2.0 ** ((i + 0.5) / self.bpo)

    def percentile(self, q: float, counts: Optional[np.ndarray] = None,
                   ) -> float:
        """Value at percentile ``q`` (0..100) from the bucket counts
        (optionally a caller-supplied windowed copy). NaN when empty."""
        c = self.counts if counts is None else counts
        n = int(c.sum())
        if n == 0:
            return math.nan
        if q >= 100.0 and counts is None:
            return self.vmax
        rank = max(1, math.ceil(q / 100.0 * n))
        i = int(np.searchsorted(np.cumsum(c), rank))
        v = self._bucket_value(i)
        if counts is None and self.n == n:
            v = min(max(v, self.vmin), self.vmax)
        return v

    def snapshot(self, counts: Optional[np.ndarray] = None) -> dict:
        """The standard artifact row: count/sum/mean + p50/p90/p99/max."""
        c = self.counts if counts is None else counts
        n = int(c.sum())
        out = {"n": n,
               "sum": self.total if counts is None else math.nan,
               "mean": (self.total / self.n
                        if counts is None and self.n else math.nan),
               "p50": self.percentile(50, counts),
               "p90": self.percentile(90, counts),
               "p99": self.percentile(99, counts),
               "max": self.vmax if counts is None and self.n else
               self.percentile(100, counts)}
        return out

    def merge(self, other: "Histogram"):
        assert (self.lo == other.lo
                and self.counts.size == other.counts.size), \
            "merging histograms with different geometry"
        self.counts += other.counts
        self.n += other.n
        self.total += other.total
        self.vmin = min(self.vmin, other.vmin)
        self.vmax = max(self.vmax, other.vmax)


class _Scope:
    """Prefix view over a registry: ``scope.counter("x")`` is
    ``registry.counter("prefix.x")``."""

    __slots__ = ("_reg", "_prefix")

    def __init__(self, reg: "Registry", prefix: str):
        self._reg = reg
        self._prefix = prefix.rstrip(".") + "."

    def counter(self, name: str) -> Counter:
        return self._reg.counter(self._prefix + name)

    def gauge(self, name: str) -> Gauge:
        return self._reg.gauge(self._prefix + name)

    def histogram(self, name: str, **kw) -> Histogram:
        return self._reg.histogram(self._prefix + name, **kw)

    def ingest(self, stats: dict, counters: bool = False):
        self._reg.ingest(stats, prefix=self._prefix, counters=counters)


class Registry:
    """Flat get-or-create store of named metrics (see module docstring)."""

    def __init__(self):
        self._metrics: Dict[str, object] = {}

    def _get(self, name: str, cls):
        m = self._metrics.get(name)
        if m is None:
            m = cls(name)
            self._metrics[name] = m
        assert isinstance(m, cls), \
            f"metric {name!r} already registered as {type(m).__name__}"
        return m

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge)

    def histogram(self, name: str, **kw) -> Histogram:
        m = self._metrics.get(name)
        if m is None:
            m = Histogram(name, **kw)
            self._metrics[name] = m
        assert isinstance(m, Histogram)
        return m

    def scope(self, prefix: str) -> _Scope:
        return _Scope(self, prefix)

    def ingest(self, stats: dict, prefix: str = "", counters: bool = False):
        """Absorb an existing ``stats()`` dict: numeric values become
        gauges (the dicts are cumulative — last write wins is correct),
        bools become 0/1 gauges, everything else is skipped. The dict APIs
        stay authoritative; this mirrors them into the one namespace.

        ``counters=True`` lands the numbers in Counters instead (value
        overwritten, not added — a mirror, not an increment): the shape a
        per-shard mirror registry needs so ``aggregate`` SUMS the fleet
        (gauges would take the last shard's value)."""
        for k, v in stats.items():
            if isinstance(v, bool):
                self.gauge(prefix + k).set(int(v))
            elif isinstance(v, (int, float, np.integer, np.floating)):
                v = float(v) if isinstance(v, (float, np.floating)) else int(v)
                if counters:
                    self.counter(prefix + k).value = v
                else:
                    self.gauge(prefix + k).set(v)

    def merge(self, other: "Registry"):
        """Sum ``other`` into this registry (counters/histograms add,
        gauges take the other's value) — the per-shard aggregation path."""
        for name, m in other._metrics.items():
            self._get(name, type(m)).merge(m)
        return self

    @staticmethod
    def aggregate(regs: Iterable["Registry"]) -> "Registry":
        out = Registry()
        for r in regs:
            out.merge(r)
        return out

    # -- export -----------------------------------------------------------

    def names(self):
        return sorted(self._metrics)

    def get(self, name: str):
        return self._metrics.get(name)

    def snapshot(self) -> dict:
        """Flat dict of every metric: counters/gauges as values,
        histograms as their standard row."""
        out = {}
        for name in sorted(self._metrics):
            m = self._metrics[name]
            if isinstance(m, Histogram):
                out[name] = m.snapshot()
            else:
                out[name] = m.value
        return out

    def histogram_rows(self, prefix: str = "") -> dict:
        """Just the histograms (optionally filtered by name prefix) — the
        rows benches stamp into their JSON artifacts."""
        return {name: m.snapshot() for name, m in sorted(self._metrics.items())
                if isinstance(m, Histogram) and name.startswith(prefix)}
