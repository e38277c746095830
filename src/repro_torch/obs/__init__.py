"""Unified observability layer: metrics registry, op-lifecycle tracing,
SLO monitoring, and the durable flight recorder with its crash forensics
(numpy and plain Python; this package's own copy of ``repro.obs``).

``Observability`` is the per-frontend bundle the serving/persistence stack
threads through itself: one ``Registry`` (counters/gauges/histograms — the
substrate behind every ``stats()`` dict and ``BENCH_*.json`` histogram row),
one ``Tracer`` (enqueue→batch-form→dispatch→publish→flush→ack spans; off by
default, enabled explicitly or via ``REPRO_TRACE=1``), and one ``SloMonitor``
the frontend ticks alongside the scrubber.

``now()`` is the one clock helper every op timestamp goes through —
``enqueue_t``/``done_t`` stamping, span timing, and SLO window rotation all
share it, so sojourn histograms and bench percentiles are measuring the
same thing.
"""
from __future__ import annotations

import os
import time

from .registry import Counter, Gauge, Histogram, Registry
from .slo import SloMonitor, SloRule
from .trace import Span, Tracer, export_chrome_trace
from .blackbox import FlightRecorder, TELEMETRY_SLO_RULES, \
    telemetry_slo_extra

__all__ = ["Counter", "Gauge", "Histogram", "Registry", "SloMonitor",
           "SloRule", "Span", "Tracer", "export_chrome_trace",
           "FlightRecorder", "TELEMETRY_SLO_RULES", "telemetry_slo_extra",
           "Observability", "now", "trace_enabled_from_env"]

#: the single op-timestamp clock (satellite: sojourn-timing unification)
now = time.perf_counter


def trace_enabled_from_env() -> bool:
    return os.environ.get("REPRO_TRACE", "") not in ("", "0")


class Observability:
    """Registry + tracer + SLO monitor for one frontend (or shard).

    ``trace=None`` defers to ``REPRO_TRACE`` so benches and CI can turn
    span capture on without plumbing a flag through every constructor."""

    def __init__(self, trace=None, trace_capacity: int = 1 << 16,
                 slo_rules=(), slo_interval: int = 64):
        self.registry = Registry()
        if trace is None:
            trace = trace_enabled_from_env()
        self.tracer = Tracer(enabled=bool(trace), capacity=trace_capacity,
                             clock=now)
        # ring evictions surface as a counter (satellite: silent telemetry
        # loss is itself observable — pair with TELEMETRY_SLO_RULES)
        self.tracer.drop_counter = self.registry.scope("trace").counter(
            "dropped")
        self.slo = SloMonitor(self.registry, rules=slo_rules,
                              eval_interval=slo_interval, clock=now)
        self.clock = now

    def now(self) -> float:
        return self.clock()

    def snapshot(self) -> dict:
        """Registry snapshot + last SLO snapshot + tracer stats — the
        export surface for ``obs_snapshot()`` / bench artifacts."""
        return {"metrics": self.registry.snapshot(),
                "slo": self.slo.snapshot(),
                "trace": self.tracer.stats()}
