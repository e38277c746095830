"""Per-tick health snapshot + SLO monitor.

The frontend ticks this alongside the scrubber. Each evaluation assembles a
snapshot of the system's *recent* behavior — rolling read/write sojourn
percentiles, publish/flush byte rates, epoch limbo depth, health-state dwell
— and evaluates declarative ``SloRule``s against it, flagging violations
into the snapshot (and a cumulative counter) instead of raising: an SLO
breach is an observation, not an exception.

Rolling percentiles come from the same cumulative histograms the registry
already holds: the monitor snapshots each watched histogram's bucket counts
at window rotation and evaluates on the *diff* — recent ops only, no second
recording path, no extra hot-path cost. Rates are cumulative-counter diffs
over the rotation's wall-time. When a window saw no ops the previous full
window's result is served, so the snapshot never flaps to NaN between
batches.
"""
from __future__ import annotations

import math
import time
from typing import Dict, Optional

import numpy as np

from .registry import Counter, Histogram, Registry

__all__ = ["SloRule", "SloMonitor"]


class SloRule:
    """Declarative bound on one snapshot field.

    ``field`` is a dotted path into the snapshot ("read_sojourn.p99_s",
    "rates.flush_bytes_per_s", "limbo_depth"). A rule with ``max`` fires
    when the value exceeds it; with ``min`` when the value falls below.
    Missing/NaN fields never fire (no data is not a violation)."""

    __slots__ = ("name", "field", "max", "min")

    def __init__(self, name: str, field: str, max: Optional[float] = None,
                 min: Optional[float] = None):
        assert max is not None or min is not None, f"rule {name}: no bound"
        self.name = name
        self.field = field
        self.max = max
        self.min = min

    def check(self, snapshot: dict) -> Optional[dict]:
        v = snapshot
        for part in self.field.split("."):
            if not isinstance(v, dict) or part not in v:
                return None
            v = v[part]
        if not isinstance(v, (int, float)) or (isinstance(v, float)
                                               and math.isnan(v)):
            return None
        if self.max is not None and v > self.max:
            return {"rule": self.name, "field": self.field, "value": v,
                    "bound": self.max, "kind": "max"}
        if self.min is not None and v < self.min:
            return {"rule": self.name, "field": self.field, "value": v,
                    "bound": self.min, "kind": "min"}
        return None


class _Window:
    """Rotation state for one watched histogram: counts snapshot at the
    last rotation + the last non-empty windowed result."""

    __slots__ = ("hist", "base", "last")

    def __init__(self, hist: Histogram):
        self.hist = hist
        self.base = hist.counts.copy()
        self.last: dict = {}

    def rotate(self) -> dict:
        delta = self.hist.counts - self.base
        n = int(delta.sum())
        if n > 0:
            self.last = {"n": n,
                         "p50_s": self.hist.percentile(50, delta),
                         "p90_s": self.hist.percentile(90, delta),
                         "p99_s": self.hist.percentile(99, delta)}
            self.base = self.hist.counts.copy()
        return dict(self.last)


class _Rate:
    """Rotation state for one watched counter → per-second rate."""

    __slots__ = ("counter", "base", "last")

    def __init__(self, counter: Counter):
        self.counter = counter
        self.base = counter.value
        self.last = 0.0

    def rotate(self, dt: float) -> float:
        if dt > 0:
            self.last = (self.counter.value - self.base) / dt
            self.base = self.counter.value
        return self.last


class SloMonitor:
    """Ticked by the frontend; evaluates every ``eval_interval`` ticks.

    ``tick(extra)`` is O(1) between evaluations (a counter bump); an
    evaluation rotates the watched windows, assembles the snapshot, and
    runs the rules. ``extra`` carries per-tick facts the registry doesn't
    own (health string, limbo depth)."""

    def __init__(self, registry: Registry, rules=(), eval_interval: int = 64,
                 clock=time.perf_counter):
        self.registry = registry
        self.rules = list(rules)
        self.eval_interval = max(1, int(eval_interval))
        self.clock = clock
        self._windows: Dict[str, _Window] = {}
        self._rates: Dict[str, _Rate] = {}
        self._ticks = 0
        self._evals = 0
        self._last_eval_t = clock()
        self._snapshot: dict = {"tick": 0, "evals": 0, "violations": []}
        self.violation_count = 0
        # health dwell accounting: state -> cumulative seconds
        self._health = None
        self._health_since = clock()
        self._dwell: Dict[str, float] = {}

    # -- configuration ----------------------------------------------------

    def watch_histogram(self, alias: str, hist: Histogram):
        self._windows[alias] = _Window(hist)

    def watch_rate(self, alias: str, counter: Counter):
        self._rates[alias] = _Rate(counter)

    def add_rule(self, rule: SloRule):
        self.rules.append(rule)

    # -- ticking ----------------------------------------------------------

    def note_health(self, state: str, now: Optional[float] = None):
        """Called on every health transition (and lazily at eval) to keep
        per-state dwell-time accounting."""
        if now is None:
            now = self.clock()
        if self._health is not None:
            self._dwell[self._health] = (self._dwell.get(self._health, 0.0)
                                         + now - self._health_since)
        self._health = state
        self._health_since = now

    def tick(self, extra=None) -> Optional[dict]:
        """Cheap per-tick entry point (one counter bump between
        evaluations); returns the new snapshot on evaluation ticks, None
        otherwise. ``extra`` may be a dict or a zero-arg callable — a
        callable is only invoked on evaluation ticks, so the frontend's
        per-tick cost stays flat."""
        self._ticks += 1
        if self._ticks % self.eval_interval:
            return None
        return self.evaluate(extra() if callable(extra) else extra)

    def evaluate(self, extra: Optional[dict] = None) -> dict:
        now = self.clock()
        dt = now - self._last_eval_t
        self._last_eval_t = now
        self._evals += 1
        extra = extra or {}
        health = extra.get("health")
        if health is not None and health != self._health:
            self.note_health(health, now)
        elif health is None:
            health = self._health     # transitions noted out-of-band count too
        snap: dict = {"tick": self._ticks, "evals": self._evals,
                      "window_s": dt}
        if health is not None:
            snap["health"] = health
            snap["health_dwell_s"] = {
                **self._dwell,
                **({self._health: self._dwell.get(self._health, 0.0)
                    + now - self._health_since}
                   if self._health is not None else {})}
        for k, v in extra.items():
            if k != "health":
                snap[k] = v
        for alias, win in self._windows.items():
            snap[alias] = win.rotate()
        if self._rates:
            snap["rates"] = {alias: r.rotate(dt)
                             for alias, r in self._rates.items()}
        violations = []
        for rule in self.rules:
            hit = rule.check(snap)
            if hit is not None:
                violations.append(hit)
        snap["violations"] = violations
        self.violation_count += len(violations)
        snap["violation_count"] = self.violation_count
        self._snapshot = snap
        return snap

    def snapshot(self) -> dict:
        """Last evaluated snapshot (evaluates once if none yet)."""
        if self._evals == 0:
            return self.evaluate()
        return dict(self._snapshot)
