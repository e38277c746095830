"""Op-lifecycle tracing: causally-linked spans, ring-buffered, Chrome-trace
export.

A batch's journey — enqueue → batch-form → dispatch → publish → flush → ack —
was invisible before this module: each stage stamped its own
``perf_counter`` and threw the relationship away. A ``Tracer`` records that
journey as spans:

  * ``begin(name)`` / ``end(span)`` — an explicit span for work that crosses
    scheduler ticks (a write batch whose insert rounds interleave with SMO
    stages); the parent defaults to the innermost open ``span()`` context.
  * ``with tracer.span(name):`` — a scoped child span (probe, verify, one
    SMO stage, one flush phase).
  * ``instant(name)`` — a point event (redo-log commit, health transition,
    quarantine report), parented to the innermost open span.
  * ``link(span, *others)`` — extra causal edges beyond the tree: an ack
    span links back to its batch span AND the publish/flush spans that made
    its effects visible/durable.

Memory is bounded: closed spans land in a ring (``capacity`` entries, oldest
dropped first, drops counted) and open spans are only ever the live stack +
the handful of cross-tick spans the frontend holds. A disabled tracer
(``enabled=False``, the default for production serving) is a few ``None``
checks per call — the hot path stays cheap enough to leave call sites
unconditional.

``export_chrome_trace`` renders the ring as Chrome-trace JSON ("traceEvents"
with complete/instant/flow events) for drop-into-``chrome://tracing`` /
Perfetto inspection; span ids and causal links also ride in each event's
``args`` so tests (and scripts) can verify linkage without a trace viewer.
"""
from __future__ import annotations

import json
import time
from collections import deque
from contextlib import contextmanager
from typing import Optional

__all__ = ["Span", "Tracer", "export_chrome_trace"]


class Span:
    """One traced operation: half-open [t0, t1) plus causal edges."""

    __slots__ = ("sid", "parent", "name", "cat", "t0", "t1", "tid", "args",
                 "links")

    def __init__(self, sid: int, parent: Optional[int], name: str, cat: str,
                 t0: float, tid: int, args: Optional[dict]):
        self.sid = sid
        self.parent = parent
        self.name = name
        self.cat = cat
        self.t0 = t0
        self.t1 = t0
        self.tid = tid
        self.args = args or {}
        self.links = []


class Tracer:
    """Span recorder with a bounded ring of closed spans. Single-writer by
    design (the frontends are cooperative schedulers); concurrent producers
    should each own a tracer and merge exports."""

    def __init__(self, enabled: bool = True, capacity: int = 1 << 16,
                 clock=time.perf_counter):
        self.enabled = bool(enabled)
        self.capacity = int(capacity)
        self.clock = clock
        self._ring: deque = deque(maxlen=self.capacity)
        self._stack: list = []          # innermost open scoped spans
        self._next_sid = 1
        self.recorded = 0               # spans closed into the ring
        self.dropped = 0                # ring evictions (bounded memory)
        self.sink = None                # flight recorder (obs/blackbox.py):
        #                                 every closed span mirrors into it
        self.drop_counter = None        # registry counter: ring evictions
        #                                 surface as `trace.dropped` so
        #                                 silent telemetry loss is visible

    # -- recording --------------------------------------------------------

    def current(self) -> Optional[Span]:
        return self._stack[-1] if self._stack else None

    def begin(self, name: str, cat: str = "", parent=None, tid: int = 0,
              **args) -> Optional[Span]:
        """Open a span. ``parent`` is a Span, a span id, or None (inherit
        the innermost open scoped span). The span is NOT pushed on the
        scope stack — it may stay open across scheduler ticks; close it
        with ``end``. Returns None when disabled."""
        if not self.enabled:
            return None
        if parent is None:
            cur = self.current()
            parent = cur.sid if cur is not None else None
        elif isinstance(parent, Span):
            parent = parent.sid
        sp = Span(self._next_sid, parent, name, cat, self.clock(), tid, args)
        self._next_sid += 1
        return sp

    def end(self, sp: Optional[Span], **args):
        """Close a span into the ring (no-op on None — disabled tracer)."""
        if sp is None:
            return
        self._close(sp, self.clock(), args)

    def _close(self, sp: Span, t1: float, args: dict):
        sp.t1 = t1
        if args:
            sp.args.update(args)
        if len(self._ring) == self.capacity:
            self.dropped += 1
            if self.drop_counter is not None:
                self.drop_counter.inc()
        self._ring.append(sp)
        self.recorded += 1
        if self.sink is not None:
            self.sink.on_span(sp)

    @contextmanager
    def span(self, name: str, cat: str = "", parent=None, **args):
        """Scoped child span: pushed on the stack so nested spans/instants
        parent to it automatically. Yields the Span (None when disabled)."""
        sp = self.begin(name, cat, parent=parent, **args)
        if sp is not None:
            self._stack.append(sp)
        try:
            yield sp
        finally:
            if sp is not None:
                self._stack.pop()
            self.end(sp)

    def instant(self, name: str, cat: str = "", parent=None, **args
                ) -> Optional[Span]:
        """Zero-duration event (health transition, log commit, quarantine);
        parented like ``begin``. Closed at exactly ``t0`` so the export
        renders a true Chrome-trace instant (``ph: "i"``) — clock-stamping
        the close would leave a microscopic slice instead."""
        sp = self.begin(name, cat, parent=parent, **args)
        if sp is not None:
            self._close(sp, sp.t0, {})
        return sp

    @staticmethod
    def link(sp: Optional[Span], *others):
        """Add causal edges from ``sp`` back to ``others`` (Spans, ids, or
        None — Nones are skipped, so call sites stay unconditional)."""
        if sp is None:
            return
        for o in others:
            if o is None:
                continue
            sp.links.append(o.sid if isinstance(o, Span) else int(o))

    # -- export -----------------------------------------------------------

    def spans(self) -> list:
        return list(self._ring)

    def clear(self):
        self._ring.clear()

    def export_chrome_trace(self, path: Optional[str] = None,
                            pid: int = 0) -> dict:
        return export_chrome_trace(self, path, pid=pid)

    def stats(self) -> dict:
        return {"trace_enabled": self.enabled,
                "trace_recorded": self.recorded,
                "trace_buffered": len(self._ring),
                "trace_dropped": self.dropped,
                "trace_capacity": self.capacity}


def export_chrome_trace(tracer: Tracer, path: Optional[str] = None,
                        pid: int = 0) -> dict:
    """Render the tracer's ring as a Chrome-trace JSON object and (when
    ``path`` is given) write it.

    Event mapping: spans become complete events (``ph: "X"``, microsecond
    ``ts``/``dur``) carrying ``sid``/``parent``/``links`` in ``args``;
    zero-duration spans become instants (``ph: "i"``); every causal link
    additionally becomes a flow pair (``ph: "s"`` at the source span,
    ``ph: "f"`` at the linking span) so Perfetto draws the arrows. The
    object form ({"traceEvents": [...]}) is used so metadata rides along.

    Flow-pair integrity over the bounded ring: a link whose target was
    evicted (or never closed) has no slice to anchor the ``s`` end, and
    Perfetto renders a dangling broken arrow — those links are DROPPED
    from both the flow events and the exported ``args["links"]`` (the
    orphan end is never emitted), with the count surfaced per-span as
    ``args["links_evicted"]`` and globally in ``metadata["links_evicted"]``
    so the loss is observable rather than silent. A flow end anchored on a
    zero-duration span would dangle the same way (instants are not
    slices), so those pairs are skipped too (``metadata["flows_skipped"]``)
    while the link itself stays in ``args["links"]`` — both spans exist;
    only the arrow has nowhere to attach.
    """
    events = []
    spans = tracer.spans()
    have = {sp.sid for sp in spans}
    by_sid = {sp.sid: sp for sp in spans}
    flow_id = 0
    links_evicted = flows_skipped = 0
    for sp in spans:
        ts = sp.t0 * 1e6
        dur = max(sp.t1 - sp.t0, 0.0) * 1e6
        args = dict(sp.args)
        args["sid"] = sp.sid
        if sp.parent is not None:
            args["parent"] = sp.parent
        kept = [t for t in sp.links if t in have]
        if kept:
            args["links"] = kept
        if len(kept) < len(sp.links):
            args["links_evicted"] = len(sp.links) - len(kept)
            links_evicted += len(sp.links) - len(kept)
        ev = {"name": sp.name, "cat": sp.cat or "span", "pid": pid,
              "tid": sp.tid, "ts": ts, "args": args}
        if dur == 0.0:
            events.append({**ev, "ph": "i", "s": "t"})
        else:
            events.append({**ev, "ph": "X", "dur": dur})
        for target in kept:
            src = by_sid[target]
            if dur == 0.0 or src.t1 <= src.t0:
                flows_skipped += 1    # an arrow end on an instant dangles
                continue
            flow_id += 1
            events.append({"name": f"{src.name}->{sp.name}", "cat": "flow",
                           "ph": "s", "id": flow_id, "pid": pid,
                           "tid": src.tid, "ts": src.t1 * 1e6})
            events.append({"name": f"{src.name}->{sp.name}", "cat": "flow",
                           "ph": "f", "bp": "e", "id": flow_id, "pid": pid,
                           "tid": sp.tid, "ts": ts})
    out = {"traceEvents": events, "displayTimeUnit": "ms",
           "metadata": {"recorded": tracer.recorded,
                        "dropped": tracer.dropped,
                        "links_evicted": links_evicted,
                        "flows_skipped": flows_skipped}}
    if path is not None:
        with open(path, "w") as f:
            json.dump(out, f)
    return out
