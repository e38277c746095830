"""Durable flight recorder: observability that survives the crash.

Ported from ``repro.obs.blackbox``; a window this recorder writes decodes
in either package. The observability layer (trace ring, registry, SLO
windows) is volatile — it vanishes at exactly the moment it matters most. The
``FlightRecorder`` keeps a bounded in-memory ring of *encoded* entries
(recent trace spans with their causal links, health transitions,
quarantine/degraded instants, op/ack stamps, per-flush metric deltas
keyed by ``flush_seq``) and, on every durable flush, the writeback
persists a snapshot of that ring into the pool's blackbox region
(``core/layout.py:BlackboxLayout``) *before* the superblock commit:

  * the window for the flush that will commit ``seq`` goes to the slot
    the committed superblock does NOT reference, so a crash mid-flush
    cannot scribble the committed story;
  * the commit record carries ``(bb_slot, bb_nbytes, bb_crc)``, so the
    committed window is exactly as durable as the data it describes and
    never newer (the "entries ride the commit fence" discipline);
  * each window is additionally self-framed (magic | seq | length | CRC),
    so ``obs/forensics.py`` can recognize the OTHER slot as the torn
    flush's own uncommitted story when its embedded seq reads
    ``committed_seq + 1`` — that is where "ops acked-but-in-flight in the
    torn flush" come from.

Entries are newline-delimited compact JSON, encoded once at record time;
a snapshot is a byte join + one CRC, kept cheap on the flush path.

Ack/intent protocol (proven against ground truth by ``persist/chaos.py``):
a serving layer records ``record_ops(kind, keys, await_seq=flush_seq+1)``
when it applies a write batch. An op is acked once a commit with
``flush_seq >= await_seq`` lands; forensics reports as in-flight exactly
the ops whose ``await_seq`` exceeds the last committed ``flush_seq``.
"""
from __future__ import annotations

import json
import time
import zlib
from collections import deque
from typing import Optional

from .slo import SloRule

now = time.perf_counter       # the shared op clock (see obs/__init__.py)

#: window frame: magic(8) | seq(8, little) | payload_len(4) | crc32(4)
BB_MAGIC = b"DASHBB01"
BB_HDR = 24

#: ring-byte budget headroom reserved for the per-snapshot fresh parts
#: (window header, open spans, the flush's own metric-delta entry)
_FRESH_RESERVE = 4096

#: per-ops-entry key cap (a frontend batch is <= 256; chaos batches are 48)
_OPS_KEY_CAP = 512

#: declarative "silent telemetry loss is itself observable" rules
#: (satellite: wire ``telemetry_slo_extra`` into the monitor's extra feed,
#: e.g. ``DashFrontend`` does — then these fire on any drop/failed write)
TELEMETRY_SLO_RULES = (
    SloRule("trace-loss", "telemetry.trace_dropped", max=0),
    SloRule("blackbox-write-loss", "telemetry.blackbox_write_failures",
            max=0),
)


def frame_window(seq: int, payload: bytes) -> bytes:
    """Self-describing window frame (see module docstring)."""
    return (BB_MAGIC + int(seq).to_bytes(8, "little")
            + len(payload).to_bytes(4, "little")
            + zlib.crc32(payload).to_bytes(4, "little") + payload)


def decode_window(raw: bytes) -> Optional[dict]:
    """Decode one slot's frame; ``None`` on a missing/torn/corrupt window.
    Returns ``{"seq", "nbytes", "crc", "entries"}`` with entries parsed
    from the newline-delimited JSON payload (unparseable lines are
    surfaced as ``{"t": "garbled"}`` rather than dropped silently)."""
    if len(raw) < BB_HDR or raw[:8] != BB_MAGIC:
        return None
    seq = int.from_bytes(raw[8:16], "little")
    n = int.from_bytes(raw[16:20], "little")
    crc = int.from_bytes(raw[20:24], "little")
    if n < 0 or BB_HDR + n > len(raw):
        return None
    payload = raw[BB_HDR:BB_HDR + n]
    if zlib.crc32(payload) != crc:
        return None
    entries = []
    for line in payload.split(b"\n"):
        if not line:
            continue
        try:
            entries.append(json.loads(line))
        except ValueError:
            entries.append({"t": "garbled", "nbytes": len(line)})
    return {"seq": seq, "nbytes": n, "crc": crc, "entries": entries}


def _enc(d: dict) -> bytes:
    return json.dumps(d, separators=(",", ":")).encode() + b"\n"


def _span_entry(sp) -> dict:
    """Compact durable form of a closed span. Args are kept only when they
    are small scalars (seg ids, row counts — the forensic correlators);
    anything else would bloat the bounded window."""
    e = {"t": "span", "sid": sp.sid, "name": sp.name, "cat": sp.cat,
         "t0": sp.t0, "t1": sp.t1}
    if sp.parent:
        e["par"] = sp.parent
    if sp.tid:
        e["tid"] = sp.tid
    if sp.links:
        e["links"] = list(sp.links)
    args = {k: v for k, v in sp.args.items()
            if isinstance(v, (int, float, bool, str)) and
            (not isinstance(v, str) or len(v) <= 64)}
    if args:
        e["args"] = args
    return e


class FlightRecorder:
    """Bounded ring of encoded observability entries + the snapshot the
    writeback persists each flush. One recorder per pool; attach via
    ``WritebackEngine.attach_recorder``."""

    def __init__(self, capacity_bytes: Optional[int] = None, clock=now,
                 wall=time.time):
        from repro_torch.core import layout
        cap = (layout.BLACKBOX_BYTES // 2 if capacity_bytes is None
               else int(capacity_bytes)) - BB_HDR
        assert cap > _FRESH_RESERVE, "blackbox capacity too small"
        self.capacity = cap
        self._ring_budget = cap - _FRESH_RESERVE
        self._clock = clock
        self._wall = wall                   # window headers' wall clock
        self._entries: deque = deque()      # already-encoded bytes
        self._bytes = 0
        self._open: dict = {}               # sid -> open-span stub dict
        self.tracer = None
        self.registry = None
        self._metric_prev: dict = {}
        # plain counters (mirrored into the registry when attached —
        # satellite: silent telemetry loss is itself observable)
        self.recorded = 0
        self.evicted = 0
        self.write_failures = 0
        self.windows_written = 0

    # -- wiring ------------------------------------------------------------

    def attach(self, tracer=None, registry=None):
        """Bind the volatile obs layer: closed spans mirror in via the
        tracer's sink hook; the registry feeds per-flush counter deltas
        and receives the recorder's own loss counters."""
        if tracer is not None:
            self.tracer = tracer
            tracer.sink = self
        if registry is not None:
            self.registry = registry
            sc = registry.scope("blackbox")
            self._c_recorded = sc.counter("recorded")
            self._c_evicted = sc.counter("evicted")
            self._c_write_failures = sc.counter("write_failures")
        return self

    # -- recording ---------------------------------------------------------

    def _append(self, entry: dict):
        entry.setdefault("ts", self._clock())
        enc = _enc(entry)
        self._entries.append(enc)
        self._bytes += len(enc)
        self.recorded += 1
        if self.registry is not None:
            self._c_recorded.inc()
        while self._bytes > self._ring_budget:
            self._bytes -= len(self._entries.popleft())
            self.evicted += 1
            if self.registry is not None:
                self._c_evicted.inc()

    def record(self, etype: str, **fields):
        """Generic durable instant (quarantine, degraded, recovery...)."""
        fields["t"] = etype
        self._append(fields)

    def record_health(self, frm: str, to: str):
        self._append({"t": "health", "frm": frm, "to": to})

    def record_ops(self, kind, keys, await_seq: int, **extra):
        """Write-batch intent stamp: these ops are acked by the first
        commit with ``flush_seq >= await_seq``; until then they are
        in-flight and a torn flush's window is their only evidence.
        ``kind`` is the frontend's op-kind token (str or int)."""
        keys = [int(k) for k in keys]
        e = {"t": "ops", "kind": kind if isinstance(kind, str)
             else int(kind), "n": len(keys),
             "await_seq": int(await_seq), "keys": keys[:_OPS_KEY_CAP]}
        if len(keys) > _OPS_KEY_CAP:
            e["truncated"] = len(keys) - _OPS_KEY_CAP
        e.update(extra)
        self._append(e)

    def record_ack(self, seq: int, kind, n: int, durable: bool = True):
        self._append({"t": "ack", "seq": int(seq),
                      "kind": kind if isinstance(kind, str) else int(kind),
                      "n": int(n), "durable": bool(durable)})

    # tracer sink: every closed span mirrors into the durable ring (health
    # transitions arrive via record_health instead — skip the volatile twin)
    def on_span(self, sp):
        if sp.cat == "health":
            return
        self._open.pop(sp.sid, None)
        self._append(_span_entry(sp))

    def note_open(self, sp):
        """Register a long-lived span (cross-tick batch/SMO spans) so a
        snapshot lists it as open even though it is not on the tracer's
        context stack."""
        if sp is not None:
            self._open[sp.sid] = {"t": "open", "sid": sp.sid,
                                  "name": sp.name, "cat": sp.cat,
                                  "t0": sp.t0, "par": sp.parent,
                                  "tid": sp.tid}

    def forget_open(self, sp):
        if sp is not None:
            self._open.pop(sp.sid, None)

    # -- the per-flush snapshot --------------------------------------------

    def _metric_delta(self) -> dict:
        """Changed-counter deltas since the previous snapshot (counters
        only: gauges are point-in-time, histograms too wide for the
        bounded window)."""
        from .registry import Counter
        if self.registry is None:
            return {}
        out = {}
        for name in self.registry.names():
            m = self.registry.get(name)
            if not isinstance(m, Counter):
                continue
            d = m.value - self._metric_prev.get(name, 0)
            if d:
                out[name] = d
                self._metric_prev[name] = m.value
        return out

    def snapshot(self, flush_seq: int) -> bytes:
        """The window payload for the flush that will commit ``flush_seq``:
        window header (wall + monotonic clocks, so forensics can align
        pre-crash and post-restart timelines) | this flush's metric-delta
        entry (keyed by ``flush_seq``, kept in the ring so recent history
        survives too) | spans currently open | the entry ring, newest kept
        when over budget. Called by the writeback just before the
        pre-commit fence — keep it cheap (encode-once ring + byte join)."""
        delta = self._metric_delta()
        if delta:
            self._append({"t": "metrics", "seq": int(flush_seq), "d": delta})
        fresh = [_enc({"t": "window", "seq": int(flush_seq),
                       "wall": self._wall(), "mono": self._clock(),
                       "recorded": self.recorded, "evicted": self.evicted})]
        open_spans = list(self._open.values())
        if self.tracer is not None:
            have = set(self._open)
            open_spans += [{"t": "open", "sid": s.sid, "name": s.name,
                            "cat": s.cat, "t0": s.t0, "par": s.parent,
                            "tid": s.tid}
                           for s in self.tracer._stack if s.sid not in have]
        fresh += [_enc(e) for e in open_spans]
        budget = self.capacity - sum(len(f) for f in fresh)
        if self._bytes <= budget:
            body = list(self._entries)
        else:                     # keep the newest entries that fit
            body, used = [], 0
            for enc in reversed(self._entries):
                if used + len(enc) > budget:
                    break
                body.append(enc)
                used += len(enc)
            body.reverse()
        self.windows_written += 1
        return b"".join(fresh + body)

    def note_write_failure(self):
        self.write_failures += 1
        if self.registry is not None:
            self._c_write_failures.inc()

    def stats(self) -> dict:
        return {"recorded": self.recorded, "evicted": self.evicted,
                "write_failures": self.write_failures,
                "windows_written": self.windows_written,
                "buffered_bytes": self._bytes,
                "open_spans": len(self._open)}


def telemetry_slo_extra(tracer=None, recorder=None) -> dict:
    """The ``telemetry`` section ``TELEMETRY_SLO_RULES`` evaluates against
    — feed it through the SLO monitor's ``extra`` (see ``DashFrontend``)."""
    return {"telemetry": {
        "trace_dropped": 0 if tracer is None else tracer.dropped,
        "blackbox_write_failures":
            0 if recorder is None else recorder.write_failures,
    }}
