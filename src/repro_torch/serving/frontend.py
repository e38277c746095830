"""Online-resize serving frontend: epoch-guarded concurrent Dash table.

Ported from ``repro.serving.frontend``; ticks, batches, SMO stages and
publishes follow the reference one for one, so the same op stream gives
the same per-op outcomes and the same final table.

The stop-the-world path (``DashTable.insert``) holds every queued operation
hostage while a split storm runs: the host retry loop splits, retries, and
only then admits the next batch. This frontend serves reads and writes
*while* bulk SMOs run — the system-level rendering of the paper's claim that
readers are lock-free against structural modifications (Sec. 4.4, Fig. 13):

  * **Epoch-pinned snapshot reads.** Read batches acquire the newest
    published table version under an epoch pin (``core/epoch.py:
    SnapshotRegistry``) and probe it through the default fingerprint read
    path. A verify pass (``serving/engine.py:buckets_changed``) compares the
    snapshot's bucket version planes against the live state; only queries
    whose buckets changed are retried on the live version — the
    snapshot-verify-retry contract. Every result is therefore either
    pre-SMO-consistent or post-SMO-consistent; a torn read is impossible
    because both probes run against immutable functional versions.
  * **O(dirty) copy-on-write publish.** Installing a new version costs
    bytes proportional to what the write batch actually touched, not to the
    table size: ``SnapshotRegistry.publish_cow`` scatters exactly the
    version-changed bucket rows into the previous version's buffers
    (in place when unpinned) and aliases every untouched plane —
    the directory after a non-SMO batch, the overflow metadata after an
    update burst, whole record planes after a metadata-only tick.
    Reclamation is plane-level (refcounted ``PlanePool``): retiring v_n
    never frees a plane v_n+1 still aliases. ``stats()`` exposes
    ``publish_bytes`` / ``planes_copied`` / ``planes_aliased`` /
    ``reclaimed`` for the publish-volume checks.
  * **Deferred background SMOs.** A write batch that reports pressure does
    NOT split inline: the frontend plans a staged bulk-split task
    (``core/smo.py:BulkSplitTask`` / ``BulkSplitNextTask``) and pumps ONE
    stage per scheduler tick. Read batches admitted between stages keep
    serving the pinned snapshot (whose planes no split stage writes); the
    split publishes into the *next* directory version, which readers adopt
    through verify-retry after the commit stage publishes a fresh snapshot.
  * **Admission pipeline.** A bounded admission queue feeds two lanes
    (reads / writes); a batch former pulls maximal same-kind runs from the
    lane head. Reads may overtake a write stalled behind a resize — that is
    the point: FIFO holds within a lane, freshness across lanes is governed
    by the verify pass (acknowledged writes are always visible; in-flight
    writes surface once acknowledged).

Epoch lifecycle per write batch::

    publish(v_n) ──► reads pin v_n ──► write batch mutates live (in place)
         ▲                                    │ pressure?
         │                                    ▼
    commit stage ◄─ phase2 (next dir) ◄─ phase1 (staged, one stage/tick)
         │            ... reads keep pinning v_n between stages ...
         ▼
    publish(v_n+1) — v_n retired into epoch limbo, reclaimed 2 epochs later

  * **Flush-on-publish.** Over a durable table (``persist.create`` /
    ``reopen``) every publish also flushes the same dirty rows into the
    pool, so an acknowledged op is durable; a pool that stops accepting
    flushes turns the frontend DEGRADED, a background scrubber verifies and
    repairs the pool's rows, and a flight recorder persists the recent
    observability window with every commit.

``StopTheWorldFrontend`` drives the identical op stream through the inline
path (single FIFO, full split storms inside write batches) — the baseline
the read sojourn p50/p99 is compared against.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import List, Optional

import numpy as np
import torch

from repro_torch import obs as obs_mod
from repro_torch.core import engine as dash_engine
from repro_torch.core import hashing
from repro_torch.core.epoch import SnapshotRegistry
from repro_torch.core.layout import DROPPED, INSERTED, NOT_FOUND
from repro_torch.core.table import DashTable, TableFullError
from repro_torch.kernels import fused
from repro_torch.persist.writeback import Scrubber, WritebackDegraded

from .engine import buckets_changed

READ, INSERT, UPDATE, DELETE, RMW = "read", "insert", "update", "delete", "rmw"


def _read_batching(table: DashTable, max_batch: int,
                   fused_reads: Optional[bool]) -> str:
    """Read-path selection for a frontend tick. ``fused_reads=None`` picks
    the fused one-launch probe exactly when the table's planner would
    (batch fits under ``table.fused_threshold`` and the config is fused-
    eligible); True/False force the fused or the routed fingerprint-kernel
    path. The decision is made once at construction: read batches are
    padded to ``max_batch``, so every tick shares one shape and one plan."""
    if fused_reads is False:
        return "auto"
    if fused_reads is True:
        return "fused"
    if (max_batch <= table.fused_threshold
            and fused.fused_search_eligible(table.cfg)):
        return "fused"
    return "auto"


#: frontend health states. Guarantees:
#:   HEALTHY  — every acknowledged write is durable (flush-on-publish ran
#:              through its commit fence, with a pool attached) and reads
#:              serve verified state.
#:   DEGRADED — the durable device stopped accepting flushes past the retry
#:              budget: serving CONTINUES (reads + writes, full speed) but
#:              acknowledgments are volatile until ``try_recover`` brings
#:              the pool back (then one force-full flush resynchronizes).
#:              The pool's on-media image stays the last committed flush.
#:   READONLY — capacity exhaustion (segment pool / retry budget) with
#:              ``readonly_on_full``: writes are rejected at admission and
#:              in-flight writes fail explicitly (DROPPED); reads keep
#:              serving. Terminal until operator action (resize/restart).
HEALTHY, DEGRADED, READONLY = "healthy", "degraded", "readonly"


@dataclasses.dataclass
class Op:
    """One client operation. The frontend stamps admission/completion times;
    ``latency`` is the sojourn (queue wait + service), the quantity read
    p50/p99 are quoted over."""
    kind: str
    key: int
    value: int = 0
    enqueue_t: float = 0.0
    done_t: float = 0.0
    status: int = -1
    found: bool = False
    result: int = 0

    @property
    def latency(self) -> float:
        return self.done_t - self.enqueue_t


class AdmissionQueue:
    """Bounded FIFO admission lane. ``offer`` rejects when full — the
    backpressure is surfaced to the caller (shed/retry upstream) instead of
    letting the queue grow without bound during a split storm."""

    def __init__(self, depth: int = 4096):
        self.depth = depth
        self._q: deque = deque()
        self.admitted = 0
        self.rejected = 0

    def offer(self, op: Op) -> bool:
        if len(self._q) >= self.depth:
            self.rejected += 1
            return False
        op.enqueue_t = obs_mod.now()
        self._q.append(op)
        self.admitted += 1
        return True

    def __len__(self) -> int:
        return len(self._q)

    def peek(self) -> Optional[Op]:
        return self._q[0] if self._q else None

    def pop(self) -> Op:
        return self._q.popleft()


class BatchFormer:
    """Pulls the maximal same-kind run from a lane head, up to
    ``max_batch`` — admission order is preserved within the lane and every
    formed batch is homogeneous (one engine dispatch kind)."""

    def __init__(self, max_batch: int = 256):
        self.max_batch = max_batch

    def form(self, lane: AdmissionQueue) -> List[Op]:
        head = lane.peek()
        if head is None:
            return []
        ops = []
        while (len(ops) < self.max_batch and lane.peek() is not None
               and lane.peek().kind == head.kind):
            ops.append(lane.pop())
        return ops


def _keys_arrays(ops: List[Op], pad_to: int = 0, device="cpu"):
    """Key word tensors of a batch on ``device``, zero-padded to ``pad_to``
    so every read batch has one shape."""
    keys = np.zeros(max(pad_to, len(ops)), dtype=np.uint64)
    keys[:len(ops)] = [op.key for op in ops]
    return hashing.split_keys(keys, device)


def _host_reads(found, vals):
    """(found bool, values uint32) numpy arrays in one transfer."""
    both = torch.stack([found.to(torch.int32), vals]).cpu().numpy()
    return both[0] != 0, both[1].view(np.uint32)


class FrontendBase:
    """Shared cooperative scheduler: bounded read/write admission lanes,
    batch forming, read-priority ticks, sojourn stamping + snapshot/retry
    stats. Subclasses provide the probe/verify/write machinery
    (``_serve_reads``, ``_pump_write``) and report in-flight write work via
    ``_write_pending``."""

    def __init__(self, *, max_batch: int = 256, queue_depth: int = 4096,
                 obs: Optional[obs_mod.Observability] = None):
        self.reads = AdmissionQueue(queue_depth)
        self.writes = AdmissionQueue(queue_depth)
        self.former = BatchFormer(max_batch)
        self.registry = SnapshotRegistry()
        self.health = HEALTHY
        self.degraded_events = 0     # HEALTHY -> DEGRADED transitions
        self.readonly_events = 0     # -> READONLY transitions (terminal)
        self.unflushed_publishes = 0  # publishes acked volatile while degraded
        self.snapshot_reads = 0      # queries answered from the snapshot
        self.retried_reads = 0       # queries re-run on the live version
        self.read_latencies: List[float] = []
        self.write_latencies: List[float] = []
        # observability bundle: metrics registry + tracer + SLO monitor
        # (obs/). The sojourn histograms are fed by the same _finish_*
        # stamps the latency lists come from — one clock, one code path.
        self.obs = obs if obs is not None else obs_mod.Observability()
        # durable flight recorder (obs/blackbox.py): set by subclasses that
        # attach a pool — health transitions and write intents stamp it
        self.recorder = None
        scope = self.obs.registry.scope("frontend")
        self._read_hist = scope.histogram("read_sojourn_s")
        self._write_hist = scope.histogram("write_sojourn_s")
        self._publish_bytes = scope.counter("publish_bytes")
        self._flush_bytes = scope.counter("flush_bytes")
        self._publishes = scope.counter("publishes")
        self.obs.slo.watch_histogram("read_sojourn", self._read_hist)
        self.obs.slo.watch_histogram("write_sojourn", self._write_hist)
        self.obs.slo.watch_rate("publish_bytes_per_s", self._publish_bytes)
        self.obs.slo.watch_rate("flush_bytes_per_s", self._flush_bytes)
        self.obs.slo.note_health(self.health)

    def _set_health(self, new: str):
        """The one health-transition path: keeps the transition counters,
        the SLO monitor's dwell accounting, and the trace instant in sync."""
        if new == self.health:
            return
        if new == DEGRADED:
            self.degraded_events += 1
        elif new == READONLY:
            self.readonly_events += 1
        self.obs.tracer.instant("health_transition", "health",
                                frm=self.health, to=new)
        if self.recorder is not None:
            self.recorder.record_health(self.health, new)
        self.obs.slo.note_health(new)
        self.health = new

    def submit(self, op: Op) -> bool:
        if self.health == READONLY and op.kind != READ:
            self.writes.rejected += 1
            return False
        lane = self.reads if op.kind == READ else self.writes
        return lane.offer(op)

    def _write_pending(self) -> bool:
        return False

    @property
    def busy(self) -> bool:
        return bool(len(self.reads) or len(self.writes)
                    or self._write_pending())

    def stats(self) -> dict:
        """One observability surface (tests + the chip run): the registry's
        copy-on-write publish counters, the read-path snapshot/retry split,
        the health counters and — when a durable pool is attached — the
        writeback's flush counters and the scrubber's."""
        out = self.registry.stats()
        out["snapshot_reads"] = self.snapshot_reads
        out["retried_reads"] = self.retried_reads
        out["health"] = self.health
        out["degraded_events"] = self.degraded_events
        out["readonly_events"] = self.readonly_events
        out["unflushed_publishes"] = self.unflushed_publishes
        table = getattr(self, "table", None)
        if table is not None:
            report = getattr(table, "lost_report", [])
            out["lost_rows"] = sum(1 for r in report if r.get("plane") == "bt")
            out["lost_records"] = sum(r.get("lost_records", 0) for r in report)
        wb = getattr(table, "writeback", None)
        if wb is not None:
            # superblock counts are the durable cumulative truth (survive
            # the healing flush and later restarts); prefer them when present
            out["lost_records"] = max(out.get("lost_records", 0),
                                      wb.pool.sb.lost_records)
            out["quarantined_bt"] = len(wb.pool.sb.lost_bt)
            out["quarantined_nb"] = len(wb.pool.sb.lost_nb)
            out["quarantine_overflow"] = wb.pool.sb.lost_overflow
            out.update(wb.stats())
        scrubber = getattr(self, "scrubber", None)
        if scrubber is not None:
            out.update(scrubber.stats())
        return out

    def obs_snapshot(self) -> dict:
        """Full observability export: registry metrics (with the stats()
        surfaces mirrored in under ``stats.``), the last SLO snapshot, and
        tracer occupancy."""
        self.obs.registry.ingest(self.stats(), prefix="stats.")
        return self.obs.snapshot()

    def _finish_reads(self, ops: List[Op], found, vals, n_changed: int):
        now = self.obs.now()
        for i, op in enumerate(ops):
            op.found = bool(found[i])
            op.result = int(vals[i])
            op.status = INSERTED if op.found else NOT_FOUND
            op.done_t = now
            self.read_latencies.append(op.latency)
        self._read_hist.observe_many([op.latency for op in ops])
        self.snapshot_reads += len(ops) - n_changed
        self.retried_reads += n_changed

    def _finish_writes(self, ops: List[Op], statuses):
        now = self.obs.now()
        for op, st in zip(ops, statuses):
            op.status = int(st)
            op.done_t = now
            self.write_latencies.append(op.latency)
        self._write_hist.observe_many([op.latency for op in ops])

    def step(self) -> bool:
        """One tick: a read batch first (latency priority — it never waits
        on the write side), then one write-side unit. Returns True if any
        work ran."""
        did = False
        read_ops = self.former.form(self.reads)
        if read_ops:
            self._serve_reads(read_ops)
            did = True
        return self._pump_write() or did

    def drain(self):
        """Run the scheduler until every admitted op completed and no SMO
        is in flight."""
        while self.busy:
            self.step()


class DashFrontend(FrontendBase):
    """Concurrent serving frontend over one ``DashTable`` (EH or LH).

    Cooperative scheduler: ``step()`` is one tick — serve one read batch
    from the pinned snapshot, then advance the write side by exactly one
    unit (one SMO stage, one insert round, or one new write batch). The
    interleaving is deterministic. ``drain()`` runs ticks until idle.

    Requires the staged bulk SMO path (``table.smo_task_eligible()``) for
    deferred splits; scan-mode / rebuild-ineligible tables split inline
    inside the write tick (reads still serve the snapshot).

    The frontend assumes it is the table's only writer: the clean-snapshot
    fast path (skip the verify when nothing was written since the last
    publish) is tracked by a host-side dirty flag that direct
    ``table.insert(...)`` calls would bypass.
    """

    def __init__(self, table: DashTable, *, max_batch: int = 256,
                 queue_depth: int = 4096, readonly_on_full: bool = False,
                 scrub_interval: int = 0, scrub_rows: int = 512,
                 fused_reads: Optional[bool] = None,
                 obs: Optional[obs_mod.Observability] = None):
        super().__init__(max_batch=max_batch, queue_depth=queue_depth,
                         obs=obs)
        self.table = table
        table.attach_obs(self.obs)
        self.cfg = table.cfg
        self.mode = table.mode
        # read-path selection (fused one-launch probe vs routed fingerprint
        # kernel); writes take the fused path through the table planner
        self.read_batching = _read_batching(table, max_batch, fused_reads)
        # capacity exhaustion policy: False raises through; True turns it
        # into the READONLY health state (reads keep serving, writes fail
        # explicitly)
        self.readonly_on_full = readonly_on_full
        # background media scrub: every `scrub_interval` ticks verify+repair
        # one `scrub_rows` window of the attached pool (0 disables)
        self.scrub_interval = scrub_interval
        self._scrub_countdown = scrub_interval
        self.scrubber = None
        if scrub_interval > 0 and table.writeback is not None:
            self.scrubber = Scrubber(table.writeback, rows_per_tick=scrub_rows)
        # durable flight recorder: one per attached pool. Every flush then
        # persists the recent-observability window alongside the commit
        # (obs/blackbox.py) and crash forensics can replay the last moments
        # (obs/forensics.py). Telemetry loss gets its own declarative SLO.
        if table.writeback is not None:
            self.recorder = (table.writeback.recorder or
                             table.writeback.attach_recorder(
                                 obs_mod.FlightRecorder()))
            for rule in obs_mod.TELEMETRY_SLO_RULES:
                self.obs.slo.add_rule(rule)
        self._dirty = True            # live state diverged from the snapshot
        # trace state: the batch/SMO spans stay open across ticks; the last
        # publish/flush span ids are what ack spans causally link back to
        self._batch_span = None
        self._smo_span = None
        self._last_publish_sid = None
        self._last_flush_sid = None
        self._publish()
        # in-flight write machinery (at most one of each at a time)
        self._insert_job = None
        self._insert_ops: List[Op] = []
        self._smo_task = None
        self.smo_stages = 0          # staged SMO pumps
        self.smo_dispatches = 0      # completed SMO tasks

    def _write_pending(self) -> bool:
        return self._insert_job is not None or self._smo_task is not None

    # -- snapshot lifecycle ------------------------------------------------

    def _publish(self):
        """Install the live state as the next published version in O(dirty)
        bytes (core/epoch.py). The table's host-side dirty tracker is
        drained ONCE: the registry audits it against the version-plane diff
        and honors its force-full escape after crash/restart. Superseded
        versions retire through the epoch manager; their planes go only
        when no newer version aliases them.

        Flush-on-publish: with a durable pool attached (persist/), the same
        dirty hint drives the pool writeback right after the publish — an
        op acknowledged by this frontend is durable, and the flush volume
        tracks the publish volume (both O(dirty bucket rows)). The flush
        reads ``self.table.state`` as it is now.

        Graceful degradation: a flush that exhausts its transient-error
        retry budget marks the frontend DEGRADED instead of failing the
        publish — serving continues volatile (the pool keeps its last
        committed image; acknowledgments stop implying durability until
        ``try_recover`` succeeds). The hint loss is harmless: recovery
        resynchronizes with a force-full flush."""
        tr = self.obs.tracer
        self._last_publish_sid = None
        self._last_flush_sid = None
        with tr.span("publish", "epoch") as psp:
            hint = self.table.dirty.drain()
            self.registry.publish_cow(self.cfg, self.table.state,
                                      dirty_hint=hint)
            self._publishes.inc()
            self._publish_bytes.inc(self.registry.last_publish_bytes)
            if psp is not None:
                psp.args["bytes"] = self.registry.last_publish_bytes
                self._last_publish_sid = psp.sid
            wb = self.table.writeback
            if wb is not None:
                if wb.degraded:
                    self.unflushed_publishes += 1
                else:
                    before = wb.flushed_bytes
                    try:
                        # the writeback opens its own "flush" span — nested
                        # under this publish span via the tracer stack
                        wb.flush(self.table.state, hint)
                        self._last_flush_sid = wb.last_flush_sid
                    except WritebackDegraded:
                        if self.health == HEALTHY:
                            self._set_health(DEGRADED)
                        self.unflushed_publishes += 1
                    self._flush_bytes.inc(wb.flushed_bytes - before)
        self._dirty = False

    def try_recover(self) -> bool:
        """Attempt DEGRADED -> HEALTHY: probe the pool's fence and, on
        success, resynchronize it with one force-full flush
        (``WritebackEngine.try_recover``). READONLY is terminal — capacity,
        not media. Returns True when the frontend is healthy afterwards."""
        if self.health == READONLY:
            return False
        wb = self.table.writeback
        if wb is None or not wb.degraded:
            self._set_health(HEALTHY)
            return True
        if wb.try_recover(self.table.state):
            self._set_health(HEALTHY)
            return True
        return False

    # -- read lane ---------------------------------------------------------

    def _serve_reads(self, ops: List[Op]):
        tr = self.obs.tracer
        with tr.span("read_batch", "serving", n=len(ops)) as rsp:
            n_changed = self._serve_reads_inner(ops)
        ack = tr.begin("ack", "serving", kind=READ, n=len(ops),
                       retried=n_changed)
        tr.link(ack, rsp)
        tr.end(ack)

    def _serve_reads_inner(self, ops: List[Op]) -> int:
        hi, lo = _keys_arrays(ops, self.former.max_batch, self.table.device)
        n = len(ops)
        if self.table.lazy_recovery:
            # lazy per-segment recovery hooks the READ path too (Sec. 4.8):
            # the verify below then retries the recovered buckets on the
            # live version (recovery bumps their version words)
            before = self.table.recovered_segments
            self.table._ensure_recovered(self.table._segments_of(hi[:n], lo[:n]))
            if self.table.recovered_segments != before:
                self._dirty = True
        with self.registry.acquire() as snap:
            found, vals = dash_engine.search_batch(
                self.cfg, self.mode, snap.state, hi, lo,
                batching=self.read_batching)
            n_changed = 0
            if self._dirty:
                # verify only when the live state diverged since publish
                # (a clean snapshot is the live state by construction)
                changed = buckets_changed(self.cfg, self.mode, snap.state,
                                          self.table.state, hi, lo)
                changed[n:] = False               # padding lanes never retry
                n_changed = int(changed.sum())
            if n_changed:
                # lazy retry: one extra probe ONLY when the verify pass
                # flagged queries — the only read-path dependency on
                # in-flight writes/SMOs
                f2, v2 = dash_engine.search_batch(
                    self.cfg, self.mode, self.table.state, hi, lo,
                    batching=self.read_batching)
                found = torch.where(changed, f2, found)
                vals = torch.where(changed, v2, vals)
            found, vals = _host_reads(found, vals)
        self._finish_reads(ops, found, vals, n_changed)
        return n_changed

    # -- write lane --------------------------------------------------------

    def _pump_write(self) -> bool:
        """Advance the write side by one unit. Returns True if work ran.
        With ``readonly_on_full``, capacity exhaustion (segment pool /
        insert retry budget) transitions to READONLY instead of raising:
        in-flight write ops fail explicitly (DROPPED — never silently),
        queued writes are rejected, reads keep serving."""
        try:
            return self._pump_write_inner()
        except TableFullError:
            if not self.readonly_on_full:
                raise
            self._set_health(READONLY)
            tr = self.obs.tracer
            if self._insert_ops:
                self._finish_writes(self._insert_ops,
                                    [DROPPED] * len(self._insert_ops))
            tr.end(self._batch_span, dropped=True)
            tr.end(self._smo_span, dropped=True)
            self._batch_span = self._smo_span = None
            self._insert_job, self._insert_ops = None, []
            self._smo_task = None
            while len(self.writes):
                op = self.writes.pop()
                op.status = DROPPED
                op.done_t = self.obs.now()
                self.writes.rejected += 1
            self._dirty = True       # surgery may have run mid-SMO
            self._publish()
            return True

    def _begin_smo_span(self):
        task = self._smo_task
        if task is not None:
            self._smo_span = self.obs.tracer.begin("smo", "smo",
                                                   **task.describe())
            if self.recorder is not None:
                self.recorder.note_open(self._smo_span)

    # -- durable intent/ack stamps (flight recorder protocol) --------------

    def _record_intent(self, kind, keys):
        """Stamp the write batch into the flight recorder BEFORE the
        flush-on-publish: these ops are acked by the first commit with
        ``flush_seq >= await_seq``. If that flush tears, its half-written
        window is the only durable evidence the ops were in flight — the
        forensics contract. No-op without a durable pool."""
        rec = self.recorder
        if rec is None:
            return None
        aw = self.table.writeback.pool.sb.flush_seq + 1
        rec.record_ops(kind, [int(k) for k in keys], await_seq=aw)
        return aw

    def _record_ack(self, aw, kind, n: int):
        rec = self.recorder
        if rec is None or aw is None:
            return
        seq = self.table.writeback.pool.sb.flush_seq
        # durable=False while DEGRADED: the ack is volatile-only and the
        # recorder says so (acknowledgments stop implying durability)
        rec.record_ack(seq, kind, n, durable=seq >= aw)

    def _emit_write_ack(self, batch_span, kind: str, n: int):
        """The acknowledgment trace event: an acked batch links back to its
        batch span, the publish that made it visible, and (when durable)
        the flush that made it durable."""
        tr = self.obs.tracer
        if not tr.enabled:
            return
        ack = tr.begin("ack", "serving", parent=batch_span, kind=kind, n=n)
        tr.link(ack, batch_span, self._last_publish_sid,
                self._last_flush_sid)
        tr.end(ack)

    def _pump_write_inner(self) -> bool:
        tr = self.obs.tracer
        if self._smo_task is not None:
            with tr.span("smo_stage", "smo", parent=self._smo_span,
                         stage=self._smo_task.stage):
                self.table.state, done = self._smo_task.pump(
                    self.table.state)
            self.smo_stages += 1
            self._dirty = True
            if done:
                shortfall = self._smo_task.shortfall
                self._smo_task = None
                self.smo_dispatches += 1
                tr.end(self._smo_span, shortfall=shortfall)
                self._smo_span = None
                # the next directory version is live: publish so subsequent
                # read batches pin it instead of paying the retry probe
                self._publish()
                if shortfall:
                    raise TableFullError("segment pool exhausted")
            return True

        if self._insert_job is not None:
            job = self._insert_job
            if job.rounds > 256:
                raise TableFullError("insert retry budget exhausted")
            with tr.span("insert_round", "serving",
                         parent=self._batch_span):
                activated = self.table.insert_round(job)
            self._dirty = True
            staged = self.table.smo_task_eligible()
            if job.done:
                n_ops = len(self._insert_ops)
                aw = self._record_intent(
                    INSERT, [op.key for op in self._insert_ops])
                self._finish_writes(self._insert_ops, job.out.cpu().numpy())
                bsp = self._batch_span
                tr.end(bsp, rounds=job.rounds)
                self._batch_span = None
                self._insert_job, self._insert_ops = None, []
                self._publish()
                self._emit_write_ack(bsp, INSERT, n_ops)
                self._record_ack(aw, INSERT, n_ops)
                if activated:   # LH stash activation still demands a split
                    if staged:
                        self._smo_task = self.table.make_smo_task(None)
                        if self._smo_task is not None:
                            self.table.note_smo(self._smo_task)
                            self._begin_smo_span()
                    else:
                        self.table._on_pressure(None)
                        self._dirty = True
            elif staged:
                # defer the storm: plan the bulk SMO, pump it on later ticks
                self._smo_task = self.table.make_smo_task(
                    self.table.pressure_hints(job))
                self.table.note_smo(self._smo_task)
                self._begin_smo_span()
            else:
                # scalar / rebuild-ineligible configs keep the inline SMO
                # (splits land inside this tick; reads still serve snapshots)
                self.table._on_pressure(self.table.pressure_hints(job))
            return True

        ops = self.former.form(self.writes)
        if not ops:
            return False
        kind = ops[0].kind
        if kind == INSERT:
            self._batch_span = tr.begin("write_batch", "serving",
                                        kind=kind, n=len(ops))
            if self.recorder is not None:
                self.recorder.note_open(self._batch_span)
            self._insert_job = self.table.insert_begin(
                [op.key for op in ops], [op.value for op in ops])
            self._insert_ops = ops
            # first round runs this tick; pressure (if any) defers to a task
            return self._pump_write()
        bsp = tr.begin("write_batch", "serving", kind=kind, n=len(ops))
        keys = [op.key for op in ops]
        self._dirty = True
        if kind == UPDATE:
            statuses = self.table.update(keys, [op.value for op in ops])
        elif kind == DELETE:
            statuses = self.table.delete(keys)
        else:                                   # RMW: read live, write back
            found, vals = self.table.search(keys)
            for op, f, v in zip(ops, found, vals):
                op.found, op.result = bool(f), int(v)
            statuses = self.table.update(
                keys, [op.value for op in ops])
        aw = self._record_intent(kind, keys)
        self._finish_writes(ops, np.asarray(statuses))
        tr.end(bsp)
        self._publish()
        self._emit_write_ack(bsp, kind, len(ops))
        self._record_ack(aw, kind, len(ops))
        return True

    def _slo_extra(self) -> dict:
        """Per-tick facts the SLO snapshot carries beyond the registry:
        health, epoch limbo depth, queue occupancy. Built lazily — only on
        SLO evaluation ticks."""
        out = {"health": self.health,
               "limbo_depth": self.registry.epochs.limbo_size,
               "queue_depth": len(self.reads) + len(self.writes),
               "unflushed_publishes": self.unflushed_publishes}
        out.update(obs_mod.telemetry_slo_extra(self.obs.tracer,
                                               self.recorder))
        return out

    def step(self) -> bool:
        did = super().step()
        if self.scrubber is not None:
            self._scrub_countdown -= 1
            if self._scrub_countdown <= 0:
                self._scrub_countdown = self.scrub_interval
                self.scrubber.tick(self.table.state)
        # the SLO monitor ticks alongside the scrubber: one counter bump
        # per tick, a windowed evaluation every eval_interval ticks
        self.obs.slo.tick(self._slo_extra)
        return did

    def shutdown(self):
        self.drain()
        self.registry.flush()


class StopTheWorldFrontend(FrontendBase):
    """Baseline: the same admission stream served strictly in order through
    the inline path — ONE FIFO (no lane separation: everything lands in the
    base's write lane), writes run ``DashTable.insert`` (split storms inside
    the batch), reads probe the live state. A read admitted behind a storm
    waits for the whole storm; its sojourn latency shows it."""

    def __init__(self, table: DashTable, *, max_batch: int = 256,
                 queue_depth: int = 4096,
                 fused_reads: Optional[bool] = None):
        super().__init__(max_batch=max_batch, queue_depth=queue_depth)
        self.table = table
        self.cfg = table.cfg
        self.mode = table.mode
        self.queue = self.writes          # the single FIFO, reads included
        self.read_batching = _read_batching(table, max_batch, fused_reads)

    def submit(self, op: Op) -> bool:
        return self.queue.offer(op)

    def _serve_reads(self, ops: List[Op]):
        hi, lo = _keys_arrays(ops, self.former.max_batch, self.table.device)
        n = len(ops)
        if self.table.lazy_recovery:
            self.table._ensure_recovered(self.table._segments_of(hi[:n], lo[:n]))
        found, vals = dash_engine.search_batch(
            self.cfg, self.mode, self.table.state, hi, lo,
            batching=self.read_batching)
        self._finish_reads(ops, *_host_reads(found, vals), 0)

    def _pump_write(self) -> bool:
        ops = self.former.form(self.queue)
        if not ops:
            return False
        kind = ops[0].kind
        if kind == READ:
            self._serve_reads(ops)
            return True
        keys = [op.key for op in ops]
        if kind == INSERT:
            statuses = self.table.insert(keys, [op.value for op in ops])
        elif kind == UPDATE:
            statuses = self.table.update(keys, [op.value for op in ops])
        elif kind == DELETE:
            statuses = self.table.delete(keys)
        else:                                   # RMW
            found, vals = self.table.search(keys)
            for op, f, v in zip(ops, found, vals):
                op.found, op.result = bool(f), int(v)
            statuses = self.table.update(keys, [op.value for op in ops])
        self._finish_writes(ops, np.asarray(statuses))
        return True
