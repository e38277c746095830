"""O(dirty) flush-on-publish: ordered dirty-plane writeback into the PM pool.

Ported from ``repro.persist.writeback``: the same fenced phases, redo-log
rule, recorder window and counters, writing the reference's bytes. The live
state lives on the table's device; only the dirty rows (and the narrow
planes) cross to the host, where the pool's mapping is.

``WritebackEngine.flush(state, hint)`` makes the live table state durable in
bytes proportional to what changed since the last flush — the durable
rendering of the O(dirty) COW publish. The dirty ground truth is the same:
every plane mutation bumps its bucket's version word (core/bucket.py), so the
diff of the live version plane against the POOL's version plane is a complete
change record; the host ``DirtyTracker`` hint is audited against it
(``flush_hint_misses``) and carries the force-full escape for paths outside
the version discipline (crash simulation, degraded-mode resync). The
pointer-mode key heap carries no version words but is append-only, so its
tail above the pool's durable ``heap_top`` is the exact dirty set —
pointer-mode flushes are O(dirty rows + heap tail), not O(pool).

Host staging is O(dirty) too, not just the pool I/O: the wide record planes
(key/value/fingerprint/overflow-fingerprint — ~95% of the pool's bytes) are
never copied to the host whole. Once the version diff names the dirty rows,
a device gather (``_gather_rows``: one ``index_select`` per plane, one
``.cpu()`` each) pulls exactly those rows and only they cross to the host,
wrapped in row-indexable ``_GatheredRows``
proxies the phase writes and the redo-log encoder index like full planes.
Only the narrow planes (4-byte publish words, routing, scalars) are copied
whole; the pointer-mode heap is device-sliced at its tail. ``staged_bytes``
/ ``last_staged_bytes`` count every host-materialized byte, the dirty-row
gathers at the reference's pow2-padded size (its jitted gather pads the id
vector so its trace count stays bounded; this one gathers only the real
rows, and counts the same bytes so the counters agree). The bytes that
really crossed to the host are ``transferred_bytes`` /
``last_transferred_bytes``: attributes outside ``stats()``, whose keys stay
the reference's.
``stage_seconds`` / ``last_stage_seconds`` time the device-to-host staging
apart from the pool I/O and fences.

**Crash consistency.** Every dirty bucket row is classified against the
pool's current contents:

  * **append** — the row only gains records; every slot the pool's meta word
    claims keeps its exact key/fingerprint bytes. Normal inserts and
    displacement destinations.
  * **clear**  — the row loses alloc bits but surviving slots keep their
    bytes. Deletes and displacement sources.
  * **rebuilt** — some pool-allocated slot's key/fp bytes CHANGED: the
    vectorized SMO rebuild (split source, merge keep, cleared merge victim)
    relaid the segment. No store order makes an in-place rewrite of such a
    row crash-atomic — old meta claims slots whose bytes a partial write
    already scrambled — so rebuilt rows are staged through the pool's redo
    log instead (PMDK's allocate-activate discipline, scoped to exactly the
    rows that need it; in-place value updates stay in place — a torn value
    is an in-flight op's indeterminacy, not a lost key).

Stores are then ordered into fenced phases; a crash at ANY inter-store point
leaves a pool in which every previously-acknowledged key is reachable (an op
is acknowledged durable only after its flush's commit fence — in-flight ops
of a torn flush may land partially, exactly like in-flight stores on PM):

  1. append+clear rows: data planes (key/value/fp/ofp). New bytes land only
     in slots the pool's meta words consider free — invisible until
     published (the paper's record-then-CLWB-the-meta-word order, Alg. 2).
  2. append rows: meta/ometa/version. Records become visible; nothing
     becomes unreachable.
  3. routing (directory, per-segment metadata, scalars incl. the LH
     level/next word and the watermark) — in place ONLY when no rebuilt
     rows exist this flush (a torn directory then mixes old/new 4-byte
     entries, each routing to an intact segment); with rebuilt rows the
     routing planes ride in the redo log so they flip together with the
     rebuilt segments.
  4. clear rows: meta/ometa/version. Only now can a record leave a row —
     its displacement copy (if any) was published in phase 2. Acked deletes
     of previous flushes stay deleted; this flush's deletes are unacked
     until commit either way. In place ONLY when no rebuilt rows exist this
     flush: a moved record's destination may be a rebuilt row that lives
     solely in the (uncommitted) redo log, so with a log the clears join
     the logged set and land atomically with the commit instead.
  5. redo log: rebuilt + clear rows (+ routing planes when any), one
     staged write.
  6. commit — the superblock slot (flush_seq, clean marker, V, log
     descriptor + CRC), fenced: the acknowledgment point.
  7. apply the log to the home rows, fence. A crash inside the apply is
     repaired at the next open: a committed log is re-applied idempotently
     (absolute row contents).
  8. commit again with the log descriptor cleared: the applied log
     is retired, so a descriptor seen at open always refers to live log
     bytes — a CRC mismatch there is media loss, never staleness.

The emulated store granularity is one plane scatter between fences (a clwb
train); ``inject_crash(after_ops)`` kills the engine after that many stores,
which is what the crash-matrix test sweeps every cut point of. Per-store
tearing WITHIN one scatter (real PM's finer failure model) is out of the
emulation's store model — Dash's per-record fence protocol collapses into
the phase ordering here.

Recovery after a torn flush needs nothing new: the pool's superblock says
dirty, reopen bumps V, and the existing per-segment lazy recovery
(core/recovery.py) clears locks, dedupes the half-displaced records phases
2/4 can leave behind, and rebuilds the overflow metadata.
"""
from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from repro_torch.core import layout
from repro_torch.core.epoch import DirtyHint
from repro_torch.core.layout import DashState

from .pool import FlushError, PmPool

#: phase-1 record planes, in flush order (keys/values before anything that
#: could publish them)
DATA_BT = ("fp", "key_hi", "key_lo", "val")
#: publish planes: the meta word is the visibility point; version is the
#: dirty-diff ground truth and lands LAST so a torn row is re-flushed
PUBLISH_BT = ("meta", "version")

#: big record planes (wide rows — ~95% of the pool's bytes): staged
#: host-side at DIRTY-ROW granularity via a device gather, never copied
#: whole. Everything else (4-byte-row publish planes, routing, scalars)
#: is copied whole per flush — a few percent of the pool.
GATHER_BT = DATA_BT
GATHER_NB = ("ofp",)


def _gather_rows(planes, ids: torch.Tensor):
    """Device-side dirty-row gather: one ``index_select`` per
    (pre-reshaped) plane, then one host transfer each. A full set of rows
    is copied as it lies."""
    return tuple((p if ids.numel() == p.shape[0] else p.index_select(0, ids)).cpu()
                 for p in planes)


class _GatheredRows:
    """Row-indexable stand-in for a full host copy of one record plane:
    holds only the gathered dirty rows. Supports exactly the access
    patterns of the flush and of ``PmPool.write_rows`` / ``_encode_log``
    — fancy-index by any subset of the gathered ids, plus a
    shape-preserving ``reshape`` (the row-major layout is already the
    gathered one). Indexing an id that was not gathered is a staging
    bug, not a fallback — it asserts."""

    def __init__(self, ids: np.ndarray, rows: np.ndarray):
        self._ids = ids               # sorted (flatnonzero order)
        self._rows = rows             # (ids.size, row_elems)
        self.shape = rows.shape
        self.dtype = rows.dtype

    def __getitem__(self, ids):
        ids = np.asarray(ids)
        flat = ids.reshape(-1)
        pos = np.searchsorted(self._ids, flat)
        if flat.size:
            hit = np.minimum(pos, self._ids.size - 1)
            assert np.array_equal(self._ids[hit], flat), \
                "row indexed outside the gathered dirty set"
        return self._rows[pos].reshape(ids.shape + self._rows.shape[1:])

    def reshape(self, *shape):
        return self                   # rows are already row-major


class SimulatedCrash(RuntimeError):
    """Raised when an injected crash point is reached mid-flush; the engine
    is dead afterwards (the process 'died' — reopen the pool to continue)."""


class WritebackDegraded(RuntimeError):
    """A flush fence kept failing past the bounded retry budget: the engine
    is DEGRADED. The pool's durable image is the last committed flush
    (phases land between fences, so nothing half-acknowledged exists);
    serving must continue volatile. ``try_recover`` probes the device and,
    on success, resynchronizes with one force-full flush."""


def _slot_bits(meta_rows: np.ndarray, num_slots: int) -> np.ndarray:
    """(n, num_slots) bool alloc matrix from packed meta words."""
    alloc = (meta_rows.astype(np.uint32) >> np.uint32(layout.ALLOC_SHIFT)) \
        & np.uint32(layout.SLOT_MASK)
    return (alloc[:, None] >> np.arange(num_slots, dtype=np.uint32)) & 1 == 1


class WritebackEngine:
    """Flush-on-publish engine bound to one ``PmPool``.

    Counters (the observability surface tests and runs read): ``flushes``,
    ``flushed_bytes`` / ``last_flush_bytes`` (bytes actually written,
    including the doubled cost of logged rebuilt rows), ``flushed_rows``,
    ``logged_rows``, ``flush_seconds``, ``flush_hint_misses`` (device-dirty
    segments the host tracker failed to report — should stay 0), and the
    pool's ``fences``.
    """

    def __init__(self, pool: PmPool, retry_limit: int = 4,
                 retry_base_s: float = 0.002):
        self.pool = pool
        self.cfg = pool.cfg
        self.mode = pool.mode
        self.retry_limit = retry_limit      # fence retries before DEGRADED
        self.retry_base_s = retry_base_s    # backoff base (doubles per retry)
        self.flushes = 0
        self.flushed_bytes = 0
        self.last_flush_bytes = 0
        self.staged_bytes = 0         # host bytes materialized from device
        self.last_staged_bytes = 0    # ... by the last flush (O(dirty) gate)
        self.transferred_bytes = 0    # bytes that really crossed to the host
        self.last_transferred_bytes = 0
        self.last_flush_rows = 0      # per-plane row writes of the last flush
        self.last_dirty_rows = 0      # distinct dirty bucket rows last flush
        self.last_heap_tail_rows = 0  # pointer-mode heap rows of last flush
        self.flushed_rows = 0
        self.logged_rows = 0
        self.flush_seconds = 0.0
        self.last_flush_seconds = 0.0
        self.stage_seconds = 0.0      # device-to-host staging within flushes
        self.last_stage_seconds = 0.0
        self.flush_hint_misses = 0
        self.flush_io_errors = 0      # fence attempts that raised FlushError
        self.flush_retries = 0        # fences retried after a transient error
        self.degraded_flushes = 0     # flush calls refused while degraded
        self.recoveries = 0           # successful DEGRADED -> healthy returns
        self.degraded = False
        self._ops_budget: Optional[int] = None
        self.dead = False
        self.obs = None               # observability bundle (obs/), optional
        self.recorder = None          # flight recorder (obs/blackbox.py)
        self.last_flush_sid = None    # span id of the last committed flush

    def attach_obs(self, obs):
        """Bind an observability bundle: each flush becomes a traced span
        (with redo-log commit / log-apply instants) and quarantine events
        surface through the pool."""
        self.obs = obs
        self.pool.obs = obs
        if self.recorder is not None:
            self.recorder.attach(tracer=obs.tracer, registry=obs.registry)

    def attach_recorder(self, recorder):
        """Bind a durable flight recorder: every flush persists
        the recorder's window into the pool's blackbox region before the
        commit fence, and the pool stamps quarantine evidence into it."""
        self.recorder = recorder
        self.pool.recorder = recorder
        if self.obs is not None:
            recorder.attach(tracer=self.obs.tracer,
                            registry=self.obs.registry)
        return recorder

    # -- crash injection ---------------------------------------------------

    def inject_crash(self, after_ops: int):
        """Die (raise ``SimulatedCrash``) after ``after_ops`` further
        emulated stores; 0 dies before the next store lands."""
        self._ops_budget = int(after_ops)

    def _store(self):
        """One emulated store op is about to land; the crash point sits
        BEFORE it (the op that would exceed the budget never lands)."""
        if self._ops_budget is not None:
            if self._ops_budget <= 0:
                self.dead = True
                raise SimulatedCrash("injected crash mid-flush")
            self._ops_budget -= 1

    def _account(self, nbytes: int, rows: int = 0):
        self.flushed_bytes += nbytes
        self.last_flush_bytes += nbytes
        self.flushed_rows += rows
        self.last_flush_rows += rows

    def _count_staged(self, nbytes: int, seconds: float, moved: int):
        """Count ``nbytes`` staged (the reference's measure), ``moved``
        bytes copied to the host and the seconds it took."""
        self.staged_bytes += nbytes
        self.last_staged_bytes += nbytes
        self.transferred_bytes += moved
        self.last_transferred_bytes += moved
        self.stage_seconds += seconds
        self.last_stage_seconds += seconds

    @staticmethod
    def _host(name: str, t: torch.Tensor) -> np.ndarray:
        """One host tensor as numpy in the reference's dtype of plane
        ``name`` (uint32 planes view their int32 bits as uint32)."""
        a = t.numpy()
        return a.view(np.uint32) if layout.PLANE_DTYPES[name] == "u32" else a

    def _stage(self, name: str, t: torch.Tensor) -> np.ndarray:
        """Materialize one device tensor of plane ``name`` host-side,
        counting the bytes — the flush's host-staging cost the O(dirty)
        gate audits."""
        t0 = time.perf_counter()
        out = self._host(name, t.cpu())
        self._count_staged(out.nbytes, time.perf_counter() - t0, out.nbytes)
        return out

    def _stage_gathered(self, state: DashState, names, ids: np.ndarray
                        ) -> dict:
        """Stage ONLY the dirty rows of the big record planes: one device
        gather per plane, one host transfer per plane of just those rows.
        Counts the reference's pow2-padded gather bytes. Returns
        row-indexable proxies."""
        t0 = time.perf_counter()
        pad = 1
        while pad < max(int(ids.size), 1):
            pad <<= 1
        planes = tuple(getattr(state, n).reshape(self.pool.spec(n).rows, -1)
                       for n in names)
        idt = torch.from_numpy(np.ascontiguousarray(ids, dtype=np.int64)).to(
            planes[0].device)
        out = _gather_rows(planes, idt)
        nbytes = sum(pad * self.pool.spec(n).row_nbytes for n in names)
        self._count_staged(nbytes, time.perf_counter() - t0,
                           sum(g.numel() * g.element_size() for g in out))
        return {n: _GatheredRows(ids, self._host(n, g)) for n, g in zip(names, out)}

    def _write_rows(self, name: str, ids: np.ndarray, live: np.ndarray):
        if ids.size == 0:
            return
        self._store()
        self._account(self.pool.write_rows(name, ids, live), ids.size)

    def _write_plane(self, name: str, live: np.ndarray):
        self._store()
        self._account(self.pool.write_plane(name, live))

    # -- fence with bounded retry / graceful degradation -------------------

    def _fence(self):
        """Fence with bounded retry + exponential backoff on transient
        flush errors (EIO and friends). The mapping still holds every
        store, so a retried msync re-persists them — retrying the fence IS
        retrying the writes. Past the budget the engine goes DEGRADED and
        raises ``WritebackDegraded``; the pool keeps its last committed
        image and serving continues volatile."""
        delay = self.retry_base_s
        attempt = 0
        while True:
            try:
                self.pool.fence()
                return
            except SimulatedCrash:
                self.dead = True
                raise
            except FlushError as e:
                self.flush_io_errors += 1
                if attempt >= self.retry_limit:
                    self.degraded = True
                    if self.recorder is not None:
                        # durable degraded instant: rides the recovery
                        # flush's window (or the torn story, if we crash)
                        self.recorder.record("degraded",
                                             io_errors=self.flush_io_errors,
                                             err=getattr(e, "err", None))
                    raise WritebackDegraded(
                        f"fence on {self.pool.path} failed "
                        f"{attempt + 1}x (last: {e}); engine degraded"
                    ) from e
                attempt += 1
                self.flush_retries += 1
                time.sleep(delay)
                delay *= 2

    def try_recover(self, state: DashState) -> bool:
        """Attempt DEGRADED -> healthy: probe the fence once and, if the
        device answers, resynchronize the pool with one force-full flush
        (the degraded window may have left partial uncommitted phases in
        the mapping; a full rewrite + commit supersedes them). Returns
        True when the engine is healthy afterwards."""
        if self.dead:
            return False
        if not self.degraded:
            return True
        try:
            self.pool.fence()
        except SimulatedCrash:
            self.dead = True
            raise
        except FlushError:
            return False
        self.degraded = False
        if self.recorder is not None:
            # rides the resync flush's own window just below
            self.recorder.record("recovery", recoveries=self.recoveries + 1)
        try:
            self.flush(state, DirtyHint(segments=set(), dir=False, full=True))
        except WritebackDegraded:
            return False
        self.recoveries += 1
        return True

    def _write_blackbox_window(self):
        """Phase 5.5: stage the flight-recorder window for the flush about
        to commit — ordered BEFORE the last pre-commit fence, so the
        commit can never become durable ahead of the window it references
        (recorder entries are never newer than the data they describe).
        The window goes to the slot the CURRENT committed superblock does
        not reference; a tear here leaves the committed story intact.
        Returns the descriptor for ``pool.commit`` (``None``s = carry the
        committed descriptor forward: no recorder, or a failed write —
        counted, never fatal: telemetry must not take down the flush)."""
        rec = self.recorder
        if rec is None:
            return None, None, None
        self._store()                 # one emulated store op (crash point)
        try:
            seq = self.pool.sb.flush_seq + 1
            slot, nbytes, crc = self.pool.write_blackbox(seq,
                                                         rec.snapshot(seq))
        except (SimulatedCrash, FlushError):
            raise
        except Exception:
            rec.note_write_failure()
            return None, None, None
        self._account(nbytes)
        return slot, nbytes, crc

    # -- the flush ---------------------------------------------------------

    def flush(self, state: DashState, hint: Optional[DirtyHint] = None) -> int:
        """Write every dirty plane of ``state`` to the pool in the fenced
        phase order above; returns bytes written. O(dirty) I/O: row-granular
        for the record planes (version diff vs the pool), compare-then-copy
        for directory/segment metadata, always-copy for scalars."""
        if self.dead:
            raise SimulatedCrash("writeback engine died in a previous flush")
        if self.degraded:
            self.degraded_flushes += 1
            raise WritebackDegraded(
                f"pool {self.pool.path} is degraded; call try_recover first")
        tr = self.obs.tracer if self.obs is not None else None
        fsp = tr.begin("flush", "persist") if tr is not None else None
        try:
            return self._flush_inner(state, hint, tr, fsp)
        except WritebackDegraded:
            if tr is not None:
                tr.end(fsp, degraded=True)
            raise

    def _flush_inner(self, state: DashState, hint, tr, fsp) -> int:
        t0 = time.perf_counter()
        self.last_flush_bytes = 0
        self.last_flush_rows = 0
        self.last_heap_tail_rows = 0
        self.last_staged_bytes = 0
        self.last_transferred_bytes = 0
        self.last_stage_seconds = 0.0
        cfg = self.cfg
        NB, BT, SL = cfg.num_buckets, cfg.buckets_total, cfg.num_slots

        # host staging is O(dirty), not O(pool): only the narrow planes
        # (4-byte rows, routing, scalars — a few percent of the pool) are
        # copied whole; the wide record planes are staged row-granularly
        # by a device gather once the dirty set is known. The pointer-mode
        # key heap is device-sliced at its tail (never copied whole).
        small = tuple(n for n in DashState._fields
                      if n not in GATHER_BT + GATHER_NB
                      and not (n == "key_heap" and cfg.pointer_mode))
        live = {n: self._stage(n, getattr(state, n)) for n in small}
        full = (self.pool.sb.flush_seq == 0
                or (hint is not None and hint.full))

        # dirty rows = version-plane diff against the pool (the durable
        # mirror of engine.changed_rows); force-full writes every row
        disk_ver = self.pool.rows("version").reshape(-1)
        live_ver = live["version"].reshape(-1)
        if full:
            ids_bt = np.arange(live_ver.size, dtype=np.int64)
        else:
            ids_bt = np.flatnonzero(disk_ver != live_ver).astype(np.int64)
        seg_of = ids_bt // BT
        b_of = ids_bt % BT
        nb_mask = b_of < NB
        ids_nb = (seg_of * NB + b_of)[nb_mask]
        self.last_dirty_rows = int(ids_bt.size)

        if hint is not None and not full and ids_bt.size:
            seen = set(np.unique(seg_of).tolist())
            self.flush_hint_misses += len(seen - hint.segments)

        live.update(self._stage_gathered(state, GATHER_BT, ids_bt))
        live.update(self._stage_gathered(state, GATHER_NB, ids_nb))
        rowview = {n: live[n].reshape(self.pool.spec(n).rows, -1)
                   for n in DATA_BT + PUBLISH_BT + layout.NB_PLANES}

        # -- classification vs the pool's current contents -----------------
        disk_bits = _slot_bits(self.pool.rows("meta").reshape(-1)[ids_bt], SL)
        live_bits = _slot_bits(live["meta"].reshape(-1)[ids_bt], SL)
        changed = np.zeros_like(disk_bits)
        for n in ("key_hi", "key_lo"):
            changed |= (self.pool.rows(n)[ids_bt]
                        != live[n].reshape(-1, SL)[ids_bt])
        # fp rows are lane-padded to 16; compare the record slots only
        changed |= (self.pool.rows("fp")[ids_bt][:, :SL]
                    != live["fp"].reshape(-1, 16)[ids_bt][:, :SL])
        # any POOL-allocated slot with changed key/fp bytes forces the log:
        # an in-place data store there would scramble a visible record even
        # if the live row no longer keeps that slot
        rebuilt = (disk_bits & changed).any(axis=1)
        loses = (disk_bits & ~live_bits).any(axis=1)
        a_bt = ids_bt[~rebuilt & ~loses]        # append rows
        c_bt = ids_bt[~rebuilt & loses]         # clear rows
        r_bt = ids_bt[rebuilt]                  # rebuilt rows -> redo log
        a_nb = ids_nb[(~rebuilt & ~loses)[nb_mask]]
        c_nb = ids_nb[(~rebuilt & loses)[nb_mask]]
        r_nb = ids_nb[rebuilt[nb_mask]]

        log_routing = r_bt.size > 0
        routing_dirty = not log_routing and (full or any(
            not np.array_equal(self.pool.plane(n), live[n])
            for n in layout.DIR_PLANES + layout.SEG_META_PLANES))

        # phase 1: data planes of the in-place rows (new bytes land only in
        # pool-free slots — invisible until a publish word flips)
        ip_bt = np.concatenate([a_bt, c_bt])
        ip_nb = np.concatenate([a_nb, c_nb])
        for n in DATA_BT:
            self._write_rows(n, ip_bt, rowview[n])
        self._write_rows("ofp", ip_nb, rowview["ofp"])
        # pointer mode: the key heap is append-only (handles are bump-
        # allocated), so only the tail above the pool's durable high water
        # needs writing — O(heap-tail) instead of O(heap), and it lands in
        # phase 1 so any handle a later phase publishes already has its
        # heap row durable
        if cfg.pointer_mode and cfg.key_heap_size > 0:
            disk_top = int(self.pool.plane("heap_top")[()])
            live_top = int(live["heap_top"])
            lo = 0 if full else max(0, min(disk_top, live_top))
            hi = int(state.key_heap.shape[0]) if full else live_top
            if hi > lo:
                # device-sliced tail: stage the [lo, hi) rows only — the
                # heap is append-only, so everything below lo is already
                # durable and never crosses the host boundary again
                tail = self._stage("key_heap", state.key_heap[lo:hi])
                self._store()
                self._account(self.pool.write_span("key_heap", lo, hi, tail))
                self.last_heap_tail_rows = hi - lo
        self._fence()

        # phase 2: publish the append rows
        self._write_rows("meta", a_bt, rowview["meta"])
        self._write_rows("ometa", a_nb, rowview["ometa"])
        self._write_rows("version", a_bt, rowview["version"])
        self._fence()

        # phase 3: routing + per-segment metadata + scalars, in place only
        # when no rebuilt rows ride this flush (else they go via the log)
        if not log_routing:
            if routing_dirty:
                for n in layout.DIR_PLANES + layout.SEG_META_PLANES:
                    if full or not np.array_equal(self.pool.plane(n), live[n]):
                        self._write_plane(n, live[n])
            for n in layout.SCALAR_PLANES:
                if n == "key_heap" and cfg.pointer_mode:
                    continue           # tail already written in phase 1
                self._write_plane(n, live[n])
            self._fence()

        # phase 4: clear rows — records may leave, their displacement copies
        # (if any) are already published. In place ONLY when no log rides
        # this flush: with rebuilt rows, a moved record's destination may
        # exist solely in the not-yet-committed log, so a durable clear
        # before the commit fence can orphan an acked record (the chaos
        # matrix found exactly this: torn fence between the clears and the
        # commit). With a log, the clears join the logged set instead and
        # land atomically with the commit at apply time.
        if not log_routing:
            self._write_rows("meta", c_bt, rowview["meta"])
            self._write_rows("ometa", c_nb, rowview["ometa"])
            self._write_rows("version", c_bt, rowview["version"])
            bb_slot, bb_nbytes, bb_crc = self._write_blackbox_window()
            self._fence()

        # phase 5: stage rebuilt (+ clear) rows (+ routing) in the redo log
        log_bt = log_nb = 0
        log_crc = 0
        if log_routing:
            l_bt = np.concatenate([r_bt, c_bt])
            l_nb = np.concatenate([r_nb, c_nb])
            self._store()
            nbytes, log_crc = self.pool.write_log(l_bt, l_nb, True, live)
            self._account(nbytes, l_bt.size)
            self.logged_rows += int(l_bt.size)
            log_bt, log_nb = int(l_bt.size), int(l_nb.size)
            # phase 5.5: the flight-recorder window rides this flush's last
            # pre-commit fence (same slot discipline as the no-log branch)
            bb_slot, bb_nbytes, bb_crc = self._write_blackbox_window()
            self._fence()

        # phase 6: commit record (acknowledgment point)
        self._store()
        self.pool.commit(gver=int(live["gver"]), clean=bool(live["clean"]),
                         log_bt=log_bt, log_nb=log_nb,
                         log_routing=log_routing, log_crc=log_crc,
                         bb_slot=bb_slot, bb_nbytes=bb_nbytes, bb_crc=bb_crc)
        self._fence()
        if tr is not None:
            tr.instant("redo_log_commit", "persist", parent=fsp,
                       logged=log_routing, log_rows=log_bt)

        # phase 7: apply the committed log to the home rows (idempotent —
        # a crash inside the apply is redone at the next open)
        # phase 8: clear the log descriptor with a second commit. After
        # this, a later flush's staging (phase 5) can never be confused
        # with a committed-but-unapplied log — so a descriptor whose CRC
        # fails at open is REAL log-region media loss, not staleness
        # (pool.apply_log sets ``log_lost`` on exactly that signal).
        if log_routing:
            self._store()
            self._account(self.pool.apply_log())
            self._fence()
            self._store()
            self.pool.commit(gver=int(live["gver"]),
                             clean=bool(live["clean"]))
            self._fence()
            if tr is not None:
                tr.instant("log_apply", "persist", parent=fsp)

        self.flushes += 1
        self.last_flush_seconds = time.perf_counter() - t0
        self.flush_seconds += self.last_flush_seconds
        if tr is not None:
            tr.end(fsp, bytes=self.last_flush_bytes,
                   rows=self.last_flush_rows,
                   dirty_rows=self.last_dirty_rows)
            self.last_flush_sid = fsp.sid if fsp is not None else None
        return self.last_flush_bytes

    def stats(self) -> dict:
        return {
            "flushes": self.flushes,
            "flushed_bytes": self.flushed_bytes,
            "last_flush_bytes": self.last_flush_bytes,
            "staged_bytes": self.staged_bytes,
            "last_staged_bytes": self.last_staged_bytes,
            "flushed_rows": self.flushed_rows,
            "last_dirty_rows": self.last_dirty_rows,
            "last_heap_tail_rows": self.last_heap_tail_rows,
            "logged_rows": self.logged_rows,
            "flush_seconds": self.flush_seconds,
            "flush_hint_misses": self.flush_hint_misses,
            "flush_io_errors": self.flush_io_errors,
            "flush_retries": self.flush_retries,
            "degraded": self.degraded,
            "degraded_flushes": self.degraded_flushes,
            "recoveries": self.recoveries,
            "fences": self.pool.fences,
            "pool_bytes": self.pool.plane_bytes,
            "flush_seq": self.pool.sb.flush_seq,
        }


class Scrubber:
    """Incremental background media scrub over the pool's checksummed
    planes. Each ``tick`` verifies a window of bucket rows (every record
    plane at those rows) against the stored per-row checksums; a mismatch
    is media rot that crept in SINCE the row was written (data + checksum
    travel in one store op, so they never disagree at a store boundary).

    While the table is live the serving state is authoritative, so a bad
    row is repaired in place from ``state`` — detection latency is then
    bounded by one full pass (``rows_total / rows_per_tick`` ticks).
    Repairs are fenced immediately.
    """

    def __init__(self, wb: WritebackEngine, rows_per_tick: int = 512):
        self.wb = wb
        self.rows_per_tick = int(rows_per_tick)
        self.bt_rows = wb.pool.csum.rows_of("version")
        self.nb_rows = wb.pool.csum.rows_of("ometa")
        self.rows_total = self.bt_rows + self.nb_rows
        self.pos = 0                  # scan cursor in [0, rows_total)
        self.cycles = 0               # completed full passes
        self.scanned_rows = 0
        self.mismatched_rows = 0
        self.repaired_rows = 0

    def _scrub_group(self, names, lo, hi, state) -> int:
        pool = self.wb.pool
        ids = np.arange(lo, hi, dtype=np.int64)
        repaired = 0
        for n in names:
            have = layout.np_row_checksum(pool.rows(n)[ids])
            bad = ids[have != pool.csum_rows(n)[ids]]
            if bad.size:
                self.mismatched_rows += int(bad.size)
                # repair needs the live bytes of the BAD rows only — a
                # device gather of those rows, not a whole-plane copy
                rows = self.wb._stage_gathered(state, (n,), bad)[n]
                pool.write_rows(n, bad, rows)
                repaired += int(bad.size)
        return repaired

    def tick(self, state: DashState) -> dict:
        """Scrub the next window; returns the per-tick report. Safe to call
        while the engine is degraded — repairs are volatile stores either
        way until a fence succeeds, and the fence failure is swallowed
        (the rows stay dirty-diffable; recovery's force-full rewrites
        them)."""
        if self.wb.dead or self.rows_total == 0:
            return {"scanned": 0, "repaired": 0}
        lo = self.pos
        hi = min(lo + self.rows_per_tick, self.rows_total)
        repaired = 0
        if lo < self.bt_rows:
            repaired += self._scrub_group(
                layout.BT_PLANES, lo, min(hi, self.bt_rows), state)
        if hi > self.bt_rows:
            repaired += self._scrub_group(
                layout.NB_PLANES, max(lo - self.bt_rows, 0),
                hi - self.bt_rows, state)
        self.scanned_rows += hi - lo
        self.repaired_rows += repaired
        self.pos = hi % self.rows_total
        if self.pos == 0:
            self.cycles += 1
        obs = self.wb.obs
        if obs is not None:
            obs.registry.counter("scrub.scanned_rows").inc(hi - lo)
            if repaired:
                obs.registry.counter("scrub.repaired_rows").inc(repaired)
                obs.tracer.instant("scrub_repair", "persist",
                                   rows=repaired, window=(lo, hi))
        if repaired:
            try:
                self.wb.pool.fence()
            except SimulatedCrash:
                self.wb.dead = True
                raise
            except FlushError:
                pass                  # degraded device; repair stays volatile
        return {"scanned": hi - lo, "repaired": repaired}

    def stats(self) -> dict:
        return {"scrub_cycles": self.cycles,
                "scrub_scanned_rows": self.scanned_rows,
                "scrub_mismatched_rows": self.mismatched_rows,
                "scrub_repaired_rows": self.repaired_rows}
