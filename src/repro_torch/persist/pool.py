"""Emulated-PM pool file: memory-mapped plane regions + checksummed superblock.

Ported from ``repro.persist.pool``: the file format is the reference's, byte
for byte, so either package opens a pool the other wrote. The pool holds
numpy arrays in the reference's dtypes; only ``read_state`` builds tensors
(on the table's device, uint32 planes as int32 tensors with the same bits).

The pool is the durable mirror of one ``DashState`` (the paper's PM pool,
emulated with ``np.memmap`` over an ordinary file — on a PM-backed mount the
same code is real persistent memory programming modulo the DAX flush path):

  * byte 0: two 2 KB **superblock slots**, written alternately with a
    monotonic ``flush_seq`` and a CRC32 over the payload. A torn superblock
    write can only corrupt the slot being written; ``open`` picks the valid
    slot with the highest sequence — the 8-byte-atomic commit record of real
    PM, emulated at slot granularity.
  * a **per-row checksum region**: one uint32 content checksum per
    bucket row of every record plane (``layout.CSUM_PLANES``), maintained
    atomically with the row's store (same emulated store op), verified by
    ``verify_checksums`` at reopen and by the background scrubber. Checksums
    detect *media* faults — torn cachelines inside one store, bit rot — which
    the crash-only model (torn flushes at store boundaries) never exercises.
  * from there: one region per state plane, laid out by
    ``core/layout.py:pool_plane_specs`` (the plane↔file-offset map) in
    ``DashState._fields`` order, 64-byte aligned. Record planes are
    addressed at bucket-row granularity: the flattened row index of
    ``version[..., b]`` addresses the same row in every BT plane — the same
    row index space the COW publish scatters.

The pool itself is policy-free: ``write_rows`` / ``write_plane`` land bytes
in the mapping (emulated stores), ``fence`` flushes the mapping (emulated
``sfence`` after a ``clwb`` train), ``commit`` writes the next superblock
slot. The ORDER of those calls — what makes a torn crash recoverable — is
the writeback engine's contract (persist/writeback.py).

Fault injection: a ``persist/faults.py:FaultPlan`` attached at
create/open hooks the fence path (torn msyncs, transient EIO) and the
create path (ENOSPC). While a tear is scheduled the pool journals the
pre-image of every store since the last fence, so the plan can revert a
seeded subset of the written cachelines — emulating the lines that never
left the CPU's write pending queue.

The superblock payload also carries the table config + mode, so ``open``
reconstructs the exact ``DashConfig`` the pool was created with: a reopened
pool needs no out-of-band schema.
"""
from __future__ import annotations

import dataclasses
import json
import os
import zlib
from typing import Optional

import numpy as np

import torch

from repro_torch.core import layout
from repro_torch.core.layout import DashConfig, DashState

MAGIC = b"DASHPM01"
FORMAT = 1
SLOT_BYTES = 2048                      # two slots fit in SUPERBLOCK_BYTES
assert 2 * SLOT_BYTES <= layout.SUPERBLOCK_BYTES
_HDR = 16                              # magic(8) + crc(4) + payload_len(4)

#: above this many scattered rows, journal the whole plane span instead of
#: per-row extents (bounds journaling cost on full flushes)
_JOURNAL_ROW_CAP = 1024


class PoolError(RuntimeError):
    pass


class FlushError(PoolError):
    """The fence (msync analog) or a pool write failed at the media level.
    Carries ``err`` (an errno) so the writeback's retry policy can tell
    transient faults (EIO) from permanent ones. Stores issued before the
    failed fence are NOT durable; they remain in the mapping, so a retried
    fence re-persists them — which is exactly what the writeback's bounded
    retry-with-backoff does."""

    def __init__(self, msg: str, err: Optional[int] = None):
        super().__init__(msg)
        self.err = err


@dataclasses.dataclass
class Superblock:
    """The durable commit record. ``clean`` is authoritative over the state
    region's ``clean`` scalar at reopen (a torn scalar flush can leave the
    plane region stale; the superblock is written last, post-fence).

    ``log_*`` describe the redo-log contents this commit staged (SMO-rebuilt
    rows + routing planes): committed-but-unapplied entries are re-applied
    at open (idempotent — the log holds absolute row contents). The
    writeback clears the descriptor with a second commit right after
    applying (phase 8), so a descriptor that survives to open marks a crash
    inside the tiny commit→apply→commit window, not a stale leftover."""
    mode: str
    cfg: dict
    flush_seq: int = 0                 # 0 = created, never flushed
    gver: int = 1
    clean: bool = True
    log_bt: int = 0                    # logged BT-row entries
    log_nb: int = 0                    # logged NB-row entries
    log_routing: bool = False          # routing/scalar planes logged too
    log_crc: int = 0                   # crc32 over the used log bytes
    # durable quarantine evidence: rows media rot has cost records
    # in, committed BEFORE the reopen's healing flush rewrites them — a
    # crash mid-recovery must never turn an explicit loss into a silent
    # one. Capped (slot budget); ``lost_overflow`` marks a truncated list.
    lost_bt: list = dataclasses.field(default_factory=list)
    lost_nb: list = dataclasses.field(default_factory=list)
    lost_records: int = 0              # cumulative cleared-record count
    lost_overflow: bool = False
    # flight-recorder descriptor: which blackbox slot holds the
    # observability window this commit covers, and its payload bytes/CRC.
    # Committed atomically with flush_seq, so the referenced window is
    # never newer than the data the commit acknowledges. -1 = no window.
    bb_slot: int = -1
    bb_nbytes: int = 0
    bb_crc: int = 0

    def encode(self) -> bytes:
        payload = json.dumps(dataclasses.asdict(self)).encode()
        if _HDR + len(payload) > SLOT_BYTES:
            raise PoolError("superblock payload too large")
        hdr = MAGIC + zlib.crc32(payload).to_bytes(4, "little") + \
            len(payload).to_bytes(4, "little")
        return hdr + payload

    @classmethod
    def decode(cls, raw: bytes) -> Optional["Superblock"]:
        """None on an invalid/torn slot (bad magic, length, or CRC)."""
        if raw[:8] != MAGIC:
            return None
        crc = int.from_bytes(raw[8:12], "little")
        n = int.from_bytes(raw[12:16], "little")
        if n <= 0 or _HDR + n > SLOT_BYTES:
            return None
        payload = raw[_HDR:_HDR + n]
        if zlib.crc32(payload) != crc:
            return None
        try:
            return cls(**json.loads(payload.decode()))
        except (ValueError, TypeError):
            return None


class PmPool:
    """One memory-mapped pool file holding one table's planes.

    ``create`` allocates and zero-fills (a fresh PM allocation); ``open``
    maps an existing file and validates/loads the superblock. Plane views
    write through the mapping; ``fence()`` is the ordering point.
    """

    def __init__(self, path: str, sb: Superblock, faults=None):
        self.path = path
        self.sb = sb
        self.obs = None               # observability bundle, set via writeback
        self.recorder = None          # flight recorder, set via writeback
        self.cfg = DashConfig(**sb.cfg)
        self.mode = sb.mode
        self.specs, self.log, self.bbox, self.csum, self.total_bytes = \
            layout.pool_plane_specs(self.cfg, self.mode)
        self.plane_bytes = sum(s.nbytes for s in self.specs)
        self._by_name = {s.name: s for s in self.specs}
        have = os.path.getsize(path)
        if have < self.total_bytes:
            raise PoolError(
                f"pool file truncated: {path} holds {have} bytes but the "
                f"superblock config needs {self.total_bytes} "
                f"(mode={self.mode!r}); refusing to map a short file")
        self._mm = np.memmap(path, dtype=np.uint8, mode="r+",
                             shape=(self.total_bytes,))
        self._views = {}
        for s in self.specs:
            raw = self._mm[s.offset:s.offset + s.nbytes]
            self._views[s.name] = raw.view(s.dtype).reshape(s.shape)
        self._csum_views = {}
        for name, off, rows in self.csum.entries:
            self._csum_views[name] = self._mm[off:off + 4 * rows].view(
                np.uint32)
        self.faults = faults
        self._journal = []             # (offset, pre-image bytes) since fence
        self.fences = 0
        self.log_lost = False          # committed log failed its CRC at open
        self.apply_log()               # redo a committed-but-unapplied log

    # -- lifecycle ---------------------------------------------------------

    @classmethod
    def create(cls, path: str, cfg: DashConfig, mode: str = "eh",
               faults=None) -> "PmPool":
        if os.path.exists(path):
            raise PoolError(f"pool exists: {path}")
        sb = Superblock(mode=mode, cfg=dataclasses.asdict(cfg))
        _, _, _, _, total = layout.pool_plane_specs(cfg, mode)
        try:
            if faults is not None:
                faults.on_create(path, total)
            with open(path, "wb") as f:
                f.truncate(total)
        except OSError as e:
            # never leave a partial pool file behind a failed allocation
            if os.path.exists(path):
                os.unlink(path)
            raise PoolError(
                f"pool create failed at {path} ({total} bytes): {e}") from e
        pool = cls(path, sb, faults=faults)
        pool._write_slot(0, sb)
        pool.fence()
        return pool

    @classmethod
    def open(cls, path: str, faults=None) -> "PmPool":
        if not os.path.exists(path):
            raise PoolError(f"no pool at {path}")
        size = os.path.getsize(path)
        if size < 2 * SLOT_BYTES:
            raise PoolError(
                f"pool file truncated: {path} holds {size} bytes, smaller "
                f"than the {2 * SLOT_BYTES}-byte superblock region")
        with open(path, "rb") as f:
            head = f.read(2 * SLOT_BYTES)
        slots = [Superblock.decode(head[i * SLOT_BYTES:(i + 1) * SLOT_BYTES])
                 for i in range(2)]
        valid = [s for s in slots if s is not None]
        if not valid:
            raise PoolError(
                f"no valid superblock in {path}: both slots failed "
                f"magic/CRC validation (corrupt or not a pool file)")
        sb = max(valid, key=lambda s: s.flush_seq)
        return cls(path, sb, faults=faults)

    def close(self):
        self.fence()
        self._views.clear()
        self._csum_views.clear()
        self._mm = None

    # -- emulated stores ---------------------------------------------------

    def plane(self, name: str) -> np.ndarray:
        """Writable view of one plane region (writes land in the mapping)."""
        return self._views[name]

    def spec(self, name: str) -> layout.PlaneSpec:
        return self._by_name[name]

    def rows(self, name: str) -> np.ndarray:
        """Row-major (rows, row_bytes…) view of a record plane."""
        s = self._by_name[name]
        return self._views[name].reshape(s.rows, -1)

    def csum_rows(self, name: str) -> np.ndarray:
        """Writable uint32 view of one plane's per-row checksum words."""
        return self._csum_views[name]

    def _journaling(self) -> bool:
        return self.faults is not None and self.faults.journal_needed()

    def _j_span(self, off: int, nbytes: int):
        """Journal the pre-image of [off, off+nbytes) for tear-revert."""
        self._journal.append((off, bytes(self._mm[off:off + nbytes])))

    def _j_rows(self, name: str, ids: np.ndarray):
        s = self._by_name[name]
        if ids.size > _JOURNAL_ROW_CAP:
            self._j_span(s.offset, s.nbytes)
            coff = self.csum.offset_of(name) if name in self._csum_views \
                else None
            if coff is not None:
                self._j_span(coff, 4 * s.rows)
            return
        coff = self.csum.offset_of(name) if name in self._csum_views else None
        rb = s.row_nbytes
        for i in np.asarray(ids).reshape(-1):
            i = int(i)
            self._j_span(s.offset + i * rb, rb)
            if coff is not None:
                self._j_span(coff + 4 * i, 4)

    def write_rows(self, name: str, ids: np.ndarray, live_rows: np.ndarray
                   ) -> int:
        """Scatter dirty rows of ``live_rows`` (same row-major layout) into
        the plane region; returns bytes written. One call = one emulated
        ordered-store op (a clwb train over the dirty lines). For
        checksummed planes the rows' checksum words are part of the same
        op — checksums never lag the data at a store boundary."""
        if ids.size == 0:
            return 0
        if self._journaling():
            self._j_rows(name, ids)
        src = live_rows[ids]
        self.rows(name)[ids] = src
        n = int(ids.size) * self._by_name[name].row_nbytes
        cs = self._csum_views.get(name)
        if cs is not None:
            cs[ids] = layout.np_row_checksum(src)
            n += 4 * int(ids.size)
        return n

    def write_plane(self, name: str, live: np.ndarray) -> int:
        """Overwrite one whole plane region; returns bytes written."""
        s = self._by_name[name]
        if self._journaling():
            self._j_span(s.offset, s.nbytes)
            if name in self._csum_views:
                self._j_span(self.csum.offset_of(name), 4 * s.rows)
        view = self._views[name]
        view[...] = live.reshape(view.shape)
        n = s.nbytes
        cs = self._csum_views.get(name)
        if cs is not None:
            cs[...] = layout.np_row_checksum(self.rows(name))
            n += 4 * s.rows
        return n

    def write_span(self, name: str, lo: int, hi: int, tail: np.ndarray
                   ) -> int:
        """Overwrite the contiguous leading-axis span ``[lo, hi)`` of one
        plane with ``tail`` — the span's rows only (shape ``(hi-lo, ...)``),
        so the caller stages just the pointer-mode key heap's append-only
        tail, never the whole heap. One emulated store op; returns bytes
        written."""
        if hi <= lo:
            return 0
        s = self._by_name[name]
        view = self._views[name]
        per_row = s.nbytes // view.shape[0]
        if self._journaling():
            self._j_span(s.offset + lo * per_row, (hi - lo) * per_row)
        view[lo:hi] = np.asarray(tail).reshape(view[lo:hi].shape)
        return (hi - lo) * per_row

    def fence(self):
        """Ordering point: every store issued before this is durable before
        any store issued after (msync as the clwb+sfence analog). Raises
        ``FlushError`` when the flush fails — the return code is checked
        and propagated, not swallowed, so acked-durability is never a lie
        on a failing device. An attached FaultPlan may tear (revert seeded
        cachelines + simulated crash) or inject transient EIO here."""
        if self._mm is None:
            return
        if self.faults is not None:
            self.faults.on_fence(self)  # may raise FlushError / TornPersist
        try:
            self._mm.flush()
        except (OSError, ValueError) as e:
            raise FlushError(f"msync failed on {self.path}: {e}",
                             err=getattr(e, "errno", None)) from e
        self.fences += 1
        if self._journal:
            self._journal.clear()

    # -- media verification ------------------------------------------------

    def verify_checksums(self, names=None) -> dict:
        """Recompute every row checksum of the named planes (default: all
        checksummed planes) against the stored checksum words. Returns
        ``{"bt": row_ids, "nb": row_ids, "planes": {name: row_ids}}`` —
        the union of mismatching rows per record-row space. A mismatch
        means a sub-store media fault (torn cacheline, bit rot): the crash
        matrix alone can never produce one, because data + checksum travel
        in the same emulated store op."""
        bad_bt, bad_nb, per_plane = set(), set(), {}
        for name in (names or layout.CSUM_PLANES):
            have = layout.np_row_checksum(self.rows(name))
            bad = np.flatnonzero(have != self._csum_views[name])
            if bad.size:
                per_plane[name] = bad
                (bad_bt if name in layout.BT_PLANES else bad_nb).update(
                    int(i) for i in bad)
        return {"bt": np.array(sorted(bad_bt), dtype=np.int64),
                "nb": np.array(sorted(bad_nb), dtype=np.int64),
                "planes": per_plane}

    # -- redo log ----------------------------------------------------------
    # SMO-rebuilt rows are staged here instead of being rewritten in place:
    # an in-place segment rebuild overwrites slots still claimed by the old
    # meta word, so no store order makes it crash-atomic. The log section
    # is struct-of-arrays: int64 row ids, then each plane's logged rows
    # contiguously; routing planes (when logged) are whole-plane snapshots
    # (``layout.log_routing_planes`` — the pointer-mode heap is exempt).

    def _encode_log(self, ids_bt, ids_nb, routing: bool, live: dict) -> bytes:
        parts = [np.ascontiguousarray(ids_bt.astype(np.int64))]
        for n in layout.BT_PLANES:
            parts.append(np.ascontiguousarray(
                live[n].reshape(self.log.bt_rows, -1)[ids_bt]))
        parts.append(np.ascontiguousarray(ids_nb.astype(np.int64)))
        for n in layout.NB_PLANES:
            parts.append(np.ascontiguousarray(
                live[n].reshape(self.log.nb_rows, -1)[ids_nb]))
        if routing:
            for n in layout.log_routing_planes(self.cfg):
                parts.append(np.ascontiguousarray(live[n]))
        return b"".join(p.tobytes() for p in parts)

    def write_log(self, ids_bt, ids_nb, routing: bool, live: dict) -> tuple:
        """Stage rebuilt rows (+ optionally the routing planes) into the
        log region; returns (nbytes, crc) for the commit record. One
        emulated store op (the caller fences before committing)."""
        enc = self._encode_log(ids_bt, ids_nb, routing, live)
        if self._journaling():
            self._j_span(self.log.offset, len(enc))
        self._mm[self.log.offset:self.log.offset + len(enc)] = \
            np.frombuffer(enc, dtype=np.uint8)
        return len(enc), zlib.crc32(enc)

    def apply_log(self):
        """Redo a committed log: scatter the logged rows/planes into their
        home regions (checksum words updated with each scatter — the redo
        heals both data and checksums). Idempotent (absolute contents);
        called at open and by the writeback right after its commit fence.

        With the phase-8 descriptor-clearing commit a CRC mismatch
        on a committed descriptor is no longer explainable as a stale
        leftover: it marks log-region media loss. We skip the apply (never
        scatter garbage), set ``log_lost``, and let the reopen path surface
        the affected segments in the lost-keys report."""
        sb = self.sb
        if not (sb.log_bt or sb.log_nb or sb.log_routing):
            return 0
        off = self.log.offset
        raw = self._mm[off:off + self.log.nbytes]
        if zlib.crc32(raw[:self._log_used_bytes(sb)].tobytes()) != sb.log_crc:
            self.log_lost = True
            return 0                   # never apply a corrupt log
        pos = 0

        def take(nbytes):
            nonlocal pos
            out = raw[pos:pos + nbytes]
            pos += nbytes
            return out

        applied = 0
        ids_bt = take(8 * sb.log_bt).view(np.int64)
        for n in layout.BT_PLANES:
            rb = self._by_name[n].row_nbytes
            rows = take(rb * sb.log_bt).reshape(sb.log_bt, rb)
            if self._journaling() and sb.log_bt:
                self._j_rows(n, ids_bt)
            self.rows(n).view(np.uint8).reshape(
                self.log.bt_rows, -1)[ids_bt] = rows
            if sb.log_bt:
                self._csum_views[n][ids_bt] = layout.np_row_checksum(rows)
            applied += rows.nbytes
        ids_nb = take(8 * sb.log_nb).view(np.int64)
        for n in layout.NB_PLANES:
            rb = self._by_name[n].row_nbytes
            rows = take(rb * sb.log_nb).reshape(sb.log_nb, rb)
            if self._journaling() and sb.log_nb:
                self._j_rows(n, ids_nb)
            self.rows(n).view(np.uint8).reshape(
                self.log.nb_rows, -1)[ids_nb] = rows
            if sb.log_nb:
                self._csum_views[n][ids_nb] = layout.np_row_checksum(rows)
            applied += rows.nbytes
        if sb.log_routing:
            for n in layout.log_routing_planes(self.cfg):
                s = self._by_name[n]
                if self._journaling():
                    self._j_span(s.offset, s.nbytes)
                self._mm[s.offset:s.offset + s.nbytes] = take(s.nbytes)
                applied += s.nbytes
        return applied

    def _log_used_bytes(self, sb: Superblock) -> int:
        used = sb.log_bt * (8 + self.log.bt_row_nbytes) \
            + sb.log_nb * (8 + self.log.nb_row_nbytes)
        if sb.log_routing:
            used += self.log.routing_nbytes
        return used

    # -- commit record -----------------------------------------------------

    def _write_slot(self, slot: int, sb: Superblock):
        enc = sb.encode()
        off = slot * SLOT_BYTES
        if self._journaling():
            self._j_span(off, len(enc))
        self._mm[off:off + len(enc)] = np.frombuffer(enc, dtype=np.uint8)

    def commit(self, gver: int, clean: bool, log_bt: int = 0, log_nb: int = 0,
               log_routing: bool = False, log_crc: int = 0,
               bb_slot: Optional[int] = None,
               bb_nbytes: Optional[int] = None,
               bb_crc: Optional[int] = None) -> int:
        """Write the next superblock slot (flush_seq + 1) — the flush's
        atomic commit point, carrying the redo-log descriptor. The caller
        fences before (data + log durable first) and after (commit durable
        before acknowledging). The flight-recorder descriptor rides the
        same record when given; ``None`` carries the current one forward
        (commits that never touched the blackbox region — quarantine
        evidence, recorder-less flushes — must not orphan the committed
        window). Returns the new sequence number."""
        cur = self.sb
        nxt = dataclasses.replace(cur, flush_seq=cur.flush_seq + 1,
                                  gver=int(gver), clean=bool(clean),
                                  log_bt=int(log_bt), log_nb=int(log_nb),
                                  log_routing=bool(log_routing),
                                  log_crc=int(log_crc),
                                  bb_slot=int(cur.bb_slot if bb_slot is None
                                              else bb_slot),
                                  bb_nbytes=int(cur.bb_nbytes
                                                if bb_nbytes is None
                                                else bb_nbytes),
                                  bb_crc=int(cur.bb_crc if bb_crc is None
                                             else bb_crc))
        self._write_slot(nxt.flush_seq % 2, nxt)
        self.sb = nxt
        return nxt.flush_seq

    # -- flight recorder ---------------------------------------------------

    def write_blackbox(self, seq: int, payload: bytes) -> tuple:
        """Stage one recorder window (the recent-observability snapshot
        for the flush that will commit ``seq``) into the blackbox slot the
        CURRENT superblock does not reference, so a crash before the
        commit never scribbles the committed window. (NOT ``seq % 2``:
        log-routing flushes commit twice and quarantine evidence commits
        without a window, so seq parity drifts off the descriptor.) One
        emulated store op: the caller orders it before the commit fence.
        The window is self-framed (magic + seq + length + CRC, see
        ``obs/blackbox.py``) so forensics can identify a torn flush's
        uncommitted story by ``seq == committed_seq + 1``. Returns
        ``(slot, payload_nbytes, crc)`` for the commit record; payloads
        beyond the slot budget are truncated at an entry boundary by the
        recorder, never here."""
        from repro_torch.obs import blackbox as bb_mod
        slot = 1 - self.sb.bb_slot if self.sb.bb_slot in (0, 1) else 0
        framed = bb_mod.frame_window(int(seq), payload)
        cap = self.bbox.slot_nbytes
        if len(framed) > cap:
            raise PoolError(
                f"blackbox window {len(framed)}B exceeds slot budget {cap}B")
        off = self.bbox.slot_offset(slot)
        if self._journaling():
            self._j_span(off, len(framed))
        self._mm[off:off + len(framed)] = np.frombuffer(framed, np.uint8)
        return slot, len(payload), zlib.crc32(payload)

    def read_blackbox_slot(self, slot: int) -> bytes:
        """Raw bytes of one blackbox slot (forensics decodes the frame)."""
        off = self.bbox.slot_offset(int(slot))
        return bytes(self._mm[off:off + self.bbox.slot_nbytes])

    # -- durable quarantine evidence ---------------------------------------

    LOST_CAP = 64                      # per-kind rows kept in the slot

    def record_lost(self, report) -> None:
        """Merge a fresh quarantine report into the superblock's durable
        lost-row lists and commit+fence IMMEDIATELY — before any healing
        store. Ordering is the point: if recovery crashes after the rows
        are rewritten (checksums healed) but the evidence only lived in
        memory, the next reopen would see a clean pool and the loss would
        become silent. Committing first makes the report at least as
        durable as the healing that erases its trigger."""
        if not report:
            return
        sb = self.sb
        bt = sorted({*sb.lost_bt,
                     *(r["row"] for r in report if r["plane"] == "bt")})
        nb = sorted({*sb.lost_nb,
                     *(r["row"] for r in report if r["plane"] == "nb")})
        cap = self.LOST_CAP
        self.sb = dataclasses.replace(
            sb, lost_bt=bt[:cap], lost_nb=nb[:cap],
            lost_records=sb.lost_records
            + sum(r.get("lost_records", 0) for r in report),
            lost_overflow=sb.lost_overflow or len(bt) > cap or len(nb) > cap)
        # pass the log descriptor through untouched: retiring it is the
        # healing flush's job (and a lost descriptor must stay visible)
        self.commit(gver=sb.gver, clean=False, log_bt=sb.log_bt,
                    log_nb=sb.log_nb, log_routing=sb.log_routing,
                    log_crc=sb.log_crc)
        self.fence()
        if self.obs is not None:
            self.obs.registry.counter("pool.quarantine_events").inc()
            self.obs.registry.counter("pool.quarantined_rows").inc(
                len(report))
            self.obs.tracer.instant(
                "quarantine", "persist", rows=len(report),
                lost_records=sum(r.get("lost_records", 0) for r in report))
        if self.recorder is not None:
            # durable stamp: the quarantine instant must survive a crash
            # even with tracing off (it rides the next committed window)
            self.recorder.record(
                "quarantine", rows=len(report),
                lost_records=sum(r.get("lost_records", 0) for r in report))

    def lost_entries(self) -> list:
        """The durable lost-keys report, decoded to quarantine-report shape
        (``plane``/``seg``/``bucket``/``row``; a trailing ``overflow``
        sentinel when the row list was truncated)."""
        BT, NB = self.cfg.buckets_total, self.cfg.num_buckets
        out = [{"plane": "bt", "seg": r // BT, "bucket": r % BT, "row": r}
               for r in self.sb.lost_bt]
        out += [{"plane": "nb", "seg": r // NB, "bucket": r % NB, "row": r}
                for r in self.sb.lost_nb]
        if self.sb.lost_overflow:
            out.append({"plane": "any", "overflow": True})
        return out

    # -- state I/O ---------------------------------------------------------

    def read_state(self, device=None) -> DashState:
        """Materialize the pool's planes as a fresh ``DashState`` on
        ``device`` (the card unless given): uint32 planes become int32
        tensors holding the same bits. The copy is bounded by the pool size
        — constant in the number of stored keys for a fixed config, which
        is what keeps the durable restart O(1) in data size."""
        device = layout.resolve_device(device)
        out = {}
        for s in self.specs:
            a = np.array(self._views[s.name])
            if a.dtype == np.uint32:
                a = a.view(np.int32)
            out[s.name] = torch.from_numpy(a).to(device)
        return DashState(**out)

    def disk_plane(self, name: str) -> np.ndarray:
        """Read-only host copy of one plane (diff/classification input)."""
        return np.array(self._views[name])
