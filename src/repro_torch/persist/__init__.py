"""Durable PM-pool persistence: flush-on-publish + instant-restart serving.

Ported from ``repro.persist``. ``pool.py`` emulates a persistent-memory pool
(memory-mapped plane regions + checksummed superblock, the reference's file
format byte for byte), ``writeback.py`` flushes only the dirty planes per
publish (O(dirty) bytes to durable media, with a fenced phase order that
keeps torn crashes recoverable), and this module is the lifecycle API:

    table = persist.create("t.pool", DashConfig(...))        # fresh pool
    table.insert(keys, vals); table.flush()                  # ack durable
    table.close()                                            # clean marker

    table, info = persist.reopen("t.pool")                   # O(1) restart
    table.search(keys)                  # lazy per-segment recovery on access

The table state lives on the card unless ``device`` names another
(``device="cpu"`` for CPU runs); the pool is a host file, and only dirty
rows cross between the two. ``reopen`` is the paper's Table-1 instant
restart, end-to-end durable: map the pool, read the superblock's clean
marker, bump V if dirty (constant work), and return a table that serves
immediately — segments are recovered on first access by the lazy path
(core/recovery.py). Handing the table to ``serving.frontend.DashFrontend``
gives flush-on-publish: every acknowledged batch is durable before its ops
complete.

Media hardening: ``reopen(verify=True)`` additionally checks every record
row against the pool's per-row checksum region. Rows the redo log could not
rebuild are quarantined (cleared + scheduled for re-flush) and surfaced in
``table.lost_report`` / ``info`` — an explicit lost-keys report instead of
silently serving bit-rotted bytes. A seeded ``faults.FaultPlan`` can be
attached to any create/open to inject torn persists, bit rot, transient
EIO, and ENOSPC (``persist/chaos.py``).

The reference's one-pool-per-shard functions for the sharded DHT are not
ported yet: they come with the distributed table.
"""
from __future__ import annotations

import os
import time
from typing import Optional, Tuple

from repro_torch.core import layout, recovery
from repro_torch.core.layout import DashConfig
from repro_torch.core.table import DashEH, DashLH, DashTable

from .faults import FaultPlan, TornPersist
from .pool import FlushError, PmPool, PoolError, Superblock
from .writeback import (Scrubber, SimulatedCrash, WritebackDegraded,
                        WritebackEngine)

__all__ = [
    "PmPool", "PoolError", "FlushError", "Superblock", "WritebackEngine",
    "WritebackDegraded", "SimulatedCrash", "Scrubber", "FaultPlan",
    "TornPersist", "create", "reopen", "durable_open",
]

_CLS = {"eh": DashEH, "lh": DashLH}


def create(path: str, cfg: DashConfig, mode: str = "eh", faults=None,
           device=None, **table_kw) -> DashTable:
    """Allocate a fresh pool at ``path`` and return a durable table bound to
    it, on ``device`` (the card unless given). The table is marked
    dirty-serving immediately (clean goes durable only through
    ``table.close()``), and the empty state is flushed so a crash before
    the first ``flush()`` reopens to a valid empty table. A failed
    allocation (e.g. ENOSPC) raises ``PoolError`` and leaves no partial
    file behind."""
    device = layout.resolve_device(device)
    pool = PmPool.create(path, cfg, mode, faults=faults)
    table = _CLS[mode](cfg, device=device, **table_kw)
    table.state.clean.fill_(False)
    table.attach_writeback(WritebackEngine(pool))
    table.flush()
    return table


def reopen(path: str, verify: bool = True, faults=None, device=None,
           **table_kw) -> Tuple[DashTable, dict]:
    """Instant restart from a pool file onto ``device`` (the card unless
    given): constant work before the table can serve (map + superblock + V
    bump + a scalars-only flush to mark the new serving period dirty), plus
    one copy of the pool's planes to the device. All real recovery is
    deferred to first access of each segment (``DashTable._ensure_recovered``);
    ``info['seconds']`` times exactly the blocking part.

    ``verify=True`` (the default) additionally recomputes every record
    row's checksum against the pool's checksum region — still O(pool
    size), not O(keys) — and quarantines mismatching rows
    (``recovery.quarantine_rows``): corrupted buckets are cleared and
    reported via ``table.lost_report`` (and ``info['quarantined_bt'/'_nb']``,
    ``info['lost_records']``) rather than served. The quarantined rows'
    version words are forced off the pool's, so the marker flush below
    immediately rewrites them (healing the checksums).

    Merged-away segment ids (``free_segments``) are not persisted: a
    reopened table re-allocates from the watermark and re-learns free ids
    from future merges — capacity conservatism, never a correctness issue.
    """
    device = layout.resolve_device(device)
    t0 = time.perf_counter()
    pool = PmPool.open(path, faults=faults)
    if pool.sb.flush_seq == 0:
        raise PoolError(f"pool at {path} was never flushed")
    state = pool.read_state(device)
    state, work = recovery.instant_restart(state, clean_override=pool.sb.clean)
    report = []
    if verify:
        bad = pool.verify_checksums()
        if bad["bt"].size or bad["nb"].size:
            state, report = recovery.quarantine_rows(
                pool.cfg, pool.mode, state, pool.disk_plane("version"),
                bad["bt"], bad["nb"])
            # persist the loss evidence BEFORE the healing flush below: a
            # crash after the heal but before the next verify would
            # otherwise reopen a clean-looking pool and turn this explicit
            # loss into a silent one
            pool.record_lost(report)
    # after quarantine (a torn handle word must never inflate the floor):
    # published records may reference heap rows above the stale scalar
    state = recovery.heap_top_floor(pool.cfg, state)
    work["quarantined_bt"] = sum(1 for r in report if r["plane"] == "bt")
    work["quarantined_nb"] = sum(1 for r in report if r["plane"] == "nb")
    work["lost_records"] = sum(r.get("lost_records", 0) for r in report)
    work["lost_records_total"] = pool.sb.lost_records
    work["log_lost"] = pool.log_lost
    table = _CLS[pool.mode](pool.cfg, state=state, **table_kw)
    # merged view: rows quarantined now + evidence persisted by any earlier
    # (possibly crashed) reopen of this pool
    table.lost_report = pool.lost_entries()
    table.attach_writeback(WritebackEngine(pool))
    if report:
        table.dirty.note_segments([r["seg"] for r in report])
    # commit the dirty-serving marker (and the bumped V) BEFORE serving: a
    # crash from here on must reopen as dirty. The version diff vs the pool
    # is empty (clean reopen) or exactly the quarantined rows, so this
    # flush writes scalars + quarantine repairs + commit only.
    table.flush()
    work["seconds"] = time.perf_counter() - t0
    work["flush_seq"] = pool.sb.flush_seq
    return table, work


def durable_open(path: str, cfg: Optional[DashConfig] = None,
                 mode: str = "eh", **table_kw) -> Tuple[DashTable, dict]:
    """Open-or-create: ``reopen`` when a pool exists at ``path``, else
    ``create`` (which then requires ``cfg``)."""
    if os.path.exists(path):
        return reopen(path, **table_kw)
    assert cfg is not None, "creating a pool needs a config"
    return create(path, cfg, mode, **table_kw), {"created": True,
                                                 "clean": True, "seconds": 0.0}
