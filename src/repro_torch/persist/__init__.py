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

The sharded DHT keeps one pool per shard (``shard_pool_paths``,
``create_shard_pools``, ``open_shard_pools``, ``flush_shards``,
``recover_shards``, ``reopen_shards``). A process that holds every shard
passes the stacked ``(n_shards, ...)`` state, as the reference does; a DHT
rank names the shard(s) it owns (``shards=``) and passes just those
states. Every shard's pool file is the reference's bytes.
"""
from __future__ import annotations

import glob
import os
import time
from typing import List, Optional, Sequence, Tuple

import torch

from repro_torch.core import layout, recovery
from repro_torch.core.layout import DashConfig, DashState
from repro_torch.core.table import DashEH, DashLH, DashTable

from .faults import FaultPlan, TornPersist
from .pool import FlushError, PmPool, PoolError, Superblock
from .writeback import (Scrubber, SimulatedCrash, WritebackDegraded,
                        WritebackEngine)

__all__ = [
    "PmPool", "PoolError", "FlushError", "Superblock", "WritebackEngine",
    "WritebackDegraded", "SimulatedCrash", "Scrubber", "FaultPlan",
    "TornPersist", "create", "reopen", "durable_open", "shard_pool_paths",
    "create_shard_pools", "open_shard_pools", "flush_shards", "recover_shards",
    "reopen_shards",
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


# -- sharded DHT: one pool per shard ------------------------------------------

def shard_pool_paths(dirpath: str, n_shards: int) -> List[str]:
    return [os.path.join(dirpath, f"shard_{i:04d}.pool")
            for i in range(n_shards)]


def _shard_ids(n_found: int, shards: Optional[Sequence[int]]) -> List[int]:
    return list(range(n_found)) if shards is None else [int(i) for i in shards]


def create_shard_pools(dirpath: str, cfg: DashConfig, n_shards: int,
                       faults: Optional[list] = None,
                       shards: Optional[Sequence[int]] = None
                       ) -> List[WritebackEngine]:
    """One independent pool per shard (all EH: the DHT's shard type), for
    every shard or only the ``shards`` a rank owns. ``faults`` optionally
    attaches one FaultPlan per shard (indexed by shard id)."""
    os.makedirs(dirpath, exist_ok=True)
    paths = shard_pool_paths(dirpath, n_shards)
    return [WritebackEngine(PmPool.create(paths[i], cfg, "eh",
                                          faults=faults[i] if faults else None))
            for i in _shard_ids(n_shards, shards)]


def _found_paths(dirpath: str) -> List[str]:
    paths = sorted(glob.glob(os.path.join(dirpath, "shard_*.pool")))
    if not paths:
        raise PoolError(f"no shard pools under {dirpath}")
    return paths


def open_shard_pools(dirpath: str, faults: Optional[list] = None
                     ) -> List[WritebackEngine]:
    return [WritebackEngine(PmPool.open(p, faults=faults[i] if faults else None))
            for i, p in enumerate(_found_paths(dirpath))]


def _per_shard(state, n: int) -> List[DashState]:
    """The per-shard states behind ``state``: a stacked ``(n, ...)`` state,
    a sequence of shard states, or (n = 1) one shard's own state."""
    if isinstance(state, DashState):
        if state.version.dim() == 3:                   # (n_shards, S, BT)
            return [DashState(*(x[i] for x in state)) for i in range(n)]
        return [state]
    return list(state)


def flush_shards(state, wbs: List[WritebackEngine]) -> int:
    """Flush each shard's state into its own pool (``wbs[i]`` takes the
    i-th shard of ``state``; see ``_per_shard``): each shard's dirty diff
    runs against its own pool, so an insert burst that touched two owners
    flushes two pools' dirty rows and commits the rest with a
    scalars-only write.

    Per-shard fault isolation: a shard whose pool trips the degraded path
    is skipped (its engine reports ``degraded``; its pool keeps the last
    committed image) while every healthy neighbor still flushes."""
    total = 0
    for shard, wb in zip(_per_shard(state, len(wbs)), wbs):
        if wb.degraded:
            wb.degraded_flushes += 1
            continue
        try:
            total += wb.flush(shard)
        except WritebackDegraded:
            continue                   # this shard only; neighbors proceed
    return total


def recover_shards(state, wbs: List[WritebackEngine]) -> int:
    """Probe every degraded shard engine (``try_recover``: fence probe +
    force-full resync flush). Returns how many shards came back healthy."""
    back = 0
    for shard, wb in zip(_per_shard(state, len(wbs)), wbs):
        if wb.degraded and wb.try_recover(shard):
            back += 1
    return back


def reopen_shards(dirpath: str, eager_recover_dirty: bool = False,
                  verify: bool = True, faults: Optional[list] = None,
                  retries: int = 2, retry_base_s: float = 0.002,
                  shards: Optional[Sequence[int]] = None, device=None,
                  stack: bool = True):
    """Reopen every shard pool (or only ``shards``) independently onto
    ``device`` (the card unless given). Returns ``(state, wbs, info)``:
    the shard states stacked into one ``(n, ...)`` state, or with
    ``stack=False`` a list of them, one per opened shard.

    Per-shard recovery is LAZY by default, like the single-table path: the
    DHT's programs flag or bounce a lane whose segment's ``seg_version``
    lags the recovery generation, and ``DistributedDash.ensure_recovered``
    repairs exactly the touched segments on first access — so a dirty
    fleet reopen is O(1) in stored data. ``eager_recover_dirty=True`` runs
    ``recovery.recover_all`` per dirty shard at reopen instead. Clean
    shards pay nothing either way. ``info["dirty_shard_ids"]`` lists the
    shards that reopened dirty, ``info["n_shards"]`` counts the pools
    found.

    Fault isolation: each shard's reopen is retried ``retries`` times with
    exponential backoff on transient flush errors; a shard that still
    cannot commit its dirty-serving marker stays attached but DEGRADED
    (volatile until ``recover_shards``) instead of failing the fleet.
    ``verify`` runs the per-shard checksum scan; quarantined rows are
    reported per shard in ``info["lost_reports"]``."""
    device = layout.resolve_device(device)
    paths = _found_paths(dirpath)
    wbs, states = [], []
    dirty = degraded = 0
    dirty_ids = []
    lost_reports = {}
    for i in _shard_ids(len(paths), shards):
        plan = faults[i] if faults else None
        wb = st = None
        delay = retry_base_s
        for attempt in range(retries + 1):
            try:
                wb = WritebackEngine(PmPool.open(paths[i], faults=plan))
                pool = wb.pool
                if pool.sb.flush_seq == 0:
                    raise PoolError(f"shard pool {paths[i]} was never flushed")
                st = pool.read_state(device)
                st, work = recovery.instant_restart(
                    st, clean_override=pool.sb.clean)
                if verify:
                    bad = pool.verify_checksums()
                    if bad["bt"].size or bad["nb"].size:
                        st, rep = recovery.quarantine_rows(
                            pool.cfg, "eh", st, pool.disk_plane("version"),
                            bad["bt"], bad["nb"])
                        pool.record_lost(rep)    # durable before healing
                    persisted = pool.lost_entries()
                    if persisted:
                        lost_reports[i] = persisted
                st = recovery.heap_top_floor(pool.cfg, st)
                if not work["clean"]:
                    dirty += 1
                    dirty_ids.append(i)
                    if eager_recover_dirty:
                        st = recovery.recover_all(pool.cfg, "eh", st)
                wb.flush(st)           # dirty-serving marker, per shard
                break
            except (FlushError, WritebackDegraded):
                if attempt >= retries:
                    # keep the shard attached but degraded: it serves the
                    # reopened state volatile; neighbors are unaffected
                    if wb is not None and st is not None:
                        wb.degraded = True
                        degraded += 1
                        break
                    raise
                time.sleep(delay)
                delay *= 2
        states.append(st)
        wbs.append(wb)
    if stack:
        states = DashState(*(torch.stack([getattr(s, n) for s in states])
                             for n in DashState._fields))
    return states, wbs, {"n_shards": len(paths), "dirty_shards": dirty,
                         "dirty_shard_ids": dirty_ids,
                         "degraded_shards": degraded,
                         "lost_reports": lost_reports,
                         "cfg": wbs[0].pool.cfg}
