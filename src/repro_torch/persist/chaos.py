"""Randomized chaos schedules over the durable table.

Ported from ``repro.persist.chaos``: the same seed drives the same workload
and the same faults, so a schedule's counters equal the reference's.
``run_schedule`` drives one seeded fault schedule: an SMO-heavy workload
(small segments force split storms) against one durable pool while a
``FaultPlan`` tears fences, flips persisted bits, injects transient EIO
bursts and ENOSPC — then checks the safety property the whole PR exists
to enforce:

    every acknowledged key is served with an acknowledged value, or its
    loss is EXPLICITLY reported (quarantined rows / log-loss) — never a
    silent wrong read, never a silent disappearance.

Acknowledged means ``table.flush()`` returned: the model snapshots the
key->value map at every successful flush (``committed``) and tracks the
live map (``live``) between flushes. At every reopen (torn crash or clean
restart) the harness searches every key it ever wrote and classifies each
outcome against ``{committed, live}``:

  - committed-stable key (no op since the last ack) served with any OTHER
    value            -> ``wrong_reads``  (hard failure)
  - committed-stable key absent with no quarantined row among its
    reachable slots (home probe window + stash of its current segment)
    and no log loss  -> ``silent_lost`` (hard failure)
  - in-flight key (insert/update/delete between ack and crash) may
    resolve to either side of the ack boundary; anything else counts in
    ``indeterminate_pending`` (reported, not a failure: un-acked writes
    carry no durability contract).

Determinism: the schedule derives entirely from ``seed`` (workload rng and
``FaultPlan`` share it), so a failing seed replays exactly.

Flight-recorder cross-check: every schedule attaches a durable
``FlightRecorder`` and stamps each mutation group's intent
(``record_ops`` with ``await_seq = flush_seq + 1``) before the flush. At
every restart the harness runs ``obs/forensics.py:analyze_pool`` on the
raw pool file BEFORE reopening it and checks the reconstruction against
ground truth: every op forensics reports as acked-but-in-flight must be a
key whose committed and live values actually disagree — an op that was
durably acknowledged (or never applied) showing up as in-flight is a
``forensics_contradictions`` hard failure. The check is one-sided by
design: a flush that tears before its window write legitimately leaves no
story (soundness, not completeness).

Shapes are kept uniform (fixed insert batch, fixed padded search chunks),
as in the reference. Tables live on ``device`` (the card unless given).
"""
from __future__ import annotations

import dataclasses
import os
from typing import Dict

import numpy as np

from repro_torch.core import hashing
from repro_torch.core.layout import DashConfig
from repro_torch.core.table import TableFullError
from repro_torch import persist
from repro_torch.persist.faults import FaultPlan
from repro_torch.persist.pool import FlushError, PoolError
from repro_torch.persist.writeback import Scrubber, SimulatedCrash, \
    WritebackDegraded

#: Small segments + shallow directory: a few hundred inserts drive real
#: split storms, so fault windows overlap SMOs (the hard case).
CHAOS_CFG = DashConfig(max_segments=16, dir_depth_max=8, num_buckets=16,
                       num_slots=8)

_SEARCH_CHUNK = 256


@dataclasses.dataclass
class ScheduleResult:
    """Outcome of one seeded schedule. ``wrong_reads`` and ``silent_lost``
    are the safety gates — any nonzero value is a correctness bug (the
    chaos tests assert 0)."""
    seed: int
    ops: int = 0
    flushes: int = 0
    crashes: int = 0             # torn-persist reopens
    clean_restarts: int = 0
    tears: int = 0
    flips: int = 0
    eio_raised: int = 0
    enospc_raised: int = 0
    degraded_events: int = 0
    recoveries: int = 0
    reported_lost: int = 0       # acked keys lost WITH a quarantine report
    wrong_reads: int = 0         # MUST be 0
    silent_lost: int = 0         # MUST be 0
    indeterminate_pending: int = 0
    scrub_repaired: int = 0
    log_lost_events: int = 0
    pointer_mode: bool = False
    table_full: bool = False
    # flight-recorder forensics cross-check: reconstructions
    # audited, torn-flush windows recovered, in-flight ops reported, and
    # reports contradicting ground truth (MUST be 0)
    forensics_checks: int = 0
    forensics_torn_windows: int = 0
    forensics_in_flight: int = 0
    forensics_contradictions: int = 0


def _words_of(keys, w: int) -> np.ndarray:
    """Deterministic u64-key -> (n, W) word embedding for pointer-mode
    schedules (bijective, so the harness's integer key model carries)."""
    keys = np.asarray(keys, np.uint64)
    out = np.zeros((keys.size, w), np.uint32)
    out[:, 0] = (keys & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    if w > 1:
        out[:, 1] = (keys >> np.uint64(32)).astype(np.uint32)
    return out


def _op(table, name, keys, vals=None):
    """Dispatch insert/update/delete/search through either key surface."""
    cfg = table.cfg
    kw = ({"words": _words_of(keys, cfg.key_heap_words)}
          if cfg.pointer_mode else {"keys": np.asarray(keys, np.uint64)})
    if vals is not None:
        kw["values"] = vals
    return getattr(table, name)(**kw)


def _search_all(table, keys):
    """Fixed-chunk padded search (uniform shapes -> one jit cache entry)."""
    keys = np.asarray(keys, np.uint64)
    found = np.zeros(keys.size, bool)
    vals = np.zeros(keys.size, np.uint32)
    for lo in range(0, keys.size, _SEARCH_CHUNK):
        chunk = keys[lo:lo + _SEARCH_CHUNK]
        pad = _SEARCH_CHUNK - chunk.size
        if pad:
            chunk = np.concatenate([chunk, np.full(pad, chunk[0], np.uint64)])
        f, v = _op(table, "search", chunk)
        found[lo:lo + _SEARCH_CHUNK - pad] = f[:_SEARCH_CHUNK - pad]
        vals[lo:lo + _SEARCH_CHUNK - pad] = v[:_SEARCH_CHUNK - pad]
    return found, vals


def _reported_lost(cfg, state, report, key) -> bool:
    """True iff a quarantined bt row sits among the slots ``key`` could
    legally occupy — its current segment's home probe window or stash.
    That is exactly the reachable set of the search path, so a quarantine
    hit there explains an absence; one elsewhere does not."""
    if not report:
        return False
    if any(r.get("overflow") for r in report):
        return True     # per-row evidence capped out; any loss is covered
    if cfg.pointer_mode:
        w = _words_of(np.array([key], np.uint64), cfg.key_heap_words)
        hi = hashing.np_fold_words(w, hashing.FOLD_SEED_HI)
        lo = hashing.np_fold_words(w, hashing.FOLD_SEED_LO)
    else:
        hi, lo = hashing.np_split_keys(np.array([key], np.uint64))
    h1 = hashing.np_hash1(hi, lo)
    d = int(h1[0] >> np.uint32(32 - cfg.dir_depth_max))
    seg = int(state.dir[d])
    nb = cfg.num_buckets
    b = int(h1[0] & np.uint32(nb - 1))
    cand = {(b + w) & (nb - 1) for w in range(cfg.probe_window)}
    cand |= set(range(nb, nb + cfg.num_stash))
    return any(r["plane"] == "bt" and r["seg"] == seg and r["bucket"] in cand
               for r in report)


def _classify(table, info, committed, live, res, cfg):
    """Post-reopen audit: search every tracked key, enforce the safety
    property, and return the observed map (the new committed AND live —
    the reopen's internal healing flush made the served state durable)."""
    report = getattr(table, "lost_report", [])
    log_lost = bool(info.get("log_lost", False))
    if log_lost:
        res.log_lost_events += 1
    keys = sorted(set(committed) | set(live))
    if not keys:
        return {}
    found, vals = _search_all(table, keys)
    observed = {}
    for i, k in enumerate(keys):
        c, l = committed.get(k), live.get(k)
        if found[i]:
            observed[k] = int(vals[i])
        stable = c is not None and c == l
        if stable:
            if found[i] and int(vals[i]) != c:
                res.wrong_reads += 1
            elif not found[i]:
                if _reported_lost(cfg, table.state, report, k):
                    res.reported_lost += 1
                else:
                    res.silent_lost += 1
        else:
            # in-flight across the ack boundary: either side may surface
            allowed = {v for v in (c, l) if v is not None}
            if found[i] and int(vals[i]) not in allowed:
                res.indeterminate_pending += 1
            elif not found[i] and c is not None and l is not None \
                    and not log_lost \
                    and not _reported_lost(cfg, table.state, report, k):
                # an in-flight UPDATE should not vanish the key outright
                res.indeterminate_pending += 1
    return observed


def _attach_recorder(table):
    """One durable flight recorder per (re)opened pool — the blackbox
    window then rides every flush commit."""
    from repro_torch.obs import FlightRecorder
    table.writeback.attach_recorder(FlightRecorder())
    return table


def _stamp_ops(table, kind: str, keys):
    """Durable intent stamp for one mutation group (the blackbox ack
    protocol: acked once a commit with flush_seq >= await_seq lands)."""
    rec = table.writeback.recorder
    if rec is not None and len(keys):
        rec.record_ops(kind, np.asarray(keys, np.uint64),
                       await_seq=table.writeback.pool.sb.flush_seq + 1)


def _forensics_audit(path, committed, live, res):
    """Cross-check the flight recorder's crash reconstruction against the
    harness's ground truth, on the RAW pool file before reopen disturbs
    it. Soundness gate: every key forensics claims was acked-but-in-flight
    must genuinely sit on the ack boundary (committed and live disagree).
    An acked-and-committed (or never-written) key reported in flight is a
    contradiction — the acceptance gate asserts zero across every seeded
    schedule."""
    from repro_torch.obs import forensics as obs_forensics
    rep = obs_forensics.analyze_pool(path)
    res.forensics_checks += 1
    if not rep.get("ok"):
        return
    if rep.get("torn", {}).get("present"):
        res.forensics_torn_windows += 1
    truth = {k for k in set(committed) | set(live)
             if committed.get(k) != live.get(k)}
    for op in rep.get("in_flight_ops", ()):
        for k in op.get("keys", ()):
            res.forensics_in_flight += 1
            if int(k) not in truth:
                res.forensics_contradictions += 1


def _restart(path, plan, res, committed, live, cfg, torn: bool, device):
    """Reopen (retrying through tears/EIO hitting the healing flush) and
    audit. Returns (table, committed', live') — identical maps: everything
    the audit observed is durable again."""
    res.crashes += 1 if torn else 0
    if not torn:
        res.clean_restarts += 1
    # forensics reads the evidence BEFORE reopen's healing flush moves it
    _forensics_audit(path, committed, live, res)
    table = info = None
    for _ in range(16):
        try:
            table, info = persist.reopen(path, faults=plan, device=device)
            break
        except SimulatedCrash:
            res.crashes += 1        # tear landed inside the healing flush
        except (WritebackDegraded, FlushError):
            continue                # burst drains across attempts
    assert table is not None, f"seed {res.seed}: reopen never converged"
    _attach_recorder(table)
    observed = _classify(table, info, committed, live, res, cfg)
    return table, dict(observed), dict(observed)


def run_schedule(seed: int, tmpdir: str, cfg: DashConfig = CHAOS_CFG,
                 n_batches: int = 8, batch: int = 48,
                 min_tears: int = 0, min_flips: int = 0,
                 scrub: bool = True, allow_pointer_mode: bool = True,
                 p_tear: float = 0.30, p_eio: float = 0.20,
                 p_flip: float = 0.35, p_clean_restart: float = 0.15,
                 device=None) -> ScheduleResult:
    """Run ONE seeded chaos schedule on ``device`` (the card unless given);
    raises AssertionError on any safety violation and returns the counters
    otherwise."""
    rng = np.random.default_rng(np.uint64(seed) ^ np.uint64(0xC8A05))
    res = ScheduleResult(seed=seed)
    plan = FaultPlan(seed=seed)
    if allow_pointer_mode and rng.random() < 0.25:
        cfg = dataclasses.replace(cfg, pointer_mode=True,
                                  key_heap_size=4096, key_heap_words=2)
        res.pointer_mode = True
    path = os.path.join(tmpdir, f"chaos_{seed}.pool")

    # ENOSPC rehearsal on ~1/4 of seeds: the failed create must clean up
    # and a retry on the same path must succeed.
    if rng.random() < 0.25:
        plan.enospc_creates = 1
        try:
            persist.create(path, cfg, faults=plan, device=device)
            raise AssertionError("injected ENOSPC did not surface")
        except PoolError:
            assert not os.path.exists(path), "partial pool file left behind"

    table = _attach_recorder(persist.create(path, cfg, faults=plan,
                                            device=device))
    scrubber = Scrubber(table.writeback, rows_per_tick=256) if scrub else None
    committed: Dict[int, int] = {}
    live: Dict[int, int] = {}
    next_key = 1
    tears_armed = flips_done = 0

    for bi in range(n_batches):
        # -- arm this round's faults (relative to the live fence clock) ---
        want_tear = tears_armed < min_tears or rng.random() < p_tear
        want_eio = not want_tear and rng.random() < p_eio
        if want_tear:
            idx = plan.fence_calls + int(rng.integers(0, 12))
            plan.torn_fences = frozenset(set(plan.torn_fences) | {idx})
            tears_armed += 1
        elif want_eio:
            idx = plan.fence_calls + int(rng.integers(0, 6))
            plan.eio_fences[idx] = int(rng.choice([2, 8]))
        if flips_done < min_flips or rng.random() < p_flip:
            n = int(rng.integers(1, 4))
            plan.flip_bits(table.writeback.pool, n=n)
            flips_done += n

        # -- mutate: fresh inserts + updates/deletes of committed keys ----
        if not res.table_full:
            ins = np.arange(next_key, next_key + batch, dtype=np.uint64)
            next_key += batch
            vals = ((ins % np.uint64(2**31 - 1)) + np.uint64(1)
                    ).astype(np.uint32)
            try:
                _op(table, "insert", ins, vals)
                live.update(zip(ins.tolist(), vals.tolist()))
                res.ops += batch
                _stamp_ops(table, "insert", ins)
            except TableFullError:
                res.table_full = True
        pool_keys = list(committed)
        if len(pool_keys) >= 8:
            pick = rng.choice(len(pool_keys), size=8, replace=False)
            upd = np.array([pool_keys[i] for i in pick[:4]], np.uint64)
            dele = np.array([pool_keys[i] for i in pick[4:]], np.uint64)
            nv = (np.asarray(upd % np.uint64(997), np.uint32)
                  + np.uint32(bi + 2))
            _op(table, "update", upd, nv)
            live.update(zip(upd.tolist(), nv.tolist()))
            _stamp_ops(table, "update", upd)
            _op(table, "delete", dele)
            for k in dele.tolist():
                live.pop(k, None)
            _stamp_ops(table, "delete", dele)
            res.ops += 8

        # -- flush = acknowledgment point ---------------------------------
        try:
            table.flush()
            res.flushes += 1
            committed = dict(live)
        except SimulatedCrash:
            table, committed, live = _restart(
                path, plan, res, committed, live, cfg, torn=True,
                device=device)
            scrubber = (Scrubber(table.writeback, rows_per_tick=256)
                        if scrub else None)
            continue
        except WritebackDegraded:
            res.degraded_events += 1
            # degraded-mode serving: live keys still read back volatile
            probe = list(live)[:32]
            if probe:
                f, v = _search_all(table, probe)
                assert f.all(), "degraded table stopped serving live keys"
            recovered = False
            for _ in range(12):
                try:
                    if table.writeback.try_recover(table.state):
                        recovered = True
                        break
                except SimulatedCrash:
                    break
            if table.writeback.dead:
                table, committed, live = _restart(
                    path, plan, res, committed, live, cfg, torn=True,
                device=device)
                scrubber = (Scrubber(table.writeback, rows_per_tick=256)
                            if scrub else None)
                continue
            if recovered:
                res.recoveries += 1
                committed = dict(live)
            continue

        # -- background scrub + occasional clean restart ------------------
        if scrubber is not None and rng.random() < 0.5:
            try:
                scrubber.tick(table.state)
            except SimulatedCrash:
                table, committed, live = _restart(
                    path, plan, res, committed, live, cfg, torn=True,
                device=device)
                scrubber = Scrubber(table.writeback, rows_per_tick=256)
                continue
        if rng.random() < p_clean_restart:
            closed_ok = True
            try:
                table.close()
            except (SimulatedCrash, WritebackDegraded, FlushError):
                closed_ok = False     # fall through: reopen audits either way
            table, committed, live = _restart(
                path, plan, res, committed, live, cfg, torn=not closed_ok,
                device=device)
            scrubber = (Scrubber(table.writeback, rows_per_tick=256)
                        if scrub else None)

    # -- final verdict: force one last crash-free audit -----------------------
    try:
        table.close()
    except (SimulatedCrash, WritebackDegraded, FlushError):
        pass
    plan.torn_fences = frozenset()    # the audit itself must not tear
    plan.eio_fences.clear()
    table, committed, live = _restart(
        path, plan, res, committed, live, cfg, torn=False,
        device=device)
    bad = table.writeback.pool.verify_checksums()
    assert bad["bt"].size == 0 and bad["nb"].size == 0, \
        f"seed {seed}: reopen left unhealed checksums"
    table.close()
    os.unlink(path)

    res.tears = plan.tears
    res.flips = plan.flips
    res.eio_raised = plan.eio_raised
    res.enospc_raised = plan.enospc_raised
    if scrubber is not None:
        res.scrub_repaired = scrubber.repaired_rows
    assert res.wrong_reads == 0, \
        f"seed {seed}: {res.wrong_reads} SILENT WRONG READS"
    assert res.silent_lost == 0, \
        f"seed {seed}: {res.silent_lost} acked keys silently lost"
    assert res.forensics_contradictions == 0, \
        (f"seed {seed}: {res.forensics_contradictions} forensics reports "
         f"contradict ground truth")
    return res


def run_many(seeds, tmpdir: str, **kw) -> dict:
    """Aggregate a batch of schedules (keywords go to ``run_schedule``)."""
    agg: Dict[str, int] = {}
    results = []
    for s in seeds:
        r = run_schedule(int(s), tmpdir, **kw)
        results.append(r)
        for f in dataclasses.fields(ScheduleResult):
            v = getattr(r, f.name)
            if isinstance(v, bool):
                v = int(v)
            if f.name != "seed":
                agg[f.name] = agg.get(f.name, 0) + int(v)
    agg["schedules"] = len(results)
    return agg
