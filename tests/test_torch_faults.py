"""Port parity: media faults, degradation, quarantine, scrubbing, the
durable frontend's health states and the chaos matrix (the cases of
``test_faults.py`` and the serving half of ``test_persist.py``, each held
to the reference).

Both packages start from the same pool bytes and get the same seeded
``FaultPlan``: the torn, rotted, retried and recovered pools must stay
byte-identical, every quarantine report, reopen record and counter equal,
and the port must keep the reference's safety property on its own chaos
schedules — every acknowledged key served with its value or explicitly
reported lost.
"""
import dataclasses
import os
import shutil
import time

import numpy as np
import pytest

from repro import persist as rp
from repro.core import DashConfig
from repro.core import recovery as rrec
from repro.obs import FlightRecorder as RRecorder
from repro.persist import chaos as rchaos
from repro.persist.faults import FaultPlan as RPlan
from repro.persist.writeback import Scrubber as RScrubber
from repro.persist.writeback import SimulatedCrash as RSimulatedCrash
from repro.persist.writeback import WritebackDegraded as RDegraded
from repro.serving import frontend as rfe
from repro_torch import persist as tp
from repro_torch.core import recovery as trec
from repro_torch.obs import FlightRecorder as TRecorder
from repro_torch.persist import (FaultPlan, PoolError, Scrubber, SimulatedCrash,
                                 TornPersist, WritebackDegraded, chaos)
from repro_torch.persist.pool import PmPool
from repro_torch.persist.writeback import WritebackEngine
from repro_torch.serving import frontend as tfe
from tests.conftest import unique_keys
from tests.torch_parity import (assert_same_counters, assert_same_pool, assert_same_state,
                                counter_clock, port_cfg, to_port)

SMALL = rchaos.CHAOS_CFG


def _vals(n, base=1):
    return (np.arange(n) % 2**31).astype(np.uint32) + base


def _plan_stats(plan):
    return (plan.fence_calls, plan.tears, plan.eio_raised, plan.flips,
            plan.enospc_raised, plan.torn_bytes)


@pytest.fixture(scope="module")
def base_pools(tmp_path_factory):
    """One filled, flushed pool per package (400 keys, byte-identical) and
    the keys; each test reopens copies of them."""
    d = tmp_path_factory.mktemp("base")
    keys = unique_keys(np.random.default_rng(0), 400)
    ref = rp.create(str(d / "ref.pool"), SMALL)
    port = tp.create(str(d / "port.pool"), port_cfg(SMALL), device="cpu")
    for t in (ref, port):
        t.insert(keys, _vals(400))
        t.flush()
        t.close()
    assert_same_pool(d / "ref.pool", d / "port.pool", "base")
    return d, keys


def _pair(base_pools, tmp_path, seed, **plan_kw):
    """(ref table, port table, ref plan, port plan, ref path, port path):
    both packages' base pools copied and reopened under same-seed plans."""
    d, _ = base_pools
    out = []
    for side, mod, plan_cls in (("ref", rp, RPlan), ("port", tp, FaultPlan)):
        path = str(tmp_path / f"{side}.pool")
        shutil.copyfile(d / f"{side}.pool", path)
        plan = plan_cls(seed=seed, **plan_kw)
        kw = {} if side == "ref" else {"device": "cpu"}
        t, _ = mod.reopen(path, faults=plan, **kw)
        out.append((t, plan, path))
    (r, rplan, rpath), (t, tplan, tpath) = out
    return r, t, rplan, tplan, rpath, tpath


# -- fault primitives ---------------------------------------------------------

def test_enospc_create_fails_clean_like_reference(tmp_path):
    for side, mod, plan_cls in (("ref", rp, RPlan), ("port", tp, FaultPlan)):
        p = str(tmp_path / f"{side}.pool")
        plan = plan_cls(seed=1, enospc_creates=1)
        kw = {} if side == "ref" else {"device": "cpu"}
        with pytest.raises(Exception, match="[Nn]o space") as err:
            mod.create(p, SMALL if side == "ref" else port_cfg(SMALL), faults=plan, **kw)
        assert not os.path.exists(p)          # no partial file left behind
        assert plan.enospc_raised == 1
        if side == "port":
            assert err.type is PoolError
        mod.create(p, SMALL if side == "ref" else port_cfg(SMALL), faults=plan, **kw)
    assert_same_pool(tmp_path / "ref.pool", tmp_path / "port.pool")


def test_transient_eio_burst_absorbed_like_reference(base_pools, tmp_path):
    """A burst within the retry budget is invisible to the caller; both
    engines count the same retries and leave the same bytes."""
    r, t, rplan, tplan, rpath, tpath = _pair(base_pools, tmp_path, seed=2)
    fresh = unique_keys(np.random.default_rng(7), 60, lo=2**62)
    for tab, plan in ((r, rplan), (t, tplan)):
        plan.eio_fences[plan.fence_calls] = 2
        tab.insert(fresh, _vals(60))
        tab.flush()
    assert tplan.eio_raised == 2 and t.writeback.flush_retries >= 2
    assert not t.writeback.degraded and t.writeback.flush_io_errors == 2
    assert_same_counters(r.writeback, t.writeback)
    assert _plan_stats(rplan) == _plan_stats(tplan)
    assert_same_pool(rpath, tpath)


def test_eio_past_budget_degrades_then_recovers_like_reference(base_pools, tmp_path):
    r, t, rplan, tplan, rpath, tpath = _pair(base_pools, tmp_path, seed=3)
    keys = base_pools[1]
    fresh = unique_keys(np.random.default_rng(8), 60, lo=2**62)
    probes = []
    for tab, plan, exc in ((r, rplan, RDegraded), (t, tplan, WritebackDegraded)):
        plan.eio_fences[plan.fence_calls] = 9     # > retry budget
        tab.insert(fresh, _vals(60))
        with pytest.raises(exc):
            tab.flush()
        assert tab.writeback.degraded
        with pytest.raises(exc):                  # degraded engine refuses work
            tab.flush()
        f, _ = tab.search(keys)
        assert f.all()                            # serving continues volatile
        probes.append([tab.writeback.try_recover(tab.state) for _ in range(10)])
        assert not tab.writeback.degraded and tab.writeback.recoveries == 1
    assert probes[0] == probes[1]
    assert_same_counters(r.writeback, t.writeback)
    assert _plan_stats(rplan) == _plan_stats(tplan)
    assert_same_pool(rpath, tpath, "after the resync")
    t.close()
    t2, _ = tp.reopen(tpath, device="cpu")        # recovery resynced the pool
    f, _ = t2.search(np.concatenate([keys, fresh]))
    assert f.all()


def _lost_covers(table, key) -> bool:
    return chaos._reported_lost(table.cfg, table.state, table.lost_report, key)


def _reopen_both(rpath, tpath, **kw):
    r2, ri = rp.reopen(rpath, **kw)
    t2, ti = tp.reopen(tpath, device="cpu", **kw)
    assert {k: v for k, v in ri.items() if k != "seconds"} == \
        {k: v for k, v in ti.items() if k != "seconds"}
    assert r2.lost_report == t2.lost_report
    return r2, t2, ti


def test_torn_persist_quarantine_matches_reference(base_pools, tmp_path):
    """A torn msync reverts the same seeded cachelines in both pools;
    reopen quarantines the same rows into the same report, serves every
    acked key correctly or lists it lost, and heals the checksums."""
    r, t, rplan, tplan, rpath, tpath = _pair(base_pools, tmp_path, seed=11,
                                             torn_line_frac=0.5)
    keys = base_pools[1]
    fresh = unique_keys(np.random.default_rng(9), 300, lo=2**62)
    for tab, plan, exc in ((r, rplan, RSimulatedCrash), (t, tplan, TornPersist)):
        plan.torn_fences = frozenset([plan.fence_calls + 1])
        tab.insert(fresh, _vals(300, base=5000))
        with pytest.raises(exc):
            tab.flush()
    assert tplan.tears == 1 and tplan.torn_bytes > 0
    assert _plan_stats(rplan) == _plan_stats(tplan)
    assert_same_pool(rpath, tpath, "torn")
    r2, t2, info = _reopen_both(rpath, tpath, faults=None)
    assert_same_pool(rpath, tpath, "reopened")
    fr, vr = r2.search(keys)
    f, v = t2.search(keys)
    np.testing.assert_array_equal(f, fr)
    np.testing.assert_array_equal(v, vr)
    assert int((f & (v != _vals(keys.size))).sum()) == 0    # never a wrong read
    for i in np.flatnonzero(~f):                            # every miss reported
        assert _lost_covers(t2, int(keys[i])), f"acked key {keys[i]} silently lost"
    bad = t2.writeback.pool.verify_checksums()
    assert bad["bt"].size == 0 and bad["nb"].size == 0      # healed


def test_bit_rot_quarantine_matches_reference(base_pools, tmp_path):
    d, keys = base_pools
    paths = []
    for side, pool_mod, plan_cls in (("ref", rp.PmPool, RPlan), ("port", PmPool, FaultPlan)):
        path = str(tmp_path / f"{side}.pool")
        shutil.copyfile(d / f"{side}.pool", path)
        plan = plan_cls(seed=5, flip_csum_frac=0.3)
        pool = pool_mod.open(path, faults=plan)
        plan.flip_bits(pool, n=6)
        pool.close()
        paths.append(path)
    assert_same_pool(*paths, "rotted")
    r2, t2, info = _reopen_both(*paths)
    assert info["quarantined_bt"] + info["quarantined_nb"] > 0 and t2.lost_report
    assert_same_state(r2.state, t2.state, "quarantined")
    fr, vr = r2.search(keys)
    f, v = t2.search(keys)
    np.testing.assert_array_equal(f, fr)
    np.testing.assert_array_equal(v, vr)
    assert int((f & (v != _vals(keys.size))).sum()) == 0
    for i in np.flatnonzero(~f):
        assert _lost_covers(t2, int(keys[i]))
    r2.close(), t2.close()
    assert_same_pool(*paths, "healed")
    t3, info3 = tp.reopen(paths[1], device="cpu")  # healing is durable
    assert info3["quarantined_bt"] == info3["quarantined_nb"] == 0


def test_scrubber_repairs_match_reference(base_pools, tmp_path):
    r, t, rplan, tplan, rpath, tpath = _pair(base_pools, tmp_path, seed=6)
    scrubs = []
    for tab, plan, cls in ((r, rplan, RScrubber), (t, tplan, Scrubber)):
        scrub = cls(tab.writeback, rows_per_tick=512)
        plan.flip_bits(tab.writeback.pool, n=4)
        assert tab.writeback.pool.verify_checksums()["bt"].size + \
            tab.writeback.pool.verify_checksums()["nb"].size > 0
        reports = []
        while scrub.cycles == 0:
            reports.append(scrub.tick(tab.state))
        scrubs.append((reports, scrub.stats()))
    assert scrubs[0] == scrubs[1]
    assert scrubs[1][1]["scrub_repaired_rows"] == scrubs[1][1]["scrub_mismatched_rows"] >= 1
    assert_same_pool(rpath, tpath, "scrubbed")
    bad = t.writeback.pool.verify_checksums()
    assert bad["bt"].size == 0 and bad["nb"].size == 0      # live state healed it


def test_heap_top_floor_matches_reference():
    """The pointer-mode reopen guard raises a stale ``heap_top`` past the
    highest live handle, as the reference does."""
    from repro.core import DashEH
    cfg = dataclasses.replace(SMALL, pointer_mode=True, key_heap_size=4096,
                              key_heap_words=2)
    ref = DashEH(cfg)
    ref.insert(values=_vals(300), words=chaos._words_of(np.arange(1, 301), 2))
    stale = ref.state._replace(heap_top=ref.state.heap_top - 40)
    want = rrec.heap_top_floor(cfg, stale)
    got = trec.heap_top_floor(port_cfg(cfg), to_port(cfg, stale))
    assert int(got.heap_top) == int(np.asarray(want.heap_top)) == 300
    got = trec.heap_top_floor(port_cfg(cfg), to_port(cfg, ref.state))
    assert int(got.heap_top) == 300                          # never lowered


def test_heap_top_floor_guards_reopened_allocator(tmp_path):
    """Kill a pointer-mode flush at every store boundary; after each torn
    reopen, KEEP INSERTING: acked keys survive the post-crash inserts."""
    cfg = port_cfg(dataclasses.replace(SMALL, pointer_mode=True, key_heap_size=4096,
                                       key_heap_words=2))
    p = str(tmp_path / "t.pool")
    t = tp.create(p, cfg, device="cpu")
    acked = np.arange(1, 201, dtype=np.uint64)
    t.insert(values=_vals(200), words=chaos._words_of(acked, 2))
    t.flush()
    base = p + ".base"
    shutil.copyfile(p, base)
    t.insert(values=_vals(100, base=9000),
             words=chaos._words_of(np.arange(201, 301, dtype=np.uint64), 2))
    shutil.copyfile(base, p + ".scratch")
    wb = WritebackEngine(PmPool.open(p + ".scratch"))
    wb.inject_crash(1 << 30)
    wb.flush(t.state)
    ops_total = (1 << 30) - wb._ops_budget
    post = np.arange(1001, 1101, dtype=np.uint64)
    for k in range(0, ops_total + 1, 3):
        shutil.copyfile(base, p)
        wb = WritebackEngine(PmPool.open(p))
        wb.inject_crash(k)
        try:
            wb.flush(t.state)
        except SimulatedCrash:
            pass
        t2, _ = tp.reopen(p, device="cpu")
        t2.insert(values=_vals(100, base=7000), words=chaos._words_of(post, 2))
        f, v = t2.search(words=chaos._words_of(acked, 2))
        assert f.all(), f"cut {k}: post-reopen inserts ate acked keys"
        assert (v == _vals(200)).all(), f"cut {k}: torn values"


# -- the durable frontend -----------------------------------------------------


def _fixed_recorders(monkeypatch, ref, port):
    """Flight recorders with the same deterministic clocks on both tables
    (the frontends adopt an attached recorder), so the recorder windows —
    and so the flushed bytes — are equal."""
    monkeypatch.setattr(time, "time", lambda: 1.7e9)   # window headers' wall clock
    ref.writeback.attach_recorder(RRecorder(clock=counter_clock()))
    port.writeback.attach_recorder(TRecorder(clock=counter_clock(), wall=time.time))


def _drive_pair(fr, ft, keys, every: int = 40, update_every: int = 5):
    """The same op stream into both frontends, stepped tick for tick."""
    ops = {"ref": [], "port": []}
    admitted = {"ref": [], "port": []}
    for i, k in enumerate(keys):
        for f, side, m in ((fr, "ref", rfe), (ft, "port", tfe)):
            group = [m.Op(m.INSERT, int(k), i + 1)]
            if i % 3 == 0:
                group.append(m.Op(m.READ, int(keys[i // 2])))
            if i % update_every == 0 and i > 50:
                group.append(m.Op(m.UPDATE, int(keys[i // 3]), 5))
            for op in group:
                ops[side].append(op)
                admitted[side].append(f.submit(op))
        if i % every == every - 1:
            assert fr.step() == ft.step()
    while fr.busy or ft.busy:
        assert fr.step() == ft.step()
    assert admitted["ref"] == admitted["port"]
    out = [[(o.kind, o.key, o.status, o.found, o.result) for o in ops[s]]
           for s in ("ref", "port")]
    assert out[0] == out[1]
    return ops["port"]


def _same_stats(fr, ft):
    sr, st = fr.stats(), ft.stats()
    assert set(sr) == set(st)
    assert {k: sr[k] for k in sr if "seconds" not in k} == \
        {k: st[k] for k in st if "seconds" not in k}
    return st


def test_frontend_flush_on_publish_matches_reference(tmp_path, monkeypatch):
    """The same op stream through both durable frontends (scrubber every
    tick, flight recorder with fixed clocks): per-op outcomes, every
    tick's work, ``stats()`` apart from the seconds and the pool bytes
    equal; after a kill both reopen and serve the same reads, recovering
    lazily on the read path."""
    a, b = str(tmp_path / "ref.pool"), str(tmp_path / "port.pool")
    ref, port = rp.create(a, SMALL), tp.create(b, port_cfg(SMALL), device="cpu")
    _fixed_recorders(monkeypatch, ref, port)
    kw = dict(max_batch=128, scrub_interval=1, scrub_rows=64)
    fr, ft = rfe.DashFrontend(ref, **kw), tfe.DashFrontend(port, **kw)
    keys = unique_keys(np.random.default_rng(14), 480)
    _drive_pair(fr, ft, keys)
    st = _same_stats(fr, ft)
    assert st["flushes"] == st["published"] + 1 and st["flush_hint_misses"] == 0
    assert st["scrub_scanned_rows"] > 0 and st["logged_rows"] > 0
    assert_same_pool(a, b, "after the drain")
    del fr, ft, ref, port                          # the kill
    reads = {}
    for side, mod, m in (("ref", rp, rfe), ("port", tp, tfe)):
        path = a if side == "ref" else b
        t, info = mod.reopen(path) if side == "ref" else mod.reopen(path, device="cpu")
        assert not info["clean"]
        f = m.DashFrontend(t, max_batch=128)
        rops = [m.Op(m.READ, int(k)) for k in keys[:256]]
        for op in rops:
            f.submit(op)
        f.drain()
        reads[side] = ([(o.found, o.result) for o in rops], t.recovered_segments)
    assert reads["ref"] == reads["port"]
    assert all(found for found, _ in reads["port"][0]) and reads["port"][1] > 0


def test_frontend_degrades_and_recovers_like_reference(tmp_path, monkeypatch):
    """An EIO burst past the retry budget turns both frontends DEGRADED at
    the same tick; reads keep serving; ``try_recover`` returns both to
    HEALTHY after the same probes, and the resynced pools are equal."""
    a, b = str(tmp_path / "ref.pool"), str(tmp_path / "port.pool")
    rplan, tplan = RPlan(seed=7), FaultPlan(seed=7)
    ref = rp.create(a, SMALL, faults=rplan)
    port = tp.create(b, port_cfg(SMALL), faults=tplan, device="cpu")
    _fixed_recorders(monkeypatch, ref, port)
    fr, ft = rfe.DashFrontend(ref), tfe.DashFrontend(port)
    keys = unique_keys(np.random.default_rng(1), 200)
    _drive_pair(fr, ft, keys[:120])
    assert ft.health == tfe.HEALTHY
    rplan.eio_fences[rplan.fence_calls] = 9
    tplan.eio_fences[tplan.fence_calls] = 9
    _drive_pair(fr, ft, keys[120:])
    assert ft.health == tfe.DEGRADED and ft.degraded_events == 1
    assert ft.unflushed_publishes >= 1
    rr, rt = rfe.Op(rfe.READ, int(keys[0])), tfe.Op(tfe.READ, int(keys[0]))
    fr.submit(rr), ft.submit(rt)
    fr.drain(), ft.drain()
    assert rt.found and rr.result == rt.result          # reads keep serving
    tries = [(fr.try_recover(), ft.try_recover()) for _ in range(10)]
    assert all(x == y for x, y in tries)
    assert ft.health == tfe.HEALTHY and port.writeback.recoveries == 1
    _same_stats(fr, ft)
    assert_same_pool(a, b, "resynced")
    ft.shutdown()
    port.close()
    t2, _ = tp.reopen(b, device="cpu")                  # degraded-window keys resynced
    fo, _ = t2.search(keys)
    assert fo.all()


def test_durable_frontend_readonly_on_capacity_like_reference(tmp_path, monkeypatch):
    """Capacity exhaustion with ``readonly_on_full`` over a durable table:
    READONLY at the same tick, in-flight writes DROPPED, reads served,
    and every publish flushed alike."""
    cfg = DashConfig(max_segments=2, dir_depth_max=1, num_buckets=4,
                     num_slots=4, num_stash=1)
    a, b = str(tmp_path / "ref.pool"), str(tmp_path / "port.pool")
    ref, port = rp.create(a, cfg), tp.create(b, port_cfg(cfg), device="cpu")
    _fixed_recorders(monkeypatch, ref, port)
    fr = rfe.DashFrontend(ref, readonly_on_full=True)
    ft = tfe.DashFrontend(port, readonly_on_full=True)
    ops, admitted = {"ref": [], "port": []}, {"ref": [], "port": []}
    for k in unique_keys(np.random.default_rng(3), 160):
        for f, side, m in ((fr, "ref", rfe), (ft, "port", tfe)):
            ops[side].append(m.Op(m.INSERT, int(k), int(k & 0x7FFFFFFF)))
            admitted[side].append(f.submit(ops[side][-1]))
        assert fr.step() == ft.step()
    fr.drain(), ft.drain()
    assert admitted["ref"] == admitted["port"]
    assert [o.status for o in ops["ref"]] == [o.status for o in ops["port"]]
    assert any(o.status == rfe.DROPPED for o in ops["port"])
    assert ft.health == tfe.READONLY and fr.health == rfe.READONLY
    assert not ft.submit(tfe.Op(tfe.INSERT, 123, 1))     # writes rejected
    assert not ft.try_recover()                          # READONLY is terminal
    _same_stats(fr, ft)
    assert_same_pool(a, b, "readonly")


# -- the chaos matrix ---------------------------------------------------------

def test_chaos_matrix_quick_on_port(tmp_path):
    """Eight seeded schedules with forced tears + flips on the port;
    ``run_schedule`` raises on any safety violation."""
    agg = chaos.run_many(range(8), str(tmp_path), min_tears=1, min_flips=1, device="cpu")
    assert agg["schedules"] == 8
    assert agg["wrong_reads"] == 0 and agg["silent_lost"] == 0
    assert agg["tears"] >= 8 and agg["flips"] >= 8 and agg["crashes"] >= 8
    assert agg["flushes"] > 0 and agg["ops"] > 0


@pytest.mark.parametrize("seed", [1, 2])
def test_chaos_schedule_matches_reference(tmp_path, seed):
    """One seed replays the same schedule in both packages: every counter
    of the ``ScheduleResult`` equal (seed 1 degrades and recovers, seed 2
    runs pointer mode through an ENOSPC rehearsal)."""
    want = rchaos.run_schedule(seed, str(tmp_path), min_tears=1, min_flips=1)
    got = chaos.run_schedule(seed, str(tmp_path), min_tears=1, min_flips=1, device="cpu")
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


@pytest.mark.slow
def test_chaos_matrix_full_on_port(tmp_path):
    """The reference's wide sweep on the port: 64 seeds, EIO + ENOSPC +
    tears + flips + scrub + pointer-mode lineages, zero silent wrong
    reads."""
    agg = chaos.run_many(range(100, 164), str(tmp_path), min_tears=1, min_flips=1,
                         device="cpu")
    assert agg["schedules"] == 64
    assert agg["wrong_reads"] == 0 and agg["silent_lost"] == 0
    assert agg["tears"] >= 64 and agg["eio_raised"] > 0
    assert agg["degraded_events"] > 0 and agg["pointer_mode"] > 0
