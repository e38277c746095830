"""Port parity: the online-resize serving frontend (the cases of
``test_frontend.py``, each checked against the reference).

Both frontends get the same op stream and are stepped tick for tick: every
tick must do work in both or in neither, and at the end the per-op
``(kind, key, status, found, result)``, the snapshot/retry split of the
reads, the SMO stage and dispatch counts, ``stats()`` (apart from the
publish seconds) and the final table must all be equal. Latencies are
never compared. The epoch manager, the admission pipeline, the verify
masks, ``snapshot_search`` and the YCSB generator are held to the
reference on the same inputs.
"""
import gc
import weakref

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import DashConfig, DashEH, DashLH
from repro.core.epoch import EpochManager as REpochManager
from repro.core.epoch import SnapshotRegistry as RRegistry
from repro.core.hashing import np_split_keys
from repro.serving import buckets_changed as r_changed, snapshot_search as r_snapsearch
from repro.serving import frontend as rfe
from repro.workloads import ycsb as rycsb
from repro_torch import interop
from repro_torch.core import DashEH as TDashEH, DashLH as TDashLH
from repro_torch.core import engine as te
from repro_torch.core.epoch import EpochManager, SnapshotRegistry, shared_planes
from repro_torch.serving import buckets_changed, snapshot_search
from repro_torch.serving import frontend as tfe
from repro_torch.workloads import ycsb
from tests.conftest import unique_keys
from tests.torch_parity import assert_same_state, port_cfg, ref_copy, to_port, words

CFG = DashConfig(max_segments=32, dir_depth_max=7, num_buckets=16,
                 num_slots=8)


# ---------------------------------------------------------------------------
# epoch manager + snapshot registry
# ---------------------------------------------------------------------------

def _epoch_script(mgr_cls):
    freed = []
    mgr = mgr_cls(reclaim=freed.append)
    trace = []
    with mgr.pin():
        mgr.retire("v0")
        mgr.retire("v1")
        trace.append((list(freed), mgr.limbo_size, mgr.active_readers))
    for i in range(4):
        mgr.retire(f"x{i}")
        trace.append((list(freed), mgr.limbo_size, mgr.global_epoch))
    mgr.flush()
    trace.append((list(freed), mgr.reclaimed, mgr.global_epoch))
    return trace


def test_epoch_manager_matches_reference():
    assert _epoch_script(EpochManager) == _epoch_script(REpochManager)
    trace = _epoch_script(EpochManager)
    assert trace[0][0] == []                 # a pinned reader blocks reclaim
    assert "v0" in trace[-2][0] and "v1" in trace[-2][0]


def _registry_script(reg_cls):
    freed = []
    reg = reg_cls(reclaim=lambda s: freed.append(s.version))
    out = []
    reg.publish("s0")
    with reg.acquire() as snap:
        out.append((snap.version, snap.state, snap.pins))
        reg.publish("s1")
        out.append((reg.version, list(freed)))
    for i in range(4):
        reg.publish(f"s{i + 2}")
        out.append((reg.version, list(freed)))
    reg.flush()
    out.append((sorted(freed), reg.published, reg.reclaimed))
    return out


def test_snapshot_registry_matches_reference():
    got = _registry_script(SnapshotRegistry)
    assert got == _registry_script(RRegistry)
    assert got[-1][0] == [0, 1, 2, 3, 4]     # all but current reclaimed


def test_snapshot_reclaim_releases_payloads():
    """The pooled registry drops its references to a retired payload: the
    tensor is gone once nothing else holds it."""
    reg, rref = SnapshotRegistry(), RRegistry()
    first = torch.arange(4)
    gone = weakref.ref(first)
    reg.publish(first)
    rref.publish(jnp.arange(4))
    del first
    for _ in range(5):
        reg.publish(torch.arange(4))
        rref.publish(jnp.arange(4))
    gc.collect()
    assert gone() is None
    assert reg.reclaimed == rref.reclaimed >= 1
    assert reg.pool.freed == reg.reclaimed


# ---------------------------------------------------------------------------
# admission pipeline
# ---------------------------------------------------------------------------

def test_admission_and_batch_forming_match_reference():
    for mod in (rfe, tfe):
        q = mod.AdmissionQueue(depth=2)
        assert q.offer(mod.Op(mod.READ, 1)) and q.offer(mod.Op(mod.READ, 2))
        assert not q.offer(mod.Op(mod.READ, 3))   # bounded: reject
        assert (q.rejected, q.admitted) == (1, 2)
        q.pop()
        assert q.offer(mod.Op(mod.READ, 3))
    runs = []
    for mod in (rfe, tfe):
        q = mod.AdmissionQueue()
        kinds = [mod.INSERT, mod.INSERT, mod.UPDATE, mod.INSERT, mod.READ,
                 mod.READ, mod.READ]
        for i, k in enumerate(kinds):
            q.offer(mod.Op(k, i, i))
        f = mod.BatchFormer(max_batch=2)
        out = []
        while True:
            b = f.form(q)
            if not b:
                break
            out.append([(op.kind, op.key) for op in b])
        runs.append(out)
    assert runs[0] == runs[1]
    assert runs[1][:3] == [[("insert", 0), ("insert", 1)], [("update", 2)],
                           [("insert", 3)]]


# ---------------------------------------------------------------------------
# verify masks and snapshot search
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["eh", "lh"])
def test_buckets_changed_and_snapshot_search_match_reference(mode):
    cls = DashEH if mode == "eh" else DashLH
    t = cls(CFG)
    keys = unique_keys(np.random.default_rng(21), 600)
    t.insert(keys[:400], np.arange(400, dtype=np.uint32))
    snap = ref_copy(t.state)
    t.update(keys[:16], np.arange(16, dtype=np.uint32) + 7000)
    t.insert(keys[400:416], np.arange(16, dtype=np.uint32) + 400)
    t.delete(keys[200:204])
    q = np.concatenate([keys[:224], keys[400:432]])
    hi, lo = np_split_keys(q)
    want = np.asarray(r_changed(CFG, mode, snap, t.state, jnp.asarray(hi),
                                jnp.asarray(lo)))
    ps, pl = to_port(CFG, snap), to_port(CFG, t.state)
    got = buckets_changed(port_cfg(CFG), mode, ps, pl, words(hi), words(lo))
    assert (got.numpy() == want).all()
    assert want[:16].all() and not want.all()
    for batching in ("auto", "fused", "vmap"):
        f0, v0, n0 = r_snapsearch(CFG, snap, t.state, jnp.asarray(hi),
                                  jnp.asarray(lo), batching=batching, mode=mode)
        f1, v1, n1 = snapshot_search(port_cfg(CFG), ps, pl, words(hi), words(lo),
                                     batching=batching, mode=mode)
        assert (f1.numpy() == np.asarray(f0)).all()
        assert (v1.numpy().view(np.uint32) == np.asarray(v0)).all()
        assert int(n1) == int(n0)


# ---------------------------------------------------------------------------
# YCSB generator
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mix", sorted(ycsb.MIXES))
def test_ycsb_generate_matches_reference(mix):
    loaded = ycsb.load_keys(np.random.default_rng(1), 512)
    assert (loaded == rycsb.load_keys(np.random.default_rng(1), 512)).all()
    fresh = ycsb.load_keys(np.random.default_rng(2), 600)
    if mix == "load":
        loaded = np.array([], np.uint64)
    for dist in ("zipfian", "uniform", "latest"):
        cfg = dict(mix=mix, n_ops=700, seed=3, distribution=dist)
        a = rycsb.generate(rycsb.YCSBConfig(**cfg), loaded, insert_keys=fresh)
        b = ycsb.generate(ycsb.YCSBConfig(**cfg), loaded, insert_keys=fresh)
        assert [(o.kind, o.key, o.value) for o in a] == \
               [(o.kind, o.key, o.value) for o in b]
        assert all(isinstance(o, tfe.Op) for o in b)
    z = ycsb.zipfian_ranks(np.random.default_rng(4), 512, 2000)
    assert (z == rycsb.zipfian_ranks(np.random.default_rng(4), 512, 2000)).all()


# ---------------------------------------------------------------------------
# frontends, tick for tick
# ---------------------------------------------------------------------------

def _mixed_stream(mod, rng, n_load=400, n_fresh=240):
    """The shape of ``test_frontend._mixed_stream``: a load, then fresh
    inserts each followed by a read of a loaded key, an update every third."""
    keys = mod.load_keys(rng, n_load + n_fresh)
    loaded, fresh = keys[:n_load], keys[n_load:]
    ops = [(tfe.INSERT, int(k), mod.expected_value(int(k))) for k in loaded]
    ridx = rng.integers(0, n_load, n_fresh)
    for i, k in enumerate(fresh):
        ops.append((tfe.INSERT, int(k), mod.expected_value(int(k))))
        ops.append((tfe.READ, int(loaded[ridx[i]]), 0))
        if i % 3 == 0:
            kk = int(loaded[ridx[i]])
            ops.append((tfe.UPDATE, kk, mod.updated_value(kk)))
    return keys, ops


def _lockstep(ref_fe, port_fe, ops, step_each=False):
    """Submit ``ops`` to both frontends (stepping after each submit when
    ``step_each``) and tick both until idle. Returns both op lists."""
    r_ops = [rfe.Op(*o) for o in ops]
    t_ops = [tfe.Op(*o) for o in ops]
    for a, b in zip(r_ops, t_ops):
        assert ref_fe.submit(a) == port_fe.submit(b)
        if step_each:
            assert ref_fe.step() == port_fe.step()
    while True:
        did = ref_fe.step()
        assert port_fe.step() == did
        if not did:
            break
    return r_ops, t_ops


def _assert_same_run(ref_fe, port_fe, r_ops, t_ops):
    for a, b in zip(r_ops, t_ops):
        assert (a.kind, a.key, a.status, a.found, a.result) == \
               (b.kind, b.key, b.status, b.found, b.result)
    sa, sb = ref_fe.stats(), port_fe.stats()
    sa.pop("publish_seconds", None)
    sb.pop("publish_seconds", None)
    assert sa == sb
    for attr in ("snapshot_reads", "retried_reads", "smo_stages",
                 "smo_dispatches"):
        assert getattr(ref_fe, attr, None) == getattr(port_fe, attr, None), attr
    assert_same_state(ref_fe.table.state, port_fe.table.state)
    reg = getattr(port_fe, "registry", None)
    if isinstance(port_fe, tfe.DashFrontend):
        assert_same_state(ref_fe.registry.current.state, reg.current.state)
        assert shared_planes(reg.current.state, port_fe.table.state) == []


def _pair(cls, cfg=CFG, **kw):
    t_cls = {DashEH: TDashEH, DashLH: TDashLH}[cls]
    return (rfe.DashFrontend(cls(cfg), **kw),
            tfe.DashFrontend(t_cls(port_cfg(cfg), device="cpu"), **kw))


def test_frontend_eh_mixed_stream_matches_reference():
    keys, ops = _mixed_stream(ycsb, np.random.default_rng(7))
    _, ops_ref = _mixed_stream(rycsb, np.random.default_rng(7))
    assert ops == ops_ref
    ref_fe, port_fe = _pair(DashEH, max_batch=128, queue_depth=1 << 14)
    r_ops, t_ops = _lockstep(ref_fe, port_fe, ops)
    _assert_same_run(ref_fe, port_fe, r_ops, t_ops)
    assert port_fe.smo_dispatches > 0 and port_fe.snapshot_reads > 0
    for op in t_ops:                         # pre- or post-update values
        if op.kind == tfe.READ and op.found:
            assert op.result in (ycsb.expected_value(op.key),
                                 ycsb.updated_value(op.key))
    f, _ = port_fe.table.search(keys)
    assert f.all()


def test_frontend_lh_stride_expansion_matches_reference():
    cfg = DashConfig(max_segments=32, dir_depth_max=7, num_buckets=16,
                     num_slots=8, lh_base_log2=2)
    keys = ycsb.load_keys(np.random.default_rng(3), 700)
    ops = []
    for k in keys:
        ops += [(tfe.INSERT, int(k), ycsb.expected_value(int(k))),
                (tfe.READ, int(k), 0)]
    ref_fe, port_fe = _pair(DashLH, cfg, max_batch=128, queue_depth=1 << 14)
    r_ops, t_ops = _lockstep(ref_fe, port_fe, ops)
    _assert_same_run(ref_fe, port_fe, r_ops, t_ops)
    assert port_fe.table.n_items == 700
    assert port_fe.table.active_segments > (1 << cfg.lh_base_log2)


def test_frontend_rmw_and_delete_match_reference():
    keys = unique_keys(np.random.default_rng(11), 300)
    ops = [(tfe.INSERT, int(k), ycsb.expected_value(int(k))) for k in keys]
    ops += [(tfe.RMW, int(k), ycsb.updated_value(int(k))) for k in keys[:64]]
    ops += [(tfe.DELETE, int(k), 0) for k in keys[32:96]]
    ops += [(tfe.READ, int(k), 0) for k in keys[:128]]
    ref_fe, port_fe = _pair(DashEH, max_batch=64, queue_depth=4096)
    r_ops, t_ops = _lockstep(ref_fe, port_fe, ops)
    _assert_same_run(ref_fe, port_fe, r_ops, t_ops)
    rmw = [op for op in t_ops if op.kind == tfe.RMW]
    assert all(op.found and op.result == ycsb.expected_value(op.key) for op in rmw)


def test_frontend_readonly_on_full_matches_reference():
    cfg = DashConfig(max_segments=2, dir_depth_max=1, num_buckets=4,
                     num_slots=4, num_stash=1)
    keys = unique_keys(np.random.default_rng(3), 200)
    ops = [(tfe.INSERT, int(k), int(k & 0x7FFFFFFF)) for k in keys]
    ref_fe, port_fe = _pair(DashEH, cfg, readonly_on_full=True)
    r_ops, t_ops = _lockstep(ref_fe, port_fe, ops, step_each=True)
    assert port_fe.health == tfe.READONLY == ref_fe.health
    ok = [op for op in t_ops if op.status == 0]
    assert ok and any(op.status != 0 for op in t_ops)
    r_more, t_more = _lockstep(ref_fe, port_fe, [(tfe.READ, ok[0].key, 0),
                                                 (tfe.INSERT, 123, 1)])
    _assert_same_run(ref_fe, port_fe, r_ops + r_more, t_ops + t_more)
    assert t_more[0].found and t_more[0].result == ok[0].value
    assert t_more[1].status == -1            # rejected at admission
    assert not port_fe.try_recover()


def test_stop_the_world_matches_reference():
    keys, ops = _mixed_stream(ycsb, np.random.default_rng(5), 300, 160)
    ref_fe = rfe.StopTheWorldFrontend(DashEH(CFG), max_batch=128,
                                      queue_depth=1 << 14)
    port_fe = tfe.StopTheWorldFrontend(TDashEH(port_cfg(CFG), device="cpu"),
                                       max_batch=128, queue_depth=1 << 14)
    r_ops, t_ops = _lockstep(ref_fe, port_fe, ops)
    _assert_same_run(ref_fe, port_fe, r_ops, t_ops)


def test_frontend_ticks_identical_fused_on_off():
    """The port's fused-read and routed-read frontends, tick for tick: the
    same per-op outcomes, snapshot/retry split and final table."""
    _, ops = _mixed_stream(ycsb, np.random.default_rng(23), 300, 200)
    fes = [tfe.DashFrontend(TDashEH(port_cfg(CFG), device="cpu"), max_batch=128,
                            queue_depth=1 << 14, fused_reads=f)
           for f in (True, False)]
    assert [fe.read_batching for fe in fes] == ["fused", "auto"]
    runs = [[tfe.Op(*o) for o in ops] for _ in fes]
    for a, b in zip(*runs):          # reads overlap the storm's SMO stages
        fes[0].submit(a)
        fes[1].submit(b)
        assert fes[0].step() == fes[1].step()
    while fes[0].step() | fes[1].step():
        pass
    for a, b in zip(*runs):
        assert (a.kind, a.key, a.status, a.found, a.result) == \
               (b.kind, b.key, b.status, b.found, b.result)
    a, b = (interop.state_to_numpy(fe.table.state) for fe in fes)
    assert all(a[k].tobytes() == b[k].tobytes() for k in a)
    assert fes[0].snapshot_reads == fes[1].snapshot_reads
    assert fes[0].retried_reads == fes[1].retried_reads > 0


# ---------------------------------------------------------------------------
# full workload suite through the frontend (slow lane)
# ---------------------------------------------------------------------------

@pytest.mark.slow
@pytest.mark.parametrize("mix", ["A", "B", "C", "D", "E", "F"])
def test_ycsb_suite_through_frontend_matches_reference(mix):
    """Every YCSB mix end-to-end through both frontends, tick for tick."""
    rng = np.random.default_rng(0x5C + ord(mix))
    loaded = ycsb.load_keys(rng, 1500)
    fresh = ycsb.load_keys(np.random.default_rng(ord(mix)), 800)
    ref_fe, port_fe = _pair(DashEH, max_batch=128, queue_depth=1 << 15)
    vals = np.asarray([ycsb.expected_value(int(k)) for k in loaded], np.uint32)
    ref_fe.table.insert(loaded, vals)
    port_fe.table.insert(loaded, vals)
    ref_fe._dirty = port_fe._dirty = True
    ops = ycsb.generate(ycsb.YCSBConfig(mix=mix, n_ops=4000, seed=13),
                        loaded, insert_keys=fresh)
    r_ops, t_ops = _lockstep(ref_fe, port_fe,
                             [(o.kind, o.key, o.value) for o in ops])
    _assert_same_run(ref_fe, port_fe, r_ops, t_ops)
    assert port_fe.table.n_items == int(te.recount_items(port_fe.table.state))


def test_fused_plane_memo_follows_reused_addresses():
    """Each snapshot version hands ``fused_probe`` its own plane tensors,
    and the caching allocator may give a new version a freed version's
    addresses. The wrapper's plane-set memo is keyed by every plane's
    pointer, shape, dtype and layout, and the record it returns is built
    from the key alone, so a reused address gives the record of the
    tensors at hand."""
    from repro_torch.kernels import fused
    from repro_torch.core import layout as tlayout
    cfg = port_cfg(CFG)
    for i in range(4):                       # drop each version, allocate anew
        st = tlayout.make_state(cfg, device="cpu")
        planes = (st.fp, st.meta, st.key_hi, st.key_lo, st.val, st.stash_active)
        rec = fused._checked_planes(fused._plane_key(planes), cfg.num_buckets,
                                    cfg.num_stash, True)
        assert [rec.fp, rec.meta, rec.key_hi, rec.key_lo, rec.val,
                rec.stash_active] == [t.data_ptr() for t in planes]
        assert (rec.num_segments, rec.bt, rec.sl) == tuple(st.key_hi.shape)
        del st, planes
