"""Port parity: the durable PM pool (the cases of ``test_persist.py``, each
held to the reference).

The pool file is the reference's format, so the checks are byte checks: the
plane/log/recorder/checksum layout equals the reference's for EH, LH and
pointer mode; the same op stream leaves the same pool bytes after every
flush, with the same flush counters; each package reopens the other's pool
to the same state; and a flush killed at every store boundary leaves the
reference's torn bytes and reopens with every acknowledged key.
Flush-on-publish through ``DashFrontend`` is held to the reference in
``test_torch_faults.py``, beside the frontend's health states.
"""
import dataclasses
import os
import shutil

import numpy as np
import pytest
import torch

from repro import persist as rp
from repro.core import DashConfig, layout as rlayout
from repro.persist.pool import PmPool as RPool
from repro.persist.writeback import SimulatedCrash as RSimulatedCrash
from repro.persist.writeback import WritebackEngine as REngine
from repro_torch import interop
from repro_torch import persist as tp
from repro_torch.core import layout as tlayout
from repro_torch.persist import SimulatedCrash
from repro_torch.persist.pool import PmPool as TPool
from repro_torch.persist.writeback import WritebackEngine as TEngine
from tests.conftest import unique_keys
from tests.torch_parity import (assert_same_counters, assert_same_pool, assert_same_state,
                                port_cfg)

SMALL = DashConfig(max_segments=16, dir_depth_max=8, num_buckets=16, num_slots=8)
LH_CFG = DashConfig(max_segments=32, num_stash=4, num_buckets=16, num_slots=8)
PTR_CFG = dataclasses.replace(SMALL, pointer_mode=True, key_heap_size=4096,
                              key_heap_words=2)


def _vals(n, base=1):
    return (np.arange(n) % 2**31).astype(np.uint32) + base


def _words(keys):
    keys = np.asarray(keys, np.uint64)
    out = np.zeros((keys.size, 2), np.uint32)
    out[:, 0] = (keys & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    out[:, 1] = (keys >> np.uint64(32)).astype(np.uint32)
    return out


# -- layout -------------------------------------------------------------------

@pytest.mark.parametrize("cfg,mode", [
    (SMALL, "eh"), (LH_CFG, "lh"), (PTR_CFG, "eh"),
    (DashConfig(max_segments=32768, dir_depth_max=17), "eh"),
], ids=["eh", "lh", "pointer", "main-geometry"])
def test_pool_layout_matches_reference(cfg, mode):
    ref = rlayout.pool_plane_specs(cfg, mode)
    port = tlayout.pool_plane_specs(port_cfg(cfg), mode)
    assert [dataclasses.astuple(s) for s in port[0]] == \
        [dataclasses.astuple(s) for s in ref[0]]
    for a, b in zip(port[1:4], ref[1:4]):        # log, blackbox, checksum regions
        assert dataclasses.astuple(a) == dataclasses.astuple(b)
    assert port[4] == ref[4]
    assert tlayout.pool_nbytes(port_cfg(cfg), mode) == rlayout.pool_nbytes(cfg, mode)
    assert tlayout.log_routing_planes(port_cfg(cfg)) == rlayout.log_routing_planes(cfg)
    assert (tlayout.POOL_ALIGN, tlayout.SUPERBLOCK_BYTES, tlayout.BLACKBOX_BYTES,
            tlayout.CSUM_PLANES) == (rlayout.POOL_ALIGN, rlayout.SUPERBLOCK_BYTES,
                                     rlayout.BLACKBOX_BYTES, rlayout.CSUM_PLANES)


@pytest.mark.parametrize("dtype,shape", [
    (np.uint8, (300, 16)), (np.uint8, (300, 4)), (np.uint32, (300, 8)),
    (np.uint32, (300,)), (np.int32, (7, 5, 3)),
])
def test_row_checksum_matches_reference(dtype, shape):
    rng = np.random.default_rng(4)
    rows = rng.integers(0, np.iinfo(dtype).max, shape, dtype=np.int64).astype(dtype)
    rows[:3] = 0                                  # zero rows checksum to 0
    got = tlayout.np_row_checksum(rows)
    assert got.dtype == np.uint32 and (got[:3] == 0).all()
    np.testing.assert_array_equal(got, rlayout.np_row_checksum(rows))


# -- one op stream, byte for byte --------------------------------------------

def _stream(seed):
    """The flushes of a durable stream, each a list of op batches: inserts
    through splits; deletes and updates of live keys with more inserts; a
    crash with every artifact class."""
    keys = unique_keys(np.random.default_rng(seed), 1024)
    vals = _vals(keys.size, base=seed)
    out = [[("insert", keys[a:a + 256], vals[a:a + 256])] for a in (0, 256, 512)]
    out += [[("delete", keys[:768:6], None),
             ("update", keys[1:768:6], _vals(128, base=9000)),
             ("insert", keys[768:], vals[768:])], [("crash", None, None)]]
    return out, keys


def _apply(table, op, keys, vals):
    if op == "crash":
        table.crash(np.random.default_rng(3), lock_frac=0.2, n_dups=6,
                    interrupt_smo=table.mode == "eh")
        return None
    kw = {"words": _words(keys)} if table.cfg.pointer_mode else {"keys": keys}
    if vals is not None:
        kw["values"] = vals
    return getattr(table, op)(**kw)


@pytest.mark.parametrize("cfg,mode", [(SMALL, "eh"), (LH_CFG, "lh"), (PTR_CFG, "eh")],
                         ids=["eh", "lh", "pointer"])
def test_flush_stream_pool_bytes_match_reference(tmp_path, cfg, mode):
    """Every flush of the same stream leaves the same pool file with the
    same counters: splits (rebuilt rows through the redo log), deletes,
    updates, crash artifacts, the reopen's marker flush, lazy recovery on
    reads, the clean close."""
    a, b = str(tmp_path / "ref.pool"), str(tmp_path / "port.pool")
    ref = rp.create(a, cfg, mode=mode)
    port = tp.create(b, port_cfg(cfg), mode=mode, device="cpu")
    assert_same_pool(a, b, "create")
    flushes, keys = _stream(seed=7 if mode == "eh" else 8)
    for i, batches in enumerate(flushes):
        for op, k, v in batches:
            out_r, out_p = _apply(ref, op, k, v), _apply(port, op, k, v)
            if out_r is not None:
                np.testing.assert_array_equal(out_r, out_p)
        assert ref.flush() == port.flush()
        assert_same_pool(a, b, f"flush {i}")
        assert_same_counters(ref.writeback, port.writeback, f"flush {i}")
        assert_same_state(ref.state, port.state, f"flush {i}")
        wb = port.writeback
        if cfg.pointer_mode and i == 1:
            # an incremental insert batch flushes O(dirty rows + heap
            # tail): the key heap is written and staged at its tail only
            assert wb.last_heap_tail_rows == 256
            assert wb.last_flush_bytes < wb.pool.plane_bytes // 2
            assert wb.last_staged_bytes < wb.pool.plane_bytes // 2
    assert port.writeback.logged_rows > 0 and port.n_segments > 4
    del ref, port                                 # the kill: no close()
    ref, info_r = rp.reopen(a)
    port, info_p = tp.reopen(b, device="cpu")
    assert not info_p["clean"]
    assert {k: v for k, v in info_r.items() if k != "seconds"} == \
        {k: v for k, v in info_p.items() if k != "seconds"}
    assert_same_pool(a, b, "reopen")
    kw = {"words": _words(keys)} if cfg.pointer_mode else {"keys": keys}
    fr, vr = ref.search(**kw)
    fp, vp = port.search(**kw)
    np.testing.assert_array_equal(fr, fp)
    np.testing.assert_array_equal(vr, vp)
    assert ref.recovered_segments == port.recovered_segments > 0
    ref.flush(), port.flush()
    assert_same_pool(a, b, "flush after lazy recovery")
    ref.close(), port.close()
    assert_same_pool(a, b, "close")


def test_each_side_reopens_the_others_pool(tmp_path):
    """A pool the reference wrote reopens in the port to the reference's
    own reopened state, and the other way round (dirty, with a crash's
    artifacts in the pool)."""
    keys = unique_keys(np.random.default_rng(12), 900)
    paths = {}
    for side, mod in (("ref", rp), ("port", tp)):
        p = str(tmp_path / f"{side}.pool")
        kw = {} if side == "ref" else {"device": "cpu"}
        t = mod.create(p, SMALL if side == "ref" else port_cfg(SMALL), **kw)
        t.insert(keys, _vals(900))
        t.flush()
        t.crash(np.random.default_rng(2), lock_frac=0.2, n_dups=4)
        t.flush()
        del t
        paths[side] = p
    for writer in ("ref", "port"):
        src = paths[writer]
        for reader in ("ref", "port"):
            shutil.copyfile(src, str(tmp_path / f"{writer}-{reader}.pool"))
        r, _ = rp.reopen(str(tmp_path / f"{writer}-ref.pool"))
        t, _ = tp.reopen(str(tmp_path / f"{writer}-port.pool"), device="cpu")
        assert_same_state(r.state, t.state, f"{writer}'s pool")
        assert_same_pool(str(tmp_path / f"{writer}-ref.pool"),
                   str(tmp_path / f"{writer}-port.pool"), f"{writer}'s pool reopened")
        f, v = t.search(keys)
        assert f.all() and (v == _vals(900)).all()


# -- the crash matrix ---------------------------------------------------------

def _ops_total(engine_cls, pool_cls, base, scratch, state):
    shutil.copyfile(base, scratch)
    wb = engine_cls(pool_cls.open(scratch))
    wb.inject_crash(1 << 30)
    wb.flush(state)
    return (1 << 30) - wb._ops_budget


@pytest.mark.parametrize("workload", ["inserts_smo", "mixed"])
def test_torn_flush_matrix_matches_reference(tmp_path, workload):
    """The reference's crash matrix on the port: kill the flush at EVERY
    store boundary; the torn pool holds the reference's bytes at each cut
    and reopens with every acknowledged key (and value) intact."""
    rng = np.random.default_rng(11)
    keys = unique_keys(rng, 2000)
    acked = keys[:800]
    pr, pt = str(tmp_path / "ref.pool"), str(tmp_path / "port.pool")
    ref, port = rp.create(pr, SMALL), tp.create(pt, port_cfg(SMALL), device="cpu")
    deleted = updated = np.array([], np.uint64)
    for t in (ref, port):
        t.insert(acked, _vals(800))
        t.flush()
        if workload == "inserts_smo":
            t.insert(keys[800:1200], _vals(400, base=5000))
        else:
            deleted, updated = acked[::7], acked[3::7]
            t.delete(deleted)
            t.update(updated, _vals(updated.size, base=9000))
            t.insert(keys[800:1000], _vals(200, base=5000))
    assert_same_state(ref.state, port.state)
    base_r, base_t = pr + ".base", pt + ".base"
    shutil.copyfile(pr, base_r)
    shutil.copyfile(pt, base_t)
    assert_same_pool(base_r, base_t, "base")
    survivors = np.setdiff1d(acked, np.concatenate([deleted, updated]))
    total = _ops_total(TEngine, TPool, base_t, pt + ".scratch", port.state)
    assert total == _ops_total(REngine, RPool, base_r, pr + ".scratch", ref.state) > 5
    for k in range(total + 1):
        for base, path, eng, pool, st in ((base_r, pr, REngine, RPool, ref.state),
                                          (base_t, pt, TEngine, TPool, port.state)):
            shutil.copyfile(base, path)
            wb = eng(pool.open(path))
            wb.inject_crash(k)
            try:
                wb.flush(st)
                assert k >= total
            except (SimulatedCrash, RSimulatedCrash):
                assert k < total
            del wb
        assert_same_pool(pr, pt, f"cut {k}")
        t2, info = tp.reopen(pt, device="cpu")
        assert not info["clean"]
        f, v = t2.search(acked)
        mask = np.isin(acked, survivors)
        assert f[mask].all(), f"cut {k}: lost {int((~f[mask]).sum())} acked keys"
        assert (v[mask] == _vals(800)[mask]).all(), f"cut {k}: torn values"
        if k >= total:
            f3, _ = t2.search(np.setdiff1d(
                keys[800:1200] if workload == "inserts_smo" else keys[800:1000], deleted))
            assert f3.all()


def test_torn_flush_then_more_work(tmp_path):
    """A reopened torn pool keeps working: inserts, splits, flushes and a
    clean second reopen."""
    rng = np.random.default_rng(5)
    p = str(tmp_path / "t.pool")
    t = tp.create(p, port_cfg(SMALL), device="cpu")
    keys = unique_keys(rng, 1500)
    t.insert(keys[:600], _vals(600))
    t.flush()
    base = p + ".base"
    shutil.copyfile(p, base)
    t.insert(keys[600:1100], _vals(500, base=2000))
    ops = _ops_total(TEngine, TPool, base, p + ".scratch", t.state)
    shutil.copyfile(base, p)
    wb = TEngine(TPool.open(p))
    wb.inject_crash(max(ops - 2, 1))
    with pytest.raises(SimulatedCrash):
        wb.flush(t.state)
    t2, _ = tp.reopen(p, device="cpu")
    t2.insert(keys[1100:], _vals(400, base=8000))
    t2.flush()
    t2.close()
    t3, info = tp.reopen(p, device="cpu")
    assert info["clean"]
    f, _ = t3.search(np.concatenate([keys[:600], keys[1100:]]))
    assert f.all()


# -- entry points ------------------------------------------------------------

def test_create_and_reopen_default_to_the_card(tmp_path, monkeypatch):
    """Without ``device`` the durable entry points run on the card, and
    raise without one — leaving no pool file behind."""
    p = str(tmp_path / "t.pool")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tp.create(p, port_cfg(SMALL))
    assert not os.path.exists(p)
    t = tp.create(p, port_cfg(SMALL), device="cpu")
    t.close()
    with pytest.raises(RuntimeError, match="CUDA"):
        tp.reopen(p)
    t2, info = tp.reopen(p, device="cpu")
    assert info["clean"] and t2.device == torch.device("cpu")
    planes = interop.state_to_numpy(t2.state)
    assert planes["meta"].dtype == np.uint32 and planes["clean"].dtype == np.bool_
    t2.close()
    # open-or-create: a missing pool is created, an existing one reopened
    q = str(tmp_path / "q.pool")
    t3, info3 = tp.durable_open(q, port_cfg(SMALL), mode="lh", device="cpu")
    assert info3["created"] and t3.mode == "lh"
    t3.close()
    t4, info4 = tp.durable_open(q, device="cpu")
    assert info4["clean"] and t4.mode == "lh"
    t5, info5 = tp.durable_open(p, device="cpu")
    assert info5["clean"] and t5.mode == "eh"
