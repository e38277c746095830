"""Port parity: copy-on-write snapshots (the cases of ``test_cow.py``,
each checked against the reference).

The same seeded operations go through a reference table + registry and a
port table + registry. After every publish the two must agree on
``last_publish_bytes``, ``planes_copied`` and ``planes_aliased`` (so the
port aliases and scatters in place exactly when the reference aliases and
donates), the port's snapshot must equal the live state byte for byte, and
no snapshot plane may share storage with a live plane (the port's engines
update the live planes in place). Reclamation is checked with weak
references: a released plane really is gone, an aliased one survives.
"""
import gc
import weakref

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import DashConfig, DashEH, DashLH
from repro.core import layout
from repro.core.epoch import PlanePool as RPlanePool, SnapshotRegistry as RRegistry
from repro.serving.frontend import (DELETE, INSERT, READ, RMW, UPDATE,
                                    DashFrontend, Op)
from repro.workloads import ycsb
from repro_torch.core import DashEH as TDashEH, DashLH as TDashLH
from repro_torch.core import engine as te, layout as tlayout
from repro_torch.core.epoch import (PlanePool, SnapshotRegistry, shared_planes)
from repro_torch.serving import frontend as tfe
from tests.conftest import unique_keys
from tests.torch_parity import assert_same_state, port_cfg
from repro_torch import interop

CFG = DashConfig(max_segments=32, dir_depth_max=7, num_buckets=16,
                 num_slots=8)
COUNTERS = ("last_publish_bytes", "planes_copied", "planes_aliased",
            "published", "publish_bytes", "hint_misses", "reclaimed")


class Twin:
    """A reference table + registry and a port table + registry driven by
    the same calls."""

    def __init__(self, n=500, cls=(DashEH, TDashEH), cfg=CFG, seed=0xC0):
        self.cfg = cfg
        self.ref, self.port = cls[0](cfg), cls[1](port_cfg(cfg), device="cpu")
        self.keys = unique_keys(np.random.default_rng(seed), n + 400)
        self.n = n
        self.do("insert", self.keys[:n], np.arange(n, dtype=np.uint32))
        self.rreg, self.treg = RRegistry(), SnapshotRegistry()

    def do(self, op, *args):
        a, b = getattr(self.ref, op)(*args), getattr(self.port, op)(*args)
        for x, y in zip(a if op == "search" else [a],
                        b if op == "search" else [b]):
            assert (np.asarray(x) == y).all(), op

    def publish(self, hint=True):
        rs = self.rreg.publish_cow(self.cfg, self.ref.state,
                                   dirty_hint=self.ref.dirty.drain() if hint else None)
        ts = self.treg.publish_cow(port_cfg(self.cfg), self.port.state,
                                   dirty_hint=self.port.dirty.drain() if hint else None)
        check_publish(self.rreg, self.treg, ts.state, self.port.state)
        assert_same_state(rs.state, ts.state)
        return rs, ts


def check_publish(rreg, treg, snap_state, live):
    """Counters equal to the reference's; snapshot == live; no shared
    storage with the live planes."""
    rs, ts = rreg.stats(), treg.stats()
    assert {k: rs[k] for k in COUNTERS} == {k: ts[k] for k in COUNTERS}
    a, b = interop.state_to_numpy(snap_state), interop.state_to_numpy(live)
    assert all(a[k].tobytes() == b[k].tobytes() for k in a)
    assert shared_planes(snap_state, live) == []


# ---------------------------------------------------------------------------
# plane pool
# ---------------------------------------------------------------------------

def test_plane_pool_refcounts():
    ref, pool = RPlanePool(), PlanePool()
    a, ra = torch.arange(16), jnp.arange(16)
    wa = weakref.ref(a)
    for p, x in ((ref, ra), (pool, a)):
        p.incref(x)
        p.incref(x)              # second snapshot aliases the same plane
    assert pool.refcount(a) == ref.refcount(ra) == 2
    assert not pool.decref(a) and not ref.decref(ra)   # still referenced
    assert pool.decref(a) and ref.decref(ra)           # last release frees
    assert ra.is_deleted() and pool.freed == 1
    assert pool.live_planes == ref.live_planes == 0
    del a, x                 # the loop variable held it too
    gc.collect()
    assert wa() is None          # the pool held the last reference


# ---------------------------------------------------------------------------
# COW publish: aliasing + in-place scatter + bit-exactness
# ---------------------------------------------------------------------------

def test_cow_publish_is_bit_exact_and_o_dirty():
    tw = Twin()
    tw.publish()
    whole = tlayout.state_nbytes(tw.port.state)
    assert whole == layout.state_nbytes(tw.ref.state)
    assert tw.treg.last_publish_bytes == whole       # first publish: full copy
    n = tw.n
    tw.do("insert", tw.keys[n:n + 64], np.arange(64, dtype=np.uint32) + n)
    tw.publish()
    assert tw.treg.last_publish_bytes < 0.5 * whole  # O(dirty), not O(table)
    assert tw.treg.hint_misses == 0
    tw.do("update", tw.keys[:32], np.arange(32, dtype=np.uint32) + 7000)
    tw.publish()
    assert tw.treg.last_publish_bytes < 0.5 * whole


def test_cow_unchanged_planes_share_buffers():
    tw = Twin(n=600)
    _, s0 = tw.publish()
    dir0, key_hi0 = s0.state.dir, s0.state.key_hi
    ptr, w_key_hi0 = key_hi0.data_ptr(), weakref.ref(key_hi0)
    splits0 = int(tw.port.state.n_splits)
    tw.do("insert", tw.keys[tw.n:tw.n + 32], np.arange(32, dtype=np.uint32))
    assert int(tw.port.state.n_splits) == splits0     # no SMO this batch
    _, s1 = tw.publish()
    assert s1.state.dir is dir0                       # aliased, refcounted
    assert tw.treg.pool.refcount(dir0) == 2
    # in place: a new tensor object over the same storage
    assert s1.state.key_hi is not key_hi0
    assert s1.state.key_hi.data_ptr() == ptr
    assert tw.treg.planes_aliased >= 1 and tw.treg.planes_copied > 0
    del s0, key_hi0
    tw.do("update", tw.keys[:8], np.arange(8, dtype=np.uint32))
    tw.publish()                                      # v0 reclaimed here
    gc.collect()
    assert w_key_hi0() is None                        # released, not leaked
    assert tw.treg.current.state.key_hi.data_ptr() == ptr


def test_cow_smo_republishes_directory_plane():
    cfg = CFG
    ref_t, port_t = DashEH(cfg), TDashEH(port_cfg(cfg), device="cpu")
    keys = unique_keys(np.random.default_rng(0xC0), 800)
    ref_t.insert(keys[:500], np.arange(500, dtype=np.uint32))
    port_t.insert(keys[:500], np.arange(500, dtype=np.uint32))
    ref_fe = DashFrontend(ref_t, max_batch=128, queue_depth=1 << 14)
    port_fe = tfe.DashFrontend(port_t, max_batch=128, queue_depth=1 << 14)
    dir_before = port_fe.registry.current.state.dir
    splits0 = int(port_t.state.n_splits)
    for k in keys[500:800]:
        ref_fe.submit(Op(INSERT, int(k), ycsb.expected_value(int(k))))
        port_fe.submit(tfe.Op(INSERT, int(k), ycsb.expected_value(int(k))))
    ref_fe.drain()
    port_fe.drain()
    assert int(port_t.state.n_splits) > splits0
    assert port_fe.registry.current.state.dir is not dir_before
    check_publish(ref_fe.registry, port_fe.registry,
                  port_fe.registry.current.state, port_t.state)
    assert_same_state(ref_t.state, port_t.state)
    assert port_fe.stats()["hint_misses"] == 0


# ---------------------------------------------------------------------------
# reclamation safety
# ---------------------------------------------------------------------------

def test_pinned_version_planes_are_never_donated():
    tw = Twin()
    tw.publish()
    keys = tw.keys
    with tw.rreg.acquire(), tw.treg.acquire() as snap:
        val_ptr = snap.state.val.data_ptr()
        tw.do("update", keys[:64], np.arange(64, dtype=np.uint32) + 5000)
        _, s1 = tw.publish()                 # pinned: scattered into clones
        assert snap.state.val.data_ptr() == val_ptr
        assert s1.state.val.data_ptr() != val_ptr
        # the pinned version still reads its own (pre-update) values
        hi, lo = tw.port._prep(keys[:64])[:2]
        f, v = te.search_batch(tw.port.cfg, "eh", snap.state, hi, lo)
        assert f.all() and (v.numpy() == np.arange(64)).all()
    assert_same_state(tw.ref.state, s1.state)


def test_reclaiming_old_versions_never_invalidates_newer_ones():
    tw = Twin()
    tw.publish()
    dir_plane = tw.treg.current.state.dir
    gone = []
    for i in range(8):                      # supersede -> retire -> reclaim
        gone.append(weakref.ref(tw.treg.current.state.n_items))
        tw.do("update", tw.keys[:16], np.arange(16, dtype=np.uint32) + i)
        tw.publish()
    gc.collect()
    assert tw.treg.reclaimed >= 4           # old versions really were freed
    assert sum(w() is None for w in gone) == tw.treg.reclaimed
    cur = tw.treg.current.state
    assert cur.dir is dir_plane             # aliased through the whole chain
    assert_same_state(tw.ref.state, cur)    # newest snapshot fully intact
    tw.do("search", tw.keys[:tw.n])         # live state untouched by reclaims
    tw.rreg.flush()
    tw.treg.flush()
    assert tw.treg.current.state.dir is dir_plane
    assert tw.treg.reclaimed == tw.rreg.reclaimed


def test_cow_force_full_after_crash():
    tw = Twin()
    tw.publish()
    tw.ref.crash(np.random.default_rng(3), interrupt_smo=False)
    tw.port.crash(np.random.default_rng(3), interrupt_smo=False)
    tw.ref.restart()
    tw.port.restart()
    _, s = tw.publish()
    assert tw.treg.last_publish_bytes == tlayout.state_nbytes(tw.port.state)


# ---------------------------------------------------------------------------
# version-bump completeness: content change implies version change
# ---------------------------------------------------------------------------

def _missed_rows(cfg, old, new):
    """Bucket rows whose content changed without a version-word bump."""
    NB = cfg.num_buckets
    vmask = old["version"] != new["version"]
    vm, vm_nb = vmask.reshape(-1), vmask[..., :NB].reshape(-1)
    missed = 0
    for name in tlayout.BT_PLANES + tlayout.NB_PLANES:
        if name == "version":
            continue
        m = vm if name in tlayout.BT_PLANES else vm_nb
        a, b = old[name].reshape(len(m), -1), new[name].reshape(len(m), -1)
        missed += int(((a != b).any(axis=1) & ~m).sum())
    return missed


@pytest.mark.parametrize("mode", ["eh", "lh"])
def test_every_plane_mutation_bumps_its_version_row(mode):
    cls = (DashEH, TDashEH) if mode == "eh" else (DashLH, TDashLH)
    ref, port = cls[0](CFG), cls[1](port_cfg(CFG), device="cpu")
    keys = unique_keys(np.random.default_rng(0xBEEF + (mode == "lh")), 1400)
    rng = np.random.default_rng(7)
    cursor = 0
    for step in range(10):             # fixed batch sizes: few reference traces
        before = interop.state_to_numpy(port.state)
        op = step % 5
        if op in (0, 1, 3):            # inserts drive stash + splits
            args = (keys[cursor:cursor + 128], np.arange(128, dtype=np.uint32))
            cursor += 128
            name = "insert"
        elif op == 2:
            args = (keys[rng.integers(0, cursor, 64)],
                    np.arange(64, dtype=np.uint32) + 9000)
            name = "update"
        else:
            args = (keys[rng.integers(0, cursor, 64)],)
            name = "delete"
        getattr(ref, name)(*args)
        getattr(port, name)(*args)
        assert _missed_rows(CFG, before, interop.state_to_numpy(port.state)) == 0
        assert_same_state(ref.state, port.state, (mode, step))


def test_cow_frontend_mixed_workload_end_to_end():
    ref_t, port_t = DashEH(CFG), TDashEH(port_cfg(CFG), device="cpu")
    ref_fe = DashFrontend(ref_t, max_batch=64, queue_depth=1 << 15)
    port_fe = tfe.DashFrontend(port_t, max_batch=64, queue_depth=1 << 15)
    keys = unique_keys(np.random.default_rng(0xF00), 900)
    rng = np.random.default_rng(11)
    ops = [(INSERT, int(k), ycsb.expected_value(int(k))) for k in keys[:500]]
    for i, k in enumerate(keys[500:700]):
        ops.append((INSERT, int(k), ycsb.expected_value(int(k))))
        ops.append((READ, int(keys[rng.integers(0, 500)]), 0))
        if i % 3 == 0:
            kk = int(keys[rng.integers(0, 500)])
            ops.append((UPDATE, kk, ycsb.updated_value(kk)))
        if i % 7 == 0:
            ops.append((RMW, int(keys[rng.integers(0, 500)]), 123))
        if i % 11 == 0:
            ops.append((DELETE, int(keys[rng.integers(0, 500)]), 0))
    for kind, k, v in ops:
        ref_fe.submit(Op(kind, k, v))
        port_fe.submit(tfe.Op(kind, k, v))
    while True:                        # tick for tick: same publishes, same counters
        did = ref_fe.step()
        assert port_fe.step() == did
        rs, ts = ref_fe.registry.stats(), port_fe.registry.stats()
        assert {k: rs[k] for k in COUNTERS} == {k: ts[k] for k in COUNTERS}
        assert shared_planes(port_fe.registry.current.state, port_t.state) == []
        if not did:
            break
    check_publish(ref_fe.registry, port_fe.registry,
                  port_fe.registry.current.state, port_t.state)
    assert_same_state(ref_t.state, port_t.state)
    s = port_fe.stats()
    assert s["hint_misses"] == 0 and s["published"] > 10
    whole = tlayout.state_nbytes(port_t.state)
    assert s["publish_bytes"] < 0.6 * s["published"] * whole
    assert s["planes_aliased"] > 0 and s["reclaimed"] > 0
