"""Port parity: one durable pool per DHT shard (``repro_torch.persist``'s
shard-pool functions), each shard's pool file the reference's bytes.

Twins of ``test_persist.py::test_shard_pools_reopen_independently`` and
``test_faults.py::test_shard_fault_isolation`` run both packages in this
process. The scenario of the reference's red ``test_dht_durable_shard_pools``
runs on 8 gloo ranks (``tests/torch_dht_ranks.py``): a writer process per
rank flushes its shard's pool and dies, a fresh process per rank reopens
its own pool lazily and finds all 3000 keys. One JAX subprocess gives the
reference's side: its 8-device writer's pools (which must equal the port
writer's byte for byte), the reopen of a copy of them, and per shard its
``recovery.lazy_recover_touched`` on the unstacked shard (what its
``DistributedDash.ensure_recovered`` runs before the re-stack this JAX
rejects), which the port's lazily recovered shards must equal.
"""
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from repro import persist as rp
from repro.core import DashEH as RefEH
from repro.core import layout as rlayout
from repro.core.layout import DashConfig
from repro.persist.faults import FaultPlan as RefPlan
from repro_torch import interop
from repro_torch import persist as tp
from repro_torch.core import DashEH
from repro_torch.core.layout import DashState
from repro_torch.distributed import make_sharded_state
from repro_torch.persist import FaultPlan
from tests.conftest import unique_keys
from tests.torch_dht_ranks import launch
from tests.torch_parity import assert_same_pool, port_cfg

ROOT = Path(__file__).resolve().parents[1]
SMALL = DashConfig(max_segments=16, dir_depth_max=8, num_buckets=16, num_slots=8)


def _vals(n):
    return (np.arange(n) % 1000 + 1).astype(np.uint32)


def _same_pools(ref_dir, port_dir, n, where):
    for i in range(n):
        name = f"shard_{i:04d}.pool"
        assert_same_pool(os.path.join(ref_dir, name), os.path.join(port_dir, name),
                         f"{where}, shard {i}")


def _stack(states):
    return DashState(*(torch.stack([getattr(s, n) for s in states])
                       for n in DashState._fields))


def test_shard_pools_reopen_independently(tmp_path):
    import jax.numpy as jnp
    from repro.distributed.dht import make_sharded_state as ref_sharded
    n_shards = 4
    rd, pd = str(tmp_path / "ref"), str(tmp_path / "port")
    ref_wbs = rp.create_shard_pools(rd, SMALL, n_shards)
    wbs = tp.create_shard_pools(pd, port_cfg(SMALL), n_shards)
    ref_sh = ref_sharded(SMALL, n_shards)._replace(
        n_items=jnp.asarray(np.arange(n_shards, dtype=np.int32) * 10),
        clean=jnp.zeros(n_shards, bool))
    sh = make_sharded_state(port_cfg(SMALL), n_shards, device="cpu")
    sh.n_items.copy_(torch.arange(n_shards, dtype=torch.int32) * 10)
    sh.clean.fill_(False)
    rp.flush_shards(ref_sh, ref_wbs)
    tp.flush_shards(sh, wbs)
    _same_pools(rd, pd, n_shards, "after flush_shards")
    ref_stacked, _, ref_info = rp.reopen_shards(rd)
    stacked, wbs2, info = tp.reopen_shards(pd, device="cpu")
    _same_pools(rd, pd, n_shards, "after reopen_shards")
    assert info["n_shards"] == ref_info["n_shards"] == n_shards
    assert info["dirty_shards"] == n_shards     # never closed cleanly
    got = interop.state_to_numpy(stacked)
    for n in DashState._fields:
        assert got[n].tobytes() == np.asarray(getattr(ref_stacked, n)).tobytes(), n
        if n not in ("clean", "gver", "seg_version", "version"):   # restart bumps these
            assert np.array_equal(got[n], interop.state_to_numpy(sh)[n]), n
    assert all(w.pool.sb.flush_seq >= 2 for w in wbs2)
    # a rank reopens only its own shard's pool
    for w in wbs2:
        w.pool.close()
    mine, wbs3, info3 = tp.reopen_shards(pd, shards=[2], stack=False, device="cpu")
    assert len(mine) == len(wbs3) == 1 and info3["n_shards"] == n_shards
    assert wbs3[0].pool.path.endswith("shard_0002.pool")
    assert int(mine[0].n_items) == 20


def test_shard_fault_isolation(tmp_path):
    n_shards = 3
    rd, pd = str(tmp_path / "ref"), str(tmp_path / "port")
    ref_plans = [RefPlan(seed=40 + i) for i in range(n_shards)]
    plans = [FaultPlan(seed=40 + i) for i in range(n_shards)]
    ref_wbs = rp.create_shard_pools(rd, SMALL, n_shards, faults=ref_plans)
    wbs = tp.create_shard_pools(pd, port_cfg(SMALL), n_shards, faults=plans)
    ref_tables = [RefEH(SMALL) for _ in range(n_shards)]
    tables = [DashEH(port_cfg(SMALL), device="cpu") for _ in range(n_shards)]
    rng = np.random.default_rng(4)
    per = [unique_keys(rng, 200, lo=1 + i * 2**61, hi=(i + 1) * 2**61)
           for i in range(n_shards)]
    for rt, t, keys in zip(ref_tables, tables, per):
        rt.insert(keys, _vals(200))
        t.insert(keys, _vals(200))

    def ref_stacked():
        import jax.numpy as jnp
        return rlayout.DashState(*[jnp.stack([np.asarray(getattr(t.state, n))
                                              for t in ref_tables])
                                   for n in rlayout.DashState._fields])

    rp.flush_shards(ref_stacked(), ref_wbs)
    tp.flush_shards(_stack([t.state for t in tables]), wbs)
    _same_pools(rd, pd, n_shards, "first flush")
    # shard 1's device fails hard: only IT degrades, neighbors still flush
    for p in (ref_plans[1], plans[1]):
        p.eio_fences[p.fence_calls] = 99
    more = unique_keys(rng, 50, lo=2**60, hi=2**61)
    ref_tables[0].insert(more, _vals(50))
    tables[0].insert(more, _vals(50))
    rp.flush_shards(ref_stacked(), ref_wbs)
    st = [t.state for t in tables]           # per-shard states, as a rank holds
    tp.flush_shards(st, wbs)
    assert [w.degraded for w in wbs] == [w.degraded for w in ref_wbs] == [False, True, False]
    n0 = wbs[0].flushes
    rp.flush_shards(ref_stacked(), ref_wbs)
    tp.flush_shards(st, wbs)                 # the degraded shard is skipped
    assert wbs[0].flushes == n0 + 1 and wbs[1].degraded_flushes >= 1
    assert [w.degraded_flushes for w in wbs] == [w.degraded_flushes for w in ref_wbs]
    for p in (ref_plans[1], plans[1]):
        p.eio_fences.clear()
    assert rp.recover_shards(ref_stacked(), ref_wbs) == 1
    assert tp.recover_shards(st, wbs) == 1
    assert not any(w.degraded for w in wbs)
    for w in ref_wbs + wbs:
        w.pool.close()
    _same_pools(rd, pd, n_shards, "after recovery")
    # rot shard 0's closed pool (no faults armed while flipping)
    for opener, flip, d in ((rp.open_shard_pools, RefPlan, rd),
                            (tp.open_shard_pools, FaultPlan, pd)):
        pools = opener(d)
        flip(seed=50).flip_bits(pools[0].pool, n=3)
        for w in pools:
            w.pool.close()
    _same_pools(rd, pd, n_shards, "after the bit flips")
    # reopen: transient EIO on one shard is retried away; the flipped shard
    # quarantines locally and reports ONLY its own keys
    ref_plans2 = [RefPlan(seed=50 + i) for i in range(n_shards)]
    plans2 = [FaultPlan(seed=50 + i) for i in range(n_shards)]
    ref_plans2[2].eio_fences[0] = plans2[2].eio_fences[0] = 1
    _, ref_wbs2, ref_info = rp.reopen_shards(rd, faults=ref_plans2)
    st2, wbs2, info = tp.reopen_shards(pd, faults=plans2, device="cpu")
    assert plans2[2].eio_raised == ref_plans2[2].eio_raised == 1
    assert info["degraded_shards"] == 0
    assert set(info["lost_reports"]) <= {0}
    assert info["lost_reports"] == ref_info["lost_reports"]
    assert info["dirty_shard_ids"] == ref_info["dirty_shard_ids"]
    for w in wbs2:
        bad = w.pool.verify_checksums()
        assert bad["bt"].size == 0 and bad["nb"].size == 0
    for w in ref_wbs2 + wbs2:
        w.pool.close()
    _same_pools(rd, pd, n_shards, "after the verified reopen")


REF = """
import os, shutil, sys
import numpy as np
import jax, jax.numpy as jnp
from repro import persist
from repro.core import DashConfig, hashing, recovery
from repro.core.layout import DashState
from repro.distributed import DistributedDash
from repro.launch.mesh import make_test_mesh
out, pools = sys.argv[1], sys.argv[2]
cfg = DashConfig(max_segments=32, dir_depth_max=8)
rng = np.random.default_rng(5)
keys = np.unique(rng.integers(1, 2**63, 8000, dtype=np.uint64))[:3000]
vals = np.arange(3000, dtype=np.uint32) % 1000 + 1
d = DistributedDash(cfg, make_test_mesh(2, 4), axes=("data", "model"), capacity=256)
d.attach_pools(persist.create_shard_pools(pools, cfg, d.n_shards))
assert (d.insert(keys, vals) == 0).all()
d.flush_pools()
shutil.copytree(pools, pools + "-written")
stacked, wbs, info = persist.reopen_shards(pools)
assert info["dirty_shards"] == 8
host = {k: np.array(v) for k, v in stacked._asdict().items()}
np.savez(os.path.join(out, "reopened.npz"), **host)
h1 = hashing.np_hash1(*hashing.np_split_keys(keys))
owners = h1.astype(np.int64) >> 29
recovered = {k: v.copy() for k, v in host.items()}
n_rec = 0
for shard in range(8):
    sub = DashState(**{k: jnp.asarray(v[shard]) for k, v in host.items()})
    touched = host["dir"][shard][h1[owners == shard] >> np.uint32(32 - cfg.dir_depth_max)]
    sub, rec = recovery.lazy_recover_touched(cfg, "eh", sub, touched)
    n_rec += len(rec)
    for k, v in sub._asdict().items():
        recovered[k][shard] = np.asarray(v)
np.savez(os.path.join(out, "recovered.npz"), n_rec=n_rec, **recovered)
print("REF OK", n_rec)
"""


def test_dht_durable_shard_pools(tmp_path):
    """A writer per rank dies after ``flush_pools``; a fresh process per
    rank reopens its shard lazily and finds every acknowledged key."""
    port_pools, ref_pools = tmp_path / "port", tmp_path / "ref"
    env = {**os.environ, "XLA_FLAGS": "--xla_force_host_platform_device_count=8",
           "PYTHONPATH": "src", "JAX_PLATFORMS": "cpu"}
    ref = subprocess.Popen([sys.executable, "-c", REF, str(tmp_path), str(ref_pools)],
                           stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                           env=env, cwd=ROOT)
    try:
        writers = launch("pool_writer", 8, tmp_path, args=(port_pools,))
        assert all(w["n_items"] == 3000 for w in writers)
        written = tmp_path / "port-written"
        shutil.copytree(port_pools, written)
        ranks = launch("pool_reopen", 8, tmp_path, args=(port_pools,))
    finally:
        log, _ = ref.communicate(timeout=600)
    assert ref.returncode == 0, log
    _same_pools(str(tmp_path / "ref-written"), str(written), 8, "the writers' pools")
    reopened = np.load(tmp_path / "reopened.npz")
    recovered = np.load(tmp_path / "recovered.npz")
    for r, mine in enumerate(ranks):
        for k in DashState._fields:
            want = reopened[k][r]
            if k == "clean":
                want = np.zeros_like(want)      # attach_pools marks the period dirty
            assert mine["reopened"][k].tobytes() == want.tobytes(), (r, k)
            want = recovered[k][r] if k != "clean" else want
            assert mine["recovered"][k].tobytes() == want.tobytes(), (r, k, "lazy")
    assert ranks[0]["recovered_segments"] == int(recovered["n_rec"]) > 0
