"""Rank programs of the port's DHT tests: one process per rank in a gloo
group on the CPU, run by ``launch`` (``tests/test_torch_dht.py``,
``tests/test_torch_shard_pools.py``).

    python tests/torch_dht_ranks.py SCENARIO RANK WORLD INIT_FILE OUT_DIR

Each scenario is the port's twin of a reference test: it asserts the
reference test's own checks on every rank and writes what the parity tests
compare — statuses, answers, this rank's shard planes, and for the
frontend scenarios the log of every program call — to
``OUT_DIR/SCENARIO_rank{RANK}.pkl``. Imports no JAX.
"""
from __future__ import annotations

import os
import pickle
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]


def launch(scenario: str, world: int, out_dir, timeout: float = 300.0, args=()):
    """Run ``scenario`` (or ``all`` of SCENARIOS) on ``world`` gloo ranks
    (file init under ``out_dir``, so parallel test workers never share a
    port); fail if a rank fails or the group outlives ``timeout``. Returns
    the ranks' pickled results (for ``all``, a dict of them by scenario)."""
    out_dir = Path(out_dir)
    init = out_dir / f"pg-{scenario}"
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "OMP_NUM_THREADS": "1"}
    procs = [subprocess.Popen(
        [sys.executable, str(Path(__file__).resolve()), scenario, str(r), str(world),
         str(init), str(out_dir), *map(str, args)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env, cwd=ROOT)
        for r in range(world)]
    deadline = time.monotonic() + timeout
    logs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=max(deadline - time.monotonic(), 1.0))
            logs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    bad = [r for r, p in enumerate(procs) if p.returncode != 0]
    assert not bad, "\n".join(f"--- rank {r}\n{logs[r][-4000:]}" for r in bad)
    names = list(SCENARIOS) if scenario == "all" else [scenario]
    out = {name: [pickle.loads((out_dir / f"{name}_rank{r}.pkl").read_bytes())
                  for r in range(world)] for name in names}
    return out if scenario == "all" else out[scenario]


# ---------------------------------------------------------------------------
# scenarios (run inside each rank)
# ---------------------------------------------------------------------------

def _keys(seed: int, draw: int, n: int):
    rng = np.random.default_rng(seed)
    return rng, np.unique(rng.integers(1, 2**63, draw, dtype=np.uint64))[:n]


def _small():
    from repro_torch.core import DashConfig
    return DashConfig(max_segments=32, dir_depth_max=8, init_depth=1,
                      num_buckets=16, num_slots=8)


def _planes(d):
    """A copy of this rank's shard planes (the port updates them in place)."""
    from repro_torch import interop
    return {k: v.copy() for k, v in interop.state_to_numpy(d.state).items()}


def _recount(d):
    from repro_torch.core import layout
    return int(d._sum([int(layout.meta_count(d.state.meta).sum())])[0])


def scenario_8_shards(out):
    """test_dht_8_shards"""
    from repro_torch.core import EXISTS, INSERTED, DashConfig
    from repro_torch.distributed import DistributedDash
    d = DistributedDash(DashConfig(max_segments=32, dir_depth_max=8), capacity=256,
                        device="cpu")
    rng, keys = _keys(5, 8000, 4000)
    vals = np.arange(4000, dtype=np.uint32) % 1000 + 1
    out["st"] = st = d.insert(keys, vals)
    assert (st == INSERTED).all()
    out["planes"] = _planes(d)
    out["st2"] = d.insert(keys[:64], vals[:64])
    assert (out["st2"] == EXISTS).all()
    out["f"], out["v"] = d.search(keys)
    assert out["f"].all() and (out["v"] == vals).all()
    neg = np.setdiff1d(np.unique(rng.integers(1, 2**63, 2000, dtype=np.uint64)), keys)[:500]
    out["f2"], out["v2"] = d.search(neg)
    assert out["f2"].sum() == 0
    out["n_items"] = d.n_items
    assert out["n_items"] == 4000


def scenario_splits_bulk(out):
    """test_dht_shard_splits_bulk, planes kept after every insert call"""
    from repro_torch.core import INSERTED
    from repro_torch.distributed import DistributedDash
    d = DistributedDash(_small(), capacity=256, device="cpu")
    _, keys = _keys(9, 8000, 3001)
    vals = np.arange(3001, dtype=np.uint32) % 1000 + 1
    out["st"], out["planes"] = [], []
    for a, b in ((0, 1200), (1200, 3001)):
        st = d.insert(keys[a:b], vals[a:b])
        assert (st == INSERTED).all()
        out["st"].append(st)
        out["planes"].append(_planes(d))
    wm = d._gather_rows(d.state.watermark.reshape(1))
    assert wm.max() > 2, wm                   # splits actually happened
    out["f"], out["v"] = d.search(keys)
    assert out["f"].all() and (out["v"] == vals).all()
    out["n_items"] = d.n_items
    assert out["n_items"] == 3001 == _recount(d)


def scenario_zero_key(out):
    """test_dht_device_retry_never_inserts_zero_key"""
    from repro_torch.core import INSERTED
    from repro_torch.distributed import DistributedDash
    d = DistributedDash(_small(), capacity=256, device="cpu")
    _, keys = _keys(23, 8000, 2777)              # 2777 % 8 != 0: tail padding
    vals = np.arange(2777, dtype=np.uint32) % 1000 + 1
    out["st"] = st = d.insert(keys, vals)
    assert (st == INSERTED).all()
    assert d._gather_rows(d.state.watermark.reshape(1)).max() > 2
    f0, _ = d.search(np.zeros(8, np.uint64))
    assert f0.sum() == 0, "padded lane inserted key 0"
    out["n_items"] = d.n_items
    assert out["n_items"] == 2777 == _recount(d)
    out["f"], out["v"] = d.search(keys)
    assert out["f"].all() and (out["v"] == vals).all()
    out["planes"] = _planes(d)


def scenario_verify_diff(out):
    """test_dht_device_verify_matches_host_mirror"""
    from repro_torch.core.layout import DashState
    from repro_torch.distributed import DistributedDash, ShardFrontend
    d = DistributedDash(_small(), capacity=256, device="cpu")
    fe = ShardFrontend(d, max_batch=256, verify_mode="host")
    rng, keys = _keys(41, 24000, 9000)
    vals = (np.arange(9000) % 1000 + 1).astype(np.uint32)
    d.insert(keys[:1500], vals[:1500])
    cursor, total = 1500, 0
    out["dev"] = []
    for step in range(50):
        old = DashState(*(x.clone() for x in d.state))
        # 0 => a read-only interleaving; two batch sizes keep the
        # reference's compiles few
        n = 64 * int(rng.integers(0, 3))
        if n:
            d.insert(keys[cursor:cursor + n], vals[cursor:cursor + n])
            cursor += n
        probe = keys[rng.integers(0, cursor, 512)]
        _, _, dev, stale = d.snap_search_on(old, probe)
        assert not stale.any()
        host = fe._changed_mask(old, probe)
        assert (dev == host).all(), step
        out["dev"].append(dev)
        total += int(host.sum())
    assert total > 0                             # the interleavings raced
    out["cursor"], out["planes"] = cursor, _planes(d)


def _logged(d, log):
    """Wrap the DHT's programs so every call lands in ``log`` with its
    inputs (this rank's rows), its outputs and this rank's planes after
    it."""
    import torch

    def host(x):
        return x.cpu().numpy() if torch.is_tensor(x) else x

    def wrap(name, fn, n_state):
        def call(*args):
            res = fn(*args)
            kind = "search_snap" if name == "search" and args[0] is not d.state else name
            log.append(dict(kind=kind, args=[host(a) for a in args[n_state:]],
                            res=[host(r) for r in (res if isinstance(res, tuple) else (res,))],
                            planes=_planes(d)))
            return res
        return call

    d.insert_round_fn = wrap("insert_round", d.insert_round_fn, 1)
    d.split_fn = wrap("split", d.split_fn, 1)
    d.insert_fn = wrap("insert_once", d.insert_fn, 1)
    d.search_fn = wrap("search", d.search_fn, 1)
    d.snap_search_fn = wrap("snap_search", d.snap_search_fn, 2)
    split_host = d._split_for_host

    def logged_split_host(keys):
        split_host(keys)
        log.append(dict(kind="split_host", args=[np.asarray(keys, np.uint64)], res=[],
                        planes=_planes(d)))
    d._split_for_host = logged_split_host


def _log_publishes(fe, log):
    """Log the frontend's publishes (the reference replays each as a
    snapshot of its state); the constructor's publish has just run."""
    publish_cow = fe.registry.publish_cow

    def logged(cfg, live, **kw):
        log.append(dict(kind="publish", args=[], res=[], planes=None))
        return publish_cow(cfg, live, **kw)
    log.append(dict(kind="publish", args=[], res=[], planes=None))
    fe.registry.publish_cow = logged


def scenario_frontend(out, verify_mode: str):
    """test_dht_shard_frontend in one verify mode, every program call
    logged for the reference's replay"""
    from repro_torch.core import INSERTED
    from repro_torch.distributed import DistributedDash, ShardFrontend
    from repro_torch.serving.frontend import INSERT, READ, Op
    from repro_torch.workloads import ycsb
    d = DistributedDash(_small(), capacity=256, device="cpu")
    log = []
    _logged(d, log)
    rng, keys = _keys(77, 9000, 3600)
    loaded, fresh = keys[:1800], keys[1800:]
    d.insert(loaded, np.asarray([ycsb.expected_value(int(k)) for k in loaded], np.uint32))
    fe = ShardFrontend(d, max_batch=256, queue_depth=1 << 14, verify_mode=verify_mode)
    _log_publishes(fe, log)
    ridx = rng.integers(0, loaded.size, fresh.size)
    ops = []
    for i, k in enumerate(fresh):          # storm: inserts + racing reads
        ops.append(Op(INSERT, int(k), ycsb.expected_value(int(k))))
        ops.append(Op(READ, int(loaded[ridx[i]])))
    for op in ops:
        assert fe.submit(op)
    fe.drain()
    for op in ops:
        if op.kind == INSERT:
            assert op.status == INSERTED, op
        else:
            assert op.found and op.result == ycsb.expected_value(op.key), op
    assert d._gather_rows(d.state.watermark.reshape(1)).max() > 2   # splits ran
    f, _ = d.search(keys)
    assert f.all()
    out["n_items"] = d.n_items
    assert out["n_items"] == 3600 == _recount(d), (out["n_items"], _recount(d))
    out["log"] = log
    out["reads"] = [(op.key, op.found, op.result) for op in ops if op.kind == READ]
    out["stats"] = {k: v for k, v in fe.stats().items() if "seconds" not in k}
    out["counts"] = (fe.snapshot_reads, fe.retried_reads, fe.registry.published)


def _pool_keys():
    _, keys = _keys(5, 8000, 3000)
    return keys, np.arange(3000, dtype=np.uint32) % 1000 + 1


def scenario_pool_writer(out, pool_dir, save):
    """test_dht_durable_shard_pools, the writer: one pool per shard,
    inserts through the DHT, every shard's pool flushed, then the process
    dies without closing them (``os._exit``)."""
    import torch.distributed as dist
    from repro_torch import persist
    from repro_torch.core import DashConfig
    from repro_torch.distributed import DistributedDash
    cfg = DashConfig(max_segments=32, dir_depth_max=8)
    d = DistributedDash(cfg, capacity=256, device="cpu")
    d.attach_pools(persist.create_shard_pools(pool_dir, cfg, d.n_shards, shards=[d.rank]))
    keys, vals = _pool_keys()
    assert (d.insert(keys, vals) == 0).all()
    out["flushed"], out["n_items"] = d.flush_pools(), d.n_items
    dist.barrier()                       # every shard flushed before any dies
    save()
    os._exit(0)


def scenario_pool_reopen(out, pool_dir, save):
    """test_dht_durable_shard_pools, the reopener: a fresh process per
    rank reopens its own shard's pool lazily and every acknowledged key is
    found; a clean close then reopens clean."""
    from repro_torch import persist
    from repro_torch.core import DashConfig
    from repro_torch.distributed import DistributedDash
    import torch.distributed as dist
    rank = dist.get_rank()
    cfg = DashConfig(max_segments=32, dir_depth_max=8)
    states, wbs, info = persist.reopen_shards(pool_dir, shards=[rank], stack=False,
                                              device="cpu")
    assert info["n_shards"] == 8 and info["dirty_shard_ids"] == [rank], info
    d = DistributedDash(cfg, capacity=256, device="cpu", state=states[0])
    d.attach_pools(wbs)
    out["reopened"] = _planes(d)
    assert d._dirty_shards == set(range(8))
    keys, vals = _pool_keys()
    f, v = d.search(keys)
    assert f.all() and (v == vals).all()
    out["recovered"], out["recovered_segments"] = _planes(d), d.recovered_segments
    assert d.n_items == 3000 and d.recovered_segments > 0
    d.close_pools()
    _, wbs2, info2 = persist.reopen_shards(pool_dir, shards=[rank], stack=False,
                                           device="cpu")
    assert info2["dirty_shards"] == 0
    for wb in wbs2:
        wb.pool.close()


SCENARIOS = {
    "8_shards": scenario_8_shards,
    "splits_bulk": scenario_splits_bulk,
    "zero_key": scenario_zero_key,
    "verify_diff": scenario_verify_diff,
    "frontend_device": lambda out: scenario_frontend(out, "device"),
    "frontend_host": lambda out: scenario_frontend(out, "host"),
}
#: scenarios that take the pool directory and a ``save`` callback
POOL_SCENARIOS = {"pool_writer": scenario_pool_writer, "pool_reopen": scenario_pool_reopen}


def main(argv):
    """Run SCENARIO (or ``all``: every entry of SCENARIOS in order, in the
    same group) on this rank; each scenario's result is pickled as soon as
    it finishes. A scenario that raises ends the rank at once (its peers
    would wait in their next collective; ``launch`` reports the failure)."""
    scenario, rank, world, init, out_dir = argv[:5]
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init}", rank=int(rank),
                            world_size=int(world))

    def saver(name, out):
        def save():
            path = Path(out_dir) / f"{name}_rank{rank}.pkl"
            tmp = path.with_suffix(".tmp")
            tmp.write_bytes(pickle.dumps(out))
            tmp.rename(path)                  # readers never see a partial file
        return save
    names = list(SCENARIOS) if scenario == "all" else [scenario]
    try:
        for name in names:
            out = {}
            if name in SCENARIOS:
                SCENARIOS[name](out)
            else:
                POOL_SCENARIOS[name](out, *argv[5:], saver(name, out))
            saver(name, out)()
    except BaseException:
        import traceback
        traceback.print_exc()
        sys.stdout.flush()
        os._exit(1)
    dist.barrier()
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
