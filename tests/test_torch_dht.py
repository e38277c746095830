"""Port parity: the sharded DHT (``repro_torch.distributed``) on 8 gloo
ranks against the reference's 8-device DHT on the same configs and op
streams.

The port runs one process per rank (``tests/torch_dht_ranks.py``); each
scenario is a twin of a reference test in ``tests/test_distributed.py`` and
asserts that test's own checks on every rank. One JAX subprocess (8 fake
devices) runs the reference's side: the same streams through its
``DistributedDash``, and for ``ShardFrontend`` — which this JAX cannot run
end to end (its COW publish fails to resolve an explicit sharding) — a
replay of the port frontend's logged program calls through the
reference's own ``insert_round_fn`` / ``split_fn`` / ``snap_search_fn`` /
``search_fn`` / ``insert_fn``, with a snapshot copied at every logged
publish. Every shard's planes, every status and every answer must be
byte-identical.
"""
import os
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.core import DashConfig as RefConfig
from repro.core import smo as rsmo
from repro.core.layout import make_state as ref_make_state
from repro_torch.core import smo as tsmo
from tests.torch_dht_ranks import launch
from tests.torch_parity import assert_same_state, port_cfg, to_port, words

ROOT = Path(__file__).resolve().parents[1]
WORLD = 8

REF = """
import pickle, sys, time
from pathlib import Path
import numpy as np
import jax, jax.numpy as jnp
from repro.core import DashConfig, smo, hashing
from repro.core.layout import DashState
from repro.distributed import DistributedDash
from repro.launch.mesh import make_test_mesh

out_dir = Path(sys.argv[1])
mesh = make_test_mesh(2, 4)
small = DashConfig(max_segments=32, dir_depth_max=8, init_depth=1,
                   num_buckets=16, num_slots=8)


def dht(cfg):
    return DistributedDash(cfg, mesh, axes=("data", "model"), capacity=256)


def planes(d):
    return {k: np.array(v) for k, v in d.state._asdict().items()}


def keys_of(seed, draw, n):
    rng = np.random.default_rng(seed)
    return rng, np.unique(rng.integers(1, 2**63, draw, dtype=np.uint64))[:n]


res = {}
d = dht(DashConfig(max_segments=32, dir_depth_max=8))
rng, keys = keys_of(5, 8000, 4000)
vals = np.arange(4000, dtype=np.uint32) % 1000 + 1
r = res["8_shards"] = {"st": d.insert(keys, vals), "planes": planes(d)}
r["st2"] = d.insert(keys[:64], vals[:64])
r["f"], r["v"] = d.search(keys)
neg = np.setdiff1d(np.unique(rng.integers(1, 2**63, 2000, dtype=np.uint64)), keys)[:500]
r["f2"], r["v2"] = d.search(neg)
r["n_items"] = d.n_items

d = dht(small)
_, keys = keys_of(9, 8000, 3001)
vals = np.arange(3001, dtype=np.uint32) % 1000 + 1
r = res["splits_bulk"] = {"st": [], "planes": []}
for a, b in ((0, 1200), (1200, 3001)):
    r["st"].append(d.insert(keys[a:b], vals[a:b]))
    r["planes"].append(planes(d))
r["f"], r["v"] = d.search(keys)
r["n_items"] = d.n_items

d = dht(small)
_, keys = keys_of(23, 8000, 2777)
vals = np.arange(2777, dtype=np.uint32) % 1000 + 1
r = res["zero_key"] = {"st": d.insert(keys, vals)}
r["f0"] = d.search(np.zeros(8, np.uint64))[0]
r["f"], r["v"] = d.search(keys)
r["n_items"], r["planes"] = d.n_items, planes(d)

d = dht(small)
rng, keys = keys_of(41, 24000, 9000)
vals = (np.arange(9000) % 1000 + 1).astype(np.uint32)
d.insert(keys[:1500], vals[:1500])
cursor = 1500
r = res["verify_diff"] = {"dev": []}
for step in range(50):
    old = jax.tree.map(jnp.copy, d.state)
    n = 64 * int(rng.integers(0, 3))
    if n:
        d.insert(keys[cursor:cursor + n], vals[cursor:cursor + n])
        cursor += n
    probe = keys[rng.integers(0, cursor, 512)]
    r["dev"].append(d.snap_search_on(old, probe)[2])
r["cursor"], r["planes"] = cursor, planes(d)


def stack(rows, dtype=None):
    a = np.stack(rows)
    return jnp.asarray(a.view(dtype) if dtype is not None else a)


def split_host(d, keys):
    # the reference's _split_for_host, per unstacked shard (its re-stack
    # of a sharded array fails on this JAX)
    host = planes(d)
    h1 = hashing.np_hash1(*hashing.np_split_keys(keys))
    owners = h1.astype(np.int64) >> (32 - int(np.log2(d.n_shards)))
    for shard in np.unique(owners):
        sub = DashState(**{k: jnp.asarray(v[shard]) for k, v in host.items()})
        segs = np.unique(host["dir"][shard][h1[owners == shard]
                                            >> np.uint32(32 - d.cfg.dir_depth_max)])
        wm = int(host["watermark"][shard])
        sub, _ = smo.bulk_split(d.cfg, sub, segs, wm + np.arange(segs.size))
        for k, v in sub._asdict().items():
            host[k][shard] = np.asarray(v)
    d.state = jax.device_put(DashState(**{k: jnp.asarray(v) for k, v in host.items()}),
                             jax.tree.map(lambda x: x.sharding, d.state))


def replay(ranks):
    d = dht(small)
    snap, outs = None, []
    for i, ev in enumerate(ranks[0]["log"]):
        kind = ev["kind"]
        args = [[rk["log"][i]["args"][j] for rk in ranks] for j in range(len(ev["args"]))]
        if kind == "publish":
            snap = jax.tree.map(jnp.copy, d.state)
            outs.append(None)
            continue
        if kind == "split_host":
            split_host(d, args[0][0])
            got = []
        elif kind in ("insert_round", "insert_once"):
            hi, lo, v = (stack(a, np.uint32) for a in args[:3])
            fn = d.insert_round_fn if kind == "insert_round" else d.insert_fn
            d.state, *got = fn(d.state, hi, lo, v, *(stack(a) for a in args[3:]))
        elif kind == "split":
            hi, lo = (stack(a, np.uint32) for a in args[:2])
            d.state, *got = d.split_fn(d.state, hi, lo, stack(args[2]))
        elif kind in ("search", "search_snap"):
            hi, lo = (stack(a, np.uint32) for a in args)
            got = d.search_fn(d.state if kind == "search" else snap, hi, lo)
        elif kind == "snap_search":
            hi, lo = (stack(a, np.uint32) for a in args)
            got = d.snap_search_fn(snap, d.state, hi, lo)
        else:
            raise AssertionError(kind)
        outs.append(dict(res=[np.asarray(g) for g in got], planes=planes(d)))
    return outs


for name in ("frontend_device", "frontend_host"):
    # the port's ranks run beside this process: wait for their logs
    files = [out_dir / f"{name}_rank{r}.pkl" for r in range(8)]
    deadline = time.monotonic() + 600
    while not all(f.exists() for f in files):
        if time.monotonic() > deadline or (out_dir / "port-failed").exists():
            raise SystemExit(f"no port log of {name}")
        time.sleep(0.2)
    res[name] = {"replay": replay([pickle.loads(f.read_bytes()) for f in files])}

(out_dir / "ref.pkl").write_bytes(pickle.dumps(res))
print("REF OK", sorted(res))
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every port scenario on one group of 8 ranks, beside the reference's
    side in one JAX subprocess (which replays the port frontends' logs as
    they appear)."""
    out = tmp_path_factory.mktemp("dht")
    env = {**os.environ, "XLA_FLAGS": "--xla_force_host_platform_device_count=8",
           "PYTHONPATH": "src", "JAX_PLATFORMS": "cpu"}
    ref = subprocess.Popen([sys.executable, "-c", REF, str(out)], stdout=subprocess.PIPE,
                           stderr=subprocess.STDOUT, text=True, env=env, cwd=ROOT)
    try:
        port = launch("all", WORLD, out)
    except AssertionError:
        (out / "port-failed").touch()
        raise
    finally:
        log, _ = ref.communicate(timeout=900)
    assert ref.returncode == 0, log
    return port, pickle.loads((out / "ref.pkl").read_bytes())


def _scenario(runs, name):
    port, ref = runs
    return port[name], ref[name]


def _rows(ranks, key):
    return np.concatenate([np.asarray(r[key]).reshape(-1) for r in ranks])


def _same_shards(port_planes, ref_planes_, where):
    """Rank r's shard planes are the bytes of row r of the reference's
    stacked planes."""
    for r, mine in enumerate(port_planes):
        bad = [k for k, v in ref_planes_.items()
               if v[r].dtype != mine[k].dtype or v[r].tobytes() != mine[k].tobytes()]
        assert not bad, (where, "shard", r, bad)


def test_dht_8_shards(runs):
    port, ref = _scenario(runs, "8_shards")
    for r in port:                       # every rank returns the global answers
        for k in ("st", "st2", "f", "v", "f2", "v2"):
            assert np.array_equal(r[k], np.asarray(ref[k])), k
        assert r["n_items"] == ref["n_items"] == 4000
    _same_shards([r["planes"] for r in port], ref["planes"], "after the load")


def test_dht_shard_splits_bulk(runs):
    port, ref = _scenario(runs, "splits_bulk")
    for call in range(2):
        for r in port:
            assert np.array_equal(r["st"][call], ref["st"][call])
        _same_shards([r["planes"][call] for r in port], ref["planes"][call],
                     f"insert call {call}")
    assert ref["planes"][-1]["watermark"].max() > 2
    for r in port:
        assert np.array_equal(r["f"], ref["f"]) and np.array_equal(r["v"], ref["v"])
        assert r["n_items"] == ref["n_items"] == 3001


def test_dht_device_retry_never_inserts_zero_key(runs):
    port, ref = _scenario(runs, "zero_key")
    assert not np.asarray(ref["f0"]).any()
    for r in port:
        for k in ("st", "f", "v"):
            assert np.array_equal(r[k], np.asarray(ref[k])), k
        assert r["n_items"] == ref["n_items"] == 2777
    _same_shards([r["planes"] for r in port], ref["planes"], "after the load")


def test_dht_device_verify_matches_host_mirror(runs):
    port, ref = _scenario(runs, "verify_diff")
    for r in port:
        assert r["cursor"] == ref["cursor"]
        for step, (a, b) in enumerate(zip(r["dev"], ref["dev"])):
            assert np.array_equal(a, np.asarray(b).astype(bool)), step
    _same_shards([r["planes"] for r in port], ref["planes"], "after the interleavings")


@pytest.mark.parametrize("mode", ["device", "host"])
def test_shard_frontend_record_and_replay(runs, mode):
    """The port frontend's program calls, replayed through the reference's
    programs, give the same answers, statuses, flags and shard planes
    after every call; the port frontend itself passed the reference test's
    checks (every insert lands, every read pre- or post-split, n_items ==
    recount) on every rank."""
    port, ref = _scenario(runs, f"frontend_{mode}")
    log = port[0]["log"]
    kinds = {ev["kind"] for ev in log}
    assert {"publish", "split" if mode == "device" else "split_host"} <= kinds, kinds
    assert len(ref["replay"]) == len(log)
    for i, (ev, got) in enumerate(zip(log, ref["replay"])):
        if ev["kind"] == "publish":
            continue
        where = f"call {i} ({ev['kind']})"
        for j, want in enumerate(got["res"]):
            rows = [rk["log"][i]["res"][j] for rk in port]
            if ev["kind"] in ("insert_round", "split") and j == len(got["res"]) - 1:
                # the flags: reduced over the group in the port, per shard here
                assert all(np.array_equal(row, want.max(0)) for row in rows), where
                continue
            mine = np.stack([np.asarray(x) for x in rows])
            assert np.array_equal(mine.view(want.dtype) if mine.dtype.itemsize ==
                                  want.dtype.itemsize else mine.astype(want.dtype),
                                  want), (where, j)
        _same_shards([rk["log"][i]["planes"] for rk in port], got["planes"], where)
    for r in port[1:]:
        assert r["reads"] == port[0]["reads"] and r["counts"] == port[0]["counts"]
    assert port[0]["counts"][0] + port[0]["counts"][1] == 1800
    assert port[0]["n_items"] == 3600


def test_plan_and_split_segments_local_match_reference():
    """``plan_local_splits`` + ``split_segments_local`` on one shard's state
    against the reference's, with more pressured segments than lanes,
    padding lanes and duplicate keys."""
    import jax.numpy as jnp
    from repro.core import hashing as rhash
    from repro.core.layout import DashState as RefState
    from repro_torch import interop
    from repro_torch.core import DashEH
    cfg = RefConfig(max_segments=32, dir_depth_max=8, init_depth=2, num_buckets=16,
                    num_slots=8)
    t = DashEH(port_cfg(cfg), device="cpu")
    rng = np.random.default_rng(3)
    keys = np.unique(rng.integers(1, 2**63, 3000, dtype=np.uint64))[:1400]
    t.insert(keys, np.arange(keys.size, dtype=np.uint32) + 1)
    ref_state = RefState(**{k: jnp.asarray(v)
                            for k, v in interop.state_to_numpy(t.state).items()})
    probe = np.concatenate([keys[:200], keys[:50]])
    hi, lo = rhash.np_split_keys(probe)
    h1 = rhash.np_hash1(hi, lo)
    want = rng.random(probe.size) < 0.7
    port_state = t.state
    splits = int(t.state.n_splits)
    for k_max in (4, 8, 16):
        ref_plan = rsmo.plan_local_splits(cfg, ref_state, jnp.asarray(h1),
                                          jnp.asarray(want), k_max)
        plan = tsmo.plan_local_splits(port_cfg(cfg), port_state, words(h1),
                                      torch.from_numpy(want), k_max)
        for a, b in zip(plan, ref_plan):
            assert np.array_equal(a.numpy(), np.asarray(b)), k_max
    old, new, valid, depth_bad, pool_bad = ref_plan
    commit = valid & ~(depth_bad | pool_bad)
    ref_state, ref_ok = rsmo.split_segments_local(cfg, ref_state, old, new, commit)
    _, ok = tsmo.split_segments_local(port_cfg(cfg), port_state, *(
        torch.from_numpy(np.array(x)) for x in (old, new, commit)))
    assert np.array_equal(ok.numpy(), np.asarray(ref_ok))
    assert_same_state(ref_state, port_state, "split_segments_local")
    assert int(port_state.n_splits) - splits == int(np.asarray(commit).sum()) > 0
    # an exhausted pool is flagged, not planned around
    full = ref_make_state(RefConfig(max_segments=4, dir_depth_max=8, init_depth=2,
                                    num_buckets=16, num_slots=8), "eh")
    fcfg = RefConfig(max_segments=4, dir_depth_max=8, init_depth=2, num_buckets=16,
                     num_slots=8)
    plan = tsmo.plan_local_splits(port_cfg(fcfg), to_port(fcfg, full), words(h1),
                                  torch.ones(h1.size, dtype=torch.bool), 8)
    ref_plan = rsmo.plan_local_splits(fcfg, full, jnp.asarray(h1),
                                      jnp.ones(h1.size, bool), 8)
    assert bool(plan[4]) and bool(np.asarray(ref_plan[4]))
    for a, b in zip(plan, ref_plan):
        assert np.array_equal(a.numpy(), np.asarray(b))


def test_buckets_changed_lh_device_matches_host_mirror():
    """The LH half of the verify differential, per table as the reference
    test has it: the port's ``buckets_changed`` on LH against an
    independent numpy mirror of the LH addressing + version-plane diff,
    and against the reference's on the same states."""
    import jax.numpy as jnp
    from repro.core.layout import DashState as RefState
    from repro.serving.engine import buckets_changed as ref_changed
    from repro_torch import interop
    from repro_torch.core import DashLH, hashing
    from repro_torch.core.layout import DashState
    from repro_torch.serving.engine import buckets_changed
    cfg = RefConfig(max_segments=64, num_stash=4, num_buckets=16, num_slots=8,
                    lh_base_log2=2)
    t = DashLH(port_cfg(cfg), device="cpu")
    rng = np.random.default_rng(57)
    keys = np.unique(rng.integers(1, 2**63, 16000, dtype=np.uint64))[:6000]

    def host_mask(old, new, probe):
        hi, lo = hashing.np_split_keys(probe)
        h1 = hashing.np_hash1(hi, lo)

        def seg_of(st):
            w = int(st["lh_word"])
            level, nxt = w >> 24, w & 0xFFFFFF
            mask_lo = (np.uint32(1) << np.uint32(cfg.lh_base_log2 + level)) - 1
            seg = (h1 & mask_lo).astype(np.int64)
            mask_hi = (mask_lo << np.uint32(1)) | np.uint32(1)
            logical = np.where(seg < nxt, (h1 & mask_hi).astype(np.int64), seg)
            return st["lh_dir"][logical]
        so, sn = seg_of(old), seg_of(new)
        changed = so != sn
        b = ((h1 >> np.uint32(24)) & np.uint32(cfg.num_buckets - 1)).astype(np.int64)
        ov, nv = old["version"], new["version"]
        for w in range(cfg.probe_window):
            bw = (b + w) & (cfg.num_buckets - 1)
            changed |= ov[so, bw] != nv[so, bw]
        for s in range(cfg.num_stash):
            changed |= ov[so, cfg.num_buckets + s] != nv[so, cfg.num_buckets + s]
        return changed

    def ref_of(planes):
        return RefState(**{k: jnp.asarray(v) for k, v in planes.items()})

    cursor, total = 0, 0
    for step in range(50):
        old = DashState(*(x.clone() for x in t.state))
        n = min(int(rng.integers(0, 220)), keys.size - cursor)   # big batches
        if n:                                                     # drive Next
            t.insert(keys[cursor:cursor + n], np.arange(n, dtype=np.uint32) + 1)
            cursor += n
        probe = keys[rng.integers(0, max(cursor, 1), 512)]
        hi, lo = hashing.np_split_keys(probe)
        dev = buckets_changed(t.cfg, "lh", old, t.state, words(hi), words(lo)).numpy()
        a, b = interop.state_to_numpy(old), interop.state_to_numpy(t.state)
        host = host_mask(a, b, probe)
        want = np.asarray(ref_changed(cfg, "lh", ref_of(a), ref_of(b), jnp.asarray(hi),
                                      jnp.asarray(lo)))
        assert (dev == host).all() and (dev == want).all(), step
        total += int(host.sum())
    assert total > 0
