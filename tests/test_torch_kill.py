"""Port parity: a port process killed for real (``scripts/ci.sh``'s durable
and forensics smokes, against ``repro_torch``).

A writer process flushes acknowledged keys into one pool and leaves it
unclosed, then dies with ``os._exit(0)`` inside ``pool.commit`` of a
second pool's flush, after its flight-recorder window and fence but
before the superblock advanced (no destructor runs: the closest a test
gets to ``kill -9``). Fresh processes then reopen the
pools and find every acknowledged key, and ``scripts/forensics_torch.py``
names the torn window and exactly its 64 in-flight keys. The reference's
writers run the same streams: their pool files are the port's bytes, and
both forensics scripts give the same report on them (wall clocks aside).
"""
import json
import os
import shutil
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[1]
ENV = {**os.environ, "PYTHONPATH": "src", "JAX_PLATFORMS": "cpu"}
WALL = 1.7e9

PORT = dict(imports="""
    from repro_torch import persist
    from repro_torch.core import DashConfig
    from repro_torch.obs import FlightRecorder
    from repro_torch.persist.chaos import CHAOS_CFG
""", dev=', device="cpu"', rec=f"FlightRecorder(clock=clock, wall=lambda: {WALL})")
REF = dict(imports=f"""
    import time
    time.time = lambda: {WALL}          # the reference recorder's wall clock
    from repro import persist
    from repro.core import DashConfig
    from repro.obs import FlightRecorder
    from repro.persist.chaos import CHAOS_CFG
""", dev="", rec="FlightRecorder(clock=clock)")

# one writer process per package, as ci.sh's two smokes: the durable
# smoke's pool (argv[1]) gets its acknowledged keys flushed and is never
# closed; then the forensics smoke's pool (argv[2]) commits one batch,
# stamps the intent of a second, and the process dies inside that flush's
# pool.commit (the window write + fence ran) -- os._exit, no destructor
WRITER = """
    import itertools, os, sys
    import numpy as np
    {imports}
    t = persist.create(sys.argv[1], DashConfig(max_segments=16, dir_depth_max=8,
                                               num_buckets=16, num_slots=8){dev})
    keys = np.unique(np.random.default_rng(0xC1).integers(1, 2**63, 4000,
                                                          np.uint64))[:1500]
    t.insert(keys, (np.arange(1500) + 1).astype(np.uint32))
    t.flush()
    ticks = itertools.count()
    clock = lambda: float(next(ticks))
    t = persist.create(sys.argv[2], CHAOS_CFG{dev})
    rec = t.writeback.attach_recorder({rec})
    k1 = np.arange(1, 65, dtype=np.uint64)
    t.insert(k1, (np.arange(64) + 1).astype(np.uint32))
    rec.record_ops("insert", k1, await_seq=t.writeback.pool.sb.flush_seq + 1)
    t.flush()
    k2 = np.arange(5000, 5064, dtype=np.uint64)
    t.insert(k2, (np.arange(64) + 1).astype(np.uint32))
    rec.record_ops("insert", k2, await_seq=t.writeback.pool.sb.flush_seq + 1)
    t.writeback.pool.commit = lambda *a, **kw: os._exit(0)
    t.flush()
    raise SystemExit("unreachable: the flush should have killed the process")
"""


def _run(args, code=None, expect=0):
    cmd = [sys.executable] + (["-c", textwrap.dedent(code)] if code else []) + args
    r = subprocess.run(cmd, capture_output=True, text=True, env=ENV, cwd=ROOT,
                       timeout=300)
    assert r.returncode == expect, r.stdout + "\n" + r.stderr
    return r.stdout


@pytest.fixture(scope="module")
def pools(tmp_path_factory):
    """{package: (durable pool, forensics pool)}, each written by a writer
    process of that package that died as above."""
    out = {}
    for name, pkg in (("port", PORT), ("ref", REF)):
        d = tmp_path_factory.mktemp(name)
        paths = (d / "smoke.pool", d / "bb.pool")
        code = textwrap.dedent(WRITER).format(
            imports=textwrap.dedent(pkg["imports"]).strip(), dev=pkg["dev"], rec=pkg["rec"])
        _run([str(p) for p in paths], code)
        out[name] = paths
    return out


def _same_bytes(a, b):
    assert a.read_bytes() == b.read_bytes(), f"{a.name} and {b.name} differ"


def _without_wall(rep):
    """A forensics report without its wall-clock anchors and pool paths."""
    if isinstance(rep, dict):
        return {k: _without_wall(v) for k, v in rep.items()
                if k not in ("wall", "path")}
    if isinstance(rep, list):
        return [_without_wall(v) for v in rep]
    return rep


def test_killed_writer_keeps_every_acked_key(pools, tmp_path):
    port = tmp_path / "smoke.pool"
    shutil.copy(pools["port"][0], port)
    _same_bytes(port, pools["ref"][0])
    out = _run([str(port)], """
        import sys
        import numpy as np
        from repro_torch import persist
        t, info = persist.reopen(sys.argv[1], device="cpu")
        assert not info["clean"], "writer died dirty; pool must say so"
        keys = np.unique(np.random.default_rng(0xC1).integers(1, 2**63, 4000,
                                                              np.uint64))[:1500]
        f, v = t.search(keys)
        assert f.all(), f"lost {int((~f).sum())} acknowledged keys"
        assert (v == np.arange(1500) + 1).all()
        t.close()
        t2, info2 = persist.reopen(sys.argv[1], device="cpu")
        assert info2["clean"]
        f2, _ = t2.search(keys[:256])
        assert f2.all() and t2.recovered_segments == 0
        print(f"durable smoke OK: {int(f.sum())} keys survived the kill")
    """)
    assert "durable smoke OK: 1500 keys" in out


def test_writer_killed_inside_commit_leaves_a_torn_window(pools, tmp_path):
    port, ref = tmp_path / "port.pool", pools["ref"][1]
    shutil.copy(pools["port"][1], port)
    _same_bytes(port, ref)
    reports = {}
    for name, script, pool in (("port", "forensics_torch.py", port),
                               ("port on ref", "forensics_torch.py", ref),
                               ("ref", "forensics.py", ref)):
        reports[name] = json.loads(_run([str(ROOT / "scripts" / script), str(pool)]))
    rep = reports["port"]
    assert rep["ok"], rep
    assert rep["torn"]["present"], "torn flush window not recovered"
    assert rep["torn"]["seq"] == rep["flush_seq"] + 1, rep["torn"]
    got = sorted(int(k) for op in rep["in_flight_ops"] for k in op["keys"])
    assert got == list(range(5000, 5064)), (len(got), got[:4])
    assert rep["acked_ops_in_torn_window"] >= 1
    assert _without_wall(reports["port on ref"]) == _without_wall(reports["ref"])
    assert _without_wall(rep) == _without_wall(reports["ref"])
    # a fresh process heals the pool and still serves the acked batch
    out = _run([str(port)], """
        import sys
        import numpy as np
        from repro_torch import persist
        t, info = persist.reopen(sys.argv[1], device="cpu")
        assert not info["clean"]
        f, v = t.search(np.arange(1, 65, dtype=np.uint64))
        assert f.all() and (v == np.arange(64) + 1).all(), "acked batch lost"
        f2, _ = t.search(np.arange(5000, 5064, dtype=np.uint64))
        t.close()
        print("healed", int(f.sum()), int(f2.sum()))
    """)
    assert out.startswith("healed 64")


def test_forensics_cli_merges_a_fleet(pools, tmp_path):
    """Several pools on the command line give the fleet-merged report, as
    the reference's script does for one pool per DHT shard."""
    shards = [tmp_path / f"shard_{i:04d}.pool" for i in range(2)]
    for shard in shards:
        shutil.copy(pools["port"][1], shard)
    args = [str(p) for p in shards]
    port = json.loads(_run([str(ROOT / "scripts" / "forensics_torch.py")] + args))
    ref = json.loads(_run([str(ROOT / "scripts" / "forensics.py")] + args))
    assert _without_wall(port) == _without_wall(ref)
    keys = [int(k) for op in port["in_flight_ops"] for k in op["keys"]]
    assert sorted(keys) == sorted(list(range(5000, 5064)) * 2)
    assert np.unique(np.asarray([op["shard"] for op in port["in_flight_ops"]])).size == 2
