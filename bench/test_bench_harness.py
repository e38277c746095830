"""CPU tests of the benchmark harness, at tiny sizes.

Each cell runs end to end on the CPU with the port's plain kernels; the
traffic is a function of the seed; nothing under ``bench/`` imports JAX or
the JAX package, and the reference imports nothing of the program. The
control and the planted faults are ``test_bench_faults.py``'s.
"""
import ast
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from bench import generator, harness, reference, run, trace

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
SEED = 2**31 + 12345
SMALL = {"max_segments": 64, "dir_depth_max": 10}
#: per cell: a table of 64 (EH) or 128 (LH) segments and a few thousand keys
TINY = {
    "eh-load-uniform": {"config": SMALL, "setup": {
        "start": {"init_depth": 2}, "records": 1536,
        "warmup": {"start": {"init_depth": 1}, "keys": 384}}},
    "lh-load-uniform": {"config": {"max_segments": 128}, "setup": {
        "start": {"lh_base_log2": 2}, "records": 1536,
        "warmup": {"start": {"lh_base_log2": 2}, "keys": 512}}},
    "eh-read-zipf": {"config": SMALL, "setup": {"start": {"init_depth": 3}, "records": 2500},
                     "traffic": {"batch": 512, "distinct_batches": 4, "sample_draws": 64}},
}
CELLS = sorted(TINY)


def spec():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def tiny_run(cell, system=None, traced=False, seconds=0.2):
    return harness.run_cell(cell, SEED, seconds, traced, "cpu",
                            system=system, overrides=TINY[cell])


@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_on_cpu(cell, capsys):
    run.report(tiny_run(cell))
    out = capsys.readouterr()
    line = json.loads(out.out.strip().splitlines()[-1])
    assert line["correct"] is True
    assert line["attempted"] > 0 and line["failed"] == 0 and line["compared"] > 0
    assert list(line)[-1] == "checks"
    assert all(c["value"] <= c["limit"] for c in line["checks"].values())
    e2e = {m["name"] for m in spec()["end_to_end"] if cell in m.get("workloads", [cell])}
    assert set(line["metrics"]) == e2e
    assert out.err.strip().splitlines()[-1].startswith("check ")


def test_traced_load_reads_its_counters():
    tiny = TINY["eh-load-uniform"]
    over = dict(tiny, setup=dict(tiny["setup"], trace={"first": 1, "count": 2}))
    line = harness.run_cell("eh-load-uniform", SEED, 0.2, True, "cpu", overrides=over)
    assert line["correct"] is True
    assert {"table.rounds_per_batch", "table.load_factor",
            "smo.splits_per_mkey"} <= set(line["metrics"])
    assert line["metrics"]["table.rounds_per_batch"]["value"] >= 1
    assert line["device"]["window_s"] > 0 and "breakdown" in line


def test_tracer_traces_a_fixed_range_of_batches():
    system = harness.Program(harness.find_cell("eh-read-zipf", TINY["eh-read-zipf"]).config, "cpu")
    tracer = harness.Tracer(system, True, 3, 4)
    for i in range(10):
        tracer.maybe_start(i)
        tracer.after_batch(100, i)
    assert tracer.batch_ids == [3, 4, 5, 6]
    assert tracer.summary["batches"] == 4 and tracer.summary["ops"] == 400


def test_reference_catches_a_planted_wrong_answer():
    keys = generator.unique_keys(SEED, 1000)
    values = generator.expected_value(keys)
    ref = reference.Reference()
    assert (ref.insert(keys, values) == reference.INSERTED).all()
    assert (ref.insert(keys[:10], values[:10]) == reference.EXISTS).all()
    found, got = ref.search(keys)
    assert found.all() and (got == values).all()
    assert reference.mismatches(found, got, found, values) == 0
    bad = got.copy()
    bad[7] ^= 1
    assert reference.mismatches(found, bad, found, values) == 1
    lost = found.copy()
    lost[3] = False
    assert reference.mismatches(lost, got, found, values) == 1
    miss, _ = ref.search(generator.unique_keys(SEED + 1, 100))
    assert not miss.any()


def test_same_seed_same_traffic():
    load = json.loads((BENCH / "traffic" / "ycsb-load-uniform.json").read_text())
    read = dict(json.loads((BENCH / "traffic" / "ycsb-c-zipf.json").read_text()),
                batch=1024, distinct_batches=3)
    for mix in (load, read):
        a, b = (generator.make(mix, 5000, SEED, 300) for _ in range(2))
        c = generator.make(mix, 5000, SEED + 1, 300)
        for x, y in ((a.keys, b.keys), (a.values, b.values), (a.warmup_keys, b.warmup_keys)):
            assert np.array_equal(x, y)
        assert not np.array_equal(a.keys, c.keys)
        assert np.unique(a.keys).size == a.keys.size
        for x, y in zip(a.batches, b.batches):
            assert np.array_equal(x, y)
    assert np.isin(a.batches[0], a.keys).all()
    assert np.unique(generator.unique_keys(-5, 10)).size == 10


def test_trace_arithmetic():
    device = [("k1", 0, 10), ("Memcpy HtoD", 5, 20), ("k2", 40, 50), ("k3", 95, 120)]
    host = [("aten::item", 18, 45), ("inner", 20, 30), ("aten::nonzero", 60, 70)]
    s = trace.summarize(device, host, (0, 100))
    assert s["busy_s"] == pytest.approx(35e-9)
    assert s["window_s"] == pytest.approx(100e-9)
    assert s["kernel_launches"] == 3
    assert dict(map(tuple, s["idle_gaps"])) == pytest.approx(
        {"inner": 20e-9, "host python": 45e-9})


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_no_module_imports_jax_or_the_jax_package():
    files = sorted(BENCH.rglob("*.py"))
    assert files
    for path in files:
        bad = set(_imports(path)) & {"jax", "jaxlib", "flax", "repro", "benchmarks"}
        assert not bad, f"{path} imports {bad}"


def test_reference_imports_nothing_of_the_program():
    assert set(_imports(BENCH / "reference.py")) <= {"__future__", "numpy"}


def test_every_name_has_its_file():
    s = spec()
    for c in s["configs"]:
        assert (ROOT / c["file"]).is_file() and c["file"].startswith("bench/")
    for w in s["workloads"]:
        assert (BENCH / "traffic" / f"{w['traffic']}.json").is_file()
        assert (BENCH / "workloads" / f"{w['name']}.json").is_file()
    for m in s["end_to_end"] + s["per_layer"]:
        assert callable(harness.reader(m["name"]))


def test_run_without_a_card_prints_no_result():
    out = subprocess.run([sys.executable, str(BENCH / "run.py"), "--workload", "eh-read-zipf",
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and out.stdout.strip() == ""


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.card
def test_read_cell_on_the_card(card):
    line = harness.run_cell("eh-read-zipf", SEED, 1.0, False, "cuda",
                            overrides=TINY["eh-read-zipf"])
    assert line["correct"] is True and line["device"]["platform"] == "gpu"
