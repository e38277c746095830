"""The port's dry run (``repro_torch.launch.dryrun``) against the reference's
(``repro.launch.dryrun``).

One JAX subprocess on 512 fake CPU devices with Auto-axis meshes (the
reference's own ``make_production_mesh`` gives Explicit axes on this jax,
which its ``logical_constraint`` refuses) and one port subprocess a fake
world (a process holds one process group): 256 and 512 ranks for the static
bytes of every cell, 4 ranks (ranks 0 and 3) for the 2 x 2 cells of
``tests/torch_dryrun_cells.py``, and the CLI. The static bytes are the
reference's ``_sharded_bytes`` formula exactly; the 2 x 2 dot FLOPs are the
reference's compiled count exactly, or differ by the term named for the
cell (``torch_dryrun_cells.flop_terms``): the port's whole-block remat
against the reference's ``checkpoint_dots_with_no_batch_dims``, the K/V
projections it computes whole where kv heads do not split over 'model', and
RWKV's bonus term, an einsum (a dot) in the reference and a
multiply-and-sum (no matmul) in the port.
"""
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
sys.path.insert(0, str(HERE))
import torch_dryrun_cells as C  # noqa: E402

from repro_torch.configs import ARCH_IDS, SHAPES, get_config, shape_applicable  # noqa: E402

ENV = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "OMP_NUM_THREADS": "1",
       "JAX_PLATFORMS": "cpu"}
MESHES = ("pod", "multipod")
APPLICABLE = [f"{m}/{a}/{s}" for m in MESHES for a in ARCH_IDS for s in SHAPES
              if shape_applicable(get_config(a), s)]
SKIPPED = [(a, s) for a in ARCH_IDS for s in SHAPES if not shape_applicable(get_config(a), s)]
CLI_DIR = "cli"


def _cfg(name):
    if name in C.CONFIGS:
        import dataclasses
        arch, over = C.CONFIGS[name]
        return dataclasses.replace(get_config(arch, reduced=True), **over)
    return get_config(name)


def _case(shape):
    from repro_torch.configs.shapes import ShapeCase
    return ShapeCase(shape, *C.SHAPES[shape]) if shape in C.SHAPES else SHAPES[shape]


#: the 2 x 2 cells whose packages differ by design, and the term that says by
#: how much (``torch_dryrun_cells.flop_terms``); every other cell has none
NAMED = {"yi-smoke-dots/train_128": ["remat"], "yi-smoke-kv1/decode_256": ["kv"],
         "rg-smoke/decode_256": ["kv"], "rg-smoke/decode_b1_256": ["kv", "rglru"],
         "rwkv-smoke/prefill_256": ["bonus"]}
CELL_KEYS = [C.cell_key(*c) for c in C.CELLS]


def _run_all(d: Path) -> dict:
    script = str(HERE / "torch_dryrun_cells.py")
    jobs = {"reference": [script, "reference", str(d / "reference.json")]}
    for world, rank in ((4, 0), (4, 3), (256, 0), (512, 0)):
        jobs[f"{world}_{rank}"] = [script, "port", str(world), str(rank),
                                   str(d / f"{world}_{rank}.json")]
    cwd = d / CLI_DIR / "cwd"
    cwd.mkdir(parents=True)
    jobs["cli"] = ["-m", "repro_torch.launch.dryrun", "--arch", "yi-6b", "--shape",
                   "decode_32k", "--mesh", "both", "--out", str(d / CLI_DIR / "out")]
    procs = {k: subprocess.Popen([sys.executable] + v, env=ENV, cwd=cwd if k == "cli" else ROOT,
                                 stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for k, v in jobs.items()}
    out = {}
    for k, p in procs.items():
        text, _ = p.communicate(timeout=600)
        assert p.returncode == 0, f"{k}: {text[-3000:]}"
        if k != "cli":
            out[k] = json.loads((d / f"{k}.json").read_text())
    return out


@pytest.fixture(scope="module")
def readings(tmp_path_factory):
    d = tmp_path_factory.mktemp("dryrun")
    out = _run_all(d)
    out["dir"] = d
    return out


@pytest.mark.parametrize("cell", APPLICABLE)
def test_static_bytes_equal_reference(readings, cell):
    """``static_bytes_per_device`` and the rules of every cell on both
    production meshes: the reference's ``_sharded_bytes`` formula, exactly."""
    mesh = cell.split("/")[0]
    port = readings["256_0" if mesh == "pod" else "512_0"]["static"]
    assert port[cell] == readings["reference"]["static"][cell]


def test_every_cell_covered(readings):
    for key in ("256_0", "512_0"):
        assert sorted(readings[key]["static"]) == sorted(
            c for c in APPLICABLE if c.startswith("pod/" if key == "256_0" else "multipod/"))
    assert len(APPLICABLE) == 68 and len(SKIPPED) == 6
    assert all(s == "long_500k" for _, s in SKIPPED)


@pytest.mark.parametrize("cell", CELL_KEYS)
def test_2x2_dot_flops_against_compiled_reference(readings, cell):
    """The port's FLOPs a rank on the 2 x 2 mesh: the reference's compiled
    count exactly, or off by the cell's named term; its static bytes the
    reference's."""
    got = readings["4_0"]["cells"][cell]
    want = readings["reference"]["flops"][cell]
    arch, shape = cell.split("/")[:2]
    terms = C.flop_terms(_cfg(arch), _case(shape), "2x2", got["rules"])
    assert sorted(terms) == NAMED.get(cell, [])
    assert got["dot_flops_per_device"] == want + sum(terms.values())
    assert [got["static_bytes_per_device"], got["rules"]] == \
        readings["reference"]["static"][f"2x2/{cell}"]


def test_2x2_decode_32k_readings(readings):
    """yi-6b x decode_32k on the 2 x 2 mesh: what the four cards of the
    mesh phase counted (PERF.md: 102.24 MB all-reduced and 10.49 MB gathered
    a step a rank)."""
    got = readings["4_0"]["cells"]["yi-6b/decode_32k"]
    assert got["dot_flops_per_device"] == 920_867_831_808 == \
        readings["reference"]["flops"]["yi-6b/decode_32k"]
    assert got["static_bytes_per_device"] == 74_780_778_752
    assert got["collective_input_bytes"] == {"all-reduce": 102_236_160, "all-gather": 10_485_760}
    # a group of 2: the all-reduce's ring moves its bytes once, as XLA's does
    assert got["collective_wire_bytes"]["all-reduce"] == \
        readings["reference"]["wire"]["yi-6b/decode_32k"]["all-reduce"] == 102_236_160


@pytest.mark.parametrize("cell", [c for c in CELL_KEYS if not c.startswith("yi-6b/")])
def test_meta_build_matches_real_tensors(readings, cell):
    """The same reduced step on zeros on the CPU: the bytes it holds and
    returns and what it hands each collective equal the meta build's; the
    FLOPs too, but where an MoE's experts are counted at capacity, which
    only the meta device does."""
    meta, cpu = readings["4_0"]["cells"][cell], readings["4_0"]["cpu"][cell]
    for k in ("memory_analysis", "collective_input_bytes", "collective_counts",
              "collective_wire_bytes"):
        assert meta[k] == cpu[k], k
    if cell == "mixtral-smoke/train_128":
        assert meta["moe_experts"] == "capacity"
        assert cpu["dot_flops_per_device"] < meta["dot_flops_per_device"]
    else:
        assert cpu["dot_flops_per_device"] == meta["dot_flops_per_device"]


def test_rank_0_stands_for_the_last(readings):
    """Rank 3 of the 2 x 2 mesh reads what rank 0 reads, cell for cell."""
    assert readings["4_3"]["cells"] == readings["4_0"]["cells"]


@pytest.mark.parametrize("key", [f"{k}/{n}" for k in C.KINDS_ORDER for n in (2, 4)])
def test_ring_factors_against_hlo_analysis(readings, key):
    """``wire_bytes`` of one f32 (8, 16) shard handed to a group of n equals
    what the reference's ``hlo_analysis`` reads off the compiled
    collective."""
    from repro_torch.launch.dryrun import wire_bytes
    kind, n = key.split("/")
    wire, counts = wire_bytes({(kind, int(n)): [1, 8 * 16 * 4]})
    assert wire == readings["reference"]["ring"][key]
    assert sum(counts.values()) == 1


def test_cli_pod_and_multipod(readings):
    """``--mesh both`` writes one record a mesh under ``--out`` and nothing
    anywhere else; a 256- and a 512-rank world; the static bytes the
    reference's; on the pod mesh the FLOPs the reference's compiled count
    plus the K/V projections yi-6b computes whole on its 16 'model' ranks."""
    d = readings["dir"] / CLI_DIR
    files = sorted(str(p.relative_to(d)) for p in d.rglob("*") if p.is_file())
    assert files == ["out/multipod/yi-6b__decode_32k.json", "out/pod/yi-6b__decode_32k.json"]
    ref = readings["reference"]
    for mesh, n in (("pod", 256), ("multipod", 512)):
        rec = json.loads((d / "out" / mesh / "yi-6b__decode_32k.json").read_text())
        assert rec["status"] == "ok" and rec["n_devices"] == n and rec["rules"] == "decode"
        assert rec["static_bytes_per_device"] == ref["static"][f"{mesh}/yi-6b/decode_32k"][0]
        assert rec["flops_raw"] is None and rec["bytes_raw"] is None and rec["hlo_bytes"] is None
        assert rec["memory_analysis"]["temp_bytes"] is None
        assert rec["memory_analysis"]["argument_bytes"] > rec["static_bytes_per_device"]
        assert set(rec["collective_wire_bytes"]) == {"all-reduce", "all-gather"}
        if mesh == "pod":
            assert rec["static_bytes_per_device"] == 1_831_870_496
            kv = C.flop_terms(get_config("yi-6b"), SHAPES["decode_32k"], "pod", "decode")
            assert kv == {"kv": 15 * 2 * 8 * 4096 * 1024 * 32 // 16}
            assert rec["dot_flops_per_device"] == 16_401_825_792 == (
                ref["pod_flops"]["yi-6b/decode_32k"] + kv["kv"])
            assert rec["collective_input_bytes"] == {"all-reduce": 12_779_520,
                                                     "all-gather": 131_072}


@pytest.mark.parametrize("multi_pod", [False, True], ids=MESHES)
def test_long_500k_skipped_as_the_reference(readings, tmp_path, multi_pod):
    """A full-attention arch's long_500k cell: skipped with the reference's
    record (no process group is started)."""
    from repro_torch.launch import dryrun
    rec = dryrun.run_cell("yi-6b", "long_500k", multi_pod, tmp_path)
    want = dict(readings["reference"]["skip"], mesh="multipod" if multi_pod else "pod")
    assert rec == want
    mesh = "multipod" if multi_pod else "pod"
    assert json.loads((tmp_path / mesh / "yi-6b__long_500k.json").read_text()) == want
    assert dryrun._WORLD["fake"] is None


def test_moe_capacity_branch_only_on_meta():
    """``_moe_math`` multiplies the rows the router kept on real tensors
    and ``cap`` rows an expert and a batch row on the meta device."""
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.models.moe import MoEConfig, _moe_math, moe_capacity
    mc = MoEConfig(n_experts=4, top_k=2)
    B, S, d, f, E = 2, 32, 16, 24, 4
    gen = torch.Generator().manual_seed(0)
    ws = [torch.randn(shape, generator=gen) for shape in
          ((B, S, d), (d, E), (E, d, f), (E, d, f), (E, f, d))]
    cap = moe_capacity(mc, S)

    def count(ts):
        with FlopCounterMode(display=False) as fc:
            y, _, routed = _moe_math(mc, *ts, cap)
        return fc.get_total_flops(), y, routed

    router = 2 * B * S * d * E
    real, y, routed = count(ws)
    assert real == router + 3 * 2 * B * S * mc.top_k * d * f     # every assignment kept
    meta, ym, _ = count([t.to("meta") for t in ws])
    assert meta == router + 3 * 2 * E * B * cap * d * f
    assert ym.device.type == "meta" and ym.shape == y.shape and routed.shape == (B, S * 2)


@pytest.mark.slow
def test_2x2_prefill_32k_full_width(tmp_path):
    """yi-6b x prefill_32k at full width on the 2 x 2 mesh: the reference's
    compiled count (~6 minutes of meta ops)."""
    script = str(HERE / "torch_dryrun_cells.py")
    for args in (["reference", str(tmp_path / "r.json"), "yi-6b/prefill_32k"],
                 ["port", "4", "0", str(tmp_path / "p.json"), "yi-6b/prefill_32k"]):
        subprocess.run([sys.executable, script] + args, env=ENV, cwd=ROOT, check=True,
                       timeout=1800)
    ref = json.loads((tmp_path / "r.json").read_text())["flops"]["yi-6b/prefill_32k"]
    got = json.loads((tmp_path / "p.json").read_text())["cells"]["yi-6b/prefill_32k"]
    assert got["dot_flops_per_device"] == ref == 7_543_749_278_171_136


@pytest.mark.slow
def test_full_sweep(readings, tmp_path):
    """``--all --mesh both``: 68 records ok and 12 skipped (every one a
    long_500k), none an error, every static byte count the reference's
    (about an hour a mesh on one core)."""
    r = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun", "--all", "--mesh",
                        "both", "--out", str(tmp_path)], env=ENV, cwd=tmp_path,
                       capture_output=True, text=True, timeout=4 * 3600)
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    recs = [json.loads(p.read_text()) for p in tmp_path.glob("*/*.json")]
    assert sum(r["status"] == "ok" for r in recs) == 68
    skipped = [r for r in recs if r["status"] == "skipped"]
    assert len(skipped) == 12 and all(r["shape"] == "long_500k" for r in skipped)
    for r in recs:
        if r["status"] == "ok":
            key = f"{r['mesh']}/{r['arch']}/{r['shape']}"
            assert r["static_bytes_per_device"] == readings["reference"]["static"][key][0]
            assert r["dot_flops_per_device"] > 0 and math.isfinite(r["dot_flops_per_device"])
