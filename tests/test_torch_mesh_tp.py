"""Port parity: tensor and sequence parallelism on a 2 x 2 (data x model)
mesh. Four gloo ranks on the CPU run the port's mesh steps
(``tests/torch_mesh_tp_ranks.py``) beside one JAX subprocess that runs the
reference's sharded steps on 4 fake devices (``jax.jit(make_train_step(cfg),
in_shardings=...)`` under ``sharding.use(mesh, preset)``, as its dry run
builds them), on the same seeded states and batches; this module compares
the two, and each mesh step with the port's one-device step.

Bounds: ``tests/test_torch_optim.py``'s bf16 bounds (the loss, ce and aux
within one bf16 roundoff, the masters within 2.1 x the steps' summed
learning rates), ``m``, ``v`` and the grad norm at ``STEP_K``, against both
the reference's sharded step and the port's one-device step; the
prefill's logits within ``LOGITS_K`` roundoffs of the reference's largest.
The ``slow`` sweep runs every other (arch, preset) pair.
"""
import os
import pickle
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs import ARCH_IDS, get_config
from tests.test_torch_mesh import _batch as _token_batch
from tests.test_torch_mesh import _one_device, _state
from tests.test_torch_optim import BF16_STEP_K
from tests.test_torch_train import BF16_EPS
from tests.torch_mesh_ranks import launch

ROOT = Path(__file__).resolve().parents[1]
RANKS = Path(__file__).resolve().parent / "torch_mesh_tp_ranks.py"
#: the (arch, preset) train steps held here; the first is also committed
CASES = (("yi-6b", "train"), ("yi-6b", "train_tp"), ("yi-6b", "train_tp_nosp"),
         ("recurrentgemma-9b", "train"), ("rwkv6-7b", "train"),
         ("mixtral-8x7b", "train_ep"), ("mixtral-8x7b", "train_multi_moe"),
         ("phi3.5-moe-42b-a6.6b", "train_dp_ep"))
#: (arch, preset, dtype) of the prefills held here: mixtral in f32, where
#: no near-tied top-2 choice flips (in bf16 four of its 256 tokens flip)
PREFILLS = (("yi-6b", "train", "bfloat16"), ("mixtral-8x7b", "prefill_moe", "float32"))
TP_PRESETS = ("train", "train_tp", "train_tp_nosp")
MOE_PRESETS = ("train_ep", "train_multi_moe")
#: (k_m, k_v, grad norm) bounds by arch, against both the reference's
#: sharded step and the port's one-device step: yi-6b (and the other
#: dense-attention archs of the slow sweep) at
#: ``tests/test_torch_optim.py``'s (``BF16_STEP_K``, 2^-11), the rest from
#: readings (CHANGES.md, with a broken variant's beside them):
#: recurrentgemma-9b's v reads 13.1 against the one-device step, and the
#: reference's own sharded step reads 11.8 against its one-device step;
#: rwkv6-7b reads 15.3 / 21.8 / 2.85 x 2^-11 (the reference's own sharded
#: step 8.9 / 9.8 / 1.42 x 2^-11 against its one-device step, the port's
#: one-device step 11.2 / 12.6 / 2.25 x 2^-11 against that); the MoE archs
#: flip near-tied top-2 choices: mixtral reads 48.6 / 40.0 / 0.57 x 2^-11
#: here and 71.8 / 70.2 / 1.12 x 2^-11 under train_tp_nosp in the sweep,
#: phi3.5 72.0 / 59.3 / 0.68 x 2^-11 here and 57.8 / 42.9 / 1.13 x 2^-11
#: in the sweep (``python tests/test_torch_mesh_tp.py [sweep] [reference]``
#: prints them). Dropping the replicated leaves' all-reduce reads 166-322
#: / 192-254 / 1.2-379 x 2^-11 on every arch
STEP_K = {"yi-6b": BF16_STEP_K["yi-6b"] + (2.0 ** -11,),
          "recurrentgemma-9b": (8.0, 16.0, 2.0 ** -11),
          "rwkv6-7b": (24.0, 32.0, 2.0 ** -9),
          "mixtral-8x7b": (96.0, 96.0, 2.0 ** -10),
          "phi3.5-moe-42b-a6.6b": (96.0, 80.0, 2.0 ** -10)}
#: the prefill's logits within this many roundoffs of the dtype of the
#: reference's largest logit (readings: yi-6b 2.07 in bf16, mixtral-8x7b
#: 8.9 in f32)
LOGITS_K = {"bfloat16": 4.0, "float32": 64.0}

REFERENCE = textwrap.dedent("""
    import dataclasses, pickle, sys
    from pathlib import Path
    import numpy as np
    import jax, jax.numpy as jnp
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
    from repro.checkpoint.manager import _flatten
    from repro.configs import get_config
    from repro.models import param_specs
    from repro.optim import adamw
    from repro.parallel import sharding
    from repro.train.steps import TrainState, make_prefill_step, make_train_step

    d = Path(sys.argv[1])
    inp = pickle.loads((d / "inputs.pkl").read_bytes())
    mesh = Mesh(np.array(jax.devices()).reshape(2, 2), ("data", "model"))
    repl = NamedSharding(mesh, P())
    out = {}

    def tree(flat, head, spec):
        if isinstance(spec, dict):
            return {k: tree(flat, head + "/" + k, v) for k, v in spec.items()}
        return jnp.asarray(flat[head])

    def config(arch):
        return dataclasses.replace(get_config(arch, reduced=True), dtype="bfloat16")

    def batch_sh(b):
        return {k: NamedSharding(mesh, sharding.spec_for(("batch",) + (None,) * (v.ndim - 1),
                                                         dims=v.shape)) for k, v in b.items()}

    for arch, preset in inp["cases"]:
        cfg = config(arch)
        specs = param_specs(cfg)
        flat = inp[f"{arch}_state"]
        st = TrainState(tree(flat, ".params", specs),
                        adamw.AdamWState(tree(flat, ".opt/.m", specs),
                                         tree(flat, ".opt/.v", specs),
                                         jnp.asarray(flat[".opt/.count"])),
                        jnp.asarray(flat[".step"]))
        batches = inp[f"{arch}_batches"]
        with sharding.use(mesh, preset):
            p_sh = sharding.tree_shardings(specs, mesh, shape_tree=st.params)
            sh = TrainState(p_sh, adamw.AdamWState(p_sh, p_sh, repl), repl)
            step = jax.jit(make_train_step(cfg), in_shardings=(sh, batch_sh(batches[0])),
                           out_shardings=(sh, repl))
            st = jax.device_put(st, sh)
            metrics = []
            for b in batches:
                st, m = step(st, {k: jnp.asarray(v) for k, v in b.items()})
                metrics.append({k: float(v) for k, v in m.items()})
        out[f"train_{arch}_{preset}"] = metrics
        out[f"state_{arch}_{preset}"] = {k: np.asarray(v) for k, v in _flatten(st)[0].items()}

    for arch, preset, dtype in inp["prefills"]:
        cfg = dataclasses.replace(config(arch), dtype=dtype)
        specs = param_specs(cfg)
        params = tree(inp[f"{arch}_state"], ".params", specs)
        b = {"tokens": inp[f"{arch}_batches"][0]["tokens"]}
        with sharding.use(mesh, preset):
            p_sh = sharding.tree_shardings(specs, mesh, shape_tree=params)
            lspec = sharding.spec_for(("batch", "seq", "vocab"))
            f = jax.jit(make_prefill_step(cfg), in_shardings=(p_sh, batch_sh(b)),
                        out_shardings=NamedSharding(mesh, lspec))
            out[f"prefill_{arch}_{preset}"] = (np.asarray(f(params, b)), tuple(lspec))
    (d / "ref.pkl").write_bytes(pickle.dumps(out))
""")


def _batch(rng, cfg):
    """``tests/test_torch_mesh.py``'s batch of 4 x 64 tokens with masked
    labels; a vlm's 16 patch embeddings beside it, an audio model's frame
    embeddings in place of the tokens."""
    b = _token_batch(rng, cfg)
    if cfg.family == "vlm":
        b["patch_embeds"] = rng.normal(0, 1, (4, cfg.num_patches, cfg.d_model)).astype(
            np.float32)
    if cfg.family == "audio":
        b["frame_embeds"] = rng.normal(0, 1, (4, 64, cfg.d_model)).astype(np.float32)
        del b["tokens"]
    return b


def _run(d, cases, prefills, steps=2):
    """The seeded inputs, then the 4 port ranks beside the reference's
    subprocess, and the port's one-device steps meanwhile: (inputs, port
    results by rank, reference results, one-device results by arch)."""
    rng = np.random.default_rng(11)
    archs = sorted({c[0] for c in cases + prefills})
    inp = {"cases": cases, "prefills": prefills, "commit_dir": str(d / "commit")}
    for arch in archs:
        inp[f"{arch}_state"] = _state(arch)
        inp[f"{arch}_batches"] = [_batch(rng, get_config(arch, reduced=True))
                                  for _ in range(steps)]
    (d / "inputs.pkl").write_bytes(pickle.dumps(inp))
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "JAX_PLATFORMS": "cpu",
           "OMP_NUM_THREADS": "1", "XLA_FLAGS": "--xla_force_host_platform_device_count=4"}
    ref = subprocess.Popen([sys.executable, "-c", REFERENCE, str(d)], env=env, cwd=ROOT,
                           stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    wait = launch(4, d, d, script=RANKS)
    try:
        one = {a: _one_device(a, inp[f"{a}_state"], inp[f"{a}_batches"])
               for a in sorted({a for a, _ in cases})}
        port = wait()
    finally:
        log, _ = ref.communicate(timeout=900)
    assert ref.returncode == 0, log[-4000:]
    return inp, port, pickle.loads((d / "ref.pkl").read_bytes()), one


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return _run(tmp_path_factory.mktemp("mesh_tp"), CASES, PREFILLS)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _errors(got, want):
    """(masters' largest difference, m's and v's in roundoffs of each
    leaf's largest magnitude), the rest exact."""
    assert set(got) == set(want)
    p = km = kv = 0.0
    for key, w in want.items():
        a = got[key]
        assert a.shape == w.shape, key
        if key.startswith(".params"):
            p = max(p, float(np.abs(a - w).max()))
        elif key.startswith((".opt/.m", ".opt/.v")):
            k = float(np.abs(a - w).max()) / (BF16_EPS * max(float(np.abs(w).max()), 1e-30))
            if key.startswith(".opt/.m"):
                km = max(km, k)
            else:
                kv = max(kv, k)
        else:
            assert np.array_equal(a, w), key
    return p, km, kv


def _hold(got_m, want_m, got_state, want_state, lr_sum, bounds, keys):
    k_m, k_v, k_g = bounds
    for got, want in zip(got_m, want_m):
        for k in keys:
            np.testing.assert_allclose(got[k], want[k], rtol=BF16_EPS, atol=0, err_msg=k)
        np.testing.assert_allclose(got["grad_norm"], want["grad_norm"], rtol=k_g, atol=0)
        assert got["lr"] == want["lr"]
    p, km, kv = _errors(got_state, want_state)
    assert p <= 2.1 * lr_sum, f"masters {p} above {2.1 * lr_sum}"
    assert km <= k_m and kv <= k_v, f"m {km}, v {kv} roundoffs"


def _hold_step(runs, arch, preset):
    inp, port, ref, one = runs
    key = f"{arch}_{preset}"
    assert all(r[f"train_{key}"] == port[0][f"train_{key}"] for r in port)
    got_m, got_state = port[0][f"train_{key}"], port[0][f"state_{key}"]
    lr_sum = sum(m["lr"] for m in ref[f"train_{key}"])
    assert lr_sum > 0
    bounds = STEP_K.get(arch, STEP_K["yi-6b"])
    _hold(got_m, ref[f"train_{key}"], got_state, ref[f"state_{key}"], lr_sum, bounds,
          ("loss", "ce", "aux"))
    # the dense MoE has no aux loss, and the shard_map variants average
    # each rank's: the one-device step's loss or aux is not theirs
    keys = {"train_multi_moe": ("ce",), "train_dp_ep": ("loss", "ce")}.get(
        preset, ("loss", "ce", "aux"))
    _hold(got_m, one[arch][0], got_state, one[arch][1], lr_sum, bounds, keys)


@pytest.mark.parametrize("arch,preset", CASES, ids=[f"{a}-{p}" for a, p in CASES])
def test_mesh_step_matches_reference(runs, arch, preset):
    """Two bf16 train steps of the reduced ``arch`` under ``preset`` on the
    2 x 2 mesh from a state at step 100: every rank's metrics equal, and the
    metrics and the gathered masters, m and v within the bf16 bounds of the
    reference's sharded step and of the port's one-device step (under
    ``train_multi_moe`` the dense MoE has no aux loss: ce alone against the
    one-device step's metrics)."""
    _hold_step(runs, arch, preset)


@pytest.mark.parametrize("arch,preset,dtype", PREFILLS, ids=[f"{a}-{p}" for a, p, _ in PREFILLS])
def test_mesh_prefill_matches_reference(runs, arch, preset, dtype):
    """The mesh prefill's logits: each rank's block is the reference's
    ``("batch", "seq", "vocab")`` block at its coordinate (rows over
    'data', the sequence over 'model', the whole vocabulary), and the
    blocks put together are the reference's logits within ``LOGITS_K``
    roundoffs of the dtype."""
    _, port, ref, _ = runs
    want, spec = ref[f"prefill_{arch}_{preset}"]
    assert spec[:2] == ("data", "model")
    B, S, V = want.shape
    got = np.zeros_like(want)
    for r in port:
        block = r[f"prefill_{arch}_{preset}"]
        assert block.shape == (B // 2, S // 2, V)
        i, j = r["coord"]
        got[i * B // 2:(i + 1) * B // 2, j * S // 2:(j + 1) * S // 2] = block
    eps = BF16_EPS if dtype == "bfloat16" else 2.0 ** -24
    err = float(np.abs(got - want).max()) / (eps * float(np.abs(want).max()))
    assert err <= LOGITS_K[dtype], err


def test_train_sharded_commit_restores(runs):
    """The first case's state committed from its ``train`` shards
    (``save_sharded``) is the reference's format: both packages' managers
    restore it, leaf for leaf equal to the gathered state."""
    from repro.checkpoint.manager import CheckpointManager as RefManager
    from repro_torch.checkpoint import CheckpointManager
    inp, port, _, _ = runs
    arch, preset = inp["cases"][0]
    full = port[0][f"state_{arch}_{preset}"]
    for manager in (RefManager, CheckpointManager):
        _, lazy, _ = manager(inp["commit_dir"]).restore_manifest()
        assert set(lazy) == set(full)
        for k, v in full.items():
            assert np.array_equal(np.asarray(lazy[k].get()), v), k


def test_only_serving_presets_refused():
    """Every train preset (and ``prefill_moe``) runs on a mesh; ``decode``
    and ``decode_b1`` do not."""
    from repro_torch.parallel import sharding
    assert set(sharding.presets()) - set(sharding.MESH_PRESETS) == {"decode", "decode_b1"}


_FAMILIES = {"dense": "yi-6b", "swa": "h2o-danube-3-4b", "vlm": "llava-next-mistral-7b",
             "audio": "musicgen-large", "moe": "mixtral-8x7b", "hybrid": "recurrentgemma-9b",
             "ssm": "rwkv6-7b"}
SWEEP = tuple((a, p) for a in _FAMILIES.values() for p in TP_PRESETS
              if (a, p) not in CASES) + tuple(
    (a, p) for a in ("mixtral-8x7b", "phi3.5-moe-42b-a6.6b") for p in MOE_PRESETS
    if (a, p) not in CASES)


@pytest.mark.slow
def test_mesh_step_sweep(tmp_path):
    """Every other family under ``train``, ``train_tp`` and
    ``train_tp_nosp`` and phi3.5 under ``train_ep`` and ``train_multi_moe``,
    held as the cases above."""
    assert set(ARCH_IDS) >= {a for a, _ in SWEEP}
    runs = _run(tmp_path, SWEEP, ())
    failed = []
    for arch, preset in SWEEP:
        try:
            _hold_step(runs, arch, preset)
        except AssertionError as e:
            failed.append(f"{arch} {preset}: {e}")
    assert not failed, "\n".join(failed)


def _line(what, got_m, want_m, got_state, want_state, lr_sum):
    rel = {k: max(abs(g[k] - w[k]) / abs(w[k]) if w[k] else abs(g[k])
                  for g, w in zip(got_m, want_m)) for k in ("loss", "ce", "aux", "grad_norm")}
    p, km, kv = _errors(got_state, want_state)
    return (f"{what}: loss {rel['loss'] / BF16_EPS:.3f} ce {rel['ce'] / BF16_EPS:.3f} aux "
            f"{rel['aux'] / BF16_EPS:.3f} grad norm {rel['grad_norm'] / 2.0 ** -11:.3f} "
            f"masters/lr {p / lr_sum:.3f} m {km:.2f} v {kv:.2f}")


def _reference_one_device(inp, arch):
    """The reference's jitted one-device steps of ``arch`` from the inputs'
    state and batches: (metrics, state as the checkpoint's flat dict)."""
    import dataclasses

    import jax
    import jax.numpy as jnp
    from repro.checkpoint.manager import _flatten
    from repro.configs import get_config as ref_config
    from repro.train.steps import make_train_step as ref_make_train_step
    from repro_torch import interop
    from repro_torch.optim import adamw
    cfg = dataclasses.replace(ref_config(arch, reduced=True), dtype="bfloat16")
    pc = dataclasses.replace(get_config(arch, reduced=True), dtype="bfloat16")
    st = interop.train_state_from_jax(pc, inp[f"{arch}_state"], "cpu")
    st = adamw.map_tree(lambda t: jnp.asarray(t.numpy()), st)
    step = jax.jit(ref_make_train_step(cfg))
    metrics = []
    for b in inp[f"{arch}_batches"]:
        st, m = step(st, {k: jnp.asarray(v) for k, v in b.items()})
        metrics.append({k: float(v) for k, v in m.items()})
    return metrics, {k: np.asarray(v) for k, v in _flatten(st)[0].items()}


def _readings(runs, cases, reference=False):
    """Each case's bounded quantities in the bounds' units, against the
    reference's sharded step and the port's one-device step: the loss, ce
    and aux in bf16 roundoffs, the grad norm in 2^-11, the masters over
    the summed lr, m and v in roundoffs of each leaf's largest. With
    ``reference``, also the reference's sharded step and the port's
    one-device step against the reference's one-device step."""
    inp, port, ref, one = runs
    lines = []
    for arch, preset in cases:
        key = f"{arch}_{preset}"
        got = (port[0][f"train_{key}"], port[0][f"state_{key}"])
        lr_sum = sum(m["lr"] for m in ref[f"train_{key}"])
        shard = (ref[f"train_{key}"], ref[f"state_{key}"])
        lines.append(_line(f"{arch} {preset} against ref", got[0], shard[0], got[1], shard[1],
                           lr_sum))
        lines.append(_line(f"{arch} {preset} against one", got[0], one[arch][0], got[1],
                           one[arch][1], lr_sum))
        if reference:
            ref_one = _reference_one_device(inp, arch)
            lines.append(_line(f"{arch} {preset}: the reference's sharded step against its "
                               f"one-device step", shard[0], ref_one[0], shard[1], ref_one[1],
                               lr_sum))
            lines.append(_line(f"{arch}: the port's one-device step against the reference's",
                               one[arch][0], ref_one[0], one[arch][1], ref_one[1], lr_sum))
    return lines


if __name__ == "__main__":
    # PYTHONPATH=src:. JAX_PLATFORMS=cpu python tests/test_torch_mesh_tp.py [sweep] [reference]
    # prints the readings the bounds above were set from
    import tempfile
    cases = SWEEP if "sweep" in sys.argv[1:] else CASES
    torch.set_num_threads(1)
    with tempfile.TemporaryDirectory() as tmp:
        print("\n".join(_readings(_run(Path(tmp), cases, ()), cases,
                                  "reference" in sys.argv[1:])))
