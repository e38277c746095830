"""Port parity: training on a 2 x 2 (data x model) mesh. Four gloo ranks on
the CPU run the port (``tests/torch_mesh_ranks.py``) beside one JAX
subprocess that runs the reference on 4 fake devices, on the same seeded
inputs; this module compares the two, and the port's mesh steps with its
one-device steps.

Bounds, each set from readings (the port's, and a broken variant's beside
them in ``CHANGES.md``):

* state shards, the reshard after the shrink, ``compressed_psum`` and
  ``fsdp_gather_int8``'s forward and backward: bit for bit;
* each MoE shard_map variant against the reference's same variant in f32
  within ``MOE_TOL``; against plain ``moe_apply`` within ``MOE_INT8`` of the
  output's largest magnitude (the int8 weight gather);
* train steps at ``tests/test_torch_optim.py``'s bf16 bounds (the loss,
  ce and aux within one bf16 roundoff, the grad norm within 2^-11, the
  masters within 2.1 x the steps' summed learning rates, the moments at
  ``MESH_STEP_K``), against both the reference's sharded step and the
  port's one-device step.
"""
import dataclasses
import os
import pickle
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import interop
from repro_torch.checkpoint import CheckpointManager
from repro_torch.checkpoint.manager import flatten
from repro_torch.configs import get_config
from repro_torch.models import init_params
from repro_torch.train import steps as TS
from tests.test_torch_optim import BF16_STEP_K
from tests.test_torch_train import BF16_EPS
from tests.torch_mesh_ranks import launch

ROOT = Path(__file__).resolve().parents[1]
ARCHS = ("yi-6b", "mixtral-8x7b")
#: the MoE variants against the reference's same variant, f32: the port
#: reads at most 7.7e-7 (outputs of magnitude ~4); a bf16 or f32 gather in
#: place of the int8 one reads ~1e-2
MOE_TOL = dict(rtol=1e-5, atol=2e-6)
#: ... and against plain moe_apply: the int8 gather's error as a share of
#: the output's largest magnitude, between these (readings 0.0073-0.0098; a
#: gather that does not quantize reads ~1e-7)
MOE_INT8 = (1e-3, 0.02)
#: (k_m, k_v) of the mesh steps' moments, as ``BF16_STEP_K``: yi-6b at
#: ``tests/test_torch_optim.py``'s bounds (it reads 4.0 / 5.2 from the
#: reference's sharded step, 3.9 / 4.2 from the one-device step). Three
#: mixtral steps read 39.2 / 30.0 from the reference's sharded step and
#: 41.1 / 46.5 from the port's one-device step, and the reference's own
#: sharded step reads 41.0 / 45.8 from that one-device step: the int8
#: expert gather and the per-rank aux are the variant's, and near-tied
#: top-2 choices flip with them
MESH_STEP_K = {"yi-6b": BF16_STEP_K["yi-6b"], "mixtral-8x7b": (56.0, 64.0)}

REFERENCE = textwrap.dedent("""
    import dataclasses, pickle, sys
    from pathlib import Path
    import numpy as np
    import jax, jax.numpy as jnp
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
    from jax.experimental.shard_map import shard_map
    from repro.checkpoint.manager import CheckpointManager, _flatten
    from repro.configs import get_config
    from repro.launch import elastic
    from repro.models import moe as M, param_specs
    from repro.optim import adamw
    from repro.parallel import compression, sharding
    from repro.train.steps import TrainState, make_train_step

    d = Path(sys.argv[1])
    inp = pickle.loads((d / "inputs.pkl").read_bytes())
    mesh = Mesh(np.array(jax.devices()).reshape(2, 2), ("data", "model"))
    BOTH = ("data", "model")
    out = {}

    def tree(flat, head, spec):
        if isinstance(spec, dict):
            return {k: tree(flat, head + "/" + k, v) for k, v in spec.items()}
        return jnp.asarray(flat[head])

    def state(flat, specs):
        return TrainState(tree(flat, ".params", specs),
                          adamw.AdamWState(tree(flat, ".opt/.m", specs),
                                           tree(flat, ".opt/.v", specs),
                                           jnp.asarray(flat[".opt/.count"])),
                          jnp.asarray(flat[".step"]))

    def shardings(m, specs, st):
        p_sh = sharding.tree_shardings(specs, m, shape_tree=st.params)
        repl = NamedSharding(m, P())
        return TrainState(p_sh, adamw.AdamWState(p_sh, p_sh, repl), repl)

    def shards(m, st):
        got = {}
        for key, arr in _flatten(st)[0].items():
            for s in arr.addressable_shards:
                c = tuple(int(i) for i in np.argwhere(m.devices == s.device)[0])
                got.setdefault(c, {})[key] = np.asarray(s.data)
        return got

    yi = dataclasses.replace(get_config("yi-6b", reduced=True), dtype="bfloat16")
    specs = param_specs(yi)
    st = state(inp["yi_state"], specs)
    with sharding.use(mesh, "train_dp"):
        out["shards"] = shards(mesh, jax.device_put(st, shardings(mesh, specs, st)))

    def sync(g, r):
        m, res = compression.compressed_psum({"w": g[0]}, {"w": r[0]}, "data")
        return m["w"][None], res["w"][None]
    f = jax.jit(shard_map(sync, mesh=mesh, in_specs=(P(BOTH), P(BOTH)),
                          out_specs=(P(BOTH), P(BOTH)), check_rep=False))
    r = jnp.zeros(inp["cp_g"].shape[1:], jnp.float32)
    out["cp"] = []
    for g in inp["cp_g"]:
        m, r = f(jnp.asarray(g), r)
        out["cp"].append((np.asarray(m), np.asarray(r)))

    def fg(w, ct):
        y, vjp = jax.vjp(lambda w: compression.fsdp_gather_int8(w, BOTH, 1, jnp.bfloat16), w)
        return y[None], vjp(ct[0].astype(jnp.bfloat16))[0]
    y, g = jax.jit(shard_map(fg, mesh=mesh, in_specs=(P(None, BOTH, None), P(BOTH)),
                     out_specs=(P(BOTH), P(None, BOTH, None)), check_rep=False))(
        jnp.asarray(inp["fg_w"]), jnp.asarray(inp["fg_ct"]))
    out["fg"] = (np.asarray(y.astype(jnp.float32)), np.asarray(g))

    x = jnp.asarray(inp["moe_x"])
    for key, arch, rules in (("shardmap", "mixtral-8x7b", "train_dp"),
                             ("ep", "phi3.5-moe-42b-a6.6b", "train_dp_ep")):
        mc = get_config(arch, reduced=True).moe_cfg()
        params = {k: jnp.asarray(v) for k, v in inp[f"moe_{key}"].items()}
        with sharding.use(mesh, rules):
            if key == "ep":
                y, aux = jax.jit(lambda p, x: M.moe_apply_ep_shardmap(
                    p, mc, x, mesh, BOTH, "model", ("data",)))(params, x)
            else:
                y, aux = jax.jit(lambda p, x: M.moe_apply_shardmap(p, mc, x, mesh, BOTH,
                                                                   BOTH))(params, x)
            y2, aux2 = jax.jit(lambda p, x: M.moe_apply(p, mc, x))(params, x)
        assert np.array_equal(np.asarray(y), np.asarray(y2)), key
        y0, aux0 = jax.jit(lambda p, x: M.moe_apply(p, mc, x))(params, x)
        out[f"moe_{key}"] = (np.asarray(y), float(aux), np.asarray(y0), float(aux0))

    for arch in ("yi-6b", "mixtral-8x7b"):
        cfg = dataclasses.replace(get_config(arch, reduced=True), dtype="bfloat16")
        specs = param_specs(cfg)
        st = state(inp[f"{arch}_state"], specs)
        with sharding.use(mesh, "train_dp"):
            sh = shardings(mesh, specs, st)
            b_sh = NamedSharding(mesh, sharding.spec_for(("batch", None), dims=(4, 64)))
            step = jax.jit(make_train_step(cfg), in_shardings=(sh, {"tokens": b_sh,
                           "labels": b_sh}), out_shardings=(sh, NamedSharding(mesh, P())))
            st = jax.device_put(st, sh)
            metrics = []
            for b in inp[f"{arch}_batches"]:
                st, m = step(st, {k: jnp.asarray(v) for k, v in b.items()})
                metrics.append({k: float(v) for k, v in m.items()})
        out[f"train_{arch}"] = metrics
        out[f"state_{arch}"] = {k: np.asarray(v) for k, v in _flatten(st)[0].items()}

    small = elastic.shrink_mesh(mesh, "data", 1)
    _, lazy, _ = CheckpointManager(inp["fixed_dir"]).restore_manifest()
    st = state({k: np.asarray(v.get()) for k, v in lazy.items()}, param_specs(yi))
    got = TrainState(*(elastic.reshard_tree(t, small, param_specs(yi), "train_dp")
                       for t in (st.params,)), adamw.AdamWState(
        elastic.reshard_tree(st.opt.m, small, param_specs(yi), "train_dp"),
        elastic.reshard_tree(st.opt.v, small, param_specs(yi), "train_dp"),
        jax.device_put(st.opt.count, NamedSharding(small, P()))),
        jax.device_put(st.step, NamedSharding(small, P())))
    out["reshard"] = shards(small, got)

    # the reshard and one step under the default preset, train
    specs = param_specs(yi)
    with sharding.use(small, "train"):
        sh = shardings(small, specs, st)
        out["reshard_train"] = shards(small, jax.device_put(st, sh))
        _, lazy, _ = CheckpointManager(inp["commit_dir"]).restore_manifest()
        st = jax.device_put(state({k: np.asarray(v.get()) for k, v in lazy.items()}, specs), sh)
        b_sh = NamedSharding(small, sharding.spec_for(("batch", None), dims=(4, 64)))
        step = jax.jit(make_train_step(yi), in_shardings=(sh, {"tokens": b_sh, "labels": b_sh}),
                       out_shardings=(sh, NamedSharding(small, P())))
        st, m = step(st, {k: jnp.asarray(v) for k, v in inp["elastic_batch"].items()})
    out["elastic_train_metrics"] = {k: float(v) for k, v in m.items()}
    out["elastic_train_state"] = {k: np.asarray(v) for k, v in _flatten(st)[0].items()}
    (d / "ref.pkl").write_bytes(pickle.dumps(out))
""")


def _state(arch):
    """The reduced ``arch``'s state at step 100 (lr at its peak): the
    port's seed-0 f32 masters, zero moments, as the checkpoint's flat
    numpy dict."""
    cfg = get_config(arch, reduced=True)
    st = TS.train_state_init(TS.master_params(
        init_params(dataclasses.replace(cfg, dtype="float32"), 0, "cpu")))
    st.step.fill_(100)
    return {k: v.numpy().copy() for k, v in flatten(st).items()}


def _batch(rng, cfg, B=4, S=64):
    b = {"tokens": rng.integers(1, cfg.vocab_size, (B, S)).astype(np.int32),
         "labels": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)}
    b["labels"][0, :3] = -1
    b["labels"][3, 10:14] = -1
    return b


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The seeded inputs, then the 4 port ranks beside the reference's
    subprocess: (inputs, port results by rank, reference results)."""
    d = tmp_path_factory.mktemp("mesh")
    rng = np.random.default_rng(7)
    inp = {}
    for arch in ARCHS:
        inp[f"{arch}_state"] = _state(arch)
        inp[f"{arch}_batches"] = [_batch(rng, get_config(arch, reduced=True)) for _ in range(3)]
    inp["yi_state"] = inp["yi-6b_state"]
    inp["cp_g"] = rng.normal(0, 1, (3, 4, 64, 32)).astype(np.float32)
    inp["fg_w"] = rng.normal(0, 1, (2, 32, 48)).astype(np.float32)
    inp["fg_ct"] = rng.normal(0, 1, (4, 2, 32, 48)).astype(np.float32)
    inp["moe_x"] = rng.normal(0, 1, (4, 64, 256)).astype(np.float32)
    for key, arch in (("shardmap", "mixtral-8x7b"), ("ep", "phi3.5-moe-42b-a6.6b")):
        st = _state(arch)
        inp[f"moe_{key}"] = {k: st[f".params/blocks_0/moe/{k}"][0]
                             for k in ("router", "w_gate", "w_up", "w_down")}
    inp["commit_dir"], inp["fixed_dir"] = str(d / "commit"), str(d / "fixed")
    yi = get_config("yi-6b", reduced=True)
    CheckpointManager(inp["fixed_dir"]).save(
        100, interop.train_state_from_jax(yi, inp["yi_state"], "cpu"))
    inp["elastic_batch"] = _batch(rng, yi)
    (d / "inputs.pkl").write_bytes(pickle.dumps(inp))

    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": "--xla_force_host_platform_device_count=4"}
    ref = subprocess.Popen([sys.executable, "-c", REFERENCE, str(d)], env=env, cwd=ROOT,
                           stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    wait = launch(4, d, d)
    try:
        port = wait()
    finally:
        log, _ = ref.communicate(timeout=600)
    assert ref.returncode == 0, log[-4000:]
    return inp, port, pickle.loads((d / "ref.pkl").read_bytes())


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rank_index(r):
    return r["coord"][0] * 2 + r["coord"][1]


def test_state_shards_bit_equal(runs):
    """Each rank's shards of the seeded yi-6b state under train_dp equal the
    reference's ``addressable_shards`` at the same mesh coordinate."""
    _, port, ref = runs
    for r in port:
        want = ref["shards"][r["coord"]]
        assert set(r["shards"]) == set(want)
        for k, v in want.items():
            assert r["shards"][k].shape == v.shape and np.array_equal(r["shards"][k], v), k


def test_compressed_psum_matches_reference(runs):
    """Three steps of ``compressed_psum`` over 'data' with residuals carried:
    the means and residuals of every rank equal the reference's."""
    _, port, ref = runs
    for r in port:
        i = _rank_index(r)
        for (mean, res), (rm, rr) in zip(r["cp"], ref["cp"]):
            assert np.array_equal(mean, rm[i]) and np.array_equal(res, rr[i])


def test_fsdp_gather_int8_forward_and_backward(runs):
    """The int8 gather's output (bf16) and its backward (a seeded bf16
    cotangent a rank, reduce-scattered) equal the reference's."""
    _, port, ref = runs
    y, g = ref["fg"]
    for r in port:
        i = _rank_index(r)
        got_y, got_g = r["fg"]
        assert np.array_equal(got_y, y[i])
        assert np.array_equal(got_g, g[:, i * 8:(i + 1) * 8])


@pytest.mark.parametrize("key", ["shardmap", "ep"])
def test_moe_variant_matches_reference(runs, key):
    """``moe_apply_shardmap`` (mixtral, train_dp) and
    ``moe_apply_ep_shardmap`` (phi3.5, train_dp_ep) on each rank's row
    equal the reference's same variant (f32, ``MOE_TOL``), and plain
    ``moe_apply`` within the int8 gather's error (``MOE_INT8``); ``moe_apply``
    chooses the variant the reference chooses."""
    _, port, ref = runs
    y, aux, y0, aux0 = ref[f"moe_{key}"]
    for r in port:
        i = _rank_index(r)
        got, got_aux = r[f"moe_{key}"]
        assert r[f"variant_{key}"] == key
        np.testing.assert_allclose(got, y[i:i + 1], **MOE_TOL)
        np.testing.assert_allclose(got_aux, aux, rtol=1e-6)
        err = np.abs(got - y0[i:i + 1]).max() / np.abs(y0).max()
        assert MOE_INT8[0] <= err <= MOE_INT8[1], err


def test_moe_dense_matches_reference():
    """``moe_apply_dense`` (the serving presets' MoE) equals the reference's
    on the same rows, f32."""
    import jax.numpy as jnp
    from repro.models import moe as RM
    from repro_torch.models import moe as PM
    cfg = get_config("mixtral-8x7b", reduced=True)
    rng = np.random.default_rng(3)
    st = _state("mixtral-8x7b")
    params = {k: st[f".params/blocks_0/moe/{k}"][0] for k in ("router", "w_gate", "w_up",
                                                               "w_down")}
    x = rng.normal(0, 1, (2, 16, cfg.d_model)).astype(np.float32)
    y, aux = RM.moe_apply_dense({k: jnp.asarray(v) for k, v in params.items()},
                                cfg.moe_cfg(), jnp.asarray(x))
    got, got_aux = PM.moe_apply_dense({k: torch.from_numpy(v) for k, v in params.items()},
                                      cfg.moe_cfg(), torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(y), **MOE_TOL)
    assert float(got_aux) == float(aux) == 0.0


def _hold_state(got, want, arch, lr_sum):
    """``tests/test_torch_optim.py``'s bf16 bounds on a whole state, the
    moments at ``MESH_STEP_K``."""
    assert set(got) == set(want)
    k_m, k_v = MESH_STEP_K[arch]
    for key, w in want.items():
        a = got[key]
        assert a.shape == w.shape, key
        if key.startswith(".params"):
            bound = 2.1 * lr_sum
        elif key.startswith((".opt/.m", ".opt/.v")):
            bound = (k_m if key.startswith(".opt/.m") else k_v) * BF16_EPS * np.abs(w).max()
        else:
            assert np.array_equal(a, w), key
            continue
        err = float(np.abs(a - w).max())
        assert err <= bound, f"{key}: {err} above {bound}"


def _hold_metrics(got, want, keys=("loss", "ce", "aux")):
    for k in keys:
        np.testing.assert_allclose(got[k], want[k], rtol=BF16_EPS, atol=0, err_msg=k)
    np.testing.assert_allclose(got["grad_norm"], want["grad_norm"], rtol=2.0 ** -11, atol=0)
    assert got["lr"] == want["lr"]


def _one_device(arch, flat, batches):
    """The port's one-device steps from a flat state."""
    cfg = dataclasses.replace(get_config(arch, reduced=True), dtype="bfloat16")
    st = interop.train_state_from_jax(cfg, flat, "cpu")
    step = TS.make_train_step(cfg)
    metrics = []
    for b in batches:
        st, m = step(st, {k: torch.from_numpy(v) for k, v in b.items()})
        metrics.append({k: float(v) for k, v in m.items()})
    return metrics, interop.train_state_to_numpy(st)


@pytest.mark.parametrize("arch", ARCHS)
def test_mesh_train_steps(runs, arch):
    """Three bf16 train steps on the 2 x 2 mesh under train_dp from a state
    at step 100: every rank's metrics equal, and the metrics and the
    gathered masters, m and v within the bf16 bounds of both the
    reference's sharded step and the port's one-device step."""
    inp, port, ref = runs
    lr_sum = sum(m["lr"] for m in ref[f"train_{arch}"])
    assert lr_sum > 0
    assert all(r[f"train_{arch}"] == port[0][f"train_{arch}"] for r in port)
    one_m, one_state = _one_device(arch, inp[f"{arch}_state"], inp[f"{arch}_batches"])
    for want_m, want_state, keys in (
            (ref[f"train_{arch}"], ref[f"state_{arch}"], ("loss", "ce", "aux")),
            # the shard_map variant's aux is the mean of each rank's
            # load-balance loss, the one-device step's that of the whole
            # batch (2.3 % apart here): held to the reference's only
            (one_m, one_state, ("loss", "ce") if arch == "mixtral-8x7b" else ("loss", "ce", "aux"))):
        for got, want in zip(port[0][f"train_{arch}"], want_m):
            _hold_metrics(got, want, keys)
        _hold_state(port[0][f"state_{arch}"], want_state, arch, lr_sum)


def test_other_presets_and_meshes_refused(runs):
    """Every preset trains on a mesh, and a name that is not a preset
    raises, naming itself; the production mesh refuses a world of 4; a mesh
    made without ``device`` refuses a machine without a card."""
    _, port, _ = runs
    for r in port:
        assert "preset 'no_such_preset' is not a preset" in r["refused_no_such_preset"]
        assert "needs 256 ranks; the world has 4" in r["refused_production"]
        if not torch.cuda.is_available():
            assert "no CUDA device" in r["refused_no_card"]


def test_elastic_reshard_matches_reference(runs):
    """After ``shrink_mesh`` to (1, 2) the ranks outside leave, and the two
    left reshard a commit (``interop.train_state_to_mesh`` of the whole
    state, ``elastic.reshard_tree`` of its parameters) into shards equal to
    the reference's ``reshard_tree`` of it at the same coordinate."""
    _, port, ref = runs
    assert [bool(r.get("left")) for r in port] == [False, False, True, True]
    for r in port[:2]:
        want = ref["reshard"][r["coord"]]
        assert set(r["reshard"]) == set(want)
        for k, v in want.items():
            assert np.array_equal(r["reshard"][k], v), k
        # elastic.reshard_tree of the commit's parameter leaves alone
        got = {".params/" + k[len("params/"):]: v for k, v in r["reshard_tree"].items()}
        assert set(got) == {k for k in want if k.startswith(".params/")}
        for k, v in got.items():
            assert np.array_equal(v, want[k]), k


def test_elastic_step_and_sharded_commit(runs):
    """The 2 x 2 mesh's sharded commit is the reference's format (full
    leaves; its own manager restores it, equal to the gathered state); the
    step on the (1, 2) mesh from it equals the port's one-device step."""
    from repro.checkpoint.manager import CheckpointManager as RefManager
    inp, port, _ = runs
    _, lazy, _ = RefManager(inp["commit_dir"]).restore_manifest()
    full = port[0]["state_yi-6b"]
    assert set(lazy) == set(full)
    for k, v in full.items():
        assert np.array_equal(np.asarray(lazy[k].get()), v), k
    one_m, one_state = _one_device("yi-6b", full, [inp["elastic_batch"]])
    _hold_metrics(port[0]["elastic_metrics"], one_m[0])
    got = {".params/" + k[2:]: v for k, v in port[0]["elastic_params"].items()}
    want = {k: v for k, v in one_state.items() if k.startswith(".params")}
    _hold_state(got, want, "yi-6b", one_m[0]["lr"])


def test_elastic_train_reshard_matches_reference(runs):
    """After the shrink to (1, 2) the commit resharded under ``train`` (the
    reference's default preset: embed over 'data', heads, kv, mlp, vocab
    over 'model') equals the reference's shards at the same coordinate."""
    _, port, ref = runs
    for r in port[:2]:
        want = ref["reshard_train"][r["coord"]]
        assert set(r["reshard_train"]) == set(want)
        for k, v in want.items():
            assert np.array_equal(r["reshard_train"][k], v), k


def test_elastic_train_step_matches_reference(runs):
    """``relower_for_mesh`` defaults to ``train``: its step on the shrunk
    (1, 2) mesh from the 2 x 2 mesh's commit is held to the reference's
    sharded step under ``train`` on the same mesh, at the bf16 bounds."""
    inp, port, ref = runs
    assert port[0]["elastic_train_metrics"] == port[1]["elastic_train_metrics"]
    _hold_metrics(port[0]["elastic_train_metrics"], ref["elastic_train_metrics"])
    _hold_state(port[0]["elastic_train_state"], ref["elastic_train_state"], "yi-6b",
                ref["elastic_train_metrics"]["lr"])
