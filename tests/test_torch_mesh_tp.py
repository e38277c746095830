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

Serving (``decode``, ``decode_b1``): the reference's subprocess first runs
each case's one-device prefill (``serve_prefill.pkl``, which the ranks and
this module wait for), later the reference's serve step jitted with the dry
run's shardings; each rank's logits block a step within ``LOGITS_K`` (or
``SERVE_LOGITS_K``) roundoffs and its state piece within ``STATE_K`` of
both it and the port's one-device serve step.
The ``slow`` sweep runs every other (arch, preset) pair, and every arch
under both serving presets.
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
from repro_torch.train import steps as TS
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
#: 8.9 in f32); the serving cases' logits a step too
LOGITS_K = {"bfloat16": 4.0, "float32": 64.0}
#: (arch, preset, dtype) of the serve steps held here: 4 lanes (2 a data
#: rank) under decode, 1 under decode_b1; mixtral in f32, where no
#: near-tied top-2 route flips
SERVES = (("yi-6b", "decode", "bfloat16"), ("yi-6b", "decode_b1", "bfloat16"),
          ("h2o-danube-3-4b", "decode", "bfloat16"), ("recurrentgemma-9b", "decode", "bfloat16"),
          ("rwkv6-7b", "decode", "bfloat16"), ("mixtral-8x7b", "decode", "float32"))
#: a serving case's config overrides: h2o-danube-3-4b's SWA ring cut to 32
#: slots, so that the steps from position 30 wrap it (its reduced window,
#: 64, equals the cache)
SERVE_OVER = {"h2o-danube-3-4b": {"sliding_window": 32}}
#: the cache length, the one-device prefill's prompt and the decode steps
#: after it: from position 30 the writes cross from the first 'model'
#: rank's piece of a 64-slot ring to the second's
CACHE_LEN, PROMPT, SERVE_STEPS = 64, 30, 4
#: the decode products' chunk (``models/layers.py`` ``DECODE_CHUNK``) in the
#: serving cases, mesh and one-device alike: a 32-slot piece reads chunks of
#: 12, 12 and 8 slots, a 16-slot SWA piece 12 and 4, the one-device 64-slot
#: ring six chunks, so that the joined scores and the summed products
#: across chunks are held as well as a single chunk's
DECODE_CHUNK = 12
#: a serving case's logits a step within ``LOGITS_K`` roundoffs, but for
#: the recurrent archs, whose bf16 noise is larger: recurrentgemma-9b reads
#: 3.78, rwkv6-7b 4.87 (the reference's own sharded step reads 2.80 / 4.29
#: against its one-device step, and the two packages' one-device steps
#: 3.33 / 5.51 against each other; ``python tests/test_torch_mesh_tp.py
#: serve reference`` prints them)
SERVE_LOGITS_K = {"recurrentgemma-9b": 6.0, "rwkv6-7b": 8.0}
#: the final state pieces within this many roundoffs of the model's dtype
#: of each leaf's largest magnitude, against both the reference's sharded
#: step and the port's one-device step (readings: at most 3.86 in bf16,
#: rwkv6-7b's; 8.24 in f32, mixtral-8x7b's)
STATE_K = {"bfloat16": 8.0, "float32": 32.0}

REFERENCE = textwrap.dedent("""
    import dataclasses, pickle, sys
    from pathlib import Path
    import numpy as np
    import jax, jax.numpy as jnp
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
    from repro.checkpoint.manager import _flatten
    from repro.configs import get_config
    from repro.models import param_specs
    from repro.models.transformer import decode_state_specs, forward_prefill
    from repro.optim import adamw
    from repro.parallel import sharding
    from repro.train.steps import (TrainState, make_prefill_step, make_serve_step,
                                   make_train_step)

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

    def to_np(st):
        return jax.tree.map(lambda a: np.asarray(a, np.float32) if a.dtype == jnp.bfloat16
                            else np.asarray(a), st)

    # the serving cases' one-device prefill first: the port's ranks wait for it
    prefilled, states = {}, {}
    for arch, preset, dtype in inp["serves"]:
        key = f"{arch}_{preset}_{dtype}"
        cfg = dataclasses.replace(config(arch), dtype=dtype, **inp["serve_over"].get(arch, {}))
        params = tree(inp[f"{arch}_state"], ".params", param_specs(cfg))
        prompt = {k: jnp.asarray(v) for k, v in inp[f"serve_{key}"]["prompt"].items()}
        _, st = jax.jit(lambda p, b: forward_prefill(p, cfg, b, inp["cache_len"]))(params, prompt)
        states[key] = (cfg, params, st)
        prefilled[key] = to_np(st)
    (d / "serve_prefill.tmp").write_bytes(pickle.dumps(prefilled))
    (d / "serve_prefill.tmp").rename(d / "serve_prefill.pkl")

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

    # the serve step jitted with the dry run's shardings (dryrun.py:185-204)
    for arch, preset, dtype in inp["serves"]:
        key = f"{arch}_{preset}_{dtype}"
        cfg, params, st = states[key]
        steps = inp[f"serve_{key}"]["steps"]
        B = st["pos"].shape[0]
        with sharding.use(mesh, preset):
            p_sh = sharding.tree_shardings(param_specs(cfg), mesh, shape_tree=params)
            s_sh = sharding.tree_shardings(decode_state_specs(cfg), mesh, shape_tree=st)
            l_sh = NamedSharding(mesh, sharding.spec_for(("batch", "vocab"),
                                                         dims=(B, cfg.vocab_size)))
            step = jax.jit(make_serve_step(cfg), in_shardings=(p_sh, s_sh, batch_sh(steps[0])),
                           out_shardings=(l_sh, s_sh))
            st = jax.device_put(st, s_sh)
            logits = []
            for x in steps:
                lg, st = step(params, st, {k: jnp.asarray(v) for k, v in x.items()})
                logits.append(np.asarray(lg))
        out[f"serve_{key}"] = (logits, to_np(st), tuple(l_sh.spec))
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


def _serve_inputs(rng, cfg, preset):
    """A serving case's prompt (``PROMPT`` tokens a lane; a vlm's patch
    embeddings beside them, an audio model's frame embeddings in their
    place) and ``SERVE_STEPS`` decode inputs (a token a lane, or a (B, 1,
    d) frame embedding)."""
    B = 1 if preset == "decode_b1" else 4
    if cfg.family == "audio":
        prompt = {"frame_embeds": rng.normal(0, 1, (B, PROMPT, cfg.d_model)).astype(np.float32)}
        steps = [{"frame_embeds": rng.normal(0, 1, (B, 1, cfg.d_model)).astype(np.float32)}
                 for _ in range(SERVE_STEPS)]
        return {"prompt": prompt, "steps": steps}
    prompt = {"tokens": rng.integers(1, cfg.vocab_size, (B, PROMPT)).astype(np.int32)}
    if cfg.family == "vlm":
        prompt["patch_embeds"] = rng.normal(0, 1, (B, cfg.num_patches, cfg.d_model)).astype(
            np.float32)
    steps = [{"token": rng.integers(1, cfg.vocab_size, (B,)).astype(np.int32)}
             for _ in range(SERVE_STEPS)]
    return {"prompt": prompt, "steps": steps}


def _one_device_serve(inp, arch, preset, dtype):
    """The port's one-device serve steps from the reference's prefill
    state: (logits a step, the final state as numpy)."""
    from repro_torch import interop
    from repro_torch.models import serve_step
    from tests.torch_mesh_tp_ranks import decode_chunk, serve_config
    key = f"{arch}_{preset}_{dtype}"
    cfg = serve_config(inp, arch, dtype)
    masters = interop.train_state_from_jax(cfg, inp[f"{arch}_state"], "cpu").params
    model = interop.model_params_from_jax(cfg, TS.adamw.map_tree(lambda t: t.numpy(), masters),
                                          "cpu")
    state = interop.decode_state_from_numpy(cfg, inp["prefilled"][key], "cpu")
    logits = []
    with decode_chunk(inp["decode_chunk"]):
        for x in inp[f"serve_{key}"]["steps"]:
            lg, state = serve_step(model, cfg, state,
                                   {k: torch.from_numpy(v) for k, v in x.items()})
            logits.append(lg.numpy().copy())
    return logits, interop.decode_state_to_numpy(state)


def _run(d, cases, prefills, serves=(), steps=2, train_under=(), bytes_lengths=()):
    """The seeded inputs, then the 4 port ranks beside the reference's
    subprocess, and the port's one-device steps meanwhile: (inputs, port
    results by rank, reference results, one-device results by arch and by
    serving case)."""
    from tests.torch_mesh_tp_ranks import serve_config, wait_prefill
    rng = np.random.default_rng(11)
    inp = {"cases": cases, "prefills": prefills, "serves": serves, "train_under": train_under,
           "bytes_lengths": bytes_lengths, "serve_over": SERVE_OVER, "cache_len": CACHE_LEN,
           "decode_chunk": DECODE_CHUNK, "commit_dir": str(d / "commit"), "serve_dir": str(d)}
    for arch in sorted({c[0] for c in cases + prefills + train_under}):
        inp[f"{arch}_state"] = _state(arch)
        inp[f"{arch}_batches"] = [_batch(rng, get_config(arch, reduced=True))
                                  for _ in range(steps)]
    for arch in sorted({c[0] for c in serves} | ({"yi-6b"} if bytes_lengths else set())):
        if f"{arch}_state" not in inp:
            inp[f"{arch}_state"] = _state(arch)
    for arch, preset, dtype in serves:
        inp[f"serve_{arch}_{preset}_{dtype}"] = _serve_inputs(
            rng, serve_config(inp, arch, dtype), preset)
    (d / "inputs.pkl").write_bytes(pickle.dumps(inp))
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "JAX_PLATFORMS": "cpu",
           "OMP_NUM_THREADS": "1", "XLA_FLAGS": "--xla_force_host_platform_device_count=4"}
    ref = subprocess.Popen([sys.executable, "-c", REFERENCE, str(d)], env=env, cwd=ROOT,
                           stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    wait = launch(4, d, d, script=RANKS)
    try:
        one = {a: _one_device(a, inp[f"{a}_state"], inp[f"{a}_batches"])
               for a in sorted({a for a, _ in cases})}
        if serves:
            inp["prefilled"] = wait_prefill(d, lambda: ref.poll() is None)
        for case in serves:
            one["serve_{}_{}_{}".format(*case)] = _one_device_serve(inp, *case)
        port = wait()
    finally:
        log, _ = ref.communicate(timeout=900)
    assert ref.returncode == 0, log[-4000:]
    return inp, port, pickle.loads((d / "ref.pkl").read_bytes()), one


#: the train steps run under a serving preset, held to ``train_tp_nosp``'s
TRAIN_UNDER = (("yi-6b", "decode"),)
#: the cache lengths a decode step's collective bytes are compared at
BYTES_LENGTHS = (64, 128)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return _run(tmp_path_factory.mktemp("mesh_tp"), CASES, PREFILLS, SERVES,
                train_under=TRAIN_UNDER, bytes_lengths=BYTES_LENGTHS)


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


def _serve_errors(runs, arch, preset, dtype):
    """Each rank's logits blocks and final state piece of a serving case
    against the reference's sharded step and the port's one-device step:
    {"ref" / "one": (logits, state) in roundoffs of the model's dtype of
    the largest magnitude (each step's logits; each state leaf)}. Asserts
    each block's shape and place (the reference's ``("batch", "vocab")``
    spec) and ``pos`` exact."""
    import types

    from repro_torch.models.transformer import decode_state_specs
    from repro_torch.parallel import sharding
    from tests.torch_mesh_tp_ranks import serve_config
    inp, port, ref, one = runs
    key = f"{arch}_{preset}_{dtype}"
    want_logits, want_state, lspec = ref[f"serve_{key}"]
    assert lspec == (("data", "model") if preset == "decode" else (None, "model"))
    cfg = serve_config(inp, arch, dtype)
    eps = BF16_EPS if dtype == "bfloat16" else 2.0 ** -24
    mesh = types.SimpleNamespace(mesh_dim_names=("data", "model"), shape=(2, 2))
    specs = sharding.tree_specs(decode_state_specs(cfg), sharding.presets()[preset], mesh,
                                want_state)
    errs = {"ref": [0.0, 0.0], "one": [0.0, 0.0]}
    for r in port:
        got_logits, got_state = r[f"serve_{key}"]
        coord = dict(zip(("data", "model"), r["coord"]))
        lpl = sharding.placement(lspec, want_logits[0].shape, mesh, coord)
        for name, (w_logits, w_state) in (("ref", (want_logits, want_state)),
                                          ("one", one[f"serve_{key}"])):
            for g, w in zip(got_logits, w_logits, strict=True):
                w = lpl.take(torch.from_numpy(w)).numpy()
                assert g.shape == w.shape
                errs[name][0] = max(errs[name][0], float(np.abs(g - w).max())
                                    / (eps * float(np.abs(w).max())))
            for path, spec in TS.layout_leaves(specs):
                full = TS._at(w_state, path)
                w = sharding.placement(spec, full.shape, mesh, coord).take(
                    torch.from_numpy(full)).numpy()
                g = TS._at(got_state, path)
                assert g.shape == w.shape and g.dtype == w.dtype, path
                if path == ("pos",):
                    assert np.array_equal(g, w)
                    continue
                errs[name][1] = max(errs[name][1], float(np.abs(g - w).max())
                                    / (eps * max(float(np.abs(w).max()), 1e-30)))
    return errs


@pytest.mark.parametrize("arch,preset,dtype", SERVES, ids=[f"{a}-{p}" for a, p, _ in SERVES])
def test_mesh_serve_matches_reference(runs, arch, preset, dtype):
    """``SERVE_STEPS`` decode steps on the 2 x 2 mesh after the reference's
    one-device prefill of ``PROMPT`` tokens (a ``CACHE_LEN``-slot cache):
    each rank's logits block a step within ``LOGITS_K`` roundoffs
    (``SERVE_LOGITS_K`` for the recurrent archs), and its
    final state piece (cache pieces with the written slots, ``h`` /
    ``conv``, ``wkv``, the shifts) within ``STATE_K`` roundoffs, of both
    the reference's jitted sharded step and the port's one-device step;
    ``pos`` exact."""
    errs = _serve_errors(runs, arch, preset, dtype)
    for name, (k_logits, k_state) in errs.items():
        assert k_logits <= SERVE_LOGITS_K.get(arch, LOGITS_K[dtype]), (name, k_logits)
        assert k_state <= STATE_K[dtype], (name, k_state)


def test_mesh_serve_gathers_no_cache(runs):
    """yi-6b under ``decode`` at cache lengths 64 and 128: each rank's cache
    piece is half the ring long, and the bytes a step hands each collective
    are the same at both lengths (no cache, or f32 copy of it, is moved);
    the serving weights a rank slices from the whole model equal those it
    gathers from its master shards."""
    _, port, _, _ = runs
    a, b = BYTES_LENGTHS
    for r in port:
        (steps_a, shape_a), (steps_b, shape_b) = r[f"bytes_{a}"], r[f"bytes_{b}"]
        assert shape_a[3] == a // 2 and shape_b[3] == b // 2
        assert steps_a == steps_b
        assert all(s["all_reduce"] > 0 and s["all_gather"] > 0 for s in steps_a)
        assert r["serve_weights_equal"]


def test_only_serving_presets_refused(runs):
    """Every preset runs on a mesh: a train step and a prefill under each
    (yi-6b's steps under ``decode`` equal its ``train_tp_nosp`` steps: the
    cache rule has nothing to place); a serve step under the serving
    presets only, the others refused, naming themselves."""
    from repro_torch.parallel import sharding
    assert set(sharding.SERVE_PRESETS) == {"decode", "decode_b1"}
    _, port, _, _ = runs
    for arch, preset in TRAIN_UNDER:
        for r in port:
            assert r[f"train_{arch}_{preset}"] == r[f"train_{arch}_train_tp_nosp"]
    mesh = type("Mesh", (), {"mesh_dim_names": ("data", "model"), "shape": (2, 2)})()
    for preset in set(sharding.presets()) - set(sharding.SERVE_PRESETS):
        with pytest.raises(ValueError, match=f"preset '{preset}' does not serve"):
            TS.make_mesh_serve_step(get_config("yi-6b", reduced=True), mesh, preset)


_FAMILIES = {"dense": "yi-6b", "swa": "h2o-danube-3-4b", "vlm": "llava-next-mistral-7b",
             "audio": "musicgen-large", "moe": "mixtral-8x7b", "hybrid": "recurrentgemma-9b",
             "ssm": "rwkv6-7b"}
SWEEP = tuple((a, p) for a in _FAMILIES.values() for p in TP_PRESETS
              if (a, p) not in CASES) + tuple(
    (a, p) for a in ("mixtral-8x7b", "phi3.5-moe-42b-a6.6b") for p in MOE_PRESETS
    if (a, p) not in CASES)


#: every other (arch, serving preset, dtype): bf16, MoE archs in f32
SERVE_SWEEP = tuple((a, p, "float32" if get_config(a, reduced=True).family == "moe"
                     else "bfloat16") for a in ARCH_IDS for p in ("decode", "decode_b1")
                    if (a, p) not in {(c[0], c[1]) for c in SERVES})


@pytest.mark.slow
def test_mesh_step_sweep(tmp_path):
    """Every other family under ``train``, ``train_tp`` and
    ``train_tp_nosp`` and phi3.5 under ``train_ep`` and ``train_multi_moe``,
    and every arch under both serving presets, held as the cases above."""
    assert set(ARCH_IDS) >= {a for a, _ in SWEEP}
    runs = _run(tmp_path, SWEEP, (), SERVE_SWEEP)
    failed = []
    for arch, preset in SWEEP:
        try:
            _hold_step(runs, arch, preset)
        except AssertionError as e:
            failed.append(f"{arch} {preset}: {e}")
    for arch, preset, dtype in SERVE_SWEEP:
        try:
            test_mesh_serve_matches_reference(runs, arch, preset, dtype)
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


def _reference_one_device_serve(inp, arch, preset, dtype):
    """The reference's jitted one-device serve steps from its own prefill
    state: (logits a step, the final state as numpy, bf16 widened)."""
    import dataclasses

    import jax
    import jax.numpy as jnp
    from repro.configs import get_config as ref_config
    from repro.models.transformer import decode_state_init, param_specs
    from repro.train.steps import make_serve_step
    key = f"{arch}_{preset}_{dtype}"
    cfg = dataclasses.replace(ref_config(arch, reduced=True), dtype=dtype,
                              **SERVE_OVER.get(arch, {}))
    flat = inp[f"{arch}_state"]

    def tree(head, spec):
        if isinstance(spec, dict):
            return {k: tree(head + "/" + k, v) for k, v in spec.items()}
        return jnp.asarray(flat[head])
    params = tree(".params", param_specs(cfg))
    pre = inp["prefilled"][key]
    like = jax.eval_shape(lambda: decode_state_init(cfg, pre["pos"].shape[0], CACHE_LEN))
    state = jax.tree.map(lambda a, t: jnp.asarray(a, t.dtype), pre, like)
    step = jax.jit(make_serve_step(cfg))
    logits = []
    for x in inp[f"serve_{key}"]["steps"]:
        lg, state = step(params, state, {k: jnp.asarray(v) for k, v in x.items()})
        logits.append(np.asarray(lg))
    return logits, jax.tree.map(lambda a: np.asarray(a, np.float32) if a.dtype == jnp.bfloat16
                                else np.asarray(a), state)


def _whole_errors(got, want, dtype):
    """(logits, state) of one whole serving run against another's, in the
    units of ``_serve_errors``."""
    eps = BF16_EPS if dtype == "bfloat16" else 2.0 ** -24
    kl = max(float(np.abs(g - w).max()) / (eps * float(np.abs(w).max()))
             for g, w in zip(got[0], want[0]))
    ks = max(float(np.abs(g - w).max()) / (eps * max(float(np.abs(w).max()), 1e-30))
             for (path, g), (_, w) in zip(TS.layout_leaves(got[1]), TS.layout_leaves(want[1]))
             if path != ("pos",))
    return kl, ks


if __name__ == "__main__":
    # PYTHONPATH=src:. JAX_PLATFORMS=cpu python tests/test_torch_mesh_tp.py [sweep] [reference]
    # [serve] prints the readings the bounds above were set from (with
    # "serve", the serving cases' in roundoffs: logits, state)
    import tempfile
    torch.set_num_threads(1)
    with tempfile.TemporaryDirectory() as tmp:
        if "serve" in sys.argv[1:]:
            serves = SERVE_SWEEP if "sweep" in sys.argv[1:] else SERVES
            runs = _run(Path(tmp), (), (), serves)
            for case in serves:
                print(case, _serve_errors(runs, *case))
                if "reference" in sys.argv[1:]:
                    ref_one = _reference_one_device_serve(runs[0], *case)
                    key = "serve_{}_{}_{}".format(*case)
                    print("  the reference's sharded step against its one-device step",
                          _whole_errors(runs[2][key][:2], ref_one, case[2]),
                          "; the port's one-device step against that",
                          _whole_errors(runs[3][key], ref_one, case[2]))
        else:
            cases = SWEEP if "sweep" in sys.argv[1:] else CASES
            print("\n".join(_readings(_run(Path(tmp), cases, ()), cases,
                                      "reference" in sys.argv[1:])))
