"""Port parity: AdamW and its schedule (``repro_torch.optim``), whole train
steps (``repro_torch.train.steps.make_train_step``), the training state's
interop and serving's gradients-off, against the reference on the same
seeded inputs (``tests/test_torch_train.py``'s ``setup``).

Tolerances: AdamW and a whole f32 train step within 1e-5; bf16 train steps
at the bounds of ``BF16_STEP_K``'s comment; the schedule's learning rate
within 2e-7 relative (XLA's and torch's f32 cosine); a state carried across
and back bit for bit.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.manager import _flatten as ref_flatten
from repro.configs import get_config as ref_config
from repro.optim import adamw as RA
from repro.optim.schedule import cosine_warmup as ref_cosine_warmup
from repro.train.steps import make_train_step as ref_make_train_step
from repro_torch import interop
from repro_torch.checkpoint import CheckpointManager
from repro_torch.models import decode_state_init, forward_prefill, init_params, serve_step
from repro_torch.models.transformer import ModelConfig, forward_train
from repro_torch.optim import adamw as TA
from repro_torch.optim.schedule import cosine_warmup
from repro_torch.train import steps as TS
from tests.test_torch_train import BF16_EPS, jnp_batch, setup, torch_batch


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's CPU work here is small ops; with torch's default thread
    pool beside the other test workers' busy cores it spends its time in
    thread hand-offs, so this module runs torch on one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_adamw_update_matches_reference():
    """Three steps of ``adamw.update`` on a tree with a clipped and an
    unclipped step: params, m, v, count and grad_norm."""
    rng = np.random.default_rng(3)
    shapes = {"a": (8, 16), "b": {"c": (32,), "d": (4, 4, 4)}}
    tree = jax.tree.map(lambda s: rng.normal(0, 1, s).astype(np.float32), shapes,
                        is_leaf=lambda x: isinstance(x, tuple))
    cfg = RA.AdamWConfig()
    ref_p, ref_s = tree, RA.init(tree)
    p = TA.map_tree(lambda a: torch.from_numpy(a.copy()), tree)
    s = TA.init(p)
    for i, (g_scale, lr) in enumerate(((0.01, 1e-3), (5.0, 3e-3), (0.1, 2e-4))):
        g = jax.tree.map(lambda s: (g_scale * rng.normal(0, 1, s)).astype(np.float32), shapes,
                         is_leaf=lambda x: isinstance(x, tuple))
        ref_p, ref_s, ref_m = RA.update(cfg, g, ref_s, ref_p, jnp.float32(lr))
        p, s, m = TA.update(cfg, TA.map_tree(torch.from_numpy, g), s, p,
                            torch.tensor(lr, dtype=torch.float32))
        np.testing.assert_allclose(float(m["grad_norm"]), float(ref_m["grad_norm"]), rtol=1e-6)
        assert int(s.count) == int(ref_s.count) == i + 1
        for got, want in ((p, ref_p), (s.m, ref_s.m), (s.v, ref_s.v)):
            for a, b in zip(TA.leaves(got), jax.tree.leaves(want)):
                np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-5)


def test_adamw_descends_quadratic():
    """Twin of ``test_substrate.test_adamw_descends_quadratic``."""
    p = {"w": torch.tensor([3.0, -2.0])}
    st = TA.init(p)
    cfg = TA.AdamWConfig(weight_decay=0.0)
    for _ in range(200):
        g = TA.map_tree(lambda w: 2 * w, p)
        p, st, _ = TA.update(cfg, g, st, p, lr=0.05)
    assert float(p["w"].abs().max()) < 0.1


@pytest.mark.parametrize("step", [0, 1, 50, 100, 101, 5050, 9999, 10_000, 12_000])
def test_cosine_warmup_matches_reference(step):
    """Steps 0, in the warmup, at it, mid-decay, at and past the total: the
    same f32 learning rate."""
    want = np.float32(ref_cosine_warmup(jnp.asarray(step, jnp.int32), peak_lr=3e-4))
    got = cosine_warmup(torch.tensor(step, dtype=torch.int32), peak_lr=3e-4)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-7, atol=0)


# ---------------------------------------------------------------------------
# whole steps
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["yi-6b"])
def test_train_step_matches_reference(arch):
    """Two ``make_train_step`` steps from the same state (the first at
    lr 0): metrics, then params, m, v within 1e-5, count and step exact."""
    rc, pc, ref_state, st, batch = setup(arch)
    ref_step = jax.jit(ref_make_train_step(rc))
    step = TS.make_train_step(pc)
    for i in range(2):
        b = dict(batch, labels=np.roll(batch["labels"], i, axis=1))
        ref_state, ref_m = ref_step(ref_state, jnp_batch(b))
        st, m = step(st, torch_batch(b))
        for k in ("loss", "ce", "aux", "lr", "grad_norm"):
            np.testing.assert_allclose(float(m[k]), float(ref_m[k]), rtol=1e-5, atol=1e-6,
                                       err_msg=k)
    got = interop.train_state_to_numpy(st)
    want = {k: np.asarray(v) for k, v in ref_flatten(ref_state)[0].items()}
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k].dtype == v.dtype and got[k].shape == v.shape, k
        np.testing.assert_allclose(got[k], v, rtol=1e-5, atol=1e-5, err_msg=k)
    assert int(st.step) == 2 and int(st.opt.count) == 2


#: bf16 train steps against the reference's, bounds from the port's readings
#: on the reduced configs. The loss, ce and aux within one bf16 roundoff
#: (stale working weights read 3.1-7.1 roundoffs at the second step). The
#: grad norm within 2^-11 relative (the port reads at most 0.058 x 2^-8, the
#: port in f32 0.16-0.22 x 2^-8, a truncating cast 0.78-0.95 x 2^-8). Each
#: ``m`` and ``v`` leaf within k roundoffs of its reference leaf's largest
#: magnitude, (k_m, k_v) by arch: yi-6b reads 3.6 and 5.3, mixtral-8x7b 25
#: and 21 (its router flips near-tied top-2 choices); stale working weights
#: read 44-88 and 59-85. The masters within 2.1 x the steps' summed learning
#: rates: by Cauchy-Schwarz Adam's step at count <= 2 (b1 0.9, b2 0.95) moves
#: an element by at most its lr, so gradients of opposite signs part the two
#: by at most 2 lr a step (the readings reach 1.99), plus the decay's lr·wd·p.
BF16_STEP_K = {"yi-6b": (8.0, 12.0), "mixtral-8x7b": (40.0, 40.0)}


@pytest.mark.parametrize("restore", [False, True], ids=["two-steps", "across-a-restore"])
@pytest.mark.parametrize("arch", ["yi-6b", "mixtral-8x7b"])
def test_train_step_bf16_matches_reference(arch, restore, tmp_path):
    """Two bf16 ``make_train_step`` steps at the schedule's peak (both
    states' step set to 100) against the reference's: masters, m, v and the
    metrics at ``BF16_STEP_K``'s bounds; count and step exact. Working
    weights left stale after an AdamW update would show at the second step.
    With ``restore`` the port commits after the first step, takes a third
    batch, restores the commit in place and then takes the second: working
    weights left stale by an in-place restore would show."""
    rc, pc, ref_state, st, batch = setup(arch, "bfloat16")
    ref_state = ref_state._replace(step=jnp.int32(100))
    st.step.fill_(100)
    batches = [dict(batch, labels=np.roll(batch["labels"], i, axis=1)) for i in range(3)]
    ref_step = jax.jit(ref_make_train_step(rc))
    step = TS.make_train_step(pc)
    lr_sum = 0.0
    for i in range(2):
        ref_state, ref_m = ref_step(ref_state, jnp_batch(batches[i]))
        st, m = step(st, torch_batch(batches[i]))
        for k in ("loss", "ce", "aux"):
            np.testing.assert_allclose(float(m[k]), float(ref_m[k]), rtol=BF16_EPS, atol=0,
                                       err_msg=k)
        np.testing.assert_allclose(float(m["grad_norm"]), float(ref_m["grad_norm"]),
                                   rtol=2.0 ** -11, atol=0)
        assert float(m["lr"]) == float(ref_m["lr"])
        lr_sum += float(ref_m["lr"])
        if restore and i == 0:
            mgr = CheckpointManager(str(tmp_path))
            mgr.save(1, st)
            st, _ = step(st, torch_batch(batches[2]))
            _, lazy, _ = mgr.restore_manifest()
            st = mgr.restore_tree(st, lazy)
    got = interop.train_state_to_numpy(st)
    want = {k: np.asarray(v) for k, v in ref_flatten(ref_state)[0].items()}
    assert set(got) == set(want)
    k_m, k_v = BF16_STEP_K[arch]
    for key, w in want.items():
        a = got[key]
        assert a.dtype == w.dtype and a.shape == w.shape, key
        if key.startswith(".params"):
            bound = 2.1 * lr_sum
        elif key.startswith((".opt/.m", ".opt/.v")):
            bound = (k_m if key.startswith(".opt/.m") else k_v) * BF16_EPS * np.abs(w).max()
        else:
            assert np.array_equal(a, w), key
            continue
        err = float(np.abs(a - w).max())
        assert err <= bound, f"{key}: {err} above {bound}"
    assert int(st.step) == 102 and int(st.opt.count) == 2


def test_train_state_interop_round_trip():
    """A reference state (random moments, count and step) crosses by
    ``train_state_from_jax`` and comes back by ``train_state_to_numpy`` by
    the checkpoint's keys, bit for bit; a key or shape off is refused."""
    rc, pc, ref_state, _, _ = setup("recurrentgemma-9b")
    rng = np.random.default_rng(4)

    def noise(a):
        return jnp.asarray(rng.normal(0, 1, a.shape).astype(np.float32))
    ref_state = ref_state._replace(
        opt=RA.AdamWState(jax.tree.map(noise, ref_state.opt.m),
                          jax.tree.map(noise, ref_state.opt.v), jnp.int32(7)),
        step=jnp.int32(7))
    st = interop.train_state_from_jax(pc, jax.tree.map(np.asarray, ref_state), "cpu")
    want = {k: np.asarray(v) for k, v in ref_flatten(ref_state)[0].items()}
    got = interop.train_state_to_numpy(st)
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), k
    assert list(interop.train_state_to_numpy(
        interop.train_state_from_jax(pc, got, "cpu"))) == list(want)
    bad = dict(got)
    bad.pop(".step")
    with pytest.raises(ValueError, match="missing"):
        interop.train_state_from_jax(pc, bad, "cpu")
    bad = dict(got, **{".opt/.count": np.zeros((1,), np.int32)})
    with pytest.raises(ValueError, match="count"):
        interop.train_state_from_jax(pc, bad, "cpu")


def test_serving_holds_no_gradients():
    """A served model keeps ``requires_grad`` off and builds no graph; the
    working model of a train step has it on, over the f32 masters."""
    cfg = dataclasses.replace(ref_config("yi-6b", reduced=True), dtype="float32")
    pc = ModelConfig(**dataclasses.asdict(cfg))
    model = init_params(pc, seed=0, device="cpu")
    assert not any(p.requires_grad for p in model.parameters())
    logits, _ = forward_prefill(model, pc, {"tokens": torch.ones((1, 8), dtype=torch.int32)},
                                16)
    assert logits.grad_fn is None
    b = TS.bind(pc, TS.master_params(model))
    assert all(p.requires_grad for p in b.model.parameters())
    assert all(p.data_ptr() == m.data_ptr() for p, m in zip(b.params, b.masters))
    logits, _ = forward_prefill(b.model, pc, {"tokens": torch.ones((1, 8), dtype=torch.int32)},
                                16)
    assert logits.grad_fn is None


def test_prefill_and_serve_steps():
    """``make_prefill_step`` is ``forward_train``'s logits with no graph
    (whose parity with the reference ``tests/test_torch_train.py`` holds);
    ``make_serve_step`` is ``serve_step``."""
    _, pc, _, st, batch = setup("yi-6b")
    b = TS.bind(pc, st.params)
    toks = torch_batch({"tokens": batch["tokens"]})
    got = TS.make_prefill_step(pc)(b.model, toks)
    assert got.grad_fn is None and got.dtype == torch.float32
    assert torch.equal(got, forward_train(b.model, pc, toks)[0].detach())
    step = TS.make_serve_step(pc)
    s1, s2 = (decode_state_init(pc, 2, 16, "cpu") for _ in range(2))
    tok = {"token": torch.tensor([3, 5], dtype=torch.int32)}
    a, s1 = step(b.model, s1, tok)
    c, s2 = serve_step(b.model, pc, s2, tok)
    assert torch.equal(a, c) and torch.equal(s1["pos"], s2["pos"])
