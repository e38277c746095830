"""Port parity: the training forward and its gradient
(``repro_torch.models.transformer.forward_train`` / ``loss_fn`` through
``repro_torch.train.steps.loss_and_grads``) against
``jax.value_and_grad(loss_fn)`` of the reference, on the same seeded inputs
and the same f32 weights, for every architecture.
``tests/test_torch_optim.py`` holds AdamW, the schedule, whole train steps
and the state's interop.

Tolerances: in float32 the loss, ``ce``, ``aux`` and every gradient leaf are
held within rtol 1e-4 / atol 1e-5 (summation order only). In bfloat16 the
loss, ``ce`` and ``aux`` are held within 2^-8 relative, and each gradient
leaf within ``GRAD_K`` x 2^-8 of its reference leaf's largest magnitude.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.manager import _flatten as ref_flatten
from repro.configs import ARCH_IDS
from repro.configs import get_config as ref_config
from repro.models.transformer import loss_fn as ref_loss_fn
from repro.train.steps import train_state_init as ref_train_state_init
from repro_torch.checkpoint.manager import flatten
from repro_torch.models import init_params
from repro_torch.models.transformer import ModelConfig, forward_train
from repro_torch.optim import adamw as TA
from repro_torch.train import steps as TS

F32 = dict(rtol=1e-4, atol=1e-5)
#: bfloat16's unit roundoff
BF16_EPS = 2.0 ** -8
#: a bf16 gradient leaf within GRAD_K * BF16_EPS of its reference leaf's
#: largest magnitude. The port's largest reading is 3.86 (yi-6b's norm2
#: scale). A cast that truncates instead of rounding reads 7.6 (yi-6b) and
#: 73 (mixtral-8x7b), the port in f32 reads 47 (mixtral-8x7b), and an
#: all-zero gradient reads 256.
GRAD_K = 6.0
_ref_grad = jax.jit(jax.value_and_grad(ref_loss_fn, has_aux=True), static_argnums=1)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's CPU work here is small ops; with torch's default thread
    pool beside the other test workers' busy cores it spends its time in
    thread hand-offs, so this module runs torch on one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def setup(arch, dtype="float32", seq=64, seed=1):
    """(reference config, port config, reference state, port state, batch as
    numpy): the reduced ``arch`` in ``dtype`` at step 0 over the same f32
    weights (the port's seed-0 initialisation, which draws the reference's
    distributions, carried across as numpy), batch 2 of ``seq`` tokens (vlm:
    plus its 16 patches; audio: ``seq`` frame embeddings) with 3 masked
    labels. The reference's leaves are copies: a port step updates the
    masters in place, and the reference's dispatch may still be reading
    them."""
    rc = dataclasses.replace(ref_config(arch, reduced=True), dtype=dtype)
    pc = ModelConfig(**dataclasses.asdict(rc))
    masters = TS.master_params(init_params(dataclasses.replace(pc, dtype="float32"), 0, "cpu"))
    ref_state = ref_train_state_init(TA.map_tree(lambda t: jnp.array(t.numpy()), masters))
    port_state = TS.train_state_init(masters)
    rng = np.random.default_rng(seed)
    batch = {}
    if rc.family == "audio":
        batch["frame_embeds"] = rng.normal(0, 1, (2, seq, rc.d_model)).astype(np.float32)
    else:
        batch["tokens"] = rng.integers(1, rc.vocab_size, (2, seq)).astype(np.int32)
    if rc.family == "vlm":
        batch["patch_embeds"] = rng.normal(0, 1, (2, rc.num_patches, rc.d_model)
                                           ).astype(np.float32)
    batch["labels"] = rng.integers(0, rc.vocab_size, (2, seq)).astype(np.int32)
    batch["labels"][0, :3] = -1
    return rc, pc, ref_state, port_state, batch


def jnp_batch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def torch_batch(batch):
    return {k: torch.as_tensor(v) for k, v in batch.items()}


def hold_grads(port_grads, ref_grads, tol=None):
    """Every gradient leaf within ``tol``; without it, within ``GRAD_K``
    bf16 roundoffs of the reference leaf's largest magnitude."""
    got, want = flatten(port_grads), ref_flatten(ref_grads)[0]
    assert set(got) == set(want)
    for key, g in want.items():
        assert got[key].dtype == torch.float32
        g = np.asarray(g, np.float32)
        if tol is not None:
            np.testing.assert_allclose(got[key].numpy(), g, err_msg=key, **tol)
            continue
        err, bound = np.abs(got[key].numpy() - g).max(), GRAD_K * BF16_EPS * np.abs(g).max()
        assert err <= bound, f"{key}: {err} above {bound}"


# ---------------------------------------------------------------------------
# the loss and its gradient
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCH_IDS)
def test_loss_and_grads_match_reference(arch):
    """Every architecture in f32: loss, ce, aux and every gradient leaf of
    the reference's tree (blocks stacked by the checkpoint's keys)."""
    rc, pc, ref_state, st, batch = setup(arch)
    (loss, (ce, aux)), grads = _ref_grad(ref_state.params, rc, jnp_batch(batch))
    p_loss, (p_ce, p_aux), p_grads = TS.loss_and_grads(pc, st.params, torch_batch(batch))
    for got, want in ((p_loss, loss), (p_ce, ce), (p_aux, aux)):
        np.testing.assert_allclose(float(got), float(want), **F32)
    if "moe" in rc.pattern:
        assert float(p_aux) > 0
    hold_grads(p_grads, grads, F32)


@pytest.mark.parametrize("arch", ["yi-6b", "mixtral-8x7b"])
def test_loss_and_grads_bf16(arch):
    """bf16 working weights rounded from the f32 masters, as the
    reference's cast at every use: the loss, ce and aux within one bf16
    roundoff, every gradient leaf within ``GRAD_K`` roundoffs of its
    reference leaf's largest magnitude."""
    rc, pc, ref_state, st, batch = setup(arch, "bfloat16")
    (loss, (ce, aux)), grads = _ref_grad(ref_state.params, rc, jnp_batch(batch))
    p_loss, (p_ce, p_aux), p_grads = TS.loss_and_grads(pc, st.params, torch_batch(batch))
    for got, want in ((p_loss, loss), (p_ce, ce), (p_aux, aux)):
        np.testing.assert_allclose(float(got), float(want), rtol=BF16_EPS, atol=0)
    hold_grads(p_grads, grads)


def test_remat_changes_memory_not_values():
    """``remat`` checkpoints each stacked block; the loss and gradients are
    the same bits as without it."""
    rc, pc, _, st, batch = setup("recurrentgemma-9b")
    out = [TS.loss_and_grads(dataclasses.replace(pc, remat=remat), st.params,
                             torch_batch(batch)) for remat in ("none", "dots", "full")]
    for loss, _, grads in out[1:]:
        assert float(loss) == float(out[0][0])
        for key, g in flatten(grads).items():
            assert torch.equal(g, flatten(out[0][2])[key]), key


def test_vlm_loss_uses_the_text_suffix():
    """The vlm logits cover patches + tokens; the loss reads only the text
    positions' suffix."""
    rc, pc, _, st, batch = setup("llava-next-mistral-7b")
    b = TS.bind(pc, st.params)
    logits, _ = forward_train(b.model, pc, torch_batch(batch))
    assert logits.shape == (2, pc.num_patches + 64, pc.vocab_size)
    assert logits.dtype == torch.float32
