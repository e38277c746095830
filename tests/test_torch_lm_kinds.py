"""Port parity: the block kinds beyond ``dense`` — RG-LRU, RWKV6, MoE, the
``local`` window, tail layers and the vlm / audio stub fronts
(``repro_torch.models``) against the reference (``repro.models``) on the
same seeded inputs, the reference's weights carried in by
``interop.model_params_from_jax``.

Tolerances are ``tests/test_torch_lm.py``'s: float32 within 1e-4 (summation
order), bfloat16 within 0.0625 / 0.125; every integer exact (MoE dispatch).
Two places where the port is held to something other than the reference:

* RWKV6 at a prompt longer than one chunk and not a multiple of it: the
  reference's chunked form raises (it reshapes into whole chunks), the
  port computes the last, shorter chunk and is held to the reference's own
  token-by-token recurrence.
* mixtral in bfloat16 over whole models: the residual stream differs by
  bf16 ulps between the packages, which can move a token whose 2nd and 3rd
  router logits are nearly tied to another expert pair — a different, valid
  rounding of the same function. Those tokens are named from the port's
  own router margins and left out; every other token is held to the
  tolerance, and they must stay few. Layer by layer, on identical inputs,
  MoE dispatch is exact.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_config
from repro.models import moe as RM
from repro.models import rglru as RR
from repro.models import rwkv6 as RW
from repro_torch import interop
from repro_torch.configs import get_config
from repro_torch.models import moe as TM
from repro_torch.models import rglru as TR
from repro_torch.models import rwkv6 as TW
from repro_torch.models.transformer import (ModelConfig, Transformer, decode_state_init,
                                            forward_prefill, init_params, serve_step)
from tests.test_torch_lm import (F32, JDT, TDT, _ref_prefill, _ref_step, close, f32,
                                 ref_params)


def loaded(module, tree):
    """``module`` with the reference's leaves ``tree`` copied in (cast to
    each parameter's dtype)."""
    interop._load(module, tree, None, set())
    return module


def close_at_unit_scale(got, want, dtype, what):
    """``close`` after dividing both by the reference's RMS in bf16. The
    time mix's raw output and its wkv state run at ~20x the unit scale the
    bf16 tolerance is set for (the block hands the output to an RMSNorm), so
    a 1-ulp rounding step there is 0.125 on an element near 0; f32 is held
    unscaled."""
    if dtype == "bfloat16":
        scale = float(np.sqrt(np.mean(np.square(f32(want)))))
        got, want = f32(got) / scale, f32(want) / scale
    close(got, want, dtype, what)


def pair(arch, dtype):
    """(reference config, port config, reference params, port model)."""
    rc = dataclasses.replace(ref_config(arch, reduced=True), dtype=dtype)
    pc = ModelConfig(**dataclasses.asdict(rc))
    params = ref_params(arch)
    return rc, pc, params, interop.model_params_from_jax(
        pc, jax.tree.map(np.asarray, params), "cpu")


def model_inputs(cfg, S, seed):
    """Prefill inputs of the config's front as numpy: S tokens (vlm: the
    patches come first, S counts both; audio: S frame embeddings)."""
    rng = np.random.default_rng(seed)
    if cfg.family == "audio":
        return {"frame_embeds": rng.normal(0, 1, (2, S, cfg.d_model)).astype(np.float32)}
    n_tok = S - cfg.num_patches if cfg.family == "vlm" else S
    out = {"tokens": rng.integers(1, cfg.vocab_size, (2, n_tok)).astype(np.int32)}
    if cfg.family == "vlm":
        out["patch_embeds"] = rng.normal(0, 1, (2, cfg.num_patches, cfg.d_model)).astype(
            np.float32)
    return out


def step_inputs(cfg, rng):
    if cfg.family == "audio":
        return {"frame_embeds": rng.normal(0, 1, (2, 1, cfg.d_model)).astype(np.float32)}
    return {"token": rng.integers(0, cfg.vocab_size, 2).astype(np.int32)}


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rglru_layers(dtype):
    """``rglru_train`` with its state, then ``rglru_decode`` from a nonzero
    h0 and conv tail, on the reference's weights (lam f32)."""
    ref, _ = RR.rglru_init(jax.random.PRNGKey(7), 64, 96, 4)
    w = loaded(TR.RGLRU(64, 96, 4, TDT[dtype], "cpu"), ref)
    assert w.lam.dtype == torch.float32 and w.w_x.dtype == TDT[dtype]
    rng = np.random.default_rng(8)
    x = rng.normal(0, 1, (2, 37, 64)).astype(np.float32)
    out, (h, tail) = RR.rglru_train(ref, jnp.asarray(x, JDT[dtype]), return_state=True)
    got, (gh, gtail) = TR.rglru_train(w, torch.from_numpy(x).to(TDT[dtype]), return_state=True)
    assert gh.dtype == torch.float32 and gtail.dtype == TDT[dtype]
    close(got, out, dtype, "out")
    close(gh, h, dtype, "h")
    close(gtail, tail, dtype, "conv tail")
    x1 = rng.normal(0, 1, (2, 1, 64)).astype(np.float32)
    h0 = rng.normal(0, 1, (2, 96)).astype(np.float32)
    t0 = rng.normal(0, 1, (2, 3, 96)).astype(np.float32)
    out, h, tail = RR.rglru_decode(ref, jnp.asarray(x1, JDT[dtype]), jnp.asarray(h0),
                                   jnp.asarray(t0, JDT[dtype]))
    got, gh, gtail = TR.rglru_decode(w, torch.from_numpy(x1).to(TDT[dtype]),
                                     torch.from_numpy(h0), torch.from_numpy(t0).to(TDT[dtype]))
    close(got, out, dtype, "decode out")
    close(gh, h, dtype, "decode h")
    close(gtail, tail, dtype, "decode tail")


def test_linear_scan_long():
    """The doubling scan against a plain loop over 700 steps with decays
    as small as the block's (log a down to -3.2 a step)."""
    rng = np.random.default_rng(9)
    a = torch.from_numpy(np.exp(rng.uniform(-3.2, 0, (2, 700, 8))).astype(np.float32))
    b = torch.from_numpy(rng.normal(0, 1, (2, 700, 8)).astype(np.float32))
    h, want = torch.zeros(2, 8), []
    for t in range(700):
        h = a[:, t] * h + b[:, t]
        want.append(h)
    np.testing.assert_allclose(TR._linear_scan(a, b).numpy(), torch.stack(want, 1).numpy(),
                               **F32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rwkv6_layers(dtype):
    """Time mix over two whole chunks from a nonzero shift and wkv state (the
    reference's state after 64 earlier tokens), one decode step after it,
    and the channel mix; the f32 leaves stay f32."""
    d = 128
    ref, _ = RW.rwkv6_init(jax.random.PRNGKey(10), d, 256)
    w = loaded(TW.RWKV6(d, 256, TDT[dtype], "cpu"), ref)
    assert all(getattr(w, n).dtype == torch.float32 for n in TW.F32_LEAVES)
    rng = np.random.default_rng(11)
    x0, x = (rng.normal(0, 1, (2, S, d)).astype(np.float32) for S in (64, 128))
    last = rng.normal(0, 1, (2, 1, d)).astype(np.float32)
    s0 = np.array(RW.rwkv6_time_mix(ref, jnp.asarray(x0))[1][1])
    jx, tx = jnp.asarray(x, JDT[dtype]), torch.from_numpy(x).to(TDT[dtype])
    jl, tl = jnp.asarray(last, JDT[dtype]), torch.from_numpy(last).to(TDT[dtype])
    out, (shift, st) = RW.rwkv6_time_mix(ref, jx, jl, jnp.asarray(s0))
    got, (gshift, gst) = TW.rwkv6_time_mix(w, tx, tl, torch.from_numpy(s0))
    assert gst.dtype == torch.float32
    close_at_unit_scale(got, out, dtype, "time mix")
    close(gshift, shift, dtype, "shift")
    close_at_unit_scale(gst, st, dtype, "wkv state")
    x1 = rng.normal(0, 1, (2, 1, d)).astype(np.float32)
    out, (shift, st) = RW.rwkv6_time_mix_decode(ref, jnp.asarray(x1, JDT[dtype]), shift, st)
    got, (gshift, gst) = TW.rwkv6_time_mix_decode(w, torch.from_numpy(x1).to(TDT[dtype]),
                                                  gshift, gst)
    close_at_unit_scale(got, out, dtype, "decode")
    close_at_unit_scale(gst, st, dtype, "decode state")
    out, cm = RW.rwkv6_channel_mix(ref, jx, jl)
    got, gcm = TW.rwkv6_channel_mix(w, tx, tl)
    close(got, out, dtype, "channel mix")
    close(gcm, cm, dtype, "channel shift")


@pytest.mark.parametrize("S", [65, 96, 100, 130])
def test_rwkv6_ragged_chunk(S):
    """The repair: at S past one chunk and not a multiple of it the
    reference's chunked form raises; the port's equals the reference's
    token-by-token recurrence (f32), outputs and final state."""
    d = 128
    ref, _ = RW.rwkv6_init(jax.random.PRNGKey(12), d, 256)
    w = loaded(TW.RWKV6(d, 256, torch.float32, "cpu"), ref)
    x = np.random.default_rng(S).normal(0, 1, (2, S, d)).astype(np.float32)
    with pytest.raises(TypeError, match="reshape"):
        RW.rwkv6_time_mix(ref, jnp.asarray(x))
    got, (gshift, gst) = TW.rwkv6_time_mix(w, torch.from_numpy(x))
    step = jax.jit(RW.rwkv6_time_mix_decode)
    shift, st = jnp.zeros((2, 1, d)), jnp.zeros((2, 2, 64, 64))
    outs = []
    for t in range(S):
        out, (shift, st) = step(ref, jnp.asarray(x[:, t:t + 1]), shift, st)
        outs.append(np.asarray(out))
    np.testing.assert_allclose(got.numpy(), np.concatenate(outs, 1), **F32)
    np.testing.assert_allclose(gst.numpy(), np.asarray(st), **F32)
    np.testing.assert_array_equal(gshift.numpy(), x[:, -1:])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_dispatch_overflow(dtype):
    """(1, 200, d) rows whose router favours expert 1: its capacity (128 at
    the reduced config) overflows, and the port's experts, keep mask and
    dropped assignments equal the reference's dispatch exactly; outputs
    within tolerance."""
    cfg = get_config("mixtral-8x7b", reduced=True)
    mc = TM.MoEConfig(cfg.n_experts, cfg.top_k, cfg.capacity_factor)
    d = cfg.d_model
    rmc = RM.MoEConfig(*dataclasses.astuple(mc))
    ref, _ = RM.moe_init(jax.random.PRNGKey(13), d, cfg.d_ff, rmc)
    rng = np.random.default_rng(14)
    bias = rng.normal(0, 1, d).astype(np.float32)
    ref["router"] = ref["router"].at[:, 1].add(0.3 * jnp.asarray(bias))
    x = (rng.normal(0, 1, (1, 200, d)) + bias).astype(np.float32)
    w = loaded(TM.MoE(d, cfg.d_ff, mc, TDT[dtype], "cpu"), ref)
    jx = jnp.asarray(x, JDT[dtype])
    cap = RM.moe_capacity(rmc, 200)
    assert cap == TM.moe_capacity(mc, 200) == 128
    y_ref, aux_ref = RM.moe_apply(ref, rmc, jx)
    y, aux = TM.moe_apply(w, mc, torch.from_numpy(x).to(TDT[dtype]))
    # the reference's dispatch, by its own lines (moe.py _moe_math)
    router = ref["router"].astype(JDT[dtype])
    probs = jax.nn.softmax((jx @ router).astype(jnp.float32), axis=-1)
    _, experts = jax.lax.top_k(probs, mc.top_k)
    flat = experts.reshape(1, -1)
    onehot = jax.nn.one_hot(flat, mc.n_experts, dtype=jnp.int32)
    slot = jnp.sum((jnp.cumsum(onehot, axis=1) - 1) * onehot, axis=-1)
    keep = np.asarray(slot < cap)
    _, got_experts, got_keep, _ = TM.route(mc, torch.from_numpy(x).to(TDT[dtype]), w.router,
                                           cap)
    np.testing.assert_array_equal(got_experts.numpy(), np.asarray(flat))
    np.testing.assert_array_equal(w.routed.numpy(), np.asarray(flat))
    np.testing.assert_array_equal(got_keep.numpy(), keep)
    dropped = np.asarray(flat)[~keep]
    assert (dropped == 1).any(), dropped                          # expert 1 overflowed
    close(y, y_ref, dtype, "moe out")
    np.testing.assert_allclose(float(aux), float(aux_ref), rtol=1e-5)


# ---------------------------------------------------------------------------
# whole models: prefill and serve steps
# ---------------------------------------------------------------------------

def _moe_margins(monkeypatch):
    """Record, for every ``route`` call of the port, each token's gap
    between its K-th and (K+1)-th router logit, (B, S)."""
    gaps, route = [], TM.route

    def recording(cfg, x, router_w, cap):
        top = torch.topk((x @ router_w).float(), cfg.top_k + 1, dim=-1).values
        gaps.append(top[..., -2] - top[..., -1])
        return route(cfg, x, router_w, cap)
    monkeypatch.setattr(TM, "route", recording)
    return gaps


#: a near tie of the K-th and (K+1)-th router logits: within 2 bf16 ulps at
#: unit scale, where a few ulps of the residual stream can reorder them
#: (every flip seen at the reduced config had a gap of at most 1 ulp)
NEAR_TIE = 1 / 64


def _near(gaps, start):
    """(B, S) bool: a token whose routing was near-tied in any layer of the
    calls from ``start`` on."""
    return torch.stack(gaps[start:]).lt(NEAR_TIE).any(0)


def _compare_state(rs, ps, dtype, what, skip=None, pos=None):
    """Every leaf of every layer; with ``skip`` (B, P) bool over positions,
    the stacked attention rings' slots holding a skipped position are left
    out."""
    assert set(rs) == set(ps)
    np.testing.assert_array_equal(ps["pos"].numpy(), np.asarray(rs["pos"]))
    for key in rs:
        if key == "pos":
            continue
        for f, want in rs[key].items():
            got, want = ps[key][f], np.asarray(want)
            assert got.dtype == TDT[str(want.dtype)], (what, key, f, got.dtype)
            if skip is not None and f in ("k", "v"):
                C = want.shape[-2]
                slot_pos = [max(p for p in range(pos) if p % C == s) if s < pos else -1
                            for s in range(C)]
                for b in range(want.shape[-4]):
                    keep = [s for s in range(C)
                            if slot_pos[s] < 0 or not skip[b, slot_pos[s]]]
                    close_at_unit_scale(got[:, b][:, :, keep], want[:, b][:, :, keep],
                                        dtype, f"{what} {key}.{f} lane {b}")
            else:
                close_at_unit_scale(got, want, dtype, f"{what} {key}.{f}")


CASES = [   # (arch, dtype, S, cache_len): S below, at and past the ring C where it has one
    ("mixtral-8x7b", "float32", 40, 64), ("mixtral-8x7b", "float32", 128, 64),
    ("mixtral-8x7b", "bfloat16", 128, 64),
    ("recurrentgemma-9b", "float32", 40, 64), ("recurrentgemma-9b", "float32", 64, 64),
    ("recurrentgemma-9b", "float32", 128, 64), ("recurrentgemma-9b", "bfloat16", 128, 64),
    ("rwkv6-7b", "float32", 40, 64), ("rwkv6-7b", "float32", 128, 64),
    ("rwkv6-7b", "bfloat16", 128, 64),
    ("llava-next-mistral-7b", "float32", 64, 64), ("llava-next-mistral-7b", "bfloat16", 96, 64),
    ("musicgen-large", "float32", 48, 64), ("musicgen-large", "bfloat16", 80, 64),
]


@pytest.mark.parametrize("arch,dtype,S,cache_len", CASES,
                         ids=[f"{a}-{d}-S{s}-C{c}" for a, d, s, c in CASES])
def test_prefill_and_serve_steps(arch, dtype, S, cache_len, monkeypatch):
    """Prefill logits and every decode-state leaf (ring caches, recurrent
    states, tail layers), then three serve steps' logits and states, on 2
    lanes. mixtral in bf16 leaves out the near-tied tokens (module doc)."""
    rc, pc, params, model = pair(arch, dtype)
    moe_bf16 = "moe" in rc.pattern and dtype == "bfloat16"
    gaps = _moe_margins(monkeypatch) if moe_bf16 else None
    inputs = model_inputs(rc, S, seed=S)
    rl, rs = _ref_prefill(params, rc, {k: jnp.asarray(v) for k, v in inputs.items()}, cache_len)
    pl, ps = forward_prefill(model, pc, {k: torch.from_numpy(v) for k, v in inputs.items()},
                             cache_len)
    assert pl.dtype == torch.float32 and pl.shape == (2, S, rc.vocab_size)
    skip = _near(gaps, 0) if moe_bf16 else torch.zeros((2, S), dtype=torch.bool)
    assert skip.float().mean() < 0.1, f"{int(skip.sum())} near-tied tokens"
    close(pl[~skip], np.asarray(rl)[~skip.numpy()], dtype, "prefill logits")
    _compare_state(rs, ps, dtype, "prefill", skip if moe_bf16 else None, S)
    rng = np.random.default_rng(S + 1)
    for step in range(3):
        n = len(gaps) if moe_bf16 else 0
        inp = step_inputs(rc, rng)
        rl, rs = _ref_step(params, rc, rs, {k: jnp.asarray(v) for k, v in inp.items()})
        pl, ps = serve_step(model, pc, ps, {k: torch.from_numpy(v) for k, v in inp.items()})
        if moe_bf16:
            skip = torch.cat([skip, _near(gaps, n)], dim=1)
        lanes = ~skip[:, -1]
        close(pl[lanes], np.asarray(rl)[lanes.numpy()], dtype, f"step {step} logits")
        _compare_state(rs, ps, dtype, f"step {step}", skip if moe_bf16 else None, S + step + 1)


def test_tail_layers_and_state_layout():
    """recurrentgemma-9b: 38 layers = (rglru, rglru, local) x 12 + 2 tail
    layers; the tail's state has no layer axis; the local ring is
    min(cache_len, local_window); the weight count is the reference
    tree's."""
    cfg = get_config("recurrentgemma-9b")
    assert cfg.n_blocks == 12 and cfg.tail == ("rglru", "rglru")
    small = get_config("recurrentgemma-9b", reduced=True)
    model = Transformer(small, "meta")
    assert [k for k, _, _ in model.layers()][-2:] == ["tail_0", "tail_1"]
    st = decode_state_init(small, 3, 100, "cpu")
    assert st["tail_0"]["h"].shape == (3, 256) and st["tail_0"]["h"].dtype == torch.float32
    assert st["blocks_2"]["k"].shape == (1, 3, 1, 64, 64)            # local ring: 64 of 100
    assert st["blocks_0"]["conv"].shape == (1, 3, 3, 256)
    for arch in ("recurrentgemma-9b", "rwkv6-7b", "mixtral-8x7b", "musicgen-large",
                 "llava-next-mistral-7b"):
        rp = ref_params(arch)
        n_ref = sum(np.asarray(a).size for a in jax.tree.leaves(rp))
        port = Transformer(get_config(arch, reduced=True), "meta")
        assert sum(p.numel() for p in port.parameters()) == n_ref, arch
    assert Transformer(get_config("musicgen-large", reduced=True), "meta").embed is None


def test_init_params_distributions():
    """``init_params`` draws each kind's leaves at the reference's scales
    and ranges (not its draws): lam in [0.65, 0.85), decay_base in [-6, -5),
    bonus_u in [0, 0.5), mixes in [0, 1), truncated normals within 2σ."""
    model = init_params(get_config("rwkv6-7b", reduced=True), seed=3, device="cpu")
    tm = model.blocks[0][0].tm
    assert -6 <= float(tm.decay_base.min()) and float(tm.decay_base.max()) < -5
    assert 0 <= float(tm.bonus_u.min()) and float(tm.bonus_u.max()) < 0.5
    assert float(tm.w_decay.abs().max()) <= 2 * 0.1 / 16 * (1 + 2 ** -8)   # bf16 rounding
    rnn = init_params(get_config("recurrentgemma-9b", reduced=True), 3, "cpu").blocks[0][0].rnn
    assert 0.65 <= float(rnn.lam.min()) and float(rnn.lam.max()) < 0.85
    assert float(rnn.conv_w.float().abs().max()) <= 1.0 + 1e-6
    moe = init_params(get_config("mixtral-8x7b", reduced=True), 3, "cpu").blocks[0][0].moe
    std = moe.w_gate.float().std().item()
    assert abs(std - 0.88 / 16) < 0.005, std         # trunc ±2σ keeps 0.88 of σ
