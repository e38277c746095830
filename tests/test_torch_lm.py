"""Port parity: the LM substrate's layers and the dense decoder
(``repro_torch.models``) against the reference (``repro.models``) on the
same seeded inputs, the reference's weights carried in by
``interop.model_params_from_jax``.

Tolerances, set from the dtype: in float32 the two packages differ by
summation order only (``F32``); in bfloat16 every product rounds to 8
mantissa bits, so a different accumulation order moves a value by a few
bf16 ulps, and that carries through the layers (``BF16``). The sliding-window
prefill is held to the reference where the reference is right, and to a
naive masked attention where it is not (ragged lengths past the window).
"""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS as REF_ARCH_IDS
from repro.configs import all_cells as ref_all_cells
from repro.configs import get_config as ref_config
from repro.models import init_params as ref_init
from repro.models import layers as RL
from repro.models.transformer import forward_prefill as ref_forward_prefill
from repro.models.transformer import serve_step as ref_serve_step
from repro_torch import interop
from repro_torch.configs import ARCH_IDS, all_cells, get_config
from repro_torch.models import layers as TL
from repro_torch.models.transformer import (ModelConfig, decode_state_init,
                                            forward_prefill, init_params, serve_step)

F32 = dict(rtol=1e-4, atol=1e-4)
BF16 = dict(rtol=0.0625, atol=0.125)
TOL = {"float32": F32, "bfloat16": BF16}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}

_ref_prefill = jax.jit(ref_forward_prefill, static_argnums=(1, 3))
_ref_step = jax.jit(ref_serve_step, static_argnums=(1,))
_REF_PARAMS = {}


def f32(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(a, np.float32)


def close(got, want, dtype, what=""):
    np.testing.assert_allclose(f32(got), f32(want), err_msg=what, **TOL[dtype])


def ref_params(arch):
    if arch not in _REF_PARAMS:
        params, _ = ref_init(jax.random.PRNGKey(0), ref_config(arch, reduced=True))
        _REF_PARAMS[arch] = params
    return _REF_PARAMS[arch]


def pair(arch, dtype):
    """(reference config, port config, reference params, port model)."""
    rc = dataclasses.replace(ref_config(arch, reduced=True), dtype=dtype)
    pc = ModelConfig(**dataclasses.asdict(rc))
    params = ref_params(arch)
    return rc, pc, params, interop.model_params_from_jax(
        pc, jax.tree.map(np.asarray, params), "cpu")


def loaded(module, ref):
    """``module`` with the reference's weight leaves ``ref`` copied in."""
    for name, a in ref.items():
        getattr(module, name).data.copy_(torch.from_numpy(np.array(a)))
    return module


def same_state(ref_state, port_state, dtype, what):
    assert set(ref_state) == set(port_state)
    np.testing.assert_array_equal(port_state["pos"].numpy(), np.asarray(ref_state["pos"]))
    for key in ref_state:
        if key != "pos":
            for f in ref_state[key]:
                assert port_state[key][f].dtype == TDT[dtype]
                close(port_state[key][f], ref_state[key][f], dtype, f"{what} {key}.{f}")


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------

def test_configs_match_reference():
    assert ARCH_IDS == REF_ARCH_IDS
    for arch in ARCH_IDS:
        for reduced in (False, True):
            rc, pc = ref_config(arch, reduced), get_config(arch, reduced)
            assert dataclasses.asdict(pc) == dataclasses.asdict(rc), (arch, reduced)
            assert (pc.param_count(), pc.active_param_count(), pc.hd, pc.n_blocks, pc.tail) == (
                rc.param_count(), rc.active_param_count(), rc.hd, rc.n_blocks, rc.tail)
    assert all_cells() == ref_all_cells()
    assert get_config("yi-6b").param_count() == 6_060_769_280


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    cfg = get_config("yi-6b", reduced=True)
    for make in (lambda: init_params(cfg), lambda: decode_state_init(cfg, 1, 64)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_and_rope(dtype):
    rng = np.random.default_rng(1)
    x = rng.normal(0, 2, (2, 3, 5, 64)).astype(np.float32)
    scale = rng.normal(1, 0.1, 64).astype(np.float32)
    got = TL.rmsnorm(torch.from_numpy(scale), torch.from_numpy(x).to(TDT[dtype]))
    want = RL.rmsnorm({"scale": jnp.asarray(scale)}, jnp.asarray(x, JDT[dtype]))
    assert got.dtype == TDT[dtype]
    close(got, want, dtype, "rmsnorm")
    np.testing.assert_array_equal(TL.rope_frequencies(64, 5e6), RL.rope_frequencies(64, 5e6))
    pos = rng.integers(0, 5000, (2, 1, 5)).astype(np.int32)
    got = TL.apply_rope(torch.from_numpy(x).to(TDT[dtype]), torch.from_numpy(pos), 5e6)
    want = RL.apply_rope(jnp.asarray(x, JDT[dtype]), jnp.asarray(pos), 5e6)
    assert got.dtype == TDT[dtype]
    close(got, want, dtype, "rope")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mlp_and_embeddings(dtype):
    rng = np.random.default_rng(2)
    ref, _ = RL.mlp_init(jax.random.PRNGKey(3), 64, 160)
    w = loaded(TL.SwiGLU(64, 160, TDT[dtype], "cpu"), ref)
    x = rng.normal(0, 1, (2, 7, 64)).astype(np.float32)
    got = TL.mlp(w, torch.from_numpy(x).to(TDT[dtype]))
    want = RL.mlp(ref, jnp.asarray(x, JDT[dtype]))
    close(got, want, dtype, "mlp")
    table = rng.normal(0, 1, (50, 64)).astype(np.float32)
    toks = rng.integers(0, 50, (2, 9)).astype(np.int32)
    got = TL.embed(torch.from_numpy(table).to(TDT[dtype]), torch.from_numpy(toks))
    want = RL.embed({"table": jnp.asarray(table)}, jnp.asarray(toks), JDT[dtype])
    np.testing.assert_array_equal(f32(got), f32(want))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attention_decode(dtype):
    """One token per lane against ring caches: lanes before, at and past the
    ring's wrap; the written caches and the output."""
    cfg = RL.AttnConfig(d_model=64, n_heads=4, n_kv_heads=2, head_dim=16, rope_theta=1e4)
    ref, _ = RL.attention_init(jax.random.PRNGKey(4), cfg)
    w = loaded(TL.Attention(TL.AttnConfig(**dataclasses.asdict(cfg)), TDT[dtype], "cpu"), ref)
    rng = np.random.default_rng(5)
    C = 24
    x = rng.normal(0, 1, (4, 1, 64)).astype(np.float32)
    ck = rng.normal(0, 1, (4, 2, C, 16)).astype(np.float32)
    cv = rng.normal(0, 1, (4, 2, C, 16)).astype(np.float32)
    cache_len = np.array([0, 5, C - 1, 57], np.int32)
    out, nk, nv = RL.attention_decode(ref, cfg, jnp.asarray(x, JDT[dtype]),
                                      jnp.asarray(ck, JDT[dtype]), jnp.asarray(cv, JDT[dtype]),
                                      jnp.asarray(cache_len))
    tk, tv = torch.from_numpy(ck).to(TDT[dtype]), torch.from_numpy(cv).to(TDT[dtype])
    got, gk, gv = TL.attention_decode(w, w.cfg, torch.from_numpy(x).to(TDT[dtype]), tk, tv,
                                      torch.from_numpy(cache_len))
    assert gk is tk and gv is tv                   # written in place
    close(got, out, dtype, "out")
    close(gk, nk, dtype, "k")
    close(gv, nv, dtype, "v")


def _naive_attention(x, p, cfg, S):
    """Masked softmax attention in float64 from the weights: causal, inside
    the window."""
    x = x.astype(np.float64)
    H, G, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    freqs = RL.rope_frequencies(hd, cfg.rope_theta).astype(np.float64)
    ang = np.arange(S)[:, None] * freqs
    cos, sin = np.cos(ang), np.sin(ang)

    def heads(w, n, rope):
        t = (x @ np.asarray(p[w], np.float64)).reshape(S, n, hd).transpose(1, 0, 2)
        if rope:
            a, b = t[..., :hd // 2], t[..., hd // 2:]
            t = np.concatenate([a * cos - b * sin, b * cos + a * sin], -1)
        return t
    q, k, v = heads("wq", H, True), heads("wk", G, True), heads("wv", G, False)
    k, v = np.repeat(k, H // G, 0), np.repeat(v, H // G, 0)
    s = q @ k.transpose(0, 2, 1) / math.sqrt(hd)
    i, j = np.arange(S)[:, None], np.arange(S)[None, :]
    s = np.where((j <= i) & (j > i - cfg.sliding_window), s, -np.inf)
    pr = np.exp(s - s.max(-1, keepdims=True))
    pr /= pr.sum(-1, keepdims=True)
    out = (pr @ v).transpose(1, 0, 2).reshape(S, H * hd)
    return out @ np.asarray(p["wo"], np.float64)


@pytest.mark.parametrize("S", [48, 64, 128, 192, 96, 100, 160, 200])
def test_sliding_window_prefill(S):
    """The static band in f32: at S <= window or S a multiple of q_chunk the
    port equals the reference (and naive attention); at ragged S past the
    window the reference labels the clamped band with the unclamped start
    and is wrong, the port equals naive attention."""
    cfg = RL.AttnConfig(d_model=64, n_heads=2, n_kv_heads=1, head_dim=32, sliding_window=64,
                        q_chunk=64)
    ref, _ = RL.attention_init(jax.random.PRNGKey(6), cfg)
    w = loaded(TL.Attention(TL.AttnConfig(**dataclasses.asdict(cfg)), torch.float32, "cpu"), ref)
    x = np.random.default_rng(S).normal(0, 1, (1, S, 64)).astype(np.float32)
    pos = np.arange(S, dtype=np.int32)[None]
    got = f32(TL.attention_train(w, w.cfg, torch.from_numpy(x), torch.from_numpy(pos)))[0]
    want = f32(RL.attention_train(ref, cfg, jnp.asarray(x), jnp.asarray(pos)))[0]
    naive = _naive_attention(x[0], ref, cfg, S)
    np.testing.assert_allclose(got, naive, **F32)
    if S <= 64 or S % 64 == 0:
        np.testing.assert_allclose(got, want, **F32)
    else:
        assert np.abs(want - naive).max() > 0.1, "the reference's band fault did not show"


# ---------------------------------------------------------------------------
# the decoder: prefill, decode state, serve steps
# ---------------------------------------------------------------------------

CASES = [   # (arch, dtype, prompt length S, cache_len): S below, at and past the ring C
    ("yi-6b", "float32", 40, 64), ("yi-6b", "float32", 64, 64),
    ("yi-6b", "float32", 100, 64), ("yi-6b", "bfloat16", 100, 64),
    ("h2o-danube-3-4b", "float32", 48, 128), ("h2o-danube-3-4b", "float32", 64, 128),
    ("h2o-danube-3-4b", "float32", 128, 128), ("h2o-danube-3-4b", "bfloat16", 128, 128),
    ("glm4-9b", "float32", 80, 64), ("glm4-9b", "bfloat16", 80, 64),
    ("mistral-nemo-12b", "float32", 40, 64), ("mistral-nemo-12b", "bfloat16", 40, 64),
]


@pytest.mark.parametrize("arch,dtype,S,cache_len", CASES,
                         ids=[f"{a}-{d}-S{s}-C{c}" for a, d, s, c in CASES])
def test_prefill_and_serve_steps(arch, dtype, S, cache_len):
    """Prefill logits and decode state (ring caches at their slots), then
    three serve steps' logits and states, on 2 lanes."""
    rc, pc, params, model = pair(arch, dtype)
    toks = np.random.default_rng(S).integers(1, rc.vocab_size, (2, S)).astype(np.int32)
    rl, rs = _ref_prefill(params, rc, {"tokens": jnp.asarray(toks)}, cache_len)
    pl, ps = forward_prefill(model, pc, {"tokens": torch.from_numpy(toks)}, cache_len)
    assert pl.dtype == torch.float32 and pl.shape == (2, S, rc.vocab_size)
    close(pl, rl, dtype, "prefill logits")
    same_state(rs, ps, dtype, "prefill")
    for step, tok in enumerate(([3, 7], [11, 0], [rc.vocab_size - 1, 5])):
        tok = np.array(tok, np.int32)
        rl, rs = _ref_step(params, rc, rs, {"token": jnp.asarray(tok)})
        pl, ps = serve_step(model, pc, ps, {"token": torch.from_numpy(tok)})
        close(pl, rl, dtype, f"step {step} logits")
        same_state(rs, ps, dtype, f"step {step}")


@pytest.mark.parametrize("arch", ["yi-6b", "h2o-danube-3-4b", "recurrentgemma-9b", "rwkv6-7b",
                                  "mixtral-8x7b"])
def test_decode_matches_prefill(arch):
    """The port alone, in bf16: prefill logits at the last position equal
    the logits after feeding the same tokens one by one (the reference's own
    check and tolerance, tests/test_archs_smoke.py, with its list of
    archs). mixtral runs in f32: in bf16 the two paths round the residual
    stream differently and can flip a near-tied top-2 routing, which is why
    the reference's check leaves MoE out."""
    cfg = get_config(arch, reduced=True)
    if "moe" in cfg.pattern:
        cfg = dataclasses.replace(cfg, dtype="float32")
    model = init_params(cfg, seed=1, device="cpu")
    T = 24
    toks = np.random.default_rng(0).integers(1, cfg.vocab_size, (1, T)).astype(np.int32)
    plogits, _ = forward_prefill(model, cfg, {"tokens": torch.from_numpy(toks)}, 64)
    state = decode_state_init(cfg, 1, 64, "cpu")
    for t in range(T):
        logits, state = serve_step(model, cfg, state, {"token": torch.from_numpy(toks[:, t])})
    np.testing.assert_allclose(f32(logits[0]), f32(plogits[0, -1]), rtol=0.12, atol=0.6)
    assert int(state["pos"][0]) == T
