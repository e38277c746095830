"""Port parity: serving the block kinds beyond ``dense`` — ``ServingEngine``
over mixtral (MoE), recurrentgemma (RG-LRU + local attention + tail layers)
and rwkv6 (state snapshots in the page pool), the recurrent ``PagePool``
kinds, the engine refusing the stub fronts, and the launcher twins —
against the reference (``repro.serving``).

The engines serve the same reduced model (the reference's weights carried
in) in float32: generated tokens, cached/prefilled counts, every
``match_prefix`` / ``admit`` answer, the prefix cache's state and its
table's planes are equal; every pool field within 1e-4. Prompts are 64
shared + 64 fresh tokens: a multiple of 64, where the reference's
sliding-window band is right (ROADMAP Queue 3) and its RWKV chunking does
not raise.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_config
from repro.launch import serve as ref_serve
from repro.serving import Request as RRequest, ServingEngine as RServingEngine
from repro.serving.kv_cache import PagePool as RPagePool, PagePoolConfig as RPagePoolConfig
from repro_torch import interop
from repro_torch.configs import get_config
from repro_torch.launch import serve as port_serve
from repro_torch.models import init_params
from repro_torch.models.transformer import ModelConfig, decode_state_init
from repro_torch.serving import Request, ServingEngine
from repro_torch.serving.kv_cache import PagePool, PagePoolConfig
from tests.test_torch_lm import ref_params
from tests.test_torch_lm_serving import _logged, _prompts, _serve
from tests.torch_parity import assert_same_state

F32 = dict(rtol=1e-4, atol=1e-4)


def f32_pair(arch):
    rc = dataclasses.replace(ref_config(arch, reduced=True), dtype="float32")
    pc = ModelConfig(**dataclasses.asdict(rc))
    params = ref_params(arch)
    return rc, pc, params, interop.model_params_from_jax(
        pc, jax.tree.map(np.asarray, params), "cpu")


@pytest.mark.parametrize("arch", ["mixtral-8x7b", "recurrentgemma-9b", "rwkv6-7b"])
def test_stream_matches_reference(arch):
    """Two rounds of 4 requests (64 shared tokens + 64 fresh) through both
    engines in float32: every request's tokens and counts, every page list,
    the prefix cache's state and planes, and every page-pool field."""
    rc, pc, params, model = f32_pair(arch)
    ref = RServingEngine(rc, params, cache_len=128, num_pages=64, batch_size=4)
    port = ServingEngine(pc, model, cache_len=128, num_pages=64, batch_size=4)
    logs = _logged(ref.prefix), _logged(port.prefix)
    rounds = _prompts(rc.vocab_size, 2, seed=5, user_len=64)
    want, got = _serve(ref, RRequest, rounds), _serve(port, Request, rounds)
    assert got == want
    assert [c for _, c, _ in got] == [0] + [64] * 7
    assert logs[1] == logs[0]
    assert vars(port.prefix.stats) == vars(ref.prefix.stats)
    assert (port.prefix.free, port.prefix.lru, port.prefix.page_owner) == (
        ref.prefix.free, ref.prefix.lru, ref.prefix.page_owner)
    assert port.flops_saved_tokens == ref.flops_saved_tokens == 7 * 64
    assert_same_state(ref.prefix.table.state, port.prefix.table.state)
    assert set(port.pool.storage) == set(ref.pool.storage)
    for pi, leaves in ref.pool.storage.items():
        assert set(port.pool.storage[pi]) == set(leaves)
        for f, want_leaf in leaves.items():
            got_leaf = port.pool.storage[pi][f]
            assert str(got_leaf.dtype)[6:] == str(want_leaf.dtype), (pi, f)
            np.testing.assert_allclose(got_leaf.numpy(), np.asarray(want_leaf), err_msg=f,
                                       **F32)


@pytest.mark.parametrize("arch", ["recurrentgemma-9b", "rwkv6-7b"])
def test_page_pool_recurrent_kinds(arch):
    """``store_request`` puts lane 1's final state into a request's last
    page (none for an empty page list), ``gather_into_cache`` brings that
    snapshot into another lane; attention kinds beside them page their
    ring. Storage and gathered states equal the reference's bit for bit."""
    cfg = get_config(arch, reduced=True)
    rng = np.random.default_rng(6)
    entries = {}
    for key, leaves in decode_state_init(cfg, 2, 64, "cpu").items():
        if key.startswith("blocks_"):
            entries[key] = {f: rng.normal(0, 1, t.shape).astype(np.float32)
                            for f, t in leaves.items()}
    ref = RPagePool(RPagePoolConfig(8, ref_config(arch, reduced=True)))
    port = PagePool(PagePoolConfig(8, cfg), device="cpu")
    dts = {pi: {f: t.dtype for f, t in port.storage[pi].items()} for pi in port.storage}

    def rounded(pi, entry):      # the state's values in the pool's dtypes
        return {f: torch.from_numpy(a).to(dts[pi][f]) for f, a in entry.items()}
    for pi, kind in enumerate(cfg.pattern):
        e = rounded(pi, entries[f"blocks_{pi}"])
        je = {f: jnp.asarray(t.float().numpy(), dtype=str(t.dtype)[6:]) for f, t in e.items()}
        for pages in ([], [3, 5, 6]):
            ref.store_request(pages, je, pi, kind, 1, 48)
            port.store_request(pages, e, pi, kind, 1, 48)
        for f, want in ref.storage[pi].items():
            np.testing.assert_array_equal(port.storage[pi][f].float().numpy(),
                                          np.asarray(want, np.float32))
        if kind in ("rglru", "rwkv"):                  # only the last page holds a snapshot
            assert not any(port.storage[pi][f][[3, 5]].any() for f in e)
        zeros = {f: torch.zeros_like(t) for f, t in e.items()}
        got = port.gather_into_cache([3, 5, 6], pi, kind, zeros, 0)
        want = ref.gather_into_cache([3, 5, 6], pi, kind,
                                     {f: jnp.zeros_like(v) for f, v in je.items()}, 0)
        for f in e:
            np.testing.assert_array_equal(got[f].float().numpy(),
                                          np.asarray(want[f], np.float32))
        if kind in ("rglru", "rwkv"):
            for f in e:
                assert torch.equal(got[f][:, 0], e[f][:, 1]), f


@pytest.mark.parametrize("arch", ["llava-next-mistral-7b", "musicgen-large"])
def test_engine_refuses_stub_fronts(arch):
    """The stub fronts are served through forward_prefill and serve_step
    (tests/test_torch_lm_kinds.py); the engine refuses them, as the
    reference's does."""
    cfg = get_config(arch, reduced=True)
    with pytest.raises(AssertionError, match="token-in archs"):
        RServingEngine(ref_config(arch, reduced=True), ref_params(arch), cache_len=64,
                       num_pages=8, batch_size=1)
    with pytest.raises(ValueError, match=f"the {cfg.family} front"):
        ServingEngine(cfg, init_params(cfg, 0, "cpu"), cache_len=64, num_pages=8, batch_size=1)
    with pytest.raises(SystemExit, match="token archs"):
        port_serve.main(["--arch", arch, "--device", "cpu"])


def _summary(lines):
    """The launcher's summary line and each request's counts (none depends
    on the weights)."""
    return lines[0], [line.split("->")[0] for line in lines[1:]]


@pytest.mark.parametrize("arch,argv", [("mixtral-8x7b", []), ("recurrentgemma-9b", []),
                                       ("rwkv6-7b", ["--prompt-len", "128"])],
                         ids=["mixtral-8x7b", "recurrentgemma-9b", "rwkv6-7b-prompt128"])
def test_serve_launcher_twin(arch, argv, capsys):
    """``python -m repro_torch.launch.serve --arch <arch>`` prints the
    reference launcher's summary line and per-request counts."""
    ref_serve.main(["--arch", arch] + argv)
    want = capsys.readouterr().out.splitlines()
    port_serve.main(["--arch", arch, "--device", "cpu"] + argv)
    got = capsys.readouterr().out.splitlines()
    assert _summary(got) == _summary(want)


def test_serve_launcher_rwkv_at_its_defaults(capsys):
    """At its default 96-token prompts the reference's launcher dies in the
    RWKV chunking (a 96-token prefill is not a multiple of 64); the port's
    serves all 6 requests, 8 tokens each."""
    with pytest.raises(TypeError, match="reshape"):
        ref_serve.main(["--arch", "rwkv6-7b"])
    capsys.readouterr()
    done = port_serve.main(["--arch", "rwkv6-7b", "--device", "cpu"])
    out = capsys.readouterr().out
    assert out.startswith("[serve] rwkv6-7b: 6 requests, prefix hit rate 55.56%, prefill "
                          "tokens saved 320")
    assert [(r.cached_tokens, r.prefilled_tokens) for r in done] == [(0, 96)] + [(64, 32)] * 5
    assert all(len(r.generated) == 8 for r in done)
