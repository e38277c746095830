"""Port parity: LM serving — ``ServingEngine`` over the Dash prefix cache and
the paged KV pool (``repro_torch.serving``) against the reference
(``repro.serving``), the launcher and the example twin.

The engines serve the same reduced model (the reference's weights carried
in) in float32: generated tokens, cached/prefilled counts, the pages the
prefix cache hands out, its stats and its table's planes must be equal;
the page pool's K/V within the f32 tolerance of ``tests/test_torch_lm.py``.
The reference's engine jits prefill once per distinct suffix length, so
the streams keep to two lengths.
"""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest

from repro.configs import get_config as ref_config
from repro.launch import serve as ref_serve
from repro.models import init_params as ref_init
from repro.serving import Request as RRequest, ServingEngine as RServingEngine
from repro_torch import interop
from repro_torch.configs import get_config
from repro_torch.models import init_params
from repro_torch.models.transformer import ModelConfig
from repro_torch.serving import Request, ServingEngine
from tests.torch_parity import assert_same_state

ROOT = Path(__file__).resolve().parents[1]
F32 = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module")
def yi32():
    """(reference config, port config, reference params, port model) of the
    reduced yi-6b in float32."""
    rc = dataclasses.replace(ref_config("yi-6b", reduced=True), dtype="float32")
    pc = ModelConfig(**dataclasses.asdict(rc))
    params, _ = ref_init(jax.random.PRNGKey(0), rc)
    return rc, pc, params, interop.model_params_from_jax(
        pc, jax.tree.map(np.asarray, params), "cpu")


def _logged(cache):
    """Record every ``match_prefix`` and ``admit`` answer of a prefix cache."""
    log = []
    match, admit = cache.match_prefix, cache.admit

    def logged_match(tokens):
        out = match(tokens)
        log.append(("match", list(out[0]), out[1]))
        return out

    def logged_admit(tokens, first_new_block=0):
        out = admit(tokens, first_new_block)
        log.append(("admit", list(out)))
        return out
    cache.match_prefix, cache.admit = logged_match, logged_admit
    return log


def _prompts(vocab, rounds, seed, shared_len=64, user_len=32):
    rng = np.random.default_rng(seed)
    shared = rng.integers(1, vocab, shared_len)
    return [[np.concatenate([shared, rng.integers(1, vocab, user_len)]) for _ in range(4)]
            for _ in range(rounds)]


def _serve(engine, make_request, rounds):
    out = []
    for r, prompts in enumerate(rounds):
        reqs = [make_request(4 * r + i, p, max_new_tokens=5) for i, p in enumerate(prompts)]
        engine.run(reqs)
        out += [(q.generated, q.cached_tokens, q.prefilled_tokens) for q in reqs]
    return out


def test_prefix_cache_hits_and_saved_prefill():
    """Twin of tests/test_serving.py: the shared prefix is reused."""
    cfg = get_config("yi-6b", reduced=True)
    eng = ServingEngine(cfg, init_params(cfg, 0, "cpu"), cache_len=256, num_pages=128,
                        batch_size=2)
    rng = np.random.default_rng(0)
    shared = rng.integers(1, cfg.vocab_size, 64)
    r1 = Request(0, np.concatenate([shared, rng.integers(1, cfg.vocab_size, 32)]),
                 max_new_tokens=4)
    r2 = Request(1, np.concatenate([shared, rng.integers(1, cfg.vocab_size, 32)]),
                 max_new_tokens=4)
    eng.run([r1])
    eng.run([r2])
    assert r1.cached_tokens == 0
    assert r2.cached_tokens == 64          # shared prefix reused
    assert r2.prefilled_tokens == 32
    assert eng.prefix.stats.hit_rate > 0.2
    assert len(r2.generated) == 4
    assert eng.flops_saved_tokens == 64


def test_prefix_cache_eviction_bounded():
    """Twin of tests/test_serving.py: 8 pages, 6 prompts of 4 blocks."""
    cfg = get_config("yi-6b", reduced=True)
    eng = ServingEngine(cfg, init_params(cfg, 0, "cpu"), cache_len=128, num_pages=8,
                        batch_size=1)
    rng = np.random.default_rng(1)
    for i in range(6):
        eng.run([Request(i, rng.integers(1, cfg.vocab_size, 64), max_new_tokens=2)])
    assert eng.prefix.stats.evictions > 0
    assert len(eng.prefix.free) + len(eng.prefix.lru) <= 8 + 1


def test_stream_matches_reference(yi32):
    """Two rounds of 4 requests (64 shared tokens + 32 fresh) through both
    engines in float32: every request's tokens and counts, every page list,
    the prefix cache's state and planes, and the page pool."""
    rc, pc, params, model = yi32
    ref = RServingEngine(rc, params, cache_len=128, num_pages=64, batch_size=4)
    port = ServingEngine(pc, model, cache_len=128, num_pages=64, batch_size=4)
    logs = _logged(ref.prefix), _logged(port.prefix)
    rounds = _prompts(rc.vocab_size, 2, seed=3)
    want, got = _serve(ref, RRequest, rounds), _serve(port, Request, rounds)
    assert got == want
    assert [c for _, c, _ in got] == [0] + [64] * 7
    assert logs[1] == logs[0]
    assert vars(port.prefix.stats) == vars(ref.prefix.stats)
    assert (port.prefix.free, port.prefix.lru, port.prefix.page_owner) == (
        ref.prefix.free, ref.prefix.lru, ref.prefix.page_owner)
    assert port.flops_saved_tokens == ref.flops_saved_tokens == 7 * 64
    assert_same_state(ref.prefix.table.state, port.prefix.table.state)
    for f in ("k", "v"):
        np.testing.assert_allclose(port.pool.storage[0][f].numpy(),
                                   np.asarray(ref.pool.storage[0][f]), **F32)


def test_hit_decode_differs_from_cold(yi32):
    """The reference's quirk, mirrored: after a prefix hit the suffix's own
    prefill state (positions 0..) replaces the gathered lane, so the decode
    differs from a cold run of the same prompt — in both packages alike."""
    rc, pc, params, model = yi32
    (p1, p2, _, _), = _prompts(rc.vocab_size, 1, seed=4)
    runs = {}
    for name, engine, make in (("ref", RServingEngine, RRequest), ("port", ServingEngine, Request)):
        p = params if name == "ref" else model
        c = rc if name == "ref" else pc
        warm = engine(c, p, cache_len=128, num_pages=64, batch_size=1)
        warm.run([make(0, p1, max_new_tokens=4)])
        hit = make(1, p2, max_new_tokens=4)
        warm.run([hit])
        cold = make(1, p2, max_new_tokens=4)
        engine(c, p, cache_len=128, num_pages=64, batch_size=1).run([cold])
        assert (hit.cached_tokens, cold.cached_tokens) == (64, 0)
        runs[name] = (hit.generated, cold.generated)
        assert hit.generated != cold.generated, name
    assert runs["port"] == runs["ref"]


def _run(args):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable] + args, cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    return out.stdout


def test_serve_launcher_twin(capsys):
    """``python -m repro_torch.launch.serve --device cpu`` prints the
    reference launcher's summary line (hit rate, saved prefill tokens, the
    table's load factor: none depends on the weights) and its per-request
    counts."""
    ref_serve.main([])
    want = capsys.readouterr().out.splitlines()
    got = _run(["-m", "repro_torch.launch.serve", "--device", "cpu"]).splitlines()
    assert got[0] == want[0]
    assert [g.split("->")[0] for g in got[1:]] == [w.split("->")[0] for w in want[1:]]


def test_serve_example_twin():
    out = _run(["examples/serve_prefix_cache_torch.py", "--device", "cpu", "--rounds", "2"])
    assert "round 1: hit-rate 58.3%, prefill tokens saved so far 448" in out
