"""Port parity: the Dash applications — the prefix cache and the dedup
pipeline — and the example twins.

``DashPrefixCache`` over the port's ``DashEH`` must hand out the
reference's pages, free list, LRU ticks, owners and stats after every call,
eviction included, with the same table planes. ``DedupFilter`` over the
port's ``DashLH`` behind ``PackedBatcher`` must pack the reference's batches
and skip the same documents with the same LH planes. The example twins run
on the CPU.
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from repro.data import DedupFilter, PackedBatcher, PipelineConfig, dedup as rdedup
from repro.serving import prefix_cache as rpc
from repro_torch.data import (DedupFilter as TDedupFilter, PackedBatcher as TPackedBatcher,
                              PipelineConfig as TPipelineConfig, dedup as tdedup)
from repro_torch.serving import prefix_cache as tpc
from tests.torch_parity import assert_same_state

ROOT = Path(__file__).resolve().parents[1]


def _cache_view(c):
    return (list(c.free), dict(c.lru), dict(c.page_owner), c.tick, vars(c.stats))


def test_prefix_cache_matches_reference():
    """Prompts built from 3 shared prefixes: lookups, admissions of the new
    blocks, a repeated admission (EXISTS) and LRU evictions once the 24
    pages run out; the cache's host state and the table after every call."""
    rng = np.random.default_rng(4)
    prefixes = [rng.integers(1, 32000, 32) for _ in range(3)]
    ref, port = rpc.DashPrefixCache(num_pages=24), tpc.DashPrefixCache(num_pages=24,
                                                                       device="cpu")
    for i in range(14):
        tokens = np.concatenate([prefixes[i % 3], rng.integers(1, 32000, 16 * (1 + i % 3))])
        np.testing.assert_array_equal(tpc._chain_hashes(tokens), rpc._chain_hashes(tokens))
        got, want = port.match_prefix(tokens), ref.match_prefix(tokens)
        assert got == want, i
        first = 0 if i == 5 else got[1] // tpc.BLOCK        # i == 5 re-admits (EXISTS)
        assert port.admit(tokens, first) == ref.admit(tokens, first), i
        assert _cache_view(port) == _cache_view(ref), i
    assert_same_state(ref.table.state, port.table.state)
    assert port.stats.evictions > 0 and port.stats.hit_blocks > 0
    assert port.stats.hit_rate == ref.stats.hit_rate
    assert port.load_factor == ref.load_factor


def test_dedup_pipeline_matches_reference():
    """Packed batches with 30 % synthetic duplicates through the dedup
    stage: the same batches, skips and unique documents, the same Dash-LH
    planes, and a cursor checkpoint that resumes to the same batch."""
    kw = dict(vocab_size=1000, seq_len=128, batch_size=2, dup_fraction=0.3,
              doc_len_min=16, doc_len_max=48)
    rd, td = DedupFilter(), TDedupFilter(device="cpu")
    rb_, tb_ = PackedBatcher(PipelineConfig(**kw), dedup=rd), TPackedBatcher(
        TPipelineConfig(**kw), dedup=td)
    for i in range(12):
        a, b = rb_.next_batch(), tb_.next_batch()
        for k in ("tokens", "labels"):
            np.testing.assert_array_equal(b[k], a[k], err_msg=(i, k))
    assert (tb_.docs_seen, tb_.docs_skipped) == (rb_.docs_seen, rb_.docs_skipped)
    assert tb_.docs_skipped > 0
    assert td.unique_docs == rd.unique_docs == tb_.docs_seen - tb_.docs_skipped
    assert_same_state(rd.table.state, td.table.state)
    state = tb_.state_dict()
    nxt = tb_.next_batch()
    resumed = TPackedBatcher(TPipelineConfig(**kw))
    resumed.load_state_dict(state)
    np.testing.assert_array_equal(resumed.next_batch()["tokens"], nxt["tokens"])


def test_content_hashes_match_reference():
    rng = np.random.default_rng(9)
    for n in (1, 17, 300, 5000):
        doc = rng.integers(1, 32000, n, dtype=np.int32)
        assert tdedup.content_hash64_fast(doc) == rdedup.content_hash64_fast(doc)
        if n <= 300:                       # the FNV-1a loop is one step a byte
            assert tdedup.content_hash64(doc) == rdedup.content_hash64(doc)


@pytest.mark.parametrize("script,args,expect", [
    ("quickstart_torch.py", ["--keys", "2000"], "Dash-LH: 500 items"),
    ("dedup_pipeline_torch.py", ["--batches", "3"], "batch 3: docs seen"),
    ("distributed_dht_torch.py", ["--ranks", "2", "--keys", "3000"],
     "inserted 3000 across 2 shards; search hit 3000/3000"),
])
def test_example_twins_run_on_cpu(script, args, expect):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, str(ROOT / "examples" / script),
                          "--device", "cpu", *args], capture_output=True, text=True,
                         env=env, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    assert expect in out.stdout, out.stdout
