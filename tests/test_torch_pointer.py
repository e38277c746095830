"""Port parity: pointer mode (variable-length keys in a key heap, paper
Sec. 4.5).

Keys are (n, W) uint32 word rows; records store the folded identity's high
word and a key-heap handle. The same seeded streams of inserts (through
splits), searches, deletes and updates go through the reference and the
port, which must agree on every status and found/value vector and end with
byte-identical planes, ``key_heap`` and ``heap_top`` included.
``heap_top_floor`` (the reopen guard) must lift a torn ``heap_top`` alike.
"""
import numpy as np
import pytest

from repro.core import DashConfig, DashEH, DashLH
from repro.core import recovery as rrec
from repro.core import hashing
from repro_torch.core import DashEH as TDashEH, DashLH as TDashLH
from repro_torch.core import hashing as thashing, recovery as trec
from tests.torch_parity import assert_same_state, port_cfg, ref_copy, to_port, words


def _cfg(W, **kw):
    return DashConfig(max_segments=16, dir_depth_max=6, num_buckets=16,
                      num_slots=8, pointer_mode=True, key_heap_size=2048,
                      key_heap_words=W, **kw)


def _key_words(rng, n, W):
    """``n`` distinct (W,) uint32 key rows."""
    rows = rng.integers(0, 2**32, size=(int(n * 1.2) + 8, W), dtype=np.uint64)
    rows = np.unique(rows.astype(np.uint32), axis=0)
    return rows[rng.permutation(rows.shape[0])[:n]]


@pytest.mark.parametrize("W", [2, 3])
def test_fold_words_matches_reference(W):
    rows = _key_words(np.random.default_rng(W), 257, W)
    want = hashing.np_key_identity_from_words(rows)
    got = thashing.key_identity_from_words(words(rows))
    for a, b in zip(want, got):
        assert (b.numpy().view(np.uint32) == a).all()
    for a, b in zip(want, thashing.np_key_identity_from_words(rows)):
        assert (a == b).all()


@pytest.mark.parametrize("mode,W", [("eh", 2), ("eh", 3), ("lh", 2)])
def test_pointer_stream_matches_reference(mode, W):
    """Every batch is B keys, so the reference compiles few shapes."""
    B = 128
    cfg = _cfg(W)
    ref = (DashEH if mode == "eh" else DashLH)(cfg)
    port = (TDashEH if mode == "eh" else TDashLH)(port_cfg(cfg), device="cpu")
    rng = np.random.default_rng(0x9E + W)
    keys = _key_words(rng, 640, W)
    absent = _key_words(np.random.default_rng(99), 32, W)
    vals = np.arange(B, dtype=np.uint32)

    def both(op, *args):
        a = getattr(ref, op)(*args)
        b = getattr(port, op)(*args)
        return a, b

    for i in range(4):                      # loads through several splits
        a, b = both("insert", None, vals + B * i + 1, keys[B * i:B * (i + 1)])
        assert (np.asarray(a) == b).all()
    assert ref.n_segments > 2 and ref.n_segments == port.n_segments
    a, b = both("insert", None, vals + 5000, keys[B // 2:B // 2 + B])  # EXISTS
    assert (np.asarray(a) == b).all() and (b == 1).all()
    q = np.concatenate([keys[:4 * B:6][:64], absent, keys[4 * B:4 * B + 32]])
    (fa, va), (fb, vb) = both("search", None, q)
    assert (np.asarray(fa) == fb).all() and (np.asarray(va) == vb).all()
    assert np.asarray(fa)[:64].all() and not np.asarray(fa)[64:].any()
    dele = np.concatenate([keys[:4 * B:5][:96], absent])
    a, b = both("delete", None, dele)
    assert (np.asarray(a) == b).all()
    a, b = both("update", None, vals + 7000, keys[B:2 * B])
    assert (np.asarray(a) == b).all()
    a, b = both("insert", None, vals + 9000,
                np.concatenate([keys[:4 * B:5][:64], keys[4 * B:4 * B + 64]]))
    assert (np.asarray(a) == b).all()
    for i in range(5):
        (fa, va), (fb, vb) = both("search", None, keys[B * i:B * (i + 1)])
        assert (np.asarray(fa) == fb).all() and (np.asarray(va) == vb).all()
    assert_same_state(ref.state, port.state)
    assert int(port.state.heap_top) == 4 * B + 64 + 64


def test_heap_top_floor_matches_reference():
    cfg = _cfg(2)
    ref = DashEH(cfg)
    keys = _key_words(np.random.default_rng(5), 300, 2)
    ref.insert(None, np.arange(300, dtype=np.uint32), keys)
    torn = ref_copy(ref.state)._replace(
        heap_top=np.asarray(ref.state.heap_top) * 0 + 120)
    port = to_port(cfg, torn)
    want = rrec.heap_top_floor(cfg, torn)
    got = trec.heap_top_floor(port_cfg(cfg), port)
    assert int(np.asarray(want.heap_top)) == int(got.heap_top) == 300
    assert_same_state(want, got)
    # a heap_top already past every handle stays; inline mode is a no-op
    again = trec.heap_top_floor(port_cfg(cfg), got)
    assert int(again.heap_top) == 300
