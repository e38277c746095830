"""Port parity: Dash-LH (linear hashing) against the JAX package.

LH fills through the table in both SMO modes, the stride expansion
(``bulk_split_next``) and the scan split at Next on one state, the
hybrid-expansion accounting, and LH reads through every read plan plus
deletes and updates must give the reference's planes — ``lh_word``,
``lh_dir``, ``stash_active`` and ``watermark`` included — and answers,
byte for byte.
"""
import jax.numpy as jnp
import numpy as np
import pytest

from repro.core import DashConfig, DashLH, dash_lh as rdash_lh, engine as re_, hashing
from repro.core import layout, smo as rsmo
from repro.core.table import TableFullError
from repro_torch.core import DashLH as TDashLH, dash_lh as tdash_lh, engine as te
from repro_torch.core import TableFullError as TTableFullError
from repro_torch.core import smo as tsmo
from tests.conftest import unique_keys
from tests.torch_parity import assert_same_state, port_cfg, to_port, words

#: small segments (16 buckets x 8 slots + 4 stash) so a few thousand keys
#: take the table through many stride expansions and stash activations
CFG = DashConfig(max_segments=64, num_buckets=16, num_slots=8, num_stash=4)


def _keys_vals(n, seed):
    keys = unique_keys(np.random.default_rng(seed), n)
    vals = np.random.default_rng(seed + 1).integers(0, 2**32, n, dtype=np.uint64
                                                    ).astype(np.uint32)
    return keys, vals


@pytest.mark.parametrize("smo_mode", ["bulk", "scalar"])
def test_lh_fill_matches_reference(smo_mode):
    """Batches of both write plans (fused <= 1024 keys, segment-parallel),
    stride expansions on stash activation and on pressure."""
    keys, vals = _keys_vals(1600, 11)
    ref = DashLH(CFG, smo_mode=smo_mode)
    port = TDashLH(port_cfg(CFG), device="cpu", smo_mode=smo_mode)
    for a, b in ((0, 200), (200, 900), (900, 1600)):
        np.testing.assert_array_equal(port.insert(keys[a:b], vals[a:b]),
                                      np.asarray(ref.insert(keys[a:b], vals[a:b])))
        assert_same_state(ref.state, port.state, (a, b))
    assert port.n_segments >= 12 and port.active_segments == ref.active_segments
    assert port.n_items == int(te.recount_items(port.state)) == 1600


def _lh_scanned(n, seed):
    """A reference LH state with ``n`` keys scanned into its 4 segments."""
    hi, lo = hashing.np_split_keys(unique_keys(np.random.default_rng(seed), n))
    state = layout.make_state(CFG, "lh")
    state, _, _ = re_.insert_batch(CFG, "lh", state, jnp.asarray(hi), jnp.asarray(lo),
                                   jnp.asarray(np.arange(n, dtype=np.uint32)),
                                   batching="scan")
    return state


def test_bulk_split_next_matches_reference():
    """One state: a stride of 3 at Next, then the rest of the round (wrap
    to the next level), then a scan split and a rebuild split at Next."""
    ref = _lh_scanned(420, 5)
    port = to_port(CFG, ref)
    pc = port_cfg(CFG)
    for R in (3, 1):
        ref, ok_r, old_r = rsmo.bulk_split_next(CFG, ref, R)
        port, ok_p, old_p = tsmo.bulk_split_next(pc, port, R)
        np.testing.assert_array_equal(ok_p.numpy(), np.asarray(ok_r))
        np.testing.assert_array_equal(old_p.numpy(), np.asarray(old_r))
        assert_same_state(ref, port, R)
    assert int(np.asarray(ref.lh_word)) == 1 << 24        # level 1, Next 0
    ref, ok_r = rdash_lh.split_next_scan(CFG, ref)
    port, ok_p = tdash_lh.split_next_scan(pc, port)
    assert bool(ok_r) and ok_p
    assert_same_state(ref, port, "scan")
    ref, _ = rdash_lh.split_next(CFG, ref)
    port, _ = tdash_lh.split_next(pc, port)
    assert_same_state(ref, port, "rebuild")
    # the scan fallback of a bulk lane, on a segment of the advanced table
    ref, _ = rdash_lh.rehash_segment_scan(CFG, ref, 1)
    port, _ = tdash_lh.rehash_segment_scan(pc, port, 1)
    assert_same_state(ref, port, "rehash")
    assert tdash_lh.lh_active_segments(pc, port) == \
        rdash_lh.lh_active_segments(CFG, ref) == 10


@pytest.mark.parametrize("n_segments,stride", [(0, 8), (1, 8), (64, 8), (65, 4),
                                               (5000, 8), (10**6, 4), (2**25, 8)])
def test_hybrid_expansion_directory(n_segments, stride):
    assert tdash_lh.hybrid_expansion_directory(n_segments, stride) == \
        rdash_lh.hybrid_expansion_directory(n_segments, stride)


@pytest.fixture(scope="module")
def stashed():
    """A reference LH state whose 4 segments overflow into 3-4 active stash
    rows (keys past the last stash row were refused), and its keys."""
    n = 640
    keys = unique_keys(np.random.default_rng(7), n)
    hi, lo = hashing.np_split_keys(keys)
    state = layout.make_state(CFG, "lh")
    state, st, _ = re_.insert_batch(CFG, "lh", state, jnp.asarray(hi), jnp.asarray(lo),
                                    jnp.asarray(np.arange(n, dtype=np.uint32)),
                                    batching="scan")
    assert (np.asarray(state.stash_active)[:4] > CFG.lh_base_stash).sum() >= 2
    return state, keys, np.asarray(st)


@pytest.mark.parametrize("plan", ["vmap", "pallas", "fused"])
def test_lh_search_matches_reference(plan, stashed):
    """LH reads through each read plan: hits (stash-resident ones included,
    with up to 4 stash rows active), refused keys and misses."""
    ref, keys, st = stashed
    port = to_port(CFG, ref)
    q = np.concatenate([keys, unique_keys(np.random.default_rng(99), 300)])
    hi, lo = hashing.np_split_keys(q)
    f_r, v_r = re_.search_batch(CFG, "lh", ref, jnp.asarray(hi), jnp.asarray(lo),
                                batching="vmap")
    f_p, v_p = te.search_batch(port_cfg(CFG), "lh", port, words(hi), words(lo),
                               batching=plan)
    np.testing.assert_array_equal(f_p.numpy(), np.asarray(f_r))
    np.testing.assert_array_equal(v_p.numpy().view(np.uint32), np.asarray(v_r))
    assert np.asarray(f_r).sum() == (st == 0).sum() < keys.size


def test_lh_delete_update_matches_reference():
    """Deletes and updates on a filled LH table, then table reads."""
    keys, vals = _keys_vals(1200, 21)
    ref = DashLH(CFG)
    port = TDashLH(port_cfg(CFG), device="cpu")
    ref.insert(keys, vals)
    port.insert(keys, vals)
    np.testing.assert_array_equal(port.delete(keys[::5]), np.asarray(ref.delete(keys[::5])))
    upd = keys[1::4]
    np.testing.assert_array_equal(port.update(upd, vals[:upd.size]),
                                  np.asarray(ref.update(upd, vals[:upd.size])))
    assert_same_state(ref.state, port.state)
    for q in (keys[:500], keys):                # fused and fingerprint plans
        f_r, v_r = ref.search(q)
        f_p, v_p = port.search(q)
        np.testing.assert_array_equal(f_p, np.asarray(f_r))
        np.testing.assert_array_equal(v_p, np.asarray(v_r))


def test_lh_retry_budget_matches_reference():
    """Both LH tables exhaust an insert's retry budget on the same batch and
    in the same state, with the pool not yet full. A key whose segment
    filled before Next reached it waits until Next gets there: up to
    round_size / 16 rounds (two strides of 8 a round), here 64 / 16 = 4 =
    ``max_retries``. At the default of 256 the same wait ends the insert
    once a round spans 4096 segments."""
    cfg = DashConfig(max_segments=128, num_buckets=16, num_slots=8, num_stash=4)
    keys, vals = _keys_vals(40000, 3)
    ref = DashLH(cfg)
    port = TDashLH(port_cfg(cfg), device="cpu")
    for a in range(0, keys.size, 1024):
        batch = keys[a:a + 1024], vals[a:a + 1024]
        try:
            ref.insert(*batch, max_retries=4)
        except TableFullError as e:
            assert "retry budget" in str(e)
            break
        np.testing.assert_array_equal(port.insert(*batch, max_retries=4), 0)
        assert_same_state(ref.state, port.state, a)
    else:
        pytest.fail("the reference never exhausted its retry budget")
    with pytest.raises(TTableFullError, match="retry budget"):
        port.insert(*batch, max_retries=4)
    assert_same_state(ref.state, port.state, "at the raise")
    assert port.n_segments == ref.n_segments < cfg.max_segments
    assert port.active_segments == ref.active_segments > 64
