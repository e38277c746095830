"""Port parity: crash simulation, instant restart and lazy/eager recovery.

From one seed the port's ``simulate_crash`` must leave the reference's
artifacts byte for byte (held locks, displacement duplicates, wiped
overflow metadata, an interrupted EH split); ``instant_restart`` must set
the same scalars; the port's set-form recovery must equal both the
per-segment form and the reference's ``recover_all``; lazy recovery
through ``search`` — SMO continuation and rollback included — must give
the reference's planes, answers and recovered-segment counts; and a clean
shutdown must skip recovery.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import DashConfig, DashEH, DashLH, EXISTS, layout
from repro.core import recovery as rrec, smo as rsmo
from repro_torch import interop
from repro_torch.core import DashEH as TDashEH, DashLH as TDashLH, engine as te
from repro_torch.core import recovery as trec, smo as tsmo
from tests.conftest import unique_keys
from tests.torch_parity import assert_same_state, port_cfg, ref_copy, to_port

EH_CFG = DashConfig(max_segments=32, dir_depth_max=8, num_buckets=16, num_slots=8)
LH_CFG = DashConfig(max_segments=32, num_buckets=16, num_slots=8, num_stash=4)
TABLES = {"eh": (EH_CFG, DashEH, TDashEH), "lh": (LH_CFG, DashLH, TDashLH)}
CRASH = dict(lock_frac=0.2, n_dups=12, wipe_overflow=True)


def _keys_vals(n, seed):
    keys = unique_keys(np.random.default_rng(seed), n)
    return keys, np.arange(n, dtype=np.uint32) ^ np.uint32(0x5A5A5A5A)


@pytest.fixture(scope="module")
def filled():
    """One filled (reference, port) table pair per mode, shared read-only:
    each test carries the states over fresh."""
    out = {}
    for mode, (cfg, R, T) in TABLES.items():
        keys, vals = _keys_vals(1100, 3)
        ref, port = R(cfg), T(port_cfg(cfg), device="cpu")
        ref.insert(keys, vals)
        port.insert(keys, vals)
        assert_same_state(ref.state, port.state, mode)
        out[mode] = (ref.state, keys, vals)
    return out


def _pair(mode, ref_state):
    cfg, R, T = TABLES[mode]
    ref = R(cfg, state=ref_copy(ref_state))
    port = T(port_cfg(cfg), state=to_port(cfg, ref_state))
    return ref, port


@pytest.mark.parametrize("mode,interrupt", [("eh", False), ("eh", True), ("lh", False)])
def test_simulate_crash_matches_reference(filled, mode, interrupt):
    ref, port = _pair(mode, filled[mode][0])
    kw = dict(CRASH, interrupt_smo=interrupt)
    ref.crash(np.random.default_rng(17), **kw)
    port.crash(np.random.default_rng(17), **kw)
    assert_same_state(ref.state, port.state)
    seg_state = port.state.seg_state.numpy()
    assert (seg_state == layout.SEG_SPLITTING).sum() == int(interrupt)
    assert port.dirty.drain().full


@pytest.mark.parametrize("clean", [True, False])
def test_instant_restart_matches_reference(filled, clean):
    ref, port = _pair("eh", filled["eh"][0])
    if clean:
        ref.graceful_shutdown()
        port.graceful_shutdown()
    else:
        ref.crash(np.random.default_rng(1), **CRASH)
        port.crash(np.random.default_rng(1), **CRASH)
    w_ref, w_port = ref.restart(), port.restart()
    assert w_ref["clean"] == w_port["clean"] == clean
    assert_same_state(ref.state, port.state)
    assert int(port.state.gver) == 1 + (not clean) and not bool(port.state.clean)


@pytest.mark.parametrize("mode,interrupt", [("eh", True), ("lh", False)])
def test_set_form_recovery_matches_per_segment(filled, mode, interrupt):
    """recover_all (steps 1-3 over every segment at once, step 4 first on
    the host) == recover_segment_host segment by segment == the
    reference's recover_all."""
    cfg = TABLES[mode][0]
    ref, port = _pair(mode, filled[mode][0])
    kw = dict(CRASH, interrupt_smo=interrupt)
    ref.crash(np.random.default_rng(23), **kw)
    port.crash(np.random.default_rng(23), **kw)
    ref.restart()
    port.restart()
    loop = interop.state_from_numpy(port_cfg(cfg), interop.state_to_numpy(port.state), "cpu")
    for seg in range(int(loop.watermark)):
        loop = trec.recover_segment_host(port_cfg(cfg), mode, loop, seg)
    whole = trec.recover_all(port_cfg(cfg), mode, port.state)
    ref_state = rrec.recover_all(cfg, mode, ref.state)
    assert_same_state(ref_state, whole, "set form")
    assert_same_state(ref_state, loop, "per segment")
    assert int(te.recount_items(whole)) == int(whole.n_items) == 1100


@pytest.mark.parametrize("mode,interrupt", [("eh", True), ("lh", False)])
def test_lazy_recovery_through_search(filled, mode, interrupt):
    """crash -> restart -> reads recover exactly the touched dirty
    segments (an interrupted split is continued) -> inserts of live keys
    answer EXISTS; the reference's states, answers and counts throughout."""
    _, keys, vals = filled[mode]
    ref, port = _pair(mode, filled[mode][0])
    kw = dict(CRASH, interrupt_smo=interrupt)
    ref.crash(np.random.default_rng(29), **kw)
    port.crash(np.random.default_rng(29), **kw)
    ref.restart()
    port.restart()
    for q in (keys[:40], keys[:700], keys):    # fused, fingerprint, rest
        f_r, v_r = ref.search(q)
        f_p, v_p = port.search(q)
        np.testing.assert_array_equal(f_p, np.asarray(f_r))
        np.testing.assert_array_equal(v_p, np.asarray(v_r))
        assert_same_state(ref.state, port.state, q.size)
        assert port.recovered_segments == ref.recovered_segments > 0
    assert f_p.all() and (v_p == vals).all()
    assert (port.state.seg_state.numpy() == layout.SEG_NORMAL).all()
    assert port.n_items == int(te.recount_items(port.state)) == keys.size
    np.testing.assert_array_equal(port.insert(keys[:64], vals[:64]),
                                  np.asarray(ref.insert(keys[:64], vals[:64])))
    assert (port.insert(keys[64:128], vals[64:128]) == EXISTS).all()
    ref.insert(keys[64:128], vals[64:128])
    assert_same_state(ref.state, port.state)


def test_lazy_recovery_rolls_back_orphan_split(filled):
    """A SPLITTING segment whose side-link is not NEW rolls back: state
    NORMAL, local depth one lower, its records untouched."""
    ref, port = _pair("eh", filled["eh"][0])
    ref.crash(np.random.default_rng(31), **dict(CRASH, interrupt_smo=True))
    port.crash(np.random.default_rng(31), **dict(CRASH, interrupt_smo=True))
    new = int(np.nonzero(port.state.seg_state.numpy() == layout.SEG_NEW)[0][0])
    ref.state = ref.state._replace(seg_state=ref.state.seg_state.at[new].set(0))
    port.state.seg_state[new] = 0
    ref.restart()
    port.restart()
    _, keys, vals = filled["eh"]
    f_r, _ = ref.search(keys)
    f_p, v_p = port.search(keys)
    np.testing.assert_array_equal(f_p, np.asarray(f_r))
    assert_same_state(ref.state, port.state)
    assert f_p.all() and (v_p == vals).all()


@pytest.mark.parametrize("mode", ["eh", "lh"])
def test_clean_shutdown_skips_recovery(filled, mode):
    _, keys, vals = filled[mode]
    ref, port = _pair(mode, filled[mode][0])
    port.graceful_shutdown()
    assert port.restart()["clean"]
    f, v = port.search(keys)
    assert f.all() and (v == vals).all() and port.recovered_segments == 0
    assert_same_state(ref.state._replace(clean=jnp.asarray(False)), port.state)


def test_bulk_split_crash_recovery():
    """The bulk-split crash case of tests/test_smo.py: phase 1 committed for
    K segments, phase 2 lost; lazy recovery finishes every split through
    the uniqueness-checked rebuild, in both packages alike."""
    cfg = DashConfig(max_segments=64, dir_depth_max=10, num_buckets=16, num_slots=8)
    keys, vals = unique_keys(np.random.default_rng(0), 1000), np.arange(1000, dtype=np.uint32)
    ref, port = DashEH(cfg), TDashEH(port_cfg(cfg), device="cpu")
    ref.insert(keys, vals)
    port.insert(keys, vals)
    wm = port.n_segments
    depths = port.state.local_depth.numpy()
    segs = [int(s) for s in np.unique(port.state.dir.numpy())
            if depths[s] < cfg.dir_depth_max][:3]
    assert len(segs) >= 2
    news = list(range(wm, wm + len(segs)))
    ref.state = rsmo.bulk_split_phase1(cfg, ref.state, jnp.asarray(segs, jnp.int32),
                                       jnp.asarray(news, jnp.int32),
                                       jnp.ones(len(segs), jnp.bool_))
    tsmo.bulk_split_phase1(port_cfg(cfg), port.state, torch.tensor(segs),
                           torch.tensor(news), torch.ones(len(segs), dtype=torch.bool))
    assert_same_state(ref.state, port.state, "phase 1")
    for t in (ref, port):
        t.crash(np.random.default_rng(5), lock_frac=0.1, n_dups=5, wipe_overflow=True)
        t.restart()
    f_r, _ = ref.search(keys)
    f, v = port.search(keys)
    np.testing.assert_array_equal(f, np.asarray(f_r))
    assert_same_state(ref.state, port.state, "recovered")
    assert f.all() and (v == vals).all()
    assert (port.state.seg_state.numpy() == layout.SEG_NORMAL).all()
    assert port.n_items == 1000 == int(te.recount_items(port.state))
    assert (port.insert(keys[:64], vals[:64]) == EXISTS).all()
    dirv, dp = port.state.dir.numpy(), port.state.local_depth.numpy()
    for seg in np.unique(dirv):
        e = np.nonzero(dirv == seg)[0]
        assert e.size == 1 << (cfg.dir_depth_max - dp[seg])
        assert (np.diff(e) == 1).all()
