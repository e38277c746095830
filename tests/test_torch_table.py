"""Port parity: bulk splits and the DashEH table.

``bulk_split`` (and the scan-rehash split) must give the reference's
planes on the same state, directory, local depths and split counters
included; a DashEH filled through both packages past eight segments must
end byte-identical; the README quickstart must run against
``repro_torch.core`` on the CPU; and a table asked for no device on a
machine without a card must refuse rather than fall back.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import DashConfig, DashEH, dash_eh as rdash_eh, engine as re_, hashing
from repro.core import layout, smo as rsmo
from repro_torch.core import DashConfig as TDashConfig, DashEH as TDashEH
from repro_torch.core import dash_eh as tdash_eh, engine as te, smo as tsmo
from tests.conftest import unique_keys
from tests.torch_parity import assert_same_state, port_cfg, to_port


def _filled(cfg, n, seed):
    """A reference state with ``n`` keys scanned into its initial segments."""
    hi, lo = hashing.np_split_keys(unique_keys(np.random.default_rng(seed), n))
    state = layout.make_state(cfg, "eh")
    state, _, _ = re_.insert_batch(cfg, "eh", state, jnp.asarray(hi), jnp.asarray(lo),
                                   jnp.asarray(np.arange(n, dtype=np.uint32)),
                                   batching="scan")
    return state


@pytest.mark.parametrize("cfg,n", [
    (DashConfig(max_segments=16, dir_depth_max=6, init_depth=2), 2400),
    (DashConfig(max_segments=16, dir_depth_max=6, init_depth=2, num_buckets=16,
                num_slots=8), 400),
])
def test_bulk_split_matches_reference(cfg, n):
    ref = _filled(cfg, n, 1)
    port = to_port(cfg, ref)
    old, new = [0, 2, 3], [4, 5, 6]          # local depth 2 -> 3, one doubling
    ref, k_ref = rsmo.bulk_split(cfg, ref, old, new)
    port, k_port = tsmo.bulk_split(port_cfg(cfg), port, old, new)
    assert k_ref == k_port == 3
    assert_same_state(ref, port)
    assert int(port.n_splits) == 3 and int(port.n_doublings) == 1
    # a second round splitting an already-split segment and its new buddy
    ref, _ = rsmo.bulk_split(cfg, ref, [0, 4], [7, 8])
    port, _ = tsmo.bulk_split(port_cfg(cfg), port, [0, 4], [7, 8])
    assert_same_state(ref, port)


def test_scan_split_matches_reference():
    """The per-record rehash (fallback for infeasible rebuilds)."""
    cfg = DashConfig(max_segments=8, dir_depth_max=6, num_buckets=16, num_slots=8)
    ref = _filled(cfg, 240, 2)
    port = to_port(cfg, ref)
    ref, ok_ref = rdash_eh.split_segment(cfg, ref, 1, impl="scan")
    port, ok = tdash_eh.split_segment(port_cfg(cfg), port, 1, impl="scan")
    assert bool(ok_ref) and ok
    assert_same_state(ref, port)
    ref, _ = rdash_eh.split_segment(cfg, ref, 0)
    port, _ = tdash_eh.split_segment(port_cfg(cfg), port, 0)
    assert_same_state(ref, port)


@pytest.mark.parametrize("smo_mode", ["bulk", "scalar"])
def test_dash_eh_fill_matches_reference(smo_mode):
    """Batches of both write plans (fused <= 1024 keys, segment-parallel)
    with splits in between, then deletes, updates and reads."""
    cfg = DashConfig(max_segments=32, dir_depth_max=8, num_buckets=16, num_slots=8)
    keys = unique_keys(np.random.default_rng(3), 1600)
    vals = np.random.default_rng(4).integers(0, 2**32, 1600, dtype=np.uint64
                                             ).astype(np.uint32)
    ref = DashEH(cfg, smo_mode=smo_mode)
    port = TDashEH(port_cfg(cfg), device="cpu", smo_mode=smo_mode)
    for lo_i, hi_i in ((0, 200), (200, 1600)):
        s_ref = ref.insert(keys[lo_i:hi_i], vals[lo_i:hi_i])
        s_port = port.insert(keys[lo_i:hi_i], vals[lo_i:hi_i])
        np.testing.assert_array_equal(s_port, s_ref)
        assert_same_state(ref.state, port.state, (lo_i, hi_i))
    assert port.n_segments >= 8 and port.global_depth == ref.global_depth
    np.testing.assert_array_equal(port.delete(keys[::7]), ref.delete(keys[::7]))
    np.testing.assert_array_equal(port.update(keys[1::5], vals[::5]),
                                  ref.update(keys[1::5], vals[::5]))
    assert_same_state(ref.state, port.state)
    for q in (keys[:300], keys):                # fused and fingerprint plans
        f_r, v_r = ref.search(q)
        f_p, v_p = port.search(q)
        np.testing.assert_array_equal(f_p, np.asarray(f_r))
        np.testing.assert_array_equal(v_p, np.asarray(v_r))
    assert port.n_items == int(te.recount_items(port.state))
    assert port.dirty.any and port.dirty.drain().dir


def test_readme_quickstart_on_cpu():
    t = TDashEH(TDashConfig(), device="cpu")
    keys = np.unique(np.random.default_rng(0).integers(1, 2**63, 5000, np.uint64))
    t.insert(keys, np.arange(keys.size, dtype=np.uint32))
    found, vals = t.search(keys)
    assert found.all()
    assert (vals == np.arange(keys.size, dtype=np.uint32)).all()


def test_dash_eh_needs_a_device_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TDashEH(TDashConfig())
