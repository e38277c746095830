"""Port parity: buddy merges and ``DashEH.shrink`` against the JAX package.

``find_buddy_pairs``/``find_buddy`` must name the reference's pairs; the
bulk merge and the scan merge must give the reference's planes on one
state (directory, local depths, side links and the cleared victim's
version bump included); delete-heavy streams followed by ``shrink`` must
give the reference's state, merge count and free list; and refills must
recycle the freed ids exactly as the reference does.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import DashConfig, DashEH, dash_eh as rdash_eh, smo as rsmo
from repro_torch.core import DashEH as TDashEH, dash_eh as tdash_eh, engine as te
from repro_torch.core import smo as tsmo
from tests.conftest import unique_keys
from tests.torch_parity import assert_same_state, port_cfg, ref_copy, to_port

CFG = DashConfig(max_segments=64, dir_depth_max=8, num_buckets=16, num_slots=8)


@pytest.fixture(scope="module")
def grown():
    """A reference table grown past 16 segments, then thinned by deletes."""
    keys = unique_keys(np.random.default_rng(41), 2400)
    vals = np.arange(keys.size, dtype=np.uint32)
    ref = DashEH(CFG)
    ref.insert(keys, vals)
    ref.delete(keys[::5][:300])
    assert ref.n_segments >= 16
    return ref.state, keys, vals


def test_find_buddy_pairs_matches_reference(grown):
    state = grown[0]
    port = to_port(CFG, state)
    dirv, depths = np.asarray(state.dir), np.asarray(state.local_depth)
    pairs = tsmo.find_buddy_pairs(port_cfg(CFG), port.dir.numpy(), port.local_depth.numpy())
    np.testing.assert_array_equal(pairs, rsmo.find_buddy_pairs(CFG, dirv, depths))
    assert pairs.shape[0] >= 4
    for seg in np.unique(dirv):
        assert tdash_eh.find_buddy(port_cfg(CFG), port, int(seg)) == \
            rdash_eh.find_buddy(CFG, state, int(seg))


def _bulk_merge_all(ref, port):
    """Merge every buddy pair of both states at once (plus one padding
    lane, as the reference's fixed chunks carry). Returns ok (K,)."""
    pairs = rsmo.find_buddy_pairs(CFG, np.asarray(ref.dir), np.asarray(ref.local_depth))
    kp = np.append(pairs[:, 0], -1).astype(np.int32)
    vp = np.append(pairs[:, 1], -1).astype(np.int32)
    valid = np.arange(kp.size) < pairs.shape[0]
    ref, ok_r = rsmo.bulk_merge(CFG, ref, jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(valid))
    port, ok_p = tsmo.bulk_merge(port_cfg(CFG), port, torch.from_numpy(kp),
                                 torch.from_numpy(vp), torch.from_numpy(valid))
    np.testing.assert_array_equal(ok_p.numpy(), np.asarray(ok_r))
    assert_same_state(ref, port, "bulk")
    return ref, port, ok_p.numpy()[:-1]


def test_bulk_merge_matches_reference(grown):
    """All buddy pairs merged at once on the grown table (pairs too full
    for one segment stay uncommitted), then on a thinned copy: all pairs
    at once, one scan merge and one rebuild merge of the next level."""
    pc = port_cfg(CFG)
    ref = ref_copy(grown[0])
    _, _, ok = _bulk_merge_all(ref, to_port(CFG, ref))
    assert ok.any() and not ok.all()
    thin = DashEH(CFG, state=ref_copy(grown[0]))
    thin.delete(grown[1][:1700])
    ref, port = thin.state, to_port(CFG, thin.state)
    pairs = rsmo.find_buddy_pairs(CFG, np.asarray(ref.dir), np.asarray(ref.local_depth))
    records = {int(k): tsmo.segment_record_set(pc, port, int(k))
               + tsmo.segment_record_set(pc, port, int(v)) for k, v in pairs}
    ref, port, ok = _bulk_merge_all(ref, port)
    assert ok.all()
    for k in pairs[:, 0]:
        assert tsmo.segment_record_set(pc, port, int(k)) == sorted(records[int(k)])
    pairs = rsmo.find_buddy_pairs(CFG, np.asarray(ref.dir), np.asarray(ref.local_depth))
    assert pairs.shape[0] >= 2
    ref, ok_r = rdash_eh.merge_segments_scan(CFG, ref, int(pairs[0, 0]), int(pairs[0, 1]))
    port, ok_p = tdash_eh.merge_segments_scan(pc, port, int(pairs[0, 0]), int(pairs[0, 1]))
    assert bool(ok_r) and ok_p
    assert_same_state(ref, port, "scan")
    ref, _ = rdash_eh.merge_segments(CFG, ref, int(pairs[1, 1]), int(pairs[1, 0]))
    port, _ = tdash_eh.merge_segments(pc, port, int(pairs[1, 1]), int(pairs[1, 0]))
    assert_same_state(ref, port, "rebuild")
    assert int(te.recount_items(port)) == int(port.n_items)


@pytest.mark.parametrize("smo_mode", ["bulk", "scalar"])
def test_shrink_then_refill_matches_reference(grown, smo_mode):
    """80 % deletes, shrink (bulk: one call per round; the reference: chunks
    of 8 pairs), then refills that split into recycled ids."""
    state, keys, vals = grown
    ref = DashEH(CFG, smo_mode=smo_mode, state=ref_copy(state))
    port = TDashEH(port_cfg(CFG), smo_mode=smo_mode, state=to_port(CFG, state))
    gone = keys[: int(keys.size * 0.8)]
    np.testing.assert_array_equal(port.delete(gone), np.asarray(ref.delete(gone)))
    before = port.n_segments
    m_ref, m_port = ref.shrink(), port.shrink()
    assert m_port == m_ref > 8
    assert port.free_segments == ref.free_segments
    assert_same_state(ref.state, port.state, "shrink")
    assert port.global_depth == ref.global_depth
    live = keys[int(keys.size * 0.8):]
    f, v = port.search(live)
    assert f.all() and (v == vals[int(keys.size * 0.8):]).all()
    assert not port.search(gone[::4])[0].any()
    fresh = np.setdiff1d(unique_keys(np.random.default_rng(43), 1500), keys)[:1400]
    np.testing.assert_array_equal(port.insert(fresh, vals[:1400]),
                                  np.asarray(ref.insert(fresh, vals[:1400])))
    assert port.free_segments == ref.free_segments
    assert_same_state(ref.state, port.state, "refill")
    assert port.n_segments == before            # the splits took recycled ids
    assert port.n_items == int(te.recount_items(port.state))
