"""Hostile-input parity of the two read kernels' plain versions.

``repro_torch.kernels.edges.read_kernel_edges`` builds small seeded planes
and lanes aimed at every rule the kernels keep (first-hit order across rows
and slots, fingerprint collisions, the stash gate at 0, 1 and ``ns`` active
rows, negative and out-of-table rows, out-of-range segment ids). Here the
plain versions, and the wrappers on CPU tensors, are held exactly against
the JAX package on those inputs: ``fused_probe`` against the Pallas kernel
(interpret mode) and its jnp oracle over ``fused_plane_views``,
``fingerprint_probe`` against the Pallas kernel and its oracle over
``plane_views``. The CUDA kernels meet the same inputs on the card in
``chip_smoke.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import DashConfig, layout
from repro.kernels import fused as rfused
from repro.kernels import ops as rops
from repro.kernels import ref
from repro.kernels.probe import fingerprint_probe
from repro_torch.kernels import edges
from repro_torch.kernels import fused as tfused
from repro_torch.kernels import probe as tprobe

S, NB, SEED = 4, 64, 12


def _reference(case, use_fp=True):
    """(cfg, state, routed (S, C) lanes) of the reference for ``case``. A
    lane with a segment id outside [0, S) becomes a padding lane (q_b = q_pb
    = -1), and with fingerprints off the reference's zeroed fp plane is met
    with zero query bytes."""
    cfg = DashConfig(max_segments=S, num_buckets=NB, num_stash=case["ns"],
                     dir_depth_max=4, use_fingerprints=use_fp)
    state = layout.make_state(cfg, "eh")._replace(**{
        k: jnp.asarray(case[k])
        for k in ("fp", "meta", "key_hi", "key_lo", "val", "stash_active")})
    pad = (case["q_seg"] < 0) | (case["q_seg"] >= S)
    q_fp = case["q_fp"] if use_fp else np.zeros_like(case["q_fp"])
    lanes = [q_fp, np.where(pad, -1, case["q_b"]), np.where(pad, -1, case["q_pb"]),
             case["q_hi"], case["q_lo"]]
    return cfg, state, [jnp.asarray(a.reshape(S, case["cap"])) for a in lanes]


def _kinds(case, *names):
    return np.isin(case["kind"], [edges.KINDS.index(k) for k in names])


@pytest.mark.parametrize("ns", [2, 4])
def test_edges_plant_every_case(ns):
    case = edges.read_kernel_edges(SEED, segments=S, ns=ns)
    counts = np.bincount(case["kind"], minlength=len(edges.KINDS))
    assert (counts >= S).all(), dict(zip(edges.KINDS, counts))
    assert sorted(set(case["stash_active"])) == sorted({0, 1, ns})
    assert ((case["q_seg"] == -1).any() and (case["q_seg"] == S).any()
            and (case["q_b"] >= NB + ns).any() and (case["q_pb"] < 0).any())
    again = edges.read_kernel_edges(SEED, segments=S, ns=ns)
    assert all(np.array_equal(case[k], again[k]) for k in case if isinstance(case[k], np.ndarray))


@pytest.mark.parametrize("use_fp", [True, False], ids=["fp", "no_fp"])
def test_fused_probe_edges_match_reference(use_fp):
    case = edges.read_kernel_edges(SEED, segments=S, ns=2)
    cfg, state, lanes = _reference(case, use_fp)
    planes = rfused.fused_plane_views(cfg, state, jnp.arange(S, dtype=jnp.int32))
    f_k, v_k = rfused.fused_probe(planes, *lanes, nb=NB, ns=2, interpret=True)
    f_j, v_j = rfused.fused_probe_jnp(planes, *lanes, nb=NB, ns=2)

    p_planes, p_lanes = edges.to_torch(case, "cpu")
    kw = dict(nb=NB, ns=2, use_fp=use_fp)
    f, v = tfused.fused_probe_plain(*p_planes, *p_lanes, **kw)
    before = tfused.LAUNCHES
    f_w, v_w = tfused.fused_probe(*p_planes, *p_lanes, **kw)
    assert tfused.LAUNCHES == before
    assert torch.equal(f, f_w) and torch.equal(v, v_w)
    f, v = f.numpy(), v.numpy().view(np.uint32)

    np.testing.assert_array_equal(f, np.asarray(f_j).reshape(-1))
    np.testing.assert_array_equal(v, np.asarray(v_j).reshape(-1))
    # A negative q_pb on a live lane reads row 0 in the jnp oracle (a clipped
    # gather) and in the port; the Pallas kernel's one-hot gather of row -1
    # reads nothing. The routed read never makes such a lane (q_pb < 0 only
    # with q_b < 0), so the two reference versions agree on every lane the
    # reference itself produces.
    neg_pb = _kinds(case, "pb_negative")
    f_k, v_k = np.asarray(f_k).reshape(-1), np.asarray(v_k).reshape(-1)
    np.testing.assert_array_equal(f[~neg_pb], f_k[~neg_pb])
    np.testing.assert_array_equal(v[~neg_pb], v_k[~neg_pb])
    assert not f_k[neg_pb].any()

    found_all = _kinds(case, "b_and_pb", "pb_and_stash1", "twice_in_b",
                       "pb_negative", "b_past_bt")
    found_none = _kinds(case, "seg_negative", "seg_past_end", "b_negative",
                        "alloc_cleared")
    assert f[found_all].all() and not f[found_none].any()
    assert f[_kinds(case, "fp_collision")].all() != use_fp
    stash1 = _kinds(case, "stash1_only")
    active = case["stash_active"][case["q_seg"].clip(0, S - 1)]
    np.testing.assert_array_equal(f[stash1], active[stash1] >= 2)


def test_fused_probe_edges_more_stash_rows():
    """ns = 4: the kernel's second group of candidate rows."""
    case = edges.read_kernel_edges(SEED + 1, segments=S, ns=4)
    cfg, state, lanes = _reference(case)
    planes = rfused.fused_plane_views(cfg, state, jnp.arange(S, dtype=jnp.int32))
    f_j, v_j = rfused.fused_probe_jnp(planes, *lanes, nb=NB, ns=4)
    f, v = tfused.fused_probe(*sum(edges.to_torch(case, "cpu"), ()), nb=NB, ns=4,
                              use_fp=True)
    np.testing.assert_array_equal(f.numpy(), np.asarray(f_j).reshape(-1))
    np.testing.assert_array_equal(v.numpy().view(np.uint32), np.asarray(v_j).reshape(-1))
    assert f.numpy()[_kinds(case, "pb_and_stash1")].all()


def test_fingerprint_probe_edges_match_reference():
    case = edges.read_kernel_edges(SEED, segments=S, ns=2)
    cfg, state, (q_fp, q_b, q_pb, _, _) = _reference(case)
    fp_pad, alloc = rops.plane_views(cfg, state)
    want = ref.fingerprint_probe_ref(fp_pad, alloc, q_fp, q_b, q_pb)
    kern = fingerprint_probe(fp_pad, alloc, q_fp, q_b, q_pb, interpret=True)

    (fp, meta, *_), (q_seg, p_fp, p_b, p_pb, _, _) = edges.to_torch(case, "cpu")
    got = tprobe.fingerprint_probe_plain(fp, meta, q_seg, p_fp, p_b, p_pb)
    before = tprobe.LAUNCHES
    via_wrapper = tprobe.fingerprint_probe(fp, meta, q_seg, p_fp, p_b, p_pb)
    assert tprobe.LAUNCHES == before
    for g, w, k, x in zip(got, want, kern, via_wrapper):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w).reshape(-1))
        np.testing.assert_array_equal(g.numpy(), np.asarray(k).reshape(-1))
        assert torch.equal(g, x)
    past = (case["q_b"] >= NB + 2) & (case["q_seg"] >= 0) & (case["q_seg"] < S)
    assert (got[2].numpy()[past] == 0x3FFF).all() and not got[0].numpy()[past].any()
    assert (got[0].numpy() != 0).any() and (got[1].numpy() != 0).any()


def test_fused_probe_wrapper_checks_planes_and_lanes():
    case = edges.read_kernel_edges(SEED, segments=S, ns=2)
    planes, lanes = edges.to_torch(case, "cpu")
    kw = dict(nb=NB, ns=2, use_fp=True)
    f, _ = tfused.fused_probe(*planes, *lanes, **kw)
    assert f.shape == (S * case["cap"],)
    bad_planes = [
        (TypeError, (planes[0].int(),) + planes[1:]),
        (ValueError, planes[:1] + (planes[1][:, :-1],) + planes[2:]),
        (ValueError, planes[:4] + (planes[4][:2],) + planes[5:]),
        (ValueError, planes[:2] + (planes[2].transpose(0, 2).contiguous().transpose(0, 2),)
         + planes[3:]),
    ]
    for exc, ps in bad_planes:
        with pytest.raises(exc):
            tfused.fused_probe(*ps, *lanes, **kw)
    with pytest.raises(ValueError):                       # stash rows past BT
        tfused.fused_probe(*planes, *lanes, nb=NB, ns=3, use_fp=True)
    bad_lanes = [
        (TypeError, (lanes[0].long(),) + lanes[1:]),
        (ValueError, lanes[:3] + (lanes[3][:-1],) + lanes[4:]),
        (ValueError, lanes[:5] + (lanes[5].repeat(2)[::2],)),
    ]
    for exc, ls in bad_lanes:
        with pytest.raises(exc):
            tfused.fused_probe(*planes, *ls, **kw)
    # the checks are remembered per plane set, and a changed plane is checked anew
    f2, _ = tfused.fused_probe(*planes, *lanes, **kw)
    assert torch.equal(f, f2)
    with pytest.raises(ValueError):
        tfused.fused_probe(*planes[:5], planes[5][:-1].contiguous(), *lanes, **kw)
