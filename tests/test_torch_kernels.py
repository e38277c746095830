"""Port parity: each CUDA kernel's plain PyTorch version against the Pallas
TPU kernel it replaces (run in interpret mode, as the JAX package's own
tests run it on the CPU) and that kernel's jnp oracle. Exact equality: the
kernels are all integer. The CUDA kernels themselves are held against these
plain versions on the card by ``chip_smoke.py``; no CUDA tensor is used here.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import DashConfig, DashEH, engine, hashing, layout
from repro.kernels import fused as rfused
from repro.kernels import ops as rops
from repro.kernels import ref
from repro.kernels.hashmix import BLOCK, bulk_hash
from repro.kernels.probe import fingerprint_probe
from repro_torch.kernels import fused as tfused
from repro_torch.kernels import hashmix as thash
from repro_torch.kernels import probe as tprobe
from tests.conftest import unique_keys
from tests.torch_parity import to_port, words

EDGE = np.array([0, 1, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFF], dtype=np.uint32)


def _flat(x):
    return words(np.asarray(x).reshape(-1).astype(np.int64).astype(np.uint32))


@pytest.mark.parametrize("n", [4 * BLOCK, 3 * BLOCK + 517])
def test_bulk_hash_plain_matches_pallas(n):
    rng = np.random.default_rng(n)
    hi = rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
    lo = rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
    hi[:EDGE.size], lo[:EDGE.size] = EDGE, EDGE[::-1]
    got = thash.bulk_hash_plain(words(hi), words(lo))
    want = ref.bulk_hash_ref(jnp.asarray(hi), jnp.asarray(lo))
    pad = (-n) % BLOCK       # the Pallas kernel takes whole BLOCKs only
    kern = bulk_hash(jnp.asarray(np.pad(hi, (0, pad))),
                     jnp.asarray(np.pad(lo, (0, pad))), interpret=True)
    for g, w, k in zip(got, want, kern):
        g = g.numpy()
        np.testing.assert_array_equal(g, np.asarray(w).view(g.dtype))
        np.testing.assert_array_equal(g, np.asarray(k)[:n].view(g.dtype))
    assert (np.asarray(want[0]) >= 2**31).any()
    # the wrapper takes the plain version on CPU tensors and launches nothing
    before = thash.LAUNCHES
    for g, w in zip(thash.bulk_hash(words(hi), words(lo)), got):
        assert torch.equal(g, w)
    assert thash.LAUNCHES == before and isinstance(before, int)


def test_fingerprint_probe_plain_matches_pallas(rng):
    cfg = DashConfig(max_segments=8, dir_depth_max=7)
    t = DashEH(cfg)
    keys = unique_keys(rng, 1200)
    t.insert(keys, np.arange(1200, dtype=np.uint32))
    fp_pad, alloc = rops.plane_views(cfg, t.state)
    probe_keys = np.concatenate([keys[:200], unique_keys(rng, 56)])
    hi, lo = hashing.np_split_keys(probe_keys)
    qf, qb, qpb, _, _ = rops.route_queries(cfg, t.state, jnp.asarray(hi),
                                           jnp.asarray(lo), 128)
    # out-of-table bucket rows on some padding lanes: the reference reads
    # its zero padding rows there (bits 0, free 0x3FFF)
    qb = np.asarray(qb).copy()
    pad_lanes = np.argwhere(qb < 0)[:5]
    qb[tuple(pad_lanes.T)] = cfg.buckets_total + np.arange(len(pad_lanes))
    qb = jnp.asarray(qb)
    assert (np.asarray(qb) < 0).any()                     # padding lanes remain
    want = ref.fingerprint_probe_ref(fp_pad, alloc, qf, qb, qpb)
    kern = fingerprint_probe(fp_pad, alloc, qf, qb, qpb, interpret=True)

    st = to_port(cfg, t.state)
    S, C = qf.shape
    q_seg = torch.arange(S, dtype=torch.int32)[:, None].expand(S, C).reshape(-1)
    args = (st.fp, st.meta, q_seg.contiguous(), _flat(qf), _flat(qb), _flat(qpb))
    got = tprobe.fingerprint_probe_plain(*args)
    before = tprobe.LAUNCHES
    via_wrapper = tprobe.fingerprint_probe(*args)
    assert tprobe.LAUNCHES == before
    for g, w, k, v in zip(got, want, kern, via_wrapper):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w).reshape(-1))
        np.testing.assert_array_equal(g.numpy(), np.asarray(k).reshape(-1))
        assert torch.equal(g, v)
    assert (got[0].numpy() != 0).any()


def test_fused_probe_plain_matches_pallas():
    """Default geometry filled into two segments far enough that records
    overflow into the stash; the queries include stash-resident keys."""
    cfg = DashConfig(max_segments=8, dir_depth_max=6)
    rng = np.random.default_rng(0xF00D)
    keys = unique_keys(rng, 1700)
    hi, lo = hashing.np_split_keys(keys)
    state = layout.make_state(cfg, "eh")
    state, statuses, _ = engine.insert_batch(
        cfg, "eh", state, jnp.asarray(hi), jnp.asarray(lo),
        jnp.asarray(np.arange(1700, dtype=np.uint32) + 7), batching="scan")
    placed = np.asarray(statuses) == layout.INSERTED
    st = to_port(cfg, state)
    NB, ns = cfg.num_buckets, cfg.num_stash
    stash_hi = st.key_hi[:2, NB:NB + ns].reshape(-1).numpy().view(np.uint32)
    in_stash = np.isin(hi, stash_hi) & placed
    assert in_stash.sum() > 0
    pick = np.concatenate([np.nonzero(in_stash)[0][:64], np.arange(128)])
    miss_hi, miss_lo = hashing.np_split_keys(unique_keys(np.random.default_rng(9), 64))
    qhi = jnp.asarray(np.concatenate([hi[pick], miss_hi]))
    qlo = jnp.asarray(np.concatenate([lo[pick], miss_lo]))

    h2 = hashing.hash2(qhi, qlo)
    seg, b = rops.locate_batch(cfg, "eh", state, hashing.hash1(qhi, qlo))
    fpv = (h2 & jnp.uint32(0xFF)).astype(jnp.int32)
    lanes, src, keep = rops.route_lanes(
        seg, (fpv, b.astype(jnp.int32), qhi, qlo, seg >= 0),
        cfg.max_segments, 256, (0, -1, 0, 0, False))
    q_fp, q_b, q_hi, q_lo, q_valid = lanes
    q_b = jnp.where(q_valid, q_b, -1)
    q_pb = jnp.where(q_valid, (q_b + 1) & (NB - 1), -1)
    q_fp = jnp.where(q_valid, q_fp, -1)
    planes = rfused.fused_plane_views(
        cfg, state, jnp.arange(cfg.max_segments, dtype=jnp.int32))
    f_k, v_k = rfused.fused_probe(planes, q_fp, q_b, q_pb, q_hi, q_lo,
                                  nb=NB, ns=ns, interpret=True)
    f_j, v_j = rfused.fused_probe_jnp(planes, q_fp, q_b, q_pb, q_hi, q_lo,
                                      nb=NB, ns=ns)

    S, C = q_fp.shape
    q_seg = torch.arange(S, dtype=torch.int32)[:, None].expand(S, C).reshape(-1)
    args = (st.fp, st.meta, st.key_hi, st.key_lo, st.val, st.stash_active,
            q_seg.contiguous(), _flat(q_fp), _flat(q_b), _flat(q_pb),
            _flat(q_hi), _flat(q_lo))
    kw = dict(nb=NB, ns=ns, use_fp=cfg.use_fingerprints)
    f_p, v_p = tfused.fused_probe_plain(*args, **kw)
    before = tfused.LAUNCHES
    f_w, v_w = tfused.fused_probe(*args, **kw)
    assert tfused.LAUNCHES == before
    assert torch.equal(f_p, f_w) and torch.equal(v_p, v_w)
    for f_r, v_r in ((f_k, v_k), (f_j, v_j)):
        np.testing.assert_array_equal(f_p.numpy(), np.asarray(f_r).reshape(-1))
        np.testing.assert_array_equal(v_p.numpy().view(np.uint32),
                                      np.asarray(v_r).reshape(-1))
    # stash hits occurred: every stash-resident query was found
    hit = np.zeros(qhi.shape[0], bool)
    srcf = np.asarray(src).reshape(-1)
    hit[srcf[srcf >= 0]] = f_p.numpy()[srcf >= 0] != 0
    n_st = int(in_stash.sum().clip(max=64))
    assert hit[:n_st].all() and hit[:n_st + 128].sum() == n_st + 128
    assert not hit[n_st + 128:].any()


def test_wrappers_check_their_inputs():
    z = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(TypeError):
        thash.bulk_hash(z.long(), z.long())
    with pytest.raises(ValueError):
        thash.bulk_hash(z, torch.zeros(5, dtype=torch.int32))
    with pytest.raises(ValueError):
        thash.bulk_hash(torch.zeros(8, dtype=torch.int32)[::2], z)
    fp = torch.zeros((2, 4, 16), dtype=torch.uint8)
    with pytest.raises(ValueError):
        tprobe.fingerprint_probe(fp, torch.zeros((2, 5), dtype=torch.int32),
                                 z, z, z, z)
    with pytest.raises(TypeError):
        tprobe.fingerprint_probe(fp.int(), torch.zeros((2, 4), dtype=torch.int32),
                                 z, z, z, z)


def _per_position(src, planes, n):
    """Routed lane planes -> per-batch-position arrays (lanes with src < 0
    dropped)."""
    src = np.asarray(src).reshape(-1)
    out = []
    for p in planes:
        a = np.zeros(n, np.int64)
        a[src[src >= 0]] = np.asarray(p).reshape(-1)[src >= 0]
        out.append(a)
    return out


def test_routed_reads_and_write_hints_match_reference(rng):
    """``ops.probe_routed`` (the (S, C) routed read through the fingerprint
    kernel) and ``ops.route_writes(with_hints=True)`` against the
    reference's, per batch position."""
    from repro_torch.kernels import ops as tops
    from tests.torch_parity import port_cfg
    cfg = DashConfig(max_segments=16, dir_depth_max=8)
    t = DashEH(cfg)
    keys = unique_keys(rng, 4000)
    t.insert(keys, np.arange(4000, dtype=np.uint32))
    st = to_port(cfg, t.state)
    q = np.concatenate([keys[:448], unique_keys(np.random.default_rng(12), 64)])
    hi, lo = hashing.np_split_keys(q)
    for cap in (64, 256):           # 64 drops some lanes (keep = False)
        f_r, v_r, k_r = rops.probe_routed(cfg, t.state, jnp.asarray(hi),
                                          jnp.asarray(lo), capacity=cap)
        f_p, v_p, k_p = tops.probe_routed(port_cfg(cfg), st, words(hi), words(lo),
                                          capacity=cap)
        np.testing.assert_array_equal(k_p.numpy(), np.asarray(k_r))
        np.testing.assert_array_equal(f_p.numpy(), np.asarray(f_r))
        np.testing.assert_array_equal(v_p.numpy().view(np.uint32), np.asarray(v_r))
        assert np.asarray(k_r).all() == (cap == 256)

    n = 256
    payload_r = (jnp.asarray(hi[:n]), jnp.asarray(lo[:n]), jnp.zeros(n, jnp.uint32),
                 jnp.zeros((n, cfg.key_heap_words), jnp.uint32), jnp.ones(n, jnp.bool_))
    _, src_r, keep_r, hints_r = rops.route_writes(cfg, "eh", t.state, payload_r, 128, True)
    payload_p = (words(hi[:n]), words(lo[:n]), torch.zeros(n, dtype=torch.int32),
                 torch.ones(n, dtype=torch.bool))
    lanes, src_p, keep_p, hints_p = tops.route_writes(port_cfg(cfg), "eh", st,
                                                      payload_p, 128, True)
    np.testing.assert_array_equal(keep_p.numpy(), np.asarray(keep_r))
    for a, b in zip(_per_position(src_p, hints_p, n), _per_position(src_r, hints_r, n)):
        np.testing.assert_array_equal(a, b)
    assert lanes["seg"].shape[0] <= cfg.max_segments
