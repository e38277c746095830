"""Port parity: the batched engines over the feature-flag matrix.

Every write engine of the port (``scan``, ``segment``, ``fused``) must give
the reference scan engine's planes, statuses and stash-activation flag
byte for byte — with in-batch duplicate keys, ``valid`` masks, stash
overflow and NEED_SPLIT pressure — and every read path (``vmap``,
``pallas``, ``fused``) the reference per-key ``vmap`` results on hits and
misses. Deletes and updates must equal the reference segment engines.

``no_fp`` pins the port's fused read to the per-key semantics with
fingerprints off: the reference's routed TPU read path misses nearly every
key in that config, and the port does not copy that fault.
"""
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import DashConfig, engine as re_, hashing, layout
from repro_torch.core import engine as te
from repro_torch.kernels import fused as tfused
from tests.conftest import unique_keys
from tests.torch_parity import assert_same_state, port_cfg, to_port, words

B = 64

#: the feature-flag matrix of tests/test_fused.py
CONFIGS = {
    "default": DashConfig(max_segments=8, dir_depth_max=6, init_depth=1),
    "no_disp": DashConfig(max_segments=8, dir_depth_max=6, init_depth=1,
                          use_displacement=False),
    "no_fp": DashConfig(max_segments=8, dir_depth_max=6, init_depth=1,
                        use_fingerprints=False),
    "no_ometa": DashConfig(max_segments=8, dir_depth_max=6, init_depth=1,
                           use_overflow_meta=False),
    "no_stash": DashConfig(max_segments=8, dir_depth_max=6, init_depth=1,
                           num_stash=0),
    "no_ofp": DashConfig(max_segments=8, dir_depth_max=6, init_depth=1,
                         num_ofp=0),
    "small_buckets": DashConfig(max_segments=8, dir_depth_max=6,
                                init_depth=1, num_buckets=16, num_slots=8),
}
WRITE_ENGINES = ("scan", "segment", "fused")
READ_PATHS = ("vmap", "pallas", "fused")


def _keys(rng, n):
    return hashing.np_split_keys(unique_keys(rng, n))


def _check_search(cfg, ref_state, port_state, hi, lo):
    f_r, v_r = re_.search_batch(cfg, "eh", ref_state, jnp.asarray(hi),
                                jnp.asarray(lo), batching="vmap")
    f_r, v_r = np.asarray(f_r), np.asarray(v_r)
    for path in READ_PATHS:
        f, v = te.search_batch(port_cfg(cfg), "eh", port_state, words(hi),
                               words(lo), batching=path)
        np.testing.assert_array_equal(f.numpy(), f_r, err_msg=path)
        np.testing.assert_array_equal(v.numpy().view(np.uint32), v_r, err_msg=path)
    return f_r


def _drive(cfg, rng, rounds=4, mask_round=2):
    """Fill a tiny table through the reference scan engine and every port
    write engine round by round; the small geometry reaches stash overflow
    and NEED_SPLIT within a few batches."""
    pc = port_cfg(cfg)
    st_ref = layout.make_state(cfg, "eh")
    ports = {e: to_port(cfg, st_ref) for e in WRITE_ENGINES}
    hi_all, lo_all = _keys(rng, rounds * B)
    saw_split = saw_stash = False
    for r in range(rounds):
        hi, lo = hi_all[r * B:(r + 1) * B].copy(), lo_all[r * B:(r + 1) * B].copy()
        # in-batch duplicates: repeat a quarter of the lanes
        hi[B // 2:B // 2 + B // 4], lo[B // 2:B // 2 + B // 4] = hi[:B // 4], lo[:B // 4]
        vals = rng.integers(1, 2**32, B, dtype=np.uint64).astype(np.uint32)
        valid = np.arange(B) < B // 2 if r == mask_round else np.ones(B, bool)
        st_ref, s_ref, a_ref = re_.insert_batch(
            cfg, "eh", st_ref, jnp.asarray(hi), jnp.asarray(lo), jnp.asarray(vals),
            None, jnp.asarray(valid), batching="scan")
        s_ref = np.asarray(s_ref)
        for e in WRITE_ENGINES:
            ports[e], s, a = te.insert_batch(
                pc, "eh", ports[e], words(hi), words(lo), words(vals),
                torch.from_numpy(valid), batching=e)
            np.testing.assert_array_equal(s.numpy(), s_ref, err_msg=f"{e} round {r}")
            assert bool(a) == bool(a_ref), (e, r)
            assert_same_state(st_ref, ports[e], (e, r))
        saw_split |= bool((s_ref == layout.NEED_SPLIT).any())
        if cfg.num_stash:
            saw_stash |= bool(
                (np.asarray(st_ref.meta)[:, cfg.num_buckets:] != 0).any())
        _check_search(cfg, st_ref, ports["segment"], hi, lo)
    miss_hi, miss_lo = _keys(np.random.default_rng(999), B)
    assert not _check_search(cfg, st_ref, ports["segment"], miss_hi, miss_lo).any()
    return st_ref, ports["segment"], saw_split, saw_stash


@pytest.mark.parametrize("name", list(CONFIGS))
def test_writes_and_reads_match_reference(name):
    _drive(CONFIGS[name], np.random.default_rng(zlib.crc32(name.encode())))


def test_writes_match_reference_under_pressure():
    """Past capacity: stash activation and NEED_SPLIT must occur AND stay
    byte-identical."""
    _, _, saw_split, saw_stash = _drive(CONFIGS["small_buckets"],
                                        np.random.default_rng(0xE0),
                                        rounds=8, mask_round=5)
    assert saw_split and saw_stash


@pytest.mark.parametrize("name", ["default", "no_ometa", "no_disp", "small_buckets"])
def test_delete_update_match_reference(name):
    """Deletes and updates of present, stash-resident and absent keys, with
    a mask, against the reference segment engines; the port's scan and
    segment engines both."""
    cfg = CONFIGS[name]
    pc = port_cfg(cfg)
    rng = np.random.default_rng(7)
    hi, lo = _keys(rng, 1700 if name != "small_buckets" else 280)
    st_ref = layout.make_state(cfg, "eh")
    st_ref, statuses, _ = re_.insert_batch(
        cfg, "eh", st_ref, jnp.asarray(hi), jnp.asarray(lo),
        jnp.asarray(np.arange(hi.size, dtype=np.uint32)), batching="scan")
    live = np.asarray(statuses) == layout.INSERTED
    NB = cfg.num_buckets
    stash_alloc = np.asarray(st_ref.meta)[:, NB:] & 0x3FFF
    stash_hi = np.asarray(st_ref.key_hi)[:, NB:][
        (stash_alloc[..., None] >> np.arange(cfg.num_slots)) & 1 == 1]
    in_stash = live & np.isin(hi, stash_hi)
    assert in_stash.sum() >= 8
    ports = {e: to_port(cfg, st_ref) for e in ("scan", "segment")}
    miss_hi, miss_lo = _keys(np.random.default_rng(11), 16)
    pick = np.concatenate([np.nonzero(live)[0][:32], np.nonzero(in_stash)[0][:32],
                           np.nonzero(live)[0][-32:]])
    d_hi = np.concatenate([hi[pick[:64]], miss_hi, hi[pick[64:]]])
    d_lo = np.concatenate([lo[pick[:64]], miss_lo, lo[pick[64:]]])
    valid = np.arange(d_hi.size) % 7 != 3
    st_ref, s_ref = re_.delete_batch(cfg, "eh", st_ref, jnp.asarray(d_hi),
                                     jnp.asarray(d_lo), None, jnp.asarray(valid),
                                     batching="segment")
    for e, st in ports.items():
        ports[e], s = te.delete_batch(pc, "eh", st, words(d_hi), words(d_lo),
                                      torch.from_numpy(valid), batching=e)
        np.testing.assert_array_equal(s.numpy(), np.asarray(s_ref), err_msg=e)
        assert_same_state(st_ref, ports[e], ("delete", e))
    assert (np.asarray(s_ref) == layout.NOT_FOUND).any()

    u_hi = np.concatenate([hi[live][40:120], miss_hi])
    u_lo = np.concatenate([lo[live][40:120], miss_lo])
    u_val = rng.integers(2**31, 2**32, u_hi.size, dtype=np.uint64).astype(np.uint32)
    valid = np.arange(u_hi.size) % 5 != 1
    st_ref, s_ref = re_.update_batch(cfg, "eh", st_ref, jnp.asarray(u_hi),
                                     jnp.asarray(u_lo), jnp.asarray(u_val), None,
                                     jnp.asarray(valid), batching="segment")
    for e, st in ports.items():
        ports[e], s = te.update_batch(pc, "eh", st, words(u_hi), words(u_lo),
                                      words(u_val), torch.from_numpy(valid),
                                      batching=e)
        np.testing.assert_array_equal(s.numpy(), np.asarray(s_ref), err_msg=e)
        assert_same_state(st_ref, ports[e], ("update", e))
    _check_search(cfg, st_ref, ports["segment"], u_hi, u_lo)
    assert int(te.recount_items(ports["segment"])) == int(ports["segment"].n_items)


@pytest.mark.parametrize("name", ["no_fp", "default"])
def test_fused_reads_follow_vmap_semantics(name):
    """The port's one-kernel read — direct lanes and the routed form — must
    equal the reference per-key search, fingerprints on or off."""
    cfg = CONFIGS[name]
    pc = port_cfg(cfg)
    hi, lo = _keys(np.random.default_rng(0xCAFE), 256)
    st_ref = layout.make_state(cfg, "eh")
    st_ref, _, _ = re_.insert_batch(cfg, "eh", st_ref, jnp.asarray(hi), jnp.asarray(lo),
                                    jnp.asarray(np.arange(256, dtype=np.uint32) + 1),
                                    batching="scan")
    st = to_port(cfg, st_ref)
    miss_hi, miss_lo = _keys(np.random.default_rng(1), 128)
    q_hi, q_lo = np.concatenate([hi, miss_hi]), np.concatenate([lo, miss_lo])
    f_r, v_r = re_.search_batch(cfg, "eh", st_ref, jnp.asarray(q_hi),
                                jnp.asarray(q_lo), batching="vmap")
    assert np.asarray(f_r)[:256].all()
    for cap in (128, 512):      # 128 overflows some segments: direct fallback
        f, v = tfused._fused_search_routed(pc, "eh", st, words(q_hi), words(q_lo), cap)
        np.testing.assert_array_equal(f.numpy(), np.asarray(f_r))
        np.testing.assert_array_equal(v.numpy().view(np.uint32), np.asarray(v_r))
    f, v = tfused.fused_search(pc, "eh", st, words(q_hi), words(q_lo))
    np.testing.assert_array_equal(f.numpy(), np.asarray(f_r))
    np.testing.assert_array_equal(v.numpy().view(np.uint32), np.asarray(v_r))


def test_linear_probing_scan_matches_reference():
    """The unbalanced linear-probe window (CCEH-style ablation): no fused or
    kernel read path covers probe_len 4, so scan writes and vmap reads."""
    cfg = DashConfig(max_segments=8, dir_depth_max=6, use_balanced=False,
                     probe_len=4, num_buckets=16, num_slots=8)
    pc = port_cfg(cfg)
    hi, lo = _keys(np.random.default_rng(4), 160)
    st_ref = layout.make_state(cfg, "eh")
    st = to_port(cfg, st_ref)
    vals = np.arange(160, dtype=np.uint32)
    st_ref, s_ref, _ = re_.insert_batch(cfg, "eh", st_ref, jnp.asarray(hi),
                                        jnp.asarray(lo), jnp.asarray(vals),
                                        batching="scan")
    st, s, _ = te.insert_batch(pc, "eh", st, words(hi), words(lo), words(vals),
                               batching="scan")
    np.testing.assert_array_equal(s.numpy(), np.asarray(s_ref))
    assert_same_state(st_ref, st)
    _check_search(cfg, st_ref, st, hi, lo)
