"""Port parity: hashing, layout and the state carry-across.

The PyTorch port's hashes must equal the JAX package's ``hash1``/``hash2``
and its numpy mirrors bit for bit, including the keys where a signed 32-bit
word would go wrong (h1 >= 2**31, words 0 and 2**32 - 1); a fresh state's
planes must equal the reference's byte for byte; and the config classes
must carry the same fields and defaults.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import hashing as rh
from repro.core import layout as rl
from repro_torch import interop
from repro_torch.core import hashing as th
from repro_torch.core import layout as tl
from tests.torch_parity import assert_same_state, port_cfg, ref_planes, words

EDGE = np.array([0, 1, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFE, 0xFFFFFFFF],
                dtype=np.uint32)


def _key_words(seed: int, n: int = 4096):
    rng = np.random.default_rng(seed)
    hi = rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
    lo = rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
    eh, el = np.meshgrid(EDGE, EDGE)
    return np.concatenate([hi, eh.ravel()]), np.concatenate([lo, el.ravel()])


@pytest.mark.parametrize("seed", [0, 1])
def test_hashes_match_reference(seed):
    hi, lo = _key_words(seed)
    want1 = np.asarray(rh.hash1(jnp.asarray(hi), jnp.asarray(lo)))
    want2 = np.asarray(rh.hash2(jnp.asarray(hi), jnp.asarray(lo)))
    assert (want1 >= 2**31).any() and (want1 < 2**31).any()   # the sign trap
    got1 = th.hash1(words(hi), words(lo)).numpy().view(np.uint32)
    got2 = th.hash2(words(hi), words(lo)).numpy().view(np.uint32)
    np.testing.assert_array_equal(got1, want1)
    np.testing.assert_array_equal(got2, want2)
    np.testing.assert_array_equal(got1, rh.np_hash1(hi, lo))
    np.testing.assert_array_equal(th.np_hash1(hi, lo), rh.np_hash1(hi, lo))
    np.testing.assert_array_equal(th.np_hash2(hi, lo), rh.np_hash2(hi, lo))
    np.testing.assert_array_equal(
        th.fingerprint(words(got2)).numpy(),
        np.asarray(rh.fingerprint(jnp.asarray(want2))))


def test_split_keys_match_reference():
    keys = np.array([0, 1, 2**32 - 1, 2**32, 2**63, 2**64 - 1], dtype=np.uint64)
    for a, b in zip(th.np_split_keys(keys), rh.np_split_keys(keys)):
        np.testing.assert_array_equal(a, b)
    hi, lo = th.split_keys(keys, "cpu")
    np.testing.assert_array_equal(hi.numpy().view(np.uint32), rh.np_split_keys(keys)[0])
    np.testing.assert_array_equal(lo.numpy().view(np.uint32), rh.np_split_keys(keys)[1])


def test_config_fields_match():
    ref = [(f.name, f.default) for f in dataclasses.fields(rl.DashConfig)]
    port = [(f.name, f.default) for f in dataclasses.fields(tl.DashConfig)]
    assert port == ref
    for cfg in (rl.DashConfig(), rl.DashConfig(num_buckets=16, num_slots=8,
                                               num_stash=0, use_balanced=False)):
        pc = port_cfg(cfg)
        for prop in ("buckets_total", "bucket_bits", "dir_size", "probe_window",
                     "seg_capacity"):
            assert getattr(pc, prop) == getattr(cfg, prop), prop
        assert pc.bytes_per_segment() == cfg.bytes_per_segment()
    with pytest.raises(ValueError):
        tl.DashConfig(num_buckets=48)
    # pointer mode is ported: its key heap is sized like the reference's
    ptr = rl.DashConfig(max_segments=4, pointer_mode=True, key_heap_size=64,
                        key_heap_words=3)
    assert_same_state(rl.make_state(ptr), tl.make_state(port_cfg(ptr), device="cpu"))


@pytest.mark.parametrize("mode,cfg", [
    ("eh", rl.DashConfig(max_segments=8, dir_depth_max=6)),
    ("eh", rl.DashConfig(max_segments=16, dir_depth_max=8, init_depth=2,
                         num_buckets=16, num_slots=8, num_stash=0)),
    ("lh", rl.DashConfig(max_segments=32, num_stash=4, lh_base_log2=2)),
])
def test_make_state_byte_equal(mode, cfg):
    ref = rl.make_state(cfg, mode)
    assert_same_state(ref, tl.make_state(port_cfg(cfg), mode, device="cpu"))
    assert tl.DashState._fields == rl.DashState._fields


def test_interop_roundtrip():
    cfg = rl.DashConfig(max_segments=8, dir_depth_max=6)
    rng = np.random.default_rng(5)
    planes = {k: rng.integers(0, 256, v.shape).astype(v.dtype) if v.dtype != bool
              else v for k, v in ref_planes(rl.make_state(cfg)).items()}
    planes["meta"] = rng.integers(0, 2**32, planes["meta"].shape,
                                  dtype=np.uint64).astype(np.uint32)
    back = interop.state_to_numpy(interop.state_from_numpy(port_cfg(cfg), planes, "cpu"))
    for k, v in planes.items():
        assert back[k].dtype == v.dtype and back[k].tobytes() == v.tobytes(), k
    with pytest.raises(ValueError):
        interop.state_from_numpy(port_cfg(rl.DashConfig(max_segments=16)),
                                 planes, "cpu")


def test_addressing_and_packed_words_unsigned():
    """Word fields whose top bit is set: the directory index, LH bucket bits
    and a meta count >= 8 must read as the reference's uint32 arithmetic."""
    cfg = rl.DashConfig(max_segments=64, dir_depth_max=12)
    hi, lo = _key_words(3, 512)
    h1 = np.asarray(rh.hash1(jnp.asarray(hi), jnp.asarray(lo)))
    t1 = words(h1)
    pc = port_cfg(cfg)
    np.testing.assert_array_equal(tl.dir_index(pc, t1).numpy(),
                                  np.asarray(rl.dir_index(cfg, jnp.asarray(h1))))
    np.testing.assert_array_equal(tl.bucket_index(pc, t1).numpy(),
                                  np.asarray(rl.bucket_index(cfg, jnp.asarray(h1))))
    np.testing.assert_array_equal(tl.lh_bucket_index(pc, t1).numpy(),
                                  np.asarray(rl.lh_bucket_index(cfg, jnp.asarray(h1))))
    lh_word = np.uint32((3 << 24) | 5)
    np.testing.assert_array_equal(
        tl.lh_logical_segment(pc, t1, words(np.array(lh_word))).numpy(),
        np.asarray(rl.lh_logical_segment(cfg, jnp.asarray(h1), jnp.asarray(lh_word))))
    alloc = np.array([0x3FFF, 5, 0], np.uint32)
    member = np.array([0x2AAA, 1, 0], np.uint32)
    count = np.array([14, 8, 0], np.uint32)
    want = np.asarray(rl.meta_pack(jnp.asarray(alloc), jnp.asarray(member),
                                   jnp.asarray(count)))
    got = tl.meta_pack(torch.from_numpy(alloc.astype(np.int64)),
                       torch.from_numpy(member.astype(np.int64)),
                       torch.from_numpy(count.astype(np.int64)))
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)
    np.testing.assert_array_equal(tl.meta_count(got).numpy(), count)
    np.testing.assert_array_equal(tl.meta_alloc(got).numpy(), alloc)
    np.testing.assert_array_equal(tl.meta_member(got).numpy(), member)
