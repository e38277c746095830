"""Port parity: the paper's baselines and the pessimistic search.

Level hashing (its own structure: two levels of 4-slot buckets, one move,
full-table rehash) must leave the reference's ``LevelState`` byte for byte
after every insert batch and every rehash, with the same statuses, search
answers, load factor and rehash count; the move branch and pool exhaustion
included. CCEH and 'Bucketized' are ``DashConfig`` points of the shared
engine: inserts with splits, searches, deletes and updates must give the
reference's planes and answers. ``search_batch_pessimistic`` (Fig. 13) must
give the reference's version planes and answers in EH, LH and pointer mode,
and the answers of ``search_batch``.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import DashConfig, DashEH, DashLH, baselines as rb, engine as re_
from repro.core import hashing
from repro_torch import interop
from repro_torch.core import DashEH as TDashEH, baselines as tb, engine as te
from tests.conftest import unique_keys
from tests.torch_parity import assert_same_state, port_cfg, to_port, words

LEVEL = dict(max_log2=10, init_log2=4)
#: the top bit makes absent keys: every inserted key is below 2**63
TOP = np.uint64(1 << 63)


def _keys_vals(n, seed):
    rng = np.random.default_rng(seed)
    keys = rng.permutation(unique_keys(rng, n))
    return keys, rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)


def _ref_level_planes(state):
    return {k: np.asarray(v) for k, v in state._asdict().items()}


def assert_same_level(ref_state, port_state, where=""):
    a, b = _ref_level_planes(ref_state), interop.level_state_to_numpy(port_state)
    bad = [k for k in a if a[k].dtype != b[k].dtype or a[k].tobytes() != b[k].tobytes()]
    assert not bad, (where, bad)


def _level_batches(keys, vals):
    """6 batches of 500 fresh keys, each followed by 20 keys of the batch
    before (EXISTS)."""
    for i in range(6):
        a, b = i * 500, (i + 1) * 500
        yield (np.concatenate([keys[a:b], keys[max(0, a - 20):a]]),
               np.concatenate([vals[a:b], vals[max(0, a - 20):a]]))


def test_level_stream_matches_reference():
    """3000 keys in 6 batches through ``LevelHashing``: 6 rehashes to
    k = 10, statuses (EXISTS on the re-inserted keys), the state after
    every batch, search answers for hits and misses, the load factor."""
    keys, vals = _keys_vals(3000, 21)
    ref = rb.LevelHashing(rb.LevelConfig(**LEVEL))
    port = tb.LevelHashing(tb.LevelConfig(**LEVEL), device="cpu")
    for i, (k, v) in enumerate(_level_batches(keys, vals)):
        st = port.insert(k, v)
        np.testing.assert_array_equal(st, np.asarray(ref.insert(k, v)))
        assert (st[500:] == rb.EXISTS).all() and (st[:500] == rb.INSERTED).all()
        assert_same_level(ref.state, port.state, i)
        assert port.load_factor == ref.load_factor and port.n_items == ref.n_items
    assert int(port.state.k) == 10 and int(port.state.n_rehashes) == 6
    assert port.n_items == 3000 and abs(port.load_factor - 0.48828125) < 1e-12
    probe = np.concatenate([keys, unique_keys(np.random.default_rng(99), 1000) | TOP])
    f_r, v_r = ref.search(probe)
    f_p, v_p = port.search(probe)
    np.testing.assert_array_equal(f_p, np.asarray(f_r))
    np.testing.assert_array_equal(v_p, np.asarray(v_r))
    assert f_p[:3000].all() and (v_p[:3000] == vals).all()


def test_level_batch_and_rehash_match_reference():
    """The same stream through the module functions: the state after every
    ``level_insert_batch`` (first batches unpadded, retries padded with a
    ``valid`` mask) and after every ``level_rehash``, which copies the old
    top's stale bytes and re-inserts the old bottom through the kernel."""
    rc, tc = rb.LevelConfig(**LEVEL), tb.LevelConfig(**LEVEL)
    keys, vals = _keys_vals(3000, 21)
    rs = rb.level_make_state(rc)
    ps = interop.level_state_from_numpy(tc, _ref_level_planes(rs), "cpu")
    rehashes = 0
    for k, v in _level_batches(keys, vals):
        hi, lo = hashing.np_split_keys(k)
        pending, first = np.arange(k.size), True
        while pending.size:
            idx, valid = pending, None
            if not first:
                n = max(8, 1 << int(np.ceil(np.log2(pending.size))))
                idx = np.concatenate([pending, np.zeros(n - pending.size, np.int64)])
                valid = np.arange(n) < pending.size
            args = (hi[idx], lo[idx], v[idx])
            rs, st_r = rb.level_insert_batch(
                rc, rs, *map(jnp.asarray, args),
                None if valid is None else jnp.asarray(valid))
            ps, st_p = tb.level_insert_batch(
                tc, ps, *map(words, args),
                None if valid is None else torch.from_numpy(valid))
            np.testing.assert_array_equal(st_p.numpy(), np.asarray(st_r))
            assert_same_level(rs, ps, ("batch", rehashes))
            st = np.asarray(st_r)[:pending.size]
            pending, first = pending[st == rb.NEED_SPLIT], False
            if pending.size:
                rs, ps = rb.level_rehash(rc, rs), tb.level_rehash(tc, ps)
                rehashes += 1
                assert_same_level(rs, ps, ("rehash", rehashes))
    assert rehashes == 6


def _np_buckets(key, k, boff):
    hi, lo = hashing.np_split_keys(np.array([key], np.uint64))
    h1, h2 = int(hashing.np_hash1(hi, lo)[0]), int(hashing.np_hash2(hi, lo)[0])
    top, bot = (1 << k) - 1, (1 << (k - 1)) - 1
    return h1 & top, h2 & top, boff + (h1 & bot), boff + (h2 & bot)


def test_level_move_branch_matches_reference():
    """A key whose four candidate buckets are full, where slot 0 of its
    top-a bucket holds a record whose alternate top bucket is empty: the
    plain step inserts it by the move (the record to its alternate bucket,
    the key into slot 0), and the planes and status are the reference's."""
    rc, tc = rb.LevelConfig(max_log2=6, init_log2=3), tb.LevelConfig(max_log2=6, init_log2=3)
    boff = 1 << 6
    keys = unique_keys(np.random.default_rng(3), 400)
    key = keys[0]
    ta, tb_, ba, bb = _np_buckets(key, 3, boff)
    for r in keys[1:]:                  # a record that lives in ta, alt elsewhere
        ra, rb_ = _np_buckets(r, 3, boff)[:2]
        alt = rb_ if ra == ta else ra
        if ta in (ra, rb_) and alt not in (ta, tb_):
            break
    planes = _ref_level_planes(rb.level_make_state(rc))
    planes = {n: a.copy() for n, a in planes.items()}
    filler = iter(keys[-64:])
    for b in {ta, tb_, ba, bb}:
        planes["alloc"][b] = 0xF
        for s in range(4):
            f = r if (b, s) == (ta, 0) else next(filler)
            planes["key_hi"][b, s], planes["key_lo"][b, s] = (
                x[0] for x in hashing.np_split_keys(np.array([f], np.uint64)))
            planes["val"][b, s] = 100 + s
    planes["n_items"] = np.int32(4 * len({ta, tb_, ba, bb}))
    ps = interop.level_state_from_numpy(tc, planes, "cpu")
    rs = rb.LevelState(**{n: jnp.asarray(a) for n, a in planes.items()})
    hi, lo = hashing.np_split_keys(np.array([key], np.uint64))
    st = tb.level_insert_one(tc, ps, words(hi), words(lo), words(np.array([7], np.uint32)))
    assert int(st[0]) == tb.INSERTED
    r_hi, r_lo = hashing.np_split_keys(np.array([r], np.uint64))
    assert int(ps.key_lo[ta, 0]) == int(words(lo)[0]) and int(ps.val[ta, 0]) == 7
    assert int(ps.key_lo[alt, 0]) == int(words(r_lo)[0]) and int(ps.val[alt, 0]) == 100
    rs, st_r = rb.level_insert_batch(rc, rs, jnp.asarray(hi), jnp.asarray(lo),
                                     jnp.asarray(np.array([7], np.uint32)))
    np.testing.assert_array_equal(st.numpy(), np.asarray(st_r))
    assert_same_level(rs, ps)


def test_level_exhaustion_raises_at_the_same_batch():
    """``max_log2=6``: both tables raise 'pool exhausted' on the same batch,
    with equal states before it."""
    cfg = dict(max_log2=6, init_log2=3)
    ref = rb.LevelHashing(rb.LevelConfig(**cfg))
    port = tb.LevelHashing(tb.LevelConfig(**cfg), device="cpu")
    keys, vals = _keys_vals(400, 6)
    for i in range(0, 400, 40):
        try:
            ref.insert(keys[i:i + 40], vals[i:i + 40])
        except RuntimeError as e:
            with pytest.raises(RuntimeError, match=str(e)):
                port.insert(keys[i:i + 40], vals[i:i + 40])
            break
        port.insert(keys[i:i + 40], vals[i:i + 40])
        assert_same_level(ref.state, port.state, i)
    else:
        pytest.fail("the reference never exhausted its pool")
    assert int(port.state.k) == 6


@pytest.mark.parametrize("which", ["cceh", "bucketized"])
def test_dash_config_baselines_match_reference(which):
    """Inserts with splits, then searches of hits and misses, deletes,
    updates and searches again, on CCEH and Bucketized: the reference's
    planes, statuses and answers."""
    if which == "cceh":
        cfg, tcfg = rb.cceh_config(64, 8), tb.cceh_config(64, 8)
    else:
        cfg = rb.bucketized_config(max_segments=64, dir_depth_max=8)
        tcfg = tb.bucketized_config(max_segments=64, dir_depth_max=8)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(cfg)
    keys, vals = _keys_vals(1500, 31)
    misses = unique_keys(np.random.default_rng(77), 300) | TOP
    ref, port = DashEH(cfg), TDashEH(tcfg, device="cpu")
    for a, b in ((0, 300), (300, 1500)):
        np.testing.assert_array_equal(port.insert(keys[a:b], vals[a:b]),
                                      np.asarray(ref.insert(keys[a:b], vals[a:b])))
        assert_same_state(ref.state, port.state, (which, a))
    assert port.n_segments > 2                   # it split (from 2 segments)
    for op, args in (("search", (keys,)), ("search", (misses,)),
                     ("delete", (keys[::7],)), ("update", (keys[1::5], vals[::5][:300])),
                     ("search", (np.concatenate([keys, misses]),))):
        out_r, out_p = getattr(ref, op)(*args), getattr(port, op)(*args)
        for r, p in zip(out_r if op == "search" else (out_r,),
                        out_p if op == "search" else (out_p,)):
            np.testing.assert_array_equal(p, np.asarray(r), err_msg=(which, op))
        assert_same_state(ref.state, port.state, (which, op))
    assert port.load_factor == ref.load_factor


@pytest.mark.parametrize("kind", ["eh", "lh", "pointer"])
def test_pessimistic_search_matches_reference(kind):
    """Read-locking search on a loaded table: four version bumps per key
    (acquire and release of its two buckets), the reference's version plane
    and answers, and the answers of the optimistic search."""
    cfg = {"eh": DashConfig(max_segments=16, dir_depth_max=6),
           "lh": DashConfig(max_segments=16, num_stash=4),
           "pointer": DashConfig(max_segments=16, dir_depth_max=6, pointer_mode=True,
                                 key_heap_size=2048, key_heap_words=2)}[kind]
    mode = "lh" if kind == "lh" else "eh"
    keys, vals = _keys_vals(600, 41)
    w = np.stack([(keys & np.uint64(0xFFFFFFFF)).astype(np.uint32),
                  (keys >> np.uint64(32)).astype(np.uint32)], 1)
    ref = (DashLH if mode == "lh" else DashEH)(cfg)
    if cfg.pointer_mode:
        ref.insert(values=vals, words=w)
    else:
        ref.insert(keys, vals)
    probe = np.concatenate([keys[:48], unique_keys(np.random.default_rng(8), 16) | TOP])
    pw = np.concatenate([w[:48], np.full((16, 2), 7, np.uint32)])
    hi, lo = hashing.np_split_keys(probe)
    port_state = to_port(cfg, ref.state)
    rw = jnp.asarray(pw) if cfg.pointer_mode else None
    tw = words(pw) if cfg.pointer_mode else None
    before = port_state.version.clone()
    rs, f_r, v_r = re_.search_batch_pessimistic(cfg, mode, ref.state, jnp.asarray(hi),
                                                jnp.asarray(lo), rw)
    ps, f_p, v_p = te.search_batch_pessimistic(port_cfg(cfg), mode, port_state,
                                               words(hi), words(lo), tw)
    np.testing.assert_array_equal(f_p.numpy(), np.asarray(f_r))
    np.testing.assert_array_equal(v_p.numpy().view(np.uint32), np.asarray(v_r))
    assert_same_state(rs, ps, kind)
    assert int((ps.version.long() - before.long()).sum()) == 4 * 2 * probe.size
    assert f_p[:48].all() and not f_p[48:].any()
    f_o, v_o = te.search_batch(port_cfg(cfg), mode, ps, words(hi), words(lo), words=tw)
    np.testing.assert_array_equal(f_o.numpy(), f_p.numpy())
    np.testing.assert_array_equal(v_o.numpy(), v_p.numpy())
