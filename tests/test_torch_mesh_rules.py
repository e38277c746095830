"""Port parity of the mesh layer's pure functions, in process (no ranks):
``repro_torch.parallel.sharding`` (presets, spec resolution, flags),
``models.transformer.param_specs`` and ``decode_state_specs``,
``parallel.compression``'s quantizer,
error feedback and ``wire_bytes``, and ``launch.elastic.rescale_batch_plan``
against the reference's own functions. Meshes are duck objects: the
reference's ``_resolve`` reads ``axis_names`` and ``devices.shape``, the
port's ``mesh_dim_names`` and ``shape``.

Every spec, flag, plan and byte count is compared for equality; int8 codes
bit for bit; a quantizer scale within one f32 ulp (the port multiplies by
the f32 reciprocal of 127, as the reference's compiled steps do; the
reference run eagerly divides).
"""
import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS
from repro.configs import get_config as ref_config
from repro.configs import input_specs as ref_input_specs
from repro.launch import elastic as R_el
from repro.models.transformer import abstract_params
from repro.models.transformer import decode_state_specs as ref_decode_state_specs
from repro.models.transformer import param_specs as ref_param_specs
from repro.parallel import compression as RC
from repro.parallel import sharding as RS
from repro_torch.configs import get_config, input_specs
from repro_torch.launch import elastic as P_el
from repro_torch.models.transformer import decode_state_specs, param_specs
from repro_torch.parallel import compression as PC
from repro_torch.parallel import sharding as PS
from repro_torch.train.steps import master_meta

PRESETS = tuple(RS.presets())
MESHES = {"2x2": ((2, 2), ("data", "model")), "2x4": ((2, 4), ("data", "model")),
          "16x16": ((16, 16), ("data", "model")), "pod": ((2, 16, 16), ("pod", "data", "model"))}


def _meshes(name):
    shape, axes = MESHES[name]
    ref = types.SimpleNamespace(axis_names=axes, devices=np.empty(shape, np.int8))
    port = types.SimpleNamespace(mesh_dim_names=axes, shape=shape)
    return ref, port


@functools.lru_cache(maxsize=None)
def _abstract(arch):
    return abstract_params(ref_config(arch))


def test_presets_equal_reference():
    """Every preset's dict, axis rules and ``_moe_*`` flags alike."""
    assert PS.presets() == RS.presets()


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_specs_equal_reference(arch):
    """``param_specs`` of the full config: the same nested keys and logical
    names, and the master tree's shapes the reference's abstract ones."""
    shapes, specs = _abstract(arch)
    assert param_specs(get_config(arch)) == specs == ref_param_specs(ref_config(arch))
    meta = master_meta(get_config(arch))
    got = jax.tree.map(lambda t: tuple(t.shape), meta)
    assert got == jax.tree.map(lambda s: tuple(s.shape), shapes)


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("preset", PRESETS)
def test_tree_specs_equal_reference(preset, mesh):
    """``tree_specs`` of every arch's ``param_specs`` with and without the
    shapes (the divisibility drop), and ``spec_for`` of activation names,
    equal the reference's ``PartitionSpec``s entry for entry."""
    rmesh, pmesh = _meshes(mesh)
    rules = RS.presets()[preset]
    for arch in ARCH_IDS:
        shapes, specs = _abstract(arch)
        for shape_tree in (None, shapes):
            want = jax.tree.map(tuple, RS.tree_specs(specs, rules, rmesh, shape_tree),
                                is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
            got = PS.tree_specs(specs, PS.presets()[preset], pmesh, shape_tree)
            assert got == want, (arch, shape_tree is not None)
    for names, dims in ((("batch", "seq", "act_embed"), (256, 4096, 4096)),
                        (("batch", "seq", "vocab"), (1, 32768, 32064)),
                        (("batch", "kv_heads", "cache", "head_dim"), (128, 8, 32768, 128)),
                        (("batch", None), (255, 7)), (("batch",), None)):
        want = tuple(RS.spec_for(names, rules, rmesh, dims))
        assert PS.spec_for(names, PS.presets()[preset], pmesh, dims) == want


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("preset", ("decode", "decode_b1"))
def test_decode_state_specs_equal_reference(preset, mesh):
    """``decode_state_specs`` of every arch equals the reference's, and its
    ``tree_specs`` over the decode shapes' states (decode_32k's 128 lanes
    and long_500k's one, a KV cache of each length) under the serving
    presets, with the divisibility fall-backs, entry for entry."""
    rmesh, pmesh = _meshes(mesh)
    rules = RS.presets()[preset]
    for arch in ARCH_IDS:
        specs = decode_state_specs(get_config(arch))
        assert specs == ref_decode_state_specs(ref_config(arch))
        for shape in ("decode_32k", "long_500k"):
            state = ref_input_specs(ref_config(arch), shape)["state"]
            want = jax.tree.map(tuple, RS.tree_specs(specs, rules, rmesh, state),
                                is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
            got = PS.tree_specs(specs, PS.presets()[preset], pmesh,
                                input_specs(get_config(arch), shape)["state"])
            assert got == want, (arch, shape)


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("preset", PRESETS)
def test_axes_flags_and_batch_axes(preset, mesh):
    """Under ``use``: ``axes_for``, ``batch_axes`` and ``flag`` as the
    reference's, dims-aware; without a mesh ``axes_for`` is empty."""
    rmesh, pmesh = _meshes(mesh)
    with RS.use(rmesh, preset), PS.use(pmesh, preset):
        assert PS.active_mesh() is pmesh and PS.active_rules_name() == preset
        for f in ("_moe_shardmap", "_moe_ep", "_moe_dense", "_nothing"):
            assert PS.flag(f) == RS.flag(f)
        for name in ("batch", "embed", "expert", "mlp", "heads", "vocab", "cache", "seq"):
            for dim in (None, 1, 2, 7, 16, 256, 4096, 6400, 32064):
                assert PS.axes_for(name, dim) == RS.axes_for(name, dim), (name, dim)
        for dim in (None, 1, 8, 32, 256, 512):
            assert PS.batch_axes(dim) == RS.batch_axes(dim)
    assert PS.active_mesh() is None and PS.axes_for("batch") == ()


def test_shard_specs_and_logical_constraint():
    tree = {"a": np.zeros(3), "b": {"c": np.zeros(2)}}
    want = jax.tree.map(tuple, RS.shard_specs(("data", "model"), tree),
                        is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    assert PS.shard_specs(("data", "model"), tree) == want
    x = torch.ones(2, 3)
    with PS.use(_meshes("2x2")[1], "train_dp"):
        assert PS.logical_constraint(x, ("batch", None)) is x


@pytest.mark.parametrize("mesh", ["2x2", "2x4"])
def test_placement_slices(mesh):
    """A leaf's shard at each coordinate: the dim split into the product of
    its axes' sizes, the first axis major (embed over (data, model))."""
    _, pmesh = _meshes(mesh)
    (nd, nm), _ = MESHES[mesh]
    full = torch.arange(4 * 64 * 8).reshape(4, 64, 8)
    parts = {}
    for i in range(nd):
        for j in range(nm):
            pl = PS.placement((None, ("data", "model"), None), full.shape, pmesh,
                              {"data": i, "model": j})
            parts[i * nm + j] = pl.take(full)
            assert pl.local_shape == (4, 64 // (nd * nm), 8)
    assert torch.equal(torch.cat([parts[k] for k in sorted(parts)], dim=1), full)
    pl = PS.placement(("model", None), (nm * 3, 5), pmesh, {"data": 1, "model": nm - 1})
    assert pl.slices == ((3 * (nm - 1), 3), (0, 5))


def test_rescale_batch_plan_grid():
    for gb in (16, 17, 64, 255, 256, 1000):
        for old in (1, 2, 8, 16):
            for new in (1, 3, 7, 8, 15, 16):
                assert P_el.rescale_batch_plan(gb, old, new) == R_el.rescale_batch_plan(
                    gb, old, new), (gb, old, new)


@pytest.mark.parametrize("arch", ["yi-6b", "mixtral-8x7b", "recurrentgemma-9b"])
def test_wire_bytes_equal(arch):
    shapes, _ = _abstract(arch)
    meta = master_meta(get_config(arch))
    for compressed in (False, True):
        got = PC.wire_bytes(meta, compressed)
        assert isinstance(got, int) and got == RC.wire_bytes(shapes, compressed)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_quantize_matches_reference(seed):
    """int8 codes bit for bit, the scale within one f32 ulp, the
    dequantized tensor from the same codes and scale equal."""
    rng = np.random.default_rng(seed)
    for shape, sd in (((256,), 1.0), ((64, 32), 1e-3), ((7, 5, 3), 40.0)):
        x = (sd * rng.normal(0, 1, shape)).astype(np.float32)
        rq, rs = RC._quantize(jnp.asarray(x))
        pq, ps = PC._quantize(torch.from_numpy(x))
        assert pq.dtype == torch.int8 and np.array_equal(pq.numpy(), np.asarray(rq))
        assert abs(float(ps) - float(rs)) <= np.spacing(np.float32(rs))
        np.testing.assert_array_equal(PC._dequantize(pq, torch.tensor(float(rs))).numpy(),
                                      np.asarray(RC._dequantize(rq, rs)))
    z = PC._quantize(torch.zeros(4))
    assert float(z[1]) > 0 and not z[0].any()


def test_compression_error_feedback_is_unbiased_over_steps():
    """Twin of ``test_substrate``'s: int8 + error feedback on one rank —
    the cumulative update converges to the true mean."""
    rng = np.random.default_rng(0)
    g_true = torch.from_numpy(rng.normal(0, 1, (256,)).astype(np.float32))
    res = torch.zeros(256)
    acc = torch.zeros(256)
    for _ in range(20):
        e = g_true + res
        q, scale = PC._quantize(e)
        deq = PC._dequantize(q, scale)
        res = e - deq
        acc = acc + deq
    np.testing.assert_allclose((acc / 20).numpy(), g_true.numpy(), atol=2e-3)
