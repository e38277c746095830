"""Port parity of the shape grid (``repro_torch.configs.shapes``) against the
reference's ``repro.configs.shapes``: the grid, ``shape_applicable`` and
``all_cells`` equal; ``input_specs`` the same tree, shapes and dtypes for
all 10 archs x 4 shapes (the reference's side ``ShapeDtypeStruct``s, the
port's meta tensors: nothing allocated); ``concrete_inputs`` value for
value at the reduced configs where the draw is small (``DRAWN``).
"""
import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS as REF_ARCH_IDS
from repro.configs import SHAPES as REF_SHAPES
from repro.configs import all_cells as ref_all_cells
from repro.configs import concrete_inputs as ref_concrete
from repro.configs import get_config as ref_config
from repro.configs import input_specs as ref_input_specs
from repro.configs import shape_applicable as ref_applicable
from repro_torch.configs import (ARCH_IDS, SHAPES, all_cells, concrete_inputs, get_config,
                                 input_specs, shape_applicable)

CELLS = [(a, s) for a in ARCH_IDS for s in SHAPES]
#: the reduced cells whose draw is at most this many elements (under a
#: second a package): every train and prefill cell but musicgen-large's
#: (268M frame-embedding values each), and decode_32k / long_500k of the
#: archs whose state is windowed or recurrent (h2o-danube-3-4b,
#: mixtral-8x7b, recurrentgemma-9b, rwkv6-7b, 0.03M-8.7M); the full-attention
#: archs' caches there are 0.27G-8.6G values and are left out
DRAW_LIMIT = 16_000_000


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k], path + (k,))]
    return [(path, tree)]


def _size(tree) -> int:
    return sum(int(np.prod(t.shape)) for _, t in _leaves(tree))


DRAWN = [(a, s) for a, s in CELLS if _size(input_specs(get_config(a, reduced=True), s))
         <= DRAW_LIMIT]


def test_grid_equal_reference():
    assert ARCH_IDS == REF_ARCH_IDS
    assert set(SHAPES) == set(REF_SHAPES) and list(SHAPES) == list(REF_SHAPES)
    for name, case in SHAPES.items():
        ref = REF_SHAPES[name]
        assert (case.name, case.seq_len, case.global_batch, case.kind) == (
            ref.name, ref.seq_len, ref.global_batch, ref.kind)
    assert all_cells() == ref_all_cells()
    for a in ARCH_IDS:
        for s in SHAPES:
            assert shape_applicable(get_config(a), s) == ref_applicable(ref_config(a), s)


@pytest.mark.parametrize("arch,shape", CELLS, ids=[f"{a}-{s}" for a, s in CELLS])
def test_input_specs_equal_reference(arch, shape):
    """The same tree (keys), and each leaf's shape and dtype, at the
    published config; the port's leaves are on the meta device."""
    got = _leaves(input_specs(get_config(arch), shape))
    want = _leaves(ref_input_specs(ref_config(arch), shape))
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, g), (_, w) in zip(got, want):
        assert g.device.type == "meta", path
        assert tuple(g.shape) == tuple(w.shape), path
        assert str(g.dtype).removeprefix("torch.") == np.dtype(w.dtype).name, path


@pytest.mark.parametrize("arch,shape", DRAWN, ids=[f"{a}-{s}" for a, s in DRAWN])
def test_concrete_inputs_equal_reference(arch, shape):
    """The reduced config's draws from the same seed, value for value (bf16
    leaves compared widened to f32)."""
    got = _leaves(concrete_inputs(get_config(arch, reduced=True), shape,
                                  np.random.default_rng(5), device="cpu"))
    want = _leaves(ref_concrete(ref_config(arch, reduced=True), shape, np.random.default_rng(5)))
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, g), (_, w) in zip(got, want):
        w = np.asarray(w)
        assert str(g.dtype).removeprefix("torch.") == w.dtype.name, path
        g = g.float() if g.dtype == torch.bfloat16 else g
        assert np.array_equal(g.numpy(), np.asarray(w, dtype=g.numpy().dtype)), path


def test_concrete_inputs_default_device():
    """Like every entry point, ``concrete_inputs`` runs on the card unless
    the caller names another device."""
    cfg = get_config("rwkv6-7b", reduced=True)
    if torch.cuda.is_available():
        assert concrete_inputs(cfg, "long_500k")["inputs"]["token"].is_cuda
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            concrete_inputs(cfg, "long_500k")
