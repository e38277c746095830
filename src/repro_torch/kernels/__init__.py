"""Hand-written CUDA kernels for the Dash hot path and the code around them.

hashmix.py — bulk_hash: (h1, h2, fp) per key        (csrc/hashmix.cu)
probe.py   — fingerprint_probe: match/free bitmaps (csrc/probe.cu)
fused.py   — fused_probe read kernel + merged-commit insert (csrc/fused.cu)
level.py   — level_scan: a level-hashing insert batch  (csrc/level.cu)
ops.py     — routing and the fingerprint read paths
_build.py  — nvcc build at first use + ctypes binding

Each kernel's plain PyTorch version sits beside its wrapper; the wrapper
takes it for CPU tensors only. Importing this package builds nothing.
"""
from . import fused, hashmix, level, ops, probe

__all__ = ["fused", "hashmix", "level", "ops", "probe"]
