"""Build the Dash CUDA kernels with nvcc and bind them with ctypes.

The sources in ``csrc/`` have a plain C interface: every entry point takes
device pointers, sizes and a stream, launches on that stream and returns
``cudaGetLastError()``. They are compiled for ``sm_90a`` at first use, one
``nvcc`` process per source started together, then linked into one shared
library under ``build/repro_torch_kernels/`` at the checkout root, keyed by
a hash of the sources and flags so an edit rebuilds and an unchanged tree
reuses the library. Nothing here runs at import time.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = ("hashmix.cu", "probe.cu", "fused.cu", "level.cu")
HEADERS = ("dash_common.cuh",)
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-Xcompiler", "-fPIC")

_P, _I64, _I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
#: C signature of every entry point (all return an int cudaError_t)
SIGNATURES = {
    "dash_bulk_hash": (_P, _P, _P, _P, _P, _I64, _P),
    "dash_fingerprint_probe": (_P, _P, _I64, _I, _P, _P, _P, _P, _I64, _P, _P),
    "dash_fused_probe": (_P, _P, _P, _P, _P, _P, _P, _I64, _P, _P),
    "dash_level_scan": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I64, _I, _P),
    "dash_noop_launch": (_P,),
    "dash_latency_chase": (_P, _I64, _P, _P),
}

_lib = None
#: compiler output of the last build (ptxas register / spill report)
build_log = ""


def _nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                           "machine with the CUDA toolkit")
    return found


def _digest() -> str:
    h = hashlib.sha256(" ".join(FLAGS).encode())
    for name in HEADERS + SOURCES:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile (if needed) and return the path of the shared library."""
    global build_log
    out = BUILD_DIR / f"libdash_kernels-{_digest()}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs, procs = [], []
        for src in SOURCES:
            obj = Path(tmp) / (src + ".o")
            objs.append(str(obj))
            procs.append(subprocess.Popen(
                [nvcc, *FLAGS, "-Xptxas", "-v", "-c", str(CSRC / src),
                 "-o", str(obj)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        logs = []
        for src, p in zip(SOURCES, procs):
            text, _ = p.communicate()
            logs.append(f"== {src}\n{text}")
            if p.returncode != 0:
                for q in procs:
                    q.kill()
                raise RuntimeError(f"nvcc failed on {src}:\n{text}")
        lib_tmp = Path(tmp) / out.name
        link = subprocess.run([nvcc, *FLAGS, "-shared", *objs, "-o", str(lib_tmp)],
                              capture_output=True, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}{link.stderr}")
        os.replace(lib_tmp, out)     # atomic: concurrent builders agree
    build_log = "\n".join(logs)
    return out


def load() -> ctypes.CDLL:
    """The bound library (built on first use)."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, args in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = list(args)
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def check(rc: int, name: str) -> None:
    """Raise on a nonzero cudaError_t from a launch."""
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed (cudaError {rc})")


def require(t, name: str, dtype, ndim: int, like=None) -> None:
    """Check a kernel argument's type, rank and layout (and, with ``like``,
    that it matches another argument's shape and device)."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a tensor")
    if t.dtype != dtype or t.dim() != ndim:
        raise TypeError(f"{name}: expected {ndim}-d {dtype}, got "
                        f"{t.dim()}-d {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")
    if like is not None and (t.shape != like.shape or t.device != like.device):
        raise ValueError(f"{name}: shape/device {tuple(t.shape)}/{t.device} "
                         f"differs from {tuple(like.shape)}/{like.device}")


def require_cuda(t) -> None:
    """The kernels run only on CUDA tensors; there is no silent fallback."""
    if t.device.type != "cuda":
        raise ValueError(f"kernels run on CUDA or CPU tensors, not {t.device}")


def same_device(ref, *ts) -> None:
    for t in ts:
        if t.device != ref.device:
            raise ValueError(f"tensor on {t.device}, expected {ref.device}")


def stream(t) -> int:
    """Handle of PyTorch's current stream on ``t``'s CUDA device, read the
    way PyTorch's own kernel launchers read it (no Stream object built)."""
    return torch._C._cuda_getCurrentRawStream(t.device.index)
