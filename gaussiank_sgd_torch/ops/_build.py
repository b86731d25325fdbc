"""Build and bind the port's CUDA kernels: ``nvcc`` into a shared library
with a plain C interface, loaded with ``ctypes``.

The build runs at first use, from the sources under ``csrc/`` only, into
``gaussiank_sgd_torch/build/`` (listed in ``.gitignore``). The library's
name carries a hash of its source, so an edited kernel is rebuilt and a
built one is reused. Nothing here runs at import time: this module is
imported on machines with no ``nvcc`` and no GPU.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor
from typing import NamedTuple

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "build")
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")

_P = ctypes.c_void_p
_LL = ctypes.c_longlong
# C signatures of each source's entry points
_SIGNATURES = {
    "fused_select": {
        "gk_select_candidates": [_P, _P, _P, _P, _P, ctypes.c_int, _LL,
                                 ctypes.c_int, ctypes.c_int, _P],
        "gk_ef_select_candidates": [_P, _P, ctypes.c_float, _P, _P, _P, _P,
                                    _P, ctypes.c_int, _LL, ctypes.c_int,
                                    ctypes.c_int, _P],
    },
    "threshold_select": {
        "gk_stats_blocks": [_LL],
        "gk_fused_stats": [_P, _LL, _P, ctypes.c_int, _P, _P],
        "gk_multi_threshold_counts": [_P, _LL, _P, _P, _P],
    },
    "batch_norm": {
        "gk_bn_forward": [_P, ctypes.c_int, _LL, _LL, _LL, ctypes.c_int,
                          ctypes.c_int, ctypes.c_int, _P, _P, _P, _P,
                          ctypes.c_float, ctypes.c_float, ctypes.c_float,
                          ctypes.c_float, _P, _P, _P, _P],
        "gk_bn_backward": [_P, _P, ctypes.c_int, _LL, _LL, _LL, ctypes.c_int,
                           ctypes.c_int, ctypes.c_int, _P, _P,
                           ctypes.c_float, _P, _P, _P, _P, _P],
    },
}
SOURCES = tuple(_SIGNATURES)


class BuiltLibrary(NamedTuple):
    lib: ctypes.CDLL
    path: str
    seconds: float      # wall time of the nvcc call (0.0 when reused)
    log: str            # nvcc's output, with -Xptxas -v's register report


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build "
                       "the port's kernels")


def _build(name: str) -> BuiltLibrary:
    src = os.path.join(CSRC_DIR, f"{name}.cu")
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(ARCH_FLAGS).encode())
    os.makedirs(BUILD_DIR, exist_ok=True)
    path = os.path.join(BUILD_DIR, f"lib{name}-{digest.hexdigest()[:16]}.so")
    seconds, log = 0.0, ""
    if not os.path.exists(path):
        tmp = f"{path}.{os.getpid()}.tmp"
        cmd = [_nvcc(), *ARCH_FLAGS, "-std=c++17", "-O3", "-shared",
               "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-o", tmp, src]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        seconds = time.perf_counter() - t0
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}) building "
                               f"{src}:\n{log}")
        os.replace(tmp, path)    # atomic: a concurrent build never sees half
    lib = ctypes.CDLL(path)
    for fn, argtypes in _SIGNATURES.get(name, {}).items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ctypes.c_int
    return BuiltLibrary(lib, path, seconds, log)


@functools.lru_cache(maxsize=None)
def load(name: str = "fused_select") -> BuiltLibrary:
    """The built library for ``csrc/<name>.cu``, building it on first use.
    (Two threads racing here may both run nvcc; the atomic rename keeps
    that harmless.)"""
    return _build(name)


def load_all() -> dict:
    """Every source's library, the nvcc calls started together (one
    thread each; nvcc runs outside the GIL)."""
    with ThreadPoolExecutor(max_workers=len(SOURCES)) as pool:
        return dict(zip(SOURCES, pool.map(load, SOURCES)))


def check(status: int, what: str) -> None:
    """Raise when a C entry point returned a nonzero ``cudaError_t``."""
    if status != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError_t "
                           f"{status}")
