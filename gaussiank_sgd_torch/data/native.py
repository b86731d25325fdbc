"""ctypes bindings of the native host pipeline ``native/io_pipeline.cpp``
(port of ``gaussiank_sgd_tpu/data/native.py``).

The library assembles CIFAR batches (index gather, u8 -> f32
normalisation, pad-4 reflect random crop and horizontal flip, in one
threaded pass with a counter-based generator a batch), shuffles indices,
and computes AN4's log spectrograms. It is built with g++ the first time it
is asked for, with the reference's flags, into
``gaussiank_sgd_torch/build/``: through a temporary file of its own and an
``os.replace``, so a reader never sees a half-written library, and under
an exclusive ``fcntl`` lock on ``build/libgksgd_io.lock``, so processes
that ask at once wait for one build (each looks again under the lock)
instead of each compiling against g++'s time limit. When it cannot be
built or loaded, ``available()`` is false, ``load_error()`` says why, and
the callers take their numpy paths, the reference's selection rule (their
batches then differ from the native ones, as the reference's do).
"""

from __future__ import annotations

import ctypes
import fcntl
import os
import subprocess
import tempfile
import threading
from typing import Optional

import numpy as np

_REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", ".."))
_SRC = os.path.join(_REPO, "native", "io_pipeline.cpp")
_LIB_PATH = os.path.join(_REPO, "gaussiank_sgd_torch", "build",
                         "libgksgd_io.so")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False
_error: Optional[str] = None       # why the last build or load failed


def _build() -> bool:
    """g++ the source into a private file, then move it into place; on a
    failure ``_error`` holds the reason."""
    global _error
    if not os.path.exists(_SRC):
        _error = f"no source at {_SRC}"
        return False
    os.makedirs(os.path.dirname(_LIB_PATH), exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=os.path.dirname(_LIB_PATH),
                               suffix=".so.tmp")
    os.close(fd)
    cmd = ["g++", "-O3", "-march=native", "-fPIC", "-std=c++17", "-shared",
           "-pthread", "-o", tmp, _SRC]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        os.replace(tmp, _LIB_PATH)
        return True
    except subprocess.CalledProcessError as e:
        _error = (f"g++ exited {e.returncode}: "
                  f"{e.stderr.decode(errors='replace')[-500:]}")
    except subprocess.TimeoutExpired:
        _error = "g++ ran past its 120 s limit"
    except OSError as e:
        _error = f"g++ could not run: {e}"
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return False


def _build_locked(force: bool = False) -> bool:
    """Build (with ``force``, always; else unless another process built a
    fresh library while this one waited for the lock): one build at a
    time, per build directory."""
    os.makedirs(os.path.dirname(_LIB_PATH), exist_ok=True)
    lock = os.path.splitext(_LIB_PATH)[0] + ".lock"
    # gklint: disable=conc-blocking-under-lock -- the in-process lock serializes the one build; this file is the cross-process build lock, opened to take its flock
    with open(lock, "a") as fh:
        fcntl.flock(fh, fcntl.LOCK_EX)
        try:
            if not force and os.path.exists(_LIB_PATH) and not _stale():
                return True
            return _build()
        finally:
            fcntl.flock(fh, fcntl.LOCK_UN)


def _stale() -> bool:
    """The built library predates the source."""
    try:
        return os.path.getmtime(_SRC) > os.path.getmtime(_LIB_PATH)
    except OSError:
        return False


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare every entry point; raises AttributeError on a library that
    lacks one."""
    u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    lib.gk_assemble_batch.argtypes = [
        u8p, i32p, i32p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, f32p, f32p, f32p, i32p,
        ctypes.c_uint64, ctypes.c_int, ctypes.c_int]
    lib.gk_assemble_batch.restype = None
    lib.gk_shuffle_indices.argtypes = [i32p, ctypes.c_int, ctypes.c_uint64]
    lib.gk_shuffle_indices.restype = None
    lib.gk_log_spectrogram.argtypes = [f32p, ctypes.c_int, ctypes.c_int,
                                       ctypes.c_int, f32p, ctypes.c_int]
    lib.gk_log_spectrogram.restype = None
    return lib


def load() -> Optional[ctypes.CDLL]:
    """The library, built if needed (once a process); None when it cannot
    be built or loaded (``load_error()`` says why)."""
    global _lib, _tried, _error
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if ((not os.path.exists(_LIB_PATH) or _stale())
                and not _build_locked()):
            return None
        for attempt in range(2):
            try:
                _lib = _bind(ctypes.CDLL(_LIB_PATH))
                _error = None
                return _lib
            except OSError as e:
                _error = f"{_LIB_PATH} does not load: {e}"
                return None
            except AttributeError:
                # a library built from an older source: rebuild once
                _error = f"{_LIB_PATH} lacks an entry point"
                if attempt or not _build_locked(force=True):
                    return None
        return None


def available() -> bool:
    return load() is not None


def load_error() -> Optional[str]:
    """Why the library is not available (None when it loaded or was not
    asked for yet)."""
    return _error


def _loaded() -> ctypes.CDLL:
    lib = load()
    if lib is None:
        raise RuntimeError("the native host pipeline is not available "
                           "(g++ could not build native/io_pipeline.cpp)")
    return lib


def assemble_batch(images_u8: np.ndarray, labels: np.ndarray,
                   sel: np.ndarray, mean: np.ndarray, std: np.ndarray,
                   seed: int, augment: bool, pad: int = 4,
                   nthreads: int = 4):
    """Rows ``sel`` of ``images_u8`` ``[N, H, W, C]`` gathered, normalised
    with ``mean``/``std`` and, with ``augment``, randomly cropped from the
    ``pad``-reflect-padded image and flipped (per-image draws from
    ``seed``): ``(x f32 [B, H, W, C], y i32 [B])``."""
    lib = _loaded()
    if images_u8.dtype != np.uint8 or images_u8.ndim != 4:
        raise ValueError(f"images must be u8 [N, H, W, C], got "
                         f"{images_u8.dtype} {images_u8.shape}")
    sel = np.ascontiguousarray(sel, np.int32)
    if sel.size and (sel.min() < 0 or sel.max() >= len(images_u8)):
        raise IndexError("batch indices outside the dataset")
    b = int(sel.shape[0])
    h, w, c = images_u8.shape[1:]
    out_x = np.empty((b, h, w, c), np.float32)
    out_y = np.empty((b,), np.int32)
    lib.gk_assemble_batch(
        np.ascontiguousarray(images_u8),
        np.ascontiguousarray(labels, np.int32), sel, b, h, w, c, pad,
        np.ascontiguousarray(mean, np.float32),
        np.ascontiguousarray(std, np.float32),
        out_x, out_y, ctypes.c_uint64(seed & (2 ** 64 - 1)),
        1 if augment else 0, nthreads)
    return out_x, out_y


def log_spectrogram(samples: np.ndarray, n_fft: int, stride: int,
                    nthreads: int = 4) -> np.ndarray:
    """The STFT's log1p magnitude with a Hamming window, ``[n_fft // 2 +
    1, frames]`` f32, not normalised."""
    lib = _loaded()
    samples = np.ascontiguousarray(samples, np.float32)
    if len(samples) < n_fft:
        raise ValueError(f"need >= n_fft={n_fft} samples, got "
                         f"{len(samples)} (pad first)")
    n_freq = n_fft // 2 + 1
    n_frames = 1 + (len(samples) - n_fft) // stride
    out = np.empty((n_freq, n_frames), np.float32)
    lib.gk_log_spectrogram(samples, len(samples), n_fft, stride, out,
                           nthreads)
    return out


def shuffle_indices(n: int, seed: int) -> np.ndarray:
    """A permutation of ``range(n)`` (i32) drawn from ``seed``."""
    lib = _loaded()
    idx = np.empty((n,), np.int32)
    lib.gk_shuffle_indices(idx, n, ctypes.c_uint64(seed & (2 ** 64 - 1)))
    return idx
