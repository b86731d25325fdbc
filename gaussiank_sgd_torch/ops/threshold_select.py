"""Threshold estimation in three passes — port of
``gaussiank_sgd_tpu/ops/pallas_select.py``.

1. ``fused_stats`` (kernel B3): one pass -> (sum, sum of squares, max|x|),
   which give mu, sigma and the search's upper bound.
2. ``multi_threshold_counts`` (kernel B4) on 32 log-spaced candidates
   from deep in the bulk (~0.05 sigma) to max|x|: one pass that counts
   every element against all 32 (the kernel bins each element by a binary
   search into the thresholds, sorted once per block).
3. The same kernel on 32 linear candidates inside the bracket that pass 2
   found; the candidate whose count is nearest k is the threshold.

Both kernels are CUDA C++ (``csrc/threshold_select.cu``); their plain
PyTorch versions live here and run for CPU tensors only. The estimate reads
nothing on the host. The pack after it is ``pack_by_threshold``.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..compressors.base import CompressResult, pack_by_threshold
from . import _build

_NCAND = 32           # candidate thresholds per counting pass
# jnp.linspace(0, 1, 32) in f32 is i * f32(1/31), which is not always the
# correctly rounded i/31 that np.linspace gives
_STEP = float(np.float32(1.0) / np.float32(_NCAND - 1))

# Launches of each CUDA kernel, counted by its wrapper where it launches.
# Plain-version calls (CPU tensors) do not count.
LAUNCHES = {"fused_stats": 0, "multi_threshold_counts": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _check_flat(flat: torch.Tensor) -> None:
    if flat.dtype != torch.float32:
        raise TypeError(f"flat must be float32, got {flat.dtype}")
    if flat.dim() != 1 or flat.numel() == 0:
        raise ValueError(f"flat must be a non-empty 1-D buffer, got shape "
                         f"{tuple(flat.shape)}")
    if not flat.is_contiguous():
        raise ValueError("flat must be contiguous")
    if flat.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {flat.device}")


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


# ------------------------------------------------------------------- B3

def fused_stats_plain(flat: torch.Tensor):
    """Plain version of kernel B3 (any device)."""
    return flat.sum(), (flat * flat).sum(), flat.abs().amax()


def fused_stats(flat: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One pass over a flat f32 buffer: ``(sum, sum_of_squares, max|x|)``
    as 0-d f32 tensors.

    Kernel B3 on a CUDA tensor; the plain version on a CPU tensor. The max
    is exact, so the two agree bit for bit on it. The sums differ only in
    summation order: the kernel adds per thread, then in a fixed tree per
    block, then the block partials in a fixed order in a second one-block
    pass (no float atomics, so a run repeats bit for bit). Against the
    plain version ``|d sum| <= 1e-6 * sum|x|`` and ``|d sumsq| <= 1e-5 *
    sumsq``."""
    _check_flat(flat)
    if flat.device.type == "cpu":
        return fused_stats_plain(flat)
    lib = _build.load("threshold_select").lib
    blocks = lib.gk_stats_blocks(flat.numel())
    scratch = torch.empty((blocks, 3), dtype=torch.float32,
                          device=flat.device)
    out = torch.empty(3, dtype=torch.float32, device=flat.device)
    _build.check(lib.gk_fused_stats(
        flat.data_ptr(), flat.numel(), scratch.data_ptr(), blocks,
        out.data_ptr(), _stream(flat.device)), "fused_stats")
    LAUNCHES["fused_stats"] += 1
    return out[0], out[1], out[2]


# ------------------------------------------------------------------- B4

def multi_threshold_counts_plain(flat: torch.Tensor,
                                 thresholds: torch.Tensor) -> torch.Tensor:
    """Plain version of kernel B4 (any device): one compare-and-count pass
    per threshold."""
    ax = flat.abs()
    counts = torch.stack([(ax > thresholds[j]).sum()
                          for j in range(_NCAND)])
    return counts.to(torch.float32)


def multi_threshold_counts(flat: torch.Tensor,
                           thresholds: torch.Tensor) -> torch.Tensor:
    """One pass: ``counts[j] = |{|x| > thresholds[j]}|`` for 32 f32
    thresholds (in any order), returned as f32 ``[32]``.

    Kernel B4 on a CUDA tensor, counting in integers (n < 2^31); the plain
    version on a CPU tensor. The reference accumulates its counts in f32, so
    the three agree exactly while n <= 2^24 (VGG-16's 14,986,698 included);
    above that the port rounds each count once. One difference from the
    reference: it pads ``flat`` with zeros to a multiple of 8192, and
    ``|0| > t`` holds for any ``t < 0`` (``-inf`` included), so at a
    negative threshold it also counts its padding; the port counts the n
    real elements only. The estimate never makes a negative candidate."""
    _check_flat(flat)
    if (thresholds.dtype != torch.float32
            or tuple(thresholds.shape) != (_NCAND,)
            or thresholds.device != flat.device
            or not thresholds.is_contiguous()):
        raise ValueError(f"thresholds must be a contiguous f32 [{_NCAND}] "
                         f"tensor on {flat.device}")
    if flat.device.type == "cpu":
        return multi_threshold_counts_plain(flat, thresholds)
    counts = torch.zeros(_NCAND, dtype=torch.int32, device=flat.device)
    lib = _build.load("threshold_select").lib
    _build.check(lib.gk_multi_threshold_counts(
        flat.data_ptr(), flat.numel(), thresholds.data_ptr(),
        counts.data_ptr(), _stream(flat.device)), "multi_threshold_counts")
    LAUNCHES["multi_threshold_counts"] += 1
    return counts.to(torch.float32)


# ------------------------------------------------------- the estimate

def _bracket(thresholds: torch.Tensor, counts: torch.Tensor,
             k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``[lo, hi]``: the last candidate with count >= k and the next one.
    Degenerate cases: k above every count -> ``[0, t_0]``; k below every
    count -> ``[t_31, t_31]``."""
    ge = counts >= float(np.float32(k))
    found = ge.any()
    # index of the last True, 0 if none
    idx = (torch.arange(_NCAND, device=counts.device) * ge).amax()
    lo = torch.where(found, _at(thresholds, idx), 0.0)
    hi = torch.where(found,
                     _at(thresholds, torch.clamp(idx + 1, max=_NCAND - 1)),
                     thresholds[0])
    return lo, hi


def _at(t: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """``t[i]`` for a 0-d index tensor, read on the device (no host sync)."""
    return t.gather(0, i.reshape(1)).reshape(())


def _fractions(device) -> torch.Tensor:
    """The reference's ``jnp.linspace(0, 1, 32)``, made on ``device``."""
    return torch.arange(_NCAND, dtype=torch.float32, device=device) * _STEP


def _log_candidates(lo0: torch.Tensor, hi0: torch.Tensor) -> torch.Tensor:
    """``lo0 * exp(f * log(hi0 / lo0))`` for the 32 fractions ``f``. f32
    ``exp`` and ``log`` are not XLA's, so these may differ from the
    reference's by a few ulp."""
    return lo0 * torch.exp(_fractions(lo0.device) * torch.log(hi0 / lo0))


def _lin_candidates(lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """``lo + (hi - lo) * f``, each operation rounded (XLA on the CPU may
    fuse the last two into one multiply-add)."""
    return lo + (hi - lo) * _fractions(lo.device)


def pallas_threshold_estimate(flat: torch.Tensor, k: int) -> torch.Tensor:
    """Threshold ``t`` with ``|{|x| > t}| ~= k`` in three passes (B3, then
    B4 twice), as a 0-d f32 tensor; nothing is read on the host."""
    s, ss, amax = fused_stats(flat)
    n = flat.shape[0]
    mu = s / n
    sigma = torch.sqrt(torch.clamp(ss / n - mu * mu, min=1e-30))
    # pass 2: log-spaced candidates from deep inside the bulk to the max
    lo0 = torch.maximum(0.05 * sigma, amax * 1e-7) + 1e-30
    hi0 = torch.maximum(amax, lo0 * 2.0)
    log_cand = _log_candidates(lo0, hi0)
    lo, hi = _bracket(log_cand, multi_threshold_counts(flat, log_cand), k)
    # pass 3: linear candidates inside the bracket
    lin_cand = _lin_candidates(lo, hi)
    c2 = multi_threshold_counts(flat, lin_cand)
    # the candidate whose count is nearest k (ties -> the first, i.e. the
    # larger count)
    return _at(lin_cand, torch.argmin((c2 - float(np.float32(k))).abs()))


def pallas_gaussian_compress(acc: torch.Tensor, k: int) -> CompressResult:
    """GaussianK with the three-pass estimator: the same contract as
    ``gaussiank_compress`` (exactly k slots, exact EF residual). ``acc`` is
    not modified."""
    return pack_by_threshold(acc, pallas_threshold_estimate(acc, k), k)
