"""GaussianK: a Gaussian-tail threshold estimate refined by bisection, then
mask selection (port of ``gaussiank_sgd_tpu/compressors/gaussian.py``).

The accumulated gradient is modelled as N(mu, sigma^2); the threshold
``|mu| + s * sigma`` with ``s = Phi^-1(1 - density/2)`` keeps about a
``density`` share of it, and ten bisection count passes pull the count
toward ``k``. The warm form carries the threshold across steps and needs
no search pass while the carried threshold stays usable.

Where the reference branches with ``lax.cond`` the port reads the scalar
predicate on the host once per call and runs only the branch taken: one
device-to-host sync per call of a warm compressor. Computing both branches
instead would run the ten-pass bisection every step.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import numpy as np
import torch

from .base import (CompressResult, bisect_threshold, finish_pack,
                   pack_by_threshold, select_by_mask)


@functools.lru_cache(maxsize=None)
def _quantile(density: float) -> float:
    """``s``, the two-sided Gaussian tail quantile of ``density``, taken in
    f64 and rounded to f32 as the reference multiplies it (computed once
    per density, like the reference's trace-time constant)."""
    p = 1.0 - min(max(density, 1e-12), 0.5) / 2.0
    s = torch.special.ndtri(torch.tensor(p, dtype=torch.float64))
    return float(np.float32(float(s)))


def gaussian_threshold_estimate(acc: torch.Tensor, density: float,
                                sigma_scale: Optional[float] = None
                                ) -> torch.Tensor:
    """Initial threshold ``t0 = |mu| + s * sigma`` along the last axis, with
    the population std (``jnp.std``: ``correction=0``). ``s`` is the
    density's tail quantile, or ``sigma_scale`` (``--sigma-scale``) when
    given, rounded to f32 as the reference multiplies it."""
    s = (_quantile(density) if sigma_scale is None
         else float(np.float32(sigma_scale)))
    mu = acc.mean(dim=-1)
    sigma = acc.std(dim=-1, correction=0)
    return mu.abs() + s * sigma


def gaussiank_compress(acc: torch.Tensor, k: int, *,
                       density: float = 0.001,
                       sigma_scale: Optional[float] = None) -> CompressResult:
    """Gaussian estimate, ten bisection passes, then ``|acc| > t`` packed to
    exactly ``k`` slots by index order. ``acc`` is not modified."""
    abs_acc = acc.abs()
    t0 = gaussian_threshold_estimate(acc, density, sigma_scale)
    return pack_by_threshold(acc, bisect_threshold(abs_acc, k, t0), k)


def _next_threshold(t: torch.Tensor, nsel: torch.Tensor, k: int,
                    gain: float) -> torch.Tensor:
    """``t * clip(((nsel + 1) / (k + 1)) ** gain, 1/4, 4)``; the power is
    taken in f64 and rounded to f32 (XLA's f32 ``pow`` may differ from it
    in the last bit)."""
    ratio = (nsel.to(torch.float32) + 1.0) / float(k + 1)
    nudge = (ratio.to(torch.float64) ** float(np.float32(gain))).to(
        torch.float32)
    return t * torch.clamp(nudge, 0.25, 4.0)


def _usable(count: torch.Tensor, state: torch.Tensor, k: int):
    return (state > 0) & (count >= k // 4) & (count <= 4 * k)


def gaussian_warm_compress(acc: torch.Tensor, k: int, state: torch.Tensor,
                           *, density: float = 0.001,
                           sigma_scale: Optional[float] = None,
                           gain: float = 0.18,
                           ) -> Tuple[CompressResult, torch.Tensor]:
    """GaussianK with the threshold carried across steps as ``state``.

    Warm (the carried threshold is set and its count is within
    ``[k/4, 4k]``): select with it by magnitude priority; no search pass.
    Cold: the Gaussian estimate and ten bisection passes, index priority.
    Either way the controller nudges the threshold toward count == k.

    One host sync per call: the predicate is read on the host and only the
    branch taken runs. ``acc`` is not modified."""
    abs_acc = acc.abs()
    mask_prev = abs_acc > state
    if bool(_usable(mask_prev.sum(dtype=torch.int32), state, k)):
        sent_idx, val, nsel = select_by_mask(acc, mask_prev, k,
                                             priority="magnitude")
        t = state
    else:
        t0 = gaussian_threshold_estimate(acc, density, sigma_scale)
        t = bisect_threshold(abs_acc, k, t0)
        sent_idx, val, nsel = select_by_mask(acc, abs_acc > t, k)
    comp, residual = finish_pack(acc.clone(), sent_idx, val)
    return CompressResult(comp, residual, nsel), _next_threshold(t, nsel, k,
                                                                 gain)


def gaussian_warm_compress_batched(x: torch.Tensor, k: int,
                                   state: torch.Tensor, *,
                                   density: float = 0.001,
                                   sigma_scale: Optional[float] = None,
                                   gain: float = 0.18,
                                   ) -> Tuple[CompressResult, torch.Tensor]:
    """gaussian_warm over ``[n_chunks, chunk]`` with per-lane recovery.

    When every lane is usable only the warm selection runs. Otherwise the
    estimate and bisection run for all lanes, and each lane adopts the fresh
    threshold only if its own was unusable: warm lanes keep theirs. Both
    branches select by magnitude priority. One host sync per call (the
    all-lanes predicate). ``x`` is not modified."""
    abs_x = x.abs()
    mask_prev = abs_x > state[:, None]
    usable = _usable(mask_prev.sum(dim=1, dtype=torch.int32), state, k)
    if bool(usable.all()):
        mask, t_eff = mask_prev, state
    else:
        t_fresh = bisect_threshold(abs_x, k, gaussian_threshold_estimate(
            x, density, sigma_scale))
        t_eff = torch.where(usable, state, t_fresh)
        mask = abs_x > t_eff[:, None]
    sent_idx, val, nsel = select_by_mask(x, mask, k, priority="magnitude")
    comp, residual = finish_pack(x.clone(), sent_idx, val)
    return (CompressResult(comp, residual, nsel),
            _next_threshold(t_eff, nsel, k, gain))
