"""DGC sampling and RedSync (port of
``gaussiank_sgd_tpu/compressors/sampling.py``).

* ``dgcsampling`` (Deep Gradient Compression): the threshold is the
  ``ceil(density * s)``-th largest ``|x|`` of s indices drawn at random
  with replacement, nudged one f32 step towards zero so that the sampled
  entry itself passes ``|x| > t``; then the entries above it are packed
  into k slots, lowest index first.
* ``redsync``: 20 fixed bisection passes on ``[0, max|x|]`` that stop
  moving once the count above the threshold lies in ``[k, 2k]``; every
  entry above it is packed into 2k slots. ``redsynctrim`` packs k of them,
  lowest index first. What is not packed stays in the EF residual.

The draw and the compress are separate, as for RandomK
(``compressors/randomk.py``): ``dgc_sample`` draws from the bucket's
compressor generator, so every rank draws the same sample (unless
``decorrelate_comp_rng`` folds the rank in) and a resumed step draws it
again; ``dgc_compress_at`` takes given indices. The reference draws from
JAX's PRNG, which torch cannot reproduce, so the two agree on the compress
given the same sample. All of it stays on the device: no value is read on
the host.
"""

from __future__ import annotations

import math

import torch

from .base import CompressResult, pack_by_threshold


def dgc_num_samples(n: int, k: int, sample_ratio: float = 0.01) -> int:
    """``max(k, min(n, ceil(sample_ratio * n)))``, the reference's sample
    size."""
    return max(k, min(n, int(math.ceil(sample_ratio * n))))


def dgc_sample(n: int, k: int, generator: torch.Generator,
               sample_ratio: float = 0.01) -> torch.Tensor:
    """``dgc_num_samples`` int64 indices in ``[0, n)``, drawn uniformly
    with replacement."""
    return torch.randint(0, n, (dgc_num_samples(n, k, sample_ratio),),
                         generator=generator, device=generator.device)


def dgc_compress_at(acc: torch.Tensor, sample_idx: torch.Tensor, k: int,
                    density: float) -> CompressResult:
    """DGC on the given sample: the threshold from ``|acc[sample_idx]|``,
    then the pack of every entry above it into k slots."""
    k_sample = max(1, int(math.ceil(density * sample_idx.shape[0])))
    sample = acc[sample_idx].abs()
    t = torch.topk(sample, k_sample, sorted=True).values[-1]
    return pack_by_threshold(acc, torch.nextafter(t, torch.zeros_like(t)),
                             k)


def dgc_compress(acc: torch.Tensor, k: int, generator: torch.Generator, *,
                 density: float = 0.001,
                 sample_ratio: float = 0.01) -> CompressResult:
    """DGC sampling with the sample drawn from ``generator``."""
    return dgc_compress_at(
        acc, dgc_sample(acc.shape[0], k, generator, sample_ratio), k,
        density)


def redsync_threshold(abs_acc: torch.Tensor, k: int,
                      num_iters: int = 20) -> torch.Tensor:
    """The RedSync threshold of a flat ``|acc|``: from ``t = max/2`` on
    ``[0, max]``, ``num_iters`` bisection passes, each a full count, that
    leave ``t`` where it is once ``|{|x| > t}|`` lies in ``[k, 2k]``. Every
    midpoint rounds as the reference's does (a sum, then a product by
    0.5). A count outside the band after the last pass is a miss, and its
    entries are packed all the same."""
    hi = abs_acc.max()
    lo = torch.zeros_like(hi)
    t = 0.5 * hi
    for _ in range(num_iters):
        cnt = (abs_acc > t).sum(dtype=torch.int32)
        ok = (cnt >= k) & (cnt <= 2 * k)
        new_lo = torch.where(cnt > 2 * k, t, lo)
        new_hi = torch.where(cnt < k, t, hi)
        t = torch.where(ok, t, 0.5 * (new_lo + new_hi))
        lo = torch.where(ok, lo, new_lo)
        hi = torch.where(ok, hi, new_hi)
    return t


def redsync_compress(acc: torch.Tensor, k: int) -> CompressResult:
    """RedSync: every entry above the threshold, in 2k slots."""
    return pack_by_threshold(acc, redsync_threshold(acc.abs(), k), 2 * k)


def redsynctrim_compress(acc: torch.Tensor, k: int) -> CompressResult:
    """RedSync trimmed to k slots, lowest index first; the trimmed entries
    stay in the residual."""
    return pack_by_threshold(acc, redsync_threshold(acc.abs(), k), k)
