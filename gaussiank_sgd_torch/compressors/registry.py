"""Compressor registry (port of ``gaussiank_sgd_tpu/compressors/registry.py``).

Each entry is a :class:`CompressorSpec` binding hyper-parameters into a
uniform function plus the static metadata the train step needs. Every name
of the reference builds a spec: ``none``, ``topk``, ``approxtopk`` and
``approxtopk16`` (the exact top-k; the spec's name says so), the GaussianK
family (``gaussian``, ``gaussian_warm``, ``gaussian_pallas`` and the
default selector ``gaussian_fused``), ``randomk``, ``randomkec``,
``dgcsampling``, ``redsync`` (2k slots) and ``redsynctrim``.
"""

from __future__ import annotations

import functools
from typing import Callable, NamedTuple, Optional

import torch

from .base import CompressedGrad, CompressResult
from .exact import topk_compress
from .gaussian import (gaussian_warm_compress, gaussian_warm_compress_batched,
                       gaussiank_compress)
from .randomk import randomk_compress, randomkec_compress
from .sampling import dgc_compress, redsync_compress, redsynctrim_compress


class CompressorSpec(NamedTuple):
    name: str
    fn: Callable[..., CompressResult]   # (acc, k[, state][, generator])
    # the fn takes a torch.Generator last: the train step hands it the
    # compressor stream of its (seed, step, bucket)
    requires_rng: bool
    uses_error_feedback: bool
    # packed slots for a nominal k; None for the dense 'none' compressor
    out_k: Optional[Callable[[int], int]]
    # stateful compressors carry a per-bucket threshold across steps:
    # fn is (acc, k, state) -> (CompressResult, new_state)
    stateful: bool = False
    init_state: float = 0.0
    # (x [n_chunks, chunk], k, state [n_chunks]) -> (CompressResult, state)
    batched_fn: Optional[Callable] = None
    # fused EF+select: (res2d, g2d, scale, k, state) -> (CompressResult,
    # state) over block-aligned [n_chunks, chunk_pad] rows
    fused_ef_fn: Optional[Callable] = None
    # (chunk, k) -> padded chunk the fused EF kernel needs, or None
    ef_pad: Optional[Callable[[int, int], Optional[int]]] = None


def none_compress(acc: torch.Tensor, k: int) -> CompressResult:
    """Dense pass-through: every entry is sent, the residual is zero."""
    n = acc.shape[0]
    idx = torch.arange(n, dtype=torch.int32, device=acc.device)
    # the count by a fill, not a host-to-device copy that would wait for
    # the queued kernels
    return CompressResult(CompressedGrad(idx, acc), torch.zeros_like(acc),
                          torch.full((), n, dtype=torch.int32,
                                     device=acc.device))


def get_compressor(name: str, *, density: float = 0.001,
                   sigma_scale: Optional[float] = None) -> CompressorSpec:
    """Build a compressor spec with hyper-parameters bound. ``sigma_scale``
    (``--sigma-scale``) replaces the Gaussian tail quantile of the
    threshold estimate where one runs: ``gaussian``, ``gaussian_warm`` and
    ``gaussian_fused``'s warm forms (its kernel path bootstraps from its
    candidates and never estimates, as in the reference)."""
    name = "none" if name is None else name.lower()
    if name == "auto":
        name = DEFAULT_SELECTOR
    if name in ("none", "dense"):
        return CompressorSpec("none", none_compress, False, False, None)
    if name == "topk":
        return CompressorSpec("topk", topk_compress, False, True,
                              lambda k: k)
    if name in ("approxtopk", "approx_topk"):
        # lax.approx_max_k has no torch twin; the exact top-k runs
        return CompressorSpec("approxtopk(exact)", topk_compress, False,
                              True, lambda k: k)
    if name in ("approxtopk16", "approx_topk16"):
        return CompressorSpec("approxtopk16(exact-bf16)",
                              functools.partial(topk_compress, bf16=True),
                              False, True, lambda k: k)
    if name in ("gaussian", "gaussiank"):
        return CompressorSpec(
            "gaussian", functools.partial(gaussiank_compress,
                                          density=density,
                                          sigma_scale=sigma_scale),
            False, True, lambda k: k)
    if name in ("gaussian_warm", "gaussianw"):
        return _warm_spec("gaussian_warm", density, sigma_scale)
    if name in ("gaussian_pallas", "gaussianp"):
        # the 'gaussian' selection contract with the three-pass estimator
        # (kernels B3 and B4)
        from ..ops.threshold_select import pallas_gaussian_compress
        return CompressorSpec("gaussian_pallas", pallas_gaussian_compress,
                              False, True, lambda k: k)
    if name in ("gaussian_fused", "gaussianf"):
        from ..ops.fused_select import (ef_padded_chunk,
                                        gaussian_fused_compress,
                                        gaussian_fused_compress_batched,
                                        gaussian_fused_ef_compress_batched,
                                        supports_density)
        if not supports_density(density):
            # the candidate buffer cannot hold k above density 1/32: the
            # warm pack runs, and the name says so
            return _warm_spec("gaussian_fused(warm-fallback)", density,
                              sigma_scale)
        kw = dict(density=density, sigma_scale=sigma_scale)
        fn = functools.partial(gaussian_fused_compress, **kw)
        bfn = functools.partial(gaussian_fused_compress_batched, **kw)
        effn = functools.partial(gaussian_fused_ef_compress_batched, **kw)
        epad = functools.partial(ef_padded_chunk, density=density)
        return CompressorSpec("gaussian_fused", fn, False, True, lambda k: k,
                              stateful=True, batched_fn=bfn,
                              fused_ef_fn=effn, ef_pad=epad)
    if name == "randomk":
        # no error feedback: the residual it returns is zero
        return CompressorSpec("randomk", randomk_compress, True, False,
                              lambda k: k)
    if name == "randomkec":
        return CompressorSpec("randomkec", randomkec_compress, True, True,
                              lambda k: k)
    if name == "dgcsampling":
        return CompressorSpec(
            "dgcsampling", functools.partial(dgc_compress, density=density),
            True, True, lambda k: k)
    if name == "redsync":
        return CompressorSpec("redsync", redsync_compress, False, True,
                              lambda k: 2 * k)
    if name == "redsynctrim":
        return CompressorSpec("redsynctrim", redsynctrim_compress, False,
                              True, lambda k: k)
    raise ValueError(f"unknown compressor {name!r}; known: {sorted(NAMES)}")


def _warm_spec(name: str, density: float,
               sigma_scale: Optional[float]) -> CompressorSpec:
    kw = dict(density=density, sigma_scale=sigma_scale)
    return CompressorSpec(
        name, functools.partial(gaussian_warm_compress, **kw), False, True,
        lambda k: k, stateful=True,
        batched_fn=functools.partial(gaussian_warm_compress_batched, **kw))


NAMES = ("none", "topk", "approxtopk", "approxtopk16", "gaussian",
         "gaussian_warm", "gaussian_fused", "gaussian_pallas", "randomk",
         "randomkec", "dgcsampling", "redsync", "redsynctrim")

# The framework's ex-ante default selector, as in the reference.
DEFAULT_SELECTOR = "gaussian_fused"
