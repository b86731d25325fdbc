"""Exact top-k by magnitude: ``topk``, and what the port runs for
``approxtopk`` and ``approxtopk16`` (port of
``gaussiank_sgd_tpu/compressors/exact.py``).

The reference's ``topk`` takes ``lax.top_k(|acc|, k)``: exactly k entries,
zeros included, larger magnitudes first and ties to the lowest index. Here
the same selection is a ``torch.topk`` over ``magnitude_key``, an integer
key with no ties, so the CPU and the card pick the reference's entries in
its order.

``approxtopk`` is ``lax.approx_max_k``, the TPU's two-level select, which
torch has no twin of. On the CPU XLA lowers it to the exact top-k, so the
port runs the exact one (recall 1, above the reference's 0.95 target) and
the registry's spec name says so. ``approxtopk16`` ranks ``bf16(|acc|)``:
its sent values still gather from the f32 ``acc``; among entries tied with
the k-th bf16 magnitude the port sends the lowest indices, where the
reference's ``approx_max_k`` picks in an order of its own.
"""

from __future__ import annotations

import torch

from .base import CompressResult, finish_pack, magnitude_key


def topk_compress(acc: torch.Tensor, k: int, *,
                  bf16: bool = False) -> CompressResult:
    """The k entries of the flat ``acc`` largest in ``|acc|`` (``bf16``: in
    ``bf16(|acc|)``), largest first: values ``acc[idx]``, and a residual
    with the sent entries zeroed; ``acc`` is not modified. num_selected is
    k."""
    idx = torch.topk(magnitude_key(acc, bf16), k, sorted=True).indices
    comp, residual = finish_pack(acc.clone(), idx, acc[idx])
    return CompressResult(comp, residual,
                          torch.full((), k, dtype=torch.int32,
                                     device=acc.device))
