"""Core types of the gradient compressors (port of
``gaussiank_sgd_tpu/compressors/base.py``).

Every compressor returns exactly ``k`` packed ``(index, value)`` pairs;
invalid slots are padded with ``(0, 0.0)``, a no-op under scatter-add. The
error-feedback (EF) residual zeroes exactly the entries that were sent, so
``decompress(sent) + residual == acc`` holds element for element. A
selection over more than ``k`` masked entries keeps the first ``k`` by
index (or, with magnitude priority, the largest by bf16 magnitude, ties to
the lowest index); the rest stay in the residual.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np
import torch


class CompressedGrad(NamedTuple):
    """A fixed-size packed sparse gradient: int32 flat ``indices`` and the
    matching ``values`` (``[..., k]``); padding slots hold ``(0, 0.0)``."""

    indices: torch.Tensor
    values: torch.Tensor

    @property
    def k(self) -> int:
        return self.indices.shape[-1]


class CompressResult(NamedTuple):
    compressed: CompressedGrad
    residual: torch.Tensor      # same shape as the input acc: the EF carry
    num_selected: torch.Tensor  # int32: entries that crossed the threshold
                                # (before truncation to k)


def k_for(numel: int, density: float) -> int:
    """Static top-k size for a tensor: ``max(1, ceil(density * numel))``."""
    return max(1, int(math.ceil(float(density) * numel)))


def finish_pack(acc: torch.Tensor, sent_idx: torch.Tensor,
                val: torch.Tensor) -> tuple:
    """``(CompressedGrad, residual)`` from a sentinel-marked selection.

    ``acc`` is ``[..., n]`` and ``sent_idx``/``val`` are ``[..., k]`` with
    indices local to the last axis; ``n`` marks an invalid slot. The sent
    entries are zeroed IN PLACE, so the residual is ``acc`` itself: callers
    hand over a buffer they own (the fused EF kernel's fresh output) or a
    copy. Invalid slots touch nothing, and their packed index maps to 0.
    """
    if not acc.is_contiguous():
        raise ValueError("finish_pack zeroes acc in place; pass a "
                         "contiguous buffer")
    n = acc.shape[-1]
    valid = sent_idx < n
    idx = torch.where(valid, sent_idx, 0).to(torch.int32)
    rows = acc.view(-1, n)
    idx2 = idx.view(rows.shape[0], -1).to(torch.int64)
    valid2 = valid.view(rows.shape[0], -1)
    # invalid slots land on their row's element 0 and write what that
    # element ends as (0 if a valid slot sends it), so every write to one
    # position agrees and the scatter is deterministic
    sent0 = (valid2 & (idx2 == 0)).any(dim=-1, keepdim=True)
    first = torch.where(sent0, 0.0, rows[:, :1])
    rows.scatter_(1, idx2, torch.where(valid2, 0.0, first))
    return CompressedGrad(idx, val), acc


def scatter_add_ordered(dest: torch.Tensor, idx: torch.Tensor,
                        val: torch.Tensor,
                        rounds: Optional[int] = None) -> torch.Tensor:
    """``dest[idx[j]] += val[j]`` in place, one ``j`` after another in
    buffer order, as the reference's ``.at[idx].add(val, mode="drop")``
    adds on the CPU; indices outside ``[0, n)`` are dropped. The bits are
    the same on the CPU and the card, on every run.

    ``index_add_`` on CUDA adds duplicate indices by atomics in no fixed
    order, so the pairs go in rounds: a stable sort gives each pair its
    occurrence number within its index, and round ``j`` adds the ``j``-th
    occurrence of every index. Everything a round does not add enters it
    as ``-0.0``, the exact identity of a rounded add, so the atomics of one
    round cannot reorder anything that matters. Pairs whose value is
    ``+0.0`` (padding slots) are left to one last pass: adding ``+0.0``
    only turns ``-0.0`` into ``+0.0``, and where in the sequence it
    happens does not change the result.

    ``rounds`` is the most pairs of nonzero-or-``-0.0`` value any index
    may hold (a gathered buffer of P payloads whose valid indices are
    distinct within each has at most P), read from the data when None: a
    host read. A pair above it would be dropped, so pass it only when the
    buffer guarantees it. With ``rounds=1`` no order is left to keep, and
    one ``index_add_`` does it all (dropped pairs add ``-0.0``)."""
    n = dest.shape[0]
    idx = idx.reshape(-1).to(torch.int64)
    val = val.reshape(-1).to(dest.dtype)
    inside = (idx >= 0) & (idx < n)
    if rounds == 1:
        return dest.index_add_(0, torch.where(inside, idx, 0),
                               torch.where(inside, val, -0.0))
    pos_zero = (val == 0) & ~torch.signbit(val)
    key = torch.where(inside & ~pos_zero, idx, n)
    skey, perm = torch.sort(key, stable=True)
    occ = (torch.arange(skey.shape[0], device=skey.device)
           - torch.searchsorted(skey, skey))
    ordered = skey < n
    if rounds is None:
        rounds = (int(torch.where(ordered, occ, -1).max()) + 1
                  if skey.numel() else 0)
    sidx, sval = torch.where(ordered, skey, 0), val[perm]
    for j in range(rounds):
        dest.index_add_(0, sidx, torch.where(ordered & (occ == j), sval,
                                             -0.0))
    return dest.index_add_(0, torch.where(inside, idx, 0),
                           torch.where(inside & pos_zero, val, -0.0))


def decompress(compressed: CompressedGrad, numel: int,
               dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Scatter a packed sparse gradient back to a dense flat buffer in the
    buffer's order (:func:`scatter_add_ordered`, which reads its number of
    rounds from the data); padding slots add zero, duplicate indices
    sum."""
    dense = torch.zeros(numel, dtype=dtype, device=compressed.indices.device)
    return scatter_add_ordered(dense, compressed.indices, compressed.values)


def magnitude_key(x: torch.Tensor, bf16: bool = False) -> torch.Tensor:
    """An int64 key over the last axis whose descending order is
    ``lax.top_k``'s order on ``|x|`` (or on ``bf16(|x|)`` with ``bf16``,
    rounded to nearest even): the bits of the non-negative magnitude,
    which order as the magnitudes do, above ``2^32 - 1 - i``, so larger
    magnitudes come first and equal ones go to the lowest index. Every key
    is positive, zero magnitudes included, and the keys are distinct, so
    ``torch.topk`` on them has no ties and picks the same entries in the
    same order on the CPU and on the card."""
    mag = x.abs()
    bits = (mag.to(torch.bfloat16).view(torch.int16) if bf16
            else mag.view(torch.int32)).to(torch.int64)
    pos = torch.arange(x.shape[-1], dtype=torch.int64, device=x.device)
    return (bits << 32) | ((1 << 32) - 1 - pos)


def _priority_key(acc: torch.Tensor, mask: torch.Tensor,
                  priority: str) -> torch.Tensor:
    """An int64 key over the last axis, positive exactly on the entries
    that may be packed and distinct there, whose descending order is the
    reference's ``lax.top_k`` order on its f32 or bf16 key.

    ``"index"``: ``n - i``, so the first masked entries in index order come
    first (the reference's f32 ``n - i`` is the same while n <= 2^24).
    ``"magnitude"``: the bits of ``bf16(|acc|)`` (round to nearest even)
    above ``2^32 - 1 - i``, so larger magnitudes come first and equal ones
    go to the lowest index; an entry whose magnitude rounds to bf16 zero
    gets key 0 and is not packed, as in the reference."""
    if priority == "index":
        n = acc.shape[-1]
        return torch.where(mask, n - torch.arange(n, device=acc.device), 0)
    if priority != "magnitude":
        raise ValueError(f"unknown priority {priority!r}")
    key = magnitude_key(torch.where(mask, acc, 0.0), bf16=True)
    return torch.where(key >> 32 > 0, key, 0)        # bf16(|x|) > 0


def select_by_mask(acc: torch.Tensor, mask: torch.Tensor, k: int,
                   priority: str = "index") -> tuple:
    """The selection half of :func:`pack_by_mask` over the last axis:
    ``(sent_idx [..., k], val [..., k], num_selected [...])`` with the
    sentinel ``n`` on invalid slots.

    The reference takes ``lax.top_k`` of an f32 or bf16 key (and
    ``approx_max_k`` above 2^21 elements, which on the CPU returns the
    same). Here the key is an integer whose values are distinct wherever
    it is positive, so ``torch.topk`` has no ties to break among the
    packed slots and its order is the reference's exactly; slots whose key
    is 0 are invalid whatever their order. No value is read on the host."""
    n = acc.shape[-1]
    num_selected = mask.sum(dim=-1, dtype=torch.int32)
    kv, ki = torch.topk(_priority_key(acc, mask, priority), k, dim=-1,
                        sorted=True)
    valid = kv > 0
    val = torch.where(valid, acc.gather(-1, torch.where(valid, ki, 0)), 0.0)
    sent_idx = torch.where(valid, ki, n).to(torch.int32)
    return sent_idx, val.to(acc.dtype), num_selected


def pack_by_mask(acc: torch.Tensor, mask: torch.Tensor, k: int,
                 priority: str = "index") -> CompressResult:
    """Pack the entries of ``acc`` where ``mask`` holds into exactly ``k``
    slots; what is not packed stays in the residual. ``acc`` is not
    modified: the residual is a copy."""
    sent_idx, val, num_selected = select_by_mask(acc, mask, k, priority)
    return CompressResult(*finish_pack(acc.clone(), sent_idx, val),
                          num_selected)


def pack_by_threshold(acc: torch.Tensor, threshold: torch.Tensor,
                      k: int) -> CompressResult:
    """Select ``|acc| > threshold`` and pack into exactly ``k`` slots, first
    in index order (see :func:`pack_by_mask`)."""
    return pack_by_mask(acc, acc.abs() > threshold, k)


def _tolerance_band(k: int, tol: float) -> tuple:
    """``(max(1, floor((1-tol)k)), ceil((1+tol)k))`` as the reference
    computes them: each product is a Python float that JAX rounds to f32
    before ``floor``/``ceil``."""
    lo = max(1, math.floor(np.float32((1.0 - tol) * k)))
    return lo, math.ceil(np.float32((1.0 + tol) * k))


def bisect_threshold(abs_acc: torch.Tensor, k: int, t0: torch.Tensor,
                     num_iters: int = 10, tol: float = 0.05) -> torch.Tensor:
    """Refine ``t0`` so that ``|{|x| > t}|`` is within ``tol * k`` of ``k``:
    ``num_iters`` fixed bisection steps on ``[0, max|x|]``, each a full
    count pass, all kept on the device (no value is read on the host).
    Works along the last axis; ``t0`` has the leading shape."""
    hi = abs_acc.amax(dim=-1)
    lo = torch.zeros_like(hi)
    t = torch.minimum(torch.maximum(t0, lo), hi)
    lo_tol, hi_tol = _tolerance_band(k, tol)
    for _ in range(num_iters):
        cnt = (abs_acc > t.unsqueeze(-1)).sum(dim=-1, dtype=torch.int32)
        within = (cnt >= lo_tol) & (cnt <= hi_tol)
        over = cnt > k
        new_lo = torch.where(over, t, lo)
        new_hi = torch.where(over, hi, t)
        t = torch.where(within, t, 0.5 * (new_lo + new_hi))
        lo = torch.where(within, lo, new_lo)
        hi = torch.where(within, hi, new_hi)
    return t
