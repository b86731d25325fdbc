"""Compact 32-bit wire format for the sparse exchange (port of
``gaussiank_sgd_tpu/parallel/wire.py``).

One word per entry::

      31 ............. 16 15 .............. 0
     +-------------------+------------------+
     |  rel index (u16)  |  value (bf16)    |
     +-------------------+------------------+

``rel`` is the entry's index relative to its bucket's first element, so 16
bits suffice while every bucket spans at most 65,536 elements; the value is
bf16, rounded to nearest even, and the sender's f32 EF residual absorbs the
rounding (``parallel/trainstep.py``). Bucket ids never travel: the grouped
layout (all-gather) has a fixed number of slots per bucket, so an entry's
bucket is its position over the slots; the sorted layout (gtopk) sends the
entries sorted by global index with a per-bucket count vector.

The words are int32 here (torch's uint32 has few operations) with the bits
of the reference's uint32 words; ``words.view(np.uint32)`` on the host
reads them as the reference does. All bit work is integer arithmetic, so
the CPU and the card make the same words. The f32 -> bf16 rounding is the
reference's (XLA's) to the bit: round to nearest even, subnormals kept,
and every NaN becomes the quiet NaN ``0x7FC0`` with its sign (torch's own
conversion makes other NaN bits).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from ..compressors.base import CompressedGrad
from .bucketing import BucketPlan

#: name of the packed format: u16 bucket-relative index + bf16 value
WIRE_PACKED = "u16bf16"
#: name of the legacy format: i32 global index + f32 value
WIRE_LEGACY = "i32f32"

#: largest bucket span a u16 relative index can address (rel <= 65535)
MAX_BUCKET_SPAN = 1 << 16

_LOW16 = 0xFFFF
_SIGN = -(1 << 31)          # the int32 sign bit


class WireFormat(NamedTuple):
    """An active packed wire format (``None`` everywhere means the legacy
    (i32, f32) exchange). ``chunk`` is the uniform bucket span."""

    name: str               # WIRE_PACKED
    chunk: int              # uniform bucket span (elements)
    n_buckets: int          # buckets in the plan (incl. a trailing pad chunk)
    bytes_per_entry: int = 4


def plan_wire_format(plan: BucketPlan,
                     grad_dtype: torch.dtype) -> Optional[WireFormat]:
    """The gate, decided when a step is built: the packed format for a
    uniform plan that tiles the flat space at stride ``chunk <= 65536``
    with f32 gradients, else ``None`` (the legacy exchange)."""
    if grad_dtype != torch.float32:
        return None
    if not plan.uniform:
        return None
    chunk = plan.buckets[0].size
    if chunk > MAX_BUCKET_SPAN:
        return None
    for i, b in enumerate(plan.buckets):
        if b.offset != i * chunk or b.size != chunk:
            return None
    return WireFormat(WIRE_PACKED, chunk, len(plan.buckets))


def _bf16_bits(values: torch.Tensor) -> torch.Tensor:
    """The bf16 bits of f32 ``values`` (round to nearest even; NaN to
    ``sign | 0x7FC0``) as int32 in ``[0, 0xFFFF]``."""
    if values.dtype != torch.float32:
        raise TypeError(f"the wire quantizes float32, got {values.dtype}")
    b = values.contiguous().view(torch.int32)
    # a NaN becomes the quiet NaN with its sign first, which the rounding
    # keeps; then no int32 add overflows: the largest pattern left,
    # 0x7FC00000, stays below 2^31 after the carry
    b = torch.where(torch.isnan(values), (b & _SIGN) | 0x7FC00000, b)
    return ((b + (0x7FFF + ((b >> 16) & 1))) >> 16) & _LOW16


def _bits_to_f32(bits16: torch.Tensor) -> torch.Tensor:
    """f32 values of bf16 bits held in the low half of int32 (exact: bf16
    is the top half of f32)."""
    return ((bits16 & _LOW16) << 16).view(torch.float32)


def quantize_values(values: torch.Tensor) -> torch.Tensor:
    """f32 -> bf16 (round to nearest even), the wire's value precision."""
    return _bf16_bits(values).to(torch.int16).view(torch.bfloat16)


def dequantize_values(q: torch.Tensor) -> torch.Tensor:
    """bf16 -> f32 (exact)."""
    return _bits_to_f32(q.view(torch.int16).to(torch.int32))


def bf16_roundtrip(values: torch.Tensor) -> torch.Tensor:
    """The f32 values as the receiver will see them."""
    return _bits_to_f32(_bf16_bits(values))


def encode_entries(rel_idx: torch.Tensor,
                   values: torch.Tensor) -> torch.Tensor:
    """Pack (bucket-relative index < 2^16, f32 value) into one int32 word
    each, elementwise over any shape. ``rel << 16`` sets the sign bit for
    ``rel >= 32768``: the word's bits are the reference's uint32."""
    return (rel_idx.to(torch.int32) << 16) | _bf16_bits(values)


def decode_entries(words: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Unpack words -> (bucket-relative int32 indices, f32 values). The
    shift is arithmetic on int32, hence the mask."""
    return (words >> 16) & _LOW16, _bits_to_f32(words)


def encode_grouped(comp: CompressedGrad, wf: WireFormat) -> torch.Tensor:
    """Encode a bucket-major packed gradient (``slots`` entries per bucket,
    global indices) for the all-gather exchange. Padding entries carry
    their bucket's base index with value 0."""
    k_packed = comp.indices.shape[0]
    if k_packed % wf.n_buckets:
        raise ValueError(
            f"packed length {k_packed} is not bucket-major over "
            f"{wf.n_buckets} buckets")
    slots = k_packed // wf.n_buckets
    bucket = torch.arange(k_packed, dtype=torch.int32,
                          device=comp.indices.device) // slots
    return encode_entries(comp.indices - bucket * wf.chunk, comp.values)


def decode_grouped(words: torch.Tensor, wf: WireFormat,
                   k_packed_local: int) -> CompressedGrad:
    """Decode a (possibly all-gathered) grouped buffer of ``W *
    k_packed_local`` words back to global indices; each entry's bucket is
    its position within its worker's payload."""
    if words.shape[0] % k_packed_local:
        raise ValueError(
            f"gathered length {words.shape[0]} is not a whole number of "
            f"{k_packed_local}-entry worker payloads")
    slots = k_packed_local // wf.n_buckets
    pos = torch.arange(words.shape[0], dtype=torch.int32,
                       device=words.device) % k_packed_local
    rel, vals = decode_entries(words)
    return CompressedGrad((pos // slots) * wf.chunk + rel, vals)


def encode_sorted(idx: torch.Tensor, val: torch.Tensor, wf: WireFormat
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Encode one gtopk round's payload: the entries sorted by global index
    (stable, as the reference's ``argsort``) and the ``int32[n_buckets]``
    per-bucket counts that replace per-entry bucket ids."""
    order = torch.sort(idx, stable=True).indices
    s_idx = idx[order]
    bucket = s_idx // wf.chunk
    counts = torch.zeros(wf.n_buckets, dtype=torch.int32, device=idx.device)
    counts.index_add_(0, bucket.to(torch.int64),
                      torch.ones_like(bucket, dtype=torch.int32))
    return encode_entries(s_idx - bucket * wf.chunk, val[order]), counts


def decode_sorted(words: torch.Tensor, counts: torch.Tensor,
                  wf: WireFormat) -> Tuple[torch.Tensor, torch.Tensor]:
    """Decode a sorted+counts payload back to (global int32, f32): position
    j is in bucket b iff ``cumsum(counts)[b-1] <= j < cumsum(counts)[b]``."""
    ends = torch.cumsum(counts, 0, dtype=torch.int32)
    pos = torch.arange(words.shape[0], dtype=torch.int32, device=words.device)
    bucket = torch.searchsorted(ends, pos, right=True).to(torch.int32)
    rel, vals = decode_entries(words)
    return bucket * wf.chunk + rel, vals
