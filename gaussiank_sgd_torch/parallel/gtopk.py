"""gTop-k: the butterfly exchange of the global top-k (port of
``gaussiank_sgd_tpu/parallel/gtopk.py``).

In place of all-gathering P x k entries, log2(P) rounds: in round r each
worker exchanges its current k entries with partner ``rank ^ (1 << r)``,
sums the entries of equal index and keeps the k largest sums by
magnitude. After the last round every worker holds the same k entries,
bit for bit: the sets are sorted by index on both sides of a hop, a sum of
two values is commutative, and the re-selection is the integer-key top-k
of ``compressors/base.py:magnitude_key``, ties to the lowest segment, as
``lax.top_k`` breaks them. Each round is one ``isend``/``irecv`` pair of
one int32 buffer (``parallel/collectives.py:exchange_with``): NCCL on the
card, gloo on the CPU.

On the packed wire (``parallel/wire.py``) a round sends the entries as
u16|bf16 words sorted by global index plus a count a bucket
(``encode_sorted``), and the local values are rounded to bf16 before the
merge, so both sides merge what the other decodes.

Error feedback is the published algorithm's (``global_residual``): a
worker zeroes its accumulator at the globally selected indices, whether or
not it sent them, and keeps the rest, its own entries that lost a merge
included. The wire's bf16 rounding is not added back: the residual
absorbs it as in the reference.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch

from ..compressors.base import (CompressedGrad, finish_pack, magnitude_key,
                                scatter_add_ordered)
from .collectives import exchange_with, rank, world_size
from .wire import WireFormat, bf16_roundtrip, decode_sorted, encode_sorted


class GtopkCommStats(NamedTuple):
    """What one butterfly exchange sent, read from the buffers handed to
    each hop."""

    bytes_sent: int          # this worker's payload bytes over all rounds
    rounds: int              # log2(P)


def merge_sparse(idx_a: torch.Tensor, val_a: torch.Tensor,
                 idx_b: torch.Tensor, val_b: torch.Tensor,
                 k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sum two k-entry sparse sets by index and keep the k largest sums by
    magnitude, largest first, ties to the lowest index.

    The concatenation (``a`` then ``b``) is sorted stably by index and each
    run of equal indices summed into one segment from +0.0, in that order;
    the segments beyond the last hold index 0 and +0.0, and lose every
    comparison a real sum wins. Within each set the indices whose value is
    not +0.0 must be distinct (as every compressor's output and every
    merge's are), so a segment adds at most two such values."""
    cat_idx = torch.cat([idx_a, idx_b])
    cat_val = torch.cat([val_a, val_b])
    s_idx, order = torch.sort(cat_idx, stable=True)
    n2 = cat_idx.shape[0]
    new_seg = torch.ones(n2, dtype=torch.int64, device=cat_idx.device)
    new_seg[1:] = s_idx[1:] != s_idx[:-1]
    seg = torch.cumsum(new_seg, 0) - 1
    summed = scatter_add_ordered(cat_val.new_zeros(n2), seg, cat_val[order],
                                 rounds=2)
    seg_idx = torch.zeros_like(cat_idx).scatter_(0, seg, s_idx)
    top = torch.topk(magnitude_key(summed), k, sorted=True).indices
    return seg_idx[top], summed[top]


def round_payload(idx: torch.Tensor, val: torch.Tensor,
                  wire: Optional[WireFormat]
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(the local values as the partner will decode them, the int32
    buffer to send)``: ``idx`` then the bits of ``val`` on the legacy
    wire, or the sorted words then the per-bucket counts on the packed
    one."""
    if wire is None:
        return val, torch.cat([idx.to(torch.int32), val.view(torch.int32)])
    val = bf16_roundtrip(val)
    words, counts = encode_sorted(idx, val, wire)
    return val, torch.cat([words, counts])


def merge_payload(idx: torch.Tensor, val: torch.Tensor,
                  payload: torch.Tensor, wire: Optional[WireFormat],
                  k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Merge the local set (values from ``round_payload``) with the
    partner's decoded ``payload``."""
    if wire is None:
        o_idx, o_val = payload[:k], payload[k:].view(torch.float32)
    else:
        o_idx, o_val = decode_sorted(payload[:k], payload[k:], wire)
    return merge_sparse(idx, val, o_idx, o_val, k)


def butterfly_rounds(idx: torch.Tensor, val: torch.Tensor, num_workers: int,
                     me: int, wire: Optional[WireFormat] = None,
                     start_round: int = 0, ablate_comm: bool = False
                     ) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """Rounds ``start_round .. log2(P) - 1`` of worker ``me`` over its
    k-entry set: ``(idx, val, bytes sent)``. The pipelined step runs round
    0 a chunk at a time and hands the merged set here with ``start_round =
    1``. ``ablate_comm`` makes each hop the identity (the partner's payload
    is this worker's own): the ``sparse_noexch`` timing twin, which never
    trains; every merge and byte count still runs."""
    if num_workers & (num_workers - 1):
        raise ValueError(f"gtopk needs a power-of-2 number of workers, got "
                         f"{num_workers}")
    k = idx.shape[0]
    bytes_sent = 0
    for r in range(start_round, int(math.log2(num_workers))):
        val, payload = round_payload(idx, val, wire)
        bytes_sent += payload.numel() * payload.element_size()
        got = (payload if ablate_comm
               else exchange_with(me ^ (1 << r), payload))
        idx, val = merge_payload(idx, val, got, wire, k)
    return idx, val, bytes_sent


def gtopk_allreduce(comp: CompressedGrad,
                    wire: Optional[WireFormat] = None,
                    ablate_comm: bool = False
                    ) -> Tuple[CompressedGrad, GtopkCommStats]:
    """The butterfly over the default process group: the global top-k of
    the summed sparse gradients (k entries, not yet averaged), the same on
    every worker, and what this worker sent. A world of one runs no
    round; ``ablate_comm`` as in ``butterfly_rounds``."""
    p = world_size()
    idx, val, bytes_sent = butterfly_rounds(comp.indices, comp.values, p,
                                            rank(), wire,
                                            ablate_comm=ablate_comm)
    return CompressedGrad(idx, val), GtopkCommStats(bytes_sent,
                                                    int(math.log2(p)))


def global_residual(acc: torch.Tensor,
                    global_comp: CompressedGrad) -> torch.Tensor:
    """The gTop-k EF residual: ``acc`` with exactly the globally selected
    indices zeroed, those whose value is not 0 (a padding slot, or a sum
    that cancelled to 0, zeroes nothing; an index at or above ``len(acc)``
    is dropped). ``acc`` is zeroed in place and returned: pass a buffer
    the caller owns."""
    live = global_comp.values != 0
    return finish_pack(acc, torch.where(live, global_comp.indices,
                                        acc.shape[0]),
                       global_comp.values)[1]
