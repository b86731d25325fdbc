"""Sparse and dense gradient exchange over the default process group (port
of ``gaussiank_sgd_tpu/parallel/collectives.py``).

Each function is a collective of ``torch.distributed``'s default group
(``parallel/mesh.py``); without a group they are the identities of a world
of one. ``exchange_with`` is the one point-to-point hop, which a world of
one never makes. The all-gather is tiled, as ``lax.all_gather(..., tiled=True)``:
one collective of a flat tensor whose result is every worker's tensor
concatenated along dim 0 in rank order.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..compressors.base import CompressedGrad, decompress


def _grouped() -> bool:
    return dist.is_available() and dist.is_initialized()


def world_size() -> int:
    """Workers in the data-parallel group (1 without a process group)."""
    return dist.get_world_size() if _grouped() else 1


def rank() -> int:
    """This worker's index in the group (0 without a process group)."""
    return dist.get_rank() if _grouped() else 0


def all_gather(x: torch.Tensor) -> torch.Tensor:
    """Every worker's ``x`` concatenated along dim 0 (tiled all-gather)."""
    if not _grouped():
        return x
    out = x.new_empty((world_size() * x.shape[0],) + tuple(x.shape[1:]))
    # all_gather_into_tensor became all_gather_single (and deprecated) in
    # later torch; both take (output, input)
    gather = getattr(dist, "all_gather_single", None)
    (gather or dist.all_gather_into_tensor)(out, x.contiguous())
    return out


def exchange_with(partner: int, x: torch.Tensor) -> torch.Tensor:
    """Send ``x`` to worker ``partner`` and receive its tensor of the same
    shape and dtype: one ``isend``/``irecv`` pair (a gTop-k hop; the
    partner calls it with this worker's rank)."""
    out = torch.empty_like(x)
    for req in dist.batch_isend_irecv([
            dist.P2POp(dist.isend, x.contiguous(), partner),
            dist.P2POp(dist.irecv, out, partner)]):
        req.wait()
    return out


def all_reduce_sum(x: torch.Tensor) -> torch.Tensor:
    """The sum of every worker's ``x``, as a new tensor (``x`` itself
    without a process group)."""
    if not _grouped():
        return x
    out = x.clone()
    dist.all_reduce(out)
    return out


def pmean(x: torch.Tensor) -> torch.Tensor:
    """The mean of a float tensor over the workers (``lax.pmean``: the sum,
    then ``/ P``)."""
    return all_reduce_sum(x) / world_size()


def sparse_allgather_sum(comp: CompressedGrad, numel: int, *,
                         mean: bool = True,
                         dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """All-gather every worker's packed pairs and scatter-sum them dense in
    the gathered buffer's order (duplicate indices sum), averaged over the
    workers."""
    p = world_size()
    dense = decompress(CompressedGrad(all_gather(comp.indices),
                                      all_gather(comp.values)), numel, dtype)
    return dense / p if mean else dense


def dense_allreduce(flat: torch.Tensor, *, mean: bool = True
                    ) -> torch.Tensor:
    """Dense all-reduce, then ``/ P``: the warm-up and 'none'-compressor
    exchange."""
    s = all_reduce_sum(flat)
    return s / world_size() if mean else s


def hierarchical_sparse_allgather_sum(comp: CompressedGrad, numel: int,
                                      *args, **kwargs) -> torch.Tensor:
    """The two-level exchange (intra-node all-gather, inter-node dense
    all-reduce) is not ported yet."""
    raise NotImplementedError(
        "hierarchical_sparse_allgather_sum: the two-level exchange over "
        "intra- and inter-node groups is not ported yet (ROADMAP A item 9)")
