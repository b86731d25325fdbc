"""Sparse and dense gradient exchange over ``torch.distributed`` (port of
``gaussiank_sgd_tpu/parallel/collectives.py``).

Each function is a collective of a process group: the default one unless
``group`` names another, such as an axis of the two-level layout
(``parallel/mesh.py:hierarchical_dp_mesh``). Without a process group they
are the identities of a world of one.
``exchange_with`` is the one point-to-point hop, which a world of one
never makes. The all-gather is tiled, as ``lax.all_gather(...,
tiled=True)``: one collective of a flat tensor whose result is every
worker's tensor concatenated along dim 0 in the group's rank order.

``all_gather_async`` and ``exchange_with_async`` return before the
collective ends, with a handle to ``wait()`` on before the result is read:
the pipelined step (``parallel/trainstep.py``) issues one a chunk and
compresses the next chunk meanwhile. On NCCL ``wait()`` makes the current
stream wait for NCCL's and does not block the host; on gloo it blocks.
The caller keeps every input tensor alive until its ``wait()``.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from ..compressors.base import CompressedGrad, decompress

Group = Optional[dist.ProcessGroup]


def _grouped() -> bool:
    return dist.is_available() and dist.is_initialized()


def world_size(group: Group = None) -> int:
    """Workers in ``group`` (the default group: every worker; 1 without a
    process group)."""
    return dist.get_world_size(group) if _grouped() else 1


def rank(group: Group = None) -> int:
    """This worker's index in ``group`` (0 without a process group)."""
    return dist.get_rank(group) if _grouped() else 0


def all_gather(x: torch.Tensor, group: Group = None) -> torch.Tensor:
    """Every worker's ``x`` concatenated along dim 0 (tiled all-gather)."""
    out, work = all_gather_async(x, group)
    if work is not None:
        work.wait()
    return out


def all_gather_async(x: torch.Tensor, group: Group = None):
    """``all_gather`` issued without waiting: ``(out, work)``, where
    ``out`` may be read only after ``work.wait()`` (``work`` is None, and
    ``out`` is ``x``, without a process group)."""
    if not _grouped():
        return x, None
    out = x.new_empty((world_size(group) * x.shape[0],) + tuple(x.shape[1:]))
    # all_gather_into_tensor became all_gather_single (and deprecated) in
    # later torch; both take (output, input)
    gather = getattr(dist, "all_gather_single", None)
    work = (gather or dist.all_gather_into_tensor)(
        out, x.contiguous(), group=group, async_op=True)
    return out, work


def exchange_with(partner: int, x: torch.Tensor) -> torch.Tensor:
    """Send ``x`` to worker ``partner`` and receive its tensor of the same
    shape and dtype: one ``isend``/``irecv`` pair (a gTop-k hop; the
    partner calls it with this worker's rank)."""
    out, reqs = exchange_with_async(partner, x)
    for req in reqs:
        req.wait()
    return out


def exchange_with_async(partner: int, x: torch.Tensor, tag: int = 0):
    """``exchange_with`` issued without waiting: ``(out, requests)``, each
    request to ``wait()`` on before ``out`` is read. Hops in flight at once
    between the same pair take distinct ``tag``s, in the same order on
    both sides."""
    (out,), reqs = send_recv([x], partner, partner, tag=tag)
    return out, reqs


def host_staged(x: torch.Tensor, group: Group = None) -> bool:
    """Whether a point-to-point hop of ``x`` over ``group`` goes through
    host memory: a CUDA tensor on a gloo group, which sends none point to
    point (several gloo ranks on one card)."""
    return x.is_cuda and dist.get_backend(group) == "gloo"


def send_recv(sends, dst: int, src: int, group: Group = None,
              tag: int = 0):
    """Send each tensor of ``sends`` to global rank ``dst`` and receive
    tensors of the same shapes from ``src``, tagged ``tag + i``: one
    ``batch_isend_irecv``, ``(recvs, requests)``. A hop that is
    ``host_staged`` goes through host memory, has ended when this returns
    and leaves no requests."""
    device = sends[0].device
    staged = host_staged(sends[0], group)
    sends = [t.detach().contiguous() for t in sends]
    if staged:
        sends = [t.cpu() for t in sends]
    recvs = [torch.empty_like(t) for t in sends]
    ops = [dist.P2POp(dist.isend, t, dst, group=group, tag=tag + i)
           for i, t in enumerate(sends)]
    ops += [dist.P2POp(dist.irecv, t, src, group=group, tag=tag + i)
            for i, t in enumerate(recvs)]
    # gklint: disable=collective-outside-pipeline -- the hop primitive itself; its callers (the pipelined _launch, butterfly_rounds, the ring's _rotate) choose the schedule
    reqs = dist.batch_isend_irecv(ops)
    if not staged:
        return recvs, reqs
    for req in reqs:
        req.wait()
    return [t.to(device) for t in recvs], []


def all_reduce_sum(x: torch.Tensor, group: Group = None) -> torch.Tensor:
    """The sum of every worker's ``x`` in ``group``, as a new tensor (``x``
    itself without a process group)."""
    if not _grouped():
        return x
    out = x.clone()
    dist.all_reduce(out, group=group)
    return out


def pmean(x: torch.Tensor, group: Group = None) -> torch.Tensor:
    """The mean of a float tensor over the workers of ``group``
    (``lax.pmean``: the sum, then ``/ P``)."""
    return all_reduce_sum(x, group) / world_size(group)


def sparse_allgather_sum(comp: CompressedGrad, numel: int, *,
                         group: Group = None, mean: bool = True,
                         dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """All-gather every worker's packed pairs over ``group`` and
    scatter-sum them dense in the gathered buffer's order (duplicate
    indices sum), averaged over the group's workers."""
    # gklint: disable=collective-outside-pipeline -- sequential oracle for parity tests and the two-level helper, off the step's path
    g_idx = all_gather(comp.indices, group)
    # gklint: disable=collective-outside-pipeline -- sequential oracle for parity tests and the two-level helper, off the step's path
    g_val = all_gather(comp.values, group)
    dense = decompress(CompressedGrad(g_idx, g_val), numel, dtype)
    return dense / world_size(group) if mean else dense


def dense_allreduce(flat: torch.Tensor, *, group: Group = None,
                    mean: bool = True) -> torch.Tensor:
    """Dense all-reduce over ``group``, then ``/ P``: the warm-up and
    'none'-compressor exchange."""
    s = all_reduce_sum(flat, group)
    return s / world_size(group) if mean else s


def hierarchical_sparse_allgather_sum(comp: CompressedGrad, numel: int,
                                      ici: Group, dcn: Group, *,
                                      mean: bool = True,
                                      dtype: torch.dtype = torch.float32
                                      ) -> torch.Tensor:
    """The two-level exchange: the pairs all-gathered and scatter-summed
    dense over the node's ``ici`` group, then that dense partial summed
    over the ``dcn`` group across nodes, and averaged over all ``I * D``
    workers. The heavy all-gather stays on the fast links; one dense
    all-reduce of ``numel * 4`` bytes crosses nodes."""
    partial = sparse_allgather_sum(comp, numel, group=ici, mean=False,
                                   dtype=dtype)
    total = all_reduce_sum(partial, dcn)
    return total / (world_size(ici) * world_size(dcn)) if mean else total
