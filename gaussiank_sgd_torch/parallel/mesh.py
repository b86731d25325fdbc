"""Process-group setup (port of ``gaussiank_sgd_tpu/parallel/mesh.py``).

The reference's mesh of chips becomes ``torch.distributed``'s default
process group: one process a worker, NCCL when the device is CUDA and gloo
when it is the CPU. A process launched by ``torchrun`` joins from its
environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``,
``MASTER_PORT``); a rank's card is ``cuda:LOCAL_RANK``. The batch is cut
as the reference's dp sharding cuts it: rank r takes the contiguous rows
``[r * B, (r + 1) * B)`` of the global batch.

The reference's mesh axes become a ``DPMesh``: one process group an axis,
in the reference's axis order. ``data_parallel_mesh`` is its 1-D ``dp``
mesh, the default group; ``hierarchical_dp_mesh`` its 2-D ``(dcn_dp,
ici_dp)`` mesh, the layout of ``--ici-size I --dcn-size D``: worker ``r =
d * I + i`` is worker ``i`` of node ``d``, the sparse all-gather runs over
the node's ``ici`` group and the dense partial's all-reduce over the
``dcn`` group across nodes. ``dp_sp_mesh`` is its 2-D ``(dp, sp)`` mesh
of ``--sp-size``: worker ``r = d * S + s`` holds block ``s`` of the
sequence of data-parallel replica ``d``; the sp group (the last axis)
carries ring attention's hops and the sparse all-gather, the dp group the
dense partial's all-reduce, as on the two-level layout.
"""

from __future__ import annotations

import math
import os
import socket
from typing import Any, NamedTuple, Optional, Tuple, Union

import torch
import torch.distributed as dist

from . import collectives

Device = Union[str, torch.device]


def backend_for(device: Device) -> str:
    """``nccl`` for a CUDA device, ``gloo`` for the CPU."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def init_distributed(device: Device, rank: int, world_size: int,
                     init_method: str = "env://",
                     backend: Optional[str] = None) -> torch.device:
    """Join the default process group as ``rank`` of ``world_size`` with
    the device's backend (or ``backend``); returns the device. A CUDA
    device (``cuda`` alone: the current one) becomes the process's current
    one first, as NCCL needs."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        torch.cuda.set_device(dev)
    dist.init_process_group(backend or backend_for(dev),
                            init_method=init_method, rank=rank,
                            world_size=world_size)
    return dev


def maybe_initialize_distributed(device: Device) -> torch.device:
    """Join the process group that ``torchrun``'s environment describes and
    return this rank's device (``cuda:LOCAL_RANK`` for CUDA).

    A no-op without that environment, or when a group already exists. When
    the environment says the process is one of several and the group
    cannot be formed, it raises: a worker must never go on training as an
    unsynchronised single process."""
    dev = torch.device(device)
    if dist.is_initialized() or "WORLD_SIZE" not in os.environ:
        return dev
    world = int(os.environ["WORLD_SIZE"])
    rank = int(os.environ.get("RANK", "0"))
    if dev.type == "cuda":
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", rank)))
    try:
        return init_distributed(dev, rank, world)
    except Exception as e:  # noqa: BLE001 -- re-raised with the launch context
        raise RuntimeError(
            f"launched as rank {rank} of {world} (torchrun environment) but "
            f"the {backend_for(dev)} process group could not be formed; "
            f"refusing to continue as an unsynchronised single process"
        ) from e


class DPMesh(NamedTuple):
    """The data-parallel layout the train step reduces over: one process
    group an axis of the reference's mesh, in its order (None: the default
    group). The last axis is the all-gather's; sums and means go over the
    axes one after another, first to last, as the reference's ``psum``
    and ``_pmean`` loops do, so the order of every f32 sum is fixed."""

    names: Tuple[str, ...]
    groups: Tuple[Optional[dist.ProcessGroup], ...]
    sizes: Tuple[int, ...]

    @property
    def size(self) -> int:
        """Workers in the layout (the world size)."""
        return math.prod(self.sizes)

    def pmean(self, x: torch.Tensor) -> torch.Tensor:
        """The mean over every worker, one axis after the other."""
        for group in self.groups:
            x = collectives.pmean(x, group)
        return x

    def psum(self, x: torch.Tensor, outer_only: bool = False
             ) -> torch.Tensor:
        """The sum over every worker, one axis after the other; with
        ``outer_only`` over the axes before the last (dcn; none on 1-D)."""
        for group in self.groups[:-1] if outer_only else self.groups:
            x = collectives.all_reduce_sum(x, group)
        return x

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """The tiled all-gather over the last (ici) axis."""
        # gklint: disable=collective-outside-pipeline -- the sequential schedule's one gather a payload tensor (overlap off or an ineligible plan), by design
        return collectives.all_gather(x, self.groups[-1])

    def gather_async(self, x: torch.Tensor):
        """``gather`` issued without waiting: ``(out, work)``
        (``collectives.all_gather_async``)."""
        return collectives.all_gather_async(x, self.groups[-1])


def data_parallel_mesh() -> DPMesh:
    """The 1-D ``dp`` mesh: the default group of every worker."""
    return DPMesh(("dp",), (None,), (collectives.world_size(),))


def hierarchical_dp_mesh(ici_size: int, dcn_size: int) -> DPMesh:
    """The 2-D ``(dcn_dp, ici_dp)`` mesh of ``ici_size * dcn_size``
    workers, the reference's ``hierarchical_dp_mesh``
    (``gaussiank_sgd_tpu/parallel/mesh.py:91-121``): worker ``r = d * I +
    i`` is ``i`` in the ici group of node ``d`` (ranks ``d * I ... d * I +
    I - 1``) and ``d`` in the dcn group of the workers ``i`` (ranks ``i,
    I + i, ...``). Every rank creates every group, in the same order (a
    collective of the world). The world must be ``I * D``, and each ici
    group must lie on one host (the ranks' host names are compared): as in
    the reference, an ici group never silently spans nodes."""
    if ici_size < 1 or dcn_size < 1:
        raise ValueError(f"ici_size={ici_size} and dcn_size={dcn_size} must "
                         f"both be >= 1")
    want, world = ici_size * dcn_size, collectives.world_size()
    if want != world:
        raise ValueError(
            f"--ici-size {ici_size} --dcn-size {dcn_size} lay out {want} "
            f"workers, but the world size is {world}: launch {ici_size} "
            f"processes on each of {dcn_size} nodes (torchrun --nnodes "
            f"{dcn_size} --nproc-per-node {ici_size})")
    sizes = (dcn_size, ici_size)
    if not dist.is_initialized():
        return DPMesh(("dcn_dp", "ici_dp"), (None, None), sizes)
    hosts = [None] * world
    dist.all_gather_object(hosts, socket.gethostname())
    for d in range(dcn_size):
        node = hosts[d * ici_size:(d + 1) * ici_size]
        if len(set(node)) != 1:
            first, last = d * ici_size, (d + 1) * ici_size - 1
            raise RuntimeError(
                f"the ici group of ranks {first}..{last} spans hosts "
                f"{sorted(set(node))}: each node must hold {ici_size} "
                f"consecutive ranks (torchrun --nnodes {dcn_size} "
                f"--nproc-per-node {ici_size})")
    return DPMesh(("dcn_dp", "ici_dp"), _grid_groups(dcn_size, ici_size),
                  sizes)


def _grid_groups(outer: int, inner: int):
    """The groups of an ``outer x inner`` grid of ranks ``r = o * inner +
    i``, created by every rank in the same order: ``(this rank's outer
    group, ranks i, inner + i, ...; its inner group, ranks o * inner ...
    o * inner + inner - 1)``."""
    rows = [dist.new_group([o * inner + i for i in range(inner)])
            for o in range(outer)]
    cols = [dist.new_group([o * inner + i for o in range(outer)])
            for i in range(inner)]
    o, i = divmod(dist.get_rank(), inner)
    return cols[i], rows[o]


def dp_sp_mesh(dp_size: int, sp_size: int) -> DPMesh:
    """The 2-D ``(dp, sp)`` mesh of ``dp_size * sp_size`` workers, the
    reference's ``dp_sp_mesh`` (``gaussiank_sgd_tpu/parallel/mesh.py:
    124-148``): worker ``r = d * S + s`` is ``s`` in the sp group of
    replica ``d`` (ranks ``d * S ... d * S + S - 1``), whose K/V ring and
    sparse all-gather it joins, and ``d`` in the dp group of the workers
    ``s`` (ranks ``s, S + s, ...``). sp is the last axis, as in the
    reference, so ``DPMesh.gather`` runs over it and ``psum(outer_only)``
    over dp. Every rank creates every group, in the same order; the world
    must be ``dp * sp``."""
    if dp_size < 1 or sp_size < 1:
        raise ValueError(f"dp_size={dp_size} and sp_size={sp_size} must "
                         f"both be >= 1")
    want, world = dp_size * sp_size, collectives.world_size()
    if want != world:
        raise ValueError(
            f"a {dp_size} x {sp_size} (dp, sp) mesh lays out {want} "
            f"workers, but the world size is {world}")
    sizes = (dp_size, sp_size)
    if not dist.is_initialized():
        return DPMesh(("dp", "sp"), (None, None), sizes)
    return DPMesh(("dp", "sp"), _grid_groups(dp_size, sp_size), sizes)


def shard_batch(batch: Any, rank: int, world_size: int,
                sp_size: int = 1) -> Any:
    """This rank's block of a global batch (a tuple of arrays or tensors
    whose leading dim is ``B * world_size / sp_size``): rows ``[d * B, (d +
    1) * B)`` of replica ``d = rank // sp_size`` and, with ``sp_size`` > 1
    (the sequence split of ``dp_sp_mesh``), columns ``[s * L, (s + 1) * L)``
    of dim 1 for ``s = rank % sp_size``, ``L = T / sp_size``."""
    dp = world_size // sp_size
    d, s = divmod(rank, sp_size)

    def block(x):
        if x.shape[0] % dp:
            raise ValueError(f"global batch of {x.shape[0]} rows does not "
                             f"split over {dp} workers")
        b = x.shape[0] // dp
        x = x[d * b:(d + 1) * b]
        if sp_size == 1:
            return x
        if x.shape[1] % sp_size:
            raise ValueError(f"a sequence of {x.shape[1]} does not split "
                             f"into {sp_size} blocks")
        t = x.shape[1] // sp_size
        return x[:, s * t:(s + 1) * t]
    return tuple(block(x) for x in batch)
