"""Process-group setup (port of ``gaussiank_sgd_tpu/parallel/mesh.py``).

The reference's mesh of chips becomes ``torch.distributed``'s default
process group: one process a worker, NCCL when the device is CUDA and gloo
when it is the CPU. A process launched by ``torchrun`` joins from its
environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``,
``MASTER_PORT``); a rank's card is ``cuda:LOCAL_RANK``. The batch is cut
as the reference's dp sharding cuts it: rank r takes the contiguous rows
``[r * B, (r + 1) * B)`` of the global batch.

The hierarchical and sequence-parallel meshes of the reference wait for
ROADMAP A items 9 and 7.
"""

from __future__ import annotations

import os
from typing import Any, Optional, Union

import torch
import torch.distributed as dist

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


def shard_batch(batch: Any, rank: int, world_size: int) -> Any:
    """This rank's rows of a global batch (a tuple of arrays or tensors
    whose leading dim is ``B * world_size``): ``[rank * B, (rank + 1) *
    B)``."""
    def rows(x):
        if x.shape[0] % world_size:
            raise ValueError(f"global batch of {x.shape[0]} rows does not "
                             f"split over {world_size} workers")
        b = x.shape[0] // world_size
        return x[rank * b:(rank + 1) * b]
    return tuple(rows(x) for x in batch)
