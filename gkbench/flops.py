"""The yardstick's arithmetic: model FLOPs of a step, the card's published
peaks, and the bytes the compression layer has to move.

``program_flops`` and the dense bf16 peak table are frozen copies of
``gaussiank_sgd_torch/benchlib.py``'s (``program_flops``,
``PEAK_FLOPS_BY_NAME``); the FLOPs are counted on the benchmark's own
float32 reference model, on the meta device, at the shapes of one
worker's step, so they stay the same whatever implements the model.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Tuple

import torch

# (card name prefix, dense bf16 FLOP/s, HBM bytes/s): NVIDIA's data sheets,
# without sparsity; the longest prefix that matches wins
PEAKS: Tuple[Tuple[str, float, float], ...] = (
    ("NVIDIA H100 PCIe", 756.5e12, 2.0e12),
    ("NVIDIA H100 NVL", 835.5e12, 3.9e12),
    ("NVIDIA H100", 989.4e12, 3.35e12),         # SXM5 (80GB HBM3)
)


def peaks(device_name: Optional[str]) -> Optional[Tuple[float, float]]:
    """``(bf16 FLOP/s, HBM bytes/s)`` of a card by its name, or None for a
    card the table does not hold (then no share of a peak is reported)."""
    if not device_name:
        return None
    for prefix, flops, bw in PEAKS:
        if device_name.startswith(prefix):
            return flops, bw
    return None


def program_flops(fn: Callable, *args) -> Optional[float]:
    """FLOPs of one call ``fn(*args)``: ``FlopCounterMode``'s analytic
    count of its matmuls and convolutions, forward and backward, from
    their shapes (None when it counts none). The call runs: pass a copy of
    any state it writes."""
    from torch.utils.flop_counter import FlopCounterMode
    with FlopCounterMode(display=False) as counter:
        fn(*args)
    flops = counter.get_total_flops()
    return float(flops) if flops else None


def step_flops(model, spec) -> Optional[float]:
    """The forward and backward FLOPs of one worker's step of a reference
    ``model`` (``reference/sgd.py:Model``) on inputs of ``spec``, ``((x
    shape, x dtype), (y shape, y dtype))`` as a traffic generator's
    ``input_spec`` gives it, counted on the meta device."""
    from .reference import models
    (x_shape, x_dtype), (y_shape, y_dtype) = spec

    def step():
        n = models.numel(model.layout)
        flat = torch.zeros(n, device="meta", requires_grad=True)
        x = torch.zeros(x_shape, dtype=x_dtype, device="meta")
        y = torch.zeros(y_shape, dtype=y_dtype, device="meta")
        loss = model.loss(models.split_flat(flat, model.layout), x, y,
                          None, lambda t: t)
        torch.autograd.grad(loss, flat)
    return program_flops(step)


def compress_bytes(n: int, k: int) -> int:
    """Bytes EF + select + pack has to move at the least, whatever
    implements it: read the gradient and the residual and write the new
    residual (3 x 4 B an entry), and write k pairs of int32 + float32."""
    return 12 * n + 8 * k


def k_of(n: int, density: float) -> int:
    """The number of pairs a worker sends: ``ceil(density * n)``."""
    return max(1, math.ceil(density * n))
