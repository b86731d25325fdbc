"""The weights both sides start from, made on the device from the run's
seed in three large calls: every kernel leaf normal with std
``1 / sqrt(fan_in)`` (fan_in: the product of all axes but the last), every
BatchNorm scale 1, every bias 0."""

from __future__ import annotations

import math

import torch

from .reference.models import Layout
from .seeds import derive


def make_weights(layout: Layout, seed: int,
                 device: torch.device) -> torch.Tensor:
    """Flat float32 weights in ``layout``'s order."""
    sizes = torch.tensor([math.prod(s) for _, s in layout], device=device)
    std = torch.tensor([1.0 / math.sqrt(math.prod(s[:-1]))
                        if p.endswith("/kernel") else 0.0
                        for p, s in layout], device=device)
    mean = torch.tensor([1.0 if p.endswith("/scale") else 0.0
                         for p, _ in layout], device=device)
    gen = torch.Generator(device).manual_seed(derive(seed, "weights"))
    noise = torch.randn(int(sizes.sum()), generator=gen, device=device)
    return (torch.repeat_interleave(mean, sizes)
            + torch.repeat_interleave(std, sizes) * noise)
