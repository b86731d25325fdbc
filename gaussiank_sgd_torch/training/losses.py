"""Per-task loss functions (port of the classify loss of
``gaussiank_sgd_tpu/training/losses.py``).

A loss function here is a closure over its model: ``loss_fn(batch) ->
(loss, aux)``. A train-mode forward updates the model's BatchNorm running
statistics in place (the train step snapshots them for its guard).
"""

from __future__ import annotations

import functools
from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

# ImageNet channel statistics (mean, std) for uint8 pixel batches
IMAGENET_NORM = ((0.485, 0.456, 0.406), (0.229, 0.224, 0.225))

Norm = Tuple[Sequence[float], Sequence[float]]
_INV255 = float(np.float32(1.0) / np.float32(255.0))


@functools.lru_cache(maxsize=8)
def _norm_constants(input_norm: Norm, device: torch.device):
    """``(-mean as f64, f32(1 / std))`` on ``device``, made once: a fresh
    host-to-device copy each step would wait for the device's queue."""
    mean, std = (np.asarray(v, np.float32) for v in input_norm)
    return (torch.tensor(-mean, dtype=torch.float64, device=device),
            torch.tensor(np.float32(1.0) / std, device=device))


def _prep_pixels(x: torch.Tensor, input_norm: Optional[Norm]) -> torch.Tensor:
    """Normalise uint8 pixels on the device: ``(x / 255 - mean) / std`` in
    f32, rounded as XLA lowers the reference's expression on the CPU — a
    multiply by f32(1/255) and the subtraction in one fused multiply-add
    (one rounding; exact here through f64, whose 53 bits hold the whole
    sum), then a multiply by the f32 reciprocal of ``std``. Float inputs
    pass through untouched."""
    if input_norm is None or x.dtype != torch.uint8:
        return x
    neg_mean, inv_std = _norm_constants(input_norm, x.device)
    return (x.double() * _INV255 + neg_mean).float() * inv_std


def make_loss_fn(model: torch.nn.Module, task: str = "classify",
                 input_norm: Optional[Norm] = None) -> Callable:
    """Softmax cross-entropy (mean over the batch) on f32 logits, with the
    batch accuracy as ``aux["acc"]``. ``input_norm`` = (mean, std) for
    uint8 pixel batches, applied on the device (``_prep_pixels``)."""
    if task != "classify":
        raise NotImplementedError(
            f"task {task!r} is not ported yet (ROADMAP A11)")

    def loss_fn(batch):
        x, y = batch
        logits = model(_prep_pixels(x, input_norm), train=True).float()
        y = y.long()
        loss = F.cross_entropy(logits, y)
        acc = (logits.argmax(-1) == y).float().mean()
        return loss, {"acc": acc.detach()}

    return loss_fn
