"""Per-task loss and eval functions (port of the classify task of
``gaussiank_sgd_tpu/training/losses.py``).

A loss function here is a closure over its model: ``loss_fn(batch) ->
(loss, aux)``. A train-mode forward updates the model's BatchNorm running
statistics in place (the train step snapshots them for its guard). An eval
function, ``eval_fn(batch) -> sums``, runs the model in eval mode.
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


def make_eval_fn(model: torch.nn.Module, task: str = "classify",
                 input_norm: Optional[Norm] = None) -> Callable:
    """``eval_fn(batch) -> {"loss_sum", "top1", "top5", "n"}``, f32 sums
    over the batch, so a distributed pass adds them across workers: the
    softmax cross-entropy of the f32 logits, the rows whose label is the
    arg-max, the rows whose label is among the 5 largest logits, and the
    row count. Eval mode: the running BatchNorm statistics, no dropout, no
    gradient; uint8 pixels normalised as in training."""
    if task != "classify":
        raise NotImplementedError(
            f"eval of task {task!r} is not ported yet (ROADMAP A item 7)")

    @torch.no_grad()
    def eval_fn(batch):
        x, y = batch
        logits = model(_prep_pixels(x, input_norm), train=False).float()
        y = y.long()
        top = logits.topk(min(5, logits.shape[-1]), dim=-1).indices
        return {"loss_sum": F.cross_entropy(logits, y, reduction="sum"),
                "top1": (logits.argmax(-1) == y).sum().float(),
                "top5": (top == y[:, None]).any(-1).sum().float(),
                "n": torch.tensor(float(y.shape[0]), device=logits.device)}

    return eval_fn
