"""Plain data-parallel GaussianK SGD with error feedback: the first steps
of a run, worked out again from the benchmark's inputs alone.

For each step and each worker, in order: the forward and backward on the
worker's rows of the global batch; ``acc = residual + g``; the selection
of the configuration's compressor (``gaussian_fused``, stated below); the
residual ``acc`` with the sent entries zeroed; then every worker's sent
pairs, each value divided by the number of workers, added into the
momentum after its decay and weight decay, ``m = mu * m + wd * p``,
``m[idx] += v``; and ``p = p - lr(step) * m``. The loss of a step is the
mean of the workers' mean losses.

The selection rule (the density's candidate cells, then an exact top-k,
then a threshold carried to the next step), as the configuration's
compressor states it:

* the accumulator is zero-padded to whole cells and seen as rows of 128
  lanes; a cell is ``seg`` consecutive rows of one lane, ``seg`` the
  largest of 64, 32, 16, 8 with ``seg * density <= 0.5`` (8 at the
  least);
* in each cell the entries with ``|x| > t`` compete by the key
  ``(bits(|x|) with its low log2(seg) bits cleared) | row in the cell``;
  the largest key's entry is the cell's candidate;
* the ``k`` candidates of largest ``|x|`` are sent (ties to the earlier
  cell, cells in row-group order, lanes within); a slot whose candidate is
  zero sends nothing;
* the next threshold: at ``t <= 0`` the smallest sent magnitude (1e-8 when
  nothing was sent); else ``t * clip(((count + 1) / (k + 1)) ** 0.18,
  1/4, 4)`` with ``count`` the entries of ``|x| > t``.

A ``fault`` plants one of the faults the check must catch, in the
reference put in the program's place: ``half_batch`` (each worker's loss
and gradient over the first half of its rows) or ``no_exchange`` (each
worker adds only its own pairs).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from . import models
from .lowp import ROUNDINGS

CELL_LANES = 128
GAIN = 0.18
FAULTS = ("half_batch", "no_exchange")


@dataclass(frozen=True)
class Hyper:
    """The configuration's numbers the steps read."""

    lr: float
    momentum: float
    weight_decay: float
    density: float
    workers: int
    warmup_epochs: float
    steps_per_epoch: int
    total_steps: int
    milestones: Tuple[float, ...]
    lr_decay: float

    @property
    def seg(self) -> int:
        seg = 64
        while seg > 8 and self.density * seg > 0.5:
            seg //= 2
        return seg

    def k(self, n: int) -> int:
        return max(1, math.ceil(self.density * n))

    def lr_at(self, step: int) -> float:
        """The milestone schedule with the multi-worker linear warm-up from
        ``lr`` to ``lr * workers``, rounded to float32."""
        lr = self.lr
        if self.workers > 1:
            warm = max(1, int(self.warmup_epochs * self.steps_per_epoch))
            lr += (self.lr * self.workers - self.lr) * min(step / warm, 1.0)
        decays = sum(step >= int(m * self.total_steps)
                     for m in self.milestones)
        return float(np.float32(lr * self.lr_decay ** decays))


def select(acc: torch.Tensor, t: torch.Tensor, k: int, seg: int):
    """``(indices [k] int64, values [k], sent [k] bool, count)`` of the
    rule above on a flat f32 ``acc``; unsent slots carry index 0 and
    value 0."""
    n = acc.numel()
    cell = seg * CELL_LANES
    x = torch.nn.functional.pad(acc, (0, -n % cell)).view(-1, seg,
                                                          CELL_LANES)
    mag = x.abs()
    over = mag > t
    row = torch.arange(seg, dtype=torch.int32, device=acc.device)
    key = (mag.view(torch.int32) & ~(seg - 1)) | row.view(1, seg, 1)
    key = torch.where(over, key, 0)
    top, at = key.max(dim=1)                         # [groups, lanes]
    value = torch.where(top > 0, x.gather(1, at.unsqueeze(1)).squeeze(1),
                        0.0).reshape(-1)
    group = torch.arange(x.shape[0], device=acc.device).view(-1, 1)
    lane = torch.arange(CELL_LANES, device=acc.device).view(1, -1)
    index = ((group * seg + at) * CELL_LANES + lane).reshape(-1)
    order = torch.sort(value.abs(), descending=True, stable=True).indices[:k]
    val = value[order]
    sent = val != 0
    return (torch.where(sent, index[order], 0), torch.where(sent, val, 0.0),
            sent, over.sum())


def next_threshold(t: torch.Tensor, val: torch.Tensor, sent: torch.Tensor,
                   count: torch.Tensor, k: int) -> torch.Tensor:
    if float(t) <= 0:
        mags = val.abs()[sent]
        return (mags.min() if mags.numel()
                else torch.tensor(1e-8, device=t.device)).float()
    ratio = (count.float() + 1.0) / float(k + 1)
    nudge = (ratio.double() ** float(np.float32(GAIN))).float()
    return t * torch.clamp(nudge, 0.25, 4.0)


@dataclass
class Model:
    """A reference model: its leaves' layout and its loss on a worker's
    rows."""

    layout: models.Layout
    # (leaves, x, y, dropout generator, rounding) -> mean loss
    loss: Callable


@dataclass
class Steps:
    """What the first steps computed: each step's loss; after step 1 the
    momentum (the gradient as the optimizer got it), worker 0's residual
    and the workers' mean dense gradient; after the last step the
    parameters. Flat float32 on the CPU, ``n`` entries each."""

    losses: List[float]
    momentum1: torch.Tensor
    residual1: torch.Tensor
    grad1: torch.Tensor
    params: torch.Tensor


def run_steps(model: Model, hyper: Hyper, p0: torch.Tensor,
              batches: Sequence[Tuple[np.ndarray, np.ndarray]],
              dropout_seeds: Sequence[int], precision: str = "float32",
              fault: Optional[str] = None) -> Steps:
    """``len(batches)`` steps from the flat weights ``p0`` (on the device
    the steps run on), on global batches of numpy ``(x, y)`` whose rows
    split evenly over ``hyper.workers``."""
    if fault is not None and fault not in FAULTS:
        raise ValueError(f"unknown fault {fault!r}; known: {FAULTS}")
    dev = p0.device
    q = ROUNDINGS[precision]
    n = models.numel(model.layout)
    k, seg, P = hyper.k(n), hyper.seg, hyper.workers
    params = p0[:n].detach().clone().float()
    mom = torch.zeros_like(params)
    residual = [torch.zeros_like(params) for _ in range(P)]
    thresh = [torch.zeros((), device=dev) for _ in range(P)]
    gens = [torch.Generator(dev).manual_seed(int(s)) for s in dropout_seeds]
    out: Dict[str, torch.Tensor] = {}
    losses: List[float] = []
    for step, (xb, yb) in enumerate(batches):
        rows = xb.shape[0] // P
        pairs, loss_sum, grad_sum = [], 0.0, torch.zeros_like(params)
        for w in range(P):
            lo = w * rows
            hi = lo + (rows // 2 if fault == "half_batch" else rows)
            x = torch.from_numpy(np.ascontiguousarray(xb[lo:hi])).to(dev)
            y = torch.from_numpy(np.ascontiguousarray(yb[lo:hi])).to(dev)
            flat = params.clone().requires_grad_(True)
            loss = model.loss(models.split_flat(flat, model.layout), x, y,
                              gens[w], q)
            (g,) = torch.autograd.grad(loss, flat)
            loss_sum += float(loss.detach())
            grad_sum += g
            with torch.no_grad():
                acc = residual[w] + g
                idx, val, sent, count = select(acc, thresh[w], k, seg)
                thresh[w] = next_threshold(thresh[w], val, sent, count, k)
                acc[idx[sent]] = 0.0
                residual[w] = acc
            pairs.append((idx, val / P))
        losses.append(loss_sum / P)
        with torch.no_grad():
            mom = mom * hyper.momentum + params * hyper.weight_decay
            own = pairs[:1] if fault == "no_exchange" else pairs
            for idx, val in own:
                mom.index_add_(0, idx, val)
            params = params + mom * -hyper.lr_at(step)
        if step == 0:
            out = {"momentum1": mom.cpu(), "residual1": residual[0].cpu(),
                   "grad1": (grad_sum / P).cpu()}
    return Steps(losses, out["momentum1"], out["residual1"], out["grad1"],
                 params.cpu())
