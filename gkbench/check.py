"""The comparison that decides ``correct``: what the timed path computed in
its first steps against the float32 reference's first steps from the same
weights, batches and dropout seeds.

Each number is a gap between two norms (never the norm of a difference);
a cell compares those its ``workloads/<cell>.json`` gives a limit, which
its readings on the chip decide (``PERF.md``). Over the whole vector:

* ``loss1_gap``: step 1's loss, ``|loss - ref| / |ref|`` (the forward);
* ``grad_gap``: the gradient as the optimizer got it in step 1 (the
  momentum after one step: the workers' averaged sparse pairs plus the
  weight decay), ``| ||prog|| - ||ref|| | / ||ref||`` (EF, the
  selection, the exchange);
* ``residual_gap``: worker 0's error-feedback residual after step 1 (its
  dense gradient less what it sent), likewise (the backward, and which
  entries left);
* ``update_gap``: the parameters' change over the checked steps, likewise,
  over the moved leaves (the optimizer and the commit).

By leaf, as the training contract reads a norm: ``| ||prog_leaf|| -
||ref_leaf|| | / max(||ref_leaf||, the median leaf's ||ref||)``, the worst
leaf (``*_leaf_gap``) and the median leaf (``*_median_gap``), over the
entries both sides selected alike. An entry near the k-th place that
rounding moves into one side's selection and not the other's is one whole
gradient entry in one side's norm of a small leaf; those entries are
zeroed on both sides before the leaf norms are taken, and their number
over the reference's selection is a number of its own:

* ``flip_share``: the entries only one side sent in step 1 (a sent entry
  is one whose step-1 momentum is not the weight decay's alone, within
  ``SENT_REL``) over the entries the reference sent;
* the step-1 gradient and residual are masked by the step-1 one-side
  entries (for the residual, an entry is sent where it is zero); the
  change by the entries only one side touched in any checked step (an
  entry whose change is not the weight decay's alone, worked out in
  float64 from the weights and the schedule).

Moved leaves: those whose step-1 reference gradient is at least a
thousandth of the median leaf's (a leaf whose gradient is nought to
rounding moves by round-off alone).
"""

from __future__ import annotations

import math
from typing import Dict, Iterable, List, Optional, Tuple

import torch

from .reference.models import Layout
from .reference.sgd import Hyper, Steps

NUMBERS = ("loss1_gap", "grad_gap", "residual_gap", "update_gap",
           "flip_share", "grad_leaf_gap", "residual_leaf_gap",
           "update_leaf_gap", "grad_median_gap", "residual_median_gap",
           "update_median_gap")
# the numbers taken with nothing masked
WHOLE = {"loss1_gap", "grad_gap", "residual_gap", "update_gap"}
MOVED_FLOOR = 1e-3
# an entry's change is the weight decay's alone within this share of it
TOUCH_REL = 1e-2
# a step-1 momentum entry is the weight decay's alone within this share
SENT_REL = 1e-5


def _leaf_norms(flat: torch.Tensor, layout: Layout) -> List[float]:
    sizes = [math.prod(s) for _, s in layout]
    parts = torch.split(flat[:sum(sizes)].double(), sizes)
    return [float(torch.linalg.vector_norm(p)) for p in parts]


def _median(xs: List[float]) -> float:
    ys = sorted(xs)
    m = len(ys) // 2
    return ys[m] if len(ys) % 2 else 0.5 * (ys[m - 1] + ys[m])


def _gap(a: float, b: float) -> float:
    return abs(a - b) / b if b > 0 else float(a != b)


def _masked(x: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
    return x if mask is None else torch.where(mask, 0.0, x)


def leaf_gaps(prog: torch.Tensor, ref: torch.Tensor, layout: Layout,
              keep: Optional[List[bool]] = None,
              mask: Optional[torch.Tensor] = None) -> List[Tuple[float, str]]:
    """``(gap, leaf)`` of each leaf ``keep`` marks, ``mask``'s entries
    zeroed on both sides: ``| ||a|| - ||b|| | / max(||b||, the median
    leaf's ||b||)``."""
    a = _leaf_norms(_masked(prog, mask), layout)
    b = _leaf_norms(_masked(ref, mask), layout)
    idx = [i for i in range(len(layout)) if keep is None or keep[i]]
    floor = _median([b[i] for i in idx])
    out = []
    for i in idx:
        den = max(b[i], floor)
        out.append((abs(a[i] - b[i]) / den if den > 0 else float(a[i] != 0),
                    layout[i][0]))
    return out


def norm_gap(prog: torch.Tensor, ref: torch.Tensor, layout: Layout,
             keep: Optional[List[bool]] = None) -> Tuple[float, str]:
    """The gap of the norms over the leaves ``keep`` marks (all by
    default)."""
    a, b = _leaf_norms(prog, layout), _leaf_norms(ref, layout)
    idx = [i for i in range(len(layout)) if keep is None or keep[i]]
    return (_gap(math.sqrt(sum(a[i] ** 2 for i in idx)),
                 math.sqrt(sum(b[i] ** 2 for i in idx))),
            f"{len(idx)} leaves")


def moved_leaves(grad: torch.Tensor, layout: Layout) -> List[bool]:
    """Leaves whose reference gradient is not nought to rounding."""
    g = _leaf_norms(grad, layout)
    floor = MOVED_FLOOR * _median(g)
    return [x >= floor for x in g]


def sent1(steps: Steps, p0: torch.Tensor, hyper: Hyper) -> torch.Tensor:
    """The entries some worker sent in step 1: the momentum after one step
    is ``wd * p0`` plus the sent pairs (a sent value is far above the
    rounding of ``wd * p0``, which the two sides may round apart)."""
    decay = p0 * hyper.weight_decay
    return (steps.momentum1 - decay).abs() > SENT_REL * decay.abs()


def decay_change(p0: torch.Tensor, hyper: Hyper, count: int) -> torch.Tensor:
    """The change over ``count`` steps of an entry that no step sent: the
    momentum and weight decay alone, in float64."""
    p, m = p0.double(), torch.zeros_like(p0, dtype=torch.float64)
    for step in range(count):
        m = m * hyper.momentum + p * hyper.weight_decay
        p = p - hyper.lr_at(step) * m
    return p - p0.double()


def touched(change: torch.Tensor, decay: torch.Tensor) -> torch.Tensor:
    """Entries some checked step sent: their change is not the weight
    decay's alone."""
    return (change.double() - decay).abs() > TOUCH_REL * decay.abs()


def masks(prog: Steps, ref: Steps, p0: torch.Tensor, hyper: Hyper
          ) -> Dict[str, torch.Tensor]:
    """The entries only one side selected: in step 1 (``grad``), worker
    0's in step 1 (``residual``), in any checked step (``update``)."""
    decay = decay_change(p0, hyper, len(ref.losses))
    return {"grad": sent1(prog, p0, hyper) ^ sent1(ref, p0, hyper),
            "residual": (prog.residual1 == 0) ^ (ref.residual1 == 0),
            "update": (touched(prog.params - p0, decay)
                       ^ touched(ref.params - p0, decay))}


def numbers(prog: Steps, ref: Steps, p0: torch.Tensor, layout: Layout,
            hyper: Hyper, names: Iterable[str] = NUMBERS
            ) -> Dict[str, Tuple[float, str]]:
    """Each of ``names`` with where it was taken or worst."""
    names = set(names)
    unknown = names - set(NUMBERS)
    if unknown:
        raise ValueError(f"no number {sorted(unknown)}; known: {NUMBERS}")
    p0 = p0[:prog.params.numel()].float().cpu()
    moved = moved_leaves(ref.grad1, layout)
    pairs = {"grad": (prog.momentum1, ref.momentum1, None),
             "residual": (prog.residual1, ref.residual1, None),
             "update": (prog.params - p0, ref.params - p0, moved)}
    out: Dict[str, Tuple[float, str]] = {}
    if "loss1_gap" in names:
        out["loss1_gap"] = (_gap(prog.losses[0], ref.losses[0]), "step 1")
    one_side = masks(prog, ref, p0, hyper) if names - WHOLE else {}
    if "flip_share" in names:
        sent = int(sent1(ref, p0, hyper).sum())
        flips = int(one_side["grad"].sum())
        out["flip_share"] = (flips / max(sent, 1),
                             f"{flips} of {sent} entries")
    for name, (a, b, keep) in pairs.items():
        if f"{name}_gap" in names:
            out[f"{name}_gap"] = norm_gap(a, b, layout, keep)
        if {f"{name}_leaf_gap", f"{name}_median_gap"} & names:
            gaps = leaf_gaps(a, b, layout, keep, one_side[name])
            out[f"{name}_leaf_gap"] = max(gaps)
            out[f"{name}_median_gap"] = (
                _median([g for g, _ in gaps]), f"median of {len(gaps)}")
    return {k: v for k, v in out.items() if k in names}
