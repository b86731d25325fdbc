"""Arithmetic the metric readers share."""

from __future__ import annotations

import statistics
from typing import List, Optional, Sequence


def p95(xs: Sequence[float]) -> Optional[float]:
    """The 95th percentile, interpolated between order statistics
    (``statistics.quantiles``' inclusive method); None for fewer than two
    values."""
    if len(xs) < 2:
        return None
    return statistics.quantiles(xs, n=20, method="inclusive")[18]


def mean_of(xs: Sequence[float], at: List[int]) -> Optional[float]:
    """The mean of ``xs`` at the steps ``at``, when ``xs`` has a value for
    every step."""
    vals = [xs[i] for i in at if i < len(xs)]
    return sum(vals) / len(vals) if vals and len(vals) == len(at) else None


def layer_ms(ctx, name: str) -> Optional[float]:
    """Device ms a step of the kernels launched inside the layer range
    ``name`` over the profiled stretch; None when the range never ran or
    the trace holds no device activity."""
    s = ctx.summary
    if (s is None or not s.busy_s or name not in s.range_s
            or not ctx.stretch_steps):
        return None
    return s.range_s[name] / ctx.stretch_steps * 1e3
