"""The program's own per-step spans and counters (``--trace on``), for the
readers of ``enqueue_ms``, ``log_interval_ms`` and
``host_syncs_per_step``.

The trainer's trace context keeps, for each of its last few thousand
steps, each span's host ms and calls and each counter
(``gaussiank_sgd_torch/telemetry/tracing.py``: ``active()``, whose
``steps()`` is the store, oldest step first). The window's steps are the
store's last ``ctx.steps``; the readers take those before the profiled
stretch (``ctx.outside``), the steps ``loop_host_ms`` reads. A program
without such a store gives None, and so do the readers.

They read a run on a device only: one whose profiled stretch saw device
activity. On the CPU the step's operations run inside the host's calls,
so the dispatch is the compute and no part of the loop waits for a
device; such a run gives None, as the device's own metrics do.
"""

from __future__ import annotations

from typing import Dict, List, Optional


def outside_steps(ctx) -> Optional[List[Dict]]:
    """The store's entries of the window's steps before the profiled
    stretch, in order; None without a store holding the whole window."""
    try:
        from gaussiank_sgd_torch.telemetry import tracing
    except ImportError:
        return None
    active = getattr(tracing, "active", None)
    store = active() if active is not None else None
    if (store is None or not ctx.outside or ctx.summary is None
            or not ctx.summary.busy_s):
        return None
    steps = list(store.steps().values())
    if len(steps) < ctx.steps:
        return None
    window = steps[len(steps) - ctx.steps:]
    return [window[i] for i in ctx.outside]
