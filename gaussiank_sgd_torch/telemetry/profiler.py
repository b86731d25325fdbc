"""A ``torch.profiler`` trace armed for a range of global steps (port of
``ProfilerSession`` from ``gaussiank_sgd_tpu/telemetry/profiler.py``).

One object owns the window: it starts the trace when the loop enters the
window (also when it enters late, as a resumed run past the start does),
stops it at the window's end, writes the trace as a Chrome trace file
under ``logdir``, and reports each start and stop through ``on_event``, so
the run's metrics file says which steps the trace covers. ``close`` stops
a trace that is still live (an early exit or a preemption).
"""

from __future__ import annotations

import logging
import os
import time
from typing import Callable, Dict, Optional

log = logging.getLogger(__name__)


class ProfilerSession:
    """Traces global steps [``start_step``, ``stop_step``): call
    ``maybe_transition(step)`` with the current step before each step.
    After the stop, ``last`` holds the stopped ``torch.profiler.profile``
    (for ``key_averages()``), ``wall_s`` the window's wall time (the device
    synchronised at both ends) and ``path`` the trace file."""

    def __init__(self, logdir: str, start_step: int, stop_step: int,
                 on_event: Optional[Callable[[Dict], None]] = None,
                 cuda: bool = True):
        if stop_step <= start_step:
            raise ValueError(f"profiler window is empty: start {start_step} "
                             f">= stop {stop_step}")
        if start_step < 0:
            raise ValueError(f"negative start_step {start_step}")
        self.logdir = logdir
        self.start_step = start_step
        self.stop_step = stop_step
        self._on_event = on_event
        self._cuda = cuda
        self.active = False
        self._done = False              # one window a session
        self.last = None
        self.wall_s: Optional[float] = None
        self.path: Optional[str] = None
        self._t0 = 0.0

    def _emit(self, action: str, step: int) -> None:
        if self._on_event is not None:
            self._on_event({"event": "profile", "action": action,
                            "step": step, "logdir": self.logdir})
        log.info("profiler %s at step %d -> %s", action, step, self.logdir)

    def _sync(self) -> None:
        if self._cuda:
            import torch
            torch.cuda.synchronize()

    def maybe_transition(self, step: int) -> None:
        """Start or stop the trace as the window says."""
        if (not self.active and not self._done
                and self.start_step <= step < self.stop_step):
            from torch.profiler import ProfilerActivity, profile
            activities = [ProfilerActivity.CPU]
            if self._cuda:
                activities.append(ProfilerActivity.CUDA)
            self._sync()
            self.last = profile(activities=activities)
            self.last.start()
            self._t0 = time.perf_counter()
            self.active = True
            self._emit("start", step)
        elif self.active and step >= self.stop_step:
            self._stop(step)

    def _stop(self, step: int) -> None:
        self._sync()
        self.wall_s = time.perf_counter() - self._t0
        self.last.stop()
        os.makedirs(self.logdir, exist_ok=True)
        self.path = os.path.join(
            self.logdir, f"trace_steps_{self.start_step}_{step}.json")
        self.last.export_chrome_trace(self.path)
        self.active = False
        self._done = True
        self._emit("stop", step)

    def close(self, step: Optional[int] = None) -> None:
        """Stop a trace that is still running (at ``step``, default the
        window's end)."""
        if self.active:
            self._stop(self.stop_step if step is None else step)
