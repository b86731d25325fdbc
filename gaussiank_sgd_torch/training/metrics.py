"""Phase timers of the train loop (port of ``PhaseTimers`` from
``gaussiank_sgd_tpu/training/metrics.py``).

``io`` is the wait for the next batch and its copy to the device, ``step``
the step itself, timed with ``time.perf_counter`` around work that ends in
a device synchronise; the finer breakdown of a step comes from
``torch.profiler`` traces (``telemetry/profiler.py``), not host timers.
"""

from __future__ import annotations

import time
from typing import Dict, Optional


class PhaseTimers:
    """Wall-clock sums and counts by phase: ``start(phase)`` closes the
    running phase and opens the next, ``stop()`` closes it, ``means()``
    gives seconds a phase entry, ``reset()`` starts a new interval."""

    def __init__(self):
        self.sums: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}
        self._t0: Optional[float] = None
        self._phase: Optional[str] = None

    def start(self, phase: str) -> None:
        now = time.perf_counter()
        if self._phase is not None:
            self.sums[self._phase] = (self.sums.get(self._phase, 0.0)
                                      + now - self._t0)
            self.counts[self._phase] = self.counts.get(self._phase, 0) + 1
        self._phase, self._t0 = phase, now

    def stop(self) -> None:
        self.start("_idle")
        self._phase = None

    def means(self) -> Dict[str, float]:
        return {k: self.sums[k] / max(1, self.counts[k])
                for k in self.sums if not k.startswith("_")}

    def reset(self) -> None:
        self.sums.clear()
        self.counts.clear()
