"""The run's log file and the phase timers of the train loop (port of
``make_logger`` and ``PhaseTimers`` from
``gaussiank_sgd_tpu/training/metrics.py``).

``make_logger`` gives the package's logger a file handler for the run's
``train.log`` (one run's file at a time); its lines also propagate to the
root logger, whose handler the CLI writes to stderr.

``io`` is the wait for the next batch and its copy to the device, ``step``
the step itself, timed with ``time.perf_counter`` around work that ends in
a device synchronise; the finer breakdown of a step comes from
``torch.profiler`` traces (``telemetry/profiler.py``), not host timers.
"""

from __future__ import annotations

import logging
import os
import time
from typing import Dict, Optional

_FORMAT = logging.Formatter("%(asctime)s [%(levelname)s] %(message)s",
                            "%H:%M:%S")


def make_logger(log_file: Optional[str] = None) -> logging.Logger:
    """The package's logger at INFO, writing to ``log_file`` as well when
    one is given: a handler of its own, which replaces the one an earlier
    run attached (``close_log_file`` removes it)."""
    logger = logging.getLogger("gaussiank_sgd_torch")
    logger.setLevel(logging.INFO)
    close_log_file(logger)
    if log_file:
        os.makedirs(os.path.dirname(log_file) or ".", exist_ok=True)
        handler = logging.FileHandler(log_file)
        handler.setFormatter(_FORMAT)
        handler.run_log = True
        logger.addHandler(handler)
    return logger


def close_log_file(logger: logging.Logger) -> None:
    """Detach and close the run's file handler, if ``logger`` has one."""
    for handler in [h for h in logger.handlers
                    if getattr(h, "run_log", False)]:
        logger.removeHandler(handler)
        handler.close()


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
