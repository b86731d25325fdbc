"""Rolling-window throughput and MFU tracker, skipped-step aware (the
port's own copy of ``gaussiank_sgd_tpu/telemetry/throughput.py``; pure
Python, the same arithmetic).

Images a second taken as ``global_batch / step_s`` would overstate what a
run trains on under the resilience runtime: a step the non-finite guard
turned into a no-op took wall time but trained on nothing, and a rollback
rewinds the model, so a window across it mixes two trajectories. The
tracker makes both corrections:

* a skipped step adds its seconds but no examples, so throughput falls
  under skips instead of holding;
* :meth:`reset` empties the window; the trainer calls it on a rollback,
  so throughput after the restore is measured on the new trajectory only.

MFU counts model FLOPs of the unskipped steps only, against the card's
peak (``benchlib.device_peak_flops``).

The tracker is thread-safe, and :meth:`signals` returns one consistent
:class:`ThroughputSignals` snapshot, every number read at one instant
under the lock.
"""

from __future__ import annotations

import threading
from collections import deque
from dataclasses import dataclass
from typing import Optional


@dataclass(frozen=True)
class ThroughputSignals:
    """One consistent read of the tracker (all fields from the same
    instant). ``step_s_ema`` is the EMA of per-step wall-clock seconds
    (skipped steps included — their time was really spent); ``mfu`` is
    None unless FLOPs/peak were passed to :meth:`ThroughputTracker.
    signals`."""

    window_steps: int = 0
    skipped_in_window: int = 0
    total_seconds: float = 0.0
    step_s_ema: Optional[float] = None
    examples_per_s: Optional[float] = None
    steps_per_s: Optional[float] = None
    mfu: Optional[float] = None


class ThroughputTracker:
    """Rolling window of (examples, seconds, skipped) step samples."""

    def __init__(self, window: int = 50, ema_beta: float = 0.9):
        if window <= 0:
            raise ValueError(f"window must be positive, got {window}")
        if not 0.0 < ema_beta < 1.0:
            raise ValueError(f"ema_beta must be in (0, 1), got {ema_beta}")
        self.window = window
        self._lock = threading.Lock()
        self._samples: deque = deque(maxlen=window)
        self._beta = float(ema_beta)
        self._step_ema: Optional[float] = None

    def update(self, examples: float, seconds: float,
               skipped: bool = False) -> None:
        """Record one step. ``examples`` is the step's GLOBAL batch;
        ``seconds`` its wall-clock (device + dispatch) time."""
        if seconds < 0:
            raise ValueError(f"negative step time {seconds}")
        with self._lock:
            self._samples.append(
                (0.0 if skipped else float(examples), float(seconds),
                 bool(skipped)))
            self._step_ema = (float(seconds) if self._step_ema is None
                              else self._beta * self._step_ema
                              + (1.0 - self._beta) * float(seconds))

    def reset(self) -> None:
        """Forget the window AND the EMA (trainer: on rollback — the
        restored trajectory must not average against the diverged one)."""
        with self._lock:
            self._samples.clear()
            self._step_ema = None

    def __len__(self) -> int:
        with self._lock:
            return len(self._samples)

    # -- *_locked internals (callers hold self._lock) ---------------------
    def _total_seconds_locked(self) -> float:
        return sum(s for _, s, _ in self._samples)

    def _examples_per_s_locked(self) -> Optional[float]:
        secs = self._total_seconds_locked()
        if not self._samples or secs <= 0:
            return None
        return sum(e for e, _, _ in self._samples) / secs

    def _steps_per_s_locked(self) -> Optional[float]:
        secs = self._total_seconds_locked()
        if not self._samples or secs <= 0:
            return None
        useful = sum(1 for _, _, sk in self._samples if not sk)
        return useful / secs

    @staticmethod
    def _mfu(sps: Optional[float], flops_per_step: Optional[float],
             peak_flops: Optional[float]) -> Optional[float]:
        if not flops_per_step or not peak_flops or sps is None:
            return None
        return flops_per_step * sps / peak_flops

    # -- public reads -----------------------------------------------------
    @property
    def total_seconds(self) -> float:
        with self._lock:
            return self._total_seconds_locked()

    @property
    def skipped_in_window(self) -> int:
        with self._lock:
            return sum(1 for _, _, sk in self._samples if sk)

    @property
    def examples_per_s(self) -> Optional[float]:
        """Useful examples per wall-clock second over the window; None
        until a sample with nonzero time exists."""
        with self._lock:
            return self._examples_per_s_locked()

    @property
    def steps_per_s(self) -> Optional[float]:
        """UNSKIPPED steps per second (skips burn time, produce nothing)."""
        with self._lock:
            return self._steps_per_s_locked()

    @property
    def step_s_ema(self) -> Optional[float]:
        """EMA of per-step wall-clock seconds (skips included)."""
        with self._lock:
            return self._step_ema

    def mfu(self, flops_per_step: Optional[float],
            peak_flops: Optional[float]) -> Optional[float]:
        """Model-FLOPs utilization over the window: useful-step FLOPs /
        (elapsed * peak). None when FLOPs/peak are unknown (CPU) or the
        window is empty."""
        with self._lock:
            return self._mfu(self._steps_per_s_locked(), flops_per_step,
                             peak_flops)

    def signals(self, flops_per_step: Optional[float] = None,
                peak_flops: Optional[float] = None) -> ThroughputSignals:
        """The canonical snapshot (see module docstring): every field is
        read under one lock acquisition, so every reader sees the numbers
        a log line was stamped from."""
        with self._lock:
            sps = self._steps_per_s_locked()
            return ThroughputSignals(
                window_steps=len(self._samples),
                skipped_in_window=sum(
                    1 for _, _, sk in self._samples if sk),
                total_seconds=self._total_seconds_locked(),
                step_s_ema=self._step_ema,
                examples_per_s=self._examples_per_s_locked(),
                steps_per_s=sps,
                mfu=self._mfu(sps, flops_per_step, peak_flops),
            )
