"""The host side of fault tolerance (port of
``gaussiank_sgd_tpu/training/resilience.py``).

The step itself contains a non-finite gradient: its guard
(``parallel/trainstep.py``) turns such a step into a no-op on the device,
which keeps a NaN out of the EF residual. This module holds the policy the
trainer consults on the host:

* :class:`ResilienceMonitor` observes every step's (already read) loss and
  skip flag. After ``max_consecutive_skips`` back-to-back skipped steps, or
  a loss spike over the loss's EMA, it arms a rollback, which the trainer
  executes at the next log-interval boundary: restore the newest good
  checkpoint from before the anomaly and back the learning rate off;
* :class:`GracefulShutdown` turns SIGTERM/SIGINT into "seal a checkpoint at
  the next step boundary, then exit cleanly" (:class:`TrainingPreempted`).

The monitor is plain Python state, deterministic given the observed
stream, so ``training/chaos.py`` can drive every path in tests.
"""

from __future__ import annotations

import math
import signal
import threading
from dataclasses import dataclass
from typing import Callable, List, Optional


class TrainingPreempted(Exception):
    """Raised at a step boundary after a shutdown request was honoured (the
    checkpoint written); carries the step the run stopped at."""

    def __init__(self, step: int, ckpt_path: Optional[str]):
        super().__init__(f"preempted at step {step}, checkpoint: "
                         f"{ckpt_path or 'none'}")
        self.step = step
        self.ckpt_path = ckpt_path


@dataclass
class ResiliencePolicy:
    """The monitor's knobs (``TrainConfig`` carries the same fields; 0
    turns a detector off).

    ``max_consecutive_skips``: after this many back-to-back guard-skipped
    steps the run rolls back. ``loss_spike_factor``: roll back when a loss
    exceeds ``factor * EMA(loss)`` (EMA over finite losses with decay
    ``loss_ema_beta``, after ``loss_ema_warmup`` observations). Each
    rollback multiplies the learning-rate scale by ``lr_backoff``;
    beyond ``max_rollbacks`` the run fails loud.
    """

    max_consecutive_skips: int = 10
    loss_spike_factor: float = 0.0
    loss_ema_beta: float = 0.9
    loss_ema_warmup: int = 5
    lr_backoff: float = 0.5
    max_rollbacks: int = 3

    @property
    def active(self) -> bool:
        return self.max_consecutive_skips > 0 or self.loss_spike_factor > 0


class ResilienceMonitor:
    """Per-run divergence tracker: ``observe`` once a step with host
    scalars, ``should_rollback`` once a log interval (a reason or None)."""

    def __init__(self, policy: ResiliencePolicy,
                 on_anomaly: Optional[Callable[[str, int], None]] = None):
        self.policy = policy
        self.consecutive_skips = 0
        self.total_skips = 0
        self.rollbacks = 0
        self._loss_ema: Optional[float] = None
        self._ema_obs = 0
        self._pending: Optional[str] = None
        self._pending_step: Optional[int] = None
        # (reason, step) callbacks run, in registration order, the moment
        # an anomaly first becomes pending; they must not raise
        self._anomaly_hooks: List[Callable[[str, int], None]] = (
            [on_anomaly] if on_anomaly is not None else [])

    def add_anomaly_hook(self, hook: Callable[[str, int], None]) -> None:
        self._anomaly_hooks.append(hook)

    def _set_pending(self, reason: str, step: int) -> None:
        if self._pending is None:
            self._pending = reason
            self._pending_step = step
            for hook in self._anomaly_hooks:
                hook(reason, step)

    def pre_arm(self, reason: str, step: int) -> None:
        """Arm a rollback from outside, as if a detector fired at ``step``
        (no-op while one is pending: the first reason wins)."""
        self._set_pending(reason, step)

    def observe(self, step: int, loss: float, skipped: float) -> None:
        p = self.policy
        if skipped > 0:
            self.consecutive_skips += 1
            self.total_skips += 1
            if (p.max_consecutive_skips > 0
                    and self.consecutive_skips >= p.max_consecutive_skips):
                self._set_pending("skip_budget", step)
            return
        self.consecutive_skips = 0
        if not math.isfinite(loss):
            # a non-finite loss on an unskipped step means the guard is
            # off: the spike detector is the policy's only one then
            if p.loss_spike_factor > 0:
                self._set_pending("loss_spike", step)
            return
        if (p.loss_spike_factor > 0 and self._ema_obs >= p.loss_ema_warmup
                and self._loss_ema is not None
                and loss > p.loss_spike_factor * self._loss_ema):
            self._set_pending("loss_spike", step)
            return              # a spiking loss must not drag the EMA up
        if self._loss_ema is None:
            self._loss_ema = loss
        else:
            b = p.loss_ema_beta
            self._loss_ema = b * self._loss_ema + (1.0 - b) * loss
        self._ema_obs += 1

    def should_rollback(self) -> Optional[str]:
        return self._pending

    @property
    def pending_since(self) -> Optional[int]:
        """The step at which the pending anomaly was first observed (None
        when none is pending): the rollback skips every checkpoint sealed
        at or after it, which may already hold the diverged state."""
        return self._pending_step

    def note_rollback(self) -> int:
        """Count one executed rollback and return its ordinal (from 1);
        raises once the budget is spent, when the fault recurs after every
        restore."""
        self.rollbacks += 1
        if self.rollbacks > self.policy.max_rollbacks:
            raise RuntimeError(
                f"rollback budget exhausted ({self.policy.max_rollbacks}); "
                f"the fault recurs after every restore: inspect the data "
                f"or lower the learning rate")
        # a restored run starts clean: skip streak, pending flag and the
        # loss EMA (the losses after it build their own baseline)
        self.consecutive_skips = 0
        self._pending = None
        self._pending_step = None
        self._loss_ema = None
        self._ema_obs = 0
        return self.rollbacks

    @property
    def lr_scale(self) -> float:
        """The compounded learning-rate backoff after the rollbacks so
        far."""
        return self.policy.lr_backoff ** self.rollbacks


class GracefulShutdown:
    """SIGTERM/SIGINT -> checkpoint at the next step boundary, then exit.
    The handler only sets a ``threading.Event``; the trainer reads
    ``requested`` once a step, and ``request()`` sets it from code.
    ``install``/``uninstall`` run on the main thread only (CPython's rule
    for ``signal.signal``); a second SIGINT raises ``KeyboardInterrupt``."""

    SIGNALS = (signal.SIGTERM, signal.SIGINT)

    def __init__(self) -> None:
        self._flag = threading.Event()
        self._old: dict = {}

    def install(self) -> "GracefulShutdown":
        # checked before the first swap: failing half-way would leave the
        # process half-installed
        if threading.current_thread() is not threading.main_thread():
            raise RuntimeError(
                "GracefulShutdown.install() must run on the main thread of "
                "its own process (CPython's signal.signal restriction)")
        for sig in self.SIGNALS:
            self._old[sig] = signal.signal(sig, self._handler)
        return self

    def uninstall(self) -> None:
        for sig, old in self._old.items():
            signal.signal(sig, old)
        self._old.clear()

    def _handler(self, signum, frame) -> None:
        if self._flag.is_set() and signum == signal.SIGINT:
            raise KeyboardInterrupt      # a second Ctrl-C: out, now
        self._flag.set()

    def request(self) -> None:
        self._flag.set()

    @property
    def requested(self) -> bool:
        return self._flag.is_set()
