"""Rolling signal state the policy engine maintains from the event bus
(port of ``gaussiank_sgd_tpu/policy/signals.py``).

The engine is attached to the trainer's :class:`~gaussiank_sgd_torch.
telemetry.bus.EventBus` as an exporter, so every record the runtime
publishes — ``train`` intervals with the on-device comms accounting
(``step_s``, ``ef_norm``, ``density_achieved``, ``bytes_sent``,
``wire_format``), resilience ``skip``/``rollback`` events — flows through
:meth:`PolicySignals.update` in publish order. ``update`` runs UNDER the
bus lock (exporter contract), so it must stay cheap and must never
publish back to the bus; the engine's decision pass reads a consistent
:class:`SignalSnapshot` later, from the trainer thread, under this
module's own lock.

Signals are per-interval (the trainer publishes one ``train`` record per
``log_every`` steps), which is exactly the cadence decisions are made at:
the log-interval boundary, where the trainer may rebuild its step.
"""

from __future__ import annotations

import threading
from collections import deque
from dataclasses import dataclass, field
from typing import Deque, Dict, Mapping, Optional, Tuple


@dataclass(frozen=True)
class SignalSnapshot:
    """Point-in-time view the rules consume (all host floats, no arrays).

    ``step_s_ema`` is the EMA of the interval-mean step seconds;
    ``ef_grad_ratio`` is EMA(ef_norm)/EMA(grad_norm) — the error-feedback
    pressure gauge the density rule reads (a residual norm that keeps
    growing relative to the gradient means the density is too low to
    drain what EF accumulates); ``ef_ratio_intervals`` counts the sparse
    intervals that fed it (dense warm-up intervals leave EF untouched, so
    their ef_norm=0 is structural, not a signal — they are excluded);
    ``ef_ratio_trend`` is the difference
    between the newest and oldest entry of the recent-ratio window
    (positive = rising). ``arm_step_s`` carries the per-selector
    steady-state EMAs observed so far — only intervals AFTER the settle
    period of a switch contribute, so compile time never pollutes an
    arm's record.
    """

    step: int = 0
    intervals: int = 0
    step_s_ema: Optional[float] = None
    dense_step_s_ema: Optional[float] = None
    ef_grad_ratio: Optional[float] = None
    ef_ratio_intervals: int = 0
    ef_ratio_trend: Optional[float] = None
    achieved_density: Optional[float] = None
    bytes_per_step: Optional[float] = None
    wire_format: Optional[str] = None
    overlap: Optional[str] = None
    loss_ema: Optional[float] = None
    consecutive_skips: int = 0
    skips_since: Dict[int, int] = field(default_factory=dict)
    last_rollback_step: Optional[int] = None
    arm_step_s: Dict[str, float] = field(default_factory=dict)
    arm_intervals: Dict[str, int] = field(default_factory=dict)
    # cross-run sentinel verdicts ingested from bench_regression records
    # (analysis/regression_sentinel.py --emit-event): how many times the
    # tree this run is on was flagged, and the worst config named last —
    # a standing caution the rules can weigh (a flagged tree is a bad
    # time to explore aggressive density cuts)
    bench_regressions: int = 0
    last_bench_regression: Optional[str] = None
    # latest run-health verdict ingested from health_status records
    # (telemetry/health.py, --health on): 0 ok / 1 degraded / 2 critical
    # plus the attributed causes. The engine holds exploration while the
    # run is non-ok — retuning knobs mid-incident would confound the
    # monitor's cause attribution AND measure the new arm under
    # conditions that won't persist. Stays 0/() when health is off, so
    # static-health runs decide identically to pre-health builds.
    health_state: int = 0
    health_causes: Tuple[str, ...] = ()

    def skips_after(self, step: int) -> int:
        """Guard-skipped steps observed at global steps > ``step``."""
        return sum(n for s, n in self.skips_since.items() if s > step)


class PolicySignals:
    """Thread-safe rolling signal accumulator (the engine's ears).

    ``current_arm`` names the selector whose step timings the ``train``
    intervals currently describe; the engine rebinds it on every applied
    or reverted decision, and passes ``settle`` intervals of grace after
    each rebind so intervals holding a rebuild's first-call costs never
    enter an arm's
    steady-state EMA. Dense warm-up intervals are attributed to the
    reserved ``DENSE_ARM`` instead (the trainer flags them), giving the
    rules a measured dense reference for overhead-vs-floor gating.
    """

    DENSE_ARM = "__dense__"

    def __init__(self, beta: float = 0.7, trend_window: int = 4,
                 settle: int = 1):
        if not 0.0 < beta < 1.0:
            raise ValueError(f"beta must be in (0, 1), got {beta}")
        self._lock = threading.Lock()
        self._beta = beta
        self._settle = max(0, int(settle))
        self._settle_left = 0
        self._arm: Optional[str] = None
        self._step = 0
        self._intervals = 0
        self._step_ema: Optional[float] = None
        self._ef_ratio_ema: Optional[float] = None
        self._ef_ratio_n = 0
        self._ratio_recent: Deque[float] = deque(maxlen=max(2, trend_window))
        self._achieved: Optional[float] = None
        self._bytes: Optional[float] = None
        self._wire: Optional[str] = None
        self._overlap: Optional[str] = None
        self._loss_ema: Optional[float] = None
        self._consecutive_skips = 0
        self._skips: Dict[int, int] = {}
        self._last_rollback: Optional[int] = None
        self._arm_ema: Dict[str, float] = {}
        self._arm_n: Dict[str, int] = {}
        self._bench_regressions = 0
        self._last_bench_regression: Optional[str] = None
        self._health_state = 0
        self._health_causes: Tuple[str, ...] = ()

    # -- engine-side bookkeeping ------------------------------------------
    def bind_arm(self, arm: Optional[str]) -> None:
        """Name the selector now on the hot path; starts a settle period
        (and drops the global step-time EMA — it described the old
        program)."""
        with self._lock:
            self._arm = arm
            self._settle_left = self._settle
            self._step_ema = None

    def reset_arm_records(self) -> None:
        """Drop every selector arm's steady-state record: after a density
        or bucket-plan retune the program layout changed, and timings
        measured under the old layout are not comparable with the new
        ones (the SelectorRule's regret/exploration comparisons would mix
        them). The DENSE_ARM reference survives — the dense step runs no
        selection or sparse exchange, so these knobs don't move it."""
        with self._lock:
            dense = self._arm_ema.get(self.DENSE_ARM)
            dense_n = self._arm_n.get(self.DENSE_ARM)
            self._arm_ema = {} if dense is None \
                else {self.DENSE_ARM: dense}
            self._arm_n = {} if dense_n is None \
                else {self.DENSE_ARM: dense_n}

    def reset_for_geometry(self, nworkers: int) -> None:
        """Drop every timing-derived signal after an ELASTIC mesh resize
        (``old_nworkers`` -> ``nworkers``): per-step wall time, the
        per-arm steady-state records INCLUDING the dense reference (the
        dense step itself runs a different psum width now), the
        bytes-per-step gauge (proportional to P·k), and the EF-pressure
        window (the mass-preserving redistribution rescaled every
        residual row, so pre-resize ratios describe tensors that no
        longer exist). Loss/skip/rollback/health signals survive — they
        are trajectory facts, not geometry measurements. A settle period
        is armed exactly like ``bind_arm`` so the first post-restore
        compile interval stays out of the fresh EMAs."""
        del nworkers                     # documents intent; value unused
        with self._lock:
            self._settle_left = self._settle
            self._step_ema = None
            self._arm_ema = {}
            self._arm_n = {}
            self._ef_ratio_ema = None
            self._ef_ratio_n = 0
            self._ratio_recent.clear()
            self._bytes = None

    def _ema(self, old: Optional[float], new: float) -> float:
        return new if old is None else self._beta * old \
            + (1.0 - self._beta) * new

    # -- exporter-side ingest (runs under the bus lock: cheap, no publish) --
    def update(self, record: Mapping[str, object]) -> None:
        event = record.get("event")
        if event == "train":
            self._ingest_train(record)
        elif event == "skip":
            with self._lock:
                step = int(record.get("step", 0) or 0)
                self._skips[step] = self._skips.get(step, 0) + 1
                self._consecutive_skips += 1
        elif event == "rollback":
            with self._lock:
                to_step = int(record.get("to_step", 0) or 0)
                self._last_rollback = to_step
                # the rewind abandons everything past to_step: skips
                # recorded at higher steps belong to the dead trajectory
                # and must not count against decisions applied at lower
                # post-rollback steps (spurious skips_after >= skip_burst
                # would revert + quarantine a possibly good pair)
                self._skips = {s: n for s, n in self._skips.items()
                               if s <= to_step}
                self._consecutive_skips = 0
        elif event == "health_status":
            with self._lock:
                code = record.get("state_code")
                if isinstance(code, (int, float)) \
                        and not isinstance(code, bool):
                    self._health_state = int(code)
                causes = record.get("causes")
                self._health_causes = tuple(
                    c for c in (causes if isinstance(causes, (list, tuple))
                                else ())
                    if isinstance(c, str))
        elif event == "bench_regression":
            with self._lock:
                if record.get("status") == "regressed":
                    self._bench_regressions += 1
                    wc = record.get("worst_config")
                    self._last_bench_regression = (
                        wc if isinstance(wc, str)
                        else str(record.get("new_rev", "unknown")))

    def _ingest_train(self, record: Mapping[str, object]) -> None:
        def num(key) -> Optional[float]:
            v = record.get(key)
            return float(v) if isinstance(v, (int, float)) \
                and not isinstance(v, bool) else None

        with self._lock:
            self._step = int(record.get("step", self._step) or self._step)
            self._intervals += 1
            if not record.get("skipped"):
                self._consecutive_skips = 0
            step_s = num("step_s")
            loss = num("loss")
            if loss is not None:
                self._loss_ema = self._ema(self._loss_ema, loss)
            ef, gn = num("ef_norm"), num("grad_norm")
            if ef is not None and gn is not None and gn > 0 \
                    and "wire_format" in record:
                # sparse intervals only (wire_format is the same marker
                # dense-arm attribution uses below): the dense warm-up
                # path never touches EF, so its ef_norm=0 is structural —
                # feeding it would drag the ratio EMA to 0 and trick the
                # density rule into halving density before the sparse
                # phase even starts
                ratio = ef / gn
                self._ef_ratio_ema = self._ema(self._ef_ratio_ema, ratio)
                self._ef_ratio_n += 1
                self._ratio_recent.append(ratio)
            ad = num("density_achieved")
            if ad is not None:
                self._achieved = ad
            bs = num("bytes_sent")
            if bs is not None:
                self._bytes = bs
            wf = record.get("wire_format")
            if isinstance(wf, str):
                self._wire = wf
            ov = record.get("overlap")
            if isinstance(ov, str):
                self._overlap = ov
            if step_s is None or step_s <= 0:
                return
            if self._settle_left > 0:
                # compile-polluted interval right after a program rebuild:
                # must not enter any steady-state EMA
                self._settle_left -= 1
                return
            self._step_ema = self._ema(self._step_ema, step_s)
            arm = (self.DENSE_ARM if "wire_format" not in record
                   and self._arm is not None else self._arm)
            if arm is not None:
                self._arm_ema[arm] = self._ema(self._arm_ema.get(arm),
                                               step_s)
                self._arm_n[arm] = self._arm_n.get(arm, 0) + 1

    # -- decision-side read ------------------------------------------------
    def snapshot(self) -> SignalSnapshot:
        with self._lock:
            trend = (self._ratio_recent[-1] - self._ratio_recent[0]
                     if len(self._ratio_recent) >= 2 else None)
            return SignalSnapshot(
                step=self._step,
                intervals=self._intervals,
                step_s_ema=self._step_ema,
                dense_step_s_ema=self._arm_ema.get(self.DENSE_ARM),
                ef_grad_ratio=self._ef_ratio_ema,
                ef_ratio_intervals=self._ef_ratio_n,
                ef_ratio_trend=trend,
                achieved_density=self._achieved,
                bytes_per_step=self._bytes,
                wire_format=self._wire,
                overlap=self._overlap,
                loss_ema=self._loss_ema,
                consecutive_skips=self._consecutive_skips,
                skips_since=dict(self._skips),
                last_rollback_step=self._last_rollback,
                arm_step_s=dict(self._arm_ema),
                arm_intervals=dict(self._arm_n),
                bench_regressions=self._bench_regressions,
                last_bench_regression=self._last_bench_regression,
                health_state=self._health_state,
                health_causes=self._health_causes,
            )
