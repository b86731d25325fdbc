"""PolicyEngine — the closed loop from event bus to knob retuning (port of
``gaussiank_sgd_tpu/policy/engine.py``).

Wiring:

* The engine attaches to the trainer's EventBus as an exporter; its
  :meth:`emit` only feeds :class:`~.signals.PolicySignals` (cheap, under
  the bus lock, never publishes back — publishing from ``emit`` would
  deadlock on the bus lock).
* At every log interval — the boundary where a rebuild is safe — the
  Trainer calls
  :meth:`check_revert` first, then (if nothing reverted and no rollback
  is pending) :meth:`decide`. (A "recompile" here, as in the reference's
  record fields, is one rebuild of the trainer's step.) Whatever comes back is applied through the
  trainer's step rebuild, after which the Trainer calls
  :meth:`note_applied` / :meth:`note_reverted`; those run on the trainer
  thread and are the only places the engine publishes
  ``policy_decision`` / ``policy_revert`` events.

Stability machinery:

* **Hysteresis** — a proposal must repeat on ``hysteresis`` consecutive
  ``decide()`` calls before it is released, so a signal oscillating
  around a rule threshold cannot flap the program.
* **Cooldown** — after any apply/revert the engine stays silent for
  ``cooldown`` boundaries (on top of the signal settle period).
* **Decision budget** — apply + revert recompiles are capped at
  ``budget`` for the whole run; recompiles stay bounded no matter what
  the signals do.
* **Probation + quarantine** — every applied decision is on probation
  for ``probation`` boundaries: a loss-EMA spike vs. the pre-decision
  baseline, a skip burst, or a resilience rollback lands the revert
  twin, and the (knob, value) pair is quarantined for the rest of the
  run. The resilience monitor stays the outer safety net: the Trainer
  reverts policy knobs BEFORE executing a monitor rollback so the
  restored checkpoint meets the program layout it was saved under.
"""

from __future__ import annotations

import logging
from typing import Callable, Dict, List, Mapping, Optional, Sequence, Set, \
    Tuple

from .rules import KNOB_COMPRESSOR, PolicyDecision, Rule, RuleContext
from .signals import PolicySignals, SignalSnapshot

logger = logging.getLogger(__name__)

PublishFn = Callable[[str, Dict[str, object]], object]


class _Probation:
    """One applied decision under watch."""

    def __init__(self, decision: PolicyDecision, snap: SignalSnapshot):
        self.decision = decision
        self.applied_step = snap.step
        self.applied_intervals = snap.intervals
        self.baseline_loss_ema = snap.loss_ema


class PolicyEngine:
    """See module docstring. All decide/check/note methods run on the
    trainer thread; :meth:`emit` runs on whatever thread publishes to the
    bus (under the bus lock) and touches only the signal accumulator."""

    def __init__(self, rules: Sequence[Rule],
                 signals: Optional[PolicySignals] = None,
                 publish: Optional[PublishFn] = None,
                 knobs: Optional[Mapping[str, str]] = None,
                 floor_ms: Optional[float] = None,
                 hysteresis: int = 2, cooldown: int = 2, budget: int = 8,
                 probation: int = 3, loss_spike_factor: float = 1.5,
                 skip_burst: int = 3):
        if hysteresis < 1:
            raise ValueError(f"hysteresis must be >= 1, got {hysteresis}")
        self.rules = list(rules)
        self.signals = signals if signals is not None else PolicySignals()
        self._publish = publish
        self._knobs: Dict[str, str] = dict(knobs or {})
        self._floor_ms = floor_ms
        self._hysteresis = int(hysteresis)
        self._cooldown = max(0, int(cooldown))
        self._budget = max(0, int(budget))
        self._probation_len = max(1, int(probation))
        self._loss_spike_factor = float(loss_spike_factor)
        self._skip_burst = int(skip_burst)

        self._streak: Dict[Tuple[str, str], int] = {}
        self._streak_decision: Dict[Tuple[str, str], PolicyDecision] = {}
        self._cooldown_left = 0
        self._probation: Optional[_Probation] = None
        self._quarantine: Set[Tuple[str, str]] = set()
        self.decision_log: List[Dict[str, object]] = []
        self._recompiles = 0

        if KNOB_COMPRESSOR in self._knobs:
            self.signals.bind_arm(self._knobs[KNOB_COMPRESSOR])

    # -- exporter interface (runs under the bus lock; never publishes) ----
    def emit(self, record: Mapping[str, object]) -> None:
        self.signals.update(record)

    def close(self) -> None:
        """Exporter interface; nothing to flush."""

    # -- state the trainer / A-B harness reads ----------------------------
    @property
    def knobs(self) -> Dict[str, str]:
        return dict(self._knobs)

    @property
    def recompiles(self) -> int:
        """Program rebuilds this engine has caused (applies + reverts)."""
        return self._recompiles

    @property
    def budget_left(self) -> int:
        return max(0, self._budget - self._recompiles)

    @property
    def on_probation(self) -> bool:
        return self._probation is not None

    @property
    def quarantine(self) -> Set[Tuple[str, str]]:
        return set(self._quarantine)

    def _context(self) -> RuleContext:
        return RuleContext(knobs=dict(self._knobs),
                           quarantine=frozenset(self._quarantine),
                           roofline_floor_ms=self._floor_ms)

    # -- decision pass (trainer thread, at the recompile-safe boundary) ---
    def decide(self, rollback_pending: bool = False) \
            -> Optional[PolicyDecision]:
        """One boundary tick: run the rules over a fresh snapshot and
        return a decision once it has survived hysteresis — or None.
        While a rollback is pending, on cooldown, on probation, or out of
        budget, this is a guaranteed no-op (streaks hold, nothing fires).
        """
        if rollback_pending or self._probation is not None:
            return None
        if self._cooldown_left > 0:
            self._cooldown_left -= 1
            return None
        if self._recompiles >= self._budget:
            return None

        snap = self.signals.snapshot()
        if snap.health_state > 0:
            # the run-health monitor attributes a live degradation
            # (telemetry/health.py): exploring now would retune against
            # conditions that won't persist AND muddy the monitor's
            # cause attribution — hold until the run is ok again.
            # check_revert is untouched by this gate: probation reverts
            # are protective, not exploratory
            return None
        ctx = self._context()
        proposed: Dict[Tuple[str, str], PolicyDecision] = {}
        for rule in self.rules:
            try:
                d = rule.propose(snap, ctx)
            except Exception:
                logger.exception("policy rule %s failed; skipping",
                                 getattr(rule, "name", rule))
                continue
            if d is not None and d.key not in proposed \
                    and not ctx.banned(*d.key):
                proposed[d.key] = d

        # hysteresis: streaks grow only for keys proposed THIS tick;
        # anything not re-proposed resets (the signal wobbled away)
        self._streak = {k: self._streak.get(k, 0) + 1 for k in proposed}
        self._streak_decision = proposed
        for key, n in self._streak.items():
            if n >= self._hysteresis:
                return self._streak_decision[key]
        return None

    def note_applied(self, decision: PolicyDecision) -> None:
        """The Trainer applied ``decision`` and rebuilt its programs.
        Publishes the ``policy_decision`` event, starts probation, and
        rebinds the timing arm."""
        snap = self.signals.snapshot()
        self._knobs[decision.knob] = decision.new
        self._recompiles += 1
        self._cooldown_left = self._cooldown
        self._streak.clear()
        self._streak_decision.clear()
        self._probation = _Probation(decision, snap)
        if decision.knob == KNOB_COMPRESSOR:
            self.signals.bind_arm(decision.new)
        else:
            # a density/bucket-plan change alters the program layout, so
            # every arm's steady-state record measured under the old
            # layout is no longer comparable — drop them (the dense
            # reference survives; these knobs don't touch the dense step)
            self.signals.reset_arm_records()
            # any program rebuild invalidates in-flight timings
            self.signals.bind_arm(self._knobs.get(KNOB_COMPRESSOR))
        self._log(decision, "policy_decision", None)

    def check_revert(self, rollback_pending: bool = False) \
            -> Optional[PolicyDecision]:
        """Probation watchdog: if the decision under probation precedes a
        loss spike, a skip burst, or a resilience rollback (or a rollback
        is pending right now), return its revert twin for the Trainer to
        apply FIRST — before any checkpoint restore — so the restored
        state meets the pre-decision program layout. Otherwise, clear
        probation once the window passes clean."""
        p = self._probation
        if p is None:
            return None
        snap = self.signals.snapshot()
        reason = None
        if rollback_pending:
            reason = "resilience rollback pending after decision"
        elif snap.last_rollback_step is not None \
                and snap.last_rollback_step >= p.applied_step:
            reason = "resilience rollback followed decision"
        elif snap.skips_after(p.applied_step) >= self._skip_burst:
            reason = (f"skip burst: {snap.skips_after(p.applied_step)} "
                      f"guard-skipped steps since apply")
        elif p.baseline_loss_ema is not None and snap.loss_ema is not None \
                and snap.loss_ema > self._loss_spike_factor \
                * p.baseline_loss_ema:
            reason = (f"loss EMA {snap.loss_ema:.4g} > "
                      f"{self._loss_spike_factor}x pre-decision baseline "
                      f"{p.baseline_loss_ema:.4g}")
        if reason is not None:
            return p.decision.reversed(step=snap.step, reason=reason)
        if snap.intervals - p.applied_intervals >= self._probation_len:
            self._probation = None          # survived probation: confirmed
        return None

    def note_reverted(self, revert: PolicyDecision, quarantined: bool = True) \
            -> None:
        """The Trainer applied the revert twin. Publishes ``policy_revert``
        and quarantines the reverted (knob, value) for the rest of the
        run."""
        p = self._probation
        self._probation = None
        self._knobs[revert.knob] = revert.new
        self._recompiles += 1
        self._cooldown_left = self._cooldown
        self._streak.clear()
        self._streak_decision.clear()
        if quarantined and p is not None:
            self._quarantine.add(p.decision.key)
        elif quarantined:
            self._quarantine.add((revert.knob, revert.old))
        if revert.knob == KNOB_COMPRESSOR:
            self.signals.bind_arm(revert.new)
        else:
            # same layout-change invalidation as note_applied
            self.signals.reset_arm_records()
            self.signals.bind_arm(self._knobs.get(KNOB_COMPRESSOR))
        self._log(revert, "policy_revert", quarantined)

    # -- internals --------------------------------------------------------
    def _log(self, decision: PolicyDecision, event: str,
             quarantined: Optional[bool]) -> None:
        payload: Dict[str, object] = {
            "step": decision.step, "rule": decision.rule,
            "knob": decision.knob, "old": decision.old,
            "new": decision.new, "reason": decision.reason,
            "recompiles": self._recompiles,
            "budget_left": self.budget_left,
        }
        if quarantined is not None:
            payload["quarantined"] = bool(quarantined)
        self.decision_log.append(dict(payload, event=event))
        logger.info("%s %s: %s -> %s (%s)", event, decision.knob,
                    decision.old, decision.new, decision.reason)
        if self._publish is not None:
            self._publish(event, payload)
