"""Resize policy and planning — the pure-logic half of the resize engine
(port of ``gaussiank_sgd_tpu/service/resize.py``).

The planner turns observed signals (clean worker exits, relaunch-budget
pressure, sustained critical health verdicts, operator commands) into
:class:`ResizeDirective` values.  It never touches processes, clocks, or
the event bus — :class:`~gaussiank_sgd_torch.service.supervisor.\
ElasticSupervisor` owns all of that — which keeps every decision rule
unit-testable with plain numbers.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping, Optional, Tuple

from ..telemetry.health import CRITICAL


@dataclasses.dataclass(frozen=True)
class ResizePolicy:
    """Bounds and budgets for geometry changes.

    ``step_budget`` caps how much merged progress a single resize may
    discard (progress step minus the sealed-checkpoint step at teardown
    time); ``wall_budget_s`` caps checkpoint -> teardown -> re-mesh ->
    first heartbeat wall clock.  A resize that would blow either budget
    aborts instead of committing.
    """

    min_nprocs: int = 1
    max_nprocs: int = 64
    #: max merged steps a resize may lose to the rollback to the sealed
    #: checkpoint before it is aborted.
    step_budget: int = 50
    #: max seconds from accepted directive to every new worker's first
    #: heartbeat.
    wall_budget_s: float = 600.0
    #: lifetime cap on accepted directives per job.
    max_resizes: int = 16
    #: how long a clean worker exit must persist (with peers still live)
    #: before it is treated as a preemption drain rather than normal
    #: staggered completion.
    drain_grace_s: float = 3.0
    #: shrink proactively once this few relaunches remain in the budget
    #: (0 = only when the relaunch being charged is the last one).
    pressure_relaunches_left: int = 0
    #: consecutive critical health verdicts (worker_lost /
    #: coordinator_stall causes) before the planner sheds a worker.
    sustained_critical: int = 2
    #: health causes that count toward ``sustained_critical``.
    signal_causes: Tuple[str, ...] = ("worker_lost", "coordinator_stall")


@dataclasses.dataclass(frozen=True)
class ResizeDirective:
    """A validated target geometry plus the reason it was chosen."""

    nprocs: int
    reason: str


class ResizePlanner:
    """Signals in, directives out.

    Stateful only for the critical-verdict streak; everything else is a
    pure function of its arguments.
    """

    def __init__(self, policy: ResizePolicy):
        self.policy = policy
        self._critical_streak = 0

    def clamp(self, nprocs: int) -> Optional[int]:
        """``nprocs`` when inside ``[min_nprocs, max_nprocs]``, else None.

        Out-of-bounds explicit targets are refused rather than silently
        adjusted — an operator asking for 128 workers on a 4-worker
        policy should see a ``resize_abort``, not a quiet re-mesh to 4.
        """
        p = self.policy
        n = int(nprocs)
        if n < p.min_nprocs or n > p.max_nprocs:
            return None
        return n

    def on_drain(self, live: int, current: int) -> Optional[ResizeDirective]:
        """Workers exited cleanly while peers run on: preemption drain.

        A SIGTERM'd (preempted) worker seals its shard and exits 0; its
        peers block in the next collective.  Shrinking to the surviving
        width un-wedges them.
        """
        if live >= current:
            return None
        return ResizeDirective(max(int(live), self.policy.min_nprocs),
                               "preemption")

    def on_loss(self, current: int,
                relaunches_left: int) -> Optional[ResizeDirective]:
        """Relaunch-budget pressure: trade width for stability.

        When the budget is nearly burned, the same-width relaunch loop
        is evidently not converging — shed one worker so the next
        generation runs a different (smaller) geometry instead of
        spending the final relaunch on a fourth identical attempt.
        """
        p = self.policy
        if relaunches_left > p.pressure_relaunches_left:
            return None
        if current <= p.min_nprocs:
            return None
        return ResizeDirective(max(current - 1, p.min_nprocs),
                               "relaunch_pressure")

    def on_verdict(self, record: Mapping[str, Any],
                   current: int) -> Optional[ResizeDirective]:
        """Sustained critical worker_lost / coordinator_stall verdicts.

        One critical tick is an incident; ``sustained_critical`` in a
        row is a pattern, and the planner responds by shedding a worker.
        The streak resets after firing so the next shrink needs fresh
        evidence at the new width.
        """
        p = self.policy
        causes = record.get("causes") or ()
        critical = (int(record.get("state_code", 0)) >= CRITICAL
                    and any(c in p.signal_causes for c in causes))
        self._critical_streak = self._critical_streak + 1 if critical else 0
        if self._critical_streak < p.sustained_critical:
            return None
        self._critical_streak = 0
        if current <= p.min_nprocs:
            return None
        return ResizeDirective(max(current - 1, p.min_nprocs),
                               "health_critical")
