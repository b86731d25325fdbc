"""Elastic supervisor — the resize engine over the pod launcher (port of
``gaussiank_sgd_tpu/service/supervisor.py``).

:class:`ElasticSupervisor` plugs the :class:`ResizePlanner`, the
:class:`ControlPlane` and a per-job :class:`HealthMonitor` into the base
:class:`~gaussiank_sgd_torch.training.launch.Supervisor`'s target-N
reconcile loop via its hooks.  A resize is one bracketed geometry
change::

    WATCH ──── directive accepted ───► resize_begin
      ▲                                    │
      │                               TEARDOWN (SIGTERM first: workers
      │                                    │    seal at a step boundary)
      │             steps_lost > budget? ──┤
      │      resize_abort(step_budget),    │ no
      │      relaunch at the OLD width     ▼
      │                               SPAWN at new N ── elastic restore
      │                                    │    (EF mass-preserving)
      │               armed in budget? ────┤
      │      resize_abort(wall_budget)     │ yes: every worker's first
      │      + revert to the old width     │       heartbeat on disk
      │                                    ▼
      └──────────────────────────── resize_commit

Directives come from four places — an operator command on the control
file, a scripted ``--resize-at`` schedule, clean worker exits while
peers run on (preemption drain), and the planner's reactions to
relaunch-budget pressure or sustained critical health verdicts.  All of
them funnel through :meth:`_direct`, which validates *before* teardown:
a refused directive emits ``resize_abort`` and training never notices.
Besides the reference's bounds and budget, a width the process-group
backend cannot form is refused there (NCCL puts one rank on a card:
``launch.Supervisor._backend_refusal``), so a grow past the cards never
tears a running pod down to fail at spawn.

The relaunched workers follow the new width through the launcher's spec:
``nprocs`` ranks, each with ``nworkers = nprocs``, so the global batch and
the learning rate's worker scaling follow it too, as in the reference.
"""

from __future__ import annotations

import logging
import os
import subprocess
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

from ..telemetry.health import HealthMonitor
from ..training import launch as launch_mod
from .control import ControlPlane
from .resize import ResizePlanner, ResizePolicy

log = logging.getLogger(__name__)


def _checkpoint_step(path: Optional[str]) -> int:
    """Step number encoded in a ``step_NNNNNNNN`` dir name (0 if none)."""
    if not path:
        return 0
    name = os.path.basename(path.rstrip("/"))
    if name.startswith("step_"):
        try:
            return int(name[len("step_"):])
        except ValueError:
            return 0
    return 0


class ElasticSupervisor(launch_mod.Supervisor):
    """Autoscaling supervisor for one training job.

    All state added here (``_inflight``, ``_schedule``, ``_drain_since``,
    the counters) is touched only from the reconcile thread — the sole
    cross-thread surface is the base class's lock-guarded
    ``request_resize``/``target_nprocs`` pair plus :meth:`stop`.
    """

    def __init__(self, cfg: Any, launch: launch_mod.LaunchConfig,
                 pod_dir: str, *,
                 policy: Optional[ResizePolicy] = None,
                 job: Optional[str] = None,
                 control_path: Optional[str] = None,
                 monitor: Optional[HealthMonitor] = None,
                 resize_schedule: Optional[Sequence[Tuple[int, int]]] = None):
        super().__init__(cfg, launch, pod_dir)
        self.job = str(job) if job else str(getattr(cfg, "run_id", "job"))
        self.policy = policy if policy is not None else ResizePolicy()
        self.planner = ResizePlanner(self.policy)
        self.control = ControlPlane(
            control_path or os.path.join(pod_dir, "control.json"))
        self.health = monitor if monitor is not None else HealthMonitor()
        self.bus.attach(self.health)
        #: accepted directives (== resize_begin events published).
        self.resizes = 0
        self.resizes_committed = 0
        self._schedule: List[Tuple[int, int]] = sorted(
            (int(s), int(n)) for s, n in (resize_schedule or []))
        self._inflight: Optional[Dict[str, Any]] = None
        self._drain_since: Optional[float] = None

    # -- directive intake ----------------------------------------------
    def _direct(self, nprocs: int, reason: str,
                spec: Dict[str, Any]) -> bool:
        """Validate a target width and enqueue it for the reconcile loop.

        Refusals (out of bounds, resize budget exhausted) publish
        ``resize_abort`` without any geometry change; a target equal to
        the current width is silently ignored (not an incident).
        """
        cur = self.target_nprocs
        n = self.planner.clamp(nprocs)
        if n is None:
            log.warning(
                "resize to %d (%s) refused: outside [%d, %d]",
                int(nprocs), reason, self.policy.min_nprocs,
                self.policy.max_nprocs)
            self.bus.publish({
                "event": "resize_abort", "job": self.job,
                "reason": f"bounds:{reason}",
                "from_nprocs": cur, "to_nprocs": int(nprocs),
                "generation": self.generation})
            self._tick_health(self._progress_step(spec))
            return False
        if n == cur:
            return False
        if self._refuse_backend(n, reason, self._progress_step(spec)):
            return False
        if self.resizes >= self.policy.max_resizes:
            log.warning(
                "resize to %d (%s) refused: resize budget exhausted (%d)",
                n, reason, self.policy.max_resizes)
            self.bus.publish({
                "event": "resize_abort", "job": self.job,
                "reason": f"resize_budget:{reason}",
                "from_nprocs": cur, "to_nprocs": n,
                "generation": self.generation})
            self._tick_health(self._progress_step(spec))
            return False
        progress = self._progress_step(spec)
        self.resizes += 1
        self._inflight = {"from": cur, "to": n, "reason": reason,
                          "t0": time.monotonic(), "begin_step": progress,
                          "committed": False}
        log.info("RESIZE %d -> %d (%s) at step ~%d", cur, n, reason,
                 progress)
        self.bus.publish({
            "event": "resize_begin", "job": self.job, "reason": reason,
            "from_nprocs": cur, "to_nprocs": n,
            "generation": self.generation, "step": progress,
            "step_budget": self.policy.step_budget,
            "wall_budget_s": self.policy.wall_budget_s})
        self._tick_health(progress)
        self.request_resize(n, reason)
        return True

    def _refuse_backend(self, n: int, reason: str, step: int) -> bool:
        """Publish ``resize_abort`` (``backend:<reason>``) and return True
        when the process-group backend cannot form ``n`` ranks."""
        refusal = self._backend_refusal(n)
        if refusal is None:
            return False
        log.warning("resize to %d (%s) refused: %s", n, reason, refusal)
        self.bus.publish({
            "event": "resize_abort", "job": self.job,
            "reason": f"backend:{reason}",
            "from_nprocs": self.target_nprocs, "to_nprocs": int(n),
            "generation": self.generation})
        self._tick_health(step)
        return True

    def _tick_health(self, step: int,
                     spec: Optional[Dict[str, Any]] = None) -> None:
        """Tick the per-job monitor and publish the verdict.

        Only the loss path passes ``spec``, which arms the planner's
        sustained-critical reaction; commit/abort ticks leave it None so
        a verdict raised *by* a resize cannot recursively direct one.
        """
        rec = self.health.tick(int(step))
        self.bus.publish(rec)
        if spec is not None:
            d = self.planner.on_verdict(rec, self.target_nprocs)
            if d is not None:
                self._direct(d.nprocs, d.reason, spec)

    # -- hook: every watch poll ----------------------------------------
    def _poll_tick(self, procs: Sequence[subprocess.Popen],
                   spec: Dict[str, Any]) -> None:
        if self._resize_pending():
            return
        if self._schedule:
            progress = self._progress_step(spec)
            while self._schedule and progress >= self._schedule[0][0]:
                at, n = self._schedule.pop(0)
                self._direct(n, f"schedule@{at}", spec)
                if self._resize_pending():
                    return
        for cmd in self.control.poll():
            kind = cmd.get("cmd")
            if kind == "stop":
                self.stop()
            elif kind == "resize":
                self._direct(int(cmd.get("nprocs", 0)), "operator", spec)
            else:
                log.warning("unknown control command %r", kind)
        if self._resize_pending():
            return
        self._check_drain(procs, spec)

    def _check_drain(self, procs: Sequence[subprocess.Popen],
                     spec: Dict[str, Any]) -> None:
        """Clean exits with peers still live = preemption drain.

        A preempted worker seals and exits 0 while its peers block in
        the next collective; after ``drain_grace_s`` (so normal
        staggered completion doesn't trip it) shrink to the survivors.
        """
        rcs = [p.poll() for p in procs]
        drained = sum(1 for rc in rcs if rc == 0)
        live = sum(1 for rc in rcs if rc is None)
        if drained == 0 or live == 0:
            self._drain_since = None
            return
        now = time.monotonic()
        if self._drain_since is None:
            self._drain_since = now
            return
        if now - self._drain_since < self.policy.drain_grace_s:
            return
        self._drain_since = None
        d = self.planner.on_drain(live, self.target_nprocs)
        if d is not None:
            self._direct(d.nprocs, d.reason, spec)

    # -- hook: after worker_lost is published --------------------------
    def _on_worker_lost(self, lost: List[Dict[str, Any]],
                        spec: Dict[str, Any]) -> None:
        self._tick_health(self._progress_step(spec), spec)
        if self._resize_pending():
            return  # verdict-driven shrink already queued
        # relaunches not yet charged for this loss; how many remain
        # after it is charged:
        left = self.launch.max_relaunches - self.relaunches - 1
        d = self.planner.on_loss(self.target_nprocs, left)
        if d is not None:
            self._direct(d.nprocs, d.reason, spec)

    # -- hook: commit the directive after teardown ---------------------
    def _apply_resize(self, directive: Tuple[int, str],
                      progress_step: int) -> bool:
        n, reason = directive
        fl = self._inflight
        if fl is None:
            # enqueued through the base request_resize directly (the
            # scheduler's pool grant, or a wall-budget revert): adopt it
            # with fresh bookkeeping so commit/abort still brackets it
            clamped = self.planner.clamp(n)
            if clamped is None:
                self.bus.publish({
                    "event": "resize_abort", "job": self.job,
                    "reason": f"bounds:{reason}",
                    "from_nprocs": self.target_nprocs, "to_nprocs": int(n),
                    "generation": self.generation})
                self._tick_health(progress_step)
                return False
            n = clamped
            if n != self.target_nprocs and self._refuse_backend(
                    n, reason, progress_step):
                return False
            fl = {"from": self.target_nprocs, "to": n, "reason": reason,
                  "t0": time.monotonic(), "begin_step": progress_step,
                  "committed": False}
            self._inflight = fl
            self.resizes += 1
            self.bus.publish({
                "event": "resize_begin", "job": self.job, "reason": reason,
                "from_nprocs": fl["from"], "to_nprocs": n,
                "generation": self.generation, "step": progress_step,
                "step_budget": self.policy.step_budget,
                "wall_budget_s": self.policy.wall_budget_s})
        sealed = launch_mod.has_sealed_checkpoint(self.ckpt_dir)
        steps_lost = max(0, int(progress_step) - _checkpoint_step(sealed))
        fl["checkpoint"] = sealed or ""
        fl["steps_lost"] = steps_lost
        if steps_lost > self.policy.step_budget:
            dur = time.monotonic() - fl["t0"]
            self._inflight = None
            log.warning(
                "RESIZE abort (step_budget): %d -> %d would lose %d "
                "step(s), budget %d", fl["from"], fl["to"], steps_lost,
                self.policy.step_budget)
            self.bus.publish({
                "event": "resize_abort", "job": self.job,
                "reason": "step_budget",
                "from_nprocs": fl["from"], "to_nprocs": fl["to"],
                "generation": self.generation,
                "steps_lost": steps_lost, "duration_s": round(dur, 3)})
            self._tick_health(progress_step)
            return False
        fl["committed"] = True
        self._commit_target(n)
        return True

    # -- hook: arm the new generation ----------------------------------
    def _post_spawn(self, procs: Sequence[subprocess.Popen],
                    spec: Dict[str, Any]) -> None:
        """Hold the commit until every new worker heartbeats.

        The first heartbeat lands after trainer construction, i.e. after
        the elastic restore succeeded — so "all heartbeat files present"
        is the arm signal.  Overrunning ``wall_budget_s`` aborts and
        reverts to the old width; a worker dying during arming aborts
        and falls through to the watch loop's loss path (its relaunch
        budget bounds repeated failures at the new width).
        """
        fl = self._inflight
        if fl is None or not fl.get("committed"):
            return
        self._drain_since = None
        deadline = fl["t0"] + self.policy.wall_budget_s
        abort_reason = None
        while True:
            if self._shutdown.is_set():
                self._inflight = None
                return  # run loop handles the shutdown
            if any(rc is not None and rc != 0
                   for rc in (p.poll() for p in procs)):
                abort_reason = "arm_failed"
                break
            beats = [launch_mod.read_heartbeat(h)
                     for h in spec["heartbeats"]]
            if all(b is not None for b in beats):
                dur = time.monotonic() - fl["t0"]
                self._inflight = None
                self.resizes_committed += 1
                log.info(
                    "RESIZE commit: %d -> %d in %.2fs (steps lost: %d)",
                    fl["from"], fl["to"], dur, fl.get("steps_lost", 0))
                self.bus.publish({
                    "event": "resize_commit", "job": self.job,
                    "from_nprocs": fl["from"], "to_nprocs": fl["to"],
                    "generation": self.generation,
                    "checkpoint": str(fl.get("checkpoint", "")),
                    "duration_s": round(dur, 3),
                    "steps_lost": int(fl.get("steps_lost", 0)),
                    "reason": fl["reason"]})
                self._tick_health(int(fl.get("begin_step", 0)))
                return
            if time.monotonic() >= deadline:
                abort_reason = "wall_budget"
                break
            time.sleep(self.launch.poll_s)
        dur = time.monotonic() - fl["t0"]
        self._inflight = None
        log.warning("RESIZE abort (%s): %d -> %d after %.2fs",
                    abort_reason, fl["from"], fl["to"], dur)
        self.bus.publish({
            "event": "resize_abort", "job": self.job,
            "reason": abort_reason,
            "from_nprocs": fl["from"], "to_nprocs": fl["to"],
            "generation": self.generation, "duration_s": round(dur, 3)})
        self._tick_health(int(fl.get("begin_step", 0)))
        if abort_reason == "wall_budget" and fl["to"] != fl["from"]:
            # reconcile back; guarded so a revert that itself overruns
            # cannot ping-pong (to == from on the second pass)
            self.request_resize(fl["from"], "revert")
