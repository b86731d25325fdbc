"""Run health — rolling SLO windows with cause attribution (port of
``gaussiank_sgd_tpu/telemetry/health.py``).

The stream already says whether a run is healthy: the ``train`` records of
each log interval (step and io seconds, EF norm, achieved density, exposed
exchange), the resilience runtime's ``skip``/``rollback`` events, the
loader's ``io_retry`` events, ``policy_revert`` records, the sentinel's
``bench_regression`` verdicts, and the pod's ``worker_lost`` and
``bootstrap_retry`` records. :class:`HealthMonitor` rides the
:class:`~gaussiank_sgd_torch.telemetry.bus.EventBus` as an exporter, keeps
rolling windows over those signals, and at each log boundary builds one
``health_status`` record: ``ok`` / ``degraded`` / ``critical``, each
non-ok verdict naming its causes with the evidence inline.

Three surfaces, which agree verdict for verdict:

* **live HTTP**: :class:`HealthServer` (``--health-port``), a stdlib
  daemon thread serving ``/healthz`` (current and worst state as JSON;
  503 when critical) and ``/metrics`` (the Prometheus textfile when one
  is written);
* **offline CLI**: ``python -m gaussiank_sgd_torch.telemetry health
  run.jsonl`` replays a stream through :func:`replay_health` and exits
  0/1/2 by the worst state reached;
* **closed loop**: a critical verdict whose cause is in
  :data:`PRE_ARM_CAUSES` pre-arms the resilience monitor's rollback.

:meth:`HealthMonitor.emit` runs on the bus's delivery path: it stays cheap
and never publishes. The verdict pass (:meth:`HealthMonitor.tick`) runs on
the trainer's thread after each published ``train`` record and returns the
record; the trainer publishes it. With ``--health off`` (the default) no
monitor exists and the stream is unchanged. :func:`replay_health` ticks
once after every ``train`` record read back, the live cadence, so the live
endpoint, the CLI and the report give the same verdicts.

Pure stdlib (no torch): the telemetry CLI runs without it.
:func:`load_roofline_floor` lives in ``policy/rules.py``, as in the
reference, keyed on the port's platform; it is re-exported here.
"""

from __future__ import annotations

import json
import statistics
import threading
from collections import deque
from dataclasses import dataclass
from typing import Any, Deque, Dict, Iterable, List, Mapping, Optional, \
    Tuple

from ..policy.rules import load_roofline_floor  # noqa: F401 (re-exported)

# state codes double as CLI exit codes and the Prometheus gauge value
OK, DEGRADED, CRITICAL = 0, 1, 2
STATE_NAMES = {OK: "ok", DEGRADED: "degraded", CRITICAL: "critical"}

# attributed-cause vocabulary
CAUSE_DATA_WAIT = "data_wait"
CAUSE_EXPOSED_EXCHANGE = "exposed_exchange"
CAUSE_EF_PRESSURE = "ef_pressure"
CAUSE_DENSITY_DRIFT = "density_drift"
CAUSE_INSTABILITY = "instability"
CAUSE_STEP_TIME = "step_time_regression"
CAUSE_POLICY_THRASH = "policy_thrash"
CAUSE_BENCH_REGRESSION = "bench_regression"
# multi-process pod rig (training/launch.py): a worker process died
# (supervisor's worker_lost records), or coordinator bootstrap is
# retrying/exhausted (bootstrap_retry records)
CAUSE_WORKER_LOST = "worker_lost"
CAUSE_COORDINATOR_STALL = "coordinator_stall"
# elastic service: the supervisor is re-meshing the job —
# resize_begin in-window marks the geometry as in-transition (degraded);
# a resize_abort means the service failed to land its target width
CAUSE_RESIZE = "resize"

# critical verdicts for these causes pre-arm the resilience monitor's
# rollback (Trainer wiring). Deliberately narrow: instability's
# skip-budget / loss-spike detectors already arm rollback themselves,
# and a data stall or exposed exchange is a performance fault a rewind
# cannot fix — only unbounded EF growth threatens the trajectory itself
# before the loss detectors can see it.
PRE_ARM_CAUSES = (CAUSE_EF_PRESSURE,)

@dataclass(frozen=True)
class HealthPolicy:
    """Thresholds for the cause detectors. Every detector degrades
    gracefully when its signal is absent from the stream (no
    phase-timing probe -> no exposed-exchange verdict, dense warm-up ->
    no EF/density verdicts), so a partial stream yields verdicts about
    what it does carry instead of failing."""

    # rolling window, in logged train intervals
    window: int = 8
    # data_wait: fraction of interval wall-clock spent waiting on the
    # loader (io_s / (io_s + step_s)), or an io_retry burst in-window
    data_wait_degraded: float = 0.30
    data_wait_critical: float = 0.60
    io_retry_degraded: int = 2
    io_retry_critical: int = 6
    # exposed_exchange: window-median exposed exchange ms vs the
    # roofline floor when one is known, else vs the step time itself
    exposed_vs_floor_degraded: float = 3.0
    exposed_frac_degraded: float = 0.5
    # ef_pressure: EMA of ef_norm/grad_norm over sparse intervals —
    # degraded when high AND rising, critical when runaway
    ef_ratio_degraded: float = 10.0
    ef_ratio_critical: float = 100.0
    ef_ema_beta: float = 0.7
    # density_drift: achieved density off target by more than this
    # factor (either direction) for N consecutive sparse intervals
    density_drift_factor: float = 3.0
    density_drift_intervals: int = 3
    # instability: any guard-skip in-window degrades; a rollback (or a
    # skip streak at/over the streak threshold) is critical
    skip_degraded: int = 1
    skip_streak_critical: int = 3
    # step_time_regression: recent-window median step_s vs the median
    # of the preceding window
    step_regression_factor: float = 1.75
    # policy_thrash: probation reverts observed in-window
    policy_revert_degraded: int = 2
    # worker_lost: pod workers lost in-window (merged/supervisor
    # streams). ONE is already critical — the pod stalls until the
    # supervisor relaunches, and an unnoticed loss means the run's
    # remaining numbers came from a smaller mesh than claimed
    worker_lost_critical: int = 1
    # coordinator_stall: bootstrap_retry burst in-window degrades; a
    # retry that reached its budget (attempt >= max_retries) is critical
    bootstrap_retry_degraded: int = 2
    # resize: any resize_begin in-window marks the mesh in-transition
    # (degraded); this many resize_aborts is critical
    resize_abort_critical: int = 1


def _pct(sorted_vals: List[float], q: float) -> float:
    """Linear-interpolated percentile of an already-sorted list."""
    if len(sorted_vals) == 1:
        return sorted_vals[0]
    pos = (len(sorted_vals) - 1) * q
    lo = int(pos)
    hi = min(lo + 1, len(sorted_vals) - 1)
    return sorted_vals[lo] + (sorted_vals[hi] - sorted_vals[lo]) * (pos - lo)


def _num(record: Mapping[str, Any], key: str) -> Optional[float]:
    v = record.get(key)
    return float(v) if isinstance(v, (int, float)) \
        and not isinstance(v, bool) else None


class HealthMonitor:
    """See module docstring. Thread-safe: :meth:`emit` (ingest, bus
    lock held by the caller) and :meth:`tick`/:meth:`status` (trainer /
    HTTP threads) serialize on this object's own lock."""

    def __init__(self, policy: Optional[HealthPolicy] = None,
                 floor_ms: Optional[float] = None,
                 density_target: Optional[float] = None):
        self.policy = policy if policy is not None else HealthPolicy()
        self._floor_ms = floor_ms
        self._density_target = density_target
        self._lock = threading.Lock()
        w = self.policy.window
        # per-interval train window (2w so the regression detector has a
        # preceding window to compare the recent one against)
        self._train: Deque[Dict[str, Any]] = deque(maxlen=2 * w)
        # counts accumulated since the last tick, then binned into
        # per-interval deques at tick time (the stream has no step on
        # io_retry records, so interval binning is the honest clock)
        self._pending = {"io_retry": 0, "skip": 0, "rollback": 0,
                         "policy_revert": 0, "worker_lost": 0,
                         "bootstrap_retry": 0, "resize_begin": 0,
                         "resize_abort": 0}
        self._per_interval: Dict[str, Deque[int]] = {
            k: deque(maxlen=w) for k in self._pending}
        self._consecutive_skips = 0
        self._ef_ratio_ema: Optional[float] = None
        self._ef_recent: Deque[float] = deque(maxlen=4)
        self._quarantined = 0
        self._bootstrap_exhausted = False
        self._bench_regressions = 0
        self._last_bench_regression: Optional[str] = None
        # verdict / incident bookkeeping
        self._ticks = 0
        self._last_tick_step: Optional[int] = None
        self._last_record: Optional[Dict[str, Any]] = None
        self._worst = OK
        self._incidents: List[Dict[str, Any]] = []
        self._open_key: Optional[Tuple[int, Tuple[str, ...]]] = None
        self._critical: Tuple[str, ...] = ()
        self._state_steps: Dict[str, int] = {}
        self._cause_steps: Dict[str, int] = {}

    # -- exporter interface (runs under the bus lock; never publishes) --
    def emit(self, record: Mapping[str, Any]) -> None:
        event = record.get("event")
        if event == "train":
            self._ingest_train(record)
        elif event in ("skip", "io_retry", "rollback", "policy_revert",
                       "worker_lost", "bootstrap_retry", "resize_begin",
                       "resize_abort"):
            with self._lock:
                self._pending[event] += 1
                if event == "skip":
                    self._consecutive_skips += 1
                elif event == "rollback":
                    self._consecutive_skips = 0
                elif event == "policy_revert" \
                        and record.get("quarantined"):
                    self._quarantined += 1
                elif event == "bootstrap_retry":
                    # the retry carrying attempt == max_retries is the
                    # last one before the bootstrap gives up and raises
                    att = _num(record, "attempt")
                    mx = _num(record, "max_retries")
                    if att is not None and mx is not None and att >= mx:
                        self._bootstrap_exhausted = True
        elif event == "bench_regression":
            with self._lock:
                if record.get("status") == "regressed":
                    self._bench_regressions += 1
                    wc = record.get("worst_config")
                    if isinstance(wc, str):
                        self._last_bench_regression = wc
        elif event == "config":
            with self._lock:
                if self._density_target is None:
                    self._density_target = _num(record, "density")
        # health_status records (our own, fanned back by the bus) and
        # every other kind are ignored — no feedback loops

    def flush(self) -> None:
        return None

    def close(self) -> None:
        return None

    def _ingest_train(self, record: Mapping[str, Any]) -> None:
        p = self.policy
        with self._lock:
            if not record.get("skipped"):
                self._consecutive_skips = 0
            sparse = "wire_format" in record
            ef, gn = _num(record, "ef_norm"), _num(record, "grad_norm")
            if sparse and ef is not None and gn is not None and gn > 0:
                # sparse intervals only: dense warm-up leaves EF
                # untouched, so its structural ef_norm=0 would drag the
                # pressure gauge to 0
                ratio = ef / gn
                self._ef_ratio_ema = (
                    ratio if self._ef_ratio_ema is None
                    else p.ef_ema_beta * self._ef_ratio_ema
                    + (1.0 - p.ef_ema_beta) * ratio)
                self._ef_recent.append(ratio)
            self._train.append({
                "step": _num(record, "step"),
                "step_s": _num(record, "step_s"),
                "io_s": _num(record, "io_s"),
                "exposed_ms": _num(record, "exposed_exchange_ms"),
                "achieved": _num(record, "density_achieved"),
                "sparse": sparse,
            })

    # -- verdict pass (trainer thread / offline replay) -----------------
    def tick(self, step: int) -> Dict[str, Any]:
        """Evaluate the windows and return one ``health_status`` record
        (NOT published — the caller owns the publish site)."""
        p = self.policy
        with self._lock:
            for k, n in self._pending.items():
                self._per_interval[k].append(n)
                self._pending[k] = 0
            causes: Dict[str, Dict[str, Any]] = {}
            levels: Dict[str, int] = {}

            def flag(cause: str, level: int, **evidence: Any) -> None:
                levels[cause] = max(levels.get(cause, OK), level)
                causes.setdefault(cause, {}).update(evidence)

            win = [r for r in self._train][-p.window:]
            n = len(win)
            step_s = sorted(r["step_s"] for r in win
                            if r["step_s"] is not None)

            # data_wait: loader-bound intervals or an io_retry burst
            io_sum = sum(r["io_s"] for r in win if r["io_s"] is not None)
            st_sum = sum(s for s in step_s)
            frac = io_sum / (io_sum + st_sum) if io_sum + st_sum > 0 \
                else 0.0
            retries = sum(self._per_interval["io_retry"])
            if frac >= p.data_wait_critical \
                    or retries >= p.io_retry_critical:
                flag(CAUSE_DATA_WAIT, CRITICAL)
            elif frac >= p.data_wait_degraded \
                    or retries >= p.io_retry_degraded:
                flag(CAUSE_DATA_WAIT, DEGRADED)
            if CAUSE_DATA_WAIT in levels:
                flag(CAUSE_DATA_WAIT, levels[CAUSE_DATA_WAIT],
                     data_wait_frac=round(frac, 4), io_retries=retries,
                     intervals=n)

            # exposed_exchange: median exposed ms vs the roofline floor
            # (absolute budget) or, floorless, vs the step itself
            exposed = sorted(r["exposed_ms"] for r in win
                             if r["exposed_ms"] is not None)
            if exposed:
                med = statistics.median(exposed)
                if self._floor_ms is not None and self._floor_ms > 0:
                    if med > p.exposed_vs_floor_degraded * self._floor_ms:
                        flag(CAUSE_EXPOSED_EXCHANGE, DEGRADED,
                             exposed_ms_median=round(med, 3),
                             floor_ms=round(self._floor_ms, 3))
                elif step_s:
                    sfrac = med / max(statistics.median(step_s) * 1e3,
                                      1e-9)
                    if sfrac > p.exposed_frac_degraded:
                        flag(CAUSE_EXPOSED_EXCHANGE, DEGRADED,
                             exposed_ms_median=round(med, 3),
                             exposed_frac_of_step=round(sfrac, 4))

            # ef_pressure: high-and-rising, or runaway, EF/grad ratio
            ema = self._ef_ratio_ema
            trend = (self._ef_recent[-1] - self._ef_recent[0]
                     if len(self._ef_recent) >= 2 else None)
            if ema is not None:
                if ema >= p.ef_ratio_critical:
                    flag(CAUSE_EF_PRESSURE, CRITICAL,
                         ef_grad_ratio=round(ema, 4))
                elif ema >= p.ef_ratio_degraded and trend is not None \
                        and trend > 0:
                    flag(CAUSE_EF_PRESSURE, DEGRADED,
                         ef_grad_ratio=round(ema, 4),
                         ef_ratio_trend=round(trend, 4))

            # density_drift: achieved off target by > factor, sustained
            tgt = self._density_target
            if tgt is not None and tgt > 0:
                streak = 0
                for r in reversed(win):
                    if not r["sparse"] or r["achieved"] is None:
                        break
                    a = r["achieved"]
                    if a > p.density_drift_factor * tgt \
                            or a < tgt / p.density_drift_factor:
                        streak += 1
                    else:
                        break
                if streak >= p.density_drift_intervals:
                    flag(CAUSE_DENSITY_DRIFT, DEGRADED,
                         achieved=round(win[-1]["achieved"], 6),
                         target=tgt, drifted_intervals=streak)

            # instability: guard skips degrade; a rollback or a skip
            # streak is critical
            skips = sum(self._per_interval["skip"])
            rollbacks = sum(self._per_interval["rollback"])
            if rollbacks > 0 \
                    or self._consecutive_skips >= p.skip_streak_critical:
                flag(CAUSE_INSTABILITY, CRITICAL)
            elif skips >= p.skip_degraded:
                flag(CAUSE_INSTABILITY, DEGRADED)
            if CAUSE_INSTABILITY in levels:
                flag(CAUSE_INSTABILITY, levels[CAUSE_INSTABILITY],
                     skips=skips, rollbacks=rollbacks,
                     consecutive_skips=self._consecutive_skips)

            # step_time_regression: recent window vs the one before it
            older = sorted(r["step_s"] for r in
                           list(self._train)[:-p.window]
                           if r["step_s"] is not None)
            trend_ratio = None
            if len(older) >= 3 and len(step_s) >= 3:
                med_old = statistics.median(older)
                med_new = statistics.median(step_s)
                if med_old > 0:
                    trend_ratio = med_new / med_old
                    if trend_ratio > p.step_regression_factor:
                        flag(CAUSE_STEP_TIME, DEGRADED,
                             step_s_median_old=round(med_old, 6),
                             step_s_median_recent=round(med_new, 6))

            # policy_thrash: the engine keeps reverting its decisions
            reverts = sum(self._per_interval["policy_revert"])
            if reverts >= p.policy_revert_degraded:
                flag(CAUSE_POLICY_THRASH, DEGRADED, reverts=reverts,
                     quarantined=self._quarantined)

            # worker_lost: a pod worker died (supervisor stream). One is
            # already critical — the mesh is gone until relaunch
            lost = sum(self._per_interval["worker_lost"])
            if lost >= p.worker_lost_critical:
                flag(CAUSE_WORKER_LOST, CRITICAL, workers_lost=lost)

            # resize: elastic geometry changes in-window — a transition
            # is degraded (the mesh the numbers describe is changing
            # under them); an aborted resize is critical (the service
            # could not land its target width inside its budgets)
            begun = sum(self._per_interval["resize_begin"])
            aborted = sum(self._per_interval["resize_abort"])
            if aborted >= p.resize_abort_critical:
                flag(CAUSE_RESIZE, CRITICAL, resizes=begun,
                     resize_aborts=aborted)
            elif begun > 0:
                flag(CAUSE_RESIZE, DEGRADED, resizes=begun)

            # coordinator_stall: bootstrap retries burst (degraded) or
            # a worker burned its whole retry budget (critical)
            boots = sum(self._per_interval["bootstrap_retry"])
            if self._bootstrap_exhausted:
                flag(CAUSE_COORDINATOR_STALL, CRITICAL,
                     bootstrap_retries=boots, retries_exhausted=True)
            elif boots >= p.bootstrap_retry_degraded:
                flag(CAUSE_COORDINATOR_STALL, DEGRADED,
                     bootstrap_retries=boots)

            # bench_regression: the sentinel flagged this tree — a
            # standing caution for the rest of the run
            if self._bench_regressions > 0:
                flag(CAUSE_BENCH_REGRESSION, DEGRADED,
                     verdicts=self._bench_regressions,
                     worst_config=self._last_bench_regression or "?")

            state = max(levels.values(), default=OK)
            self._critical = tuple(sorted(c for c, lv in levels.items()
                                          if lv >= CRITICAL))
            active = sorted((c for c, lv in levels.items() if lv > OK),
                            key=lambda c: (-levels[c], c))
            rec: Dict[str, Any] = {
                "event": "health_status", "step": int(step),
                "state": STATE_NAMES[state], "state_code": state,
                "causes": active,
                "evidence": {c: causes[c] for c in active},
                "window_intervals": n,
            }
            if step_s:
                rec["step_s_p50"] = round(_pct(step_s, 0.50), 6)
                rec["step_s_p95"] = round(_pct(step_s, 0.95), 6)
                rec["step_s_p99"] = round(_pct(step_s, 0.99), 6)
            if trend_ratio is not None:
                rec["step_s_trend"] = round(trend_ratio, 4)
            if n:
                rec["data_wait_frac"] = round(frac, 4)
            self._account_locked(rec)
            return rec

    def _account_locked(self, rec: Dict[str, Any]) -> None:
        """Incident + time-in-state bookkeeping (lock held)."""
        step = rec["step"]
        state = rec["state_code"]
        causes = tuple(rec["causes"])
        delta = (step - self._last_tick_step
                 if self._last_tick_step is not None else 0)
        delta = max(delta, 0)
        name = rec["state"]
        self._state_steps[name] = self._state_steps.get(name, 0) + delta
        for c in causes:
            self._cause_steps[c] = self._cause_steps.get(c, 0) + delta
        key = (state, causes) if state > OK else None
        if key != self._open_key:
            self._open_key = key
            if key is not None:
                self._incidents.append({
                    "state": name, "causes": list(causes),
                    "start_step": step, "end_step": step})
        elif key is not None:
            self._incidents[-1]["end_step"] = step
        self._ticks += 1
        self._last_tick_step = step
        self._worst = max(self._worst, state)
        self._last_record = rec

    def critical_causes(self) -> Tuple[str, ...]:
        """The causes critical at the last tick (a verdict's ``causes``
        also lists the degraded ones). The trainer pre-arms on these: a
        cause's own level, unlike the verdict's state, does not mix in
        per-rank signals such as io time, so every rank decides alike."""
        with self._lock:
            return self._critical

    # -- read side (HTTP server / report / CLI) -------------------------
    def status(self) -> Dict[str, Any]:
        """Live JSON status: the latest verdict plus run-so-far rollups
        (what ``/healthz`` serves)."""
        with self._lock:
            last = self._last_record
            return {
                "state": last["state"] if last else "ok",
                "state_code": last["state_code"] if last else OK,
                "causes": list(last["causes"]) if last else [],
                "evidence": dict(last["evidence"]) if last else {},
                "step": last["step"] if last else None,
                "worst_state": STATE_NAMES[self._worst],
                "worst_state_code": self._worst,
                "verdicts": self._ticks,
                "incidents": [dict(i) for i in self._incidents],
            }

    def summary(self) -> Dict[str, Any]:
        """Run-level rollup for the report section / offline CLI."""
        with self._lock:
            return {
                "worst_state": STATE_NAMES[self._worst],
                "worst_state_code": self._worst,
                "verdicts": self._ticks,
                "last_state": (self._last_record["state"]
                               if self._last_record else "ok"),
                "incidents": [dict(i) for i in self._incidents],
                "state_steps": dict(self._state_steps),
                "cause_steps": dict(self._cause_steps),
            }


def replay_health(events: Iterable[Mapping[str, Any]],
                  policy: Optional[HealthPolicy] = None,
                  floor_ms: Optional[float] = None,
                  density_target: Optional[float] = None,
                  ) -> Tuple[List[Dict[str, Any]], HealthMonitor]:
    """Replay a recorded stream through a fresh monitor, ticking once
    after every ``train`` record — the live cadence — and return the
    verdicts plus the monitor (for :meth:`HealthMonitor.summary`).
    Recorded ``health_status`` lines are skipped so a live-monitored
    stream replays to the same verdicts it logged."""
    mon = HealthMonitor(policy=policy, floor_ms=floor_ms,
                        density_target=density_target)
    out: List[Dict[str, Any]] = []
    prev_step = 0
    for rec in events:
        if not isinstance(rec, Mapping):
            continue
        event = rec.get("event")
        if event == "health_status":
            continue
        mon.emit(rec)
        if event == "train":
            step = _num(rec, "step")
            prev_step = int(step) if step is not None else prev_step + 1
            out.append(mon.tick(prev_step))
        elif event in ("worker_lost", "resize_begin", "resize_abort"):
            # supervisor streams have no train cadence of their own, and
            # a killed pod may end right here — tick so the incident is
            # attributed even with no later train record to bin it.
            # No live/replay divergence: these kinds only exist in
            # supervisor/merged streams, which never had a live monitor
            out.append(mon.tick(prev_step))
    return out, mon


def format_health(summary: Mapping[str, Any]) -> str:
    """Human-readable rendering of :meth:`HealthMonitor.summary` (the
    ``telemetry health`` CLI's text output)."""
    lines = [
        f"worst state: {summary['worst_state']} "
        f"(last: {summary['last_state']}, "
        f"{summary['verdicts']} verdict(s))"]
    for cause, steps in sorted(summary.get("cause_steps", {}).items(),
                               key=lambda kv: (-kv[1], kv[0])):
        lines.append(f"  cause {cause:<22} active ~{steps} step(s)")
    incidents = summary.get("incidents", [])
    if incidents:
        lines.append(f"{len(incidents)} incident(s):")
        for i in incidents:
            lines.append(
                f"  steps {i['start_step']}-{i['end_step']}  "
                f"{i['state']:<9} {', '.join(i['causes'])}")
    else:
        lines.append("no incidents")
    return "\n".join(lines)


class HealthServer:
    """``--health-port`` stdlib HTTP surface: ``/healthz`` (live JSON
    status, 503 when critical) and ``/metrics`` (the Prometheus
    textfile's contents when one is configured, else a minimal
    health-only exposition). Runs on a daemon thread; ``port=0`` binds
    an ephemeral port (tests), readable via :attr:`port` after
    :meth:`start`.

    **Per-job routing** (for a multi-job scheduler):
    :meth:`add_job` registers a job id -> monitor mapping and the server
    additionally routes ``/healthz/<job>`` and ``/metrics/<job>`` to
    that job's monitor (404 for unknown ids). ``monitor=None`` runs the
    server in scheduler mode: the bare ``/healthz`` then aggregates the
    worst state across registered jobs (with every job's status inline)
    instead of serving a single run. Single-monitor construction is
    unchanged — existing ``--health-port`` behavior is byte-identical
    until the first ``add_job``.
    """

    def __init__(self, monitor: Optional[HealthMonitor] = None,
                 port: int = 0,
                 host: str = "127.0.0.1",
                 prom_path: Optional[str] = None):
        self.monitor = monitor
        self.host = host
        self.port = port
        self.prom_path = prom_path
        self._server = None
        self._thread: Optional[threading.Thread] = None
        self._lock = threading.Lock()
        self._jobs: Dict[str, HealthMonitor] = {}

    # -- per-job routing table (HTTP threads read, scheduler writes) ----
    def add_job(self, job: str, monitor: HealthMonitor) -> None:
        """Serve ``/healthz/<job>`` and ``/metrics/<job>`` from this
        monitor (replaces an existing registration of the same id)."""
        with self._lock:
            self._jobs[str(job)] = monitor

    def remove_job(self, job: str) -> None:
        with self._lock:
            self._jobs.pop(str(job), None)

    def _job_monitor(self, job: str) -> Optional[HealthMonitor]:
        with self._lock:
            return self._jobs.get(job)

    def _jobs_view(self) -> Dict[str, HealthMonitor]:
        with self._lock:
            return dict(self._jobs)

    def _root_status(self) -> Dict[str, Any]:
        """The bare ``/healthz`` body: the default monitor's status, or
        (scheduler mode) the worst-across-jobs aggregate."""
        if self.monitor is not None:
            return self.monitor.status()
        jobs = {name: mon.status()
                for name, mon in sorted(self._jobs_view().items())}
        worst = max((s["state_code"] for s in jobs.values()), default=OK)
        return {"state": STATE_NAMES[worst], "state_code": worst,
                "jobs": jobs}

    def start(self) -> "HealthServer":
        from http.server import BaseHTTPRequestHandler, \
            ThreadingHTTPServer
        server, prom_path = self, self.prom_path

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):  # noqa: A003
                return None     # health probes must not spam stderr

            def _send(self, code: int, body: bytes,
                      ctype: str) -> None:
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def _send_status(self, status: Dict[str, Any]) -> None:
                code = 503 if status["state_code"] >= CRITICAL else 200
                self._send(code,
                           json.dumps(status, default=float,
                                      indent=2).encode(),
                           "application/json")

            def do_GET(self):   # noqa: N802 (stdlib handler contract)
                path = self.path.split("?", 1)[0]
                if path in ("/", "/healthz"):
                    self._send_status(server._root_status())
                elif path.startswith("/healthz/"):
                    mon = server._job_monitor(path[len("/healthz/"):])
                    if mon is None:
                        self._send(404, b"unknown job\n", "text/plain")
                    else:
                        self._send_status(mon.status())
                elif path == "/metrics":
                    text = None
                    if prom_path:
                        try:
                            with open(prom_path, "r",
                                      encoding="utf-8") as fh:
                                text = fh.read()
                        except OSError:
                            text = None
                    if text is None:
                        lines = []
                        if server.monitor is not None:
                            s = server.monitor.status()
                            lines.append(f"health_state "
                                         f"{s['worst_state_code']}")
                        for name, mon in sorted(
                                server._jobs_view().items()):
                            s = mon.status()
                            lines.append(
                                f'health_state{{job="{name}"}} '
                                f"{s['worst_state_code']}")
                        text = ("\n".join(lines) + "\n") if lines \
                            else "health_state 0\n"
                    self._send(200, text.encode(),
                               "text/plain; version=0.0.4")
                elif path.startswith("/metrics/"):
                    mon = server._job_monitor(path[len("/metrics/"):])
                    if mon is None:
                        self._send(404, b"unknown job\n", "text/plain")
                    else:
                        s = mon.status()
                        self._send(200,
                                   f"health_state "
                                   f"{s['worst_state_code']}\n".encode(),
                                   "text/plain; version=0.0.4")
                else:
                    self._send(404, b"not found\n", "text/plain")

        self._server = ThreadingHTTPServer((self.host, self.port),
                                           Handler)
        self._server.daemon_threads = True
        self.port = self._server.server_address[1]
        self._thread = threading.Thread(
            target=self._server.serve_forever, name="health-http",
            daemon=True)
        self._thread.start()
        return self

    def close(self) -> None:
        if self._server is not None:
            self._server.shutdown()
            self._server.server_close()
            self._server = None
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
