"""Multi-job scheduler — several TrainConfigs over one device pool (port
of ``gaussiank_sgd_tpu/service/scheduler.py``).

Each admitted job gets its own :class:`ElasticSupervisor` on a worker
thread (signal installation already skips non-main threads), its own pod
directory, relaunch/resize budgets, and a per-job
:class:`~gaussiank_sgd_torch.telemetry.health.HealthMonitor` routed on one
shared :class:`~gaussiank_sgd_torch.telemetry.health.HealthServer`
(``/healthz/<job>``, ``/metrics/<job>``).  The scheduler publishes its
own strict-validated stream (``scheduler.jsonl``): ``job_admit`` when a
job is granted devices and ``job_done`` when its supervisor returns.

Device accounting is slot-based (one single-device process per slot) —
the same simplification the launcher itself makes — so "fair device
assignment on resize" reduces to :meth:`DevicePool.request`'s rule:
shrinks are always granted; growth is granted only from slots left after
every *other* job could still reach its fair share (capacity divided by
active jobs).
"""

from __future__ import annotations

import dataclasses
import os
import threading
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

from ..telemetry import EventBus, JSONLExporter
from ..telemetry.health import HealthMonitor, HealthServer
from ..training.launch import LaunchConfig
from .resize import ResizePolicy
from .supervisor import ElasticSupervisor


class DevicePool:
    """Thread-safe slot accounting with a fair-share growth rule."""

    def __init__(self, capacity: int):
        if int(capacity) < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = int(capacity)
        self._lock = threading.Lock()
        self._alloc: Dict[str, int] = {}

    @property
    def free(self) -> int:
        with self._lock:
            return self.capacity - sum(self._alloc.values())

    def allocation(self, job: str) -> int:
        with self._lock:
            return self._alloc.get(job, 0)

    def admit(self, job: str, want: int) -> int:
        """Admission grant: ``min(want, free)``; 0 when nothing is free."""
        with self._lock:
            free = self.capacity - sum(self._alloc.values())
            granted = max(0, min(int(want), free))
            if granted:
                self._alloc[job] = granted
            return granted

    def request(self, job: str, want: int) -> int:
        """Resize grant for an already-admitted job.

        Shrinks are always granted.  Growth is work-conserving but
        fair: beyond its current width a job only receives slots left
        over after reserving, for every other job, the gap between that
        job's allocation and the fair share (``capacity // jobs``) — so
        one greedy job cannot absorb slots a recovering peer will need.
        """
        with self._lock:
            if job not in self._alloc:
                raise KeyError(f"unknown job {job!r}")
            cur = self._alloc[job]
            want = max(0, int(want))
            if want <= cur:
                self._alloc[job] = want
                return want
            free = self.capacity - sum(self._alloc.values())
            fair = self.capacity // max(1, len(self._alloc))
            reserve = sum(max(0, fair - alloc)
                          for j, alloc in self._alloc.items() if j != job)
            granted = min(want, cur + max(0, free - reserve))
            self._alloc[job] = granted
            return granted

    def release(self, job: str) -> int:
        with self._lock:
            return self._alloc.pop(job, 0)


class ServiceJob:
    """Handle for one admitted job.

    The job thread writes ``exit_code``/``error`` and then sets ``done``
    — callers read them only after ``done.wait()``, so no lock is
    needed (write-once, release via the Event).
    """

    def __init__(self, name: str, supervisor: ElasticSupervisor):
        self.name = name
        self.supervisor = supervisor
        self.thread: Optional[threading.Thread] = None
        self.done = threading.Event()
        self.exit_code: Optional[int] = None
        self.error: Optional[str] = None
        self.outcome: Optional[str] = None


class JobScheduler:
    """Admit, resize, and drain elastic training jobs on one host."""

    def __init__(self, devices: int, root_dir: str, *,
                 health_port: Optional[int] = None):
        self.pool = DevicePool(devices)
        self.root_dir = str(root_dir)
        os.makedirs(self.root_dir, exist_ok=True)
        self.bus = EventBus(
            [JSONLExporter(os.path.join(self.root_dir, "scheduler.jsonl"))],
            validate=True)
        self.bus.add_stamp(lambda: {"process_index": -1})
        self.server: Optional[HealthServer] = None
        if health_port is not None:
            self.server = HealthServer(None, port=health_port).start()
        self._lock = threading.Lock()
        self._jobs: Dict[str, ServiceJob] = {}

    def submit(self, name: str, cfg: Any, launch: LaunchConfig, *,
               policy: Optional[ResizePolicy] = None,
               resize_schedule: Optional[Sequence[Tuple[int, int]]] = None,
               ) -> ServiceJob:
        """Admit ``cfg`` at up to ``launch.nprocs`` workers and start it.

        Raises RuntimeError when the pool cannot grant even the job's
        ``min_nprocs`` — admission is all-or-nothing at the floor, never
        a zombie job holding zero devices.
        """
        policy = policy if policy is not None else ResizePolicy()
        with self._lock:
            known = name in self._jobs
        if known:
            raise ValueError(f"job {name!r} already submitted")
        granted = self.pool.admit(name, launch.nprocs)
        if granted < max(1, policy.min_nprocs):
            self.pool.release(name)
            raise RuntimeError(
                f"job {name!r} not admitted: needs >= {policy.min_nprocs} "
                f"device(s), pool has {self.pool.free} free "
                f"of {self.pool.capacity}")
        monitor = HealthMonitor()
        sup = ElasticSupervisor(
            cfg, dataclasses.replace(launch, nprocs=granted),
            os.path.join(self.root_dir, name),
            policy=policy, job=name, monitor=monitor,
            resize_schedule=resize_schedule)
        self.bus.publish({"event": "job_admit", "job": name,
                          "nprocs": granted, "devices_free": self.pool.free})
        if self.server is not None:
            self.server.add_job(name, monitor)
        job = ServiceJob(name, sup)
        thread = threading.Thread(target=self._run_job, args=(job,),
                                  name=f"gksgd-job-{name}", daemon=True)
        job.thread = thread
        with self._lock:
            self._jobs[name] = job
        thread.start()
        return job

    def _run_job(self, job: ServiceJob) -> None:
        rc = -1
        outcome = "error"
        try:
            rc = job.supervisor.run()
            outcome = ("ok" if rc == 0
                       else "shutdown" if rc == 143 else "exit")
        except Exception as exc:  # job failure is a result, not a crash
            job.error = f"{type(exc).__name__}: {exc}"
        finally:
            job.exit_code = rc
            job.outcome = outcome
            self.pool.release(job.name)
            self.bus.publish({
                "event": "job_done", "job": job.name, "outcome": outcome,
                "exit_code": int(rc),
                "generations": int(job.supervisor.generation),
                "resizes": int(job.supervisor.resizes)})
            job.done.set()

    def resize(self, name: str, nprocs: int) -> int:
        """Operator resize routed through the pool's fairness grant.

        Returns the granted width — which may be less than asked (fair
        share) or equal to the current width (nothing changed).
        """
        with self._lock:
            job = self._jobs.get(name)
        if job is None:
            raise KeyError(f"unknown job {name!r}")
        granted = self.pool.request(name, int(nprocs))
        if granted != job.supervisor.target_nprocs:
            job.supervisor.request_resize(granted, "operator")
        return granted

    def jobs(self) -> List[str]:
        with self._lock:
            return sorted(self._jobs)

    def job(self, name: str) -> ServiceJob:
        with self._lock:
            return self._jobs[name]

    def wait(self, timeout: Optional[float] = None) -> bool:
        """True when every submitted job has finished."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._lock:
            jobs = list(self._jobs.values())
        for job in jobs:
            left = (None if deadline is None
                    else max(0.0, deadline - time.monotonic()))
            if not job.done.wait(left):
                return False
        return True

    def close(self, timeout: float = 60.0) -> None:
        """Graceful drain: stop every job, wait, release the server."""
        with self._lock:
            jobs = list(self._jobs.values())
        for job in jobs:
            job.supervisor.stop()
        for job in jobs:
            job.done.wait(timeout)
        if self.server is not None:
            self.server.close()
        self.bus.close()
