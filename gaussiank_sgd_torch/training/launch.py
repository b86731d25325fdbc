"""The pod rig: a supervised multi-process launcher over ``torch.distributed``
(port of ``gaussiank_sgd_tpu/training/launch.py``).

``python -m gaussiank_sgd_torch.training.launch --nprocs N <train flags>``
spawns N worker processes, each running the unmodified
:class:`~gaussiank_sgd_torch.training.trainer.Trainer` as rank i of one
process group, and makes process death a real, injectable, recoverable
failure::

    SPAWN(gen) ──> WATCH ──────────── all workers exit 0 ──> DONE
       ^             │ worker lost (exit code / stale heartbeat)
       │             v
       │          TEARDOWN (SIGTERM all -> grace -> SIGKILL stragglers)
       │             │ relaunch budget left?
       └── RELAUNCH(gen+1, resume=last sealed checkpoint) ── else FAIL

* **bootstrap**: :func:`bootstrap_distributed` joins the process group
  (``init_process_group`` over ``tcp://<coordinator>``) with a bounded
  timeout and bounded exponential backoff plus a deterministic jitter;
  each retry is a ``bootstrap_retry`` record, and exhaustion raises with
  the coordinator and every attempt.
* **devices**: a worker takes ``cuda:(rank % cards)``, or the CPU when the
  config says ``device="cpu"``; the backend is NCCL on cards and gloo on
  the CPU, or ``--dist-backend``. NCCL puts one rank on a card, so with
  more ranks than cards the launcher refuses and names ``--dist-backend
  gloo`` (several gloo ranks share a card); it never switches by itself.
* **death detection**: the supervisor polls the children's exit codes (a
  SIGKILL reads -9 at once) and each worker's heartbeat file (a bus
  exporter on every train/checkpoint record) for staleness.
* **teardown**: SIGTERM to every child first (``GracefulShutdown`` seals
  a checkpoint where a step boundary is still reachable), a grace period,
  then SIGKILL to the stragglers.
* **relaunch**: a new generation (a fresh coordinator port) resumes from
  the newest sealed checkpoint in the pod's shared checkpoint directory;
  with none yet it starts cold.
* **telemetry**: each worker writes its own ``procNNN/metrics.jsonl``
  stamped with ``process_index``; the supervisor writes
  ``supervisor.jsonl`` (``worker_lost``, ``worker_relaunch``); ``python -m
  gaussiank_sgd_torch.telemetry merge`` joins them into one stream.

The supervisor imports no ``torch``: it is stdlib and the package's
telemetry; ``torch`` is imported inside the worker functions only.
"""

from __future__ import annotations

import argparse
import dataclasses
import hashlib
import json
import logging
import os
import signal
import socket
import subprocess
import sys
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

log = logging.getLogger(__name__)

# env plumbing between supervisor and workers
SPEC_ENV = "GKSGD_LAUNCH_SPEC"
KILL_STEP_ENV = "GKSGD_CHAOS_KILL_STEP"
KILL_PROC_ENV = "GKSGD_CHAOS_KILL_PROC"
PREEMPT_STEP_ENV = "GKSGD_CHAOS_PREEMPT_STEP"
PREEMPT_PROC_ENV = "GKSGD_CHAOS_PREEMPT_PROC"

# training/checkpoint.py's MANIFEST, copied so that the supervisor imports
# no torch (tests/test_torch_launch.py holds the two equal)
_MANIFEST = "commit_manifest.json"


# ---------------------------------------------------------------------------
# coordinator bootstrap (worker side; testable without a process group)
# ---------------------------------------------------------------------------

def _deterministic_jitter(process_id: int, attempt: int) -> float:
    """A jitter fraction in [0, 1), hashed from (process, attempt), never
    random: replays are bit-identical, and processes only need different
    delays, not unpredictable ones."""
    h = hashlib.sha256(f"{process_id}:{attempt}".encode()).digest()
    return int.from_bytes(h[:4], "big") / 2 ** 32


def bootstrap_distributed(coordinator: str, num_processes: int,
                          process_id: int, *,
                          backend: str = "gloo",
                          timeout_s: float = 60.0,
                          max_retries: int = 4,
                          backoff_s: float = 0.5,
                          backoff_cap_s: float = 8.0,
                          jitter: float = 0.25,
                          initialize: Optional[Callable[[], None]] = None,
                          on_retry: Optional[Callable[[Dict[str, Any]],
                                                      None]] = None,
                          sleep: Callable[[float], None] = time.sleep,
                          ) -> int:
    """Join the default process group as ``process_id`` of
    ``num_processes`` with bounded retries.

    Each attempt is ``torch.distributed.init_process_group(backend,
    init_method="tcp://<coordinator>", rank, world_size,
    timeout=timeout_s)`` (the timeout also bounds each later collective);
    an attempt that fails destroys any half-formed group first. A failed
    attempt backs off ``backoff_s * 2**(attempt - 1)``, capped at
    ``backoff_cap_s``, times ``1 + jitter * _deterministic_jitter``; after
    ``max_retries`` retries it raises with the coordinator and every
    attempt. Each retry calls ``on_retry`` with a ``bootstrap_retry``
    record (the bus does not exist yet). ``initialize`` is injectable
    (``chaos.FlakyCoordinator`` in the tests). Returns the attempts that
    ran (1: the first worked)."""
    if initialize is None:
        def initialize() -> None:
            import datetime

            import torch.distributed as dist
            try:
                dist.init_process_group(
                    backend, init_method=f"tcp://{coordinator}",
                    rank=process_id, world_size=num_processes,
                    timeout=datetime.timedelta(seconds=max(timeout_s, 1.0)))
            except BaseException:
                if dist.is_initialized():
                    dist.destroy_process_group()
                raise
    attempts: List[str] = []
    for attempt in range(1, max_retries + 2):     # 1 first try + retries
        try:
            initialize()
            return attempt
        except Exception as e:  # noqa: BLE001 -- every failure kind retries
            attempts.append(f"attempt {attempt}: {type(e).__name__}: {e}")
            if attempt > max_retries:
                raise RuntimeError(
                    f"torch.distributed bootstrap failed for process "
                    f"{process_id}/{num_processes} against coordinator "
                    f"{coordinator} after {attempt} attempt(s) "
                    f"(timeout {timeout_s:g}s each):\n  "
                    + "\n  ".join(attempts)) from e
            delay = min(backoff_s * 2 ** (attempt - 1), backoff_cap_s)
            delay *= 1.0 + jitter * _deterministic_jitter(process_id,
                                                          attempt)
            if on_retry is not None:
                on_retry({"event": "bootstrap_retry", "attempt": attempt,
                          "max_retries": max_retries,
                          "backoff_s": round(delay, 6),
                          "coordinator": coordinator,
                          "error": f"{type(e).__name__}: {e}",
                          "ts": round(time.time(), 6)})
            sleep(delay)
    raise AssertionError("unreachable")  # pragma: no cover


# ---------------------------------------------------------------------------
# heartbeats (worker writes, supervisor reads)
# ---------------------------------------------------------------------------

_HEARTBEAT_EVENTS = ("config", "train", "eval", "checkpoint", "preempt")


class HeartbeatExporter:
    """A bus exporter that records liveness and progress in a small JSON
    file: every ``train``/``checkpoint``/... record atomically replaces it
    with ``{"step", "ts", "process_index"}``. The supervisor reads ``ts``'s
    age as its hang detector (exit codes catch a death first; a heartbeat
    times out only when the process is alive but stuck). No lock: the bus's
    delivery turnstile serialises ``emit``."""

    def __init__(self, path: str, process_index: int,
                 clock: Callable[[], float] = time.time):
        self.path = path
        self.process_index = int(process_index)
        self._clock = clock
        self._step = 0
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)

    def beat(self, step: Optional[int] = None) -> None:
        if step is not None:
            self._step = int(step)
        tmp = f"{self.path}.tmp"
        with open(tmp, "w", encoding="utf-8") as fh:
            json.dump({"step": self._step, "ts": round(self._clock(), 6),
                       "process_index": self.process_index}, fh)
        os.replace(tmp, self.path)

    def emit(self, record: Dict[str, Any]) -> None:
        if record.get("event") in _HEARTBEAT_EVENTS:
            step = record.get("step")
            self.beat(int(step) if isinstance(step, (int, float)) else None)

    def flush(self) -> None:
        return None

    def close(self) -> None:
        return None


def read_heartbeat(path: str) -> Optional[Dict[str, Any]]:
    """A heartbeat file's record; None when it is absent or not a JSON
    object (a poll can race the very first create)."""
    try:
        with open(path, "r", encoding="utf-8") as fh:
            rec = json.load(fh)
        return rec if isinstance(rec, dict) else None
    except (OSError, ValueError):
        return None


# ---------------------------------------------------------------------------
# worker
# ---------------------------------------------------------------------------

def _spec_to_config(spec: Dict[str, Any], process_id: int):
    """The worker's TrainConfig from the launch spec: the pod's directory,
    a run directory of its own (streams must not interleave), and resume
    pointed at the shared checkpoint directory when the supervisor found a
    sealed checkpoint there."""
    from .config import TrainConfig
    d = dict(spec["config"])
    # the JSON round trip turns tuples into lists
    for key in ("lr_milestones", "profile_steps"):
        if d.get(key) is not None:
            d[key] = tuple(d[key])
    d["output_dir"] = spec["pod_dir"]
    d["run_id"] = f"proc{process_id:03d}"
    d["nworkers"] = int(spec["nprocs"])
    d["resume"] = spec.get("resume") or None
    if process_id != 0:
        # retention deletes shared directories: one process runs it
        d["keep_checkpoints"] = 0
    return TrainConfig(**d)


def worker_device(device: str, process_id: int) -> str:
    """A worker's device: ``cpu`` when the config asks for it, else card
    ``process_id % cards`` (``cuda:i``)."""
    if device == "cpu":
        return "cpu"
    import torch
    cards = torch.cuda.device_count()
    if cards == 0:
        raise RuntimeError(
            "no CUDA device is available; pod workers run on the GPU unless "
            "the config says device='cpu' (--device cpu)")
    return f"cuda:{process_id % cards}"


def worker_main(spec: Dict[str, Any], process_id: int) -> int:
    """One pod worker: join the process group (bounded-retry bootstrap) on
    this worker's device, then run the unmodified Trainer with (a) the
    pod's shared checkpoint directory, (b) ``process_index`` stamped on
    every record, which every process writes to its own
    ``procNNN/metrics.jsonl``, (c) a heartbeat file for the supervisor, and
    (d) the kill and preemption injectors the environment asks for. SIGTERM
    lands on this process's main thread, so ``GracefulShutdown`` seals a
    checkpoint and ``fit`` returns: exit code 0 either way."""
    import torch
    import torch.distributed as dist

    from ..parallel.mesh import backend_for
    from . import chaos
    from .trainer import Trainer

    cfg = _spec_to_config(spec, process_id)
    cfg = dataclasses.replace(cfg,
                              device=worker_device(cfg.device, process_id))
    if cfg.device != "cpu":
        torch.cuda.set_device(torch.device(cfg.device))
    pending: List[Dict[str, Any]] = []
    bootstrap_distributed(
        spec["coordinator"], int(spec["nprocs"]), process_id,
        backend=spec.get("dist_backend") or backend_for(cfg.device),
        timeout_s=float(spec.get("bootstrap_timeout_s", 60.0)),
        max_retries=int(spec.get("bootstrap_retries", 4)),
        backoff_s=float(spec.get("bootstrap_backoff_s", 0.5)),
        on_retry=pending.append)

    trainer = Trainer(cfg, every_rank_writes=True)
    try:
        trainer.bus.add_stamp(lambda: {"process_index": process_id})
        trainer.ckpt_dir = spec["ckpt_dir"]      # shared across the pod
        hb = HeartbeatExporter(spec["heartbeats"][process_id], process_id)
        trainer.bus.attach(hb)
        for rec in pending:                      # bootstrap predates the bus
            trainer.bus.publish(rec)
        hb.beat(trainer.step)                    # arm the staleness clock

        kill_step = os.environ.get(KILL_STEP_ENV)
        if (kill_step is not None
                and int(os.environ.get(KILL_PROC_ENV, "0")) == process_id):
            chaos.inject_process_death(trainer, int(kill_step))
        preempt_step = os.environ.get(PREEMPT_STEP_ENV)
        if (preempt_step is not None
                and int(os.environ.get(PREEMPT_PROC_ENV, "0")) == process_id):
            chaos.inject_preemption(trainer, int(preempt_step))
        trainer.fit()
    finally:
        trainer.close()
    dist.destroy_process_group()
    return 0


# ---------------------------------------------------------------------------
# supervisor
# ---------------------------------------------------------------------------

def free_port(host: str = "127.0.0.1") -> int:
    """An OS-assigned free TCP port (each generation gets a fresh
    coordinator: the last one's socket may still be in TIME_WAIT)."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind((host, 0))
        return int(s.getsockname()[1])


def has_sealed_checkpoint(ckpt_dir: str) -> Optional[str]:
    """The newest ``step_*`` directory that holds a commit manifest, or
    None. A plain scan: the workers' ``restore_latest_good`` does the full
    check (sizes, CRCs, the fall back past a damaged one) at relaunch."""
    if not os.path.isdir(ckpt_dir):
        return None
    best: Optional[str] = None
    for d in sorted(os.listdir(ckpt_dir)):
        if (d.startswith("step_")
                and os.path.isfile(os.path.join(ckpt_dir, d, _MANIFEST))):
            best = os.path.join(ckpt_dir, d)
    return best


def _visible_cards() -> int:
    """The CUDA devices a worker would see, counted in a child process
    (the supervisor itself imports no torch); 0 when that fails."""
    out = subprocess.run(
        [sys.executable, "-c",
         "import torch; print(torch.cuda.device_count())"],
        capture_output=True, text=True, timeout=300)
    try:
        return int(out.stdout.split()[-1]) if out.returncode == 0 else 0
    except (IndexError, ValueError):
        return 0


@dataclasses.dataclass
class LaunchConfig:
    """The supervisor's settings."""

    nprocs: int = 2
    heartbeat_timeout_s: float = 300.0   # hang backstop; exit codes are
                                         # the first death signal
    grace_s: float = 20.0                # SIGTERM -> SIGKILL escalation
    poll_s: float = 0.2
    max_relaunches: int = 2
    bootstrap_timeout_s: float = 60.0
    bootstrap_retries: int = 4
    bootstrap_backoff_s: float = 0.5
    kill_step: Optional[int] = None      # chaos: SIGKILL one worker when
    kill_proc: int = 0                   # it pulls the batch for this step
                                         # (generation 0 only)
    preempt_step: Optional[int] = None   # chaos: SIGTERM one worker at a
    preempt_proc: int = 0                # step (graceful twin; gen 0 only)
    dist_backend: Optional[str] = None   # None: nccl on cards, gloo on
                                         # the CPU


class Supervisor:
    """The spawn/watch/teardown/relaunch loop over N worker processes.

    A target-N reconciler: the width to spawn at is supervisor state
    (``target_nprocs``), every generation's spec is built from it, and
    :meth:`request_resize` moves it from any thread; the watch loop then
    tears down, re-specs and spawns at the new width, resuming from the
    last sealed checkpoint. The hooks ``_poll_tick``, ``_post_spawn``,
    ``_on_worker_lost``, ``_apply_resize`` and ``_progress_step`` are where
    an elastic service adds budgets and bounds; :meth:`_worker_command` is
    the one place a harness changes what a worker runs.

    Single-threaded: the watch loop polls, and the SIGTERM/SIGINT handlers
    only set an Event. Its own stream, ``supervisor.jsonl``, is validated
    strictly as it is written.
    """

    def __init__(self, cfg, launch: LaunchConfig, pod_dir: str):
        from ..telemetry import EventBus, JSONLExporter
        self.cfg = cfg
        self.launch = launch
        self.pod_dir = pod_dir
        self.ckpt_dir = os.path.join(pod_dir, "ckpt")
        os.makedirs(pod_dir, exist_ok=True)
        self.bus = EventBus(
            [JSONLExporter(os.path.join(pod_dir, "supervisor.jsonl"))],
            validate=True)
        self.bus.add_stamp(lambda: {"process_index": -1})
        self._shutdown = threading.Event()
        self._old_handlers: Dict[int, Any] = {}
        self._logs: List[Any] = []
        self.generation = 0
        self.relaunches = 0
        self._lock = threading.Lock()
        self._target_nprocs = int(launch.nprocs)
        self._resize: Optional[Tuple[int, str]] = None
        self._cards: Optional[int] = None    # visible cards, counted once

    # -- target-N reconciliation ---------------------------------------
    @property
    def target_nprocs(self) -> int:
        with self._lock:
            return self._target_nprocs

    def request_resize(self, nprocs: int, reason: str = "operator") -> None:
        """Thread-safe: ask the loop to re-mesh at ``nprocs`` at its next
        poll; a later request before then supersedes this one."""
        with self._lock:
            self._resize = (max(1, int(nprocs)), str(reason))

    def _resize_pending(self) -> bool:
        with self._lock:
            return self._resize is not None

    def _take_resize(self) -> Optional[Tuple[int, str]]:
        with self._lock:
            out, self._resize = self._resize, None
            return out

    def _commit_target(self, nprocs: int) -> None:
        with self._lock:
            self._target_nprocs = max(1, int(nprocs))

    # -- service hooks (no-ops here) ------------------------------------
    def _poll_tick(self, procs: Sequence[subprocess.Popen],
                   spec: Dict[str, Any]) -> None:
        """Once a watch poll, before the death checks."""

    def _post_spawn(self, procs: Sequence[subprocess.Popen],
                    spec: Dict[str, Any]) -> None:
        """Right after a generation is spawned, before it is watched."""

    def _on_worker_lost(self, lost: List[Dict[str, Any]],
                        spec: Dict[str, Any]) -> None:
        """After ``worker_lost`` is published, before the relaunch budget
        is charged."""

    def _apply_resize(self, directive: Tuple[int, str],
                      progress_step: int) -> bool:
        """Commit a directive taken after teardown; False refuses it (the
        loop relaunches at the old width). The base accepts all."""
        self._commit_target(directive[0])
        return True

    def _progress_step(self, spec: Dict[str, Any]) -> int:
        """The highest step any worker's heartbeat reached this
        generation."""
        best = 0
        for path in spec["heartbeats"]:
            hb = read_heartbeat(path)
            if hb is not None:
                best = max(best, int(hb.get("step", 0)))
        return best

    # -- lifecycle ------------------------------------------------------
    def _install_signals(self) -> None:
        if threading.current_thread() is not threading.main_thread():
            return                       # a loop driven from a thread
        for sig in (signal.SIGTERM, signal.SIGINT):
            self._old_handlers[sig] = signal.signal(
                sig, lambda _s, _f: self._shutdown.set())

    def stop(self) -> None:
        """End the run gracefully (what SIGTERM does), from any thread."""
        self._shutdown.set()

    def _uninstall_signals(self) -> None:
        for sig, old in self._old_handlers.items():
            signal.signal(sig, old)
        self._old_handlers.clear()

    def _backend_refusal(self, nprocs: int) -> Optional[str]:
        """Why the backend cannot form a pod of ``nprocs`` ranks, or None:
        NCCL puts one rank on a card, so it refuses more ranks than cards
        (and the CPU). The visible cards are counted once."""
        backend = self.launch.dist_backend or (
            "gloo" if self.cfg.device == "cpu" else "nccl")
        if backend != "nccl":
            return None
        if self._cards is None:
            self._cards = 0 if self.cfg.device == "cpu" else _visible_cards()
        n, cards = int(nprocs), self._cards
        if n <= cards:
            return None
        return (f"--nprocs {n} over NCCL needs {n} card(s), and {cards} "
                f"{'is' if cards == 1 else 'are'} visible: NCCL puts one "
                f"rank on a card. Pass --dist-backend gloo to share the "
                f"cards (collectives through host memory), or fewer --nprocs")

    def _check_backend(self) -> None:
        """Refuse a pod NCCL cannot form (:meth:`_backend_refusal`). Never
        switches backends: the message names ``--dist-backend gloo``."""
        refusal = self._backend_refusal(self.target_nprocs)
        if refusal is not None:
            raise ValueError(refusal)

    def _worker_spec(self, resume: Optional[str],
                     nprocs: Optional[int] = None) -> Dict[str, Any]:
        n = int(nprocs) if nprocs is not None else self.target_nprocs
        hb_dir = os.path.join(self.pod_dir, "heartbeats")
        return {
            "coordinator": f"127.0.0.1:{free_port()}",
            "generation": self.generation,
            "nprocs": n,
            "pod_dir": self.pod_dir,
            "ckpt_dir": self.ckpt_dir,
            "heartbeats": [os.path.join(hb_dir, f"proc{i:03d}.json")
                           for i in range(n)],
            "resume": resume,
            "dist_backend": self.launch.dist_backend,
            "bootstrap_timeout_s": self.launch.bootstrap_timeout_s,
            "bootstrap_retries": self.launch.bootstrap_retries,
            "bootstrap_backoff_s": self.launch.bootstrap_backoff_s,
            "config": dataclasses.asdict(self.cfg),
        }

    def _worker_command(self, i: int) -> List[str]:
        """The command line of worker ``i`` (its spec is in the
        environment, under ``SPEC_ENV``)."""
        return [sys.executable, "-m", "gaussiank_sgd_torch.training.launch",
                "--worker", str(i)]

    def _spawn(self, spec: Dict[str, Any]) -> List[subprocess.Popen]:
        # the last generation's heartbeats must not trip the staleness
        # check before the new workers' first beat; the whole directory,
        # since a shrink leaves files outside this spec
        hb_dir = os.path.dirname(spec["heartbeats"][0])
        if os.path.isdir(hb_dir):
            for name in os.listdir(hb_dir):
                if name.startswith("proc") and name.endswith(".json"):
                    os.remove(os.path.join(hb_dir, name))
        n = int(spec["nprocs"])
        log.info("SPAWN gen %d: nprocs=%d heartbeat_timeout=%.1fs "
                 "poll_interval=%.2fs grace=%.1fs coordinator=%s",
                 self.generation, n, self.launch.heartbeat_timeout_s,
                 self.launch.poll_s, self.launch.grace_s,
                 spec["coordinator"])
        procs = []
        pkg_root = os.path.dirname(os.path.dirname(
            os.path.dirname(os.path.abspath(__file__))))
        for i in range(n):
            env = dict(os.environ)
            env[SPEC_ENV] = json.dumps(spec)
            env["PYTHONPATH"] = (pkg_root + os.pathsep
                                 + env.get("PYTHONPATH", ""))
            for step, proc, step_env, proc_env in (
                    (self.launch.kill_step, self.launch.kill_proc,
                     KILL_STEP_ENV, KILL_PROC_ENV),
                    (self.launch.preempt_step, self.launch.preempt_proc,
                     PREEMPT_STEP_ENV, PREEMPT_PROC_ENV)):
                if self.generation == 0 and step is not None:
                    env[step_env], env[proc_env] = str(step), str(proc)
                else:
                    env.pop(step_env, None)
                    env.pop(proc_env, None)
            out = open(os.path.join(
                self.pod_dir, f"gen{self.generation:02d}_proc{i:03d}.log"),
                "w")
            self._logs.append(out)
            procs.append(subprocess.Popen(
                self._worker_command(i), env=env, stdout=out,
                stderr=subprocess.STDOUT))
        return procs

    # -- watch / teardown ----------------------------------------------
    def _lost_workers(self, procs: Sequence[subprocess.Popen],
                      spec: Dict[str, Any],
                      now: float) -> List[Dict[str, Any]]:
        lost = []
        for i, p in enumerate(procs):
            rc = p.poll()
            if rc is not None and rc != 0:
                lost.append({"worker": i, "reason": "exit", "exit_code": rc})
                continue
            if rc is None:
                hb = read_heartbeat(spec["heartbeats"][i])
                if hb is not None:
                    age = now - float(hb.get("ts", now))
                    if age > self.launch.heartbeat_timeout_s:
                        lost.append({"worker": i,
                                     "reason": "heartbeat_timeout",
                                     "heartbeat_age_s": round(age, 3),
                                     "heartbeat_step":
                                         int(hb.get("step", 0))})
        return lost

    def _watch(self, procs: List[subprocess.Popen],
               spec: Dict[str, Any]) -> Tuple[str, List[Dict[str, Any]]]:
        while True:
            if self._shutdown.is_set():
                return "shutdown", []
            self._poll_tick(procs, spec)
            if self._resize_pending():
                return "resize", []
            lost = self._lost_workers(procs, spec, time.time())
            if lost:
                return "lost", lost
            if all(p.poll() == 0 for p in procs):
                return "ok", []
            time.sleep(self.launch.poll_s)

    def _teardown(self, procs: Sequence[subprocess.Popen]) -> None:
        """SIGTERM every live child first (``GracefulShutdown`` seals where
        a step boundary is still reachable), wait out the grace period,
        then SIGKILL the stragglers: a collective whose peer died may never
        return, and no child may outlive the supervisor."""
        for p in procs:
            if p.poll() is None:
                p.terminate()
        deadline = time.time() + self.launch.grace_s
        while (time.time() < deadline
               and any(p.poll() is None for p in procs)):
            time.sleep(self.launch.poll_s)
        for p in procs:
            if p.poll() is None:
                p.kill()
        for p in procs:
            p.wait()

    # -- main loop ------------------------------------------------------
    def run(self) -> int:
        """Run the pod to its end: 0 when every worker of a generation
        exits 0, 143 on SIGTERM/SIGINT (or :meth:`stop`); raises when the
        relaunch budget is spent."""
        self._check_backend()
        self._install_signals()
        try:
            while True:
                resume = has_sealed_checkpoint(self.ckpt_dir)
                spec = self._worker_spec(
                    resume=self.ckpt_dir if resume else None)
                procs = self._spawn(spec)
                try:
                    self._post_spawn(procs, spec)
                    outcome, lost = self._watch(procs, spec)
                    progress = self._progress_step(spec)
                finally:
                    self._teardown(procs)
                if outcome == "ok":
                    return 0
                if outcome == "shutdown":
                    return 143           # 128 + SIGTERM, shell convention
                for rec in lost:
                    self.bus.publish({"event": "worker_lost",
                                      "generation": self.generation,
                                      **rec})
                if outcome == "lost":
                    self._on_worker_lost(lost, spec)
                    self.relaunches += 1
                    if self.relaunches > self.launch.max_relaunches:
                        raise RuntimeError(
                            f"relaunch budget exhausted "
                            f"({self.launch.max_relaunches}): workers keep "
                            f"dying; see {self.pod_dir}/gen*_proc*.log and "
                            f"supervisor.jsonl")
                # a directive from the watch or from _on_worker_lost is
                # applied once, after teardown, so the next spawn is at
                # the new width
                directive = self._take_resize()
                if directive is not None:
                    self._apply_resize(directive, progress)
                self.generation += 1
                sealed = has_sealed_checkpoint(self.ckpt_dir)
                self.bus.publish({"event": "worker_relaunch",
                                  "generation": self.generation,
                                  "nprocs": self.target_nprocs,
                                  "checkpoint": sealed or ""})
        finally:
            self._uninstall_signals()
            self.bus.close()
            for out in self._logs:
                out.close()


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------

def main(argv: Optional[List[str]] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s: %(message)s")
    if argv and argv[0] == "--worker":
        return worker_main(json.loads(os.environ[SPEC_ENV]), int(argv[1]))

    from . import config as config_mod
    ap = argparse.ArgumentParser(
        prog="python -m gaussiank_sgd_torch.training.launch",
        description="multi-process pod rig: N torch.distributed workers "
                    "with supervised kill/restore")
    ap.add_argument("--nprocs", type=int, default=2)
    ap.add_argument("--dist-backend", dest="dist_backend",
                    choices=("nccl", "gloo"), default=None,
                    help="the workers' process-group backend (default: "
                         "nccl on cards, gloo on the CPU); gloo lets "
                         "several ranks share one card")
    ap.add_argument("--heartbeat-timeout", type=float, default=300.0,
                    dest="heartbeat_timeout_s",
                    help="seconds of heartbeat silence before a live "
                         "worker counts as lost (hang backstop)")
    ap.add_argument("--poll-interval", type=float, default=0.2,
                    dest="poll_s",
                    help="watch-loop poll period (s); also the teardown "
                         "escalation poll")
    ap.add_argument("--grace", type=float, default=20.0, dest="grace_s",
                    help="SIGTERM -> SIGKILL escalation window (s)")
    ap.add_argument("--max-relaunches", type=int, default=2)
    ap.add_argument("--bootstrap-timeout", type=float, default=60.0,
                    dest="bootstrap_timeout_s")
    ap.add_argument("--bootstrap-retries", type=int, default=4)
    ap.add_argument("--kill-step", type=int, default=None,
                    help="chaos: SIGKILL --kill-proc when it pulls the "
                         "batch feeding this global step (gen 0 only)")
    ap.add_argument("--kill-proc", type=int, default=0)
    ap.add_argument("--preempt-step", type=int, default=None,
                    help="chaos: SIGTERM --preempt-proc (graceful "
                         "preemption) at this global step (gen 0 only)")
    ap.add_argument("--preempt-proc", type=int, default=0)
    config_mod.add_args(ap)
    args = ap.parse_args(argv)
    cfg = config_mod.from_args(args, argv)

    launch = LaunchConfig(
        nprocs=args.nprocs,
        heartbeat_timeout_s=args.heartbeat_timeout_s,
        grace_s=args.grace_s, poll_s=args.poll_s,
        max_relaunches=args.max_relaunches,
        bootstrap_timeout_s=args.bootstrap_timeout_s,
        bootstrap_retries=args.bootstrap_retries,
        kill_step=args.kill_step, kill_proc=args.kill_proc,
        preempt_step=args.preempt_step, preempt_proc=args.preempt_proc,
        dist_backend=args.dist_backend)
    pod_dir = os.path.join(cfg.output_dir, cfg.run_id)
    return Supervisor(cfg, launch, pod_dir).run()


if __name__ == "__main__":
    sys.exit(main())
