"""Trainer — the host loop (port of the training path of
``gaussiank_sgd_tpu/training/trainer.py``).

It builds the datasets, the model, the compressor, the bucket plan, the
schedule and the optimizer, then runs dense steps for the first
``compress_warmup_steps`` steps and sparse steps after.

Every runtime record goes through one ``telemetry.EventBus``, as in the
reference: the run's ``config``, each log interval's ``train`` record,
eval passes, checkpoints, restores, skips, rollbacks, preemptions, the
prefetch thread's loader retries and profiler windows. The bus stamps
``schema_version``, ``seq`` and ``ts`` and hands each record, in ``seq``
order, to rank 0's exporters: ``<output_dir>/<run_id>/metrics.jsonl`` and,
with ``prom_textfile``, a Prometheus textfile. ``trace="on"`` adds span
records of the host phases (``telemetry/tracing.py``), a ``trace_id``
stamp on every record, and the trace-gated ``pipeline_chunks`` and
``comm_rounds`` keys; besides, it times each step's parts in the trace
context's in-memory store, where no record goes: the loop's
``data_wait``, ``step_dispatch`` (and its ``step_sync``), ``step_record``,
``stop_flag`` and ``log_interval``, the step's own (``DPTrainStep``), and
the ``host_syncs`` counter, every wait for the device the loop asks for
(a synchronise, a blocking copy to the device, a host read of a device
tensor); ``health="on"`` (or ``health_port``) a
``health_status`` verdict after each ``train`` record
(``telemetry/health.py``), served at ``/healthz`` by rank 0 with a port.
Log lines also go to the run's ``train.log`` (rank 0). With
``every_rank_writes`` (the pod launcher's workers, each in a run directory
of its own) every rank writes its ``metrics.jsonl``, ``steps.jsonl`` and
``train.log``. Besides, every step's record (loss and the task's aux values as
worker means: ``acc``, ``ce_per_token`` for a language model, or ``ctc``
for the speech model; num_selected beside k, bytes_sent, and the step's
wall time in ms, taken around work that ends in a device synchronise) is
kept in ``records`` and appended to ``steps.jsonl`` (rank 0). ``train``
returns the last log interval's record, as the reference's does.

The LSTM with ``carry_hidden`` is recurrent: the train state carries its
hidden state across bptt windows (this rank's rows), zeroed at each epoch
wrap (the text starts over), and each eval pass threads a fresh carry
through the contiguous test windows.

One process is one worker. Under ``torchrun`` every process joins the
process group from its environment (``parallel/mesh.py``), and
``nworkers`` must equal the world size (0 takes the world size); with
``--ici-size I --dcn-size D`` the workers are laid out two-level
(``hierarchical_dp_mesh``: I a node on D nodes), the world must be ``I *
D``, and ``nworkers`` becomes that, as in the reference; ``--sp-size S``
(``transformer_lm`` only) lays them out ``(dp, sp)`` (``dp_sp_mesh``,
``dp = nworkers`` or the world over S): each rank takes its replica's rows
and its block of the sequence, and the model's attention is a ring over
the sp group. The optimizer is
the reference's choice: ``FlatSGDM`` on a 1-D layout without ``nesterov``
or ``fold_lr`` when momentum or weight decay is set, else ``OptaxSGD``
(the optax path; at lr 1 under ``fold_lr``, which moves the learning rate
into the EF accumulate). ``dataset_kwargs`` override ``make_dataset``'s
arguments for both splits. Every rank draws the same global batch of
``batch_size * nworkers * nsteps_update`` rows from the epoch stream
(``data/loader.py:EpochStream``: epoch e shuffled with ``seed + e``,
aligned to the step, so a resumed run draws what the uninterrupted one
would) and takes its own rows, as the reference's dp sharding does; each
rank's dropout generator is seeded from (seed, rank).

The stream runs on a background thread (``data/loader.py:prefetch``), two
batches ahead of the step, with ``io_retries`` retries of a transient read
error; the thread also copies this rank's rows into pinned host memory (a
buffer a batch), so the copy to the card does not block the host. The
reference's resilience runtime is on by default
(``training/resilience.py``): after ``max_consecutive_skips`` guard-skipped
steps in a row, or a loss spike when ``loss_spike_factor`` is set, the run
rolls back at the next log-interval boundary to the newest good checkpoint
from before the anomaly, with the learning rate scaled by ``lr_backoff``
for each rollback; and ``fit`` turns SIGTERM/SIGINT into a sealed
checkpoint at the next step boundary and a clean exit.

The step is built on ``overlap``'s schedule (``parallel/trainstep.py``:
the bucket-pipelined step where the plan allows it). Each log record
carries the schedule, the reference's windowed ``ex_per_s`` and, on a
card whose peak is known, ``mfu`` (``telemetry/throughput.py``: a skipped
step adds time but no examples; a rollback empties the window); with
``phase_timing``, also the reference's phase breakdown, timed by the
step's three probes (``_phase_breakdown``).

With ``policy="adaptive"`` the reference's policy engine (``policy/``)
rides the bus as an exporter, and at each log-interval boundary after the
dense warm-up (before a pending rollback runs) it may retune the
compressor, the density, the wire, the bucket plan or the schedule. The
trainer applies a decision by rebuilding the step (``_build_step``) and
carrying the state across; rank 0's engine decides for every rank.
"""

from __future__ import annotations

import contextlib
import dataclasses
import logging
import math
import os
import threading
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from ..benchlib import device_peak_flops, program_flops
from ..compressors import get_compressor
from ..data import TEXT_DATASETS, EpochStream, make_dataset, prefetch
from ..device import resolve_device
from ..models import get_model
from ..parallel.bucketing import plan_for_params
from ..parallel.collectives import all_reduce_sum, rank, world_size
from ..parallel.flat_opt import FlatSGDM, OptaxSGD
from ..parallel.mesh import (data_parallel_mesh, dp_sp_mesh,
                             hierarchical_dp_mesh,
                             maybe_initialize_distributed, shard_batch)
from ..parallel.trainstep import DPTrainStep, TrainState, flat_numel
from ..telemetry.bus import EventBus
from ..telemetry.exporters import JSONLExporter, PrometheusTextfileExporter
from ..policy import (KNOB_BUCKET, KNOB_COMPRESSOR, KNOB_DENSITY,
                      KNOB_OVERLAP, KNOB_WIRE, PolicyEngine, default_rules,
                      load_roofline_floor)
from ..telemetry.health import PRE_ARM_CAUSES, HealthMonitor, HealthServer
from ..telemetry.profiler import ProfilerSession
from ..telemetry.throughput import ThroughputTracker
from ..telemetry.tracing import TraceContext
from .checkpoint import (checkpoint_bytes, gc_checkpoints,
                         restore_checkpoint, restore_latest_good,
                         save_checkpoint)
from .config import TrainConfig
from .losses import IMAGENET_NORM, make_eval_fn, make_loss_fn
from .lr_schedule import warmup_milestone_schedule
from .metrics import PhaseTimers, close_log_file, make_logger
from .resilience import (GracefulShutdown, ResilienceMonitor,
                         ResiliencePolicy, TrainingPreempted)

log = logging.getLogger(__name__)

# a span site's stand-in with tracing off (reused: nothing is allocated)
_NO_SPAN = contextlib.nullcontext()

_DTYPES = {"bfloat16": torch.bfloat16, "bf16": torch.bfloat16,
           "float32": torch.float32, "fp32": torch.float32}


class _ScaledSchedule:
    """``base(step) * scale`` in f32, as the reference's backed-off
    schedule computes it; ``base(step)`` itself while ``scale`` is 1. The
    rollback sets ``scale``; the optimizer and the fold-lr accumulate read
    the schedule at every step."""

    def __init__(self, base: Callable[[int], float]):
        self.base = base
        self.scale = 1.0

    def __call__(self, step: int) -> float:
        lr = self.base(step)
        if self.scale == 1.0:
            return lr
        return float(np.float32(lr) * np.float32(self.scale))


def _batch_shape_key(batch) -> tuple:
    """The shapes of a batch's tensors: a step or probe meets a new
    shape's first-call costs once a shape."""
    return tuple(tuple(x.shape) for x in batch)


def _host_rows(rank_: int, world: int, pin: bool, sp: int = 1):
    """Global numpy batch -> this rank's block as CPU tensors, each in a
    pinned buffer of its own when ``pin`` (run on the prefetch thread)."""
    def fn(batch):
        rows = (torch.from_numpy(np.ascontiguousarray(x))
                for x in shard_batch(batch, rank_, world, sp))
        return tuple(x.pin_memory() if pin else x for x in rows)
    return fn


class Trainer:
    def __init__(self, cfg: TrainConfig, *, every_rank_writes: bool = False):
        self.device = maybe_initialize_distributed(
            resolve_device(cfg.device))
        self.rank, self.world = rank(), world_size()
        self.sp = cfg.sp_size if cfg.sp_size > 1 else 1
        if self.sp > 1:
            if cfg.dnn.lower() not in ("transformer_lm", "transformerlm"):
                raise ValueError(
                    "sequence parallelism (--sp-size) is the transformer_lm "
                    "long-context path")
            dp = cfg.nworkers if cfg.nworkers > 0 else self.world // self.sp
            self.mesh = dp_sp_mesh(dp, self.sp)
            # the dp width: examples a step are batch_size * dp
            cfg = dataclasses.replace(cfg, nworkers=dp)
        elif cfg.ici_size > 0 and cfg.dcn_size > 0:
            self.mesh = hierarchical_dp_mesh(cfg.ici_size, cfg.dcn_size)
            if cfg.nworkers != self.mesh.size:
                log.info("nworkers=%d: the %d x %d layout has %d workers",
                         cfg.nworkers, cfg.ici_size, cfg.dcn_size,
                         self.mesh.size)
                cfg = dataclasses.replace(cfg, nworkers=self.mesh.size)
        elif cfg.nworkers not in (0, self.world):
            raise ValueError(
                f"nworkers={cfg.nworkers} but the world size is "
                f"{self.world}: run one process a worker, e.g. torchrun "
                f"--standalone --nproc-per-node {cfg.nworkers} -m "
                f"gaussiank_sgd_torch.train ...")
        else:
            # 0 means every worker there is, as in the reference
            cfg = dataclasses.replace(cfg, nworkers=self.world)
            self.mesh = data_parallel_mesh()
        self.cfg = cfg
        if cfg.compute_dtype not in _DTYPES:
            raise ValueError(f"unknown compute_dtype {cfg.compute_dtype!r}")
        self.run_dir = os.path.join(cfg.output_dir, cfg.run_id)
        self.metrics_path = os.path.join(self.run_dir, "metrics.jsonl")
        self.steps_path = os.path.join(self.run_dir, "steps.jsonl")
        self.ckpt_dir = os.path.join(self.run_dir, "ckpt")
        lead = self.rank == 0
        # rank 0 writes the run's files; a pod worker (training/launch.py)
        # has a run directory of its own and writes them on every rank
        writes = lead or every_rank_writes
        self.logger = make_logger(
            os.path.join(self.run_dir, "train.log") if writes else None)
        # the telemetry spine: every rank's bus stamps, the writers'
        # exporters write (the one Prometheus textfile: rank 0's)
        exporters = []
        if writes:
            exporters.append(JSONLExporter(self.metrics_path))
        if lead and cfg.prom_textfile:
            exporters.append(PrometheusTextfileExporter(cfg.prom_textfile))
        self.bus = EventBus(exporters)
        self._steps = JSONLExporter(self.steps_path if writes else None)
        # span tracing is opt-in: off, no stamp hook and no span records
        self.trace: Optional[TraceContext] = None
        self._traj_span: Optional[str] = None
        if cfg.trace == "on":
            self.trace = TraceContext(self.bus).install()

        # as the reference builds them: no seed (the augmentation stream
        # starts at default_rng(0); the epoch stream shuffles with the
        # run's seed), the eval batch without the microbatch factor
        # (the overrides of dataset_kwargs win)
        self.train_ds, card = make_dataset(
            cfg.dataset, cfg.data_dir, **{
                "train": True, "batch_size": cfg.global_batch_size,
                **cfg.dataset_kwargs})
        self.eval_batch_size = max(cfg.nworkers,
                                   cfg.batch_size * cfg.nworkers)
        self.test_ds, _ = make_dataset(
            cfg.dataset, cfg.data_dir, **{
                "train": False, "batch_size": self.eval_batch_size,
                **cfg.dataset_kwargs})
        model_kw = {"num_classes": cfg.num_classes or card,
                    "dtype": _DTYPES[cfg.compute_dtype]}
        if cfg.dataset.lower() in TEXT_DATASETS:
            # a language model's vocabulary is the dataset's
            model_kw["vocab_size"] = cfg.num_classes or card
        model_kw.update(cfg.model_kwargs)
        if self.sp > 1:
            # the ring over this rank's sp group; the initial weights come
            # from the seed alone, so they are the sp-free twin's
            model_kw["sp_group"] = self.mesh.groups[-1]
        self.spec = get_model(cfg.dnn, cfg.dataset, device=self.device,
                              seed=cfg.seed, **model_kw)
        self.model = self.spec.module
        # a model with a carry (the LSTM) threads it across bptt windows
        self.recurrent = (cfg.carry_hidden
                          and hasattr(self.model, "initial_carry"))
        if self.world > 1:
            self.model.dropout_generator.manual_seed(int(
                np.random.SeedSequence([cfg.seed, self.rank])
                .generate_state(1, np.uint64)[0] >> 1))
        self.steps_per_epoch = self.train_ds.steps_per_epoch
        self.total_steps = (cfg.max_steps if cfg.max_steps
                            else cfg.epochs * self.steps_per_epoch)

        self.comp = get_compressor(cfg.compressor, density=cfg.density,
                                   sigma_scale=cfg.sigma_scale)
        self.is_dense_only = self.comp.name == "none"
        self.plan = plan_for_params(self.model.param_layout, cfg.density,
                                    cfg.bucket_size, policy=cfg.bucket_policy)
        # the rollback's learning-rate backoff scales this schedule
        self.schedule = _ScaledSchedule(warmup_milestone_schedule(
            cfg.lr, cfg.nworkers, self.steps_per_epoch, self.total_steps,
            cfg.warmup_epochs, cfg.lr_milestones, cfg.lr_decay))
        # wd on the exchanged gradient before momentum (torch SGD order);
        # the flat update where the reference takes it, else the optax path
        opt_kw = dict(momentum=cfg.momentum or 0.0,
                      weight_decay=cfg.weight_decay or 0.0)
        if (not cfg.nesterov and not cfg.fold_lr
                and len(self.mesh.names) == 1
                and (cfg.momentum or cfg.weight_decay)):
            self._opt = {"flat_opt": FlatSGDM(lr=self.schedule, **opt_kw)}
        else:
            self._opt = {"optimizer": OptaxSGD(
                lr=(lambda count: 1.0) if cfg.fold_lr else self.schedule,
                nesterov=cfg.nesterov, **opt_kw)}
        # uint8 ImageNet batches are normalised on the device, in the loss
        self._input_norm = (IMAGENET_NORM if cfg.dataset.lower() == "imagenet"
                            else None)
        self._build_step()
        # this rank's rows of every microbatch of the global batch
        self._state = self.ts.init_state(
            self.model.initial_carry(cfg.batch_size * cfg.nsteps_update)
            if self.recurrent else None)
        self._iter = None                 # the prefetched stream, lazily
        # every step's record, in order (a rollback does not remove any)
        self.records: List[Dict] = []
        self.timers = PhaseTimers()
        # ex_per_s and mfu over a rolling window; the MFU inputs (model
        # FLOPs a step, the card's peak) are resolved once, lazily
        self.tracker = ThroughputTracker(window=cfg.telemetry_window)
        # phase timing: the last batch (the probes' input) and whether this
        # log interval ran a step kind or shape for the first time (the
        # probes, the (kind, shapes) dispatched so far and the MFU inputs
        # belong to the step: _build_step resets them)
        self._probe_batch = None
        self._interval_has_compile = False
        # steps this trajectory has saved: a step first reached on it
        # overwrites a sealed directory an older trajectory left there
        self._saved_steps = set()

        # the resilience runtime, as the reference builds it
        self.shutdown = GracefulShutdown()    # handlers installed in fit()
        policy = ResiliencePolicy(
            max_consecutive_skips=(cfg.max_consecutive_skips
                                   if cfg.nonfinite_guard else 0),
            loss_spike_factor=cfg.loss_spike_factor,
            loss_ema_beta=cfg.loss_ema_beta, lr_backoff=cfg.lr_backoff,
            max_rollbacks=cfg.max_rollbacks)
        self.monitor = ResilienceMonitor(policy) if policy.active else None
        if self.monitor is not None and self.trace is not None:
            # an instant the moment an anomaly goes pending, apart from the
            # rollback span at the next log boundary
            self.monitor.add_anomaly_hook(
                lambda reason, step: self.trace.instant(
                    "anomaly_pending", reason=reason, step=step))
        self.profiler = (ProfilerSession(
            os.path.join(self.run_dir, "profile", f"rank_{self.rank:05d}"),
            cfg.profile_steps[0], cfg.profile_steps[1],
            on_event=self.bus.publish, cuda=self.device.type == "cuda")
            if cfg.profile_steps else None)
        # the adaptive policy engine: with the default 'static' no engine
        # exists, and the loop's policy branch never runs
        self.engine: Optional[PolicyEngine] = None
        if cfg.policy == "adaptive":
            if self.is_dense_only:
                raise ValueError(
                    "--policy adaptive retunes the sparse exchange; "
                    "--compressor none has no knobs to retune")
            self.engine = PolicyEngine(
                default_rules(cfg),
                publish=lambda event, payload: self.bus.publish(
                    {"event": event, **payload}),
                knobs=self._policy_knobs(),
                floor_ms=self._roofline_floor())
            # it rides the bus as an exporter: emit() only ingests
            self.bus.attach(self.engine)
        # run health (opt-in, as tracing is): with health off and no port
        # nothing is attached and no record is added. The monitor rides the
        # bus on every rank; _log_train ticks it and publishes the verdict;
        # rank 0 serves /healthz when a port is given
        self.health: Optional[HealthMonitor] = None
        self._health_server: Optional[HealthServer] = None
        if cfg.health == "on" or cfg.health_port is not None:
            self.health = HealthMonitor(
                floor_ms=self._roofline_floor(),
                density_target=cfg.density)
            self.bus.attach(self.health)
            if cfg.health_port is not None and lead:
                self._health_server = HealthServer(
                    self.health, port=cfg.health_port,
                    prom_path=cfg.prom_textfile).start()
                log.info("health endpoint: http://127.0.0.1:%d/healthz",
                         self._health_server.port)
        if cfg.resume:
            self._resume(cfg.resume)
        self.bus.publish({"event": "config", **{
            k: getattr(cfg, k) for k in ("dnn", "dataset", "batch_size",
                                         "compressor", "density", "lr")},
            "nworkers": cfg.nworkers, "n_params": self.plan.total_numel,
            "total_steps": self.total_steps})
        log.info("model=%s params=%d compressor=%s density=%g buckets=%d "
                 "k_total=%d device=%s rank=%d/%d wire=%s exchange=%s "
                 "mesh=%s optimizer=%s steps=%d data=%s (prefetch 2, "
                 "io_retries %d) guard=%s rollback after %d skips / loss "
                 "spike x%g, lr backoff %g, at most %d overlap=%s: %s",
                 cfg.dnn, self.plan.total_numel, self.comp.name, cfg.density,
                 len(self.plan.buckets), self.plan.total_k, self.device,
                 self.rank, self.world, self.ts.wire_format, cfg.exchange,
                 "x".join(f"{n}={s}" for n, s in zip(self.mesh.names,
                                                     self.mesh.sizes)),
                 next(iter(self._opt)), self.total_steps,
                 type(self.train_ds).__name__, cfg.io_retries,
                 "on" if cfg.nonfinite_guard else "off",
                 policy.max_consecutive_skips, policy.loss_spike_factor,
                 policy.lr_backoff, policy.max_rollbacks, cfg.overlap,
                 self.ts.overlap)
        # every host span and stamped record between rollbacks parents to
        # one trajectory span; a rollback closes it and opens the next
        if self.trace is not None:
            self._traj_span = self.trace.begin("trajectory", step=self.step)

    def _build_step(self) -> None:
        """The step for the current compressor, bucket plan and config: the
        flat parameter re-allocated at the length they need when it
        changes (``models/flat.py:pad_flat``: its first n entries kept, a
        zero tail), then the ``DPTrainStep`` and the eval function over it;
        the phase-timing probes and the MFU inputs, which hold the old
        step, are made again on first use."""
        cfg = self.cfg
        numel = flat_numel(self.comp, self.plan, cfg.exchange)
        if self.model.flat.numel() != numel:
            self.model.pad_flat(numel)
        self.ts = DPTrainStep(make_loss_fn(self.model, self.spec.task,
                                           self._input_norm,
                                           cfg.label_smoothing,
                                           self.recurrent),
                              self.model.flat, {"stats": self.model.stats},
                              self.comp, self.plan, **self._opt,
                              fold_lr=self.schedule if cfg.fold_lr else None,
                              mesh=self.mesh, wire=cfg.wire,
                              num_microbatches=cfg.nsteps_update,
                              clip_norm=cfg.clip_norm,
                              recurrent=self.recurrent, seed=cfg.seed,
                              decorrelate_comp_rng=cfg.decorrelate_comp_rng,
                              exchange=cfg.exchange,
                              guard_nonfinite=cfg.nonfinite_guard,
                              overlap=cfg.overlap,
                              sp_axis="sp" if self.sp > 1 else None,
                              tracer=self.trace)
        self.eval_fn = make_eval_fn(self.model, self.spec.task,
                                    self._input_norm, self.recurrent)
        self._probes = None
        self._warmed_probes = set()
        self._dispatched = set()
        self._mfu_probed = False
        self._flops_per_step = self._peak_flops = None

    # ------------------------------------------------------------ state
    @property
    def state(self) -> TrainState:
        return self._state

    @state.setter
    def state(self, new_state: TrainState) -> None:
        """An assignment from outside the train loop (a test, a handoff)
        moves the step: the data stream, aligned to the old step, is
        dropped, and a new trajectory begins (its saves overwrite)."""
        self._state = new_state
        self._new_trajectory()

    def _new_trajectory(self) -> None:
        self._invalidate_data_iter()
        self._saved_steps = set()

    @property
    def step(self) -> int:
        return self._state.step

    @property
    def epoch(self) -> int:
        return self._state.step // self.steps_per_epoch

    def in_warmup(self, step: int) -> bool:
        return self.is_dense_only or step < self.cfg.compress_warmup_steps

    # ------------------------------------------------------------- data
    def _stream(self):
        """The epoch stream aligned to the current step: resumable, so
        ``prefetch``'s retry can pull again after a read error."""
        return EpochStream(self.train_ds, self.cfg.seed, self.step)

    def _train_iter(self):
        if self._iter is None:
            self._iter = prefetch(
                map(_host_rows(self.rank, self.world,
                               self.device.type == "cuda", self.sp),
                    self._stream()),
                depth=2, max_retries=self.cfg.io_retries,
                backoff_s=self.cfg.io_backoff_s, on_event=self._io_event)
        return self._iter

    def _io_event(self, rec: Dict) -> None:
        """A loader retry, from the prefetch thread: on the bus, and a log
        line."""
        self.bus.publish(rec)
        log.warning("data io retry %s/%s after %s (backoff %.3g s)",
                    rec["attempt"], rec["max_retries"], rec["error"],
                    rec["backoff_s"])

    def _invalidate_data_iter(self) -> None:
        """Stop the prefetch thread (it ran ahead of the step) and drop its
        stream; the next batch starts a stream at the current step."""
        if self._iter is not None:
            self._iter.close()
        self._iter = None

    def next_batch(self):
        """This rank's rows of the next global batch, on the device (the
        copy from pinned memory does not block the host)."""
        return tuple(x.to(self.device, non_blocking=True)
                     for x in next(self._train_iter()))

    def _to_device(self, batch):
        """This rank's rows of a host batch, each a blocking copy from
        pageable memory (on the card the host waits for it)."""
        x, y = shard_batch(batch, self.rank, self.world, self.sp)
        self._waited(2)
        return (torch.from_numpy(np.ascontiguousarray(x)).to(self.device),
                torch.from_numpy(np.ascontiguousarray(y)).to(self.device))

    def _span(self, name: str, **fields):
        """A host-phase span when tracing is on, else a no-op."""
        return (self.trace.span(name, **fields) if self.trace is not None
                else _NO_SPAN)

    def _phase(self, name: str):
        """A per-step phase of the loop (no bus record) when tracing is on,
        else a no-op."""
        return (self.trace.phase(name) if self.trace is not None
                else _NO_SPAN)

    def _waited(self, n: int = 1) -> None:
        """Count ``n`` waits for the device in the step's ``host_syncs``."""
        if self.trace is not None:
            self.trace.count("host_syncs", n)

    def _host(self, x: torch.Tensor, as_: Callable = float):
        """``as_(x)`` of a device tensor: the host waits for the device,
        so every such read in the loop goes through here and is
        counted."""
        self._waited()
        return as_(x)

    def _rotate_trajectory(self, reason: str) -> None:
        """A rollback abandons the trajectory: close its span and open the
        next."""
        if self.trace is None:
            return
        if self._traj_span is not None:
            self.trace.end(self._traj_span, reason=reason)
        self._traj_span = self.trace.begin("trajectory", step=self.step)

    def _sync(self) -> None:
        self._waited()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # ------------------------------------------------------------ train
    def train(self, num_iters: int, data_iter=None) -> Dict:
        """Run ``num_iters`` steps (each appends its record to ``records``
        and the metrics file) on the trainer's stream, or on global batches
        from ``data_iter``. Returns the last log interval's record (the
        reference's ``_log_train`` keys), or, when no interval ended, one
        for the last step; ``{}`` for no step. A pending rollback runs at a
        log-interval boundary; a shutdown request seals a checkpoint and
        raises ``TrainingPreempted``."""
        cfg = self.cfg
        last, m = {}, None
        for _ in range(num_iters):
            if self.trace is not None:
                self.trace.begin_step(self.step + 1)
            self.timers.start("io")
            with self._span("data_wait"):
                batch = (self._to_device(next(data_iter))
                         if data_iter is not None else self.next_batch())
                self._sync()              # io ends when the copy has landed
            self._probe_batch = batch     # the phase-timing probes' input
            self.timers.start("step")
            step = self.step
            if self.profiler is not None:
                self.profiler.maybe_transition(step)
            if (self.recurrent and step > 0
                    and step % self.steps_per_epoch == 0):
                # the text starts over at an epoch wrap: a fresh carry
                self._state.carry = torch.zeros_like(self._state.carry)
            kind = "dense" if self.in_warmup(step) else "sparse"
            fn = self.ts.dense_step if kind == "dense" else self.ts.sparse_step
            key = (kind, _batch_shape_key(batch))
            if key not in self._dispatched:
                # a first step of a kind or shape builds kernels and plans
                # whose cost the probes would not share
                self._dispatched.add(key)
                self._interval_has_compile = True
            self._sync()
            t0 = time.perf_counter()
            # no profiler range: the span encloses the backward
            with self._span("step_dispatch", ranged=False, step=step + 1):
                m = fn(self._state, batch)
                with self._phase("step_sync"):
                    self._sync()
            step_ms = (time.perf_counter() - t0) * 1e3
            self.timers.stop()
            done = step + 1
            with self._phase("step_record"):
                self._record_step(done, kind, m, step_ms)
            if self._stop_requested():
                path = self.save_checkpoint()
                self.bus.publish({"event": "preempt", "step": done,
                                  "checkpoint": path})
                log.warning("shutdown requested: checkpointed %s at step %d",
                            path, done)
                raise TrainingPreempted(done, path)
            if done % cfg.log_every == 0:
                with self._phase("log_interval"):
                    last = self._log_train(done, m)
                    # the monitor and the policy engine act at log
                    # intervals only; a knob revert lands before a pending
                    # rollback, so the restored checkpoint meets the layout
                    # it was saved under. No tick in dense warm-up: its
                    # signals describe the dense step, and no decision can
                    # need a revert yet
                    reason = (self.monitor.should_rollback()
                              if self.monitor is not None else None)
                    if self.engine is not None and not self.in_warmup(done):
                        self._policy_tick(
                            rollback_pending=reason is not None)
                if reason:
                    # the span closes inside the abandoned trajectory; then
                    # the next one opens
                    with self._span("rollback", reason=reason):
                        self._rollback(reason)
                    self._rotate_trajectory(reason)
        if m is not None and not last:
            with self._phase("log_interval"):
                last = self._log_train(self.step, m, quiet=True)
        return last

    def _record_step(self, done: int, kind: str, m, step_ms: float) -> None:
        """Step ``done``'s record (its values read to the host) into
        ``records`` and ``steps.jsonl``; the tracker, a skip's record, the
        monitor, and the cadence save."""
        cfg = self.cfg
        rec = {"step": done, "kind": kind, "loss": self._host(m.loss),
               **{key: self._host(v) for key, v in m.aux.items()},
               "num_selected": self._host(m.num_selected),
               "k": self.plan.total_k if kind == "sparse"
               else self.plan.total_numel,
               "bytes_sent": m.bytes_sent, "skipped": self._host(m.skipped),
               "step_ms": step_ms}
        self.records.append(rec)
        self._steps.emit(rec)
        # a skipped step burns time but trains on nothing
        self.tracker.update(cfg.global_batch_size, step_ms / 1e3,
                            skipped=bool(rec["skipped"]))
        if rec["skipped"]:
            nf = self._host(m.nonfinite)
            self.bus.publish({"event": "skip", "step": done,
                              "nonfinite": nf})
            log.warning("step %d skipped by the guard (%g non-finite "
                        "gradient entries); state unchanged", done, nf)
        if self.monitor is not None:
            self.monitor.observe(done, rec["loss"], rec["skipped"])
        pending = (self.monitor.should_rollback()
                   if self.monitor is not None else None)
        if cfg.save_every_steps and done % cfg.save_every_steps == 0:
            if pending is None:
                self.save_checkpoint()
            else:
                # sealing the suspect state would make it the newest
                # checkpoint, and so the rollback's target
                log.warning("cadence save at step %d suppressed: "
                            "rollback pending (%s)", done, pending)

    def _stop_requested(self) -> bool:
        """The shutdown flag, agreed by every rank (one 1-element
        all-reduce a step when there are several: the flag's copy to the
        device and its read back are two waits), so every rank seals the
        same step."""
        with self._phase("stop_flag"):
            stop = self.shutdown.requested
            if self.world > 1:
                self._waited()
                flag = torch.tensor(float(stop), device=self.device)
                stop = self._host(all_reduce_sum(flag)) > 0
            return stop

    def _log_train(self, step: int, m, quiet: bool = False) -> Dict:
        """The log interval's record: the last step's values, the mean io
        and step seconds of the interval, and the rest of the reference's
        keys: on sparse intervals the wire and the schedule (and the
        overlapped bytes when not 0), the tracker's windowed ``ex_per_s``
        and ``mfu`` (where known), and with ``phase_timing`` (not on a
        quiet record) the phase breakdown."""
        means = self.timers.means()
        n_total = self.plan.total_numel
        nsel = self._host(m.num_selected)
        ef_ss = self.mesh.psum((self._state.ef_residual ** 2).sum())
        rec = {"event": "train", "step": step, "epoch": self.epoch,
               "loss": self._host(m.loss), "lr": float(self.schedule(step)),
               "grad_norm": self._host(self.mesh.pmean(m.grad_norm)),
               "num_selected": nsel, "bytes_sent": int(m.bytes_sent),
               "density": self.cfg.density,
               "density_achieved": float(np.float32(nsel)
                                         / np.float32(n_total)),
               "ef_norm": self._host(torch.sqrt(ef_ss)),
               "io_s": means.get("io", 0.0), "step_s": means.get("step", 0.0),
               "skipped": self._host(m.skipped),
               "nonfinite": self._host(m.nonfinite)}
        # m is the step before ``step``; warm-up steps move no wire
        if not self.in_warmup(step - 1):
            rec["wire_format"] = self.ts.wire_format
            rec["overlap"] = self.ts.overlap
            if m.overlapped_bytes_sent:
                rec["overlapped_bytes_sent"] = int(m.overlapped_bytes_sent)
            if self.trace is not None:
                # the geometry the offline trace rebuilds device phases from
                rec["pipeline_chunks"] = int(m.pipeline_chunks)
                rec["comm_rounds"] = int(m.comm_rounds)
        if len(self.plan.buckets) > 1:
            rec["sel_per_bucket"] = [
                round(v, 2)
                for v in self._host(m.sel_per_bucket, torch.Tensor.tolist)]
        self._maybe_probe_mfu()
        sig = self.tracker.signals(self._flops_per_step, self._peak_flops)
        if sig.examples_per_s is not None:
            rec["ex_per_s"] = round(sig.examples_per_s, 3)
        if sig.mfu is not None:
            rec["mfu"] = round(sig.mfu, 5)
        if self.monitor is not None:
            rec["consecutive_skips"] = self.monitor.consecutive_skips
            rec["lr_scale"] = self.schedule.scale
        if self.cfg.phase_timing and not quiet:
            rec.update(self._phase_breakdown(rec["step_s"]))
        rec.update({k: self._host(v) for k, v in m.aux.items()})
        self.bus.publish(rec)
        if self.health is not None:
            # one verdict a published train record, the cadence
            # replay_health repeats offline; it reads host values only (no
            # device sync). A cause of PRE_ARM_CAUSES that is itself
            # critical pre-arms the rollback (the reference also pre-arms
            # on a degraded one beside another critical cause, which can
            # be one rank's io time alone); ef_pressure rests on
            # all-reduced norms, so every rank pre-arms at the same step
            hrec = self.health.tick(step)
            self.bus.publish(hrec)
            if self.monitor is not None:
                cause = next((c for c in self.health.critical_causes()
                              if c in PRE_ARM_CAUSES), None)
                if cause is not None:
                    # the boundary check right after this call rolls back
                    self.monitor.pre_arm(f"health:{cause}", step)
        if not quiet and self.rank == 0:
            log.info("step %d (ep %d) loss=%.4f lr=%.4g io=%.1fms "
                     "step=%.1fms sel=%d sent=%dB %s", step, rec["epoch"],
                     rec["loss"], rec["lr"], 1e3 * rec["io_s"],
                     1e3 * rec["step_s"], nsel, rec["bytes_sent"],
                     " ".join(f"{k}={self._host(v):.4f}"
                              for k, v in m.aux.items()))
        self.timers.reset()
        self._interval_has_compile = False
        return rec

    def _timed(self, probe: Callable) -> float:
        """Seconds of one probe call on the current state and the last
        batch, between device synchronisations."""
        self._sync()
        t0 = time.perf_counter()
        probe(self._state, self._probe_batch)
        self._sync()
        return time.perf_counter() - t0

    def _phase_breakdown(self, step_s: float) -> Dict[str, Any]:
        """The reference's per-interval breakdown for the current state,
        timed on the last batch: ``fwd_bwd_s`` (the ``grads`` probe),
        ``select_s`` (the ``select`` probe less that), ``comm_update_s``
        (the interval's mean step less the ``select`` probe) and
        ``exposed_exchange_ms`` (the mean step less the ``noexch`` twin),
        each floored at 0; in warm-up only ``fwd_bwd_s`` and
        ``comm_update_s``. An interval that ran a step kind or batch shape
        for the first time gives ``phase_skipped`` instead: its mean step
        holds a first call's cost. Each probe is called once untimed before
        its first timed call on a shape. Single calls: logging grade; the
        benchmark grade is ``benchlib``'s paired rounds. The probes write
        none of the training state."""
        if self._probe_batch is None:
            return {}
        if self._interval_has_compile:
            return {"phase_skipped": "compile_in_interval"}
        if self._probes is None:
            self._probes = self.ts.make_probes(self.model.dropout_generator)
        names = (["grads"] if self.in_warmup(self.step)
                 else ["grads", "select", "noexch"])
        shape = _batch_shape_key(self._probe_batch)
        t = {}
        for name in names:
            if (name, shape) not in self._warmed_probes:
                self._timed(self._probes[name])
                self._warmed_probes.add((name, shape))
            t[name] = self._timed(self._probes[name])
        out = {"fwd_bwd_s": round(t["grads"], 6)}
        if "select" in t:
            out["select_s"] = round(max(t["select"] - t["grads"], 0.0), 6)
            out["comm_update_s"] = round(max(step_s - t["select"], 0.0), 6)
            out["exposed_exchange_ms"] = round(
                max(step_s - t["noexch"], 0.0) * 1e3, 3)
        else:
            out["comm_update_s"] = round(max(step_s - t["grads"], 0.0), 6)
        return out

    def _maybe_probe_mfu(self) -> None:
        """Resolve MFU's inputs once, at the first log record with a batch:
        the card's peak (``benchlib.device_peak_flops``: None on the CPU,
        and then nothing is counted) and the model FLOPs of a step, the
        matmuls and convolutions of this worker's forward and backward
        (``program_flops`` of the ``grads`` probe, which writes no state).
        A failed count leaves MFU off and the run going."""
        if self._mfu_probed or self._probe_batch is None:
            return
        self._mfu_probed = True
        self._peak_flops = device_peak_flops(self.device)
        if self._peak_flops is None:
            return
        try:
            self._flops_per_step = program_flops(
                self.ts.make_probes(self.model.dropout_generator)["grads"],
                self._state, self._probe_batch)
        except RuntimeError:
            log.warning("MFU probe failed; mfu disabled", exc_info=True)
            self._peak_flops = None

    # ---------------------------------------------------- adaptive policy
    def _roofline_floor(self) -> Optional[float]:
        """The model's roofline floor priced on this device (on the card:
        on a card of this name), or None."""
        name = (torch.cuda.get_device_name(self.device)
                if self.device.type == "cuda" else None)
        return load_roofline_floor(self.cfg.dnn, self.device.type,
                                   device_name=name)

    def _policy_knobs(self) -> Dict[str, str]:
        """The knobs' values in the string form a PolicyDecision carries."""
        cfg = self.cfg
        size = "" if cfg.bucket_size is None else str(cfg.bucket_size)
        return {KNOB_COMPRESSOR: self.comp.name,
                KNOB_DENSITY: f"{cfg.density:g}",
                KNOB_WIRE: cfg.wire,
                KNOB_BUCKET: f"{cfg.bucket_policy}:{size}",
                KNOB_OVERLAP: cfg.overlap}

    def _apply_policy(self, decision) -> None:
        """Apply one PolicyDecision at the boundary: set the knob, rebuild
        the compressor or the plan where it needs them, then the step and
        the live state (:meth:`_rebuild_for_policy`)."""
        cfg = self.cfg
        knob, value = decision.knob, decision.new
        if knob == KNOB_COMPRESSOR:
            cfg.compressor = value
            self.comp = get_compressor(value, density=cfg.density,
                                       sigma_scale=cfg.sigma_scale)
        elif knob == KNOB_DENSITY:
            cfg.density = float(value)
            self.comp = get_compressor(cfg.compressor, density=cfg.density,
                                       sigma_scale=cfg.sigma_scale)
            # each bucket's k follows the density
            self.plan = plan_for_params(self.model.param_layout,
                                        cfg.density, cfg.bucket_size,
                                        policy=cfg.bucket_policy)
        elif knob == KNOB_WIRE:
            cfg.wire = value
        elif knob == KNOB_OVERLAP:
            cfg.overlap = value
        elif knob == KNOB_BUCKET:
            pol, _, size = value.partition(":")
            cfg.bucket_policy = pol
            cfg.bucket_size = int(size) if size else None
            self.plan = plan_for_params(self.model.param_layout,
                                        cfg.density, cfg.bucket_size,
                                        policy=cfg.bucket_policy)
        else:
            raise ValueError(f"unknown policy knob {knob!r}")
        with self._span("policy_rebuild", knob=knob):
            self._rebuild_for_policy()

    def _rebuild_for_policy(self) -> None:
        """Rebuild the step for the retuned knobs and carry the live state
        across. The flat length may change (the fused EF path pads to the
        kernel's blocks, the unfused one does not): the parameter, the
        optimizer's vectors and the EF row keep their first n entries bit
        for bit and get a zero tail. The step and the BatchNorm statistics
        carry over; a stateful compressor's thresholds start fresh, as in
        the reference (they priced another selector or plan)."""
        old = self._state
        old_numel = old.params.numel()
        self._build_step()
        numel, n = self.ts.ef_numel, self.plan.total_numel

        def moved(x: torch.Tensor) -> torch.Tensor:
            if x.dim() == 0 or numel == old_numel:
                return x
            out = torch.zeros(numel, dtype=x.dtype, device=x.device)
            out[:n] = x[:n]
            return out

        fresh = self.ts.init_state(old.carry)
        fresh.step = old.step
        fresh.opt_state = {k: moved(v) for k, v in old.opt_state.items()}
        fresh.ef_residual = moved(old.ef_residual)
        self.state = fresh          # the setter: a new trajectory

    def _agreed(self, kind: Optional[str], decision):
        """Rank 0's ``(kind, decision)`` on every rank: the engine of each
        rank sees its own step times, so rank 0's alone decides and the
        choice is broadcast (every rank must build the same step)."""
        if self.world == 1:
            return kind, decision
        import torch.distributed as dist
        dev = (self.device if dist.get_backend() == "nccl"
               else torch.device("cpu"))
        box = [(kind, decision)]
        dist.broadcast_object_list(box, src=0, device=dev)
        return box[0]

    def _policy_tick(self, rollback_pending: bool) -> None:
        """One boundary tick of the closed loop: the probation watchdog
        first (a bad decision reverts before any rollback runs), then, when
        nothing reverted and no rollback is pending, the next decision.
        Rank 0's engine chooses; every rank applies the choice and notes it
        on its own engine. Every apply and revert seals a checkpoint (a
        revert with a rollback pending does not: the rollback restores
        one), so a later rollback has a target in the current layout."""
        eng = self.engine
        kind, decision = None, None
        if self.rank == 0:
            decision = eng.check_revert(rollback_pending=rollback_pending)
            if decision is not None:
                kind = "revert"
            elif not rollback_pending:
                decision = eng.decide()
                kind = "apply" if decision is not None else None
        kind, decision = self._agreed(kind, decision)
        if kind is None:
            return
        with self._span("policy_apply", knob=decision.knob,
                        reason=decision.reason):
            self._apply_policy(decision)
        if kind == "revert":
            eng.note_reverted(decision)
            log.warning("policy revert %s: %s -> %s (%s)", decision.knob,
                        decision.old, decision.new, decision.reason)
            if not rollback_pending:
                self.save_checkpoint()
            return
        eng.note_applied(decision)
        log.info("policy decision [%s] %s: %s -> %s (%s)", decision.rule,
                 decision.knob, decision.old, decision.new, decision.reason)
        self.save_checkpoint()

    def _on_elastic_restore(self, old_p: int, new_p: int) -> None:
        """The checkpoint being restored was written at another worker
        count: log it, and drop the policy engine's signals that describe
        the old geometry (step times, arm records, bytes a step, the EF
        pressure window: ``PolicySignals.reset_for_geometry``)."""
        log.info("elastic restore: written by %d worker(s), resuming at %d; "
                 "EF mass redistributed, carry reset, geometry-derived "
                 "policy signals dropped", old_p, new_p)
        if self.engine is not None:
            self.engine.signals.reset_for_geometry(new_p)

    def _rollback(self, reason: str) -> None:
        """Restore the newest good checkpoint from before the anomaly (the
        newest of all, with a warning, when none precedes it), scale the
        learning rate by ``lr_backoff`` once more, and restart the stream
        at the restored step: the EF row, the optimizer state, the
        BatchNorm statistics, the dropout generator and the step rewind
        together."""
        anomaly = self.monitor.pending_since
        n = self.monitor.note_rollback()   # raises once the budget is spent
        kw = dict(generator=self.model.dropout_generator,
                  on_skip=self._log_restore_skip)
        try:
            try:
                path = restore_latest_good(self.ckpt_dir, self._state,
                                           self.ts.ef_numel,
                                           before_step=anomaly, **kw)
            except FileNotFoundError:
                if anomaly is None:
                    raise
                log.warning("rollback: no checkpoint precedes the anomaly "
                            "at step %d; restoring the newest sealed one",
                            anomaly)
                path = restore_latest_good(self.ckpt_dir, self._state,
                                           self.ts.ef_numel, **kw)
        except (FileNotFoundError, RuntimeError) as e:
            raise RuntimeError(
                f"rollback ({reason}) has no restorable checkpoint under "
                f"{self.ckpt_dir!r}: set save_every_steps so that a "
                f"rollback target exists") from e
        self.schedule.scale = self.monitor.lr_scale
        # the rewound steps' times belong to the abandoned trajectory
        self.tracker.reset()
        self.bus.publish({"event": "rollback", "reason": reason,
                          "rollback": n, "to_step": self.step,
                          "lr_scale": self.schedule.scale,
                          "checkpoint": path})
        log.warning("rollback #%d (%s): restored %s (step %d), lr_scale=%g",
                    n, reason, path, self.step, self.schedule.scale)
        self._new_trajectory()

    def _log_restore_skip(self, path: str, exc: Exception) -> None:
        log.warning("restore fallback: skipping %s (%s)", path, exc)
        self.bus.publish({"event": "restore_fallback", "checkpoint": path,
                          "error": f"{type(exc).__name__}: {exc}"})

    # ------------------------------------------------------------- eval
    @torch.no_grad()
    def test(self, epoch: Optional[int] = None) -> Dict[str, float]:
        """One eval pass over the test split (at most ``eval_max_batches``
        global batches; the ragged tail is dropped): each rank evaluates
        its rows, the sums are added over the workers, and the totals give
        ``val_loss`` and, where the task counts them, ``top1`` and ``top5``
        (for ``seq2seq``, ``top1`` is the masked token accuracy), plus
        ``perplexity = exp(min(val_loss, 30))`` for a language model and
        ``cer = edit sum / max(reference characters, 1)`` for ``ctc``. They
        are appended to the metrics file as an ``eval`` event with the
        examples (tokens, for a language model) counted and the pass's wall
        time. A recurrent model starts the pass from a zero carry and
        threads it through the test windows."""
        cap = self.cfg.eval_max_batches
        self._sync()
        t0 = time.perf_counter()
        carry = (self.model.initial_carry(self.eval_batch_size // self.world)
                 if self.recurrent else None)
        keys, sums = None, []
        for i, batch in enumerate(self.test_ds.epoch()):
            if cap is not None and i >= cap:
                break
            if self.recurrent:
                s, carry = self.eval_fn(self._to_device(batch), carry)
            else:
                s = self.eval_fn(self._to_device(batch))
            keys = keys or sorted(s)
            sums.append(all_reduce_sum(torch.stack([s[k] for k in keys])))
        # per-batch f32 sums, added on the host in batch order (float64)
        totals = dict.fromkeys(keys or ("loss_sum", "n"), 0.0)
        for row in (torch.stack(sums).tolist() if sums else []):
            for k, v in zip(keys, row):
                totals[k] += v
        eval_ms = (time.perf_counter() - t0) * 1e3
        n = max(totals["n"], 1.0)
        out = {"val_loss": totals["loss_sum"] / n}
        out.update({k: totals[k] / n for k in ("top1", "top5")
                    if k in totals})
        if "cer_edit_sum" in totals:
            out["cer"] = totals["cer_edit_sum"] / max(totals["cer_ref_sum"],
                                                      1.0)
        if self.spec.task == "lm":
            out["perplexity"] = math.exp(min(out["val_loss"], 30.0))
        self.bus.publish({"event": "eval", "step": self.step,
                          "epoch": self.epoch if epoch is None else epoch,
                          **out, "n": totals["n"], "eval_ms": eval_ms})
        if self.rank == 0:
            log.info("eval step %d: %s (n %d, %.1f ms)",
                     self.step, " ".join(f"{k}={v:.4f}"
                                         for k, v in out.items()),
                     totals["n"], eval_ms)
        return out

    def fit(self) -> Dict[str, float]:
        """The reference's epoch loop, from the current step up to
        ``total_steps``: ``train(min(steps_per_epoch, steps left))``, then
        an eval pass every ``eval_every_epochs`` epochs and a checkpoint
        every ``save_every_epochs`` (an epoch cut short by ``max_steps``
        counts as the epoch it ends in; no save while a rollback is
        pending), and one more checkpoint at the end. With
        ``handle_signals`` on the main thread, SIGTERM/SIGINT seal a
        checkpoint at the next step boundary and end the loop. Returns the
        last eval pass's values, plus ``preempted_at`` (the step) when the
        run was preempted."""
        cfg, result = self.cfg, {}
        install = (cfg.handle_signals
                   and threading.current_thread() is threading.main_thread())
        if install:
            self.shutdown.install()
        try:
            while self.step < self.total_steps:
                self.train(min(self.steps_per_epoch,
                               self.total_steps - self.step))
                ep = self.epoch
                if cfg.eval_every_epochs and ep % cfg.eval_every_epochs == 0:
                    result = self.test(ep)
                if (cfg.save_every_epochs and ep % cfg.save_every_epochs == 0
                        and (self.monitor is None
                             or self.monitor.should_rollback() is None)):
                    self.save_checkpoint()
            self.save_checkpoint()
        except TrainingPreempted as e:
            log.warning("training preempted at step %d (checkpoint %s)",
                        e.step, e.ckpt_path)
            result = {**result, "preempted_at": float(e.step)}
        finally:
            if install:
                self.shutdown.uninstall()
        return result

    def close(self) -> None:
        """Stop a live profiler trace and the prefetch thread, close the
        trajectory span and the health endpoint, then the bus (its
        exporters flush) and the run's log file."""
        if self.profiler is not None:
            self.profiler.close(self.step)
        self._invalidate_data_iter()
        if self.trace is not None:
            if self._traj_span is not None:
                self.trace.end(self._traj_span)
                self._traj_span = None
            self.trace.uninstall()
        if self._health_server is not None:
            self._health_server.close()
            self._health_server = None
        self.bus.close()
        self._steps.close()
        close_log_file(self.logger)

    # ------------------------------------------------------- checkpoints
    def save_checkpoint(self) -> str:
        """Seal a checkpoint of the current step under ``ckpt_dir`` (every
        rank calls it); a step this trajectory already saved is a no-op,
        one it reaches first overwrites an older trajectory's. Appends a
        ``checkpoint`` event with its bytes and the save's wall time, then
        applies ``keep_checkpoints``."""
        step = self.step
        fresh = step not in self._saved_steps
        with self._span("checkpoint_save", step=step):
            self._sync()
            t0 = time.perf_counter()
            path = save_checkpoint(self.ckpt_dir, self._state,
                                   self.plan.total_numel,
                                   generator=self.model.dropout_generator,
                                   overwrite=fresh)
            save_ms = (time.perf_counter() - t0) * 1e3
            self._saved_steps.add(step)
            if fresh:
                self.bus.publish({"event": "checkpoint", "step": step,
                                  "path": path,
                                  "bytes": checkpoint_bytes(path),
                                  "save_ms": save_ms})
            if self.rank == 0 and self.cfg.keep_checkpoints:
                for removed in gc_checkpoints(self.ckpt_dir,
                                              self.cfg.keep_checkpoints):
                    log.info("checkpoint GC: removed %s", removed)
        return path

    def _resume(self, where: str) -> None:
        """Resume from ``where``: an explicit ``step_XXXXXXXX`` directory
        is trusted as given (a damaged one raises); any other directory
        resumes from its newest checkpoint that restores, or starts cold
        when it holds none."""
        t0 = time.perf_counter()
        kw = dict(generator=self.model.dropout_generator,
                  on_elastic=self._on_elastic_restore)
        if os.path.basename(os.path.normpath(where)).startswith("step_"):
            restore_checkpoint(where, self._state, self.ts.ef_numel, **kw)
            path = where
        else:
            try:
                path = restore_latest_good(
                    where, self._state, self.ts.ef_numel,
                    on_skip=self._log_restore_skip, **kw)
            except FileNotFoundError:
                log.info("no checkpoint under %s: starting cold", where)
                return
        self._new_trajectory()
        self._sync()
        restore_ms = (time.perf_counter() - t0) * 1e3
        self.bus.publish({"event": "restore", "step": self.step,
                          "path": os.path.abspath(path),
                          "restore_ms": restore_ms})
        log.info("resumed from %s (step %d)", path, self.step)
