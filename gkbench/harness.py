"""One run of a cell: set-up, the checked first steps, warm-up, the timed
window over ``Trainer.train``, the per-layer trace, and the comparison
with the reference. ``run.py`` is the command; ``worker.py`` runs the
ranks past 0 of a cell on several chips.

Each rank is one process and one card, as ``torchrun`` would start them:
rank r builds its own ``Trainer`` on ``cuda:r`` over NCCL, joined at
``tcp://localhost:<port>``. Every rank is handed the same global batches
and takes its rows. Rank 0 times the window, gathers the other ranks'
numbers, runs the reference and returns the result.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import os
import shutil
import sys
import tempfile
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import torch

from . import check, flops, layers, manifest, reference, trace, traffic
from .reference import sgd
from .seeds import derive
from .weights import make_weights

# seconds of whole log intervals under the profiler: steps enough for the
# layers' device ms, while most of the window runs untraced
PROFILE_S = 1.0
FORBIDDEN = ("jax", "jaxlib", "flax", "gaussiank_sgd_tpu")


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is one the benchmark must never
    load."""
    return sorted({m.split(".", 1)[0] for m in sys.modules
                   if m.split(".", 1)[0] in FORBIDDEN})


@dataclass
class Context:
    """What a metric reader reads (``metrics/<name>.py``)."""

    setup_s: float
    window_s: float
    steps: int
    skipped: int
    global_batch: int
    walls_s: List[float]            # each window step's wall, in order
    step_ms: List[float]            # the trainer's step_ms of each
    data_wait_ms: List[float] = field(default_factory=list)
    # the steps before the profiled stretch (all of them untraced), and
    # their seconds: what the host's per-layer numbers are read from
    outside: List[int] = field(default_factory=list)
    outside_s: float = 0.0
    stretch_steps: int = 0
    summary: Optional[trace.Summary] = None
    flops_per_step: Optional[float] = None
    peaks: Optional[Tuple[float, float]] = None
    n: int = 0
    k: int = 0
    setup_phases: List[Tuple[str, float]] = field(default_factory=list)


class _Stamped(list):
    """The trainer's ``records`` list, stamping each step's completion on
    the host clock."""

    def __init__(self):
        super().__init__()
        self.at: List[float] = []

    def append(self, rec):
        self.at.append(time.perf_counter())
        super().append(rec)


class _Spans:
    """A bus exporter keeping the ``data_wait`` spans, stamped when they
    close."""

    def __init__(self):
        self.data_wait: List[Tuple[float, float]] = []

    def emit(self, rec):
        if rec.get("event") == "span" and rec.get("name") == "data_wait":
            self.data_wait.append((time.perf_counter(), rec["dur_ms"]))

    def flush(self):
        return None

    def close(self):
        return None


def reference_model(config: Dict) -> sgd.Model:
    """The reference of a configuration, by its ``architecture.model``
    (``reference/<model>.py``)."""
    return reference.build(config["architecture"])


def hyper(cell: manifest.Cell) -> sgd.Hyper:
    t = cell.config["train"]
    return sgd.Hyper(
        lr=t["lr"], momentum=t["momentum"], weight_decay=t["weight_decay"],
        density=t["density"], workers=cell.chips,
        warmup_epochs=t["warmup_epochs"],
        steps_per_epoch=(cell.config.get("data_files") or t[
            "dataset_kwargs"]["synthetic_examples"]) // cell.global_batch,
        total_steps=t["max_steps"], milestones=tuple(t["lr_milestones"]),
        lr_decay=t["lr_decay"])


def train_config(cell: manifest.Cell, seed: int, device: str,
                 output_dir: str, traced: bool,
                 data_dir: Optional[str] = None):
    from gaussiank_sgd_torch.training.config import TrainConfig
    fields = {f.name for f in dataclasses.fields(TrainConfig)}
    train = cell.config["train"]
    unknown = sorted(set(train) - fields)
    if unknown:
        raise ValueError(f"{cell.config_name}: TrainConfig has no {unknown}")
    kw = {k: tuple(v) if isinstance(v, list) else v for k, v in train.items()}
    kw.update(nworkers=cell.chips, seed=int(seed), device=device,
              output_dir=output_dir, run_id=cell.name,
              trace="on" if traced else "off")
    if data_dir is not None:
        kw["data_dir"] = data_dir
    return TrainConfig(**kw)


@dataclass
class Program:
    """One rank's part of a run: what its first steps computed, and the
    window's numbers."""

    steps: sgd.Steps
    local: Dict[str, Any]          # numbers gathered at rank 0
    ctx: Context


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _broadcast(values: List[float], dev: torch.device,
               world: int) -> List[float]:
    """Rank 0's ``values`` on every rank."""
    if world == 1:
        return values
    import torch.distributed as dist
    t = torch.tensor(values, dtype=torch.float64, device=dev)
    dist.broadcast(t, src=0)
    return t.tolist()


def build(cell: manifest.Cell, seed: int, dev: torch.device, rank: int,
          traced: bool, out_dir: str, data_dir: Optional[str] = None):
    """The trainer of this rank, on the benchmark's weights and dropout
    seed, with its records stamped, its spans collected and, traced, the
    layer ranges on its step."""
    from gaussiank_sgd_torch.training.trainer import Trainer
    model = reference_model(cell.config)
    trainer = Trainer(train_config(cell, seed, str(dev), out_dir, traced,
                                   data_dir))
    theirs = [(p, tuple(s)) for p, s in trainer.model.param_layout]
    if theirs != model.layout:
        raise RuntimeError(
            f"the program lays out {cell.config_name}'s parameters unlike "
            f"the reference ({len(theirs)} leaves against "
            f"{len(model.layout)}): the weights cannot be handed over")
    dropout = cell.config["architecture"].get("dropout", 0.0)
    if getattr(trainer.model, "dropout", 0.0) != dropout:
        raise RuntimeError(f"the program's dropout is not the stated "
                           f"{dropout}")
    n = sgd.models.numel(model.layout)
    with torch.no_grad():
        trainer.state.params.detach()[:n].copy_(
            make_weights(model.layout, seed, dev))
    if trainer.model.dropout_generator is not None:
        trainer.model.dropout_generator.manual_seed(
            derive(seed, "dropout", rank))
    trainer.records = _Stamped()
    spans = _Spans()
    trainer.bus.attach(spans)
    if traced:
        layers.install(trainer.ts)
    return trainer, model, spans


def checked_steps(trainer, feed, count: int, n: int) -> sgd.Steps:
    """The first ``count`` steps, through ``Trainer.train`` on the feed,
    with what the check compares taken from the program's state."""
    def copy(x):
        return x.detach()[:n].to("cpu", torch.float32, copy=True)

    trainer.train(1, feed)
    momentum1 = copy(trainer.state.opt_state["m"])
    residual1 = copy(trainer.state.ef_residual)
    trainer.train(count - 1, feed)
    params = copy(trainer.state.params)
    losses = [float(r["loss"]) for r in trainer.records[:count]]
    return sgd.Steps(losses, momentum1, residual1, None, params)


def _window(trainer, feed, seconds, traced, dev, world, out_dir):
    """The timed window: ``train`` in chunks of a log interval until
    ``seconds`` have passed, rank 0 deciding for all; traced, one stretch
    of whole log intervals under the profiler once two thirds have passed
    (the host's numbers are read before it: a profiler, once stopped, can
    leave each launch slower)."""
    every = trainer.cfg.log_every
    rec = trainer.records
    first = len(rec)
    stretch = None          # (first step, steps, profiler)
    plan = [0.0, 0.0]       # (stop, profile the next chunk: its length)
    t0 = time.perf_counter()
    while True:
        if plan[1]:
            steps = int(plan[1])
            activities = [torch.profiler.ProfilerActivity.CPU]
            if dev.type == "cuda":
                activities.append(torch.profiler.ProfilerActivity.CUDA)
            at = len(rec)
            with torch.profiler.profile(activities=activities) as prof:
                with torch.profiler.record_function(layers.WINDOW):
                    trainer.train(steps, feed)
            stretch = (at - first, steps, prof)
        else:
            trainer.train(every, feed)
        elapsed = time.perf_counter() - t0
        if rank_of() == 0:
            done = len(rec) - first
            stop = elapsed >= seconds
            want = traced and stretch is None and (
                stop or elapsed >= seconds * 2 / 3)
            length = 0.0
            if want:
                per_chunk = every * elapsed / max(done, 1)
                length = every * max(1, round(PROFILE_S / per_chunk))
                stop = False
            plan = [float(stop), length]
        plan = _broadcast(plan, dev, world)
        if plan[0]:
            break
    window_s = time.perf_counter() - t0
    summary = None
    if stretch is not None:
        path = os.path.join(out_dir, "trace.json")
        stretch[2].export_chrome_trace(path)
        summary = trace.summarize(trace.load(path), layers.WINDOW,
                                  layers.RANGES)
        os.remove(path)
    return first, t0, window_s, stretch, summary


def rank_of() -> int:
    import torch.distributed as dist
    return dist.get_rank() if dist.is_initialized() else 0


@contextlib.contextmanager
def _trainer(cell: manifest.Cell, seed: int, dev: torch.device, rank: int,
             traced: bool):
    """``build``'s trainer and its feed; on exit the trainer is closed and
    its memory freed, and its output directory removed."""
    out_dir = tempfile.mkdtemp(prefix=f"gkbench-{cell.name}-r{rank}-")
    trainer = None
    try:
        pool = traffic.make_pool(cell.traffic, seed, dev)
        data_dir = (traffic.generator(cell.traffic).write_split_files(
            pool, int(cell.config["data_files"]),
            os.path.join(out_dir, "data"))
            if "data_files" in cell.config else None)
        trainer, model, spans = build(cell, seed, dev, rank, traced,
                                      out_dir, data_dir)
        yield trainer, model, spans, traffic.cycle(pool), out_dir
    finally:
        if trainer is not None:
            trainer.close()
        del trainer
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        shutil.rmtree(out_dir, ignore_errors=True)


def first_steps(cell: manifest.Cell, seed: int, dev: torch.device,
                rank: int = 0) -> sgd.Steps:
    """The checked steps alone, as a run makes them (for ``calibrate``)."""
    with _trainer(cell, seed, dev, rank, False) as (trainer, model, _, feed,
                                                    _):
        return checked_steps(trainer, feed, int(cell.setup["checked_steps"]),
                             sgd.models.numel(model.layout))


def run_program(cell: manifest.Cell, seed: int, seconds: float,
                traced: bool, dev: torch.device, rank: int, world: int,
                t_start: float) -> Program:
    """This rank's part: set-up, the checked steps, warm-up and the
    window. The trainer is closed and freed before it returns."""
    phases = [("start", t_start), ("imports and device", time.time())]
    with _trainer(cell, seed, dev, rank, traced) as (
            trainer, model, spans, feed, out_dir):
        phases.append(("trainer, weights and traffic", time.time()))
        n = sgd.models.numel(model.layout)
        setup_steps = int(cell.setup["setup_steps"])
        prog = checked_steps(trainer, feed, int(cell.setup["checked_steps"]),
                             n)
        phases.append(("checked steps", time.time()))
        every = trainer.cfg.log_every
        while trainer.step < setup_steps:
            trainer.train(min(every - trainer.step % every,
                              setup_steps - trainer.step), feed)
        phases.append(("warm-up steps", time.time()))
        flops_per_step = None
        if traced:
            flops_per_step = flops.step_flops(
                model, traffic.generator(cell.traffic).input_spec(
                    cell.traffic, cell.config["train"]["batch_size"]))
        _sync(dev)
        if world > 1:
            import torch.distributed as dist
            dist.barrier()
        phases.append(("flop count and ranks ready", time.time()))
        setup_s = phases[-1][1] - t_start
        first, t0, window_s, stretch, summary = _window(
            trainer, feed, seconds, traced, dev, world, out_dir)
        rec = trainer.records
        at = [t0] + rec.at[first:]
        records = rec[first:]
        walls = [b - a for a, b in zip(at, at[1:])]
        before = range(stretch[0] if stretch else len(records))
        ctx = Context(
            setup_s=setup_s, window_s=window_s, steps=len(records),
            skipped=int(sum(r["skipped"] for r in records)),
            global_batch=cell.global_batch,
            walls_s=walls, step_ms=[r["step_ms"] for r in records],
            data_wait_ms=[d for t, d in spans.data_wait if t >= t0],
            outside=list(before), outside_s=sum(walls[i] for i in before),
            stretch_steps=stretch[1] if stretch else 0, summary=summary,
            flops_per_step=flops_per_step,
            peaks=flops.peaks(torch.cuda.get_device_name(dev)
                              if dev.type == "cuda" else None),
            n=n, k=flops.k_of(n, cell.config["train"]["density"]),
            setup_phases=[(b[0], b[1] - a[1])
                          for a, b in zip(phases, phases[1:])])
        local = {"memory_peak_bytes": (torch.cuda.max_memory_allocated(dev)
                                       if dev.type == "cuda" else 0),
                 "per_layer": (per_layer(cell, ctx) if traced else {}),
                 "busy_s": summary.busy_s if summary else None,
                 "window_s": summary.window_s if summary else None}
        return Program(prog, local, ctx)


def per_layer(cell: manifest.Cell, ctx: Context) -> Dict[str, float]:
    """This rank's per-layer numbers that its readers found."""
    out = {}
    for m in manifest.metrics_for(manifest.load_manifest(), cell.name,
                                  "per_layer"):
        value = manifest.reader(m["name"]).read(ctx)
        if value is not None:
            out[m["name"]] = float(value)
    return out


def reference_steps(cell: manifest.Cell, seed: int, dev: torch.device,
                    precision: str = "float32",
                    fault: Optional[str] = None) -> sgd.Steps:
    """The reference's first steps from the run's weights, batches and
    dropout seeds (``precision`` and ``fault``: the reference put in the
    program's place as the control, or broken)."""
    model = reference_model(cell.config)
    count = int(cell.setup["checked_steps"])
    pool = traffic.make_pool(dict(cell.traffic, pool_batches=count), seed,
                             dev)
    seeds = [derive(seed, "dropout", r) for r in range(cell.chips)]
    return sgd.run_steps(model, hyper(cell),
                         make_weights(model.layout, seed, dev), pool, seeds,
                         precision, fault)


def reference_numbers(cell: manifest.Cell, seed: int, dev: torch.device,
                      prog: Optional[sgd.Steps],
                      precision: str = "float32",
                      fault: Optional[str] = None,
                      ref: Optional[sgd.Steps] = None,
                      names=check.NUMBERS):
    """``(numbers, reference steps)``: ``names`` of ``check.py`` for the
    program's first steps (or, with ``prog`` None, the reference's at
    ``precision`` with ``fault``, put in its place) against the float32
    reference's."""
    model = reference_model(cell.config)
    if ref is None:
        ref = reference_steps(cell, seed, dev)
    if prog is None:
        prog = reference_steps(cell, seed, dev, precision, fault)
    p0 = make_weights(model.layout, seed, dev)
    return check.numbers(prog, ref, p0, model.layout, hyper(cell),
                         names), ref
