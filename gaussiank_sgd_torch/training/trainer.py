"""Trainer — the host loop (port of the training path of
``gaussiank_sgd_tpu/training/trainer.py``).

It builds the datasets, the model, the compressor, the bucket plan, the
schedule and the flat optimizer, then runs dense steps for the first
``compress_warmup_steps`` steps and sparse steps after. Every step appends
one JSON line to ``<output_dir>/<run_id>/metrics.jsonl`` (rank 0 only):
loss and acc (worker means), num_selected (beside k), bytes_sent, and the
step's wall time in ms, taken around work that ends in a device
synchronise. Eval passes, checkpoints and restores add ``{"event": ...}``
lines to the same file.

One process is one worker. Under ``torchrun`` every process joins the
process group from its environment (``parallel/mesh.py``), and
``nworkers`` must equal the world size. Every rank draws the same global
batch of ``batch_size * nworkers * nsteps_update`` rows from the epoch
stream (``data/loader.py:EpochStream``: epoch e shuffled with ``seed +
e``, aligned to the step, so a resumed run draws what the uninterrupted
one would) and takes its own rows, as the reference's dp sharding does;
each rank's dropout generator is seeded from (seed, rank).
"""

from __future__ import annotations

import json
import logging
import os
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from ..compressors import get_compressor
from ..data import EpochStream, make_dataset
from ..device import resolve_device
from ..models import get_model
from ..parallel.bucketing import plan_for_params
from ..parallel.collectives import all_reduce_sum, rank, world_size
from ..parallel.flat_opt import FlatSGDM
from ..parallel.mesh import maybe_initialize_distributed, shard_batch
from ..parallel.trainstep import DPTrainStep, flat_numel
from .checkpoint import (checkpoint_bytes, gc_checkpoints,
                         restore_checkpoint, restore_latest_good,
                         save_checkpoint)
from .config import TrainConfig
from .losses import IMAGENET_NORM, make_eval_fn, make_loss_fn
from .lr_schedule import warmup_milestone_schedule

log = logging.getLogger(__name__)

_DTYPES = {"bfloat16": torch.bfloat16, "bf16": torch.bfloat16,
           "float32": torch.float32, "fp32": torch.float32}


class Trainer:
    def __init__(self, cfg: TrainConfig):
        self.cfg = cfg
        self.device = maybe_initialize_distributed(
            resolve_device(cfg.device))
        self.rank, self.world = rank(), world_size()
        if cfg.nworkers != self.world:
            raise ValueError(
                f"nworkers={cfg.nworkers} but the world size is "
                f"{self.world}: run one process a worker, e.g. torchrun "
                f"--standalone --nproc-per-node {cfg.nworkers} -m "
                f"gaussiank_sgd_torch.train ...")
        if cfg.compute_dtype not in _DTYPES:
            raise ValueError(f"unknown compute_dtype {cfg.compute_dtype!r}")
        if cfg.overlap not in ("auto", "off"):
            raise ValueError(f"unknown overlap {cfg.overlap!r}")
        self.run_dir = os.path.join(cfg.output_dir, cfg.run_id)
        self.metrics_path = os.path.join(self.run_dir, "metrics.jsonl")
        self.ckpt_dir = os.path.join(self.run_dir, "ckpt")

        # as the reference builds them: no seed (the augmentation stream
        # starts at default_rng(0); the epoch stream shuffles with the
        # run's seed), the eval batch without the microbatch factor
        self.train_ds, card = make_dataset(
            cfg.dataset, cfg.data_dir, train=True,
            batch_size=cfg.global_batch_size)
        self.eval_batch_size = max(cfg.nworkers,
                                   cfg.batch_size * cfg.nworkers)
        self.test_ds, _ = make_dataset(cfg.dataset, cfg.data_dir,
                                       train=False,
                                       batch_size=self.eval_batch_size)
        model_kw = {"num_classes": cfg.num_classes or card,
                    "dtype": _DTYPES[cfg.compute_dtype], **cfg.model_kwargs}
        self.spec = get_model(cfg.dnn, cfg.dataset, device=self.device,
                              seed=cfg.seed, **model_kw)
        self.model = self.spec.module
        if self.world > 1:
            self.model.dropout_generator.manual_seed(int(
                np.random.SeedSequence([cfg.seed, self.rank])
                .generate_state(1, np.uint64)[0] >> 1))
        self.steps_per_epoch = self.train_ds.steps_per_epoch
        self.total_steps = (cfg.max_steps if cfg.max_steps
                            else cfg.epochs * self.steps_per_epoch)

        self.comp = get_compressor(cfg.compressor, density=cfg.density)
        self.is_dense_only = self.comp.name == "none"
        self.plan = plan_for_params(self.model.param_layout, cfg.density,
                                    cfg.bucket_size, policy=cfg.bucket_policy)
        self.model.pad_flat(flat_numel(self.comp, self.plan))
        self.schedule = warmup_milestone_schedule(
            cfg.lr, cfg.nworkers, self.steps_per_epoch, self.total_steps,
            cfg.warmup_epochs, cfg.lr_milestones, cfg.lr_decay)
        # wd on the exchanged gradient before momentum (torch SGD order);
        # with momentum and wd both 0 this is plain SGD, as the reference's
        # optax path computes it
        flat_opt = FlatSGDM(lr=self.schedule, momentum=cfg.momentum or 0.0,
                            weight_decay=cfg.weight_decay or 0.0)
        # uint8 ImageNet batches are normalised on the device, in the loss
        input_norm = (IMAGENET_NORM if cfg.dataset.lower() == "imagenet"
                      else None)
        self.ts = DPTrainStep(make_loss_fn(self.model, self.spec.task,
                                           input_norm),
                              self.model.flat, {"stats": self.model.stats},
                              self.comp, self.plan, flat_opt=flat_opt,
                              wire=cfg.wire,
                              num_microbatches=cfg.nsteps_update,
                              clip_norm=cfg.clip_norm)
        self.eval_fn = make_eval_fn(self.model, self.spec.task, input_norm)
        self.state = self.ts.init_state()
        self._stream = None               # built at the first batch
        # steps this trajectory has saved: a step first reached on it
        # overwrites a sealed directory an older trajectory left there
        self._saved_steps = set()
        if cfg.resume:
            self._resume(cfg.resume)
        log.info("model=%s params=%d compressor=%s density=%g buckets=%d "
                 "k_total=%d device=%s rank=%d/%d wire=%s steps=%d "
                 "overlap=%s: sequential (pipeline not ported)", cfg.dnn,
                 self.plan.total_numel, self.comp.name, cfg.density,
                 len(self.plan.buckets), self.plan.total_k, self.device,
                 self.rank, self.world, self.ts.wire_format,
                 self.total_steps, cfg.overlap)

    def in_warmup(self, step: int) -> bool:
        return self.is_dense_only or step < self.cfg.compress_warmup_steps

    @property
    def epoch(self) -> int:
        return self.state.step // self.steps_per_epoch

    def next_batch(self):
        """This rank's rows of the next global batch, on the device."""
        if self._stream is None:
            self._stream = EpochStream(self.train_ds, self.cfg.seed,
                                       self.state.step)
        return self._to_device(next(self._stream))

    def _to_device(self, batch):
        x, y = shard_batch(batch, self.rank, self.world)
        return (torch.from_numpy(x).to(self.device),
                torch.from_numpy(y).to(self.device))

    def _event(self, rec: Dict) -> None:
        """Append one line to the metrics file (rank 0)."""
        if self.rank != 0:
            return
        os.makedirs(self.run_dir, exist_ok=True)
        with open(self.metrics_path, "a") as f:
            f.write(json.dumps(rec) + "\n")

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def train(self, num_iters: int) -> List[Dict]:
        """Run ``num_iters`` steps; returns (and appends to the JSONL file)
        one record per step."""
        records = []
        for _ in range(num_iters):
            batch = self.next_batch()
            step = self.state.step
            kind = "dense" if self.in_warmup(step) else "sparse"
            fn = self.ts.dense_step if kind == "dense" else self.ts.sparse_step
            self._sync()
            t0 = time.perf_counter()
            m = fn(self.state, batch)
            self._sync()
            step_ms = (time.perf_counter() - t0) * 1e3
            rec = {"step": step + 1, "kind": kind,
                   "loss": float(m.loss), "acc": float(m.aux["acc"]),
                   "num_selected": float(m.num_selected),
                   "k": self.plan.total_k if kind == "sparse"
                   else self.plan.total_numel,
                   "bytes_sent": m.bytes_sent, "skipped": float(m.skipped),
                   "step_ms": step_ms}
            records.append(rec)
            self._event(rec)
            if self.rank == 0 and (step + 1) % self.cfg.log_every == 0:
                log.info("step %d %s loss=%.4f acc=%.3f sel=%d %.1f ms",
                         step + 1, kind, rec["loss"], rec["acc"],
                         rec["num_selected"], step_ms)
            if (self.cfg.save_every_steps
                    and (step + 1) % self.cfg.save_every_steps == 0):
                self.save_checkpoint()
        return records

    @torch.no_grad()
    def test(self, epoch: Optional[int] = None) -> Dict[str, float]:
        """One eval pass over the test split (at most ``eval_max_batches``
        global batches; the ragged tail is dropped): each rank evaluates
        its rows, the sums are added over the workers, and the totals give
        ``val_loss``, ``top1`` and ``top5``, also appended to the metrics
        file as an ``eval`` event with the images counted and the pass's
        wall time."""
        cap = self.cfg.eval_max_batches
        self._sync()
        t0 = time.perf_counter()
        sums = []
        for i, batch in enumerate(self.test_ds.epoch()):
            if cap is not None and i >= cap:
                break
            s = self.eval_fn(self._to_device(batch))
            sums.append(all_reduce_sum(torch.stack(
                [s["loss_sum"], s["top1"], s["top5"], s["n"]])))
        # per-batch f32 sums, added on the host in batch order (float64)
        totals = [0.0] * 4
        for row in (torch.stack(sums).tolist() if sums else []):
            totals = [a + b for a, b in zip(totals, row)]
        eval_ms = (time.perf_counter() - t0) * 1e3
        n = max(totals[3], 1.0)
        out = {"val_loss": totals[0] / n, "top1": totals[1] / n,
               "top5": totals[2] / n}
        self._event({"event": "eval", "step": self.state.step,
                     "epoch": self.epoch if epoch is None else epoch,
                     **out, "n": totals[3], "eval_ms": eval_ms})
        if self.rank == 0:
            log.info("eval step %d: %s (%d images, %.1f ms)",
                     self.state.step, " ".join(f"{k}={v:.4f}"
                                               for k, v in out.items()),
                     totals[3], eval_ms)
        return out

    def fit(self) -> List[Dict]:
        """The reference's epoch loop, from the current step up to
        ``total_steps``: ``train(min(steps_per_epoch, steps left))``, then
        an eval pass every ``eval_every_epochs`` epochs and a checkpoint
        every ``save_every_epochs`` (an epoch cut short by ``max_steps``
        counts as the epoch it ends in), and one more checkpoint at the end.
        Returns every step's record. The reference's signal handler
        (checkpoint, then exit on SIGTERM) and its rollback monitor are not
        ported yet (ROADMAP A item 10)."""
        cfg, records = self.cfg, []
        while self.state.step < self.total_steps:
            records += self.train(min(self.steps_per_epoch,
                                      self.total_steps - self.state.step))
            ep = self.epoch
            if cfg.eval_every_epochs and ep % cfg.eval_every_epochs == 0:
                self.test(ep)
            if cfg.save_every_epochs and ep % cfg.save_every_epochs == 0:
                self.save_checkpoint()
        self.save_checkpoint()
        return records

    # ------------------------------------------------------- checkpoints
    def save_checkpoint(self) -> str:
        """Seal a checkpoint of the current step under ``ckpt_dir`` (every
        rank calls it); a step this trajectory already saved is a no-op,
        one it reaches first overwrites an older trajectory's. Appends a
        ``checkpoint`` event with its bytes and the save's wall time, then
        applies ``keep_checkpoints``."""
        step = self.state.step
        fresh = step not in self._saved_steps
        self._sync()
        t0 = time.perf_counter()
        path = save_checkpoint(self.ckpt_dir, self.state,
                               self.plan.total_numel,
                               generator=self.model.dropout_generator,
                               overwrite=fresh)
        save_ms = (time.perf_counter() - t0) * 1e3
        self._saved_steps.add(step)
        if fresh:
            self._event({"event": "checkpoint", "step": step, "path": path,
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
                  on_elastic=lambda old, new: log.info(
                      "elastic restore: written by %d worker(s), resuming "
                      "at %d; EF mass redistributed", old, new))
        if os.path.basename(os.path.normpath(where)).startswith("step_"):
            restore_checkpoint(where, self.state, self.ts.ef_numel, **kw)
            path = where
        else:
            try:
                path = restore_latest_good(
                    where, self.state, self.ts.ef_numel,
                    on_skip=lambda p, e: log.warning(
                        "restore fallback: skipping %s (%s)", p, e), **kw)
            except FileNotFoundError:
                log.info("no checkpoint under %s: starting cold", where)
                return
        self._sync()
        restore_ms = (time.perf_counter() - t0) * 1e3
        self._event({"event": "restore", "step": self.state.step,
                     "path": os.path.abspath(path),
                     "restore_ms": restore_ms})
        log.info("resumed from %s (step %d)", path, self.state.step)
