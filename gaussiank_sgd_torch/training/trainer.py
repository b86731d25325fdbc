"""Trainer — a minimal host loop (port of the training path of
``gaussiank_sgd_tpu/training/trainer.py``).

It builds the dataset, the model, the compressor, the bucket plan, the
schedule and the flat optimizer, then runs dense steps for the first
``compress_warmup_steps`` steps and sparse steps after. Every step appends
one JSON line to ``<output_dir>/<run_id>/metrics.jsonl`` (rank 0 only):
loss and acc (worker means), num_selected (beside k), bytes_sent, and the
step's wall time in ms, taken around work that ends in a device
synchronise.

One process is one worker. Under ``torchrun`` every process joins the
process group from its environment (``parallel/mesh.py``), and
``nworkers`` must equal the world size. Every rank draws the same seeded
global batch of ``batch_size * nworkers`` rows and takes its own rows, as
the reference's dp sharding does; each rank's dropout generator is seeded
from (seed, rank).
"""

from __future__ import annotations

import json
import logging
import os
import time
from typing import Dict, List

import numpy as np
import torch

from ..compressors import get_compressor
from ..data import make_dataset
from ..device import resolve_device
from ..models import get_model
from ..parallel.bucketing import plan_for_params
from ..parallel.collectives import rank, world_size
from ..parallel.flat_opt import FlatSGDM
from ..parallel.mesh import maybe_initialize_distributed, shard_batch
from ..parallel.trainstep import DPTrainStep, flat_numel
from .config import TrainConfig
from .losses import IMAGENET_NORM, make_loss_fn
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

        self.train_ds, card = make_dataset(
            cfg.dataset, cfg.data_dir, train=True,
            batch_size=cfg.global_batch_size, seed=cfg.seed)
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
                              wire=cfg.wire)
        self.state = self.ts.init_state()
        self._batches = iter(self.train_ds)
        log.info("model=%s params=%d compressor=%s density=%g buckets=%d "
                 "k_total=%d device=%s rank=%d/%d wire=%s steps=%d "
                 "overlap=%s: sequential (pipeline not ported)", cfg.dnn,
                 self.plan.total_numel, self.comp.name, cfg.density,
                 len(self.plan.buckets), self.plan.total_k, self.device,
                 self.rank, self.world, self.ts.wire_format,
                 self.total_steps, cfg.overlap)

    def in_warmup(self, step: int) -> bool:
        return self.is_dense_only or step < self.cfg.compress_warmup_steps

    def next_batch(self):
        x, y = shard_batch(next(self._batches), self.rank, self.world)
        return (torch.from_numpy(x).to(self.device),
                torch.from_numpy(y).to(self.device))

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def train(self, num_iters: int) -> List[Dict]:
        """Run ``num_iters`` steps; returns (and appends to the JSONL file)
        one record per step."""
        if self.rank == 0:
            os.makedirs(self.run_dir, exist_ok=True)
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
            if self.rank != 0:
                continue
            with open(self.metrics_path, "a") as f:
                f.write(json.dumps(rec) + "\n")
            if (step + 1) % self.cfg.log_every == 0:
                log.info("step %d %s loss=%.4f acc=%.3f sel=%d %.1f ms",
                         step + 1, kind, rec["loss"], rec["acc"],
                         rec["num_selected"], step_ms)
        return records

    def fit(self) -> List[Dict]:
        """Train up to ``total_steps``."""
        return self.train(max(0, self.total_steps - self.state.step))
