"""Run configuration (trimmed port of
``gaussiank_sgd_tpu/training/config.py``).

One dataclass, read from the same ``exp_configs/*.json`` files as the
reference. Keys this port does not carry are ignored with a logged note;
flags given on the command line override the file.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import logging
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

log = logging.getLogger(__name__)


@dataclass
class TrainConfig:
    # model / data
    dnn: str = "vgg16"
    dataset: str = "cifar10"
    data_dir: Optional[str] = None          # None/'synthetic' -> synthetic
    num_classes: Optional[int] = None
    batch_size: int = 32                    # per worker
    nworkers: int = 1                       # must equal the world size
                                            # (one process a worker)

    # optimization (reference SGD defaults)
    lr: float = 0.1
    momentum: float = 0.9
    weight_decay: float = 5e-4
    epochs: int = 90
    max_steps: Optional[int] = None         # hard cap (overrides epochs)
    lr_milestones: Tuple[float, ...] = (0.5, 0.75)
    lr_decay: float = 0.1
    warmup_epochs: float = 5.0

    # compression
    compressor: str = "none"
    density: float = 0.001
    compress_warmup_steps: int = 0          # dense steps before sparse ones
    bucket_size: Optional[int] = None       # None=whole-model, 0=per-tensor
    bucket_policy: str = "greedy"           # 'greedy' (tensor-boundary merge)
                                            # | 'uniform' (equal chunks)
    wire: str = "auto"                      # 'auto' (u16|bf16 words where
                                            # the plan allows) | 'off'
    overlap: str = "auto"                   # read and logged: the step is
                                            # sequential (pipeline not
                                            # ported; the reference's is
                                            # bit-identical to it)

    # numerics and device
    compute_dtype: str = "bfloat16"
    seed: int = 42
    device: str = "cuda"                    # 'cpu' only when asked

    # escape hatch: extra kwargs for get_model (e.g. a narrow ``cfg``)
    model_kwargs: dict = field(default_factory=dict)

    # io
    run_id: str = "run"
    output_dir: str = "./runs"
    log_every: int = 10

    @property
    def global_batch_size(self) -> int:
        return self.batch_size * max(1, self.nworkers)


def add_args(p: argparse.ArgumentParser,
             suppress_defaults: bool = False) -> None:
    """CLI flags named as in the reference entry point. With
    ``suppress_defaults`` a parse shows exactly which flags were typed."""
    d = TrainConfig()

    def add(*a, **kw):
        if suppress_defaults:
            kw["default"] = argparse.SUPPRESS
        p.add_argument(*a, **kw)

    add("--dnn", default=d.dnn)
    add("--dataset", default=d.dataset)
    add("--data-dir", dest="data_dir", default=d.data_dir)
    add("--num-classes", dest="num_classes", type=int, default=None)
    add("--batch-size", dest="batch_size", type=int, default=d.batch_size,
        help="per-worker batch size")
    add("--nworkers", type=int, default=d.nworkers,
        help="workers, one process each; must equal the world size "
             "(torchrun --nproc-per-node)")
    add("--lr", type=float, default=d.lr)
    add("--momentum", type=float, default=d.momentum)
    add("--weight-decay", dest="weight_decay", type=float,
        default=d.weight_decay)
    add("--epochs", type=int, default=d.epochs)
    add("--max-steps", dest="max_steps", type=int, default=None)
    add("--lr-milestones", dest="lr_milestones", type=float, nargs="*",
        default=d.lr_milestones)
    add("--lr-decay", dest="lr_decay", type=float, default=d.lr_decay)
    add("--warmup-epochs", dest="warmup_epochs", type=float,
        default=d.warmup_epochs)
    add("--compressor", default=d.compressor,
        help="none | gaussian | gaussian_warm | gaussian_pallas | "
             "gaussian_fused | auto (the default selector, gaussian_fused)")
    add("--density", type=float, default=d.density)
    add("--bucket-size", dest="bucket_size", type=int, default=None,
        help="elements per bucket: unset = one whole-model bucket, 0 = one "
             "per tensor")
    add("--bucket-policy", dest="bucket_policy",
        choices=("greedy", "uniform"), default=d.bucket_policy,
        help="greedy merges whole tensors until a bucket holds at least "
             "--bucket-size elements; uniform cuts equal --bucket-size "
             "chunks across tensors")
    add("--wire", choices=("auto", "off"), default=d.wire,
        help="auto: the packed u16|bf16 wire where the bucket plan allows "
             "it; off: (i32, f32) pairs")
    add("--compress-warmup-steps", dest="compress_warmup_steps", type=int,
        default=d.compress_warmup_steps)
    add("--compute-dtype", dest="compute_dtype", default=d.compute_dtype)
    add("--seed", type=int, default=d.seed)
    add("--device", default=d.device, choices=("cuda", "cpu"))
    add("--model-kwargs", dest="model_kwargs", type=json.loads, default={},
        help='JSON, e.g. \'{"cfg": [8, "M"], "dropout": 0.0}\'')
    add("--run-id", dest="run_id", default=d.run_id)
    add("--output-dir", dest="output_dir", default=d.output_dir)
    add("--log-every", dest="log_every", type=int, default=d.log_every)
    add("--config", dest="config", default=None,
        help="JSON config file (exp_configs/*.json); flags typed on the "
             "command line override it")


def from_args(args: argparse.Namespace,
              argv: Optional[List[str]] = None) -> TrainConfig:
    """TrainConfig from parsed args. Precedence: defaults < ``--config``
    file < flags present in ``argv``."""
    fields = {f.name for f in dataclasses.fields(TrainConfig)}

    def _detuple(d: dict) -> dict:
        return {k: tuple(v) if isinstance(v, list) else v
                for k, v in d.items()}

    base = _detuple({k: v for k, v in vars(args).items() if k in fields})
    cfg_path = getattr(args, "config", None)
    if not cfg_path:
        return TrainConfig(**base)
    if argv is None:
        raise ValueError("--config precedence needs the argv parse_args saw")
    with open(cfg_path) as f:
        file_vals = json.load(f)
    file_vals = {k: v for k, v in file_vals.items() if not k.startswith("_")}
    unknown = sorted(set(file_vals) - fields)
    if unknown:
        log.info("%s: ignoring keys this port does not carry: %s", cfg_path,
                 ", ".join(unknown))
    explicit_p = argparse.ArgumentParser()
    add_args(explicit_p, suppress_defaults=True)
    explicit, _ = explicit_p.parse_known_args(argv)
    merged = dict(base)
    merged.update(_detuple({k: v for k, v in file_vals.items()
                            if k in fields}))
    merged.update(_detuple({k: v for k, v in vars(explicit).items()
                            if k in fields}))
    return TrainConfig(**merged)
