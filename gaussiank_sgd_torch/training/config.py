"""Run configuration (trimmed port of
``gaussiank_sgd_tpu/training/config.py``).

One dataclass, read from the same ``exp_configs/*.json`` files as the
reference; flags given on the command line override the file. A file key
of the reference that this port does not carry is refused, naming the
ROADMAP item that ports it, unless the file gives it the reference's
default, which changes nothing: then it is ignored with a logged note.
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
    nsteps_update: int = 1                  # gradient accumulation: each
                                            # worker step runs this many
                                            # microbatches of batch_size
    nworkers: int = 1                       # must equal the world size
                                            # (one process a worker); 0 =
                                            # the world size
    ici_size: int = 0                       # >0 with dcn_size: the
    dcn_size: int = 0                       # two-level (dcn, ici) layout
                                            # of ici_size * dcn_size
                                            # workers
    sp_size: int = 0                        # >1: ring-attention sequence
                                            # parallelism (transformer_lm),
                                            # a (dp, sp) layout of
                                            # nworkers * sp_size workers

    # optimization (reference SGD defaults)
    lr: float = 0.1
    momentum: float = 0.9
    weight_decay: float = 5e-4
    nesterov: bool = False
    epochs: int = 90
    max_steps: Optional[int] = None         # hard cap (overrides epochs)
    lr_milestones: Tuple[float, ...] = (0.5, 0.75)
    lr_decay: float = 0.1
    warmup_epochs: float = 5.0
    clip_norm: Optional[float] = None       # clip each worker's gradient
                                            # to this global L2 norm
    label_smoothing: float = 0.0            # seq2seq soft-target CE
    carry_hidden: bool = True               # lstm: carry (c, h) across
                                            # bptt windows

    # compression
    compressor: str = "none"
    density: float = 0.001
    sigma_scale: Optional[float] = None     # GaussianK: s of t0 = |mu| +
                                            # s * sigma (None: the tail
                                            # quantile of the density)
    compress_warmup_steps: int = 0          # dense steps before sparse ones
    fold_lr: bool = False                   # EF accumulates lr(step) * g;
                                            # the optimizer runs at lr 1
    bucket_size: Optional[int] = None       # None=whole-model, 0=per-tensor
    bucket_policy: str = "greedy"           # 'greedy' (tensor-boundary merge)
                                            # | 'uniform' (equal chunks)
    decorrelate_comp_rng: bool = False      # randomk: fold the rank into
                                            # the index draw (else every
                                            # rank draws the same indices)
    wire: str = "auto"                      # 'auto' (u16|bf16 words where
                                            # the plan allows) | 'off'
    exchange: str = "allgather"             # 'allgather' | 'gtopk' (the
                                            # butterfly; power-of-2 workers)
    overlap: str = "auto"                   # 'auto' (the bucket-pipelined
                                            # step where the plan is
                                            # uniform with >= 2 buckets) |
                                            # 'off' (sequential); the two
                                            # are bit-identical
    policy: str = "static"                  # 'adaptive': the policy
                                            # engine (policy/) retunes
                                            # the compressor, density,
                                            # wire, bucket plan and
                                            # overlap at log-interval
                                            # boundaries, rebuilding the
                                            # step; 'static': the knobs
                                            # stay as configured

    # numerics and device
    compute_dtype: str = "bfloat16"
    seed: int = 42
    device: str = "cuda"                    # 'cpu' only when asked

    # escape hatch: extra kwargs for get_model (e.g. a narrow ``cfg``)
    model_kwargs: dict = field(default_factory=dict)
    dataset_kwargs: dict = field(default_factory=dict)  # overrides of
                                            # make_dataset's arguments
    eval_max_batches: Optional[int] = None  # cap test() batches (None = all)

    # io, evaluation and checkpoints
    run_id: str = "run"
    output_dir: str = "./runs"
    log_every: int = 10
    eval_every_epochs: int = 1              # 0 = no eval pass
    save_every_epochs: int = 10             # 0 = only the final save
    save_every_steps: int = 0               # mid-epoch cadence (0 = off)
    keep_checkpoints: int = 0               # keep the last k (0 = all)
    resume: Optional[str] = None            # a ckpt dir (its newest good
                                            # checkpoint) or a step_* dir
    profile_steps: Optional[Tuple[int, int]] = None  # torch.profiler trace
                                            # of global steps [start, stop)
    phase_timing: bool = False              # fwd_bwd_s, select_s,
                                            # comm_update_s and
                                            # exposed_exchange_ms in each
                                            # log record (three probe
                                            # calls an interval)
    telemetry_window: int = 50              # steps of the throughput/MFU
                                            # tracker's window
    trace: str = "off"                      # 'on': host-phase span records,
                                            # a trace_id on every record,
                                            # pipeline_chunks and
                                            # comm_rounds in train records
    prom_textfile: Optional[str] = None     # a Prometheus textfile the
                                            # run's records also go to
    health: str = "off"                     # 'on': the run-health monitor
                                            # (telemetry/health.py), one
                                            # ok/degraded/critical
                                            # health_status verdict a log
                                            # interval with its causes;
                                            # 'off': no monitor, no record
    health_port: Optional[int] = None       # serve /healthz (+ /metrics)
                                            # on 127.0.0.1:PORT from rank
                                            # 0; implies health='on'; 0 =
                                            # an ephemeral port

    # resilience (training/resilience.py)
    nonfinite_guard: bool = True            # a step with a non-finite loss
                                            # or gradient commits nothing
    max_consecutive_skips: int = 10         # roll back after N back-to-back
                                            # guard-skipped steps (0 = off)
    loss_spike_factor: float = 0.0          # roll back when loss > f * EMA
                                            # (0 = off)
    loss_ema_beta: float = 0.9              # the spike detector's EMA decay
    lr_backoff: float = 0.5                 # lr scale a rollback
                                            # (compounds)
    max_rollbacks: int = 3                  # then fail loud
    handle_signals: bool = True             # fit(): SIGTERM/SIGINT ->
                                            # checkpoint at the next step
                                            # boundary, then a clean exit
    io_retries: int = 3                     # transient loader errors
                                            # retried a batch (0 = off)
    io_backoff_s: float = 0.05              # the first retry's backoff
                                            # (doubling, capped at 2 s)

    def __post_init__(self):
        if self.sp_size > 1 and (self.ici_size or self.dcn_size):
            raise ValueError("--sp-size and --ici-size/--dcn-size are "
                             "mutually exclusive mesh layouts")

    @property
    def global_batch_size(self) -> int:
        return self.batch_size * max(1, self.nworkers) * self.nsteps_update


# The reference's config keys this port does not carry: their reference
# default, and the ROADMAP queue-A item that ports them (none left).
NOT_CARRIED: dict = {}


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
    add("--nsteps-update", dest="nsteps_update", type=int,
        default=d.nsteps_update,
        help="microbatches a worker step (gradient accumulation)")
    add("--nworkers", type=int, default=d.nworkers,
        help="workers, one process each; must equal the world size "
             "(torchrun --nproc-per-node); 0 = the world size")
    add("--ici-size", dest="ici_size", type=int, default=d.ici_size,
        help="with --dcn-size: workers a node (the all-gather's group)")
    add("--dcn-size", dest="dcn_size", type=int, default=d.dcn_size,
        help="with --ici-size: nodes (the dense all-reduce's group)")
    add("--sp-size", dest="sp_size", type=int, default=d.sp_size,
        help=">1: ring-attention sequence parallelism (transformer_lm); "
             "the world is --nworkers x --sp-size")
    add("--lr", type=float, default=d.lr)
    add("--momentum", type=float, default=d.momentum)
    add("--weight-decay", dest="weight_decay", type=float,
        default=d.weight_decay)
    add("--nesterov", action=argparse.BooleanOptionalAction,
        default=d.nesterov)
    add("--epochs", type=int, default=d.epochs)
    add("--max-steps", dest="max_steps", type=int, default=None)
    add("--lr-milestones", dest="lr_milestones", type=float, nargs="*",
        default=d.lr_milestones)
    add("--lr-decay", dest="lr_decay", type=float, default=d.lr_decay)
    add("--warmup-epochs", dest="warmup_epochs", type=float,
        default=d.warmup_epochs)
    add("--clip-norm", dest="clip_norm", type=float, default=None)
    add("--label-smoothing", dest="label_smoothing", type=float,
        default=d.label_smoothing)
    add("--carry-hidden", dest="carry_hidden",
        action=argparse.BooleanOptionalAction, default=d.carry_hidden,
        help="lstm: carry the hidden state across bptt windows (reset at "
             "each epoch and each eval pass)")
    add("--compressor", default=d.compressor,
        help="none | topk | approxtopk | approxtopk16 | gaussian | "
             "gaussian_warm | gaussian_pallas | gaussian_fused | randomk | "
             "randomkec | dgcsampling | redsync | redsynctrim | auto (the "
             "default selector, gaussian_fused)")
    add("--decorrelate-comp-rng", dest="decorrelate_comp_rng",
        action="store_true", default=d.decorrelate_comp_rng,
        help="randomk/randomkec/dgcsampling: every worker draws its own "
             "indices (by default all draw the same)")
    add("--density", type=float, default=d.density)
    add("--sigma-scale", dest="sigma_scale", type=float, default=None,
        help="GaussianK: s in t0 = |mu| + s * sigma (default: the "
             "density's Gaussian tail quantile)")
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
    add("--overlap", choices=("auto", "off"), default=d.overlap,
        help="auto: the bucket-pipelined step (each bucket's exchange "
             "issued while the next bucket compresses) where the plan is "
             "uniform with two or more buckets; off: the sequential step "
             "(bit-identical)")
    add("--policy", choices=("static", "adaptive"), default=d.policy,
        help="adaptive: the policy engine retunes the compressor, density, "
             "wire, bucket plan and overlap from the run's telemetry at "
             "log-interval boundaries, rebuilding the step; static: the "
             "knobs stay as configured")
    add("--exchange", choices=("allgather", "gtopk"), default=d.exchange,
        help="allgather: every worker's k pairs to every worker; gtopk: "
             "the log2(P)-round butterfly of the global top-k (a power-of-2 "
             "number of workers)")
    add("--compress-warmup-steps", dest="compress_warmup_steps", type=int,
        default=d.compress_warmup_steps)
    add("--fold-lr", dest="fold_lr", action=argparse.BooleanOptionalAction,
        default=d.fold_lr,
        help="accumulate lr(step) * g in the EF row and step the optimizer "
             "at lr 1")
    add("--compute-dtype", dest="compute_dtype", default=d.compute_dtype)
    add("--seed", type=int, default=d.seed)
    add("--device", default=d.device, choices=("cuda", "cpu"))
    add("--model-kwargs", dest="model_kwargs", type=json.loads, default={},
        help='JSON, e.g. \'{"cfg": [8, "M"], "dropout": 0.0}\'')
    add("--dataset-kwargs", dest="dataset_kwargs", type=json.loads,
        default={}, help='JSON, e.g. \'{"vocab_size": 256}\'')
    add("--run-id", dest="run_id", default=d.run_id)
    add("--output-dir", dest="output_dir", default=d.output_dir)
    add("--log-every", dest="log_every", type=int, default=d.log_every)
    add("--eval-every-epochs", dest="eval_every_epochs", type=int,
        default=d.eval_every_epochs)
    add("--eval-max-batches", dest="eval_max_batches", type=int,
        default=None)
    add("--save-every-epochs", dest="save_every_epochs", type=int,
        default=d.save_every_epochs)
    add("--save-every-steps", dest="save_every_steps", type=int,
        default=d.save_every_steps,
        help="mid-epoch checkpoint cadence; 0 = epoch saves only")
    add("--keep-checkpoints", dest="keep_checkpoints", type=int,
        default=d.keep_checkpoints,
        help="keep-last-k checkpoint retention; 0 = keep all")
    add("--resume", default=None,
        help="a checkpoint directory (resume from its newest restorable "
             "checkpoint) or one step_XXXXXXXX directory")
    add("--profile-steps", dest="profile_steps", type=int, nargs=2,
        metavar=("START", "STOP"), default=None,
        help="trace global steps [START, STOP) with torch.profiler into "
             "<run dir>/profile")
    add("--phase-timing", dest="phase_timing",
        action=argparse.BooleanOptionalAction, default=d.phase_timing,
        help="add fwd_bwd_s, select_s, comm_update_s and "
             "exposed_exchange_ms to each log record (three probe calls a "
             "log interval)")
    add("--telemetry-window", dest="telemetry_window", type=int,
        default=d.telemetry_window,
        help="steps in the throughput/MFU tracker's rolling window")
    add("--trace", choices=("off", "on"), default=d.trace,
        help="on: span records of the host phases and a trace_id on every "
             "record of metrics.jsonl (telemetry/tracing.py)")
    add("--prom-textfile", dest="prom_textfile", default=None,
        help="also write the run's latest numbers to this Prometheus "
             "textfile-collector file")
    add("--health", choices=("off", "on"), default=d.health,
        help="run-health monitor (telemetry/health.py): on = one "
             "ok/degraded/critical health_status verdict a log interval "
             "with its causes; off = no monitor and no health record")
    add("--health-port", dest="health_port", type=int, default=None,
        help="serve live health JSON at /healthz (+ /metrics) on this port "
             "(rank 0); implies --health on; 0 = an ephemeral port")
    add("--nonfinite-guard", dest="nonfinite_guard",
        action=argparse.BooleanOptionalAction, default=d.nonfinite_guard,
        help="a step with a non-finite loss or gradient commits nothing")
    add("--max-consecutive-skips", dest="max_consecutive_skips", type=int,
        default=d.max_consecutive_skips,
        help="roll back after N back-to-back skipped steps; 0 = off")
    add("--loss-spike-factor", dest="loss_spike_factor", type=float,
        default=d.loss_spike_factor,
        help="roll back when loss > factor * EMA(loss); 0 = off")
    add("--loss-ema-beta", dest="loss_ema_beta", type=float,
        default=d.loss_ema_beta)
    add("--lr-backoff", dest="lr_backoff", type=float,
        default=d.lr_backoff, help="lr scale a rollback (compounds)")
    add("--max-rollbacks", dest="max_rollbacks", type=int,
        default=d.max_rollbacks)
    add("--handle-signals", dest="handle_signals",
        action=argparse.BooleanOptionalAction, default=d.handle_signals,
        help="SIGTERM/SIGINT -> checkpoint at the next step boundary, then "
             "a clean exit")
    add("--io-retries", dest="io_retries", type=int, default=d.io_retries,
        help="transient data-loader errors retried a batch")
    add("--io-backoff-s", dest="io_backoff_s", type=float,
        default=d.io_backoff_s)
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
    explicit_p = argparse.ArgumentParser()
    add_args(explicit_p, suppress_defaults=True)
    explicit, _ = explicit_p.parse_known_args(argv)
    merged = dict(base)
    merged.update(_detuple({k: v for k, v in file_vals.items()
                            if k in fields}))
    merged.update(_detuple({k: v for k, v in vars(explicit).items()
                            if k in fields}))
    _refuse_uncarried(cfg_path, file_vals, fields)
    return TrainConfig(**merged)


def _refuse_uncarried(cfg_path: str, file_vals: dict,
                      fields: set) -> None:
    """Raise for a file key this port does not carry whose value differs
    from the reference's default (the port would run another algorithm),
    and for a key the reference does not know either; log the rest."""
    unknown = sorted(set(file_vals) - fields - set(NOT_CARRIED))
    if unknown:
        raise ValueError(f"unknown keys in {cfg_path}: {unknown}")
    refused = []
    for key in sorted(set(file_vals) - fields):
        default, item = NOT_CARRIED[key]
        value = file_vals[key]
        if isinstance(value, list):
            value = tuple(value)
        if value != default:
            refused.append(f"{key}={file_vals[key]!r} (ROADMAP A item "
                           f"{item})")
    if refused:
        raise ValueError(
            f"{cfg_path} sets keys this port does not carry yet, to values "
            f"other than the reference's defaults: {', '.join(refused)}")
    ignored = sorted(set(file_vals) - fields)
    if ignored:
        log.info("%s: ignoring keys this port does not carry: %s (each at "
                 "the reference's default)", cfg_path, ", ".join(ignored))
