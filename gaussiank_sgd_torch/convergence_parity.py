"""Convergence parity: compressed data-parallel training against dense at
equal steps (port of ``analysis/convergence_parity.py``).

It trains the same model with the same seeds under several
exchange/compressor arms on P workers and records each arm's final loss,
eval loss and top-1, its bytes a step, and its loss curve; with a dense
arm, each compressed arm's seed-paired gap to it.

Arms: ``none`` (the dense arm), and any registry name (``gaussian``,
``topk``, ``gaussian_fused``, ...) with an optional ``@gtopk`` (the gTop-k
butterfly) or ``@allgather`` exchange and an optional ``:wire=off``
suffix (the legacy i32+f32 exchange: same plan, same selection, only the
wire differs).

The P workers are P processes of one gloo group (``torch.multiprocessing``),
each a ``Trainer`` rank with ``nworkers = P``, all on the CPU with
``--device cpu`` or all on the current card (several gloo ranks share
it: gloo stages their CUDA tensors through the host). The data is the
synthetic stand-in of the dataset (``--data-dir`` is not offered here).
Rank 0 writes the runs' files.

Artifacts (``--out-dir``, default ``gaussiank_sgd_torch/artifacts/``):
  convergence_parity[_TAG].json — the summary (+ bytes a step an arm)
  convergence_parity[_TAG]_curves.jsonl — each arm's loss curve
The reference's plot is not made.

Run: ``python -m gaussiank_sgd_torch.convergence_parity [--steps 300]
[--density 0.01] [--nprocs 8] [--arms none,gaussian,topk,gaussian@gtopk]
[--device cpu]``.
"""

# gklint: disable-file=print-in-library -- this module is the CLI of `python -m gaussiank_sgd_torch.convergence_parity`: it prints each arm's line and the parity block, which are the command's output

from __future__ import annotations

import argparse
import json
import os
import pickle
import shutil
import tempfile
from typing import Any, Dict, List, Optional

PKG = os.path.dirname(os.path.abspath(__file__))
ARTIFACTS = os.path.join(PKG, "artifacts")

DEFAULT_ARMS = "none,gaussian,topk,gaussian@gtopk"
_RUN_KEYS = ("final_loss", "val_loss", "top1", "perplexity", "cer")


def run_arm(name: str, steps: int, density: float, outdir: str,
            **overrides) -> Dict[str, Any]:
    """One training arm on this process's rank. Experiment-defining
    hyperparameters come from the caller via ``overrides``; ``main`` is
    the single source of their defaults (the argparse surface). Every
    rank returns the run (its record stream is rank 0's)."""
    import torch.distributed as dist
    from .ops import fused_select, threshold_select
    from .training.config import TrainConfig
    from .training.trainer import Trainer

    cfg = dict(
        momentum=0.9, epochs=1, max_steps=steps,
        compressor="gaussian", density=density,
        warmup_epochs=0.0, compute_dtype="float32", output_dir=outdir,
        log_every=10, eval_every_epochs=0, save_every_epochs=0, seed=0,
        run_id=name,
    )
    cfg.update(overrides)
    fused_select.reset_launches()
    threshold_select.reset_launches()
    t = Trainer(TrainConfig(**cfg))
    t.train(steps)
    res = t.test()
    t.close()
    launches = {**fused_select.LAUNCHES, **threshold_select.LAUNCHES}
    out = None
    if t.rank == 0:
        with open(os.path.join(t.run_dir, "metrics.jsonl")) as f:
            recs = [json.loads(line) for line in f]
        tr = [r for r in recs if r.get("event") == "train"]
        out = {
            "arm": name,
            "compressor": cfg["compressor"],   # provenance: what ran
            "exchange": cfg.get("exchange", "allgather"),
            # the format the sparse bytes travelled in
            "wire_format": next(
                (r["wire_format"] for r in reversed(tr)
                 if r.get("wire_format") is not None), None),
            "final_loss": tr[-1]["loss"],
            "val_loss": res["val_loss"],
            "top1": res.get("top1"),
            "perplexity": res.get("perplexity"),
            "cer": res.get("cer"),
            # last-step exchange payload; the dense arm's is its FULL
            # dense gradient (no compression)
            "bytes_per_step": tr[-1]["bytes_sent"],
            "curve": [(r["step"], r["loss"]) for r in tr],
        }
    # every rank's kernel launches, gathered to rank 0
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, launches)
    if out is not None:
        out["launches"] = every
    return out


def _agg(vals):
    """mean ± sample spread over seeds; None-safe."""
    vals = [v for v in vals if v is not None]
    if not vals:
        return None
    import numpy as np
    return {"mean": round(float(np.mean(vals)), 4),
            "std": round(float(np.std(vals)), 4),
            "n": len(vals), "values": [round(float(v), 4) for v in vals]}


def parse_arms(spec: str, names) -> List[tuple]:
    """``compressor[@exchange][:wire=off]`` specs -> ``[(arm name,
    overrides)]``; a ValueError names a bad one."""
    arms = []
    for spec_str in spec.split(","):
        base, _, opt = spec_str.strip().partition(":")
        comp, _, exch = base.partition("@")
        if comp not in names:
            raise ValueError(f"bad arm spec {spec_str!r}: compressor must "
                             f"be one of {tuple(names)}")
        if exch and exch not in ("allgather", "gtopk"):
            raise ValueError(f"bad arm spec {spec_str!r}: exchange must be "
                             f"allgather or gtopk")
        if opt and opt != "wire=off":
            raise ValueError(f"bad arm spec {spec_str!r}: the only option "
                             f"is :wire=off")
        name = comp if comp != "none" else "dense"
        ov: Dict[str, Any] = dict(compressor=comp)
        if exch:
            name += f"_{exch}"
            ov["exchange"] = exch
        if opt:
            name += "_wireoff"
            ov["wire"] = "off"
        arms.append((name, ov))
    return arms


def _rank_main(rank: int, world: int, work: str, job: Dict[str, Any]):
    """One of the P ranks: join the gloo group, run every arm and seed in
    order, rank 0 pickling the runs to ``work/runs.pkl``."""
    import torch.distributed as dist
    from .parallel.mesh import init_distributed
    init_distributed(job["device"], rank, world,
                     "file://" + os.path.join(work, "store"),
                     backend="gloo")
    try:
        results = []
        for name, ov in job["arms"]:
            runs = []
            for s in range(job["seeds"]):
                if rank == 0:
                    print(f"=== arm {name} seed {s} ===", flush=True)
                common = dict(job["common"])
                dkw = dict(common.pop("dataset_kwargs"), seed=100 + s)
                runs.append(run_arm(
                    f"{name}_s{s}", job["steps"], job["density"],
                    job["run_dir"], **common, dataset_kwargs=dkw, **ov,
                    seed=s))
            results.append((name, runs))
        if rank == 0:
            with open(os.path.join(work, "runs.pkl"), "wb") as f:
                pickle.dump(results, f)
        dist.barrier()
    finally:
        dist.destroy_process_group()


def run(argv: Optional[List[str]] = None) -> Dict[str, Any]:
    """The CLI's work: every arm trained on ``--nprocs`` gloo ranks; the
    summary written and returned (each arm's per-rank kernel launches
    under ``"launches"`` and its unrounded runs under ``"seed_runs"`` in
    the returned copy only)."""
    p = argparse.ArgumentParser(
        prog="python -m gaussiank_sgd_torch.convergence_parity")
    p.add_argument("--steps", type=int, default=300)
    p.add_argument("--density", type=float, default=0.01)
    p.add_argument("--nprocs", type=int, default=8,
                   help="P, the gloo ranks (the reference's --devices)")
    p.add_argument("--device", default="cuda",
                   help="cuda (default: every rank on the current card) "
                        "or cpu, only when asked")
    p.add_argument("--dnn", default="mnistnet")
    p.add_argument("--dataset", default="mnist")
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--lr", type=float, default=0.005)
    p.add_argument("--weight-decay", type=float, default=0.0)
    p.add_argument("--compress-warmup-steps", type=int, default=10)
    p.add_argument("--clip-norm", dest="clip_norm", type=float, default=None)
    p.add_argument("--arms", default=DEFAULT_ARMS,
                   help="comma list of compressor[@exchange][:wire=off]; "
                        "'none' = the dense baseline arm")
    p.add_argument("--bucket-size", dest="bucket_size", type=int,
                   default=None)
    p.add_argument("--bucket-policy", dest="bucket_policy",
                   choices=("greedy", "uniform"), default="greedy")
    p.add_argument("--seeds", type=int, default=1,
                   help="run every arm with seeds 0..N-1 and report "
                        "mean +/- std per arm")
    p.add_argument("--label-noise", dest="label_noise", type=float,
                   default=0.0,
                   help="symmetric label-flip fraction p (the top-1 "
                        "ceiling becomes 1 - p)")
    p.add_argument("--model-kwargs", dest="model_kwargs", type=json.loads,
                   default={}, help="JSON model ctor overrides")
    p.add_argument("--dataset-kwargs", dest="dataset_kwargs",
                   type=json.loads, default={},
                   help="JSON dataset overrides")
    p.add_argument("--tag", default=None,
                   help="artifact suffix (default: the dnn when not "
                        "mnistnet)")
    p.add_argument("--out-dir", default=ARTIFACTS,
                   help="where the summary and curves go")
    p.add_argument("--run-dir", default=None,
                   help="the runs' own files (default: a temporary "
                        "directory, removed after)")
    args = p.parse_args(argv)

    from .compressors.registry import NAMES
    from .device import resolve_device
    resolve_device(args.device)
    try:
        arms = parse_arms(args.arms, NAMES)
    except ValueError as e:
        p.error(str(e))
    dataset_kwargs = dict(args.dataset_kwargs)
    if args.label_noise > 0:
        if args.dataset not in ("mnist", "cifar10", "cifar100"):
            p.error(f"--label-noise applies to the mnist/cifar10/cifar100 "
                    f"factories only, not {args.dataset!r}")
        dataset_kwargs["label_noise"] = args.label_noise
    common = dict(dnn=args.dnn, dataset=args.dataset,
                  batch_size=args.batch_size, lr=args.lr,
                  weight_decay=args.weight_decay, nworkers=args.nprocs,
                  model_kwargs=args.model_kwargs,
                  dataset_kwargs=dataset_kwargs,
                  clip_norm=args.clip_norm,
                  bucket_size=args.bucket_size,
                  bucket_policy=args.bucket_policy,
                  compress_warmup_steps=args.compress_warmup_steps,
                  device=args.device)

    import torch.multiprocessing as mp
    work = tempfile.mkdtemp(prefix="convergence_parity_")
    try:
        job = {"device": args.device, "arms": arms, "seeds": args.seeds,
               "steps": args.steps, "density": args.density,
               "common": common,
               "run_dir": args.run_dir or os.path.join(work, "runs")}
        mp.spawn(_rank_main, args=(args.nprocs, work, job),
                 nprocs=args.nprocs, join=True)
        with open(os.path.join(work, "runs.pkl"), "rb") as f:
            by_arm = pickle.load(f)
    finally:
        shutil.rmtree(work, ignore_errors=True)

    results = []
    for name, runs in by_arm:
        r = dict(runs[0])                      # arm metadata + seed-0 curve
        r["arm"] = name
        r["seed_runs"] = [{k: run_[k] for k in _RUN_KEYS} for run_ in runs]
        for key in _RUN_KEYS:
            r[key + "_agg"] = _agg([run_[key] for run_ in runs])
            r[key] = r[key + "_agg"]["mean"] if r[key + "_agg"] else None
        results.append(r)
        print(f"{name}: final_loss={r['final_loss']:.4f} "
              f"val_loss={r['val_loss']:.4f} top1={r['top1']} "
              f"bytes/step={r['bytes_per_step']}", flush=True)

    dense = next((r for r in results if r["compressor"] == "none"), None)
    summary: Dict[str, Any] = {
        "config": {"steps": args.steps, "density": args.density,
                   "nworkers": args.nprocs, "model": args.dnn,
                   "seeds": args.seeds, "label_noise": args.label_noise,
                   "device": args.device,
                   "dataset": args.dataset + "(synthetic)",
                   "reproduce": "python -m gaussiank_sgd_torch."
                                "convergence_parity " + " ".join(
                       f"--{k.replace('_', '-')} "
                       f"{json.dumps(v) if isinstance(v, dict) else v}"
                       for k, v in sorted(vars(args).items())
                       if v not in (None, "") and v != {}
                       and k not in ("out_dir", "run_dir"))},
        "arms": [{k: r.get(k) for k in
                  ("arm", "compressor", "exchange", "wire_format",
                   "final_loss", "val_loss", "top1", "perplexity", "cer",
                   "bytes_per_step", "final_loss_agg", "val_loss_agg",
                   "top1_agg", "perplexity_agg", "cer_agg")}
                 for r in results],
    }
    if dense is not None:   # a parity block only makes sense vs a dense arm
        def paired_gap(r, key, rel=False):
            """Seed-paired gap (dense_s - arm_s): level variation across
            seeds cancels, leaving the compression effect ± its spread."""
            gaps = []
            for da, ra in zip(dense["seed_runs"], r["seed_runs"]):
                if da[key] is None or ra[key] is None:
                    continue
                if rel and da[key] == 0:       # fully saturated dense arm
                    continue
                gaps.append((ra[key] / da[key]) if rel
                            else (da[key] - ra[key]))
            return _agg(gaps)

        summary["parity"] = {
            r["arm"]: {
                "top1_gap_vs_dense": paired_gap(r, "top1"),
                "val_loss_ratio_vs_dense": paired_gap(r, "val_loss",
                                                      rel=True),
                "perplexity_ratio_vs_dense": paired_gap(r, "perplexity",
                                                        rel=True),
                "cer_gap_vs_dense": paired_gap(r, "cer"),
            } for r in results if r is not dense
        }
    tag = (f"_{args.tag.lstrip('_')}" if args.tag else
           ("" if args.dnn == "mnistnet" else f"_{args.dnn}"))
    os.makedirs(args.out_dir, exist_ok=True)
    with open(os.path.join(args.out_dir,
                           f"convergence_parity{tag}.json"), "w") as f:
        json.dump(summary, f, indent=2)
    with open(os.path.join(args.out_dir,
                           f"convergence_parity{tag}_curves.jsonl"),
              "w") as f:
        for r in results:
            f.write(json.dumps({"arm": r["arm"], "curve": r["curve"]})
                    + "\n")
    print(json.dumps(summary.get("parity", summary["arms"]), indent=2))
    return dict(summary, launches={r["arm"]: r["launches"]
                                   for r in results},
                seed_runs={r["arm"]: r["seed_runs"] for r in results})


def main(argv: Optional[List[str]] = None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
