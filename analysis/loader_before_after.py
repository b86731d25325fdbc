#!/usr/bin/env python3
"""Config 3's wall time a step and the card's busy share through the
trainer's own loader, on one or more trees of the PyTorch port.

Usage, on a machine with a CUDA card, from the repository root::

    python3 analysis/loader_before_after.py --tree OLD --tree . --tree . \\
        --tree OLD

where ``OLD`` holds another commit's ``gaussiank_sgd_torch/`` and
``exp_configs/`` (for example ``git archive <commit> gaussiank_sgd_torch
exp_configs | tar -x -C OLD``). Each ``--tree`` runs in a process of its
own, in the order given (alternate them: old, new, new, old). A run builds
BASELINE config 3 (ResNet-50, synthetic uint8 ImageNet at 224^2, batch 64,
bf16, ``gaussian_fused`` at one worker), takes 2 dense steps and the
cold first sparse one, then ``--steps`` (20) sparse steps in one
``Trainer.train`` call (each batch drawn and copied as that tree's trainer
does it), timed on the host clock around work that ends in a device
synchronise: the wall ms a step, and beside it the median of the steps'
own ``step_ms`` (the step between two synchronises, without the batch);
then ``--profiled`` (5) more sparse steps under ``torch.profiler``: their
wall time, device time and busy share (device time over wall). It prints
one JSON line a run, then the card's ``name, power.limit`` and a summary
line; ``--out FILE`` also writes the runs there.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _one(tree: str, steps: int, profiled: int) -> dict:
    """One run on ``tree`` (this process imports the port from there)."""
    tree = os.path.abspath(tree)
    sys.path.insert(0, tree)
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    import gaussiank_sgd_torch
    from gaussiank_sgd_torch.training.config import add_args, from_args
    from gaussiank_sgd_torch.training.trainer import Trainer
    if not os.path.abspath(gaussiank_sgd_torch.__file__).startswith(tree):
        raise RuntimeError(f"imported {gaussiank_sgd_torch.__file__}, not "
                           f"the tree {tree}")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device")
    with tempfile.TemporaryDirectory() as run_dir:
        argv = ["--config", os.path.join(
            tree, "exp_configs", "config3_resnet50_imagenet_gaussian.json"),
            "--nworkers", "1", "--compressor", "gaussian_fused",
            "--compress-warmup-steps", "2", "--max-steps",
            str(3 + steps + profiled),
            "--log-every", "100", "--output-dir", run_dir]
        p = argparse.ArgumentParser()
        add_args(p)
        trainer = Trainer(from_args(p.parse_args(argv), argv))
        trainer.train(3)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        result = trainer.train(steps)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / steps
        # the parent commit's train() returned the step records
        recs = (trainer.records[-steps:] if hasattr(trainer, "records")
                else result)
        step_ms = [r["step_ms"] for r in recs]
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            trainer.train(profiled)
            torch.cuda.synchronize()
            window_ms = (time.perf_counter() - t0) * 1e3
        device_ms = sum(e.self_device_time_total
                        for e in prof.key_averages()
                        if e.device_type == DeviceType.CUDA) / 1e3
        if hasattr(trainer, "close"):
            trainer.close()
    return {"tree": tree, "card": torch.cuda.get_device_name(0),
            "wall_ms_a_step": wall_ms, "step_ms": step_ms,
            "median_step_ms": statistics.median(step_ms),
            "profiled_wall_ms_a_step": window_ms / profiled,
            "device_ms_a_step": device_ms / profiled,
            "busy": device_ms / window_ms if window_ms else None}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", action="append", required=True,
                    help="a tree of the port (repeat, in run order)")
    ap.add_argument("--steps", type=int, default=20,
                    help="timed sparse steps a run")
    ap.add_argument("--profiled", type=int, default=5,
                    help="sparse steps under the profiler a run")
    ap.add_argument("--out", default=None, help="also write the runs here")
    ap.add_argument("--one", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.one:
        print(json.dumps(_one(args.one, args.steps, args.profiled)))
        return 0
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()
    runs = []
    for tree in args.tree:
        done = subprocess.run([sys.executable, os.path.abspath(__file__),
                               "--tree", tree, "--one", tree, "--steps",
                               str(args.steps), "--profiled",
                               str(args.profiled)], cwd=REPO,
                              capture_output=True, text=True)
        if done.returncode != 0:
            print(done.stderr[-3000:], file=sys.stderr)
            return done.returncode
        runs.append(json.loads(done.stdout.strip().splitlines()[-1]))
        print(json.dumps(runs[-1]))
    print(smi[0])
    by_tree = {}
    for run in runs:
        by_tree.setdefault(run["tree"], []).append(run)
    for tree, rs in by_tree.items():
        def col(key, digits=2):
            return [round(r[key], digits) for r in rs]
        print(f"{tree}: {col('wall_ms_a_step')} ms wall a sparse step "
              f"(median step_ms {col('median_step_ms')}), profiled "
              f"{col('profiled_wall_ms_a_step')} ms wall and "
              f"{col('device_ms_a_step')} ms device a step, busy "
              f"{col('busy', 4)}")
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"card": smi[0], "runs": runs}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
