#!/usr/bin/env python3
"""Step time of BASELINE configs 2 and 3 on one GPU with cuDNN's
deterministic algorithms on and off.

``device.py:resolve_device`` pins ``torch.backends.cudnn.deterministic =
True`` (and ``benchmark = False``) so a seeded or resumed run repeats bit
for bit; this script measures what that costs. For each config it builds
the trainer at one worker (``gaussian_fused``, 2 dense warm-up steps), then
runs sparse steps in four arms, off, on, on, off, ``--steps`` steps each,
and prints each arm's step wall times (host clock around a step that ends
in ``cuda.synchronize``, as the trainer's ``step_ms``) and their median.
Needs a CUDA device; run from the repository root::

  python3 analysis/cudnn_determinism.py [--steps 8]

The last line is one JSON object with every arm's times.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = {
    "config2": os.path.join(REPO, "exp_configs",
                            "config2_vgg16_cifar10_gaussian.json"),
    "config3": os.path.join(REPO, "exp_configs",
                            "config3_resnet50_imagenet_gaussian.json"),
}


def _trainer(path: str, out_dir: str):
    from gaussiank_sgd_torch.training.config import add_args, from_args
    from gaussiank_sgd_torch.training.trainer import Trainer
    argv = ["--config", path, "--nworkers", "1", "--compressor",
            "gaussian_fused", "--compress-warmup-steps", "2",
            "--output-dir", out_dir]
    p = argparse.ArgumentParser()
    add_args(p)
    return Trainer(from_args(p.parse_args(argv), argv))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=8,
                    help="sparse steps an arm")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("cudnn_determinism: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()
    print(smi[0])
    result = {"card": smi[0], "torch": torch.__version__,
              "cudnn": torch.backends.cudnn.version(), "configs": {}}
    with tempfile.TemporaryDirectory() as out_dir:
        for name, path in CONFIGS.items():
            trainer = _trainer(path, out_dir)
            trainer.train(3)                  # 2 dense, the cold sparse one
            arms = []
            for deterministic in (False, True, True, False):
                torch.backends.cudnn.deterministic = deterministic
                torch.backends.cudnn.benchmark = False
                trainer.train(args.steps)
                ms = [rec["step_ms"] for rec in trainer.records[-args.steps:]]
                arms.append({"deterministic": deterministic, "step_ms": ms,
                             "median_ms": statistics.median(ms)})
                print(f"{name} deterministic={deterministic}: median "
                      f"{arms[-1]['median_ms']:.2f} ms of {args.steps} sparse "
                      f"steps {[round(v, 2) for v in ms]}")
            torch.backends.cudnn.deterministic = True
            result["configs"][name] = arms
            del trainer
            torch.cuda.empty_cache()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
