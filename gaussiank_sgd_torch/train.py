"""Training entry point of the port (``python -m gaussiank_sgd_torch.train``).

Runs on the GPU unless ``--device cpu`` is given, one process a worker.
BASELINE config 2 on one H100::

  python -m gaussiank_sgd_torch.train \
      --config exp_configs/config2_vgg16_cifar10_gaussian.json \
      --compressor gaussian_fused --nworkers 1 --max-steps 6

and on eight (NCCL; on the CPU add ``--device cpu`` and gloo is used)::

  torchrun --standalone --nproc-per-node 8 -m gaussiank_sgd_torch.train \
      --config exp_configs/config2_vgg16_cifar10_gaussian.json --max-steps 6

``fit`` runs epochs: an eval pass every ``--eval-every-epochs`` and a
checkpoint every ``--save-every-epochs`` (and ``--save-every-steps``) under
``<output-dir>/<run-id>/ckpt``, plus one at the end. SIGTERM or SIGINT
seals a checkpoint at the next step boundary, and the process then exits
with code 0. ``--resume`` takes that directory (its newest good
checkpoint) or one ``step_XXXXXXXX`` in it, and continues where the run
stopped::

  python -m gaussiank_sgd_torch.train \
      --config exp_configs/config3_resnet50_imagenet_gaussian.json \
      --nworkers 1 --compressor gaussian_fused --max-steps 20 \
      --save-every-epochs 1 --run-id c3
  python -m gaussiank_sgd_torch.train ... --run-id c3 \
      --max-steps 40 --resume runs/c3/ckpt

``--policy adaptive`` lets the policy engine (``policy/``) retune the
compressor, density, wire, bucket plan and overlap at log-interval
boundaries, rebuilding the step while the run is live; each decision and
each revert seals a checkpoint, so give it ``--save-every-steps`` too::

  python -m gaussiank_sgd_torch.train \
      --config exp_configs/config2_vgg16_cifar10_gaussian.json \
      --nworkers 1 --compressor gaussian_fused --compress-warmup-steps 2 \
      --max-steps 40 --log-every 2 --save-every-steps 10 --policy adaptive
"""

from __future__ import annotations

import argparse
import logging
import sys

from .training.config import add_args, from_args
from .training.trainer import Trainer


def main(argv=None):
    if argv is None:
        argv = sys.argv[1:]
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s: %(message)s")
    p = argparse.ArgumentParser(
        description="GaussianK-SGD sparse data-parallel training, one GPU "
                    "a process (PyTorch port)")
    add_args(p)
    cfg = from_args(p.parse_args(argv), argv)
    trainer = Trainer(cfg)
    try:
        result = trainer.fit()
    finally:
        trainer.close()
    # a preempted run has sealed its checkpoint: it exits 0, and the
    # rescheduled run resumes from it with --resume
    logging.getLogger(__name__).info("done at step %d: %s, metrics in %s",
                                     trainer.step, result,
                                     trainer.metrics_path)
    return result


if __name__ == "__main__":
    main()
