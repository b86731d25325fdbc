"""Training entry point of the port (``python -m gaussiank_sgd_torch.train``).

Runs on the GPU unless ``--device cpu`` is given, one process a worker.
BASELINE config 2 on one H100::

  python -m gaussiank_sgd_torch.train \
      --config exp_configs/config2_vgg16_cifar10_gaussian.json \
      --compressor gaussian_fused --nworkers 1 --max-steps 6

and on eight (NCCL; on the CPU add ``--device cpu`` and gloo is used)::

  torchrun --standalone --nproc-per-node 8 -m gaussiank_sgd_torch.train \
      --config exp_configs/config2_vgg16_cifar10_gaussian.json --max-steps 6
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
    records = trainer.fit()
    logging.getLogger(__name__).info("done: %d steps, metrics in %s",
                                     len(records), trainer.metrics_path)
    return records


if __name__ == "__main__":
    main()
