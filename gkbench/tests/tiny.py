"""Cells of ``BENCHMARK.json`` cut to a size a CPU test holds: the same
configuration with narrow models, small images, batch 4 a worker, float32
compute, a tenth of the learning rate, and the legacy (int32, float32)
wire, which the full-size cells' whole-model bucket takes anyway."""

from __future__ import annotations

import copy

from gkbench import manifest

# limits for float32 programs at this size: the port and the reference
# agree to ~1e-6 there, every fault reads 1e-2 or more
TINY_LIMITS = {"loss1_gap": 1e-4, "grad_gap": 1e-4, "residual_gap": 1e-4,
               "update_gap": 1e-4, "residual_leaf_gap": 1e-4,
               "residual_median_gap": 1e-4}


def tiny_cell(name: str = "vgg16-gk-1c", chips: int = 1) -> manifest.Cell:
    """``name``'s configuration cut down, on ``chips`` workers (gloo
    processes on the CPU)."""
    cell = manifest.load_cell(name)
    cfg = copy.deepcopy(cell.config)
    train = cfg["train"]
    if cfg["architecture"]["model"] == "vgg16":
        cfg["architecture"].update(image=[8, 8, 3], widths=[8, "M", 16, "M"])
        train["model_kwargs"] = {"cfg": [8, "M", 16, "M"],
                                 "input_shape": [8, 8, 3]}
        image, template = [8, 8, 3], [2, 2]
    else:
        cfg["architecture"].update(stages=[1, 1, 1, 1])
        train["model_kwargs"] = {"stage_sizes": [1, 1, 1, 1]}
        image, template = [64, 64, 3], [4, 4]
    # lr 0.01: at batch 4 on four batches the published 0.1 can diverge
    # within a test's window of some hundred steps
    train.update(batch_size=4, compute_dtype="float32", density=0.01,
                 wire="off", lr=0.01)
    if "data_files" in cfg:
        cfg["data_files"] = 16          # the tiny pool's rows
    else:
        train["dataset_kwargs"] = {"synthetic_examples": 64}
    traffic = dict(cell.traffic, image=image, template_hw=template,
                   pool_batches=4, global_batch=4 * chips)
    setup = dict(cell.setup, setup_steps=12, limits=dict(TINY_LIMITS))
    return manifest.Cell(name, chips, cell.config_name, cell.traffic_name,
                         cfg, traffic, setup)
