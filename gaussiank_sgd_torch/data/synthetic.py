"""Deterministic synthetic images — learnable, not noise (copies of
``synthetic_images`` and ``synthetic_images_u8`` from
``gaussiank_sgd_tpu/data/synthetic.py``, so a seed gives the same data in
both packages)."""

from __future__ import annotations

from typing import Tuple

import numpy as np


def synthetic_images(num: int, shape: Tuple[int, ...], num_classes: int,
                     seed: int = 0, noise: float = 0.3,
                     task_seed: int = 12345):
    """Images whose class signal is a per-class template (from
    ``task_seed``, shared by the splits) plus noise (from ``seed``)."""
    task_rng = np.random.default_rng(task_seed)
    templates = task_rng.normal(0.0, 1.0, size=(num_classes,) + shape)
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, num_classes, size=num).astype(np.int32)
    x = templates[labels] + rng.normal(0.0, noise, size=(num,) + shape)
    return x.astype(np.float32), labels


def synthetic_images_u8(num: int, shape: Tuple[int, ...], num_classes: int,
                        seed: int = 0, noise: float = 0.3,
                        task_seed: int = 12345):
    """``synthetic_images`` quantised to uint8 pixels (``128 + 48 x``,
    clipped), for the pipeline that normalises on the device."""
    x, y = synthetic_images(num, shape, num_classes, seed=seed, noise=noise,
                            task_seed=task_seed)
    return np.clip(128.0 + 48.0 * x, 0, 255).astype(np.uint8), y
