"""Datasets (port of ``gaussiank_sgd_tpu/data``). This slice ports CIFAR
and ImageNet; other datasets of the reference raise
``NotImplementedError``."""

from __future__ import annotations

import functools
import os
from typing import Optional, Tuple

import numpy as np

from .cifar import make_cifar
from .loader import ArrayDataset, EpochStream
from .synthetic import synthetic_images, synthetic_images_u8


@functools.lru_cache(maxsize=2)
def _synthetic_imagenet(num: int, image_size: int,
                        train: bool) -> Tuple[np.ndarray, np.ndarray]:
    """The synthetic ImageNet split, drawn once a process (at 224^2 the
    draw holds ~2.4 GB of float64 for a few seconds); read-only, since
    every dataset built from it shares the arrays."""
    x, y = synthetic_images_u8(num, (image_size, image_size, 3), 1000,
                               seed=0 if train else 1)
    x.flags.writeable = y.flags.writeable = False
    return x, y


def make_imagenet(data_dir: Optional[str] = None, train: bool = True,
                  batch_size: int = 256, image_size: int = 224, seed: int = 0,
                  synthetic_examples: int = 1024) -> Tuple[ArrayDataset, int]:
    """``(dataset, 1000)``: ``{data_dir}/{split}_images.npy`` and
    ``{split}_labels.npy`` when both exist (the images memory-mapped), else
    ``synthetic_examples`` synthetic uint8 images at ``image_size``^2.
    Batches are served as uint8 where the arrays are uint8; the loss
    normalises them on the device (``training/losses.py``)."""
    split = "train" if train else "val"
    x = None
    if data_dir and data_dir != "synthetic":
        xi = os.path.join(data_dir, f"{split}_images.npy")
        yi = os.path.join(data_dir, f"{split}_labels.npy")
        if os.path.exists(xi) and os.path.exists(yi):
            x = np.load(xi, mmap_mode="r")
            y = np.load(yi).astype(np.int32)
    if x is None:
        x, y = _synthetic_imagenet(synthetic_examples, image_size, train)
    return ArrayDataset(x, y, batch_size, shuffle=train, seed=seed), 1000


def make_dataset(dataset: str, data_dir: Optional[str] = None,
                 train: bool = True, batch_size: int = 128, **kw):
    """``(dataset, num_classes)`` by ``--dataset`` name."""
    dataset = dataset.lower()
    if dataset in ("cifar10", "cifar100"):
        return make_cifar(dataset, data_dir, train, batch_size, **kw)
    if dataset == "imagenet":
        return make_imagenet(data_dir, train, batch_size, **kw)
    if dataset in ("mnist", "ptb", "an4", "wmt14", "wmt"):
        raise NotImplementedError(
            f"dataset {dataset!r} is not ported yet (ROADMAP A7, A11)")
    raise ValueError(f"unknown dataset {dataset!r}")


__all__ = ["ArrayDataset", "EpochStream", "make_cifar", "make_dataset",
           "make_imagenet", "synthetic_images", "synthetic_images_u8"]
