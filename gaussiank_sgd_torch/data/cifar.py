"""CIFAR-10/100: binary-file reader with a synthetic stand-in (port of
``gaussiank_sgd_tpu/data/cifar.py``).

Reads the canonical ``cifar-10-batches-bin`` / ``cifar-100-binary`` files
when ``data_dir`` holds them (pad-4 reflect crop + horizontal flip on the
train split, per-channel normalisation); otherwise serves the learnable
synthetic images of ``data/synthetic.py``, as the reference does.
"""

from __future__ import annotations

import os
from typing import Callable, Optional, Tuple

import numpy as np

from .loader import ArrayDataset
from .synthetic import synthetic_images

# standard CIFAR-10 channel stats
_MEAN = np.array([0.4914, 0.4822, 0.4465], np.float32)
_STD = np.array([0.2470, 0.2435, 0.2616], np.float32)


def _read_cifar10_bin(data_dir: str, train: bool):
    names = ([f"data_batch_{i}.bin" for i in range(1, 6)] if train
             else ["test_batch.bin"])
    sub = os.path.join(data_dir, "cifar-10-batches-bin")
    base = sub if os.path.isdir(sub) else data_dir
    xs, ys = [], []
    for n in names:
        rec = np.fromfile(os.path.join(base, n), np.uint8).reshape(-1, 3073)
        ys.append(rec[:, 0])
        xs.append(rec[:, 1:].reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1))
    return np.concatenate(xs), np.concatenate(ys).astype(np.int32)


def _read_cifar100_bin(data_dir: str, train: bool):
    name = "train.bin" if train else "test.bin"
    sub = os.path.join(data_dir, "cifar-100-binary")
    base = sub if os.path.isdir(sub) else data_dir
    rec = np.fromfile(os.path.join(base, name), np.uint8).reshape(-1, 3074)
    y = rec[:, 1].astype(np.int32)         # fine label
    x = rec[:, 2:].reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
    return x, y


def _normalize(x_u8: np.ndarray) -> np.ndarray:
    return ((x_u8.astype(np.float32) / 255.0) - _MEAN) / _STD


def _augment(rng: np.random.Generator) -> Callable:
    def fn(x: np.ndarray, y: np.ndarray):
        b, h, w, _ = x.shape
        padded = np.pad(x, ((0, 0), (4, 4), (4, 4), (0, 0)), mode="reflect")
        oy = rng.integers(0, 9, size=b)
        ox = rng.integers(0, 9, size=b)
        out = np.empty_like(x)
        for i in range(b):
            out[i] = padded[i, oy[i]:oy[i] + h, ox[i]:ox[i] + w]
        flip = rng.random(b) < 0.5
        out[flip] = out[flip, :, ::-1]
        return out, y
    return fn


def make_cifar(dataset: str = "cifar10", data_dir: Optional[str] = None,
               train: bool = True, batch_size: int = 128,
               augment: bool = True, seed: int = 0,
               synthetic_examples: int = 2048) -> Tuple[ArrayDataset, int]:
    """``(dataset, num_classes)``: the binary files under ``data_dir`` when
    present, else ``synthetic_examples`` synthetic images."""
    num_classes = 100 if dataset == "cifar100" else 10
    x = None
    if data_dir and data_dir != "synthetic":
        reader = (_read_cifar100_bin if dataset == "cifar100"
                  else _read_cifar10_bin)
        try:
            x_u8, y = reader(data_dir, train)
            x = _normalize(x_u8)
        except FileNotFoundError:
            x = None
    if x is None:
        x, y = synthetic_images(synthetic_examples, (32, 32, 3), num_classes,
                                seed=0 if train else 1)
    aug = (_augment(np.random.default_rng(seed)) if train and augment
           else None)
    return ArrayDataset(x, y, batch_size, shuffle=train, seed=seed,
                        augment=aug), num_classes
