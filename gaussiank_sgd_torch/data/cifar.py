"""CIFAR-10/100 and MNIST: file readers with synthetic stand-ins (port of
``gaussiank_sgd_tpu/data/cifar.py``).

Reads the canonical ``cifar-10-batches-bin`` / ``cifar-100-binary`` files
when ``data_dir`` holds them (pad-4 reflect crop + horizontal flip on the
train split, per-channel normalisation), and MNIST's idx files; otherwise
serves the learnable synthetic images of ``data/synthetic.py``, as the
reference does. Real CIFAR files go through :class:`CifarPipeline` (the
native assembler, ``data/native.py``) when that library loads, else
through ``ArrayDataset`` and the numpy augmentation: the reference's rule,
so the port's batches are the reference's on either path.
"""

from __future__ import annotations

import logging
import os
from typing import Callable, Iterator, Optional, Tuple

import numpy as np

from .loader import ArrayDataset
from .synthetic import flip_labels, synthetic_images

log = logging.getLogger(__name__)

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


class CifarPipeline:
    """Batches over raw u8 CIFAR records through the native assembler
    (``data/native.py``: gather, normalise, pad-4 reflect crop and flip in
    one threaded pass), with ``ArrayDataset``'s interface. Epoch ``e`` is
    shuffled with the seed ``seed * 1_000_003 + e``, and its batch ``s`` is
    augmented with the seed ``(seed * 7_919 + e) * 100_003 + s``: a batch
    depends only on its place in the stream, not on what was drawn before
    it."""

    def __init__(self, x_u8: np.ndarray, y: np.ndarray, batch_size: int,
                 shuffle: bool = True, augment: bool = True, seed: int = 0):
        from . import native
        if not native.available():
            raise RuntimeError("CifarPipeline needs the native library "
                               "(data/native.py)")
        self._native = native
        self.x_u8 = np.ascontiguousarray(x_u8)
        self.y = y.astype(np.int32)
        self.batch_size = int(batch_size)
        self.shuffle = shuffle
        self.augment = augment
        self.seed = seed
        self.num_examples = len(x_u8)
        self.steps_per_epoch = self.num_examples // self.batch_size
        if self.steps_per_epoch == 0:
            raise ValueError(f"batch_size {batch_size} > dataset size "
                             f"{self.num_examples}")
        self._epoch = 0

    def epoch(self, epoch_seed: Optional[int] = None
              ) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        """One epoch of batches; without ``epoch_seed`` the epoch count of
        this dataset."""
        e = self._epoch if epoch_seed is None else epoch_seed
        self._epoch += 1
        if self.shuffle:
            order = self._native.shuffle_indices(self.num_examples,
                                                 self.seed * 1_000_003 + e)
        else:
            order = np.arange(self.num_examples, dtype=np.int32)
        for s in range(self.steps_per_epoch):
            sel = order[s * self.batch_size:(s + 1) * self.batch_size]
            yield self._native.assemble_batch(
                self.x_u8, self.y, sel, _MEAN, _STD,
                seed=(self.seed * 7_919 + e) * 100_003 + s,
                augment=self.augment)

    def __iter__(self):
        while True:
            yield from self.epoch()


def make_cifar(dataset: str = "cifar10", data_dir: Optional[str] = None,
               train: bool = True, batch_size: int = 128,
               augment: bool = True, seed: int = 0,
               synthetic_examples: int = 2048, use_native: bool = True,
               label_noise: float = 0.0):
    """``(dataset, num_classes)``: the binary files under ``data_dir`` when
    present (through ``CifarPipeline`` when ``use_native`` and the native
    library loads, else ``ArrayDataset``), else ``synthetic_examples``
    synthetic images. ``label_noise`` flips that fraction of the labels of
    either split (``flip_labels``, seeded by the split)."""
    from . import native
    num_classes = 100 if dataset == "cifar100" else 10
    x = x_u8 = None
    if data_dir and data_dir != "synthetic":
        reader = (_read_cifar100_bin if dataset == "cifar100"
                  else _read_cifar10_bin)
        try:
            x_u8, y = reader(data_dir, train)
        except FileNotFoundError:
            x_u8 = None
    if x_u8 is not None:
        y = flip_labels(y, num_classes, label_noise, seed=0 if train else 1)
        if use_native and native.available():
            return CifarPipeline(x_u8, y, batch_size, shuffle=train,
                                 augment=train and augment,
                                 seed=seed), num_classes
        if use_native:
            log.warning("CIFAR files go through the numpy path, whose "
                        "batches differ from the native pipeline's: %s",
                        native.load_error())
        x = _normalize(x_u8)
    else:
        x, y = synthetic_images(synthetic_examples, (32, 32, 3), num_classes,
                                seed=0 if train else 1)
        y = flip_labels(y, num_classes, label_noise, seed=0 if train else 1)
    aug = (_augment(np.random.default_rng(seed)) if train and augment
           else None)
    return ArrayDataset(x, y, batch_size, shuffle=train, seed=seed,
                        augment=aug), num_classes


def make_mnist(data_dir: Optional[str] = None, train: bool = True,
               batch_size: int = 128, seed: int = 0,
               synthetic_examples: int = 2048,
               label_noise: float = 0.0) -> Tuple[ArrayDataset, int]:
    """``(dataset, 10)``: ``train-images-idx3-ubyte`` /
    ``train-labels-idx1-ubyte`` (``t10k-*`` for the test split) under
    ``data_dir`` as f32 ``(x / 255 - 0.1307) / 0.3081`` images ``[N, 28,
    28, 1]`` when both exist, else ``synthetic_examples`` synthetic ones.
    ``label_noise`` flips that fraction of the labels (``flip_labels``,
    seeded by the split)."""
    x = None
    if data_dir and data_dir != "synthetic":
        prefix = "train" if train else "t10k"
        try:
            with open(os.path.join(data_dir, f"{prefix}-images-idx3-ubyte"),
                      "rb") as f:
                xi = np.frombuffer(f.read(), np.uint8, offset=16)
            with open(os.path.join(data_dir, f"{prefix}-labels-idx1-ubyte"),
                      "rb") as f:
                y = np.frombuffer(f.read(), np.uint8,
                                  offset=8).astype(np.int32)
            x = ((xi.reshape(-1, 28, 28, 1).astype(np.float32) / 255.0
                  - 0.1307) / 0.3081)
        except FileNotFoundError:
            x = None
    if x is None:
        x, y = synthetic_images(synthetic_examples, (28, 28, 1), 10,
                                seed=0 if train else 1)
    y = flip_labels(y, 10, label_noise, seed=0 if train else 1)
    return ArrayDataset(x, y, batch_size, shuffle=train, seed=seed), 10
