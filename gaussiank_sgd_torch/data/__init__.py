"""Datasets (port of ``gaussiank_sgd_tpu/data``): CIFAR, MNIST, ImageNet,
PTB, AN4 and WMT, each with its synthetic stand-in."""

from __future__ import annotations

import functools
import glob
import os
from typing import Optional, Tuple

import numpy as np

from .cifar import make_cifar, make_mnist
from .loader import (TRANSIENT_IO_ERRORS, ArrayDataset, BucketedDataset,
                     EpochStream, prefetch)
from .ptb import PTBDataset, make_ptb
from .synthetic import (synthetic_images, synthetic_images_u8,
                        synthetic_seq2seq, synthetic_spectrograms,
                        synthetic_tokens)


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


def make_an4(data_dir: Optional[str] = None, train: bool = True,
             batch_size: int = 16, seed: int = 0,
             synthetic_examples: int = 256, tgt_len: Optional[int] = None,
             widths: Tuple[int, ...] = (100, 200, 400, 800),
             freq: int = 161, time: int = 200,
             num_labels: Optional[int] = None):
    """``(dataset, number of CTC labels)`` for AN4 speech.

    ``{data_dir}/an4_{train|val}_manifest.csv`` (DeepSpeech manifest rows
    ``wav_path,transcript_path``) when it exists: each wav featurised
    (``data/audio.py``), padded to the smallest of ``widths`` frames that
    holds it, its transcript to ``tgt_len`` label slots (64 by default),
    served as a ``BucketedDataset``. A directory with another split's
    manifest but not this one raises ``FileNotFoundError``: real audio is
    never mixed with synthetic spectrograms. Otherwise
    ``synthetic_examples`` synthetic spectrograms ``[freq, time]`` with
    ``tgt_len`` (8 by default) labels below ``num_labels`` (29)."""
    if data_dir and data_dir != "synthetic":
        from .audio import NUM_LABELS, featurize_manifest
        split = "train" if train else "val"
        manifest = os.path.join(data_dir, f"an4_{split}_manifest.csv")
        if os.path.exists(manifest):
            buckets = featurize_manifest(manifest, widths,
                                         tgt_len=tgt_len or 64)
            return (_bucketed_from_arrays(buckets, batch_size, train, seed),
                    NUM_LABELS)
        other = glob.glob(os.path.join(data_dir, "an4_*_manifest.csv"))
        if other:
            raise FileNotFoundError(
                f"{manifest} not found, but {sorted(other)} exist in "
                f"{data_dir}; provide the {split} manifest (or use "
                f"data_dir='synthetic' for the all-synthetic fallback)")
    nl = num_labels or 29
    x, y = synthetic_spectrograms(synthetic_examples, freq, time, nl,
                                  tgt_len or 8, seed=0 if train else 1)
    return ArrayDataset(x, y, batch_size, shuffle=train, seed=seed), nl


def _bucketed_from_arrays(buckets, batch_size: int, train: bool,
                          seed: int) -> BucketedDataset:
    """A ``BucketedDataset`` over ``(x [N, F, W], y)`` buckets in ascending
    width: a bucket of fewer than ``batch_size`` examples is padded to the
    next width and joins that bucket, and one left over at the end joins
    the widest pool (pool i shuffles with ``seed + i``)."""
    def pad_to(x, w):
        return (np.pad(x, ((0, 0), (0, 0), (0, w - x.shape[2])))
                if x.shape[2] < w else x)

    merged, pending = [], None
    for x, y in buckets:
        if pending is not None:
            px, py = pending
            x = np.concatenate([pad_to(px, x.shape[2]), x])
            y = np.concatenate([py, y])
            pending = None
        if len(x) < batch_size:
            pending = (x, y)
        else:
            merged.append((x, y))
    if pending is not None:
        if not merged:
            raise ValueError(
                f"AN4 manifest has {len(pending[0])} usable examples, "
                f"fewer than batch_size={batch_size}")
        x, y = merged[-1]
        px, py = pending
        w = max(x.shape[2], px.shape[2])
        merged[-1] = (np.concatenate([pad_to(x, w), pad_to(px, w)]),
                      np.concatenate([y, py]))
    pools = [ArrayDataset(x, y, batch_size, shuffle=train, seed=seed + i)
             for i, (x, y) in enumerate(merged)]
    return BucketedDataset(pools, seed=seed)


def make_wmt(data_dir: Optional[str] = None, train: bool = True,
             batch_size: int = 64, src_len: int = 64, tgt_len: int = 64,
             vocab_size: int = 32000, seed: int = 0,
             synthetic_examples: int = 4096) -> Tuple[ArrayDataset, int]:
    """``(dataset of (src, tgt) id pairs, vocab size)`` for WMT14 En-De.
    ``{data_dir}/{split}.en`` and ``{split}.de`` (split ``train`` or
    ``val``) when both exist, tokenized with the joint BPE vocabulary of
    the train split (``data/wmt.py``). A directory that holds other
    ``*.en``/``*.de`` files but not this split raises
    ``FileNotFoundError``: real and synthetic text are never mixed. With no
    such files, ``synthetic_examples`` copy-reverse pairs stand in."""
    if data_dir and data_dir != "synthetic":
        split = "train" if train else "val"
        en = os.path.join(data_dir, f"{split}.en")
        de = os.path.join(data_dir, f"{split}.de")
        if os.path.exists(en) and os.path.exists(de):
            from .wmt import load_wmt_corpus
            src, tgt, tok = load_wmt_corpus(data_dir, split, src_len,
                                            tgt_len, vocab_size)
            return (ArrayDataset(src, tgt, batch_size, shuffle=train,
                                 seed=seed), tok.vocab_size)
        other = [p for pat in ("*.en", "*.de")
                 for p in glob.glob(os.path.join(data_dir, pat))]
        if other:
            raise FileNotFoundError(
                f"{en} / {de} not found, but {sorted(other)} exist in "
                f"{data_dir}; provide the {split} split (or use "
                f"data_dir='synthetic' for the all-synthetic fallback)")
    src, tgt = synthetic_seq2seq(synthetic_examples, src_len, tgt_len,
                                 vocab_size, seed=0 if train else 1)
    return (ArrayDataset(src, tgt, batch_size, shuffle=train, seed=seed),
            vocab_size)


# ``--dataset`` names whose cardinality is a vocabulary's size
TEXT_DATASETS = ("ptb", "wmt14", "wmt")


def make_dataset(dataset: str, data_dir: Optional[str] = None,
                 train: bool = True, batch_size: int = 128, **kw):
    """``(dataset, cardinality)`` by ``--dataset`` name: the number of
    classes, the vocabulary's size for ``ptb`` and ``wmt``, or the CTC
    labels for ``an4``."""
    dataset = dataset.lower()
    if dataset in ("cifar10", "cifar100"):
        return make_cifar(dataset, data_dir, train, batch_size, **kw)
    if dataset == "mnist":
        return make_mnist(data_dir, train, batch_size, **kw)
    if dataset == "imagenet":
        return make_imagenet(data_dir, train, batch_size, **kw)
    if dataset == "ptb":
        return make_ptb(data_dir, "train" if train else "valid", batch_size,
                        **kw)
    if dataset == "an4":
        return make_an4(data_dir, train, batch_size, **kw)
    if dataset in ("wmt14", "wmt"):
        return make_wmt(data_dir, train, batch_size, **kw)
    raise ValueError(f"unknown dataset {dataset!r}")


__all__ = ["ArrayDataset", "BucketedDataset", "EpochStream", "PTBDataset",
           "TEXT_DATASETS", "TRANSIENT_IO_ERRORS", "make_an4", "make_cifar",
           "make_dataset", "make_imagenet", "make_mnist", "make_ptb",
           "make_wmt", "prefetch",
           "synthetic_images", "synthetic_images_u8", "synthetic_seq2seq",
           "synthetic_spectrograms", "synthetic_tokens"]
