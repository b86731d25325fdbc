"""Deterministic synthetic data — learnable, not noise (copies of
``synthetic_images``, ``synthetic_images_u8``, ``synthetic_tokens``,
``flip_labels``, ``synthetic_seq2seq`` and ``synthetic_spectrograms`` from
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


def synthetic_tokens(num_tokens: int, vocab_size: int, seed: int = 0,
                     order: int = 1, task_seed: int = 12345) -> np.ndarray:
    """An int32 token stream from a sparse random Markov chain: the
    transition table (the task) from ``task_seed``, the walk from ``seed``.
    Order 1 conditions on the previous token; order 2 on the previous two,
    so the first prediction of a bptt window depends on the window before
    (the setting where carrying the hidden state helps). Order 2 needs
    ``vocab_size <= 512`` (a dense ``[V, V, 4]`` table)."""
    task_rng = np.random.default_rng(task_seed)
    rng = np.random.default_rng(seed)
    toks = np.empty(num_tokens, np.int32)
    jumps = rng.random(num_tokens)
    picks = rng.integers(0, 4, size=num_tokens)
    if order == 1:
        succ = task_rng.integers(0, vocab_size, size=(vocab_size, 4))
        s = 0
        for i in range(num_tokens):
            s = int(succ[s, picks[i]]) if jumps[i] > 0.1 else int(
                rng.integers(0, vocab_size))
            toks[i] = s
        return toks
    if order == 2:
        if vocab_size > 512:
            raise ValueError(
                f"order-2 synthetic stream needs vocab_size <= 512 (dense "
                f"V^2 successor table); got {vocab_size}")
        succ = task_rng.integers(0, vocab_size,
                                 size=(vocab_size, vocab_size, 4))
        s2, s1 = 0, 0
        for i in range(num_tokens):
            s = int(succ[s2, s1, picks[i]]) if jumps[i] > 0.1 else int(
                rng.integers(0, vocab_size))
            s2, s1 = s1, s
            toks[i] = s
        return toks
    raise ValueError(f"unsupported markov order {order}")


def synthetic_seq2seq(num: int, src_len: int, tgt_len: int, vocab_size: int,
                      pad_id: int = 0, seed: int = 0):
    """Copy-reverse pairs: ``tgt = reversed(src)[:tgt_len]``, ids in
    ``[1, vocab_size)`` (0 is the pad)."""
    rng = np.random.default_rng(seed)
    src = rng.integers(1, vocab_size, size=(num, src_len)).astype(np.int32)
    tgt = src[:, ::-1][:, :tgt_len].copy()
    return src, tgt


def flip_labels(y: np.ndarray, num_classes: int, fraction: float,
                seed: int = 0) -> np.ndarray:
    """Symmetric label noise: ``fraction`` of the labels, drawn from
    ``seed``, move to a uniformly random other class."""
    if fraction <= 0:
        return y
    rng = np.random.default_rng(seed * 1_000_003 + 777)
    flip = rng.random(len(y)) < fraction
    offs = rng.integers(1, num_classes, size=len(y)).astype(y.dtype)
    return np.where(flip, (y + offs) % num_classes, y)


def synthetic_spectrograms(num: int, freq: int, time: int, num_labels: int,
                           tgt_len: int, seed: int = 0):
    """``[num, freq, time]`` f32 spectrograms whose frame energy spells a
    label sequence (CTC-learnable): ``tgt_len`` labels in ``[1,
    num_labels)`` a row, label j lighting an 8-bin band at ``lab * freq //
    num_labels`` over the j-th of ``tgt_len`` equal time segments."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(1, num_labels, size=(num, tgt_len)).astype(np.int32)
    x = rng.normal(0, 0.1, size=(num, freq, time)).astype(np.float32)
    seg = time // tgt_len
    for i in range(num):
        for j, lab in enumerate(labels[i]):
            band = (lab * freq) // num_labels
            x[i, band:band + 8, j * seg:(j + 1) * seg] += 1.0
    return x, labels
