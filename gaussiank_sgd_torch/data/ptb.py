"""PTB language-model data (port of ``gaussiank_sgd_tpu/data/ptb.py``).

A word-level vocabulary from ``ptb.train.txt`` (each line's words, then
``<eos>``, ids in order of first appearance), the classic batchify (the
stream trimmed to ``batch_size`` rows of contiguous text) and bptt windows
(the target is the input shifted by one token). Without the files, the
synthetic Markov stream of ``data/synthetic.py`` stands in.

The layout depends on the global batch: ``batch_size`` here is every
worker's rows of every microbatch together, so a run at another worker
count reads the text in another layout.
"""

from __future__ import annotations

import os
from typing import Dict, Iterator, Optional, Tuple

import numpy as np

from .synthetic import synthetic_tokens


def build_vocab(path: str) -> Dict[str, int]:
    vocab: Dict[str, int] = {}
    with open(path) as f:
        for line in f:
            for w in line.split() + ["<eos>"]:
                if w not in vocab:
                    vocab[w] = len(vocab)
    return vocab


def tokenize(path: str, vocab: Dict[str, int]) -> np.ndarray:
    """int32 ids of ``path``'s words; a word outside ``vocab`` is id 0."""
    ids = []
    with open(path) as f:
        for line in f:
            for w in line.split() + ["<eos>"]:
                ids.append(vocab.get(w, 0))
    return np.asarray(ids, np.int32)


class PTBDataset:
    """Contiguous-text bptt windows: ``epoch()`` yields ``(inputs [B, T],
    targets [B, T])`` in text order, the same every epoch."""

    def __init__(self, tokens: np.ndarray, batch_size: int, bptt: int = 35):
        self.batch_size = batch_size
        self.bptt = bptt
        nb = len(tokens) // batch_size
        self.data = tokens[:nb * batch_size].reshape(batch_size, nb)
        self.steps_per_epoch = (nb - 1) // bptt
        if self.steps_per_epoch <= 0:
            raise ValueError(f"{len(tokens)} tokens make no bptt window of "
                             f"{bptt} at batch {batch_size}")

    def epoch(self, epoch_seed: Optional[int] = None
              ) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        """``epoch_seed`` is accepted for the epoch stream's interface and
        unused: the text is served in order."""
        for s in range(self.steps_per_epoch):
            i = s * self.bptt
            yield (self.data[:, i:i + self.bptt],
                   self.data[:, i + 1:i + 1 + self.bptt])

    def __iter__(self):
        while True:
            yield from self.epoch()


def make_ptb(data_dir: Optional[str] = None, split: str = "train",
             batch_size: int = 20, bptt: int = 35,
             vocab_size: int = 10000,
             synthetic_tokens_n: int = 200_000,
             synthetic_order: int = 1,
             seed: Optional[int] = None) -> Tuple[PTBDataset, int]:
    """``(dataset, vocab size)``: ``{data_dir}/ptb.{split}.txt`` with the
    vocabulary of ``ptb.train.txt`` when both exist, else the synthetic
    stream (``seed`` 0 for the train split, 1 otherwise) of
    ``synthetic_tokens_n`` tokens over ``vocab_size`` ids. ``seed`` is
    accepted and unused: the text is served in order."""
    if data_dir and data_dir != "synthetic":
        train_path = os.path.join(data_dir, "ptb.train.txt")
        path = os.path.join(data_dir, f"ptb.{split}.txt")
        if os.path.exists(train_path) and os.path.exists(path):
            vocab = build_vocab(train_path)
            return (PTBDataset(tokenize(path, vocab), batch_size, bptt),
                    len(vocab))
    toks = synthetic_tokens(synthetic_tokens_n, vocab_size,
                            seed=0 if split == "train" else 1,
                            order=synthetic_order)
    return PTBDataset(toks, batch_size, bptt), vocab_size
