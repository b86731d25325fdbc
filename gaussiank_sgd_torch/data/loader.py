"""In-memory batch iteration (port of ``ArrayDataset`` and ``EpochStream``
from ``gaussiank_sgd_tpu/data/loader.py``).

``ArrayDataset`` serves shuffled, optionally augmented minibatches over
numpy arrays. ``EpochStream`` is the trainer's train stream: epoch ``e`` is
shuffled with ``default_rng(seed + e)``, so a stream built at a global step
lands exactly where an uninterrupted run would be, the data half of an
exact resume. The reference's background prefetch thread is not ported
yet (ROADMAP A item 4): batches are drawn on the calling thread.
"""

from __future__ import annotations

from typing import Callable, Iterator, Optional, Tuple

import numpy as np


class ArrayDataset:
    """Shuffled, optionally augmented minibatches over in-memory arrays;
    drops the ragged tail of each epoch, as the reference's samplers do,
    so every worker sees the same number of steps."""

    def __init__(self, x: np.ndarray, y: np.ndarray, batch_size: int,
                 shuffle: bool = True, seed: int = 0,
                 augment: Optional[Callable] = None):
        if len(x) != len(y):
            raise ValueError(f"ragged arrays: {len(x)} != {len(y)}")
        self.x, self.y = x, y
        self.batch_size = int(batch_size)
        self.shuffle = shuffle
        self.augment = augment
        self._rng = np.random.default_rng(seed)
        self.num_examples = len(x)
        self.steps_per_epoch = self.num_examples // self.batch_size
        if self.steps_per_epoch == 0:
            raise ValueError(f"batch_size {batch_size} > dataset size "
                             f"{self.num_examples}")

    def epoch(self, epoch_seed: Optional[int] = None
              ) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        """One epoch of batches: shuffled with ``default_rng(epoch_seed)``
        when given, else with the dataset's own generator (which advances
        from epoch to epoch)."""
        order = np.arange(self.num_examples)
        if self.shuffle:
            rng = (np.random.default_rng(epoch_seed)
                   if epoch_seed is not None else self._rng)
            rng.shuffle(order)
        for s in range(self.steps_per_epoch):
            sel = order[s * self.batch_size:(s + 1) * self.batch_size]
            batch = (self.x[sel], self.y[sel])
            yield self.augment(*batch) if self.augment else batch

    def __iter__(self):
        while True:
            yield from self.epoch()


class EpochStream:
    """Endless stream of ``ds``'s epochs aligned to a global step: built at
    ``start_step``, it serves epoch ``start_step // steps_per_epoch``
    (shuffled with ``seed + epoch``) from batch ``start_step %
    steps_per_epoch`` on, replaying that epoch's earlier batches to get
    there. An augmentation generator the dataset owns is not rewound: it
    restarts with the dataset, as in the reference, so a resumed run with
    augmentation repeats the uninterrupted one exactly only inside the
    first epoch."""

    def __init__(self, ds, seed: int, start_step: int = 0):
        self._ds = ds
        self._seed = int(seed)
        self._epoch = start_step // ds.steps_per_epoch
        self._pos = start_step % ds.steps_per_epoch   # next batch index
        self._it: Optional[Iterator] = None
        self._it_pos = 0              # batches consumed from the live _it

    def __iter__(self) -> "EpochStream":
        return self

    def __next__(self):
        while True:
            if self._it is None:
                self._it = self._ds.epoch(epoch_seed=self._seed + self._epoch)
                self._it_pos = 0
            try:
                while True:
                    batch = next(self._it)
                    self._it_pos += 1
                    if self._it_pos > self._pos:
                        break
            except StopIteration:
                self._epoch += 1
                self._pos = 0
                self._it = None
                continue
            except BaseException:
                # the raise finalised the epoch's generator: the next call
                # rebuilds it and replays to this same position
                self._it = None
                raise
            self._pos += 1
            return batch
