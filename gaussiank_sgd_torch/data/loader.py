"""Host-side batch iteration (port of
``gaussiank_sgd_tpu/data/loader.py``).

``ArrayDataset`` serves shuffled, optionally augmented minibatches over
numpy arrays; ``BucketedDataset`` interleaves the batches of several of
them, one a fixed frame width (AN4's length buckets). ``EpochStream`` is
the trainer's train stream: epoch ``e`` is shuffled with ``default_rng(seed
+ e)``, so a stream built at a global step lands exactly where an
uninterrupted run would be, the data half of an exact resume.
``prefetch`` runs a stream on a background thread, a few batches ahead of
the step, and retries transient read errors.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Dict, Iterator, Optional, Sequence, Tuple

import numpy as np

# Errors ``prefetch`` retries with backoff: the OSError family covers flaky
# disks and network file systems (``training/chaos.py:TransientIOError`` is
# one). Anything else is a program error and propagates at once.
TRANSIENT_IO_ERRORS: Tuple[type, ...] = (OSError,)


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


class BucketedDataset:
    """Batches from length-homogeneous pools (``ArrayDataset`` each, all of
    one batch size): every batch comes from one pool, so it has one of a
    few fixed widths. An epoch runs every pool's epoch once, its batches
    interleaved in a schedule shuffled with ``default_rng(epoch_seed)``
    (else the dataset's own generator), each pool shuffled with the same
    ``epoch_seed``."""

    def __init__(self, pools: Sequence[ArrayDataset], seed: int = 0):
        if not pools:
            raise ValueError("BucketedDataset needs at least one pool")
        self.pools = list(pools)
        self.steps_per_epoch = sum(p.steps_per_epoch for p in pools)
        self.num_examples = sum(p.num_examples for p in pools)
        self._rng = np.random.default_rng(seed)

    def epoch(self, epoch_seed: Optional[int] = None
              ) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        rng = (np.random.default_rng(epoch_seed) if epoch_seed is not None
               else self._rng)
        schedule = np.repeat(np.arange(len(self.pools)),
                             [p.steps_per_epoch for p in self.pools])
        rng.shuffle(schedule)
        iters = [p.epoch(epoch_seed=epoch_seed) for p in self.pools]
        for i in schedule:
            yield next(iters[i])


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


class _Failed:
    """What the prefetch thread queues when its source raised."""

    def __init__(self, error: BaseException):
        self.error = error


def prefetch(it: Iterator, depth: int = 2, max_retries: int = 0,
             backoff_s: float = 0.05, max_backoff_s: float = 2.0,
             on_event: Optional[Callable[[Dict], None]] = None) -> Iterator:
    """``it`` run on a daemon thread that keeps ``depth`` items ready.

    A pull that raises one of :data:`TRANSIENT_IO_ERRORS` is retried up to
    ``max_retries`` times, after ``min(backoff_s * 2**(attempt - 1),
    max_backoff_s)`` seconds, then propagates; each retry first calls
    ``on_event`` (on the thread) with an ``io_retry`` record. A retry needs
    a resumable source such as :class:`EpochStream`: a generator is
    finalised by its first raise, and then the original error is raised
    again rather than ending the stream quietly. An error of the source
    reaches the consumer as ``RuntimeError("data prefetch thread
    failed")`` from it.

    The thread starts at the first ``next``. Closing the returned generator
    (or dropping it) stops the thread and waits for it, so an abandoned
    stream neither keeps pulling nor holds its batches.
    """
    q: "queue.Queue" = queue.Queue(maxsize=depth)
    stop = threading.Event()
    end = object()

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.05)
                return True
            except queue.Full:
                pass
        return False

    def pull(src: Iterator):
        attempt = 0
        last_err: Optional[BaseException] = None
        while True:
            try:
                return next(src)
            except StopIteration:
                if last_err is not None:
                    # a generator source finalised by the error it raised:
                    # its end is that failure, not the end of the stream
                    raise last_err
                raise
            except TRANSIENT_IO_ERRORS as e:
                last_err = e
                attempt += 1
                if attempt > max_retries:
                    raise
                delay = min(backoff_s * 2.0 ** (attempt - 1), max_backoff_s)
                if on_event is not None:
                    on_event({"event": "io_retry", "attempt": attempt,
                              "max_retries": max_retries,
                              "backoff_s": round(delay, 6),
                              "error": repr(e)})
                stop.wait(delay)

    def worker():
        try:
            src = iter(it)
            while not stop.is_set():
                try:
                    item = pull(src)
                except StopIteration:
                    put(end)
                    return
                if not put(item):
                    return
        except BaseException as e:  # noqa: BLE001 -- raised in the consumer
            put(_Failed(e))

    t = threading.Thread(target=worker, name="prefetch", daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is end:
                return
            if isinstance(item, _Failed):
                raise RuntimeError("data prefetch thread failed") from (
                    item.error)
            yield item
    finally:
        stop.set()
        if t is not threading.current_thread():
            t.join()
