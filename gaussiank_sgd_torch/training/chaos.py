"""Deterministic fault injection, the test harness of the resilience
runtime (port of the trainer-side injectors of
``gaussiank_sgd_tpu/training/chaos.py``).

* non-finite gradients: :func:`inject_nan_batches` poisons the batch that
  feeds chosen global steps, so the backward pass gives non-finite
  gradients as a bad record would, and the step's guard must contain them;
* process death: :func:`inject_process_death` SIGKILLs this process when
  the batch feeding a chosen step is pulled: no handler runs and nothing
  is sealed, so the pod supervisor (``training/launch.py``) must detect
  the loss and relaunch from the last sealed checkpoint;
* preemption: :func:`inject_preemption` sends this process SIGTERM when the
  batch feeding a chosen step is pulled; the trainer's
  ``GracefulShutdown`` seals a checkpoint and the run exits cleanly;
* coordinator faults: :class:`FlakyCoordinator` stands in for the process
  group's ``initialize`` and refuses the first K attempts, driving
  ``launch.bootstrap_distributed``'s retries to success or to a loud
  exhaustion without a network;
* checkpoint damage: :func:`corrupt_checkpoint` truncates, garbage-fills
  or unseals a saved checkpoint;
* transient loader errors: :class:`FlakyIterator` raises
  :class:`TransientIOError` on chosen pulls and stays resumable, and
  :class:`FlakyEpochSource` raises from inside a dataset's ``epoch``
  generator, through the trainer's own stream and ``prefetch``.

Everything keys on step or pull indices, never on randomness or time, so
a failure reproduces exactly. The stream injectors wrap the trainer's
stream factory (``Trainer._stream``), whose streams start at the current
step, so they stay keyed on the global step across rollbacks and resumes.
"""

from __future__ import annotations

import os
import signal
from typing import Callable, Iterable, Iterator, Optional, Sequence, Set

import numpy as np

from .checkpoint import MANIFEST


class TransientIOError(OSError):
    """The injected flaky-read error: an ``OSError``, so the loader's retry
    (``data/loader.py:TRANSIENT_IO_ERRORS``) treats it as a real one."""


def poison_batch(batch, fill: float = float("nan")):
    """``batch`` with every float leaf replaced by ``fill``; integer leaves
    (labels, token ids) pass through. A batch with no float leaf cannot
    carry the fault, so it raises."""
    out, hit = [], False
    for a in batch:
        a = np.asarray(a)
        if np.issubdtype(a.dtype, np.floating):
            out.append(np.full_like(a, fill))
            hit = True
        else:
            out.append(a)
    if not hit:
        raise ValueError(
            "poison_batch: no float leaf in batch; NaN injection needs a "
            "float input (use a float-input model for chaos tests)")
    return tuple(out)


def _wrap_stream(trainer, on_pull: Callable[[int, tuple], tuple]) -> None:
    """Make the trainer's stream factory return its stream with
    ``on_pull(global step, batch)`` applied to each batch. The wrapper is a
    class, so a transient error of the inner stream passes through without
    finalising it (``prefetch``'s retry keeps working), and its step
    advances only on a pull that succeeded."""
    orig = trainer._stream

    class _Wrapped:
        def __init__(self):
            self._inner = orig()
            self._step = trainer.step

        def __iter__(self):
            return self

        def __next__(self):
            batch = next(self._inner)
            s = self._step
            self._step += 1
            return on_pull(s, batch)

    trainer._stream = _Wrapped
    trainer._invalidate_data_iter()


def inject_nan_batches(trainer, steps: Iterable[int], once: bool = True,
                       fill: float = float("nan")) -> Set[int]:
    """Poison the batch feeding each global step in ``steps`` (with
    ``fill``). With ``once`` each step is poisoned the first time it is fed
    only, so a rolled-back run replays it clean (a transient bad record);
    else on every replay (a corrupt shard: drives the rollback budget).
    Returns the live set of steps poisoned so far."""
    steps = {int(s) for s in steps}
    fired: Set[int] = set()

    def on_pull(s, batch):
        if s in steps and (not once or s not in fired):
            fired.add(s)
            return poison_batch(batch, fill)
        return batch

    _wrap_stream(trainer, on_pull)
    return fired


def _signal_at(trainer, step: int, signum: int) -> None:
    """Send this process ``signum`` when the batch feeding global ``step``
    is pulled."""
    target = int(step)

    def on_pull(s, batch):
        if s == target:
            os.kill(os.getpid(), signum)
        return batch

    _wrap_stream(trainer, on_pull)


def inject_preemption(trainer, step: int,
                      signum: int = signal.SIGTERM) -> None:
    """Send this process ``signum`` when the batch feeding global ``step``
    is pulled (on the prefetch thread, so possibly ahead of the step). The
    installed ``GracefulShutdown`` handler flags it, and the trainer seals
    a checkpoint at the next step boundary and raises
    ``TrainingPreempted``."""
    _signal_at(trainer, step, signum)


def inject_process_death(trainer, step: int,
                         signum: int = signal.SIGKILL) -> None:
    """Send this process ``signum`` (a real SIGKILL by default) when the
    batch feeding global ``step`` is pulled. The pull is on the prefetch
    thread, up to three batches ahead of the step, but its stream position
    is fixed, so two runs of one config die at the same place."""
    _signal_at(trainer, step, signum)


class FlakyCoordinator:
    """A stand-in for the process group's ``initialize`` that refuses the
    first ``refusals`` attempts with ``ConnectionRefusedError`` (what a
    coordinator not yet listening gives), then calls ``inner`` if given;
    ``refusals < 0`` refuses for ever. ``calls`` counts the attempts."""

    def __init__(self, refusals: int,
                 inner: Optional[Callable[[], None]] = None):
        self.refusals = int(refusals)
        self.calls = 0
        self._inner = inner

    def __call__(self) -> None:
        self.calls += 1
        if self.refusals < 0 or self.calls <= self.refusals:
            raise ConnectionRefusedError(
                f"injected coordinator refusal "
                f"(attempt {self.calls}/{self.refusals})")
        if self._inner is not None:
            self._inner()


class FlakyIterator:
    """A resumable iterator that raises :class:`TransientIOError` on chosen
    pulls: pull ``n`` (0-based count of items returned) fails
    ``failures_per_pull`` times before its item comes through."""

    def __init__(self, it: Iterator, fail_pulls: Sequence[int],
                 failures_per_pull: int = 1):
        self._it = iter(it)
        self._remaining = {int(p): int(failures_per_pull)
                           for p in fail_pulls}
        self._pull = 0
        self.raised = 0

    def __iter__(self) -> "FlakyIterator":
        return self

    def __next__(self):
        left = self._remaining.get(self._pull, 0)
        if left > 0:
            self._remaining[self._pull] = left - 1
            self.raised += 1
            raise TransientIOError(f"injected transient failure (pull "
                                   f"{self._pull}, {left - 1} more)")
        item = next(self._it)
        self._pull += 1
        return item


class FlakyEpochSource:
    """A dataset whose ``epoch`` generator raises :class:`TransientIOError`
    in place of the chosen batch indices (``times`` times each). Assign it
    to ``trainer.train_ds``: the raise finalises the epoch's generator as a
    real flaky read would, and only the resumable ``EpochStream`` under
    ``prefetch`` survives it, replaying the same order (``epoch_seed``)."""

    def __init__(self, ds, fail_batches: Sequence[int], times: int = 1):
        self._ds = ds
        self._remaining = {int(b): int(times) for b in fail_batches}
        self.raised = 0

    def __getattr__(self, name):        # steps_per_epoch, batch_size, ...
        return getattr(self._ds, name)

    def epoch(self, epoch_seed=None):
        for i, batch in enumerate(self._ds.epoch(epoch_seed=epoch_seed)):
            if self._remaining.get(i, 0) > 0:
                self._remaining[i] -= 1
                self.raised += 1
                raise TransientIOError(f"injected flaky read (epoch batch "
                                       f"{i}, {self._remaining[i]} more)")
            yield batch


def corrupt_checkpoint(path: str, mode: str = "truncate") -> str:
    """Damage the checkpoint at ``path``: ``truncate`` halves its largest
    file (the manifest's size check then drops it from the listing),
    ``garbage`` overwrites every file but the manifest with 0xFF bytes of
    the same size (it still looks sealed; the restore's CRC check fails),
    ``unseal`` deletes the manifest (a save that never committed).
    Returns ``path``."""
    if mode not in ("truncate", "garbage", "unseal"):
        raise ValueError(f"unknown corruption mode {mode!r} "
                         "(truncate|garbage|unseal)")
    if mode == "unseal":
        os.remove(os.path.join(path, MANIFEST))
        return path
    files = [os.path.join(root, n) for root, _, names in os.walk(path)
             for n in names if n != MANIFEST]
    if not files:
        raise ValueError(f"nothing to corrupt under {path!r}")
    if mode == "truncate":
        victim = max(files, key=os.path.getsize)
        size = os.path.getsize(victim)
        with open(victim, "r+b") as f:
            f.truncate(max(size // 2, 1) if size > 1 else 0)
        return path
    for fp in files:
        size = os.path.getsize(fp)
        with open(fp, "r+b") as f:
            f.write(b"\xff" * size)
    return path
