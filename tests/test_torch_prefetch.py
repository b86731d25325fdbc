"""The port's prefetching loader (``data/loader.py:prefetch``) and the
trainer's stream through it, held to the reference's own tests of the same
code (``tests/test_resilience.py``, the prefetch and stream section): the
same iterators, faults and expectations, against the port.

Then what is the port's own: the trainer draws through the prefetch thread
exactly the batches of ``EpochStream``; invalidating the stream stops its
thread, so an abandoned stream pulls nothing more and holds nothing; an
``io_retry`` event lands in the metrics file from the thread; and a stress
run of many prefetch threads with a short switch interval loses, repeats
and reorders nothing.
"""

import json
import os
import sys
import threading

import numpy as np
import pytest
import torch

from gaussiank_sgd_torch import data as data_lib
from gaussiank_sgd_torch.training import chaos
from gaussiank_sgd_torch.training.config import TrainConfig
from gaussiank_sgd_torch.training.trainer import Trainer, _host_rows


def make_cfg(tmp_path, **kw):
    """The reference test's run, at one worker: mnistnet on synthetic MNIST
    (no augmentation, so a replayed epoch repeats its batches)."""
    base = dict(dnn="mnistnet", dataset="mnist", batch_size=8, nworkers=1,
                lr=0.05, momentum=0.9, weight_decay=0.0, epochs=1,
                max_steps=12, compressor="gaussian", density=0.01,
                compress_warmup_steps=4, warmup_epochs=0.0,
                compute_dtype="float32", output_dir=str(tmp_path),
                log_every=5, eval_every_epochs=0, save_every_epochs=0,
                seed=0, device="cpu")
    base.update(kw)
    return TrainConfig(**base)


def read_events(t, kind=None):
    with open(t.metrics_path) as f:
        recs = [json.loads(line) for line in f]
    return [r for r in recs if kind is None or r.get("event") == kind]


def _prefetch_threads():
    return [t for t in threading.enumerate() if t.name == "prefetch"]


# the reference's tests, against the port ------------------------------

def test_prefetch_retries_transient_io_errors():
    items = list(range(6))
    flaky = chaos.FlakyIterator(iter(items), fail_pulls=[1, 4],
                                failures_per_pull=2)
    events = []
    out = list(data_lib.prefetch(flaky, depth=2, max_retries=3,
                                 backoff_s=0.001, on_event=events.append))
    assert out == items              # nothing lost, order kept
    assert flaky.raised == 4
    assert [e["event"] for e in events] == ["io_retry"] * 4
    assert [e["attempt"] for e in events] == [1, 2, 1, 2]
    assert all(e["max_retries"] == 3 for e in events)
    assert [e["backoff_s"] for e in events] == [0.001, 0.002] * 2


def test_prefetch_retry_exhaustion_propagates():
    flaky = chaos.FlakyIterator(iter(range(3)), fail_pulls=[0],
                                failures_per_pull=10)
    gen = data_lib.prefetch(flaky, depth=1, max_retries=2, backoff_s=0.001)
    with pytest.raises(RuntimeError, match="prefetch thread failed") as ei:
        list(gen)
    assert isinstance(ei.value.__cause__, chaos.TransientIOError)
    assert flaky.raised == 3         # the first pull and 2 retries


def test_prefetch_zero_retries_is_passthrough():
    flaky = chaos.FlakyIterator(iter(range(3)), fail_pulls=[1])
    with pytest.raises(RuntimeError, match="prefetch thread failed"):
        list(data_lib.prefetch(flaky, depth=1))


def test_prefetch_generator_source_error_not_swallowed():
    """A transient error finalises a generator source, so the retry's
    ``next`` meets StopIteration; the original error must surface, not a
    quiet end of the stream."""
    def gen():
        yield 0
        yield 1
        raise chaos.TransientIOError("disk vanished")

    out = []
    it = data_lib.prefetch(gen(), depth=1, max_retries=3, backoff_s=0.001)
    with pytest.raises(RuntimeError, match="prefetch thread failed") as ei:
        for x in it:
            out.append(x)
    assert out == [0, 1]
    assert isinstance(ei.value.__cause__, chaos.TransientIOError)


def test_epoch_stream_matches_generator_and_resumes():
    """``EpochStream`` equals the epoch-looping generator at every resume
    offset and survives a mid-epoch transient error: the retried pull
    returns the batch the clean stream would have."""
    x = np.arange(20, dtype=np.float32)
    ds = data_lib.ArrayDataset(x, x, batch_size=4, seed=0)   # 5 an epoch

    def ref_stream(start):
        ep, skip = start // 5, start % 5
        while True:
            for i, b in enumerate(ds.epoch(epoch_seed=7 + ep)):
                if skip and i < skip:
                    continue
                yield b
            skip = 0
            ep += 1

    for start in (0, 3, 7):
        s = data_lib.EpochStream(ds, 7, start)
        ref = ref_stream(start)
        for _ in range(12):          # across epoch ends
            np.testing.assert_array_equal(next(s)[0], next(ref)[0])

    flaky = chaos.FlakyEpochSource(ds, fail_batches=[2], times=1)
    s = data_lib.EpochStream(flaky, 7, 0)
    ref = ref_stream(0)
    for _ in range(8):
        while True:
            try:
                batch = next(s)
                break
            except chaos.TransientIOError:
                continue             # the retrying consumer's move
        np.testing.assert_array_equal(batch[0], next(ref)[0])
    assert flaky.raised == 1


def test_trainer_stream_survives_transient_io(tmp_path):
    """A transient error raised by the dataset inside the trainer's own
    prefetched stream is retried: every step runs, the ``io_retry`` events
    are on record, and the trajectory is the unfaulted run's."""
    base = Trainer(make_cfg(tmp_path / "base", max_steps=6, log_every=50))
    base_rec = base.train(6)
    base.close()

    t = Trainer(make_cfg(tmp_path / "flaky", max_steps=6, log_every=50,
                         io_backoff_s=0.001))
    flaky = chaos.FlakyEpochSource(t.train_ds, fail_batches=[2], times=2)
    t.train_ds = flaky
    rec = t.train(6)
    assert t.step == 6
    assert flaky.raised == 2
    retries = read_events(t, "io_retry")
    assert [r["attempt"] for r in retries] == [1, 2]
    assert all(r["max_retries"] == 3 for r in retries)
    # the same batches in the same order: the same losses
    assert rec["loss"] == base_rec["loss"]
    assert [r["loss"] for r in t.records] == [r["loss"]
                                              for r in base.records]
    t.close()


def test_trainer_stream_retry_exhaustion_fails_loud(tmp_path):
    """A persistent loader fault spends ``io_retries`` and ends the run
    with the original error as the cause."""
    t = Trainer(make_cfg(tmp_path, max_steps=6, io_backoff_s=0.001))
    flaky = chaos.FlakyEpochSource(t.train_ds, fail_batches=[1], times=10)
    t.train_ds = flaky
    with pytest.raises(RuntimeError, match="prefetch thread failed") as ei:
        t.train(4)
    assert isinstance(ei.value.__cause__, chaos.TransientIOError)
    assert flaky.raised == 4         # the first read and 3 retries
    t.close()


# the port's own --------------------------------------------------------

@pytest.mark.parametrize("start", [0, 250])
def test_trainer_draws_epoch_stream_through_the_thread(tmp_path, start):
    """Through the prefetch thread the trainer draws ``EpochStream``'s
    batches, as CPU tensors of the stream's dtypes, from step 0 and from a
    step the state was moved to (across an epoch's end: 256 steps an
    epoch)."""
    t = Trainer(make_cfg(tmp_path))
    if start:
        t.state.step = start
        t.state = t.state            # an assignment drops the old stream
    ref = data_lib.EpochStream(t.train_ds, 0, start)
    for _ in range(8):
        x, y = t.next_batch()
        jx, jy = next(ref)
        assert x.dtype == torch.float32 and y.dtype == torch.int32
        np.testing.assert_array_equal(x.numpy(), jx)
        np.testing.assert_array_equal(y.numpy(), jy)
    t.close()


def test_invalidating_the_stream_stops_its_thread(tmp_path):
    """The prefetch thread runs ahead and blocks on its full queue; the
    stream's invalidation (a rollback, a restore, an assigned state) stops
    and joins it, and ``close`` stops the last one."""
    before = len(_prefetch_threads())
    t = Trainer(make_cfg(tmp_path))
    t.next_batch()
    assert len(_prefetch_threads()) == before + 1
    first = t._iter
    t._invalidate_data_iter()
    assert t._iter is None and len(_prefetch_threads()) == before
    with pytest.raises(StopIteration):
        next(first)                  # the old stream is closed
    t.next_batch()
    assert len(_prefetch_threads()) == before + 1
    t.close()
    assert len(_prefetch_threads()) == before


def test_host_rows_shards_and_copies():
    """The thread's transform: this rank's rows of the global batch as CPU
    tensors (pinned only on the card's path)."""
    x = np.arange(24, dtype=np.float32).reshape(4, 6)
    y = np.arange(4, dtype=np.int32)
    tx, ty = _host_rows(1, 2, False)((x, y))
    np.testing.assert_array_equal(tx.numpy(), x[2:])
    np.testing.assert_array_equal(ty.numpy(), y[2:])


def test_prefetch_stress_many_threads_short_switch_interval():
    """More prefetch threads than cores, a 1 us switch interval, faults on
    every fifth pull: every stream yields all its items once, in order,
    and every thread is gone after its stream ends."""
    alive = set(_prefetch_threads())
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        n_streams = 2 * (os.cpu_count() or 1) + 2
        results = [None] * n_streams

        def consume(i):
            src = chaos.FlakyIterator(iter(range(200)),
                                      fail_pulls=range(0, 200, 5))
            results[i] = list(data_lib.prefetch(
                src, depth=2, max_retries=1, backoff_s=0.0))

        workers = [threading.Thread(target=consume, args=(i,))
                   for i in range(n_streams)]
        for w in workers:
            w.start()
        for w in workers:
            w.join(timeout=60)
        assert not any(w.is_alive() for w in workers)
        assert all(r == list(range(200)) for r in results)
    finally:
        sys.setswitchinterval(old)
    started = set(_prefetch_threads()) - alive
    for th in started:
        th.join(timeout=10)
    assert not any(th.is_alive() for th in started)
