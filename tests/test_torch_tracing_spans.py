"""The port's per-step spans and its host-sync counter
(``gaussiank_sgd_torch/telemetry/tracing.py``: ``TraceContext.phase``,
``count``, the step store and ``active()``; wired into ``Trainer.train``
and ``DPTrainStep``), on the CPU:

* with ``trace="off"`` a run opens no profiler range and touches no store;
* with ``trace="on"`` under ``torch.profiler`` every ranged span lands in
  the trace once a step, the store-only ones (``step_dispatch``,
  ``fwd_bwd``, ``backward``: each encloses the backward) never, each bus
  record in a ``span_record`` range, no range named ``gk.*``; the store
  holds every span of each step under its step number, no child longer
  than its parent;
* a span's bus ``t0`` and its range's ``ts`` + ``baseTimeNanoseconds`` are
  one clock;
* ``host_syncs`` counts each synchronise, blocking copy and host read of
  the loop, the same on the sequential, pipelined and dense steps;
* at two gloo ranks the stop flag, the guard and the exchange are timed
  once a step on each rank.
"""

import json
import statistics
from collections import Counter

import numpy as np
import pytest
import torch

from gaussiank_sgd_torch.telemetry import EventBus, MemoryExporter, tracing
from gaussiank_sgd_torch.telemetry.tracing import TraceContext
from gaussiank_sgd_torch.training.config import TrainConfig
from gaussiank_sgd_torch.training.trainer import Trainer
from test_torch_distributed import _spawn

NARROW = [8, "M", 8, "M", 16, "M", 16, "M", 16, "M"]
EVERY = 4
# spans that open a profiler range, each once a step
RANGED = ("data_wait", "step_sync", "step_record", "stop_flag", "bn_state",
          "forward", "bn_sync", "compress", "exchange", "guard", "update",
          "commit")
# spans kept in the store only: each encloses the backward
STORE_ONLY = ("step_dispatch", "fwd_bwd", "backward")
# a step's waits outside the log interval: three synchronises, the reads
# of loss, acc, num_selected and skipped, and on a fed stream the batch's
# two blocking copies
SYNCS, READS, COPIES = 3, 4, 2
STEP_SYNCS = SYNCS + READS + COPIES


def _cfg(tmp_path, run_id, **kw):
    base = dict(dnn="vgg16", batch_size=8, lr=0.01,
                compressor="gaussian_fused", density=0.01,
                compress_warmup_steps=1, max_steps=100, log_every=EVERY,
                compute_dtype="float32", eval_every_epochs=0,
                save_every_epochs=0, device="cpu",
                model_kwargs={"cfg": NARROW}, output_dir=str(tmp_path),
                run_id=run_id)
    base.update(kw)
    return TrainConfig(**base)


def _feed(seed=0):
    """Global batches of 8 CIFAR-shaped rows, as host arrays."""
    rng = np.random.default_rng(seed)
    while True:
        yield (rng.normal(size=(8, 32, 32, 3)).astype(np.float32),
               rng.integers(0, 10, size=8).astype(np.int32))


def _profiled(fn, path):
    """``fn()`` under ``torch.profiler`` (CPU): ``(its "X" events, the
    trace's baseTimeNanoseconds)``."""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        fn()
    prof.export_chrome_trace(str(path))
    with open(path) as f:
        data = json.load(f)
    return ([e for e in data["traceEvents"] if e.get("ph") == "X"],
            data.get("baseTimeNanoseconds", 0))


def _ranges(events):
    return [e for e in events if e.get("cat") == "user_annotation"]


def test_tracing_off_opens_no_range_and_stores_nothing(tmp_path,
                                                       monkeypatch):
    touched = []
    monkeypatch.setattr(tracing, "_range",
                        lambda name, ranged=True: touched.append(name))
    for name in ("begin_step", "_record", "count"):
        monkeypatch.setattr(TraceContext, name,
                            lambda self, *a, _n=name, **k: touched.append(_n))
    t = Trainer(_cfg(tmp_path, "off", trace="off"))
    assert t.trace is None and t.ts.tracer is None
    events, _ = _profiled(lambda: t.train(10), tmp_path / "off.json")
    t.close()
    assert [r["kind"] for r in t.records] == ["dense"] + ["sparse"] * 9
    assert not touched
    spans = set(RANGED + STORE_ONLY + ("log_interval",))
    assert not spans & {e["name"] for e in _ranges(events)}


@pytest.fixture(scope="module")
def traced_run(tmp_path_factory):
    """A traced trainer past its dense step, then one log interval of
    sparse steps under the profiler on a fed stream: ``(its step store,
    the interval's steps, the profiler's events, baseTimeNanoseconds, the
    bus records)``."""
    tmp = tmp_path_factory.mktemp("traced")
    t = Trainer(_cfg(tmp, "on", trace="on"))
    feed = _feed()
    t.train(EVERY, feed)
    events, base = _profiled(lambda: t.train(EVERY, feed), tmp / "on.json")
    store = t.trace.steps()
    assert tracing.active() is t.trace
    t.close()
    assert tracing.active() is None
    with open(t.metrics_path) as f:
        recs = [json.loads(line) for line in f]
    steps = list(range(EVERY + 1, 2 * EVERY + 1))
    return store, steps, events, base, recs


def test_traced_steps_open_their_ranges_and_fill_the_store(traced_run):
    store, steps, events, _, _ = traced_run
    ranges = Counter(e["name"] for e in _ranges(events))
    for name in RANGED:
        assert ranges[name] == EVERY, name
    assert ranges["log_interval"] == 1
    # the bus records of data_wait and step_dispatch, each in a range
    assert ranges[tracing.SPAN_RECORD] == 2 * EVERY
    assert not any(name.startswith("gk.") for name in ranges)
    assert not set(STORE_ONLY) & set(ranges)
    assert list(store)[-EVERY:] == steps
    for step in steps:
        entry = store[step]
        want = set(RANGED + STORE_ONLY)
        if step % EVERY == 0:
            want.add("log_interval")
        assert set(entry["ms"]) == want, step
        assert all(entry["calls"][name] == 1 for name in want)
        ms = entry["ms"]
        assert ms["step_sync"] <= ms["step_dispatch"]
        assert (ms["bn_state"] + ms["forward"] + ms["backward"]
                + ms["bn_sync"]) <= ms["fwd_bwd"] <= ms["step_dispatch"]
        assert entry["counts"]["host_syncs"] >= STEP_SYNCS


def test_bus_spans_and_profiler_ranges_share_one_clock(traced_run):
    _, _, events, base, recs = traced_run
    waits = [r for r in recs
             if r["event"] == "span" and r["name"] == "data_wait"][-EVERY:]
    ranged = sorted((e for e in _ranges(events)
                     if e["name"] == "data_wait"), key=lambda e: e["ts"])
    assert len(waits) == len(ranged) == EVERY and base
    # each range opens inside its span (a process's first range spends a
    # while setting up, a loaded host may preempt): the clocks agree to
    # within the span's own length, and their median offset within 1 ms
    offsets = [(ev["ts"] + base / 1e3) * 1e-6 - rec["t0"]
               for rec, ev in zip(waits, ranged)]
    for off, rec in zip(offsets, waits):
        assert -1e-4 <= off <= rec["dur_ms"] * 1e-3, (off, rec["dur_ms"])
    assert statistics.median(abs(off) for off in offsets) < 1e-3


def test_the_store_keeps_its_last_steps_and_reads_as_a_mapping(
        monkeypatch):
    monkeypatch.setattr(tracing, "KEEP_STEPS", 3)
    tc = TraceContext(EventBus([MemoryExporter()]))
    tc.count("host_syncs")                    # before any step: step 0
    for step in range(1, 6):
        tc.begin_step(step)
        with tc.phase("forward"):
            tc.count("host_syncs", 2)
        with tc.phase("forward"):
            pass
        with tc.span("data_wait", step=step):
            pass
    tc.begin_step(4)                          # reached again: a new entry
    store = tc.steps()
    assert list(store) == [3, 5, 4]
    assert store[5]["calls"] == {"forward": 2, "data_wait": 1}
    assert store[5]["counts"] == {"host_syncs": 2}
    assert store[4] == {"ms": {}, "calls": {}, "counts": {}}
    store[5]["counts"]["host_syncs"] = 99     # a copy
    assert tc.steps()[5]["counts"]["host_syncs"] == 2


@pytest.mark.parametrize("path,kw", [
    ("sequential", {}),
    ("pipelined", {"bucket_policy": "uniform", "bucket_size": 4096}),
    ("dense", {"compress_warmup_steps": 100}),
])
def test_host_syncs_count_every_wait_the_loop_asks_for(tmp_path,
                                                       monkeypatch, path,
                                                       kw):
    """Each step's ``host_syncs`` equals the waits made in it, counted
    apart: the trainer's synchronise calls, every read of a tensor to the
    host (``float``, ``item``, ``tolist``) and the batch's two blocking
    copies; a step outside the log interval makes the same waits on each
    path."""
    t = Trainer(_cfg(tmp_path, path, trace="on", **kw))
    assert t.ts.overlap == ("pipelined" if path == "pipelined" else "off")
    feed = _feed()
    t.train(EVERY, feed)
    waits = Counter()                  # step -> waits made in it

    def counted(fn):
        def call(*a, **k):
            waits[next(reversed(t.trace.steps()))] += 1
            return fn(*a, **k)
        return call

    for name in ("__float__", "item", "tolist"):
        monkeypatch.setattr(torch.Tensor, name,
                            counted(getattr(torch.Tensor, name)))
    monkeypatch.setattr(t, "_sync", counted(t._sync))
    t.train(EVERY, feed)
    store = t.trace.steps()
    t.close()
    steps = list(range(EVERY + 1, 2 * EVERY + 1))
    for step in steps:
        assert (store[step]["counts"]["host_syncs"]
                == waits[step] + COPIES), step
    kinds = {r["kind"] for r in t.records[-EVERY:]}
    assert kinds == {"dense" if path == "dense" else "sparse"}
    assert [store[s]["counts"]["host_syncs"] for s in steps[:-1]] == [
        STEP_SYNCS] * (EVERY - 1)
    assert store[steps[-1]]["counts"]["host_syncs"] > STEP_SYNCS


def _w_spans(rank, world, out_dir, narrow, every):
    from gaussiank_sgd_torch.training.config import TrainConfig
    from gaussiank_sgd_torch.training.trainer import Trainer
    t = Trainer(TrainConfig(dnn="vgg16", batch_size=4, nworkers=world,
                            lr=0.01, compressor="gaussian_fused",
                            density=0.01, compress_warmup_steps=1,
                            max_steps=100, log_every=every,
                            compute_dtype="float32", eval_every_epochs=0,
                            save_every_epochs=0, device="cpu",
                            model_kwargs={"cfg": narrow}, output_dir=out_dir,
                            run_id="p2", trace="on"))
    t.train(every)
    store = t.trace.steps()
    t.close()
    return {step: (e["calls"], e["counts"]) for step, e in store.items()
            if step >= 1}


def test_two_ranks_time_the_stop_flag_guard_and_exchange(tmp_path):
    outs = _spawn(tmp_path, 2, _w_spans, out_dir=str(tmp_path),
                  narrow=NARROW, every=EVERY)
    for store in outs:
        assert sorted(store) == list(range(1, EVERY + 1))
        for step, (calls, counts) in store.items():
            for name in ("stop_flag", "guard", "exchange"):
                assert calls[name] == 1, (step, name)
            # the trainer's own stream copies without blocking; the stop
            # flag's copy to the device and its read add two waits
            if step % EVERY:
                assert counts["host_syncs"] == SYNCS + READS + 2, step
