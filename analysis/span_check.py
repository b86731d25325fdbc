#!/usr/bin/env python3
"""The port's per-step spans and ``host_syncs`` counter on a benchmark
cell, on the card: what they cost and whether the counter counts every
wait.

For ``--workload`` (a cell of ``BENCHMARK.json``) it builds the cell's
trainer three times (``gkbench/harness.py``: the cell's configuration,
seeded weights and traffic): ``off``, tracing off; ``spans``, tracing on;
``layers``, tracing on with the benchmark's ``gk.*`` layer ranges, as its
traced run has them. It warms each up, and then:

1. times ``--rounds`` rounds of windows of whole log intervals, about
   ``--seconds`` each, one a trainer, in turns (the order reversed every
   other round): the mean wall a step, between device synchronisations;
   the cost of each traced arm is its median over ``off``'s, and the
   median over rounds of its window over ``off``'s in the same round
   (paired: short windows cancel the host's slow drifts); beside it,
   the cost the host's noise cannot hide: each tracing primitive timed
   alone on this host (a phase, a count, a step's begin, a span's range
   and store bookkeeping), times its calls a step in ``spans``'s store,
   over ``off``'s median step; and ``spans``'s store read back: each
   span's mean host ms a step over the last ten log intervals. Each arm's
   step walls (successive completions, as ``step_ms_p95`` takes them; a
   window's first step left out) give its median and p95, and how the
   steps after a log boundary compare: a step is stamped when its record
   is kept, before the stop flag and the log interval, so a log step's
   work lands in the next step's wall. Their mean wall beside the
   others', and their share of the walls above the p95 (a tenth at
   ``log_every`` 10 if the log work does not set the tail);
2. runs ``--intervals`` log intervals of ``layers`` under
   ``torch.profiler`` (CPU and CUDA) inside the benchmark's window range
   and reports, over those steps, the store's ``host_syncs`` beside the
   synchronising runtime calls in the trace (``cudaDeviceSynchronize``,
   ``cudaStreamSynchronize``), and the stretch's idle gaps by name
   (``gkbench/trace.py``, every name, not its ten longest), in seconds a
   step;
3. runs as many intervals under ``torch.cuda.set_sync_debug_mode("warn")``
   (``lint/program_audit.py:caught_syncs``) and reports the syncs it
   caught, by site, beside the store's count.

A tree whose trace context keeps no store (an older commit) gives 1 and
the gaps alone. Needs a CUDA device; run from the root of a checkout::

  python3 analysis/span_check.py --workload vgg16-gk-1c --seed 11

The last line of standard output is one JSON object with every number.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import statistics
import sys
import time
from collections import Counter

SYNC_CALLS = ("cudaDeviceSynchronize", "cudaStreamSynchronize")


ARMS = ("off", "spans", "layers")


def _warm(trainer, feed, setup_steps: int) -> None:
    """The benchmark's warm-up: whole log intervals past ``setup_steps``
    (the first interval's log runs the one-off FLOP probe)."""
    every = trainer.cfg.log_every
    trainer.train(every * max(2, -(-setup_steps // every)), feed)


def _window(trainer, feed, seconds: float, sync):
    """``(mean wall a step in ms, [(step, wall ms)])`` over whole log
    intervals of about ``seconds``: the walls between successive step
    completions (``trainer.records.at``, the benchmark's stamps), the
    window's first step left out."""
    every = trainer.cfg.log_every
    rec = trainer.records
    first = len(rec)
    sync()
    t0, steps = time.perf_counter(), 0
    while time.perf_counter() - t0 < seconds:
        trainer.train(every, feed)
        steps += every
    sync()
    mean = (time.perf_counter() - t0) * 1e3 / steps
    walls = [(rec[i]["step"], (rec.at[i] - rec.at[i - 1]) * 1e3)
             for i in range(first + 1, len(rec))]
    return mean, walls


def _walls(walls, every: int) -> dict:
    """Of ``[(step, wall ms)]``: median, p95, the mean of the steps after
    a log boundary and of the others, and the share of the walls above
    the p95 that are steps after a log boundary."""
    ms = [w for _, w in walls]
    p95 = statistics.quantiles(ms, n=20, method="inclusive")[18]
    after = [(step - 1) % every == 0 for step, _ in walls]
    tail = [a for a, w in zip(after, ms) if w > p95]
    return {"n": len(ms), "median": statistics.median(ms), "p95": p95,
            "after_log_mean": statistics.fmean(
                w for a, w in zip(after, ms) if a),
            "other_mean": statistics.fmean(
                w for a, w in zip(after, ms) if not a),
            "after_log_share_above_p95": sum(tail) / len(tail)}


def _syncs(store, steps: int) -> int:
    """``host_syncs`` over the store's last ``steps`` steps."""
    entries = list(store.steps().values())[-steps:]
    return sum(e["counts"].get("host_syncs", 0) for e in entries)


def _primitives_us(n: int = 20000) -> dict:
    """Microseconds a call of each tracing primitive on this host, no
    profiler recording: a phase's enter and exit, a count, a step's
    begin, and what a span adds to its bus record (its store entry and
    its range check)."""
    from gaussiank_sgd_torch.telemetry import (EventBus, MemoryExporter,
                                               tracing)
    tc = tracing.TraceContext(EventBus([MemoryExporter()]))
    tc.begin_step(1)

    def per_call(fn):
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        return (time.perf_counter() - t0) * 1e6 / n

    def phase():
        with tc.phase("forward"):
            pass

    def span_extra():
        tc._record("data_wait", 0.0)
        with tracing._range(tracing.SPAN_RECORD):
            pass

    return {"phase": per_call(phase),
            "count": per_call(lambda: tc.count("host_syncs")),
            "begin_step": per_call(lambda: tc.begin_step(2)),
            "span_extra": per_call(span_extra)}


def _span_ms(store, steps: int) -> dict:
    """Each span's mean host ms a step over the store's last ``steps``
    steps."""
    entries = list(store.steps().values())[-steps:]
    names = sorted({name for e in entries for name in e["ms"]})
    return {name: sum(e["ms"].get(name, 0.0) for e in entries)
            / len(entries) for name in names}


def _calls_per_step(store, steps: int) -> dict:
    """Mean calls a step of phases (spans without a bus record), spans
    with one, and counts (``host_syncs`` a step: at least its count
    calls), over the store's last ``steps`` steps."""
    entries = list(store.steps().values())[-steps:]
    bus = ("data_wait", "step_dispatch")
    n = len(entries)
    return {"phase": sum(calls for e in entries for name, calls in
                         e["calls"].items() if name not in bus) / n,
            "span_extra": sum(e["calls"].get(name, 0) for e in entries
                              for name in bus) / n,
            "count": sum(e["counts"].get("host_syncs", 0)
                         for e in entries) / n,
            "begin_step": 1.0}


def _profiled(trainer, feed, intervals: int, out_dir: str, sync):
    """``intervals`` log intervals under the profiler inside the window
    range: ``(steps, synchronising runtime calls by name, idle gaps by
    name in s a step, busy share)``."""
    import torch
    from gkbench import layers, trace
    steps = intervals * trainer.cfg.log_every
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        with torch.profiler.record_function(layers.WINDOW):
            trainer.train(steps, feed)
        sync()
    path = os.path.join(out_dir, "span_check_trace.json")
    prof.export_chrome_trace(path)
    events = trace.load(path)
    os.remove(path)
    from unittest import mock
    win = next(e for e in events if e.get("name") == layers.WINDOW)
    w0, w1 = float(win["ts"]), float(win["ts"]) + float(win["dur"])
    calls = Counter(str(e["name"]) for e in events
                    if e.get("name") in SYNC_CALLS
                    and w0 <= float(e["ts"]) <= w1)
    with mock.patch.object(trace, "TOP", len(events)):
        summary = trace.summarize(events, layers.WINDOW, layers.RANGES)
    gaps = {name: s / steps for name, s in summary.idle_gaps}
    return steps, dict(calls), gaps, summary.busy_s / summary.window_s


def check(cell, seed: int, seconds: float, rounds: int, intervals: int,
          dev) -> dict:
    """Every number above for ``cell`` (a ``gkbench.manifest.Cell``) on
    ``dev``."""
    import torch
    from unittest import mock
    from gkbench import harness
    from gkbench.reference import sgd
    from gaussiank_sgd_torch.lint.program_audit import caught_syncs
    out = {"workload": cell.name, "seed": seed,
           "card": (torch.cuda.get_device_name(dev)
                    if dev.type == "cuda" else None)}
    with contextlib.ExitStack() as stack:
        trainers = {}
        for arm in ARMS:
            with (mock.patch.object(harness.layers, "install",
                                    lambda step: None)
                  if arm == "spans" else contextlib.nullcontext()):
                trainer, model, _, feed, out_dir = stack.enter_context(
                    harness._trainer(cell, seed, dev, 0, arm != "off"))
            harness.checked_steps(trainer, feed,
                                  int(cell.setup["checked_steps"]),
                                  sgd.models.numel(model.layout))
            _warm(trainer, feed, int(cell.setup["setup_steps"]))
            trainers[arm] = (trainer, feed, out_dir)
        trainer, feed, out_dir = trainers["layers"]
        store = (trainer.trace if hasattr(trainer.trace, "steps")
                 else None)

        def sync():
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)

        means = {arm: [] for arm in ARMS}
        walls = {arm: [] for arm in ARMS}
        for r in range(rounds):
            for arm in (ARMS if r % 2 == 0 else ARMS[::-1]):
                t, f, _ = trainers[arm]
                mean, ws = _window(t, f, seconds, sync)
                means[arm].append(mean)
                walls[arm] += ws
        med = {arm: statistics.median(v) for arm, v in means.items()}
        out["step_ms"] = means
        out["cost_pct"] = {arm: 100.0 * (med[arm] / med["off"] - 1.0)
                           for arm in ARMS[1:]}
        out["cost_paired_pct"] = {
            arm: 100.0 * (statistics.median(
                a / o for a, o in zip(means[arm], means["off"])) - 1.0)
            for arm in ARMS[1:]}
        every = trainer.cfg.log_every
        out["walls_ms"] = {arm: _walls(ws, every)
                           for arm, ws in walls.items()}
        spans_store = trainers["spans"][0].trace
        if hasattr(spans_store, "steps"):
            us = _primitives_us()
            calls = _calls_per_step(spans_store, 10 * every)
            per_step = sum(us[k] * calls[k] for k in us)
            out["primitives"] = {
                "us_a_call": us, "calls_a_step": calls,
                "us_a_step": per_step,
                "pct_of_step": 100.0 * per_step * 1e-3 / med["off"]}
            out["span_ms_a_step"] = _span_ms(spans_store, 10 * every)

        steps, calls, gaps, busy = _profiled(trainer, feed, intervals,
                                             out_dir, sync)
        out["profiled"] = {
            "steps": steps, "sync_calls": calls,
            "sync_calls_per_step": sum(calls.values()) / steps,
            "host_syncs_per_step": (_syncs(store, steps) / steps
                                    if store is not None else None),
            "idle_gaps_s_per_step": gaps, "busy_share": busy}
        steps = intervals * trainer.cfg.log_every
        sync()
        with caught_syncs() as sites:
            trainer.train(steps, feed)
        sync()
        out["sync_debug"] = {
            "steps": steps, "per_step": len(sites) / steps,
            "by_site": dict(Counter(sites)),
            "host_syncs_per_step": (_syncs(store, steps) / steps
                                    if store is not None else None)}
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, default=11)
    p.add_argument("--seconds", type=float, default=6.0)
    p.add_argument("--rounds", type=int, default=4)
    p.add_argument("--intervals", type=int, default=2)
    args = p.parse_args(argv)
    # the checkout it runs from, whichever tree holds this script
    sys.path.insert(0, os.getcwd())
    import torch
    from gkbench import manifest
    if not torch.cuda.is_available():
        print("span_check: needs a CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    out = check(manifest.load_cell(args.workload), args.seed, args.seconds,
                args.rounds, args.intervals, dev)
    print(json.dumps(out), flush=True)
    return 0 if out["profiled"]["host_syncs_per_step"] is not None else 1


if __name__ == "__main__":
    sys.exit(main())
