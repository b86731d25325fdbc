"""The port's telemetry spine (``gaussiank_sgd_torch/telemetry/``: the
event bus, the schema, the exporters, span tracing) and its wiring into
``Trainer``, against the reference's ``gaussiank_sgd_tpu/telemetry``.

* The reference's bus, exporter, validation and trace tests
  (``tests/test_telemetry.py``, ``tests/test_tracing.py``) run on the
  port's modules: the stamped envelope and ``seq`` order (file order equal
  to ``seq`` order under 8 publishing threads, exporters never called
  under the bus lock, a failed validation retiring its ticket), the JSONL,
  memory and Prometheus textfile exporters, record and stream validation,
  span nesting, stamping and thread-local stacks, and the Chrome-trace
  reconstruction.
* The port's validator and Chrome-trace renderer give the reference's
  answers on the same records.
* A port ``Trainer`` run (a NaN batch, a rollback, checkpoints, an eval
  pass) writes a ``metrics.jsonl`` that the reference's ``validate_stream``
  accepts strictly, with ``seq`` gap-free; with ``--trace on`` its span
  tree is whole, and its ``train`` records carry the reference's keys,
  ``pipeline_chunks`` and ``comm_rounds`` equal to the reference trainer's
  on the same config, on a one-bucket plan and on a pipelined one;
  ``--prom-textfile`` writes a textfile that parses; ``train.log`` holds
  the run's log lines.
"""

import json
import os
import threading

import numpy as np
import pytest

from gaussiank_sgd_tpu.telemetry import events as jevents
from gaussiank_sgd_tpu.telemetry import tracing as jtracing
from gaussiank_sgd_torch.telemetry import (SCHEMA_VERSION, EventBus,
                                           JSONLExporter, MemoryExporter,
                                           PrometheusTextfileExporter,
                                           TraceContext, build_chrome_trace,
                                           validate_record, validate_stream)
from gaussiank_sgd_torch.telemetry.tracing import chrome_trace_overlap_pairs
from gaussiank_sgd_torch.training import chaos
from gaussiank_sgd_torch.training.config import TrainConfig
from gaussiank_sgd_torch.training.trainer import Trainer
from test_torch_resilience import NARROW, _pair


# ---------------------------------------------------------------- event bus

def test_bus_stamps_envelope_and_orders_seq():
    mem = MemoryExporter()
    bus = EventBus([mem], clock=lambda: 123.456789)
    src = {"event": "skip", "step": 3, "nonfinite": 1.0}
    out = bus.emit("skip", step=3, nonfinite=1.0)
    bus.publish(src)
    assert "seq" not in src, "publish must not mutate the caller's dict"
    recs = mem.records
    assert [r["seq"] for r in recs] == [0, 1]
    assert all(r["schema_version"] == SCHEMA_VERSION for r in recs)
    assert all(r["ts"] == 123.456789 for r in recs)
    assert out == recs[0]
    assert bus.seq == 2


def test_bus_requires_event_and_rejects_after_close():
    bus = EventBus([MemoryExporter()])
    with pytest.raises(ValueError, match="event"):
        bus.publish({"step": 1})
    bus.close()
    bus.close()                           # idempotent
    with pytest.raises(ValueError, match="closed"):
        bus.emit("skip", step=1, nonfinite=0.0)


def test_bus_validate_failure_retires_ticket_without_wedging():
    mem = MemoryExporter()
    bus = EventBus([mem], validate=True)
    bus.emit("skip", step=1, nonfinite=0.0)            # seq 0
    with pytest.raises(ValueError, match="missing required field"):
        bus.emit("skip", step=1)                       # seq 1, retired
    rec = bus.emit("skip", step=2, nonfinite=0.0)
    assert rec["seq"] == 2
    assert [r["seq"] for r in mem.records] == [0, 2]


def _publish_from_threads(bus, n_threads, per_thread):
    def worker(i):
        for j in range(per_thread):
            bus.emit("skip", step=i * per_thread + j, nonfinite=0.0)

    threads = [threading.Thread(target=worker, args=(i,))
               for i in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    bus.close()


def test_concurrent_publishes_keep_file_order_equal_seq_order(tmp_path):
    path = str(tmp_path / "t.jsonl")
    _publish_from_threads(EventBus([JSONLExporter(path)]), 8, 50)
    assert [json.loads(line)["seq"] for line in open(path)] == list(
        range(400))


def test_fanout_runs_outside_the_bus_lock():
    bus = EventBus([])
    seen = []

    class LockProbe(MemoryExporter):
        def emit(self, record):
            seen.append((record["seq"], bus._lock.locked()))
            super().emit(record)

    bus.attach(LockProbe())
    _publish_from_threads(bus, 4, 25)
    assert [s for s, _ in seen] == list(range(100))
    assert not any(locked for _, locked in seen)


# ---------------------------------------------------------------- exporters

def test_jsonl_exporter_modes_and_none_path(tmp_path):
    path = str(tmp_path / "e.jsonl")
    for event, mode in (("a", "a"), ("b", "a")):
        ex = JSONLExporter(path, mode)
        ex.emit({"event": event, "x": 1})
        ex.close()
    assert [json.loads(line)["event"] for line in open(path)] == ["a", "b"]
    ex = JSONLExporter(path, mode="w")
    ex.emit({"event": "c"})
    ex.close()
    assert [json.loads(line)["event"] for line in open(path)] == ["c"]
    with pytest.raises(ValueError, match="mode"):
        JSONLExporter(path, mode="x")
    JSONLExporter(None).emit({"event": "noop"})


def test_memory_exporter_ring_capacity():
    mem = MemoryExporter(capacity=3)
    for i in range(5):
        mem.emit({"event": "train", "step": i})
    assert [r["step"] for r in mem.records] == [2, 3, 4]
    assert mem.events("train")[-1]["step"] == 4
    mem.clear()
    assert mem.records == []
    with pytest.raises(ValueError):
        MemoryExporter(capacity=0)


def _prom(path):
    return dict(line.rsplit(" ", 1) for line in open(path).read()
                .splitlines() if line and not line.startswith("#"))


def test_prometheus_textfile_exporter(tmp_path):
    path = str(tmp_path / "gksgd.prom")
    ex = PrometheusTextfileExporter(path)
    ex.emit({"event": "train", "loss": 2.5, "step": 10, "skipped": False,
             "note": "strings are skipped", "sel_per_bucket": [1, 2],
             "bytes_sent": 100, "overlapped_bytes_sent": 60,
             "exposed_exchange_ms": 2.0})
    ex.emit({"event": "train", "loss": 2.25, "step": 11, "skipped": True,
             "bytes_sent": 100, "overlapped_bytes_sent": 60,
             "exposed_exchange_ms": 1.5})
    ex.emit({"event": "skip", "step": 2, "nonfinite": 1.0})
    ex.close()
    lines = _prom(path)
    assert lines['gksgd_events_total{event="train"}'] == "2"
    assert float(lines["gksgd_train_loss"]) == 2.25
    assert float(lines["gksgd_train_skipped"]) == 1
    assert "gksgd_train_note" not in lines
    assert "gksgd_train_sel_per_bucket" not in lines
    assert float(lines["gksgd_train_bytes_sent_total"]) == 200
    assert float(lines["gksgd_train_overlapped_bytes_sent_total"]) == 120
    assert float(lines["gksgd_train_exposed_exchange_ms"]) == 1.5
    assert "gksgd_skip_step_total" not in lines
    assert not [f for f in os.listdir(tmp_path) if ".tmp." in f]


# --------------------------------------------------------------- validation

def _legacy_train():
    return {"event": "train", "step": 1, "epoch": 0, "loss": 1.0,
            "lr": 0.1, "grad_norm": 1.0, "num_selected": 5.0,
            "bytes_sent": 40, "density": 0.01, "io_s": 0.0, "step_s": 0.1,
            "skipped": 0.0, "nonfinite": 0.0, "top1": 0.5}


def _line(seq, **kw):
    return json.dumps({"event": "skip", "step": seq, "nonfinite": 0.0,
                       "schema_version": 1, "seq": seq, "ts": 0.0, **kw})


RECORDS = [
    _legacy_train(),
    dict(_legacy_train(), loss="NaN-ish"),
    dict(_legacy_train(), schema_version=1, seq=0, ts=1.0),
    {"event": "future_thing"},
    {"event": "skip", "step": 1, "nonfinite": 0.0,
     "schema_version": SCHEMA_VERSION + 1},
    {"event": "skip", "step": 1},
    {"step": 1},
    {"event": "span", "name": "x", "span_id": "s1", "ph": "X",
     "schema_version": 1, "seq": 3, "ts": 2.0, "dur_ms": "slow"},
    {"event": "checkpoint", "step": 4, "path": "/c", "schema_version": 1,
     "seq": True, "ts": 1.0},
]

STREAMS = [
    [_line(0), _line(1), _line(2)],
    [_line(0), _line(3)],
    [_line(5), _line(0)],
    [_line(0), '{"event": "tr'],
    ['{"bad', _line(0)],
    [_line(0, process_index=0), _line(0, process_index=1),
     _line(1, process_index=0), _line(0, process_index=1)],
    [json.dumps({"event": "span", "schema_version": 1, "seq": 0, "ts": 1.0,
                 "name": "trajectory", "span_id": "s01", "ph": "B"}),
     json.dumps({"event": "span", "schema_version": 1, "seq": 1, "ts": 2.0,
                 "name": "ghost", "span_id": "s02", "ph": "X",
                 "parent_span": "never_declared"})],
]


def test_validate_record_compat_and_strict():
    legacy = _legacy_train()
    assert validate_record(legacy) == []
    assert any("schema_version" in e
               for e in validate_record(legacy, strict=True))
    assert validate_record({"event": "future_thing"}) == []
    assert validate_record({"event": "future_thing"}, strict=True)
    assert any("loss" in e for e in validate_record(
        dict(legacy, loss="NaN-ish")))
    assert any("newer than this reader" in e for e in validate_record(
        {"event": "skip", "step": 1, "nonfinite": 0.0,
         "schema_version": SCHEMA_VERSION + 1}))


def test_validate_stream_gaps_resets_truncation():
    rep = validate_stream(STREAMS[0], strict=True)
    assert rep.ok and rep.n_records == 3 and rep.n_stamped == 3
    rep = validate_stream(STREAMS[1])
    assert rep.ok and rep.seq_gaps == 1 and "missing" in rep.warnings[0]
    assert validate_stream(STREAMS[2]).seq_resets == 1
    rep = validate_stream(STREAMS[3])
    assert rep.truncated and not rep.ok
    rep = validate_stream(STREAMS[4])
    assert not rep.truncated and not rep.ok
    rep = validate_stream(STREAMS[6], strict=True)
    assert rep.ok and rep.span_orphans == 1 and rep.span_unclosed == 1


@pytest.mark.parametrize("strict", [False, True])
def test_validation_gives_the_references_answers(strict):
    """The port's ``validate_record`` and ``validate_stream`` against the
    reference's on the same records and streams: the same messages and
    counts (the port knows one kind more, ``restore``)."""
    for rec in RECORDS:
        assert (validate_record(rec, strict) ==
                jevents.validate_record(rec, strict)), rec
    for lines in STREAMS:
        a, b = validate_stream(lines, strict), jevents.validate_stream(
            lines, strict)
        assert vars(a) == vars(b), lines
    restore = {"event": "restore", "step": 3, "path": "/c",
               "restore_ms": 1.0, "schema_version": 1, "seq": 0, "ts": 0.0}
    assert validate_record(restore, strict=True) == []
    assert jevents.validate_record(restore) == []


def test_merge_streams_is_the_references():
    """Per-process streams k-way merged by (ts, process, arrival), with
    provenance stamped and a torn last line dropped: the port's
    ``merge_streams`` returns the reference's records and report."""
    from gaussiank_sgd_torch.telemetry.events import merge_streams
    a = [_line(0, ts=1.0), _line(1, ts=3.0), '{"event": "sk']
    b = [_line(0, ts=2.0), json.dumps({"event": "skip", "step": 9,
                                       "nonfinite": 0.0, "seq": 1}),
         _line(2, ts=3.0, process_index=7)]
    got, rep = merge_streams([a, b], [0, 1])
    want, jrep = jevents.merge_streams([a, b], [0, 1])
    assert got == want and vars(rep) == vars(jrep)
    assert rep.dropped_lines == 1 and rep.n_records == 5
    assert validate_stream([json.dumps(r) for r in got]).ok


# --------------------------------------------------------------- tracing

def test_trace_context_nesting_stamp_and_uninstall():
    mem = MemoryExporter()
    bus = EventBus([mem])
    tc = TraceContext(bus, trace_id="t-test").install()
    traj = tc.begin("trajectory", step=0)
    with tc.span("outer") as outer_sid:
        with tc.span("inner"):
            bus.emit("skip", step=1, nonfinite=1.0)
    tc.end(traj)
    tc.uninstall()
    bus.emit("skip", step=2, nonfinite=1.0)
    recs = mem.records
    inner = next(r for r in recs if r.get("name") == "inner")
    outer = next(r for r in recs if r.get("name") == "outer")
    assert inner["parent_span"] == outer_sid == outer["span_id"]
    assert outer["parent_span"] == traj
    assert inner["ph"] == outer["ph"] == "X"
    assert inner["dur_ms"] >= 0 and "t0" in inner
    assert recs.index(inner) < recs.index(outer)
    stamped = next(r for r in recs
                   if r.get("event") == "skip" and r["step"] == 1)
    assert stamped["trace_id"] == "t-test"
    assert stamped["span_id"] == inner["span_id"]
    unstamped = next(r for r in recs
                     if r.get("event") == "skip" and r["step"] == 2)
    assert "trace_id" not in unstamped and "span_id" not in unstamped
    rep = validate_stream([json.dumps(r) for r in recs], strict=True)
    assert rep.ok, rep.errors
    assert rep.span_orphans == 0 and rep.span_unclosed == 0


def test_trace_context_stack_is_thread_local():
    mem = MemoryExporter()
    bus = EventBus([mem])
    tc = TraceContext(bus, trace_id="t-thr").install()
    with tc.span("main_loop"):
        th = threading.Thread(
            target=lambda: bus.emit("skip", step=9, nonfinite=0.0))
        th.start()
        th.join()
    rec = next(r for r in mem.records if r.get("event") == "skip")
    assert rec["trace_id"] == "t-thr" and "span_id" not in rec


def _bench_overlap_rec(n_buckets=6):
    return {"event": "bench_overlap", "schema_version": 1, "seq": 0,
            "ts": 100.0, "key": "mnistnet-u8192", "model": "mnistnet",
            "compressor": "gaussian", "bucket_size": 8192,
            "n_buckets": n_buckets, "seq_step_ms": 12.0,
            "pipe_step_ms": 10.0, "seq_overlap": "off",
            "pipe_overlap": "pipelined", "exposed_seq_ms": 3.0,
            "exposed_pipe_ms": 0.5, "pipe_vs_seq": 1.2}


def _train_rec():
    return {"event": "train", "schema_version": 1, "seq": 1, "ts": 50.0,
            "step": 10, "epoch": 0, "loss": 1.0, "lr": 0.1,
            "grad_norm": 1.0, "num_selected": 10.0, "bytes_sent": 1000,
            "density": 0.01, "io_s": 0.001, "step_s": 0.5, "skipped": 0.0,
            "nonfinite": 0.0, "overlap": "pipelined",
            "overlapped_bytes_sent": 600, "exposed_exchange_ms": 50.0}


def test_chrome_trace_reconstructions():
    n = 6
    trace = build_chrome_trace([_bench_overlap_rec(n)])
    evs = [e for e in trace["traceEvents"] if e.get("ph") == "X"]
    assert len([e for e in evs if e["cat"] == "compress"]) == n
    assert len([e for e in evs if e["cat"] == "exchange"]) == n
    assert all(e["ts"] >= 0 and e["dur"] >= 0 for e in evs)
    assert chrome_trace_overlap_pairs(trace) >= n - 1
    rec = _bench_overlap_rec()
    del rec["exposed_seq_ms"], rec["exposed_pipe_ms"], rec["pipe_vs_seq"]
    assert chrome_trace_overlap_pairs(build_chrome_trace([rec])) >= 5
    trace = build_chrome_trace([_train_rec()])
    evs = {e["name"]: e for e in trace["traceEvents"] if e.get("ph") == "X"}
    hidden = evs["exchange overlapped [step 10]"]
    exposed = evs["exchange exposed [step 10]"]
    assert hidden["dur"] == pytest.approx(270e3, rel=1e-3)
    assert exposed["dur"] == pytest.approx(50e3, rel=1e-3)
    assert hidden["ts"] + hidden["dur"] == pytest.approx(exposed["ts"],
                                                         abs=1)


def test_chrome_trace_is_the_references():
    """The port's renderer and the reference's give the same JSON on the
    same records (spans, a train interval, a bench record, an event)."""
    mem = MemoryExporter()
    bus = EventBus([mem], clock=lambda: 40.0)
    tc = TraceContext(bus, trace_id="t", clock=lambda: 40.0,
                      perf=iter(np.arange(0, 1, 0.01)).__next__).install()
    traj = tc.begin("trajectory", step=0)
    with tc.span("step_dispatch", step=1):
        tc.instant("anomaly_pending", reason="skip_budget", step=1)
    tc.end(traj)
    recs = mem.records + [_train_rec(), _bench_overlap_rec(),
                          {"event": "checkpoint", "step": 4, "path": "/c",
                           "ts": 41.0}]
    assert build_chrome_trace(recs, pid=3) == jtracing.build_chrome_trace(
        recs, pid=3)


# ------------------------------------------------------- the trainer stream

def _read(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def _cfg(tmp_path, run_id, **kw):
    base = dict(dnn="vgg16", batch_size=8, lr=0.01,
                compressor="gaussian_fused", density=0.01,
                compress_warmup_steps=1, max_steps=6, log_every=1,
                compute_dtype="float32", eval_every_epochs=0,
                save_every_epochs=0, save_every_steps=2,
                max_consecutive_skips=1, device="cpu",
                model_kwargs={"cfg": NARROW}, output_dir=str(tmp_path),
                run_id=run_id)
    base.update(kw)
    return TrainConfig(**base)


@pytest.mark.parametrize("trace", ["off", "on"])
def test_trainer_stream_validates_under_the_references_rules(tmp_path,
                                                             trace):
    """A run with a NaN batch at step 4 (a skip, then a rollback to step
    2), checkpoints and an eval pass: every record validates strictly
    under the reference's rules and the port's, ``seq`` runs 0, 1, 2, ...
    with no gap; with tracing on, every record carries the trace id and
    the span tree is whole once the run is closed."""
    prom = str(tmp_path / "gksgd.prom")
    t = Trainer(_cfg(tmp_path, "s", trace=trace, prom_textfile=prom))
    chaos.inject_nan_batches(t, {3})
    t.train(6)
    t.test()
    t.close()
    recs = _read(t.metrics_path)
    kinds = [r["event"] for r in recs]
    assert kinds[0] == "config"
    assert {"train", "skip", "rollback", "checkpoint", "eval"} <= set(kinds)
    assert [r["seq"] for r in recs] == list(range(len(recs)))
    lines = [json.dumps(r) for r in recs]
    for validate in (jevents.validate_stream, validate_stream):
        rep = validate(lines, strict=True)
        assert rep.ok and rep.seq_gaps == rep.seq_resets == 0, rep.errors
        assert rep.span_orphans == rep.span_unclosed == 0, rep.warnings
    spans = [r for r in recs if r["event"] == "span"]
    if trace == "off":
        assert not spans and not any("trace_id" in r for r in recs)
        assert not any("pipeline_chunks" in r for r in recs)
    else:
        assert all(r["trace_id"] == recs[0]["trace_id"] for r in recs)
        names = {r["name"] for r in spans}
        assert {"trajectory", "data_wait", "step_dispatch",
                "checkpoint_save", "rollback", "anomaly_pending"} <= names
        assert sum(r["name"] == "trajectory" and r["ph"] == "B"
                   for r in spans) == 2       # rotated by the rollback
        trace_json = build_chrome_trace(recs)
        assert any(e.get("cat") == "device"
                   for e in trace_json["traceEvents"])
        assert any(e.get("name") == "step_dispatch"
                   for e in trace_json["traceEvents"])
    lines = _prom(prom)
    assert float(lines["gksgd_train_step"]) == t.step == 4
    assert int(lines['gksgd_events_total{event="skip"}']) == 1
    log = open(os.path.join(t.run_dir, "train.log")).read()
    assert "model=vgg16" in log and "rollback #1" in log


@pytest.mark.parametrize("plan", [{}, {"bucket_policy": "uniform",
                                      "bucket_size": 4096}])
def test_traced_records_have_the_references_keys(tmp_path, plan):
    """The port and the reference on one config with ``--trace on``, log
    interval 2: ``train(4)``'s record has the reference's keys, the
    trace-gated ``pipeline_chunks`` and ``comm_rounds`` with the
    reference's values (0 and 1 on the one-bucket plan; the chunks of the
    pipelined uniform plan), and both streams hold the same kinds and
    span names."""
    t, jt = _pair(tmp_path, trace="on", log_every=2, max_steps=10, **plan)
    rec, jrec = t.train(4), jt.train(4)
    assert set(rec) == set(jrec)
    assert {"pipeline_chunks", "comm_rounds"} <= set(rec)
    for key in ("pipeline_chunks", "comm_rounds", "overlap"):
        assert rec[key] == jrec[key], key
    assert rec["pipeline_chunks"] == (len(t.plan.buckets) if plan else 0)
    t.close()
    jt.close()
    recs = _read(t.metrics_path)
    jrecs = _read(os.path.join(jt.run_dir, "metrics.jsonl"))
    assert ([r["event"] for r in recs if r["event"] != "span"]
            == [r["event"] for r in jrecs if r["event"] != "span"])
    assert (sorted(r["name"] for r in recs if r["event"] == "span")
            == sorted(r["name"] for r in jrecs if r["event"] == "span"))
