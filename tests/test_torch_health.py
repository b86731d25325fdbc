"""The port's run health (``gaussiank_sgd_torch/telemetry/health.py`` and its
wiring into ``Trainer``) against the reference's
``gaussiank_sgd_tpu/telemetry/health.py``.

* Verdict for verdict: the record sequences of every cause the reference's
  tests drive (``tests/test_health.py``: data wait, io-retry bursts,
  exposed exchange against a floor and without one, EF pressure, density
  drift, instability, step-time regression, policy thrash, bench
  regression) and the pod's (worker lost, coordinator stall, resize) go
  through both packages' ``HealthMonitor``s: equal verdicts, ``status()``
  and ``summary()``, dict for dict.
* Streams the port's ``Trainer`` wrote (clean, NaN chaos with a rollback,
  loader stalls) through both packages' ``replay_health`` and
  ``summarize``: equal verdicts and summaries, and equal
  ``format_health`` and ``format_report`` text.
* ``HealthServer`` serves ``/healthz`` (503 when critical), ``/metrics``
  (the textfile, or the health gauge) and per-job routes.
* The trainer: off by default (no monitor, no record); a clean run is
  ``ok`` on the live endpoint, the CLI and the report; NaN chaos gives
  ``instability`` on all three; ``FlakyEpochSource`` stalls give
  ``data_wait``; a critical ``ef_pressure`` verdict pre-arms the rollback;
  a config file with ``health`` and ``health_port`` trains through
  ``python -m gaussiank_sgd_torch.train``.
* ``load_roofline_floor`` applies a floor only on the platform it was
  priced on, as the reference's does.
"""

import json
import math
import os
import subprocess
import sys
import urllib.error
import urllib.request

import pytest

from gaussiank_sgd_tpu.policy.rules import \
    load_roofline_floor as jload_roofline_floor
from gaussiank_sgd_tpu.telemetry import health as jhealth
from gaussiank_sgd_tpu.telemetry import report as jreport
from gaussiank_sgd_torch.telemetry import health, report
from gaussiank_sgd_torch.telemetry.__main__ import main as telemetry_cli
from gaussiank_sgd_torch.telemetry.events import validate_file
from gaussiank_sgd_torch.telemetry.health import (CRITICAL, DEGRADED,
                                                  HealthMonitor,
                                                  HealthPolicy, HealthServer)
from gaussiank_sgd_torch.training import chaos
from gaussiank_sgd_torch.training.config import TrainConfig
from gaussiank_sgd_torch.training.trainer import Trainer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NARROW = [8, "M", 8, "M", 16, "M", 16, "M", 16, "M"]


def train_rec(step, *, step_s=0.1, io_s=0.0, sparse=True, **kw):
    rec = {"event": "train", "step": step, "epoch": 0, "loss": 1.0,
           "lr": 0.1, "grad_norm": 1.0, "num_selected": 10.0,
           "bytes_sent": 100, "density": 0.01, "io_s": io_s,
           "step_s": step_s, "skipped": 0.0, "nonfinite": 0.0,
           "density_achieved": 0.01, "ef_norm": 1.0}
    if sparse:
        rec["wire_format"] = "u16bf16"
    rec.update(kw)
    return rec


def trains(n, first=1, **kw):
    """``("train", rec)`` ops for log intervals ``first .. first + n - 1``
    (steps 2, 4, ...), each ticked."""
    return [("train", train_rec(2 * i, **kw)) for i in range(first,
                                                             first + n)]


ROLLBACK = {"event": "rollback", "reason": "skip_budget", "rollback": 1,
            "to_step": 4, "lr_scale": 0.5, "checkpoint": "c"}
SKIP = {"event": "skip", "step": 5, "nonfinite": 1.0}
IO_RETRY = {"event": "io_retry", "attempt": 1, "max_retries": 3,
            "backoff_s": 0.01, "error": "ChaosError"}
REVERT = {"event": "policy_revert", "step": 2, "rule": "r",
          "knob": "density", "old": "0.005", "new": "0.01",
          "reason": "loss spike", "quarantined": True}
BENCH = {"event": "bench_regression", "status": "regressed",
         "baseline_rev": "a", "new_rev": "b", "n_regressed": 1,
         "n_improved": 0, "n_flat": 3, "worst_config": "mnist"}
LOST = {"event": "worker_lost", "generation": 0, "worker": 1,
        "reason": "exit", "exit_code": -9}


def boot(attempt, max_retries=4):
    return {"event": "bootstrap_retry", "attempt": attempt,
            "max_retries": max_retries, "backoff_s": 0.5,
            "coordinator": "c:1", "error": "refused"}


def quiet(first, last):
    return [("tick", s) for s in range(first, last, 2)]


# name -> (monitor kwargs, ops); an op is ("train", rec) (emit, then tick
# at its step), ("emit", rec) or ("tick", step)
SCENARIOS = {
    "clean": ({"density_target": 0.01}, trains(8)),
    "data_wait_degraded": ({}, trains(4, io_s=0.06)),
    "data_wait_critical": ({}, trains(4, io_s=0.3)),
    "io_retry_burst": ({}, [("emit", IO_RETRY), ("emit", IO_RETRY),
                            ("tick", 2)] + quiet(4, 22)),
    "exposed_vs_floor": ({"floor_ms": 2.0},
                         trains(4, exposed_exchange_ms=9.0)),
    "exposed_under_floor": ({"floor_ms": 2.0},
                            trains(4, exposed_exchange_ms=4.0)),
    "exposed_fraction": ({}, trains(4, step_s=0.01,
                                    exposed_exchange_ms=8.0)),
    "ef_pressure_critical": ({}, [("train", train_rec(2 * (i + 1),
                                                      ef_norm=200.0 + i))
                                  for i in range(4)]),
    "ef_pressure_rising": ({}, [("train", train_rec(2 * (i + 1),
                                                    ef_norm=10.0 + 4 * i))
                                for i in range(6)]),
    "ef_flat_falling": ({}, [("train", train_rec(2 * (i + 1),
                                                 ef_norm=20.0 - i))
                             for i in range(4)]),
    "ef_dense_warmup": ({}, trains(4, sparse=False, ef_norm=0.0)),
    "density_drift": ({"density_target": 0.01},
                      trains(3, density_achieved=0.05)),
    "density_from_config": ({}, [("emit", {"event": "config",
                                           "density": 0.01})]
                            + trains(4, density_achieved=0.001)),
    "instability": ({}, [("emit", SKIP), ("tick", 8), ("emit", ROLLBACK),
                         ("tick", 10)] + quiet(12, 30)),
    "skip_streak": ({}, [("emit", SKIP)] * 3 + [("tick", 6)]
                    + [("train", train_rec(8, skipped=1.0)),
                       ("train", train_rec(10))]),
    "step_regression": ({"policy": "window4"},
                        trains(4, step_s=0.05)
                        + trains(4, first=5, step_s=0.2)),
    "step_regression_reverse": ({"policy": "window4"},
                                trains(4, step_s=0.2)
                                + trains(4, first=5, step_s=0.05)),
    "policy_thrash_bench": ({}, [("emit", REVERT), ("emit", REVERT),
                                 ("tick", 4), ("emit", BENCH), ("tick", 6)]
                            + quiet(8, 30)),
    "worker_lost": ({}, trains(1) + [("emit", LOST), ("tick", 4)]
                    + quiet(6, 30)),
    "coordinator_stall": ({}, [("emit", boot(1)), ("emit", boot(2)),
                               ("tick", 2)] + quiet(4, 24)),
    "coordinator_exhausted": ({}, [("emit", boot(4)), ("tick", 2)]),
    "resize": ({}, [("emit", {"event": "resize_begin"}), ("tick", 2),
                    ("emit", {"event": "resize_abort"}), ("tick", 4)]
               + quiet(6, 24)),
    "mixed": ({"floor_ms": 1.0, "density_target": 0.01},
              trains(3, io_s=0.05, exposed_exchange_ms=5.0,
                     density_achieved=0.04)
              + [("emit", SKIP), ("emit", IO_RETRY), ("emit", LOST)]
              + trains(5, first=4, io_s=0.2, ef_norm=150.0)
              + [("emit", {"event": "health_status", "step": 1})]
              + quiet(18, 40)),
}


def _run(mod, kwargs, ops):
    kw = dict(kwargs)
    if kw.get("policy") == "window4":
        kw["policy"] = mod.HealthPolicy(window=4)
    mon = mod.HealthMonitor(**kw)
    out = []
    for kind, arg in ops:
        if kind == "tick":
            out.append(mon.tick(arg))
            continue
        mon.emit(dict(arg))
        if kind == "train":
            out.append(mon.tick(int(arg["step"])))
    return out, mon


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_verdicts_are_the_references(name):
    kwargs, ops = SCENARIOS[name]
    got, mon = _run(health, kwargs, ops)
    want, jmon = _run(jhealth, kwargs, ops)
    assert got == want
    assert mon.status() == jmon.status()
    assert mon.summary() == jmon.summary()
    assert health.format_health(mon.summary()) == jhealth.format_health(
        jmon.summary())


def test_scenarios_reach_every_cause():
    causes = set()
    for kwargs, ops in SCENARIOS.values():
        for v in _run(health, kwargs, ops)[0]:
            causes |= set(v["causes"])
    assert causes == {
        health.CAUSE_DATA_WAIT, health.CAUSE_EXPOSED_EXCHANGE,
        health.CAUSE_EF_PRESSURE, health.CAUSE_DENSITY_DRIFT,
        health.CAUSE_INSTABILITY, health.CAUSE_STEP_TIME,
        health.CAUSE_POLICY_THRASH, health.CAUSE_BENCH_REGRESSION,
        health.CAUSE_WORKER_LOST, health.CAUSE_COORDINATOR_STALL,
        health.CAUSE_RESIZE}
    assert health.PRE_ARM_CAUSES == jhealth.PRE_ARM_CAUSES
    assert HealthPolicy() == HealthPolicy(**vars(jhealth.HealthPolicy()))


def test_critical_causes_leave_out_the_degraded_ones():
    """A degraded ef_pressure beside a critical data_wait (one rank's io
    time) is not critical itself: the trainer's pre-arm reads
    ``critical_causes``, not the verdict's state."""
    ops = [("train", train_rec(2 * (i + 1), io_s=0.3,
                               ef_norm=10.0 + 4 * i)) for i in range(6)]
    verdicts, mon = _run(health, {}, ops)
    assert verdicts[-1]["state"] == "critical"
    assert verdicts[-1]["causes"] == ["data_wait", "ef_pressure"]
    assert mon.critical_causes() == ("data_wait",)
    _, crit = _run(health, {}, [("train", train_rec(2, ef_norm=500.0))])
    assert crit.critical_causes() == ("ef_pressure",)


def test_replay_health_is_the_references_and_skips_recorded_verdicts():
    live = HealthMonitor()
    stream = []
    for i in range(6):
        r = train_rec((i + 1) * 2, io_s=0.2 if i >= 3 else 0.0)
        stream.append(r)
        live.emit(r)
        h = live.tick(r["step"])
        stream.append(h)
        live.emit(h)
    stream += [LOST, "not a record"]
    replayed, mon = health.replay_health(stream)
    jreplayed, jmon = jhealth.replay_health(stream)
    assert replayed == jreplayed
    assert [r["causes"] for r in replayed[:6]] == [
        r["causes"] for r in stream[1:12:2]]
    assert mon.summary() == jmon.summary()
    assert mon.summary()["worst_state"] == "critical"


# ------------------------------------------------------------- endpoints

def _get(url):
    try:
        with urllib.request.urlopen(url) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def test_health_server_endpoints(tmp_path):
    mon = HealthMonitor()
    mon.emit(train_rec(2))
    mon.tick(2)
    prom = tmp_path / "gksgd.prom"
    prom.write_text('gksgd_events_total{event="train"} 1\n')
    srv = HealthServer(mon, port=0, prom_path=str(prom)).start()
    bare = HealthServer(mon, port=0).start()
    try:
        base = f"http://127.0.0.1:{srv.port}"
        code, body = _get(f"{base}/healthz")
        d = json.loads(body)
        assert code == 200 and d["state"] == "ok" and d["verdicts"] == 1
        assert d["worst_state"] == "ok" and d["step"] == 2
        assert _get(f"{base}/metrics") == (
            200, b'gksgd_events_total{event="train"} 1\n')
        assert _get(f"http://127.0.0.1:{bare.port}/metrics") == (
            200, b"health_state 0\n")
        assert _get(f"{base}/nope")[0] == 404
        assert _get(f"{base}/healthz/job1")[0] == 404
        # a critical verdict: /healthz answers 503, still with the JSON
        mon.emit(ROLLBACK)
        mon.tick(4)
        code, body = _get(f"{base}/healthz")
        assert code == 503 and json.loads(body)["state"] == "critical"
        assert _get(f"http://127.0.0.1:{bare.port}/metrics") == (
            200, b"health_state 2\n")
        other = HealthMonitor()
        srv.add_job("job1", other)
        assert _get(f"{base}/healthz/job1")[0] == 200
        assert _get(f"{base}/metrics/job1") == (200, b"health_state 0\n")
        srv.remove_job("job1")
        assert _get(f"{base}/healthz/job1")[0] == 404
    finally:
        srv.close()
        bare.close()
    sched = HealthServer(None, port=0).start()
    try:
        sched.add_job("a", mon)
        code, body = _get(f"http://127.0.0.1:{sched.port}/healthz")
        assert code == 503 and set(json.loads(body)["jobs"]) == {"a"}
    finally:
        sched.close()


def test_roofline_floor_applies_on_its_own_platform_only(tmp_path):
    (tmp_path / "roofline.json").write_text(json.dumps({
        "platform": "cpu", "configs": {"vgg16": {"floor_ms": 1.5}}}))
    art = str(tmp_path)
    for model, platform in (("vgg16", "cpu"), ("VGG16", "cpu"),
                            ("vgg16", "cuda"), ("vgg16", "tpu"),
                            ("mnistnet", "cpu"), ("resnet50", "cpu")):
        got = health.load_roofline_floor(model, platform, art)
        assert got == jload_roofline_floor(model, platform, art)
    assert health.load_roofline_floor("vgg16", "cpu", art) == 1.5
    assert health.load_roofline_floor("vgg16", "cuda", art) is None
    assert health.load_roofline_floor("vgg16", "cuda",
                                      str(tmp_path / "none")) is None


# ---------------------------------------------------------------- trainer

def make_cfg(tmp_path, **kw):
    """A narrow VGG on synthetic CIFAR, f32, lr 0.01 without warm-up (the
    schedule's milestones decay it): a clean run, no guard skip and every
    loss finite and below 2 ln 10 (the reference's own "clean" mnistnet at
    lr 0.4 reads 75 at step 4 and rolls back twice)."""
    base = dict(dnn="vgg16", dataset="cifar10", batch_size=8, nworkers=1,
                lr=0.01, momentum=0.9, weight_decay=0.0, max_steps=10,
                compressor="gaussian_fused", density=0.01,
                compress_warmup_steps=2, warmup_epochs=0.0,
                compute_dtype="float32", log_every=2, eval_every_epochs=0,
                save_every_epochs=0, seed=0, device="cpu",
                model_kwargs={"cfg": NARROW, "dropout": 0.0},
                output_dir=str(tmp_path))
    base.update(kw)
    return TrainConfig(**base)


def read_events(t, kind=None):
    with open(t.metrics_path) as f:
        recs = [json.loads(line) for line in f]
    return [r for r in recs if kind is None or r["event"] == kind]


def _live(port):
    code, body = _get(f"http://127.0.0.1:{port}/healthz")
    return code, json.loads(body)


def _surfaces_agree(path, capsys):
    """The stream through both packages' replay and report: equal; returns
    the CLI's exit code and the report's health section."""
    events = report.load_events(path)
    assert events == jreport.load_events(path)
    verdicts, mon = health.replay_health(events)
    jverdicts, jmon = jhealth.replay_health(events)
    assert verdicts == jverdicts and mon.summary() == jmon.summary()
    assert health.format_health(mon.summary()) == jhealth.format_health(
        jmon.summary())
    summary = report.summarize(events)
    assert summary == jreport.summarize(events)
    assert report.format_report(summary) == jreport.format_report(summary)
    # the live verdicts in the stream are the replayed ones
    recorded = [r for r in events if r["event"] == "health_status"]
    assert [{k: v for k, v in r.items()
             if k not in ("seq", "ts", "schema_version")}
            for r in recorded] == verdicts
    capsys.readouterr()
    rc = telemetry_cli(["health", path])
    return rc, capsys.readouterr().out, summary


def test_default_run_builds_no_monitor_and_writes_no_health(tmp_path):
    t = Trainer(make_cfg(tmp_path, max_steps=4))
    assert t.health is None and t._health_server is None
    t.fit()
    t.close()
    kinds = [r["event"] for r in read_events(t)]
    assert kinds == ["config", "train", "train", "checkpoint"]


def test_clean_run_is_ok_on_every_surface(tmp_path, capsys):
    t = Trainer(make_cfg(tmp_path, health="on", health_port=0))
    port = t._health_server.port
    assert t.health is not None
    t.fit()
    code, live = _live(port)
    t.close()
    assert all(r["skipped"] == 0 and 0 < r["loss"] < 2 * math.log(10)
               for r in t.records)
    assert not read_events(t, "skip") and not read_events(t, "rollback")
    verdicts = read_events(t, "health_status")
    assert [v["step"] for v in verdicts] == [2, 4, 6, 8, 10]
    assert all(v["state"] == "ok" for v in verdicts)
    assert (code, live["worst_state"], live["verdicts"]) == (200, "ok", 5)
    assert validate_file(t.metrics_path, strict=True).ok
    rc, out, summary = _surfaces_agree(t.metrics_path, capsys)
    assert rc == 0 and "worst state: ok" in out
    assert summary["health"]["worst_state"] == "ok"


def test_nan_chaos_gives_instability_on_every_surface(tmp_path, capsys):
    t = Trainer(make_cfg(tmp_path, max_steps=12, save_every_steps=4,
                         max_consecutive_skips=1, health="on",
                         health_port=0))
    chaos.inject_nan_batches(t, {6})           # poisons step 7
    port = t._health_server.port
    while t.step < t.total_steps:
        t.train(t.total_steps - t.step)
    code, live = _live(port)
    t.close()
    verdicts = read_events(t, "health_status")
    flagged = [v for v in verdicts if "instability" in v["causes"]]
    assert flagged and flagged[0]["step"] <= 7 + 2 * t.cfg.log_every
    assert max(v["state_code"] for v in verdicts) == CRITICAL
    assert read_events(t, "rollback")
    assert code == 503 and live["worst_state"] == "critical"
    assert validate_file(t.metrics_path, strict=True).ok
    rc, out, summary = _surfaces_agree(t.metrics_path, capsys)
    assert rc == 2 and "instability" in out
    assert summary["health"]["worst_state"] == "critical"
    assert any("instability" in i["causes"]
               for i in summary["health"]["incidents"])
    assert "instability" in report.format_report(summary)


def test_loader_stalls_give_data_wait(tmp_path, capsys):
    t = Trainer(make_cfg(tmp_path, io_backoff_s=0.001, health="on"))
    t.train_ds = chaos.FlakyEpochSource(t.train_ds, fail_batches=[1, 2],
                                        times=1)
    t._invalidate_data_iter()
    t.fit()
    t.close()
    assert t.train_ds.raised == 2
    verdicts = read_events(t, "health_status")
    flagged = [v for v in verdicts if "data_wait" in v["causes"]]
    assert flagged and flagged[0]["state_code"] >= DEGRADED
    assert flagged[0]["evidence"]["data_wait"]["io_retries"] >= 2
    assert validate_file(t.metrics_path, strict=True).ok
    rc, _, _ = _surfaces_agree(t.metrics_path, capsys)
    assert rc >= 1


def test_critical_ef_pressure_pre_arms_the_rollback(tmp_path):
    """A critical verdict whose cause is in PRE_ARM_CAUSES arms the
    resilience monitor at that step; the boundary check rolls back."""
    t = Trainer(make_cfg(tmp_path, max_steps=8, save_every_steps=2,
                         health="on"))
    t.health.policy = HealthPolicy(ef_ratio_critical=1e-9)
    t.train(6)
    t.close()
    rollbacks = read_events(t, "rollback")
    assert rollbacks and rollbacks[0]["reason"] == "health:ef_pressure"
    first = [v for v in read_events(t, "health_status")
             if v["state_code"] == CRITICAL][0]
    assert first["causes"] == ["ef_pressure"]
    assert rollbacks[0]["to_step"] < first["step"]


def test_config_file_with_health_trains_through_the_cli(tmp_path):
    path = tmp_path / "c.json"
    path.write_text(json.dumps({
        "_comment": "config 2's model, narrowed, with run health",
        "dnn": "vgg16", "dataset": "cifar10", "health": "on",
        "health_port": 0}))
    cmd = [sys.executable, "-m", "gaussiank_sgd_torch.train", "--config",
           str(path), "--device", "cpu", "--compressor", "gaussian_fused",
           "--density", "0.01", "--max-steps", "4", "--log-every", "2",
           "--compress-warmup-steps", "1", "--batch-size", "8",
           "--compute-dtype", "float32", "--warmup-epochs", "0",
           "--lr", "0.01", "--eval-every-epochs", "0",
           "--model-kwargs", json.dumps({"cfg": NARROW}),
           "--output-dir", str(tmp_path), "--run-id", "cli"]
    out = subprocess.run(cmd, cwd=REPO, env=dict(os.environ,
                                                 PYTHONPATH=REPO),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "health endpoint: http://127.0.0.1:" in out.stderr
    with open(tmp_path / "cli" / "metrics.jsonl") as f:
        recs = [json.loads(line) for line in f]
    assert [r["step"] for r in recs if r["event"] == "health_status"] == [
        2, 4]
