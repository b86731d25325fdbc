"""The port's regression sentinel (``gaussiank_sgd_torch/telemetry/
sentinel.py``) against the reference's ``analysis/regression_sentinel.py``.

The reference's sentinel cases (``tests/test_tracing.py``) replayed on
both modules on the same history records: equal verdicts, baselines,
tables, exit codes and emitted ``bench_regression`` records (less their
envelope), and the port's record ingested by the port's ``PolicySignals``
and ``HealthMonitor``. The port's committed history
(``gaussiank_sgd_torch/artifacts/bench_history.jsonl``, written by the
bench driver on the card) loads, passes the self-test, and its newest
record is not a regression of its baseline.
"""

import json
import os

import pytest

from analysis import regression_sentinel as jsent
from gaussiank_sgd_torch.policy.signals import PolicySignals
from gaussiank_sgd_torch.telemetry import sentinel
from gaussiank_sgd_torch.telemetry.events import validate_file
from gaussiank_sgd_torch.telemetry.health import HealthMonitor
from gaussiank_sgd_torch.telemetry.history import (append_history,
                                                   load_history)

MODULES = {"port": sentinel, "reference": jsent}
ENVELOPE = {"ts", "seq", "schema_version", "run_id", "trace_id"}


def _history_rec(rev, ts, ratios=(0.90, 0.92), smoke=True, key="mnistnet"):
    med = sorted(ratios)[0]
    return {"history_schema": 1, "ts": ts, "git_rev": rev, "smoke": smoke,
            "platform": "cpu", "metric": "ratio_window_min_min",
            "value": med, "worst_config": key,
            "arms": {"wire": True, "overlap": True, "policy": None},
            "configs": {key: {
                "ratio_median": sum(ratios) / len(ratios),
                "ratio_window_min": med,
                "window_medians": list(ratios), "windows": len(ratios),
                "rounds": 12}}}


@pytest.mark.parametrize("factor,jitter,status", [
    (0.90, 0.0, "regressed"), (1.0, 0.003, "flat"),
    (1.10, 0.0, "improved"), (0.97, 0.0, "flat"), (0.93, 0.01, "regressed")])
def test_verdicts_equal_the_references(factor, jitter, status):
    """A 10% drop is flagged, noise-level jitter is not, a 10% gain is an
    improvement: the same verdict, perturbed record and table from both."""
    base = _history_rec("aaa0000", 100.0)
    changed = sentinel._perturb(base, factor, jitter=jitter)
    assert changed == jsent._perturb(base, factor, jitter=jitter)
    got = sentinel.compare(base, changed, tol=0.05)
    assert got == jsent.compare(base, changed, tol=0.05)
    assert got["status"] == status
    assert sentinel.format_table(got) == jsent.format_table(got)
    if status == "regressed":
        assert got["worst_config"] == "mnistnet" and got["worst_delta"] < 0


def test_scalar_fallback_without_window_medians():
    a = _history_rec("aaa0000", 100.0)
    b = _history_rec("bbb1111", 200.0, ratios=(0.80, 0.82))
    for rec in (a, b):
        del rec["configs"]["mnistnet"]["window_medians"]
    got = sentinel.classify_config(a, b, "mnistnet", tol=0.05)
    assert got == jsent.classify_config(a, b, "mnistnet", tol=0.05)
    assert got[0] == "regressed" and got[1] == pytest.approx(-0.10, abs=1e-6)


def test_baseline_scoping_equals_the_references():
    """Records with another smoke flag, a later stamp, disjoint configs or
    ``"synthetic": true`` are skipped on the automatic path; an explicit
    rev or index still reaches a synthetic row."""
    hist = [_history_rec("real0000", 50.0, smoke=False),
            _history_rec("other000", 60.0, key="vgg16"),
            _history_rec("good0000", 70.0),
            _history_rec("new00000", 100.0)]
    fake = dict(_history_rec("fake0000", 80.0), synthetic=True)
    hist_f = [_history_rec("good0000", 70.0), fake,
              _history_rec("new00000", 100.0)]
    newest = _history_rec("new00000", 100.0)
    only = [_history_rec("lonely00", 10.0)]
    cases = [(hist, hist[-1], None, None, "good0000"),
             (only, only[0], None, None, None),
             (hist_f, hist_f[-1], None, None, "good0000"),
             ([fake, newest], newest, None, None, None),
             (hist_f, hist_f[-1], "fake0000", None, "fake0000"),
             (hist_f, hist_f[-1], None, 1, "fake0000"),
             (hist_f, hist_f[-1], None, 7, None)]
    for history, new, rev, index, want in cases:
        got = [mod.pick_baseline(history, new, rev, index)
               for mod in (sentinel, jsent)]
        assert got[0] == got[1]
        assert (got[0] or {}).get("git_rev") == want


def _cli(mod, argv, capsys):
    rc = mod.main(argv)
    return rc, capsys.readouterr()


def test_cli_exit_codes_and_output_equal_the_references(tmp_path, capsys):
    """1 on a regression, 0 on an improvement, 0 with "nothing to compare"
    on one record, 2 on a missing file and on an index out of range, 0 for
    the self-test; the same output from both."""
    base = _history_rec("aaa0000", 100.0)
    files = {}
    for name, recs in (("regressed", [base, sentinel._perturb(base, 0.90)]),
                       ("improved", [base, sentinel._perturb(base, 1.10)]),
                       ("single", [base])):
        files[name] = str(tmp_path / f"{name}.jsonl")
        for rec in recs:
            append_history(files[name], rec)
    runs = [(["--history", files["regressed"]], 1, "REGRESSED"),
            (["--history", files["regressed"], "--json"], 1, '"regressed"'),
            (["--history", files["improved"]], 0, "IMPROVED"),
            (["--history", files["single"]], 0, "nothing to compare"),
            (["--history", files["regressed"], "--self-test"], 0,
             "self-test OK"),
            (["--history", str(tmp_path / "missing.jsonl")], 2, ""),
            (["--history", files["single"], "--index", "5"], 2, ""),
            (["--history", str(tmp_path / "missing.jsonl"), "--self-test"],
             2, "")]
    for argv, rc_want, text in runs:
        got = [_cli(mod, argv, capsys) for mod in (sentinel, jsent)]
        assert got[0][0] == got[1][0] == rc_want, argv
        assert got[0][1].out == got[1][1].out, argv
        assert text in got[0][1].out, argv


def test_emitted_record_equals_the_references_and_feeds_the_port(tmp_path,
                                                                 capsys):
    """``--emit-event``: a strictly valid ``bench_regression`` record, its
    fields the reference's; the port's policy signals and health monitor
    count it."""
    hist = str(tmp_path / "hist.jsonl")
    base = _history_rec("aaa0000", 100.0)
    append_history(hist, base)
    append_history(hist, sentinel._perturb(base, 0.90))
    recs = {}
    for name, mod in MODULES.items():
        path = str(tmp_path / f"{name}.jsonl")
        assert mod.main(["--history", hist, "--emit-event", path]) == 1
        rep = validate_file(path, strict=True)
        assert rep.ok, rep.errors
        lines = open(path).read().splitlines()
        assert len(lines) == 1
        recs[name] = json.loads(lines[0])
    capsys.readouterr()
    strip = [{k: v for k, v in r.items() if k not in ENVELOPE}
             for r in recs.values()]
    assert strip[0] == strip[1]
    rec = recs["port"]
    assert (rec["event"], rec["status"], rec["worst_config"]) == (
        "bench_regression", "regressed", "mnistnet")
    sig = PolicySignals()
    sig.update(rec)
    sig.update(dict(rec, status="improved"))
    snap = sig.snapshot()
    assert (snap.bench_regressions, snap.last_bench_regression) == (
        1, "mnistnet")
    mon = HealthMonitor()
    mon.emit(rec)
    verdict = mon.tick(2)
    assert "bench_regression" in verdict["causes"]


def test_committed_history_is_sentinel_clean(capsys):
    """The port's committed history holds at least two full (not smoke)
    headline runs on the card; the newest is not a regression of its
    baseline, and the self-test passes on it."""
    path = sentinel.DEFAULT_HISTORY
    assert path.endswith(os.path.join("gaussiank_sgd_torch", "artifacts",
                                      "bench_history.jsonl"))
    hist = load_history(path)
    full = [r for r in hist if not r.get("smoke")]
    assert len(full) >= 2
    for rec in full:
        assert rec["history_schema"] == 1 and rec["platform"] == "cuda"
        assert set(rec["configs"]) == {"resnet20", "vgg16", "resnet50",
                                       "lstm_ptb", "transformer_wmt"}
    new = hist[-1]
    base = sentinel.pick_baseline(hist, new, None, None)
    assert base is not None
    assert sentinel.compare(base, new, tol=0.05)["status"] != "regressed"
    assert sentinel.main(["--self-test"]) == 0
    assert "self-test OK" in capsys.readouterr().out
