"""The port's offline tools (``gaussiank_sgd_torch/telemetry/report.py``,
``history.py`` and the CLI ``__main__.py``) against the reference's.

* ``merge``: on the same input files the port's CLI writes the
  reference's output byte for byte and prints the same lines, with
  timestamp ties across three streams, a torn last line, a ts-less record,
  the supervisor's stream, and the strict check's cross-process duplicate
  report; ``--index`` and missing files are usage errors (2).
* ``report``, ``validate``, ``trace`` and ``health`` print what the
  reference's print and exit as they do, on a stream with every section
  of the report.
* ``history``: the record built from a bench result, the append and the
  tolerant load equal the reference's.
"""

import json

import pytest

from gaussiank_sgd_tpu.telemetry import history as jhistory
from gaussiank_sgd_tpu.telemetry import report as jreport
from gaussiank_sgd_tpu.telemetry.__main__ import infer_process_index as \
    jinfer
from gaussiank_sgd_tpu.telemetry.__main__ import main as jcli
from gaussiank_sgd_torch.telemetry import history, report
from gaussiank_sgd_torch.telemetry.__main__ import (infer_process_index,
                                                    main as cli)


def _rec(pidx, seq, ts, **kw):
    rec = {"schema_version": 1, "seq": seq, "process_index": pidx,
           "event": "skip", "step": seq, "nonfinite": 0.0, **kw}
    if ts is not None:
        rec["ts"] = ts
    return json.dumps(rec)


def _pod_files(tmp_path):
    d = tmp_path / "pod"
    (d / "proc000").mkdir(parents=True)
    (d / "proc001").mkdir()
    (d / "proc002").mkdir()
    files = {
        # ties at ts 1.0 across three streams; a ts-less record inherits
        # its stream's last ts; a duplicate seq; a torn last line
        d / "proc002" / "metrics.jsonl": [_rec(2, 0, 1.0), _rec(2, 1, 2.0)],
        d / "proc000" / "metrics.jsonl": [_rec(0, 0, 1.0), _rec(0, 1, 1.0),
                                          _rec(0, 1, 1.5)],
        d / "proc001" / "metrics.jsonl": [
            _rec(1, 0, 1.0), _rec(1, 1, None),
            json.dumps({"event": "skip", "step": 9, "nonfinite": 0.0,
                        "seq": 2, "schema_version": 1, "ts": 3.0}),
            '{"event": "sk'],
        d / "supervisor.jsonl": [json.dumps({
            "event": "worker_lost", "generation": 0, "worker": 1,
            "reason": "exit", "exit_code": -9, "schema_version": 1,
            "seq": 0, "ts": 1.25, "process_index": -1})],
    }
    for path, lines in files.items():
        path.write_text("\n".join(lines) + "\n")
    return [str(p) for p in files]


@pytest.mark.parametrize("extra", [[], ["--strict"],
                                   ["--index", "2", "--index", "0",
                                    "--index", "1", "--index", "-1"]])
def test_merge_is_the_references_byte_for_byte(tmp_path, capsys, extra):
    inputs = _pod_files(tmp_path)
    outs = {}
    for name, fn in (("port", cli), ("ref", jcli)):
        out = str(tmp_path / f"{name}.jsonl")
        rc = fn(["merge", *inputs, "-o", out, *extra])
        text = capsys.readouterr().out.replace(out, "OUT")
        with open(out, "rb") as f:
            outs[name] = (rc, text, f.read())
    assert outs["port"] == outs["ref"]
    rc, text, data = outs["port"]
    assert "1 torn line(s) dropped" in text
    # strict: the ts-less record lacks the envelope (an error, exit 1)
    assert rc == (1 if extra == ["--strict"] else 0)
    if extra == ["--strict"]:
        assert "duplicate seq 1 [process 0]" in text
        assert "4 process(es)" in text and "1 duplicate(s)" in text
    merged = [json.loads(line) for line in data.decode().splitlines()]
    assert [r["ts"] for r in merged if "ts" in r] == sorted(
        r["ts"] for r in merged if "ts" in r)


def test_merge_usage_errors(tmp_path, capsys):
    inputs = _pod_files(tmp_path)
    out = str(tmp_path / "m.jsonl")
    for argv in (["merge", inputs[0], "-o", out, "--index", "0",
                  "--index", "1"],
                 ["merge", str(tmp_path / "nope.jsonl"), "-o", out]):
        assert cli(argv) == jcli(argv) == 2
    capsys.readouterr()


def test_infer_process_index_is_the_references():
    for path, fallback in (("pod/proc007/metrics.jsonl", None),
                           ("gen01_proc012.log", None),
                           ("proc3.jsonl", None),
                           ("pod/supervisor.jsonl", -1),
                           ("reprocess.jsonl", None),
                           ("a/b_proc02-x.jsonl", 5)):
        assert infer_process_index(path, fallback) == jinfer(path, fallback)


def _full_stream(path):
    """Every section of the report: config, train records (sparse and
    pipelined, the phase breakdown), skips, a rollback, io retries, a
    preemption, checkpoints, policy decisions, bench overlap, an eval,
    profile windows and health verdicts."""
    recs = [{"event": "config", "dnn": "vgg16", "dataset": "cifar10",
             "compressor": "gaussian_fused", "density": 0.001,
             "batch_size": 128, "lr": 0.1, "nworkers": 2,
             "n_params": 14986698, "total_steps": 12}]
    for i in range(1, 7):
        rec = {"event": "train", "step": 2 * i, "epoch": 0,
               "loss": 2.3 - 0.1 * i, "lr": 0.1, "grad_norm": 1.5,
               "num_selected": 14987.0, "bytes_sent": 59948,
               "density": 0.001, "density_achieved": 0.001,
               "ef_norm": 3.0 + i, "io_s": 0.002 * i, "step_s": 0.03,
               "skipped": 0.0, "nonfinite": 0.0, "ex_per_s": 4000.0 + i,
               "mfu": 0.02, "fwd_bwd_s": 0.02, "select_s": 0.001,
               "comm_update_s": 0.009, "exposed_exchange_ms": 0.5}
        if i > 1:
            rec.update(wire_format="u16bf16", overlap="pipelined",
                       overlapped_bytes_sent=40000)
        recs.append(rec)
        if i == 3:
            recs += [{"event": "skip", "step": 7, "nonfinite": 12.0},
                     {"event": "rollback", "reason": "skip_budget",
                      "rollback": 1, "to_step": 4, "lr_scale": 0.5,
                      "checkpoint": "c"},
                     {"event": "io_retry", "attempt": 1, "max_retries": 3,
                      "backoff_s": 0.05, "error": "x"},
                     {"event": "checkpoint", "step": 6, "path": "c"},
                     {"event": "policy_decision", "step": 6, "rule": "r",
                      "knob": "density", "old": "0.001", "new": "0.002",
                      "reason": "why"},
                     {"event": "policy_revert", "step": 8, "rule": "r",
                      "knob": "density", "old": "0.002", "new": "0.001",
                      "reason": "spike"}]
    recs += [{"event": "bench_overlap", "key": "vgg16", "n_buckets": 4,
              "seq_step_ms": 30.0, "pipe_step_ms": 29.0,
              "pipe_vs_seq": 0.97, "exposed_seq_ms": 1.0,
              "exposed_pipe_ms": 0.5, "overlapped_bytes_sent": 100},
             {"event": "profile", "action": "start", "step": 2,
              "logdir": "p"},
             {"event": "preempt", "step": 12, "checkpoint": "c"},
             {"event": "eval", "step": 12, "epoch": 0, "val_loss": 2.0,
              "top1": 0.3, "top5": 0.7}]
    with open(path, "w") as f:
        for seq, r in enumerate(recs):
            f.write(json.dumps({**r, "schema_version": 1, "seq": seq,
                                "ts": 100.0 + seq}) + "\n")


@pytest.mark.parametrize("argv", [["report"], ["report", "--json"],
                                  ["validate"], ["validate", "--strict"],
                                  ["validate", "--json"],
                                  ["health"], ["health", "--json"],
                                  ["health", "--floor-ms", "0.1"]])
def test_cli_prints_and_exits_as_the_references(tmp_path, capsys, argv):
    path = str(tmp_path / "run.jsonl")
    _full_stream(path)
    argv = [argv[0], path, *argv[1:]]
    rc = cli(argv)
    text = capsys.readouterr().out
    assert (rc, text) == (jcli(argv), capsys.readouterr().out)
    if argv[0] == "report" and len(argv) == 2:
        for section in ("== run ==", "== per-phase timing", "== throughput",
                        "== comms volume", "== compression efficiency",
                        "== overlap efficiency", "== bench overlap arm",
                        "== policy decision log", "== resilience ==",
                        "== run health", "== eval (last) ==", "== stream"):
            assert section in text
    events = report.load_events(path)
    assert report.summarize(events) == jreport.summarize(events)


def test_cli_trace_and_file_errors(tmp_path, capsys):
    path = str(tmp_path / "run.jsonl")
    _full_stream(path)
    printed = []
    for name, fn in (("port", cli), ("ref", jcli)):
        out = str(tmp_path / f"{name}.json")
        rc = fn(["trace", path, "-o", out, "--require-overlap"])
        printed.append((rc, capsys.readouterr().out.replace(out, "OUT")))
    assert printed[0] == printed[1]
    assert printed[0][0] == 0 and "exchange/compute overlap" in printed[0][1]
    port = json.loads((tmp_path / "port.json").read_text())
    ref = json.loads((tmp_path / "ref.json").read_text())
    assert port == ref
    missing = str(tmp_path / "nope.jsonl")
    (tmp_path / "empty.jsonl").write_text("")
    empty = str(tmp_path / "empty.jsonl")
    for argv in (["report", missing], ["validate", missing],
                 ["health", missing], ["health", empty], ["report", empty],
                 ["trace", empty, "-o", str(tmp_path / "t.json")]):
        assert cli(argv) == jcli(argv)
        capsys.readouterr()
    assert cli(["health", missing]) == 3 and cli(["report", empty]) == 1


def test_report_joins_a_program_audit_as_the_reference(tmp_path, capsys):
    path = str(tmp_path / "run.jsonl")
    _full_stream(path)
    audit = {"git_rev": "abc", "jax_version": "x", "ok": True, "arms": {
        "a": {"fingerprint": "f1", "wire_format": "u16bf16",
              "overlap": "pipelined",
              "config": {"selector": "gaussian_fused"}},
        "b": {"fingerprint": "f2", "wire_format": "i32f32",
              "overlap": "off", "config": {}},
        "dense": {"fingerprint": "f3", "config": {"dense": True}}}}
    apath = tmp_path / "audit.json"
    apath.write_text(json.dumps(audit))
    argv = ["report", path, "--audit", str(apath)]
    assert cli(argv) == jcli(argv) == 0
    out = capsys.readouterr().out
    assert out.count("matched arm a") == 2 and "matched arm b" not in out
    bad = ["report", path, "--audit", str(tmp_path / "none.json")]
    assert cli(bad) == jcli(bad) == 2


def test_history_is_the_references(tmp_path):
    result = {"metric": "sparse_over_dense", "value": 1.02, "detail": {
        "platform": "gpu", "worst_config": "vgg16",
        "configs": {
            "vgg16": {"ratio_median": 1.02, "window_medians": [1.0, 1.1],
                      "rounds": 8, "sparse_step_ms": 30.0, "junk": 1,
                      "overlap_arm": {"pipe_vs_seq": 0.9, "junk": 2}},
            "resnet50": {"ratio_median": 0.99, "bytes_sent": None},
            "bad": "not a cell"}}}
    for smoke in (True, False):
        got = history.build_history_record(result, smoke=smoke, ts=12.3456,
                                           git_rev="abc")
        assert got == jhistory.build_history_record(
            result, smoke=smoke, ts=12.3456, git_rev="abc")
    assert history.HISTORY_SCHEMA == jhistory.HISTORY_SCHEMA
    path = str(tmp_path / "h" / "bench_history.jsonl")
    history.append_history(path, got)
    with open(path, "a") as f:
        f.write("\n{torn\n[1]\n")
        f.write(json.dumps({"history_schema": 99}) + "\n")
    jhistory.append_history(path, {**got, "git_rev": "def"})
    loaded = history.load_history(path)
    assert loaded == jhistory.load_history(path)
    assert [r["git_rev"] for r in loaded] == ["abc", "def"]
    assert history.load_history(str(tmp_path / "none.jsonl")) == []
    assert isinstance(history.git_revision(str(tmp_path)), str)
