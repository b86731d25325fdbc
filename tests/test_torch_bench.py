"""The port's headline bench driver (``gaussiank_sgd_torch/bench.py``)
against the reference's ``bench.py``.

* ``_ratios`` equals the reference's on the same seeded round samples.
* ``CONFIGS``, ``WINDOWS``, ``SWEEP``, ``FIXED`` and the smoke's config
  and plan are the reference's; config 5's batch is
  ``exp_configs/config5*.json``'s.
* The output contract of ``tests/test_bench_harness.py`` with the same
  fake ``bench_model`` in the port's ``benchlib``, every file in
  ``tmp_path``: one compact JSON line, the whole result in
  ``bench_last.json``, the worst config's min-over-windows median as the
  value, one history record, a strictly valid event stream.
* One real ``--smoke --device cpu`` run (mnistnet on the uniform 8,192
  plan): the reference's compact keys, both gates passed, a strictly
  valid stream, nothing written outside its ``--out-dir``.

The reference's ``bench.main`` is never called: it writes
``analysis/artifacts/``, which a reference test reads.
"""

import glob
import json
import os

import numpy as np
import pytest
import torch

import bench as jbench
from gaussiank_sgd_torch import bench, benchlib
from gaussiank_sgd_torch.compressors import DEFAULT_SELECTOR
from gaussiank_sgd_torch.telemetry.events import validate_stream
from gaussiank_sgd_torch.telemetry.history import load_history

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COMPACT_KEYS = {"policy", "worst_config", "worst_config_ratio_window_min",
                "worst_config_ratio_median", "config_window_mins",
                "config_medians", "config_spreads", "rounds",
                "overhead_vs_floor", "overlap_arm", "platform", "full_detail"}


def _samples(seed, rounds, windows, names):
    rng = np.random.default_rng(seed)
    per = {n: [[float(v) for v in rng.uniform(0.01, 0.03, rounds)]
               for _ in range(windows)] for n in names}
    return {"_rounds": {n: [v for w in per[n] for v in w] for n in names},
            "_windows": per}


@pytest.mark.parametrize("seed,rounds,windows", [(0, 3, 2), (1, 4, 2),
                                                 (2, 5, 1), (3, 1, 3)])
def test_ratios_equal_the_references(seed, rounds, windows):
    times = _samples(seed, rounds, windows, ["dense", "gaussian_fused"])
    assert bench._ratios(times, "gaussian_fused") == jbench._ratios(
        times, "gaussian_fused")
    flat = {"_rounds": times["_rounds"]}          # no window grouping
    assert bench._ratios(flat, "gaussian_fused") == jbench._ratios(
        flat, "gaussian_fused")


def test_tables_are_the_references():
    assert bench.CONFIGS == jbench.CONFIGS
    assert bench.WINDOWS == jbench.WINDOWS == 2
    assert bench.SWEEP == jbench.SWEEP
    assert bench.FIXED == jbench.FIXED == DEFAULT_SELECTOR
    assert bench.SMOKE_CONFIGS == jbench.SMOKE_CONFIGS
    assert bench.SMOKE_BUCKETS == jbench.SMOKE_BUCKETS


def test_config5_matches_the_exp_config_operating_point():
    cfg5 = glob.glob(os.path.join(REPO, "exp_configs", "config5*.json"))
    assert cfg5
    batch = {json.load(open(p))["batch_size"] for p in cfg5}
    assert len(batch) == 1
    row = [c for c in bench.CONFIGS if c[0] == "transformer_wmt"][0]
    assert row[3] == batch.pop()


def _fake_bench_model(model, dataset, batch, density, compressors, n_steps,
                      rounds, windows=1, **kw):
    """``tests/test_bench_harness.py``'s fake: distinct per-model overheads
    (the worst config is the transformer, not the flagship) and sparse
    programs drifting 3% a window."""
    base = {"resnet20": 0.020, "vgg16": 0.012, "resnet50": 0.050,
            "lstm": 0.030, "transformer": 0.080}[model]
    over = {"resnet20": 1.02, "vgg16": 1.05, "resnet50": 1.04,
            "lstm": 1.06, "transformer": 1.10}[model]
    times = {"dense": base}
    rt, wt = {"dense": []}, {"dense": []}
    names = ["dense"] + list(compressors)
    for i, c in enumerate(compressors):
        times[c] = base * (over + 0.01 * i)
        rt[c], wt[c] = [], []
    for w in range(max(1, int(windows))):
        for name in names:
            drift = 1.0 if name == "dense" else 1 + 0.03 * w
            samples = [times[name] * drift * (1 + 0.02 * r)
                       for r in range(rounds)]
            rt[name].extend(samples)
            wt[name].append(samples)
    times["_rounds"] = rt
    times["_windows"] = wt
    times["_dense_step_flops"] = 1e9 * batch
    times["_peak_flops"] = 197e12
    return times


def test_json_contract_with_a_fake_bench_model(monkeypatch, capsys,
                                               tmp_path):
    monkeypatch.setattr(benchlib, "bench_model", _fake_bench_model)
    hist = tmp_path / "hist.jsonl"
    out = tmp_path / "out"
    result = bench.main(["--history", str(hist), "--out-dir", str(out),
                         "--device", "cpu"])
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("{")]
    assert len(lines) == 1 and len(lines[0]) < 1500
    parsed = json.loads(lines[0])
    assert set(parsed) == {"metric", "value", "unit", "vs_baseline",
                           "detail"}
    assert set(parsed["detail"]) == COMPACT_KEYS
    assert parsed["value"] == result["value"]
    assert parsed["vs_baseline"] == result["vs_baseline"]
    assert (parsed["detail"]["worst_config_ratio_median"]
            == result["detail"]["worst_config_ratio_median"])
    assert json.load(open(out / "bench_last.json")) == json.loads(
        json.dumps(result))
    assert sorted(os.listdir(out)) == ["bench_events.jsonl",
                                       "bench_last.json"]
    assert result["metric"] == "sparse_vs_dense_step_throughput_ratio"
    assert result["unit"] == "ratio" and 0 < result["value"] < 2
    assert abs(result["vs_baseline"] - result["value"] / 0.90) < 1e-3
    assert (result["detail"]["platform"], result["detail"]["device"]) == (
        "cpu", "cpu")

    cfgs = result["detail"]["configs"]
    assert set(cfgs) == {"resnet20", "vgg16", "resnet50", "lstm_ptb",
                         "transformer_wmt"}
    for cell in cfgs.values():
        assert cell["compressor"] == bench.FIXED
        assert cell["ratio_min"] <= cell["ratio_median"] <= cell["ratio_max"]
        assert len(cell["round_ratios"]) >= 3
        assert cell["mfu_dense"] is not None
        assert cell["windows"] == bench.WINDOWS >= 2
        assert len(cell["window_medians"]) == cell["windows"]
        assert cell["ratio_window_min"] == min(cell["window_medians"])
        assert cell["ratio_window_min"] < max(cell["window_medians"])
        # the CPU floor is the reference's CPU-priced artifact's
        assert cell["overhead_vs_floor"] == round(
            cell["overhead_ms"] / cell["roofline_floor_ms"], 3)
    assert result["value"] == min(c["ratio_window_min"]
                                  for c in cfgs.values())
    assert result["value"] == cfgs[result["detail"]["worst_config"]][
        "ratio_window_min"]
    assert result["detail"]["worst_config"] == "transformer_wmt"
    assert result["detail"]["flagship_ratio_median"] == cfgs["resnet20"][
        "ratio_median"]
    assert "winner_secondary" in cfgs["resnet20"]

    recs = load_history(str(hist))
    assert len(recs) == 1 and recs[0]["smoke"] is False
    assert set(recs[0]["configs"]) == set(cfgs)
    assert recs[0]["value"] == result["value"]
    assert recs[0]["platform"] == "cpu"

    with open(out / "bench_events.jsonl") as f:
        rep = validate_stream(f, strict=True)
    assert rep.ok, rep.errors
    events = [json.loads(ln)["event"] for ln in
              open(out / "bench_events.jsonl").read().splitlines()]
    assert events == ["bench_model"] * 5 + ["bench_summary"]


def test_the_bench_wants_the_card_by_default(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench.main(["--smoke", "--no-history", "--out-dir", str(tmp_path)])
    assert not os.listdir(tmp_path)


def test_smoke_runs_on_the_cpu(capsys, tmp_path):
    """The real harness on mnistnet: the packed wire and the pipelined
    schedule both gated, one compact line, every file in ``--out-dir``."""
    art = os.path.join(REPO, "gaussiank_sgd_torch", "artifacts")
    before = sorted(os.listdir(art))
    out = tmp_path / "smoke"
    result = bench.main(["--smoke", "--device", "cpu", "--no-history",
                         "--out-dir", str(out)])
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("{")]
    assert len(lines) == 1
    parsed = json.loads(lines[0])
    assert set(parsed["detail"]) == COMPACT_KEYS
    assert parsed["detail"]["worst_config"] == "mnistnet"
    assert parsed["value"] == result["value"] > 0
    cell = result["detail"]["configs"]["mnistnet"]
    assert cell["wire_format"] == "u16bf16"
    assert cell["rounds"] == 4 and cell["windows"] == 2
    arm = cell["overlap_arm"]
    assert (arm["seq_overlap"], arm["pipe_overlap"]) == ("off", "pipelined")
    assert arm["overlapped_bytes_sent"] > 0
    assert sorted(os.listdir(out)) == ["bench_events.jsonl",
                                       "bench_last.json"]
    assert sorted(os.listdir(art)) == before
    with open(out / "bench_events.jsonl") as f:
        rep = validate_stream(f, strict=True)
    assert rep.ok, rep.errors
    events = [json.loads(ln)["event"] for ln in
              open(out / "bench_events.jsonl").read().splitlines()]
    assert events == ["bench_model", "bench_overlap", "bench_summary"]
