"""The port's policy A/B harness (``gaussiank_sgd_torch/policy_ab.py``).

* Replay: over the reference's committed
  ``analysis/artifacts/bench_matrix_r5.json`` it gives the reference's
  committed ``analysis/artifacts/policy_ab_r5.json`` exactly — the
  decision log, every config's medians and means, ``fixed_policies`` and
  the acceptance block — and it imports no torch.
* ``--measure``'s replay takes each config's floor where one is given and
  records it; the priced floor changes the engine's budget, not the
  fixed arms.
* ``--smoke`` at 12 steps on the CPU: both live runs' streams pass
  strict validation and the adaptive run keeps to the budget.
* The CLIs want the card unless asked for the CPU; ``--measure`` prices
  its matrix through ``bench_matrix.measure``, capped at 10 steps a run.
"""

import json
import os
import subprocess
import sys

import pytest

from gaussiank_sgd_torch import policy_ab

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COMMITTED = os.path.join(REPO, "analysis", "artifacts", "policy_ab_r5.json")


def test_replay_reproduces_the_committed_artifact_exactly(tmp_path):
    result = policy_ab.run(["--out-dir", str(tmp_path)])
    with open(COMMITTED) as f:
        want = json.load(f)
    with open(tmp_path / "policy_ab_r5.json") as f:
        got = json.load(f)
    assert got == want
    for key in ("decision_log", "fixed_policies", "acceptance", "configs"):
        assert got[key] == want[key], key
    assert result["ok"] and result["acceptance"] == want["acceptance"]
    assert policy_ab.main(["--out-dir", str(tmp_path)]) == 0


def test_replay_imports_no_torch():
    code = ("import sys\n"
            "from gaussiank_sgd_torch import policy_ab\n"
            "r = policy_ab.run_replay(policy_ab.DEFAULT_MATRIX, 120)\n"
            "assert len(r['decision_log']) == 6, r['decision_log']\n"
            "assert 'torch' not in sys.modules\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         env=dict(os.environ, PYTHONPATH=REPO),
                         capture_output=True, text=True, timeout=60)
    assert out.returncode == 0, out.stderr


def test_floors_replace_the_proxy_and_are_recorded():
    base = policy_ab.run_replay(policy_ab.DEFAULT_MATRIX, 120)
    floors = {"config2_vgg16": 1e6, "config3_resnet50": None}
    got = policy_ab.run_replay(policy_ab.DEFAULT_MATRIX, 120, floors=floors)
    vgg, r50 = got["configs"]["config2_vgg16"], got["configs"][
        "config3_resnet50"]
    assert (vgg["floor_ms"], vgg["floor_source"]) == (1e6, "roofline")
    assert r50["floor_source"] == "measured-arm proxy"
    # a floor far above every overhead leaves the engine nothing to chase
    assert vgg["adaptive"]["recompiles"] == 0
    assert base["configs"]["config2_vgg16"]["adaptive"]["recompiles"] > 0
    assert vgg["fixed"] == base["configs"]["config2_vgg16"]["fixed"]
    assert r50 == dict(base["configs"]["config3_resnet50"],
                       floor_ms=r50["floor_ms"],
                       floor_source="measured-arm proxy")


def test_smoke_on_the_cpu(tmp_path, monkeypatch):
    """The live arm cut to 12 steps (``TrainConfig`` patched):
    strict streams, the budget, and a report of both runs."""
    import torch
    from gaussiank_sgd_torch.training import config as tconfig
    real = tconfig.TrainConfig

    def short(**kw):
        return real(**dict(kw, max_steps=12, log_every=3))
    monkeypatch.setattr(tconfig, "TrainConfig", short)
    threads = torch.get_num_threads()
    torch.set_num_threads(2)     # the suite's other workers share the cores
    try:
        out = policy_ab.run_smoke(str(tmp_path), device="cpu")
    finally:
        torch.set_num_threads(threads)
    assert out["mode"] == "smoke"
    assert set(out["runs"]) == {"static", "adaptive"}
    assert not [p for p in out["problems"] if "invalid" in p
                or "budget" in p], out["problems"]
    assert out["runs"]["adaptive"]["recompiles"] <= 8
    assert out["runs"]["static"]["recompiles"] == 0


def test_measure_and_smoke_want_the_card(tmp_path):
    for argv in (["--measure"], ["--smoke"]):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            policy_ab.run([*argv, "--out-dir", str(tmp_path)])
    assert not os.listdir(tmp_path)


@pytest.mark.parametrize("caller", ["policy_ab", "cli"])
def test_the_matrix_is_priced_through_bench_matrix_measure(caller, tmp_path,
                                                           monkeypatch):
    """``--measure`` prices the quick matrix through
    ``bench_matrix.measure`` at most ``MEASURE_STEPS`` (10) steps a timed
    run, as the reference's; the ``bench_matrix`` command line reaches the
    same function uncapped and has no step option."""
    from gaussiank_sgd_torch import bench_matrix
    seen = []
    monkeypatch.setattr(bench_matrix, "measure",
                        lambda **kw: seen.append(kw) or [])
    out = str(tmp_path)
    if caller == "policy_ab":
        path = policy_ab.measure_matrix("cpu", out, "config2")
        assert path == os.path.join(out, "bench_matrix_policy_ab.json")
        assert policy_ab.MEASURE_STEPS == 10
        assert seen == [dict(quick=True, configs="config2", tag="policy_ab",
                             device="cpu", out_dir=out, max_steps=10)]
    else:
        bench_matrix.main(["--quick", "--configs", "config2", "--densities",
                           "0.1,0.01", "--device", "cpu", "--out-dir", out])
        assert seen == [dict(quick=True, configs="config2", tag="",
                             densities=(0.1, 0.01), device="cpu",
                             out_dir=out)]
        with pytest.raises(SystemExit):
            bench_matrix.main(["--max-steps", "10"])
