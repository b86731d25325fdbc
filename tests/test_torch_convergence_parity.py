"""Convergence parity of the port (``python -m
gaussiank_sgd_torch.convergence_parity``) against the reference's own
harness (``analysis/convergence_parity.py:run_arm``) at P = 2.

The port's harness runs as two gloo ranks on the CPU (a subprocess,
started first so that it trains while the reference's four arms run here
on the 8-virtual-device mesh, at ``nworkers = 2``). Both run mnistnet on
the synthetic MNIST stand-in (512 images a split, not 2,048) at the
committed artifact's settings (batch 8, lr 0.005, density 0.01, 10 dense
warm-up steps, dataset seed 100, seed 0) for 30 steps, with the arms
dense, ``gaussian``, ``topk`` and ``gaussian@gtopk``.

Each arm is held to the reference's:
* the wire format and the bytes of the last step, exactly;
* top-1 within 0.03 (the reference's own convergence bound);
* the final loss within 0.1 absolute, and the eval loss below 0.2 on both
  sides (the reference's bound).
The final loss is one batch's loss, and the two runs part after the first
step by standing differences: the dropout masks (the port draws them from
torch's generator seeded from (seed, rank), the reference from JAX's key),
and XLA's FMA contraction. Over three seeds (``python -m
gaussiank_sgd_torch.convergence_parity --device cpu --nprocs 2 --steps 30
--seeds 3 --arms none,gaussian,gaussian@gtopk``, on the 2,048 images)
the port's own final losses spread over 0.047-0.055 an arm; 0.1 is about
twice that.
Besides, each compressed arm of the port keeps the reference's bound
against the port's dense arm: top-1 >= dense - 0.03.
"""

import importlib.util
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEPS = 30
ARMS = "none,gaussian,topk,gaussian@gtopk"
# the synthetic stand-in cut from 2,048 images a split to 512 on both sides
DATA = {"synthetic_examples": 512}
SETTINGS = dict(dnn="mnistnet", dataset="mnist", batch_size=8, lr=0.005,
                weight_decay=0.0, nworkers=2, data_dir=None, model_kwargs={},
                clip_norm=None, bucket_size=None, bucket_policy="greedy",
                compress_warmup_steps=10, seed=0)


def _reference_harness():
    spec = importlib.util.spec_from_file_location(
        "reference_convergence_parity",
        os.path.join(REPO, "analysis", "convergence_parity.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_port_follows_the_reference_at_two_ranks(tmp_path):
    port = subprocess.Popen(
        [sys.executable, "-m", "gaussiank_sgd_torch.convergence_parity",
         "--device", "cpu", "--nprocs", "2", "--steps", str(STEPS),
         "--arms", ARMS, "--dataset-kwargs", json.dumps(DATA),
         "--out-dir", str(tmp_path / "port"),
         "--run-dir", str(tmp_path / "port_runs")],
        cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="2"),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        harness = _reference_harness()
        ref = {}
        for name, comp, exch in (("dense", "none", "allgather"),
                                 ("gaussian", "gaussian", "allgather"),
                                 ("topk", "topk", "allgather"),
                                 ("gaussian_gtopk", "gaussian", "gtopk")):
            ref[name] = harness.run_arm(
                f"{name}_s0", STEPS, 0.01, str(tmp_path / "ref_runs"),
                **dict(SETTINGS, dataset_kwargs=dict(DATA, seed=100),
                       compressor=comp, exchange=exch))
        out, err = port.communicate(timeout=300)
    finally:
        port.kill()
    assert port.returncode == 0, err[-3000:]
    with open(tmp_path / "port" / "convergence_parity.json") as f:
        summary = json.load(f)
    got = {a["arm"]: a for a in summary["arms"]}
    assert list(got) == list(ref)
    assert summary["config"]["nworkers"] == 2
    for name, r in ref.items():
        p = got[name]
        assert (p["wire_format"], p["bytes_per_step"], p["exchange"]) \
            == (r["wire_format"], r["bytes_per_step"], r["exchange"]), name
        assert abs(p["top1"] - r["top1"]) <= 0.03, (name, p, r)
        assert abs(p["final_loss"] - r["final_loss"]) <= 0.1, (name, p, r)
        assert p["val_loss"] < 0.2 and r["val_loss"] < 0.2, (name, p, r)
        if name != "dense":
            assert p["top1"] >= got["dense"]["top1"] - 0.03, name
            assert set(summary["parity"][name]) >= {
                "top1_gap_vs_dense", "val_loss_ratio_vs_dense"}
    with open(tmp_path / "port" / "convergence_parity_curves.jsonl") as f:
        curves = [json.loads(line) for line in f]
    assert [c["arm"] for c in curves] == list(ref)
    assert [s for s, _ in curves[0]["curve"]] == [10, 20, 30]
