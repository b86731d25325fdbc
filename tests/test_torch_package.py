"""The port's package rules and its host-side modules.

* No module of ``gaussiank_sgd_torch`` and not ``chip_smoke.py`` imports
  JAX, flax, optax or anything of ``gaussiank_sgd_tpu`` (an AST scan), and
  ``policy/`` and ``service/`` import no ``torch`` either.
* Entry points run on the GPU unless asked for the CPU: here, with no GPU,
  they raise instead of running on the CPU (the trainer, the bench
  driver, the bench matrix and the roofline floor).
* ``python -m gaussiank_sgd_torch.train --device cpu`` trains and writes
  its metrics.
* Config, registry, bucketing, schedule, flat optimizer and collectives
  agree with the reference where it has a counterpart.
"""

import ast
import json
import os
import pathlib
import re
import subprocess
import sys

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from gaussiank_sgd_tpu.parallel.bucketing import \
    make_bucket_plan as jmake_plan
from gaussiank_sgd_tpu.parallel.flat_opt import FlatSGDM as JFlatSGDM
from gaussiank_sgd_tpu.training.lr_schedule import \
    warmup_milestone_schedule as jschedule
from gaussiank_sgd_torch import resolve_device
from gaussiank_sgd_torch.compressors import (CompressedGrad, decompress,
                                             get_compressor)
from gaussiank_sgd_torch.compressors.registry import DEFAULT_SELECTOR, NAMES
from gaussiank_sgd_torch.parallel import collectives
from gaussiank_sgd_torch.parallel.bucketing import make_bucket_plan
from gaussiank_sgd_torch.parallel.flat_opt import FlatSGDM
from gaussiank_sgd_torch.training.config import (TrainConfig, add_args,
                                                 from_args)
from gaussiank_sgd_torch.training.lr_schedule import \
    warmup_milestone_schedule
from gaussiank_sgd_torch.training.trainer import Trainer

REPO = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = sorted(str(p.relative_to(REPO)) for p in
                    (REPO / "gaussiank_sgd_torch").rglob("*.py")
                    if "build" not in p.parts) + ["chip_smoke.py"]
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "orbax", "chex",
             "gaussiank_sgd_tpu"}
NARROW = [8, "M", 8, "M", 16, "M", 16, "M", 16, "M"]
CONFIG2 = str(REPO / "exp_configs" / "config2_vgg16_cifar10_gaussian.json")


@pytest.mark.parametrize("path", PORT_FILES)
def test_port_imports_nothing_of_jax_or_the_reference(path):
    tree = ast.parse((REPO / path).read_text(), filename=path)
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    assert not roots & FORBIDDEN, f"{path} imports {roots & FORBIDDEN}"


POLICY_SERVICE = [f for f in PORT_FILES
                  if f.startswith(("gaussiank_sgd_torch/policy/",
                                   "gaussiank_sgd_torch/service/"))]


@pytest.mark.parametrize("path", POLICY_SERVICE)
def test_policy_and_service_import_no_torch(path):
    """The policy engine and the elastic service are pure stdlib plus the
    package's telemetry and launcher, as the reference's are (no jax)."""
    tree = ast.parse((REPO / path).read_text(), filename=path)
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    assert "torch" not in roots, path


def test_the_supervisor_and_the_telemetry_cli_import_no_torch(tmp_path):
    """The import scan above covers the pod rig and run health; besides,
    the launcher's supervisor (its module, a ``Supervisor`` with its
    stream, the NCCL check's refusal path, its CLI's parse) and the
    telemetry CLI run without ``torch``, as the reference's run without
    ``jax``."""
    new = {"gaussiank_sgd_torch/training/launch.py",
           "gaussiank_sgd_torch/telemetry/health.py",
           "gaussiank_sgd_torch/telemetry/report.py",
           "gaussiank_sgd_torch/telemetry/history.py",
           "gaussiank_sgd_torch/telemetry/__main__.py"}
    assert new <= set(PORT_FILES)
    code = (
        "import sys\n"
        "from gaussiank_sgd_torch.training import launch\n"
        "from gaussiank_sgd_torch.training.config import TrainConfig\n"
        "from gaussiank_sgd_torch.telemetry.__main__ import main\n"
        "sup = launch.Supervisor(TrainConfig(device='cpu'),\n"
        "                        launch.LaunchConfig(nprocs=2),\n"
        f"                        {str(tmp_path / 'pod')!r})\n"
        "sup._check_backend()\n"
        "spec = sup._worker_spec(resume=None)\n"
        "sup.bus.publish({'event': 'worker_relaunch', 'generation': 1,\n"
        "                 'nprocs': 2, 'checkpoint': ''})\n"
        "sup.bus.close()\n"
        f"assert main(['health', {str(tmp_path / 'pod' / 'supervisor.jsonl')!r}])"
        " == 0\n"
        "try:\n"
        "    launch.main(['--help'])\n"
        "except SystemExit:\n"
        "    pass\n"
        "from gaussiank_sgd_torch import policy, service\n"
        "from gaussiank_sgd_torch.service.__main__ import main as smain\n"
        "esup = service.ElasticSupervisor(TrainConfig(device='cpu'),\n"
        "    launch.LaunchConfig(nprocs=2),\n"
        f"    {str(tmp_path / 'epod')!r})\n"
        "esup._direct(3, 'operator', esup._worker_spec(resume=None))\n"
        "esup.bus.close()\n"
        "policy.PolicyEngine(policy.default_rules(TrainConfig()))\n"
        "try:\n"
        "    smain(['--help'])\n"
        "except SystemExit:\n"
        "    pass\n"
        "assert 'torch' not in sys.modules, sorted(\n"
        "    m for m in sys.modules if m.startswith('torch'))\n"
        "print('NO TORCH')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         env=dict(os.environ, PYTHONPATH=str(REPO)),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and "NO TORCH" in out.stdout, out.stderr


def test_entry_points_refuse_to_run_on_the_cpu_unasked():
    assert not torch.cuda.is_available()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()
    with pytest.raises(RuntimeError, match="--device cpu"):
        Trainer(TrainConfig(compressor="gaussian_fused"))
    from gaussiank_sgd_torch.train import main
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["--max-steps", "1"])
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        resolve_device("meta")


@pytest.mark.parametrize("module,argv", [
    ("gaussiank_sgd_torch.bench", ["--smoke", "--no-history"]),
    ("gaussiank_sgd_torch.bench_matrix", ["--quick"]),
    ("gaussiank_sgd_torch.roofline", ["--bw-gbps", "1"])])
def test_bench_clis_want_the_card_by_default(module, argv, tmp_path,
                                            monkeypatch):
    """The bench driver, the matrix and the roofline floor default to
    ``--device cuda`` and, with no card, raise before writing a file."""
    import argparse
    import importlib
    mod = importlib.import_module(module)
    seen = {}
    real = argparse.ArgumentParser.parse_args

    def spy(self, args=None, namespace=None):
        ns = real(self, args, namespace)
        seen["device"] = ns.device
        return ns
    out = (["--out", str(tmp_path / "roofline.json")]
           if module.endswith("roofline") else ["--out-dir", str(tmp_path)])
    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", spy)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mod.main([*argv, *out])
    assert seen["device"] == "cuda"
    assert not os.listdir(tmp_path)


def test_cli_trains_on_the_cpu_and_writes_metrics(tmp_path):
    cmd = [sys.executable, "-m", "gaussiank_sgd_torch.train",
           "--device", "cpu", "--config", CONFIG2,
           "--compressor", "gaussian_fused", "--nworkers", "1",
           "--max-steps", "3", "--compress-warmup-steps", "1",
           "--batch-size", "8", "--density", "0.01",
           "--compute-dtype", "float32",
           "--model-kwargs", json.dumps({"cfg": NARROW}),
           "--output-dir", str(tmp_path), "--run-id", "cli"]
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run(cmd, cwd=REPO, env=env, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    # config 2's file holds no key the port does not carry
    assert "ignoring keys this port does not carry" not in proc.stderr
    lines = (tmp_path / "cli" / "metrics.jsonl").read_text().splitlines()
    # the run's config, the train record, fit's eval pass and final
    # checkpoint; the step lines in steps.jsonl
    events = [json.loads(line)["event"] for line in lines]
    assert events == ["config", "train", "eval", "checkpoint"]
    recs = [json.loads(line) for line in
            (tmp_path / "cli" / "steps.jsonl").read_text().splitlines()]
    assert [r["kind"] for r in recs] == ["dense", "sparse", "sparse"]
    assert all(np.isfinite(r["loss"]) and r["step_ms"] > 0 for r in recs)
    assert recs[1]["k"] == recs[2]["k"] > 0
    assert recs[1]["num_selected"] == recs[1]["k"]   # cold step sends k


def test_config_file_precedence():
    argv = ["--config", CONFIG2, "--nworkers", "1", "--lr", "0.05"]
    p = __import__("argparse").ArgumentParser()
    add_args(p)
    cfg = from_args(p.parse_args(argv), argv)
    assert (cfg.dnn, cfg.batch_size, cfg.density) == ("vgg16", 128, 0.001)
    assert cfg.compress_warmup_steps == 390
    assert cfg.lr_milestones == (0.5, 0.75)
    assert (cfg.nworkers, cfg.lr) == (1, 0.05)         # flags win
    assert cfg.compressor == "gaussian"                # from the file
    assert cfg.device == "cuda"


def test_config_keys_the_port_does_not_carry(tmp_path):
    """A reference key the port does not carry is refused, naming its
    ROADMAP item, unless it holds the reference's default (then a note);
    a key neither package knows is refused."""
    p = __import__("argparse").ArgumentParser()
    add_args(p)

    def load(**keys):
        path = tmp_path / "c.json"
        path.write_text(json.dumps({"_comment": "x", "dnn": "vgg16",
                                    **keys}))
        argv = ["--config", str(path)]
        return from_args(p.parse_args(argv), argv)

    # health and health_port are carried since run health was ported, and
    # policy since the policy engine was
    for key, value, item in (("health", "on", None),
                             ("health_port", 9000, None),
                             ("policy", "adaptive", None)):
        if item is None:
            assert getattr(load(**{key: value}), key) == value
            continue
        with pytest.raises(ValueError, match=f"{key}=.*A item {item}"):
            load(**{key: value})
    # carried since the resilience runtime and the prefetching loader were
    # ported, and since the sequence-parallel path and the telemetry spine
    carried = dict(nonfinite_guard=False, max_consecutive_skips=2,
                   loss_spike_factor=3.0, loss_ema_beta=0.5, lr_backoff=0.25,
                   max_rollbacks=1, handle_signals=False, io_retries=5,
                   io_backoff_s=0.5, profile_steps=[3, 6], sp_size=2,
                   trace="on", prom_textfile="m.prom")
    cfg = load(**carried)
    assert {k: getattr(cfg, k) for k in carried} == {
        **carried, "profile_steps": (3, 6)}
    assert load(policy="static", carry_hidden=True,
                exchange="allgather").dnn == "vgg16"
    assert load(exchange="gtopk").exchange == "gtopk"
    # carried since the bench harness and the pipelined schedule were
    # ported
    cfg = load(phase_timing=True, telemetry_window=7, overlap="off")
    assert (cfg.phase_timing, cfg.telemetry_window, cfg.overlap) == (
        True, 7, "off")
    # carried since the optax path and the two-level exchange were ported
    cfg = load(ici_size=2, dcn_size=4, nesterov=True, fold_lr=True,
               sigma_scale=2.5, dataset_kwargs={"augment": False})
    assert (cfg.ici_size, cfg.dcn_size, cfg.nesterov, cfg.fold_lr,
            cfg.sigma_scale, cfg.dataset_kwargs) == (
        2, 4, True, True, 2.5, {"augment": False})
    # the reference's own refusal comes before the port's
    with pytest.raises(ValueError, match="mutually exclusive mesh layouts"):
        load(sp_size=2, ici_size=2, dcn_size=2)
    with pytest.raises(ValueError, match="unknown keys"):
        load(nonesuch=1)
    cfg = load(clip_norm=0.25, nsteps_update=2, eval_every_epochs=0,
               eval_max_batches=3, save_every_epochs=2, save_every_steps=5,
               keep_checkpoints=1, resume="runs/x/ckpt")
    assert (cfg.clip_norm, cfg.nsteps_update, cfg.eval_every_epochs,
            cfg.eval_max_batches, cfg.save_every_epochs,
            cfg.save_every_steps, cfg.keep_checkpoints, cfg.resume) == (
        0.25, 2, 0, 3, 2, 5, 1, "runs/x/ckpt")
    assert cfg.global_batch_size == 32 * 2
    flags = ["--nsteps-update", "4", "--clip-norm", "1.0", "--resume", "r",
             "--eval-max-batches", "2", "--save-every-steps", "3"]
    cfg = from_args(p.parse_args(flags), flags)
    assert (cfg.nsteps_update, cfg.clip_norm, cfg.resume,
            cfg.eval_max_batches, cfg.save_every_steps) == (4, 1.0, "r", 2, 3)
    config5 = REPO / "exp_configs" / "config5_transformer_wmt_randomk.json"
    cfg = from_args(p.parse_args(["--config", str(config5)]),
                    ["--config", str(config5)])
    assert (cfg.label_smoothing, cfg.compressor) == (0.1, "randomkec")


@pytest.mark.parametrize("name,dnn,n_params,want", [
    ("config4_lstm_ptb_gaussian", "lstm", 19_775_200,
     dict(dataset="ptb", batch_size=20, carry_hidden=True, clip_norm=0.25,
          compressor="gaussian", density=0.01, compute_dtype="float32",
          label_smoothing=0.0, decorrelate_comp_rng=False)),
    ("config5_transformer_wmt_randomk", "transformer", 60_524_544,
     dict(dataset="wmt", batch_size=32, carry_hidden=True, clip_norm=1.0,
          compressor="randomkec", density=0.001, compute_dtype="bfloat16",
          label_smoothing=0.1, decorrelate_comp_rng=False))])
def test_language_configs_load_and_build(name, dnn, n_params, want):
    """Configs 4 and 5 load without a refusal, with the reference's
    defaults for what they leave out, and build their models at full width
    on the CPU when asked for it."""
    from gaussiank_sgd_torch.models import get_model
    path = str(REPO / "exp_configs" / f"{name}.json")
    p = __import__("argparse").ArgumentParser()
    add_args(p)
    argv = ["--config", path, "--device", "cpu"]
    cfg = from_args(p.parse_args(argv), argv)
    assert cfg.dnn == dnn
    assert {k: getattr(cfg, k) for k in want} == want
    spec = get_model(cfg.dnn, cfg.dataset, device="cpu",
                     dtype={"float32": torch.float32,
                            "bfloat16": torch.bfloat16}[cfg.compute_dtype])
    assert spec.module.n_params == n_params
    assert spec.task == ("lm" if dnn == "lstm" else "seq2seq")
    assert spec.module.flat.device == torch.device("cpu")
    flags = ["--no-carry-hidden", "--label-smoothing", "0.2",
             "--decorrelate-comp-rng"]
    cfg = from_args(p.parse_args(argv + flags), argv + flags)
    assert (cfg.carry_hidden, cfg.label_smoothing,
            cfg.decorrelate_comp_rng) == (False, 0.2, True)


@pytest.mark.parametrize("dnn,dataset,n_params,task", [
    ("alexnet", "cifar10", 23_272_266, "classify"),
    ("mnistnet", "mnist", 1_663_370, "classify"),
    ("lstman4", "an4", 16_138_045, "ctc")])
def test_zoo_models_build_on_the_default_device(dnn, dataset, n_params,
                                                task):
    """``alexnet``, ``mnistnet`` and ``lstman4`` build on the default
    device, the card: here, with no card, they and their trainer raise
    the no-GPU error, and build on the CPU when asked for it, at full
    width; ``transformer_lm`` (and its alias) builds too, a language
    model."""
    from gaussiank_sgd_torch.models import get_model
    with pytest.raises(RuntimeError, match="device='cpu'"):
        get_model(dnn)
    with pytest.raises(RuntimeError, match="--device cpu"):
        Trainer(TrainConfig(dnn=dnn, dataset=dataset))
    spec = get_model(dnn, dataset, device="cpu")
    assert (spec.module.n_params, spec.task) == (n_params, task)
    assert spec.module.flat.device == torch.device("cpu")
    for name in ("transformer_lm", "transformerlm"):
        lm = get_model(name, device="cpu", vocab_size=100, dim=16, heads=2,
                       num_layers=1, ffn=32)
        assert (lm.name, lm.task) == ("transformer_lm", "lm")


@pytest.mark.parametrize("dnn,dataset", [("alexnet", "cifar10"),
                                         ("mnistnet", "mnist")])
def test_zoo_models_train_through_the_trainer(tmp_path, dnn, dataset):
    """``--dnn alexnet`` / ``mnistnet`` with ``--dataset cifar10`` /
    ``mnist`` through the flags and ``Trainer`` on the CPU: 1 dense + 2
    sparse steps of ``gaussian_fused``, finite losses, the cold step
    sending k."""
    argv = ["--device", "cpu", "--dnn", dnn, "--dataset", dataset,
            "--compressor", "gaussian_fused", "--max-steps", "3",
            "--compress-warmup-steps", "1", "--batch-size", "8",
            "--compute-dtype", "float32", "--output-dir", str(tmp_path)]
    p = __import__("argparse").ArgumentParser()
    add_args(p)
    t = Trainer(from_args(p.parse_args(argv), argv))
    assert (t.spec.name, t.spec.num_classes) == (dnn, 10)
    t.train(3)
    recs = t.records
    assert [r["kind"] for r in recs] == ["dense", "sparse", "sparse"]
    assert all(np.isfinite(r["loss"]) for r in recs)
    assert recs[1]["num_selected"] == recs[1]["k"] == t.plan.total_k


def _queue_a_items():
    text = (REPO / "ROADMAP.md").read_text()
    queue_a = text.split("### A.")[1].split("### B.")[0]
    return {int(m) for m in re.findall(r"^(\d+)\. \*\*", queue_a, re.M)}


def _off_default(default):
    """A value other than a config key's reference default."""
    if default is None:
        return "x"
    if isinstance(default, bool):
        return not default
    if isinstance(default, dict):
        return {"a": 1}
    if isinstance(default, str):
        return default + "x"
    return default + 1


def _refusals(tmp_path):
    """The message of every refusal the port makes for what it does not
    carry yet: config keys off their reference default (every model,
    dataset and task of the reference is ported)."""
    from gaussiank_sgd_torch.training.config import NOT_CARRIED
    out = []
    p = __import__("argparse").ArgumentParser()
    add_args(p)
    base = json.loads(pathlib.Path(CONFIG2).read_text())
    for key, (default, _) in NOT_CARRIED.items():
        path = tmp_path / f"{key}.json"
        path.write_text(json.dumps({**base, key: _off_default(default)}))
        argv = ["--config", str(path)]
        with pytest.raises(ValueError) as e:
            from_args(p.parse_args(argv), argv)
        out.append(str(e.value))
    return out


def test_every_refusal_names_a_queue_a_item(tmp_path):
    """Each "not ported yet" refusal names its place as ``ROADMAP A item
    N``, and N is an item of ROADMAP.md's queue A; no source file of the
    port keeps the older ``A7``/``A11`` labels."""
    items = _queue_a_items()
    assert {5, 6, 7, 9, 11} <= items
    messages = _refusals(tmp_path)
    from gaussiank_sgd_torch.training.config import NOT_CARRIED
    # every key of the reference is carried since the policy engine was
    # ported: nothing is refused
    assert len(messages) == len(NOT_CARRIED) == 0
    for msg in messages:
        m = re.search(r"ROADMAP A item (\d+)", msg)
        assert m and int(m.group(1)) in items, msg
    for path in PORT_FILES:
        text = (REPO / path).read_text()
        assert not re.search(r"ROADMAP A\d|\bA(7|9|10|11)\b", text), path


def test_registry():
    spec = get_compressor("auto", density=0.001)
    assert DEFAULT_SELECTOR == "gaussian_fused" == spec.name
    assert spec.stateful and spec.uses_error_feedback
    assert spec.fused_ef_fn is not None and spec.batched_fn is not None
    assert spec.ef_pad(14_986_698, 14_987) == 15_073_280
    assert get_compressor("none").out_k is None
    for name, alias, stateful in (("gaussian", "gaussiank", False),
                                  ("gaussian_warm", "gaussianw", True),
                                  ("gaussian_pallas", "gaussianp", False)):
        for n in (name, alias):
            spec = get_compressor(n)
            assert spec.name == name and spec.uses_error_feedback
            assert spec.stateful == stateful and spec.fused_ef_fn is None
            assert spec.out_k(7) == 7 and not spec.requires_rng
    for name in ("randomk", "randomkec"):
        spec = get_compressor(name)
        assert spec.requires_rng and not spec.stateful
        assert spec.uses_error_feedback == (name == "randomkec")
    assert get_compressor("gaussian_warm").batched_fn is not None
    fallback = get_compressor("gaussian_fused", density=0.05)
    assert fallback.name == "gaussian_fused(warm-fallback)"
    assert fallback.stateful and fallback.batched_fn is not None
    from gaussiank_sgd_tpu.compressors.registry import NAMES as JNAMES
    assert NAMES == JNAMES
    for name in NAMES:                     # every reference name builds
        spec = get_compressor(name)
        assert spec.name.split("(")[0] == name
        assert callable(spec.fn)
    with pytest.raises(ValueError):
        get_compressor("nonesuch")
    r = get_compressor("none").fn(torch.arange(5.0), 1)
    assert torch.equal(decompress(r.compressed, 5), torch.arange(5.0))


def test_bucket_flags_build_the_reference_plan():
    """``--bucket-size``/``--bucket-policy`` as the reference reads them,
    with its defaults (one whole-model bucket), and the trainer's plan over
    the model's layout."""
    p = __import__("argparse").ArgumentParser()
    add_args(p)
    cfg = from_args(p.parse_args([]))
    assert (cfg.bucket_size, cfg.bucket_policy) == (None, "greedy")
    argv = ["--bucket-size", "4096", "--bucket-policy", "uniform",
            "--device", "cpu", "--dnn", "vgg16", "--compressor",
            "gaussian_pallas", "--density", "0.01", "--compute-dtype",
            "float32", "--model-kwargs", json.dumps({"cfg": NARROW})]
    cfg = from_args(p.parse_args(argv), argv)
    assert (cfg.bucket_size, cfg.bucket_policy) == (4096, "uniform")
    trainer = Trainer(cfg)
    sizes = [int(np.prod(s)) for _, s in trainer.model.param_layout]
    assert trainer.plan == make_bucket_plan(sizes, 0.01, 4096,
                                            policy="uniform")
    assert trainer.plan.uniform and len(trainer.plan.buckets) > 1
    assert trainer.ts.fused_ef is None
    with pytest.raises(SystemExit):
        p.parse_args(["--bucket-policy", "sideways"])


@pytest.mark.parametrize("kw", [dict(), dict(bucket_size=0),
                                dict(bucket_size=1000),
                                dict(bucket_size=700, policy="uniform")])
def test_bucket_plans_match_reference(kw):
    sizes = [64, 3, 900, 5, 1200, 17]
    for density in (0.001, 0.01, 0.3):
        assert (make_bucket_plan(sizes, density, **kw)
                == jmake_plan(sizes, density, **kw))


@pytest.mark.parametrize("nworkers", [1, 4])
def test_lr_schedule_matches_reference(nworkers):
    """f32 values; within 1 ulp where the reference's traced ramp is
    contracted to a fused multiply-add or its pow is XLA's own."""
    args = (0.1, nworkers, 16, 100, 2.0, (0.5, 0.75), 0.1)
    ours, ref = warmup_milestone_schedule(*args), jschedule(*args)
    steps = [0, 1, 7, 31, 32, 49, 50, 74, 75, 99]
    got = np.asarray([ours(s) for s in steps], np.float32)
    want = np.asarray([ref(jnp.int32(s)) for s in steps], np.float32)
    np.testing.assert_array_max_ulp(got, want, 1)


def test_flat_opt_matches_reference():
    """Power-of-two hyper-parameters (exact products): bit for bit."""
    rng = np.random.default_rng(0)
    m, p, g = (rng.normal(size=1000).astype(np.float32) for _ in range(3))
    idx = np.array([3, 3, 999, 0, 1000], np.int32)     # 1000 is dropped
    val = rng.normal(size=5).astype(np.float32)
    kw = dict(lr=2.0 ** -3, momentum=0.5, weight_decay=2.0 ** -10)
    j, t = JFlatSGDM(**kw), FlatSGDM(**kw)
    for jo, to in ((j.sparse_step(jnp.asarray(m), jnp.asarray(idx),
                                  jnp.asarray(val), jnp.asarray(p), 0),
                    t.sparse_step(torch.from_numpy(m), torch.from_numpy(idx),
                                  torch.from_numpy(val), torch.from_numpy(p),
                                  0)),
                   (j.dense_step(jnp.asarray(m), jnp.asarray(g),
                                 jnp.asarray(p), 0),
                    t.dense_step(torch.from_numpy(m), torch.from_numpy(g),
                                 torch.from_numpy(p), 0))):
        for a, b in zip(to, jo):
            np.testing.assert_array_equal(a.numpy().view(np.int32),
                                          np.asarray(b).view(np.int32))
    assert FlatSGDM(lr=lambda s: 0.1 * (s + 1)).lr_at(2) == float(
        np.float32(0.1 * 3))


def test_collectives_world_of_one():
    assert collectives.world_size() == 1
    x = torch.arange(6.0)
    assert collectives.all_gather(x) is x
    assert torch.equal(collectives.dense_allreduce(x), x)
    comp = CompressedGrad(torch.tensor([4, 1, 4], dtype=torch.int32),
                          torch.tensor([1.0, 2.0, 0.5]))
    assert torch.equal(collectives.sparse_allgather_sum(comp, 6),
                       torch.tensor([0.0, 2.0, 0.0, 0.0, 1.5, 0.0]))
