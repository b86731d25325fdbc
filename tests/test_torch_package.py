"""The port's package rules and its host-side modules.

* No module of ``gaussiank_sgd_torch`` and not ``chip_smoke.py`` imports
  JAX, flax, optax or anything of ``gaussiank_sgd_tpu`` (an AST scan).
* Entry points run on the GPU unless asked for the CPU: here, with no GPU,
  they raise instead of running on the CPU.
* ``python -m gaussiank_sgd_torch.train --device cpu`` trains and writes
  its metrics.
* Config, registry, bucketing, schedule, flat optimizer and collectives
  agree with the reference where it has a counterpart.
"""

import ast
import json
import os
import pathlib
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
    assert "ignoring keys this port does not carry" in proc.stderr
    lines = (tmp_path / "cli" / "metrics.jsonl").read_text().splitlines()
    recs = [json.loads(line) for line in lines]
    # the step lines, then fit's eval pass and final checkpoint
    events = [r.pop("event") for r in recs if "event" in r]
    assert events == ["eval", "checkpoint"]
    recs = [r for r in recs if "kind" in r]
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

    for key, value, item in (("exchange", "gtopk", 9),
                             ("label_smoothing", 0.1, 7),
                             ("carry_hidden", False, 7),
                             ("nesterov", True, 11)):
        with pytest.raises(ValueError, match=f"{key}=.*A item {item}"):
            load(**{key: value})
    assert load(policy="static", carry_hidden=True,
                exchange="allgather").dnn == "vgg16"
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
    with pytest.raises(ValueError, match="label_smoothing=0.1"):
        from_args(p.parse_args(["--config", str(config5)]),
                  ["--config", str(config5)])


def test_registry():
    spec = get_compressor("auto", density=0.001)
    assert DEFAULT_SELECTOR == "gaussian_fused" == spec.name
    assert spec.stateful and spec.uses_error_feedback
    assert spec.fused_ef_fn is not None and spec.batched_fn is not None
    assert spec.ef_pad(14_986_698, 14_987) == 15_073_280
    assert get_compressor("none").out_k is None
    ported = {"none", "gaussian", "gaussian_warm", "gaussian_pallas",
              "gaussian_fused"}
    for name, alias, stateful in (("gaussian", "gaussiank", False),
                                  ("gaussian_warm", "gaussianw", True),
                                  ("gaussian_pallas", "gaussianp", False)):
        for n in (name, alias):
            spec = get_compressor(n)
            assert spec.name == name and spec.uses_error_feedback
            assert spec.stateful == stateful and spec.fused_ef_fn is None
            assert spec.out_k(7) == 7
    assert get_compressor("gaussian_warm").batched_fn is not None
    fallback = get_compressor("gaussian_fused", density=0.05)
    assert fallback.name == "gaussian_fused(warm-fallback)"
    assert fallback.stateful and fallback.batched_fn is not None
    for name in NAMES:
        if name not in ported:
            with pytest.raises(NotImplementedError, match="ROADMAP"):
                get_compressor(name)
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
