"""The port's eval pass (``training/losses.py:make_eval_fn``,
``training/trainer.py:Trainer.test``) against the reference's
``make_eval_fn``.

* On the same f32 weights (flax's, converted; BatchNorm statistics
  perturbed so the running statistics matter) and batches: ``top1``,
  ``top5`` and ``n`` exactly, ``loss_sum`` within 1e-5 relative (the two
  frameworks sum convolutions in another order), for a narrow VGG, resnet20
  and resnet20 on uint8 pixels normalised on the device.
* ``Trainer.test`` at P = 1 over the test split equals the reference's sums
  over the same batches with the trainer's own weights; at P = 2 over gloo
  (each rank evaluates its rows, the sums are added over the group) it
  gives the P = 1 totals; ``eval_max_batches`` caps the pass, and the
  ``eval`` line lands in ``metrics.jsonl``.
"""

import json

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from gaussiank_sgd_tpu.data import make_dataset as jmake_dataset
from gaussiank_sgd_tpu.models import get_model as jget_model
from gaussiank_sgd_tpu.training.losses import IMAGENET_NORM as JNORM
from gaussiank_sgd_tpu.training.losses import make_eval_fn as jmake_eval
from gaussiank_sgd_torch import convert
from gaussiank_sgd_torch.models import get_model
from gaussiank_sgd_torch.training.config import TrainConfig
from gaussiank_sgd_torch.training.losses import IMAGENET_NORM, make_eval_fn
from gaussiank_sgd_torch.training.trainer import Trainer
from test_torch_distributed import _spawn

NARROW = [8, "M", 8, "M", 16, "M", 16, "M", 16, "M"]
CASES = {"vgg": ("vgg16", dict(cfg=NARROW), False),
         "resnet20": ("resnet20", {}, False),
         "resnet20_u8": ("resnet20", {}, True)}


def _perturb_stats(stats, rng):
    def leaf(path, a):
        if path[-1].key == "var":
            return rng.uniform(0.5, 2.0, a.shape).astype(np.float32)
        return (0.1 * rng.normal(size=a.shape)).astype(np.float32)
    return jax.tree_util.tree_map_with_path(leaf, stats)


def _ref_sums(spec, params, stats, batch, u8):
    fn = jmake_eval(spec, input_norm=JNORM if u8 else None)
    sums = fn(jax.tree.map(jnp.asarray, params),
              {"batch_stats": jax.tree.map(jnp.asarray, stats)},
              tuple(jnp.asarray(a) for a in batch))
    return {k: float(v) for k, v in sums.items()}


def _check(got, want):
    for key in ("top1", "top5", "n"):
        assert got[key] == want[key], (key, got, want)
    np.testing.assert_allclose(got["loss_sum"], want["loss_sum"], rtol=1e-5)


@pytest.mark.parametrize("case", list(CASES))
def test_eval_sums_match_reference(case):
    dnn, kw, u8 = CASES[case]
    spec = jget_model(dnn, "cifar10", num_classes=10, dtype=jnp.float32,
                      **{k: tuple(v) for k, v in kw.items()})
    v = spec.module.init({"params": jax.random.PRNGKey(0),
                          "dropout": jax.random.PRNGKey(0)},
                         jnp.zeros((2, 32, 32, 3)), train=False)
    rng = np.random.default_rng(0)
    params = jax.tree.map(np.asarray, v["params"])
    stats = _perturb_stats(v["batch_stats"], rng)
    model = get_model(dnn, num_classes=10, dtype=torch.float32, device="cpu",
                      **kw).module
    convert.load_flax_variables(model, params, stats)
    before = model.stats.clone()
    fn = make_eval_fn(model, input_norm=IMAGENET_NORM if u8 else None)
    for _ in range(2):
        x = (rng.integers(0, 256, size=(64, 32, 32, 3)).astype(np.uint8)
             if u8 else rng.normal(size=(64, 32, 32, 3)).astype(np.float32))
        y = rng.integers(0, 10, size=64).astype(np.int32)
        got = {k: float(t) for k, t in
               fn((torch.from_numpy(x), torch.from_numpy(y))).items()}
        _check(got, _ref_sums(spec, params, stats, (x, y), u8))
        assert 0 < got["top1"] <= got["top5"] < got["n"] == 64
    assert torch.equal(model.stats, before)       # eval mode: stats kept
    with pytest.raises(ValueError, match="unknown task"):
        make_eval_fn(model, task="nonesuch")


def _cfg(tmp_path, nworkers, batch_size, **kw):
    return TrainConfig(dnn="vgg16", batch_size=batch_size,
                       nworkers=nworkers, compute_dtype="float32",
                       device="cpu", model_kwargs={"cfg": NARROW},
                       output_dir=str(tmp_path), **kw)


def test_trainer_test_matches_reference_sums(tmp_path):
    """P = 1: the pass's totals are the reference eval function's sums over
    the same test batches with the trainer's weights and statistics, and
    the eval line lands in metrics.jsonl; ``eval_max_batches`` caps it."""
    t = Trainer(_cfg(tmp_path, 1, 128, run_id="p1"))
    assert t.eval_batch_size == 128 and t.test_ds.steps_per_epoch == 16
    t.model.stats.copy_(torch.from_numpy(convert.flatten_tree(
        _perturb_stats(convert.export_flax_variables(t.model)[1],
                       np.random.default_rng(1)), t.model.stats_layout)))
    out = t.test()
    params, stats = convert.export_flax_variables(t.model)
    spec = jget_model("vgg16", "cifar10", num_classes=10, dtype=jnp.float32,
                      cfg=tuple(NARROW))
    jds, _ = jmake_dataset("cifar10", None, train=False, batch_size=128)
    want = {"loss_sum": 0.0, "top1": 0.0, "top5": 0.0, "n": 0.0}
    for batch in jds.epoch():
        for k, v in _ref_sums(spec, params, stats, batch, False).items():
            want[k] += v
    assert want["n"] == 2048
    np.testing.assert_allclose(out["val_loss"], want["loss_sum"] / 2048,
                               rtol=1e-5)
    assert out["top1"] == want["top1"] / 2048
    assert out["top5"] == want["top5"] / 2048
    capped = Trainer(_cfg(tmp_path, 1, 128, run_id="cap",
                          eval_max_batches=3))
    capped.test()
    lines = [json.loads(line) for line in
             (tmp_path / "p1" / "metrics.jsonl").read_text().splitlines()
             + (tmp_path / "cap" / "metrics.jsonl").read_text().splitlines()]
    lines = [r for r in lines if r["event"] == "eval"]
    assert [(r["event"], r["step"], r["epoch"], r["n"]) for r in lines] == [
        ("eval", 0, 0, 2048.0), ("eval", 0, 0, 384.0)]
    assert lines[0]["top1"] == out["top1"] and lines[1]["eval_ms"] > 0


def _w_test(rank, world, out_dir, narrow):
    from gaussiank_sgd_torch.training.config import TrainConfig
    from gaussiank_sgd_torch.training.trainer import Trainer
    t = Trainer(TrainConfig(dnn="vgg16", batch_size=16, nworkers=world,
                            compute_dtype="float32", device="cpu",
                            model_kwargs={"cfg": narrow},
                            eval_max_batches=5, output_dir=out_dir,
                            run_id="p2"))
    return {"out": t.test(), "eval_batch": t.eval_batch_size}


def test_trainer_test_two_workers_equals_one(tmp_path):
    """P = 2 over gloo, each rank on its 16 rows of a 32-row eval batch,
    against P = 1 on the whole 32-row batches: the same top1 and top5
    counts, and val_loss within 1e-6 (the sums add in another order)."""
    outs = _spawn(tmp_path, 2, _w_test, out_dir=str(tmp_path),
                  narrow=NARROW)
    one = Trainer(_cfg(tmp_path, 1, 32, run_id="p1",
                       eval_max_batches=5)).test()
    for o in outs:
        assert o["eval_batch"] == 32
        assert (o["out"]["top1"], o["out"]["top5"]) == (one["top1"],
                                                        one["top5"])
        np.testing.assert_allclose(o["out"]["val_loss"], one["val_loss"],
                                   rtol=1e-6)
    (rec,) = [r for r in map(json.loads, (tmp_path / "p2" / "metrics.jsonl")
                             .read_text().splitlines())
              if r["event"] == "eval"]
    assert rec["n"] == 5 * 32                         # rank 0 writes alone
