"""The port's ImageNet data path against the reference's: the synthetic
uint8 images, ``make_imagenet``'s batches (synthetic and from ``.npy``
files), and the pixel normalisation done in the loss.

``_prep_pixels`` is held bit for bit against the reference's as XLA runs
it on the CPU. XLA does not divide there: it multiplies by f32(1/255) and
by the f32 reciprocals of the std, and contracts the first multiply and the
mean's subtraction into one fused multiply-add. Against the expression
computed as written (two IEEE divisions) that lowering differs in 74% of
the 768 (value, channel) pairs, by up to 262 ulp where ``x/255 - mean``
cancels to near zero and by at most 4.8e-7 in absolute terms; the port
rounds as XLA does.
"""

import argparse
import pathlib

import numpy as np
import jax
import pytest
import torch

from gaussiank_sgd_tpu.data import make_imagenet as jmake_imagenet
from gaussiank_sgd_tpu.data.synthetic import \
    synthetic_images_u8 as jsynthetic_u8
from gaussiank_sgd_tpu.training.losses import IMAGENET_NORM as JNORM
from gaussiank_sgd_tpu.training.losses import _prep_pixels as jprep
from gaussiank_sgd_torch.data import make_imagenet, synthetic_images_u8
from gaussiank_sgd_torch.training import trainer as trainer_mod
from gaussiank_sgd_torch.training.config import (TrainConfig, add_args,
                                                 from_args)
from gaussiank_sgd_torch.training.losses import IMAGENET_NORM, _prep_pixels


@pytest.mark.parametrize("seed", [0, 1])
def test_synthetic_images_u8_same_bytes(seed):
    x, y = synthetic_images_u8(24, (16, 16, 3), 1000, seed=seed)
    jx, jy = jsynthetic_u8(24, (16, 16, 3), 1000, seed=seed)
    assert x.dtype == np.uint8 and x.tobytes() == jx.tobytes()
    np.testing.assert_array_equal(y, jy)


def _batches(ds, n):
    it = iter(ds)
    return [next(it) for _ in range(n)]


@pytest.mark.parametrize("train", [True, False])
def test_make_imagenet_serves_the_reference_batches(train):
    """The synthetic stand-in at a small image size: the same uint8
    batches, in the same shuffled order, across epoch ends."""
    kw = dict(train=train, batch_size=8, image_size=16, seed=3,
              synthetic_examples=40)
    ds, nc = make_imagenet(None, **kw)
    jds, jnc = jmake_imagenet(None, **kw)
    assert nc == jnc == 1000 and ds.steps_per_epoch == 5
    for (x, y), (jx, jy) in zip(_batches(ds, 12), _batches(jds, 12)):
        assert x.dtype == np.uint8 and x.shape == (8, 16, 16, 3)
        np.testing.assert_array_equal(x, jx)
        np.testing.assert_array_equal(y, jy)
    # one draw a process: a second dataset shares the read-only arrays,
    # and its batches are fresh copies
    again, _ = make_imagenet(None, **kw)
    assert again.x is ds.x and not ds.x.flags.writeable
    assert next(iter(again))[0].flags.writeable


def test_make_imagenet_reads_npy_files(tmp_path):
    rng = np.random.default_rng(0)
    x = rng.integers(0, 256, size=(20, 8, 8, 3)).astype(np.uint8)
    y = rng.integers(0, 1000, size=20).astype(np.int64)
    np.save(tmp_path / "train_images.npy", x)
    np.save(tmp_path / "train_labels.npy", y)
    ds, _ = make_imagenet(str(tmp_path), batch_size=4, seed=1)
    jds, _ = jmake_imagenet(str(tmp_path), batch_size=4, seed=1)
    assert isinstance(ds.x, np.memmap) and ds.y.dtype == np.int32
    for (bx, by), (jx, jy) in zip(_batches(ds, 7), _batches(jds, 7)):
        np.testing.assert_array_equal(bx, jx)
        np.testing.assert_array_equal(by, jy)
    # the val split is absent: the synthetic stand-in
    val, _ = make_imagenet(str(tmp_path), train=False, batch_size=4,
                           image_size=8, synthetic_examples=8)
    assert val.x.shape == (8, 8, 8, 3)


def test_prep_pixels_is_the_references_bit_for_bit():
    every = np.repeat(np.arange(256, dtype=np.uint8)[None, :, None, None],
                      3, axis=3)
    batch = np.random.default_rng(1).integers(
        0, 256, size=(4, 8, 8, 3)).astype(np.uint8)
    for x in (batch, every):
        want = np.asarray(jax.jit(lambda a: jprep(a, JNORM))(x))
        got = _prep_pixels(torch.from_numpy(x), IMAGENET_NORM)
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy().view(np.int32),
                                      want.view(np.int32))
    mean, std = (np.asarray(v, np.float32) for v in IMAGENET_NORM)
    exact = (every.astype(np.float32) / np.float32(255.0) - mean) / std
    gap = np.abs(exact.view(np.int32).astype(np.int64)
                 - want.view(np.int32).astype(np.int64))
    print(f"XLA vs the divisions as written: {(gap > 0).mean():.1%} differ, "
          f"up to {gap.max()} ulp, {np.abs(exact - want).max():.3g} abs")
    assert np.abs(exact - want).max() < 5e-7   # the module docstring's gap
    f = torch.randn(2, 4, 4, 3)
    assert _prep_pixels(f, IMAGENET_NORM) is f
    u8 = torch.from_numpy(batch)
    assert _prep_pixels(u8, None) is u8


def test_trainer_normalises_imagenet_batches_in_the_loss(tmp_path,
                                                         monkeypatch):
    """Config 3's path at a small image size: the trainer serves uint8
    batches and its loss normalises them (the same loss as the model on
    the normalised floats); ResNet-50 with one block a stage, two steps
    (dense, then gaussian_fused)."""
    real = trainer_mod.make_dataset

    def small(dataset, data_dir, **kw):
        assert dataset == "imagenet"
        return real(dataset, data_dir, image_size=32, synthetic_examples=16,
                    **kw)

    monkeypatch.setattr(trainer_mod, "make_dataset", small)
    cfg = TrainConfig(dnn="resnet50", dataset="imagenet", batch_size=2,
                      compressor="gaussian_fused", density=0.01,
                      compress_warmup_steps=1, max_steps=2,
                      compute_dtype="float32", device="cpu",
                      model_kwargs={"stage_sizes": [1, 1, 1, 1]},
                      output_dir=str(tmp_path))
    t = trainer_mod.Trainer(cfg)
    assert t.spec.num_classes == 1000 and t.ts.fused_ef is not None
    x, y = t.next_batch()
    assert x.dtype == torch.uint8 and x.shape == (2, 32, 32, 3)
    stats = t.model.stats.clone()
    loss, _ = t.ts.loss_fn((x, y))
    t.model.stats.copy_(stats)
    logits = t.model(_prep_pixels(x, IMAGENET_NORM), train=True)
    t.model.stats.copy_(stats)
    ref = torch.nn.functional.cross_entropy(logits, y.long())
    assert torch.equal(loss, ref)
    t.fit()
    recs = t.records
    assert [r["kind"] for r in recs] == ["dense", "sparse"]
    assert all(np.isfinite(r["loss"]) for r in recs)


def test_config3_as_shipped_is_refused_at_one_process():
    """``"nworkers": 32`` needs 32 processes; one process is told so before
    anything is built."""
    argv = ["--config", str(pathlib.Path(__file__).resolve().parents[1]
                            / "exp_configs"
                            / "config3_resnet50_imagenet_gaussian.json"),
            "--device", "cpu"]
    p = argparse.ArgumentParser()
    add_args(p)
    cfg = from_args(p.parse_args(argv), argv)
    assert (cfg.dnn, cfg.dataset, cfg.nworkers, cfg.batch_size) == (
        "resnet50", "imagenet", 32, 64)
    with pytest.raises(ValueError, match="world size is 1"):
        trainer_mod.Trainer(cfg)
