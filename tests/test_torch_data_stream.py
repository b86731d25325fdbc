"""The port's train stream (gaussiank_sgd_torch/data/loader.py) against the
reference's (gaussiank_sgd_tpu/data/loader.py), both numpy only.

Each package's ``EpochStream`` over its own ``make_dataset``, built as the
reference's trainer builds it (no dataset seed, the run's seed to the
stream), serves bit-identical batches: synthetic CIFAR with its
augmentation and synthetic ImageNet, over 2.5 epochs from step 0 and from a
step in the middle of epoch 2. The port's ``Trainer`` draws exactly those
batches, with the microbatch factor in the global batch.
"""

import numpy as np
import pytest
import torch

from gaussiank_sgd_tpu.data import make_dataset as jmake_dataset
from gaussiank_sgd_tpu.data.loader import EpochStream as JEpochStream
from gaussiank_sgd_torch.data import EpochStream, make_dataset
from gaussiank_sgd_torch.data.cifar import ArrayDataset as CifarArrayDataset
from gaussiank_sgd_torch.data.loader import ArrayDataset
from gaussiank_sgd_torch.training.config import TrainConfig
from gaussiank_sgd_torch.training.trainer import Trainer

CASES = {
    "cifar10": dict(batch_size=32, synthetic_examples=200),
    "imagenet": dict(batch_size=8, synthetic_examples=44, image_size=16),
}
SEED = 42


def _pairs(dataset, start_step, n):
    kw = CASES[dataset]
    ds, _ = make_dataset(dataset, None, train=True, **kw)
    jds, _ = jmake_dataset(dataset, None, train=True, **kw)
    assert ds.steps_per_epoch == jds.steps_per_epoch
    ours, ref = EpochStream(ds, SEED, start_step), JEpochStream(jds, SEED,
                                                                start_step)
    return ds.steps_per_epoch, [(next(ours), next(ref)) for _ in range(n)]


@pytest.mark.parametrize("dataset", list(CASES))
@pytest.mark.parametrize("where", ["start", "mid_epoch_2"])
def test_epoch_stream_serves_the_reference_batches(dataset, where):
    spe = make_dataset(dataset, None, **CASES[dataset])[0].steps_per_epoch
    start = 0 if where == "start" else 2 * spe + spe // 2
    n = (5 * spe) // 2 if where == "start" else spe
    _, pairs = _pairs(dataset, start, n)
    for (x, y), (jx, jy) in pairs:
        assert x.dtype == jx.dtype and x.shape == jx.shape
        np.testing.assert_array_equal(x, jx)
        np.testing.assert_array_equal(y, jy)
    if where == "start":          # epochs are reshuffled, not repeated
        assert not np.array_equal(pairs[0][0][1], pairs[spe][0][1])


def test_array_dataset_moved_to_the_loader():
    assert CifarArrayDataset is ArrayDataset
    ds = ArrayDataset(np.arange(10), np.arange(10), 3, seed=1)
    assert ds.steps_per_epoch == 3                 # the ragged tail drops
    def order(seed):
        return sum((b[0].tolist() for b in ds.epoch(epoch_seed=seed)), [])

    assert order(7) == order(7) != order(8)
    assert len(set(order(7))) == 9


def test_trainer_draws_the_reference_stream():
    """Global batch = batch_size x nworkers x nsteps_update; the trainer's
    batches are the reference stream's, across an epoch's end."""
    cfg = TrainConfig(dnn="vgg16", batch_size=8, nsteps_update=2,
                      compute_dtype="float32", device="cpu", seed=SEED,
                      model_kwargs={"cfg": [8, "M"]})
    t = Trainer(cfg)
    assert t.train_ds.batch_size == 16 and t.eval_batch_size == 8
    assert t.steps_per_epoch == 2048 // 16
    jds, _ = jmake_dataset("cifar10", None, train=True, batch_size=16)
    ref = JEpochStream(jds, SEED, 0)
    for _ in range(3):
        x, y = t.next_batch()
        jx, jy = next(ref)
        np.testing.assert_array_equal(x.numpy(), jx)
        np.testing.assert_array_equal(y.numpy(), jy)
    # a stream rebuilt at a later step lands where the reference's does
    t.state.step, t._stream = 2 * t.steps_per_epoch - 1, None
    ref = JEpochStream(jds, SEED, t.state.step)
    for _ in range(2):
        x, _ = t.next_batch()
        assert torch.equal(x, torch.from_numpy(next(ref)[0]))
