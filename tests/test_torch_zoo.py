"""Parity of the port's ``alexnet`` and ``mnistnet`` (``models/alexnet.py``,
``models/mnistnet.py``) and of ``data/cifar.py:make_mnist`` with the
reference's.

Both models fix their dropout at 0.5 and the reference's modules take no
dropout argument, so the two packages are compared with dropout off:
forward, loss and gradient at ``train=False`` (neither model has
BatchNorm, so that turns off dropout only), and a 3-step ``gaussian``
trajectory (dense, sparse, sparse) whose loss on both sides is the
softmax cross-entropy of the ``train=False`` logits. Tolerances are
``tests/test_torch_resnet.py``'s: logits and losses at rtol 1e-4 / atol
1e-5 (the two frameworks sum convolutions in another order), losses 1e-3
once the two trajectories sent different entries; the flat gradient by
relative L2 (ReLU gates within f32 noise of zero), here within 1e-5. In
bf16, as ``tests/test_torch_vgg.py`` holds VGG: logits at rtol 2e-2 /
atol 1e-2, logits and gradient by relative L2 at half the reference's own
bf16-vs-f32 gap. The EF bookkeeping is held exact. MNIST data, from idx files or synthetic, bit
for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F
from jax.flatten_util import ravel_pytree

from gaussiank_sgd_tpu.compressors.registry import get_compressor as jcomp
from gaussiank_sgd_tpu.data.cifar import make_mnist as jmake_mnist
from gaussiank_sgd_tpu.models import get_model as jget_model
from gaussiank_sgd_tpu.parallel.bucketing import plan_for_params as jplan
from gaussiank_sgd_tpu.parallel.flat_opt import FlatSGDM as JFlatSGDM
from gaussiank_sgd_tpu.parallel.mesh import data_parallel_mesh, shard_batch
from gaussiank_sgd_tpu.parallel.trainstep import build_dp_train_step
from gaussiank_sgd_torch import convert
from gaussiank_sgd_torch.compressors import decompress, get_compressor
from gaussiank_sgd_torch.data import make_dataset
from gaussiank_sgd_torch.data.cifar import make_mnist
from gaussiank_sgd_torch.models import get_model
from gaussiank_sgd_torch.models.alexnet import AlexNet
from gaussiank_sgd_torch.models.mnistnet import MnistNet
from gaussiank_sgd_torch.parallel.bucketing import plan_for_params
from gaussiank_sgd_torch.parallel.flat_opt import FlatSGDM
from gaussiank_sgd_torch.parallel.trainstep import DPTrainStep, flat_numel

TOL = dict(rtol=1e-4, atol=1e-5)
# dnn: (port class, input shape NHWC, parameters)
CASES = {"alexnet": (AlexNet, (32, 32, 3), 23_272_266),
         "mnistnet": (MnistNet, (28, 28, 1), 1_663_370)}


def _paths(tree):
    return [("/".join(k.key for k in path), tuple(leaf.shape))
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]]


def _rel(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _flax(dnn, seed):
    spec = jget_model(dnn, dtype=jnp.float32)
    shape = CASES[dnn][1]
    v = spec.module.init({"params": jax.random.PRNGKey(seed)},
                         jnp.zeros((2,) + shape), train=False)
    return spec, jax.tree.map(np.asarray, v["params"])


def _batch(dnn, seed, n):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n,) + CASES[dnn][1]).astype(np.float32),
            rng.integers(0, 10, size=n).astype(np.int32))


@pytest.mark.parametrize("dnn", list(CASES))
def test_layout_is_flax_ravel_order(dnn):
    """Path for path and shape for shape at full width; every conv has a
    bias, as flax's ``Conv`` defaults to; no BatchNorm statistics."""
    cls, shape, n = CASES[dnn]
    spec = jget_model(dnn)
    v = jax.eval_shape(lambda: spec.module.init(
        {"params": jax.random.PRNGKey(0)}, jnp.zeros((2,) + shape),
        train=False))
    m = cls(device=torch.device("meta"))
    assert m.param_layout == _paths(v["params"])
    assert set(v) == {"params"} and m.stats.numel() == 0
    assert m.n_params == n
    assert all(f"{p.rsplit('/', 1)[0]}/bias" in dict(m.param_layout)
               for p, _ in m.param_layout if p.startswith("Conv"))


@pytest.mark.parametrize("dnn", list(CASES))
def test_forward_and_gradient_match_flax(dnn):
    """Logits and the cross-entropy's flat gradient at ``train=False``; in
    train mode the port's dropout keeps half of the dense activations."""
    spec, params = _flax(dnn, 1)
    x, y = _batch(dnn, 2, 8)

    def jloss(p):
        logits = spec.module.apply({"params": p}, jnp.asarray(x),
                                   train=False)
        return optax.softmax_cross_entropy_with_integer_labels(
            logits, jnp.asarray(y)).mean(), logits

    (jl, jlogits), jg = jax.value_and_grad(jloss, has_aux=True)(params)
    m = get_model(dnn, device="cpu").module
    convert.load_flax_variables(m, params)
    logits = m(torch.from_numpy(x), train=False)
    loss = F.cross_entropy(logits, torch.from_numpy(y).long())
    (g,) = torch.autograd.grad(loss, m.flat)
    assert logits.dtype == torch.float32
    np.testing.assert_allclose(logits.detach().numpy(), jlogits, **TOL)
    np.testing.assert_allclose(float(loss.detach()), float(jl), **TOL)
    assert _rel(g.numpy(), np.asarray(ravel_pytree(jg)[0])) < 1e-5
    with torch.no_grad():
        trained = m(torch.from_numpy(x), train=True)
    assert not torch.equal(trained, logits.detach())


@pytest.mark.parametrize("dnn", list(CASES))
def test_bf16_compute_casts_like_flax(dnn):
    """bf16 compute (the CLI's default dtype) against the reference's bf16
    model on the same weights at ``train=False``: the convs with their
    biases and the hidden dense layers in bf16, the last layer in f32.
    Both round to bf16 after f32 sums in their own order, so logits agree
    to the VGG bf16 test's rtol 2e-2 / atol 1e-2, and logits and the flat
    gradient are held by relative L2 at half the reference's own
    bf16-vs-f32 gap (a cast left out or added lands near that gap)."""
    _, params = _flax(dnn, 1)
    x, y = _batch(dnn, 2, 16)

    def flax_run(dtype):
        spec = jget_model(dnn, dtype=dtype)

        def jloss(p):
            logits = spec.module.apply({"params": p}, jnp.asarray(x),
                                       train=False)
            return optax.softmax_cross_entropy_with_integer_labels(
                logits, jnp.asarray(y)).mean(), logits

        (loss, logits), grad = jax.value_and_grad(jloss, has_aux=True)(
            params)
        return (float(loss), np.asarray(logits),
                np.asarray(ravel_pytree(grad)[0]))

    jl, jlogits, jgrad = flax_run(jnp.bfloat16)
    _, jlogits32, jgrad32 = flax_run(jnp.float32)
    m = get_model(dnn, dtype=torch.bfloat16, device="cpu").module
    convert.load_flax_variables(m, params)
    logits = m(torch.from_numpy(x), train=False)
    assert logits.dtype == torch.float32
    loss = F.cross_entropy(logits, torch.from_numpy(y).long())
    (g,) = torch.autograd.grad(loss, m.flat)
    logits, g = logits.detach().numpy(), g[:m.n_params].numpy()
    np.testing.assert_allclose(logits, jlogits, rtol=2e-2, atol=1e-2)
    np.testing.assert_allclose(float(loss.detach()), jl, rtol=5e-3)
    assert _rel(logits, jlogits) < 0.5 * _rel(jlogits, jlogits32)
    assert _rel(g, jgrad) < 0.5 * _rel(jgrad, jgrad32)


@pytest.mark.parametrize("dnn", list(CASES))
def test_gaussian_trajectory_matches_reference(dnn):
    """3 steps (dense, sparse, sparse) of config 2's own compressor
    ``gaussian`` at density 0.001 with ``FlatSGDM``, from the reference's
    weights on the same batches: losses at rtol 1e-4 (1e-3 once the sent
    entries differ), the first sparse step's num_selected equal, the EF
    bookkeeping exact on every sparse step."""
    density = 0.001
    opt = dict(lr=0.01, momentum=0.9, weight_decay=5e-4)
    spec, params = _flax(dnn, 3)

    def jloss_fn(p, mstate, batch, rng):
        x, y = batch
        logits = spec.module.apply({"params": p}, x, train=False)
        loss = optax.softmax_cross_entropy_with_integer_labels(
            logits, y).mean()
        return loss, (mstate, {"acc": (logits.argmax(-1) == y).mean()})

    mesh = data_parallel_mesh(1)
    jts = build_dp_train_step(jloss_fn, None,
                              jcomp("gaussian", density=density),
                              jplan(params, density), mesh,
                              flat_opt=JFlatSGDM(**opt), wire="off")
    jstate = jts.init_state(jax.tree.map(jnp.asarray, params),
                            jax.random.PRNGKey(1))
    model = get_model(dnn, device="cpu").module
    plan = plan_for_params(model.param_layout, density)
    assert plan == jplan(params, density)
    tspec = get_compressor("gaussian", density=density)
    model.pad_flat(flat_numel(tspec, plan))
    convert.load_flax_variables(model, params)

    def loss_fn(batch):
        x, y = batch
        logits = model(x, train=False)
        y = y.long()
        return (F.cross_entropy(logits, y),
                {"acc": (logits.argmax(-1) == y).float().mean().detach()})

    ts = DPTrainStep(loss_fn, model.flat, {"stats": model.stats}, tspec,
                     plan, flat_opt=FlatSGDM(**opt), wire="off")
    state = ts.init_state()
    sent_differs = False
    for i, kind in enumerate(("dense", "sparse", "sparse")):
        x, y = _batch(dnn, 10 + i, 16)
        tb = (torch.from_numpy(x), torch.from_numpy(y))
        if kind == "sparse":
            g = ts.local_grads(state, tb)
            comp, residual, _, _ = ts.compress_phase(state, g.flat_g)
            acc = state.ef_residual + g.flat_g
            assert torch.equal(decompress(comp, ts.ef_numel) + residual, acc)
        jfn = jts.dense_step if kind == "dense" else jts.sparse_step
        jstate, jm = jfn(jstate, shard_batch(mesh, (x, y)))
        tfn = ts.dense_step if kind == "dense" else ts.sparse_step
        tm = tfn(state, tb)
        np.testing.assert_allclose(float(tm.loss), float(jm.loss),
                                   rtol=1e-3 if sent_differs else 1e-4,
                                   atol=1e-5)
        if kind == "sparse":
            live = acc[:ts.n_total].numpy() != 0
            port = live & (state.ef_residual[:ts.n_total].numpy() == 0)
            ref = live & (np.asarray(jstate.ef_residual).reshape(-1)[
                :ts.n_total] == 0)
            if i == 1:
                assert float(tm.num_selected) == float(jm.num_selected)
            sent_differs |= bool((port != ref).any())


def _idx_files(root, prefix, n, seed):
    """MNIST's idx layout: a 16-byte image header and an 8-byte label
    header (big-endian magic and sizes) before the uint8 payload."""
    rng = np.random.default_rng(seed)
    images = rng.integers(0, 256, size=(n, 28, 28), dtype=np.uint8)
    labels = rng.integers(0, 10, size=n, dtype=np.uint8)
    (root / f"{prefix}-images-idx3-ubyte").write_bytes(
        np.array([2051, n, 28, 28], ">i4").tobytes() + images.tobytes())
    (root / f"{prefix}-labels-idx1-ubyte").write_bytes(
        np.array([2049, n], ">i4").tobytes() + labels.tobytes())
    return images, labels


@pytest.mark.parametrize("label_noise", [0.0, 0.3])
def test_make_mnist_reads_idx_files(tmp_path, label_noise):
    """Both splits from idx bytes: the images ``(x / 255 - 0.1307) /
    0.3081`` f32 ``[N, 28, 28, 1]`` and the labels (flipped at
    ``label_noise``), and an epoch's batches, bit for bit."""
    for train, prefix, n in ((True, "train", 64), (False, "t10k", 32)):
        images, labels = _idx_files(tmp_path, prefix, n, seed=n)
        ds, card = make_mnist(str(tmp_path), train=train, batch_size=16,
                              label_noise=label_noise)
        jds, jcard = jmake_mnist(str(tmp_path), train=train, batch_size=16,
                                 label_noise=label_noise)
        assert card == jcard == 10
        np.testing.assert_array_equal(ds.x, jds.arrays[0])
        np.testing.assert_array_equal(ds.y, jds.arrays[1])
        assert ds.x.dtype == np.float32 and ds.x.shape == (n, 28, 28, 1)
        assert ds.y.dtype == np.int32
        assert (ds.y != labels).any() == (label_noise > 0)
        for (x, y), (jx, jy) in zip(ds.epoch(epoch_seed=5),
                                    jds.epoch(epoch_seed=5), strict=True):
            np.testing.assert_array_equal(x, jx)
            np.testing.assert_array_equal(y, jy)


def test_make_mnist_synthetic_fallback(tmp_path):
    """No idx files (or ``data_dir`` None): the synthetic images bit for
    bit, both splits; ``make_dataset("mnist")`` and ``get_model("mnist")``
    dispatch to them."""
    for data_dir in (None, str(tmp_path)):
        for train in (True, False):
            ds, _ = make_mnist(data_dir, train=train, batch_size=128,
                               label_noise=0.1)
            jds, _ = jmake_mnist(data_dir, train=train, batch_size=128,
                                 label_noise=0.1)
            np.testing.assert_array_equal(ds.x, jds.arrays[0])
            np.testing.assert_array_equal(ds.y, jds.arrays[1])
    ds, card = make_dataset("mnist", batch_size=128)
    assert (card, ds.x.shape, ds.steps_per_epoch) == (10, (2048, 28, 28, 1),
                                                      16)
    spec = get_model("mnist", device="cpu")
    assert (spec.name, spec.input_shape, spec.task) == (
        "mnistnet", (28, 28, 1), "classify")
