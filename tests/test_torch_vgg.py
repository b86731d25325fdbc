"""Parity of the port's VGG-16 (gaussiank_sgd_torch/models/vgg.py) and its
weight transfer (convert.py) with the reference's flax VGG16.

The reference's weights go through numpy into the port. Forward, loss,
flat gradient (in the reference's ``ravel_pytree`` order) and the updated
BatchNorm statistics are compared in f32 with dropout off, at rtol 1e-4 /
atol 1e-5: the two frameworks sum convolutions in another order.
"""

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch
from jax.flatten_util import ravel_pytree

from gaussiank_sgd_tpu.models import get_model as jget_model
from gaussiank_sgd_tpu.models.vgg import VGG16 as JVGG16
from gaussiank_sgd_torch import convert
from gaussiank_sgd_torch.models import get_model
from gaussiank_sgd_torch.models.vgg import VGG16
from gaussiank_sgd_torch.training.losses import make_loss_fn

NARROW = (8, "M", 8, "M", 16, "M", 16, "M", 16, "M")
TOL = dict(rtol=1e-4, atol=1e-5)


def _paths(tree):
    return [("/".join(k.key for k in path), tuple(leaf.shape))
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]]


def test_full_vgg16_layout_is_flax_ravel_order():
    """Every leaf of the full-width model, in ravel_pytree order, with
    flax's shapes (HWIO convs, [in, out] dense): n = 14,986,698."""
    v = jax.eval_shape(lambda: JVGG16().init(
        {"params": jax.random.PRNGKey(0)}, jnp.zeros((2, 32, 32, 3)),
        train=False))
    m = VGG16(device=torch.device("meta"))
    assert m.param_layout == _paths(v["params"])
    assert m.stats_layout == _paths(v["batch_stats"])
    assert m.flat.numel() == 14_986_698
    order = [p for p, _ in m.param_layout]
    assert order[:4] == ["BatchNorm_0/bias", "BatchNorm_0/scale",
                         "BatchNorm_1/bias", "BatchNorm_1/scale"]
    assert order.index("BatchNorm_10/bias") < order.index("BatchNorm_2/bias")
    assert order[-4:] == ["Dense_0/bias", "Dense_0/kernel", "Dense_1/bias",
                          "Dense_1/kernel"]


def _flax_narrow(seed=0):
    spec = jget_model("vgg16", "cifar10", num_classes=10, dtype=jnp.float32,
                      cfg=NARROW, dropout=0.0)
    v = spec.module.init({"params": jax.random.PRNGKey(seed),
                          "dropout": jax.random.PRNGKey(seed)},
                         jnp.zeros((2, 32, 32, 3)), train=False)
    # perturb the BN leaves so the comparison sees non-trivial values
    rng = np.random.default_rng(seed)
    params = jax.tree.map(np.asarray, v["params"])
    stats = jax.tree.map(np.asarray, v["batch_stats"])
    for mod in params:
        if mod.startswith("BatchNorm"):
            params[mod]["scale"] = (1 + 0.1 * rng.normal(
                size=params[mod]["scale"].shape)).astype(np.float32)
            params[mod]["bias"] = (0.1 * rng.normal(
                size=params[mod]["bias"].shape)).astype(np.float32)
            stats[mod]["var"] = rng.uniform(
                0.5, 2.0, stats[mod]["var"].shape).astype(np.float32)
    return spec, params, stats


def _port_narrow(params, stats):
    m = get_model("vgg16", num_classes=10, dtype=torch.float32, cfg=NARROW,
                  dropout=0.0, device="cpu").module
    convert.load_flax_variables(m, params, stats)
    return m


def test_convert_round_trip():
    _, params, stats = _flax_narrow(1)
    m = _port_narrow(params, stats)
    p2, s2 = convert.export_flax_variables(m)
    for a, b in ((params, p2), (stats, s2)):
        assert jax.tree.structure(a) == jax.tree.structure(b)
        for x, y in zip(jax.tree.leaves(a), jax.tree.leaves(b)):
            np.testing.assert_array_equal(x, y)
    np.testing.assert_array_equal(m.flat.detach().numpy(),
                                  np.asarray(ravel_pytree(params)[0]))
    flat = convert.flatten_tree(params, m.param_layout)
    back = convert.unflatten_tree(flat, m.param_layout)
    np.testing.assert_array_equal(convert.flatten_tree(back, m.param_layout),
                                  flat)
    bad = dict(params)
    bad.pop("Dense_1")
    with pytest.raises(ValueError, match="missing"):
        convert.flatten_tree(bad, m.param_layout)
    bad = {k: dict(v) for k, v in params.items()}
    bad["Conv_0"]["kernel"] = bad["Conv_0"]["kernel"][..., :1]
    with pytest.raises(ValueError, match="shape"):
        convert.flatten_tree(bad, m.param_layout)


def test_narrow_vgg_forward_grad_and_stats_match_flax():
    spec, params, stats = _flax_narrow(2)
    rng = np.random.default_rng(3)
    x = rng.normal(size=(16, 32, 32, 3)).astype(np.float32)
    y = rng.integers(0, 10, size=16).astype(np.int32)

    def jloss(p):
        logits, upd = spec.module.apply(
            {"params": p, "batch_stats": stats}, jnp.asarray(x), train=True,
            mutable=["batch_stats"])
        loss = optax.softmax_cross_entropy_with_integer_labels(
            logits, jnp.asarray(y)).mean()
        return loss, (logits, upd["batch_stats"])

    (jl, (jlogits, jstats)), jgrad = jax.value_and_grad(
        jloss, has_aux=True)(params)
    m = _port_narrow(params, stats)
    loss_fn = make_loss_fn(m)
    tl, aux = loss_fn((torch.from_numpy(x), torch.from_numpy(y)))
    (tgrad,) = torch.autograd.grad(tl, m.flat)
    np.testing.assert_allclose(float(tl.detach()), float(jl), **TOL)
    np.testing.assert_allclose(tgrad.numpy(),
                               np.asarray(ravel_pytree(jgrad)[0]), **TOL)
    np.testing.assert_allclose(
        m.stats.numpy(),
        convert.flatten_tree(jax.tree.map(np.asarray, jstats),
                             m.stats_layout), **TOL)
    acc = float((np.asarray(jlogits).argmax(-1) == y).mean())
    assert float(aux["acc"]) == acc
    # train-mode logits, and eval mode on the updated running statistics
    m2 = _port_narrow(params, stats)
    np.testing.assert_allclose(
        m2(torch.from_numpy(x), train=True).detach().numpy(),
        np.asarray(jlogits), **TOL)
    jeval = spec.module.apply({"params": params, "batch_stats": jstats},
                              jnp.asarray(x), train=False)
    np.testing.assert_allclose(
        m(torch.from_numpy(x), train=False).detach().numpy(),
        np.asarray(jeval), **TOL)


def _rel(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.mark.parametrize("seed", [4, 5])
def test_bf16_compute_casts_like_flax(seed):
    """bf16 compute (config 2's dtype) against flax's bf16 model on the same
    weights: conv and the first dense layer in bf16, BatchNorm and the last
    layer in f32. Both round to bf16 (8 mantissa bits) in their own order,
    so eval logits agree to rtol 2e-2 (their median to 1e-5); in train
    mode the batch statistics of bf16 activations compound it, so logits
    and the flat gradient are held by relative L2 error, and must sit well
    inside flax's own bf16-vs-f32 gap (a cast left out or added lands near
    that gap)."""
    _, params, stats = _flax_narrow(seed)
    rng = np.random.default_rng(seed + 1)
    x = rng.normal(size=(16, 32, 32, 3)).astype(np.float32)
    y = rng.integers(0, 10, size=16).astype(np.int32)

    def flax_run(dtype):
        spec = jget_model("vgg16", "cifar10", num_classes=10, dtype=dtype,
                          cfg=NARROW, dropout=0.0)

        def jloss(p):
            logits, upd = spec.module.apply(
                {"params": p, "batch_stats": stats}, jnp.asarray(x),
                train=True, mutable=["batch_stats"])
            loss = optax.softmax_cross_entropy_with_integer_labels(
                logits, jnp.asarray(y)).mean()
            return loss, (logits, upd["batch_stats"])

        (loss, (logits, new_stats)), grad = jax.value_and_grad(
            jloss, has_aux=True)(params)
        evals = spec.module.apply({"params": params, "batch_stats": stats},
                                  jnp.asarray(x), train=False)
        return (float(loss), np.asarray(logits),
                np.asarray(ravel_pytree(grad)[0]), new_stats,
                np.asarray(evals))

    jl, jlogits, jgrad, jstats, jeval = flax_run(jnp.bfloat16)
    _, jlogits32, jgrad32, _, _ = flax_run(jnp.float32)

    m = get_model("vgg16", num_classes=10, dtype=torch.bfloat16,
                  cfg=NARROW, dropout=0.0, device="cpu").module
    convert.load_flax_variables(m, params, stats)
    teval = m(torch.from_numpy(x), train=False)
    assert teval.dtype == torch.float32
    teval = teval.detach().numpy()
    np.testing.assert_allclose(teval, jeval, rtol=2e-2, atol=1e-2)
    # eval mode casts at the same points: most logits agree to f32
    # rounding, and only a row where one bf16 rounding flipped moves
    assert np.median(np.abs(teval - jeval)) < 1e-5

    tlogits = m(torch.from_numpy(x), train=True)
    m.stats.copy_(torch.from_numpy(
        convert.flatten_tree(stats, m.stats_layout)))
    tl, _ = make_loss_fn(m)((torch.from_numpy(x), torch.from_numpy(y)))
    (tgrad,) = torch.autograd.grad(tl, m.flat)
    np.testing.assert_allclose(float(tl.detach()), jl, rtol=5e-3)
    np.testing.assert_allclose(
        m.stats.numpy(),
        convert.flatten_tree(jax.tree.map(np.asarray, jstats),
                             m.stats_layout), rtol=1e-3, atol=1e-3)
    tlogits = tlogits.detach().numpy()
    tgrad = tgrad.numpy()
    assert _rel(tlogits, jlogits) < 1e-2
    assert _rel(tgrad, jgrad) < 7e-2
    assert _rel(tlogits, jlogits) < 0.5 * _rel(jlogits, jlogits32)
    assert _rel(tgrad, jgrad) < 0.5 * _rel(jgrad, jgrad32)


def test_get_model_device_and_names():
    with pytest.raises(RuntimeError, match="device='cpu'"):
        get_model("vgg16")                       # no GPU here
    with pytest.raises(RuntimeError, match="device='cpu'"):
        get_model("transformer_lm")              # ported: the GPU default
    with pytest.raises(ValueError):
        get_model("nonesuch", device="cpu")
    spec = get_model("vgg16", device="cpu", cfg=NARROW, seed=3)
    again = get_model("vgg16", device="cpu", cfg=NARROW, seed=3)
    assert torch.equal(spec.module.flat, again.module.flat)   # seeded
    assert spec.module.flat.device.type == "cpu"


def test_dropout_mask_is_seeded():
    """Dropout (config 2 keeps 0.5) draws from the model's own generator,
    seeded from ``seed``: the same seed repeats a train-mode forward, step
    after step, and another seed draws other masks. Kept entries are scaled
    by 1 / (1 - rate), as flax's ``Dropout`` does."""
    x = torch.from_numpy(np.random.default_rng(0).normal(
        size=(4, 32, 32, 3)).astype(np.float32))

    def outs(seed):
        m = get_model("vgg16", device="cpu", cfg=NARROW, seed=seed,
                      dropout=0.5).module
        return [m(x, train=True).detach() for _ in range(2)]

    a, b, c = outs(7), outs(7), outs(8)
    assert all(torch.equal(u, v) for u, v in zip(a, b))
    assert not torch.equal(a[0], a[1])          # a fresh mask each step
    assert not torch.equal(a[0], c[0])
    m = VGG16(cfg=NARROW, dropout=0.5)
    m.reset_parameters(torch.Generator().manual_seed(0))
    h = torch.rand(64, 512) + 1.0
    out = m._dropout(h)
    kept = out != 0
    assert 0.3 < kept.float().mean() < 0.7
    torch.testing.assert_close(out[kept], 2.0 * h[kept], rtol=0, atol=0)
    with pytest.raises(RuntimeError, match="reset_parameters"):
        VGG16(cfg=NARROW, dropout=0.5)._dropout(h)
