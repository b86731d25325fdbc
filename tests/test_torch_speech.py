"""Parity of the port's ``lstman4`` (``models/speech.py``: the conv front
end, BatchNorm over NCHW and channels-last tensors, ``hard_tanh``, flax's
``OptimizedLSTMCell`` in both directions), the CTC loss, greedy decode and
character error counts (``training/losses.py``) and the trainer on the
``an4`` task with the reference's flax ``LSTMAN4``, ``optax.ctc_loss`` and
``build_dp_train_step``.

The reference's weights go through numpy into the port. Tolerances, f32:
logits within rtol 1e-5 / atol 1e-6; the updated BatchNorm statistics
within 1e-6; the flat gradient within 1e-5 relative L2; the CTC loss of
each sequence within rtol 1e-5 / atol 1e-6 and its gradient within 1e-5
relative L2 (the two sum over alignments in their own order); greedy
decodes and edit counts equal as integers; losses over a trainer run
within rtol 1e-5, with the selection of every sparse step held bit for
bit against the reference's compressor on the port's own accumulator.
bf16, against the reference compiled with every bf16 op rounded: narrow
eval logits within rtol 1e-5 / atol 1e-6, the other logits and the
gradient by relative L2 at half the reference's own bf16-vs-f32 gap, the
statistics within 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.flatten_util import ravel_pytree

from gaussiank_sgd_tpu.compressors.registry import get_compressor as jcomp
from gaussiank_sgd_tpu.models import get_model as jget_model
from gaussiank_sgd_tpu.parallel.bucketing import plan_for_params as jplan
from gaussiank_sgd_tpu.parallel.flat_opt import FlatSGDM as JFlatSGDM
from gaussiank_sgd_tpu.parallel.mesh import data_parallel_mesh, shard_batch
from gaussiank_sgd_tpu.parallel.trainstep import build_dp_train_step
from gaussiank_sgd_tpu.training.losses import \
    char_error_counts as jchar_error_counts
from gaussiank_sgd_tpu.training.losses import \
    ctc_greedy_decode as jctc_greedy_decode
from gaussiank_sgd_tpu.training.losses import make_eval_fn as jmake_eval
from gaussiank_sgd_tpu.training.losses import make_loss_fn as jmake_loss
from gaussiank_sgd_tpu.training.lr_schedule import \
    warmup_milestone_schedule as jschedule
from gaussiank_sgd_torch import convert
from gaussiank_sgd_torch.compressors import decompress
from gaussiank_sgd_torch.models import get_model
from gaussiank_sgd_torch.models.flat import hard_tanh, sigmoid
from gaussiank_sgd_torch.models.speech import LSTMAN4
from gaussiank_sgd_torch.training.config import TrainConfig
from gaussiank_sgd_torch.training.losses import (char_error_counts,
                                                 ctc_greedy_decode, ctc_loss,
                                                 make_eval_fn, make_loss_fn)
from gaussiank_sgd_torch.training.trainer import Trainer

TOL = dict(rtol=1e-5, atol=1e-6)
NARROW = dict(hidden=16, num_layers=2)
FREQ, TIME = 41, 32


def _paths(tree):
    return [("/".join(k.key for k in path), tuple(leaf.shape))
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]]


def _rel(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _flax(seed, kw=NARROW, freq=FREQ, time=TIME):
    """The reference's weights with BatchNorm scales, biases and running
    statistics away from their init."""
    spec = jget_model("lstman4", dtype=jnp.float32, **kw)
    v = spec.module.init({"params": jax.random.PRNGKey(seed)},
                         jnp.zeros((2, freq, time)), train=False)
    rng = np.random.default_rng(seed)
    params = jax.tree.map(np.array, v["params"])
    stats = jax.tree.map(np.array, v["batch_stats"])
    for i in range(2):
        bn = params[f"BatchNorm_{i}"]
        bn["scale"] = (1 + 0.1 * rng.normal(size=32)).astype(np.float32)
        bn["bias"] = (0.1 * rng.normal(size=32)).astype(np.float32)
        st = stats[f"BatchNorm_{i}"]
        st["mean"] = (0.1 * rng.normal(size=32)).astype(np.float32)
        st["var"] = rng.uniform(0.5, 2.0, 32).astype(np.float32)
    return spec, params, stats


def _port(params, stats, kw=NARROW, freq=FREQ, dtype=torch.float32):
    m = get_model("lstman4", device="cpu", freq=freq, dtype=dtype,
                  **kw).module
    convert.load_flax_variables(m, params, stats)
    return m


def _labels(rng, batch, slots, short=()):
    """Labels in [1, 29) with repeats; rows in ``short`` end in padding."""
    y = rng.integers(1, 29, size=(batch, slots)).astype(np.int32)
    y[:, 1] = y[:, 0]                                     # a repeat a row
    for i in short:
        if i < batch:
            y[i, slots // 2 + i:] = 0
    return y


def _inputs(seed, batch=4, freq=FREQ, time=TIME, slots=6):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(batch, freq, time)).astype(np.float32),
            _labels(rng, batch, slots, short=(1, 2)))


def test_layout_is_flax_ravel_order():
    """Path for path and shape for shape, at full width (16,138,045
    parameters, 128 statistics) and at a narrow one: the top level sorts
    BatchNorm_0, BatchNorm_1, Conv_0, Conv_1, Dense_0, bilstm_0, ...; a
    cell's leaves sort hf, hg, hi, ho, if, ig, ii, io."""
    for kw, freq, n in ((dict(), 161, 16_138_045), (NARROW, FREQ, None)):
        spec = jget_model("lstman4", **kw)
        v = jax.eval_shape(lambda: spec.module.init(
            {"params": jax.random.PRNGKey(0)}, jnp.zeros((2, freq, 200)),
            train=False))
        m = LSTMAN4(freq=freq, device=torch.device("meta"), **kw)
        assert m.param_layout == _paths(v["params"])
        assert m.stats_layout == _paths(v["batch_stats"])
        if n is not None:
            assert (m.n_params, m.stats.numel()) == (n, 128)
    order = [p for p, _ in m.param_layout]
    assert [p.split("/")[0] for p in order[:10:2]] == [
        "BatchNorm_0", "BatchNorm_1", "Conv_0", "Conv_1", "Dense_0"]
    cell = "bilstm_0/OptimizedLSTMCell_0/"
    assert [p[len(cell):] for p in order if p.startswith(cell)] == [
        "hf/bias", "hf/kernel", "hg/bias", "hg/kernel", "hi/bias",
        "hi/kernel", "ho/bias", "ho/kernel", "if/kernel", "ig/kernel",
        "ii/kernel", "io/kernel"]


def test_init_families():
    """Hidden kernels orthogonal ``[H, H]``, input and conv kernels
    lecun-normal, biases zero, BatchNorm scales one."""
    m = get_model("lstman4", device="cpu", hidden=32, num_layers=1,
                  freq=FREQ, seed=2).module
    leaves = m.leaves()
    cell = "bilstm_0/OptimizedLSTMCell_1"
    for g in "ifgo":
        w = leaves[f"{cell}/h{g}/kernel"].detach()
        torch.testing.assert_close(w.T @ w, torch.eye(32), atol=1e-5, rtol=0)
        assert not leaves[f"{cell}/h{g}/bias"].any()
    wi = leaves[f"{cell}/ii/kernel"].detach().numpy()
    assert abs(wi.std() * np.sqrt(wi.shape[0]) - 1.0) < 0.05
    assert bool((leaves["BatchNorm_1/scale"] == 1).all())
    assert not leaves["Conv_0/bias"].any()


def test_forward_direction_is_the_first_cell():
    """With ``OptimizedLSTMCell_1`` zeroed (its h stays 0) a BiLSTM layer
    is its forward pass alone: in the reference, the first frames' logits
    (outside the convs' reach of the last input frame: T' frames 8 on of
    16) do not move when the last frame changes, so
    ``OptimizedLSTMCell_0`` runs forward; the port agrees on those
    weights."""
    spec, params, stats = _flax(3, dict(hidden=16, num_layers=1))
    for leaf in params["bilstm_0"]["OptimizedLSTMCell_1"].values():
        for k in leaf:
            leaf[k] = np.zeros_like(leaf[k])
    x, _ = _inputs(4)
    x2 = x.copy()
    x2[:, :, -1] += 5.0

    def flax_logits(xx):
        return np.asarray(spec.module.apply(
            {"params": params, "batch_stats": stats}, jnp.asarray(xx),
            train=False))

    a, b = flax_logits(x), flax_logits(x2)
    np.testing.assert_array_equal(a[:, :8], b[:, :8])
    assert not np.array_equal(a[:, -1], b[:, -1])
    m = _port(params, stats, dict(hidden=16, num_layers=1))
    got = m(torch.from_numpy(x), train=False).detach().numpy()
    np.testing.assert_allclose(got, a, **TOL)


@pytest.mark.parametrize("kw,freq,time", [
    (dict(hidden=32, num_layers=1), 161, 200),
    (NARROW, FREQ, 24)])
def test_logits_and_batch_stats_match_flax(kw, freq, time):
    """Train-mode logits and the updated running statistics, and eval-mode
    logits, at the full front end (161 x 200: ``"SAME"`` pads time (4, 5)
    on the first conv) and at a narrow input. T' = ceil(T / 2)."""
    spec, params, stats = _flax(5, kw, freq, time)
    x, _ = _inputs(6, 2, freq, time)
    jlogits, upd = spec.module.apply(
        {"params": params, "batch_stats": stats}, jnp.asarray(x),
        train=True, mutable=["batch_stats"])
    jeval = spec.module.apply({"params": params, "batch_stats": stats},
                              jnp.asarray(x), train=False)
    m = _port(params, stats, kw, freq)
    logits = m(torch.from_numpy(x), train=True)
    assert logits.dtype == torch.float32
    assert tuple(logits.shape) == (2, -(-time // 2), 29)
    np.testing.assert_allclose(logits.detach().numpy(), jlogits, **TOL)
    np.testing.assert_allclose(
        m.stats.numpy(), convert.flatten_tree(
            jax.tree.map(np.asarray, upd["batch_stats"]), m.stats_layout),
        rtol=1e-6, atol=1e-6)
    m = _port(params, stats, kw, freq)
    np.testing.assert_allclose(
        m(torch.from_numpy(x), train=False).detach().numpy(), jeval, **TOL)


def test_gradient_matches_flax():
    """The ``ctc`` train loss (the batch mean of each sequence's CTC loss)
    and its flat gradient in the reference's ravel order."""
    spec, params, stats = _flax(7)
    x, y = _inputs(8)
    jloss, (_, jaux) = jmake_loss(spec)(
        params, {"batch_stats": stats}, (jnp.asarray(x), jnp.asarray(y)),
        jax.random.PRNGKey(0))
    jgrad = jax.grad(lambda p: jmake_loss(spec)(
        p, {"batch_stats": stats}, (jnp.asarray(x), jnp.asarray(y)),
        jax.random.PRNGKey(0))[0])(params)
    m = _port(params, stats)
    loss, aux = make_loss_fn(m, "ctc")((torch.from_numpy(x),
                                        torch.from_numpy(y)))
    (g,) = torch.autograd.grad(loss, m.flat)
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    np.testing.assert_allclose(float(aux["ctc"]), float(jaux["ctc"]),
                               rtol=1e-5)
    assert _rel(g.numpy(), np.asarray(ravel_pytree(jgrad)[0])) < 1e-5


def _cell_biases(params, seed):
    """``params`` with every cell's bias drawn away from its zero init, so
    that the order of the bias add shows."""
    rng = np.random.default_rng(seed)
    for name, layer in params.items():
        if name.startswith("bilstm"):
            for cell in layer.values():
                for g in "ifgo":
                    b = cell[f"h{g}"]["bias"]
                    cell[f"h{g}"]["bias"] = (0.3 * rng.normal(size=b.shape)
                                             ).astype(np.float32)
    return params


# the reference compiled with every bf16 op rounded, as the port's eager ops
# round: by default XLA keeps some bf16 intermediates of the fused scan body
# in f32 ("excess precision"), which no op-by-op port reproduces
_ROUNDED = {"xla_allow_excess_precision": False}


@pytest.mark.parametrize("kw,freq,time", [
    (dict(hidden=32, num_layers=1), 161, 200),
    (NARROW, FREQ, 24)])
def test_bf16_logits_and_batch_stats_match_flax(kw, freq, time):
    """bf16 compute (the CLI's default dtype) against the reference's bf16
    model on the same weights (cell biases away from zero), compiled as
    ``_ROUNDED`` says: the convs
    and their biases, the cells' products and gate arithmetic in bf16 (the
    sigmoid as ``1 / (1 + exp(-x))`` op by op, the gates as ``(h Wh + b) +
    x Wi``), the carry, BatchNorm and Dense_0 in f32. Eval logits at the
    narrow input agree within rtol 1e-5 / atol 1e-6, as each op rounds
    alike (``torch.sigmoid`` or a fused ``baddbmm`` lands near 1e-2).
    Elsewhere a conv's or a batch mean's f32 sum in another order now and
    then flips a bf16 rounding, which the recurrence carries: logits are
    held by relative L2 at half the reference's own bf16-vs-f32 gap, as
    the VGG bf16 test holds them, and the running statistics within 1e-5.
    """
    _, params, stats = _flax(5, kw, freq, time)
    params = _cell_biases(params, 5)
    x, _ = _inputs(6, 2, freq, time)
    variables = {"params": params, "batch_stats": stats}

    def flax_run(dtype):
        spec = jget_model("lstman4", dtype=dtype, **kw)
        train = jax.jit(lambda v, xx: spec.module.apply(
            v, xx, train=True, mutable=["batch_stats"]),
            compiler_options=_ROUNDED)
        evals = jax.jit(lambda v, xx: spec.module.apply(v, xx, train=False),
                        compiler_options=_ROUNDED)
        logits, upd = train(variables, jnp.asarray(x))
        return (np.asarray(logits), upd["batch_stats"],
                np.asarray(evals(variables, jnp.asarray(x))))

    jlogits, jstats, jeval = flax_run(jnp.bfloat16)
    jlogits32, _, jeval32 = flax_run(jnp.float32)
    m = _port(params, stats, kw, freq, torch.bfloat16)
    logits = m(torch.from_numpy(x), train=True)
    assert logits.dtype == torch.float32
    np.testing.assert_allclose(
        m.stats.numpy(), convert.flatten_tree(
            jax.tree.map(np.asarray, jstats), m.stats_layout),
        rtol=0, atol=1e-5)
    m = _port(params, stats, kw, freq, torch.bfloat16)
    teval = m(torch.from_numpy(x), train=False).detach().numpy()
    logits = logits.detach().numpy()
    assert _rel(logits, jlogits) < 0.5 * _rel(jlogits, jlogits32)
    assert _rel(teval, jeval) < 0.5 * _rel(jeval, jeval32)
    if freq == FREQ:
        np.testing.assert_allclose(teval, jeval, **TOL)


def test_bf16_gradient_matches_flax():
    """The ``ctc`` loss and its flat gradient in bf16 against the
    reference's, compiled as ``_ROUNDED`` says: the loss within rtol 1e-4,
    the gradient by relative L2 at half the reference's own bf16-vs-f32
    gap (the backward runs the cells in bf16 too, and carries the flips of
    the forward)."""
    _, params, stats = _flax(7)
    params = _cell_biases(params, 7)
    x, y = _inputs(8)

    def flax_run(dtype):
        spec = jget_model("lstman4", dtype=dtype, **NARROW)
        return jax.jit(jax.value_and_grad(lambda p: jmake_loss(spec)(
            p, {"batch_stats": stats}, (jnp.asarray(x), jnp.asarray(y)),
            jax.random.PRNGKey(0))[0]), compiler_options=_ROUNDED)(params)

    jloss, jgrad = flax_run(jnp.bfloat16)
    _, jgrad32 = flax_run(jnp.float32)
    jgrad = np.asarray(ravel_pytree(jgrad)[0])
    jgrad32 = np.asarray(ravel_pytree(jgrad32)[0])
    m = _port(params, stats, dtype=torch.bfloat16)
    loss, _ = make_loss_fn(m, "ctc")((torch.from_numpy(x),
                                      torch.from_numpy(y)))
    (g,) = torch.autograd.grad(loss, m.flat)
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-4)
    assert _rel(g[:m.n_params].numpy(), jgrad) < 0.5 * _rel(jgrad, jgrad32)


def test_sigmoid_is_the_references_logistic():
    """``flat.sigmoid`` equals ``jax.nn.sigmoid`` in value and gradient
    (``g * (s * (1 - s))`` from the rounded value), bit for bit in bf16;
    in f32, where the two libraries' ``exp`` differ in the last place, the
    value within rtol 1e-6 and the gradient within atol 1e-6 (``1 - s``
    cancels near s = 1); finite where ``exp(-x)`` overflows; ``torch.sigmoid``
    differs on about a third of bf16 inputs."""
    x = np.concatenate([np.random.default_rng(0).normal(size=4096) * 4,
                        [-200.0, -90.0, 0.0, 90.0, 200.0]]).astype(np.float32)
    for tdt, jdt, tol in ((torch.bfloat16, jnp.bfloat16, 0.0),
                          (torch.float32, jnp.float32, 1e-6)):
        t = torch.from_numpy(x).to(tdt).requires_grad_()
        jx = jnp.asarray(x).astype(jdt)
        cot = np.random.default_rng(1).normal(size=x.size).astype(np.float32)
        y = sigmoid(t)
        (g,) = torch.autograd.grad(y, t, torch.from_numpy(cot).to(tdt))
        jy, vjp = jax.vjp(jax.nn.sigmoid, jx)
        (jg,) = vjp(jnp.asarray(cot).astype(jdt))
        np.testing.assert_allclose(
            y.detach().float().numpy(), np.asarray(jy.astype(jnp.float32)),
            rtol=tol, atol=0)
        np.testing.assert_allclose(
            g.float().numpy(), np.asarray(jg.astype(jnp.float32)),
            rtol=0, atol=tol)
        assert np.isfinite(g.float().numpy()).all()
    once = torch.sigmoid(t.detach().to(torch.bfloat16)).float().numpy()
    ours = sigmoid(t.detach().to(torch.bfloat16)).float().numpy()
    assert 0.2 < np.mean(once != ours) < 0.5


def test_hard_tanh_is_the_references_where_form():
    """Values and gradients equal to ``jax.nn.hard_tanh``'s, the gradient
    1 at exactly +-1 (``F.hardtanh``'s is 0 there)."""
    x = np.array([-2.0, -1.0, -0.5, 0.0, 0.5, 1.0, 2.0], np.float32)
    t = torch.from_numpy(x).requires_grad_()
    y = hard_tanh(t)
    (g,) = torch.autograd.grad(y.sum(), t)
    jg = jax.grad(lambda v: jax.nn.hard_tanh(v).sum())(jnp.asarray(x))
    np.testing.assert_array_equal(y.detach().numpy(),
                                  np.asarray(jax.nn.hard_tanh(x)))
    np.testing.assert_array_equal(g.numpy(), np.asarray(jg))
    assert g[1] == g[5] == 1.0


@pytest.mark.parametrize("seed", [0, 1])
def test_ctc_loss_and_gradient_match_optax(seed):
    """Each sequence's loss against ``optax.ctc_loss`` (no logit padding,
    ``labels == 0`` as label padding) and the gradient of their mean with
    respect to the logits against ``jax.grad``, with repeated labels and
    rows that end in padding. The gradient is held by relative L2: optax's
    f32 gradient is 2.5e-6 and 5.2e-6 from an f64 evaluation here (0.8e-6
    and 2.0e-6 at most an element, up to 1.9e-5 relative on elements above
    1e-3); the port's, computed in f64, is rounded once."""
    rng = np.random.default_rng(seed)
    logits = (2.0 * rng.normal(size=(5, 20, 29))).astype(np.float32)
    y = _labels(rng, 5, 7, short=(0, 3))
    y[4, 2:4] = y[4, 1]                       # a run of three

    def jper(lg):
        return optax.ctc_loss(lg, jnp.zeros(lg.shape[:2]), jnp.asarray(y),
                              (jnp.asarray(y) == 0).astype(jnp.float32))

    jl = np.asarray(jper(jnp.asarray(logits)))
    jg = np.asarray(jax.grad(lambda lg: jper(lg).mean())(
        jnp.asarray(logits)))
    t = torch.from_numpy(logits).requires_grad_()
    per = ctc_loss(t, torch.from_numpy(y))
    (g,) = torch.autograd.grad(per.mean(), t)
    np.testing.assert_allclose(per.detach().numpy(), jl, **TOL)
    assert _rel(g.numpy(), jg) < 1e-5


def _levenshtein(a, b):
    d = list(range(len(b) + 1))
    for i, ca in enumerate(a, 1):
        prev, d[0] = d[0], i
        for j, cb in enumerate(b, 1):
            prev, d[j] = d[j], min(d[j] + 1, d[j - 1] + 1,
                                   prev + (ca != cb))
    return d[-1]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_greedy_decode_and_char_errors_are_exact(seed):
    """``ctc_greedy_decode`` equal to the reference's; the edit and
    reference-character sums equal to the reference's and to a Levenshtein
    oracle on the decoded strings, as integers. Few labels and peaked
    logits make blanks, repeats and empty decodes common."""
    rng = np.random.default_rng(seed)
    logits = (4.0 * rng.normal(size=(6, 15, 5))).astype(np.float32)
    logits[:, :, 0] += 2.0                        # many blanks
    logits[0, :, 0] += 50.0                       # an empty decode
    y = rng.integers(1, 5, size=(6, 9)).astype(np.int32)
    y[2:, 6:] = 0
    y[5, 1:] = 0
    ids, mask = ctc_greedy_decode(torch.from_numpy(logits))
    jids, jmask = jctc_greedy_decode(jnp.asarray(logits))
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
    np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask))
    edits, refs = char_error_counts(torch.from_numpy(logits),
                                    torch.from_numpy(y))
    jedits, jrefs = jchar_error_counts(jnp.asarray(logits), jnp.asarray(y))
    want = sum(_levenshtein(list(ids[i][mask[i]].numpy()),
                            list(y[i][y[i] != 0])) for i in range(6))
    assert float(edits) == float(jedits) == want > 0
    assert float(refs) == float(jrefs) == float((y != 0).sum())
    assert edits.dtype == refs.dtype == torch.float32


def test_ctc_eval_sums_match_reference():
    """The ``ctc`` eval sums on the reference's weights: loss_sum within
    rtol 1e-5, the CER sums and n equal; eval mode keeps the statistics."""
    spec, params, stats = _flax(9)
    x, y = _inputs(10, 6)
    want = jmake_eval(spec)(params, {"batch_stats": stats},
                            (jnp.asarray(x), jnp.asarray(y)))
    m = _port(params, stats)
    before = m.stats.clone()
    got = make_eval_fn(m, "ctc")((torch.from_numpy(x), torch.from_numpy(y)))
    assert set(got) == set(want) == {"loss_sum", "cer_edit_sum",
                                     "cer_ref_sum", "n"}
    np.testing.assert_allclose(float(got["loss_sum"]),
                               float(want["loss_sum"]), rtol=1e-5)
    for key in ("cer_edit_sum", "cer_ref_sum", "n"):
        assert float(got[key]) == float(want[key]), key
    assert torch.equal(m.stats, before)


def _cfg(tmp_path, **kw):
    return TrainConfig(
        dnn="lstman4", dataset="an4", batch_size=8,
        compressor="gaussian_fused", density=0.01, compress_warmup_steps=2,
        max_steps=4, lr=0.05, compute_dtype="float32", device="cpu",
        model_kwargs={**NARROW, "freq": FREQ}, dataset_kwargs={
            "freq": FREQ, "time": TIME, "synthetic_examples": 64},
        eval_max_batches=2, output_dir=str(tmp_path), **kw)


def test_label_count_comes_from_the_dataset(tmp_path):
    """``get_model("lstman4", num_classes=n)`` has n labels, as the
    trainer builds it from the dataset's cardinality (here a synthetic AN4
    of 9 labels); ``num_labels`` wins over ``num_classes``."""
    assert get_model("lstman4", num_classes=9, device="cpu",
                     **NARROW).num_classes == 9
    assert get_model("lstman4", num_classes=9, num_labels=7, device="cpu",
                     **NARROW).module.num_labels == 7
    cfg = _cfg(tmp_path)
    cfg.dataset_kwargs["num_labels"] = 9
    t = Trainer(cfg)
    assert t.spec.num_classes == t.model.num_labels == 9
    assert dict(t.model.param_layout)["Dense_0/kernel"] == (16, 9)


def test_trainer_run_matches_reference(tmp_path):
    """``Trainer`` on ``lstman4`` / ``an4`` (synthetic spectrograms, a
    narrow model, f32, ``gaussian_fused`` at density 0.01) for 2 dense + 2
    sparse steps against the reference's train step from the trainer's
    initial weights on the trainer's batches, with its schedule and flat
    optimizer: losses within rtol 1e-5. Each sparse step's selection is
    held bit for bit against the reference's compressor on the port's own
    EF row, gradient and threshold, and the EF bookkeeping exact. Then the
    eval pass: its ``cer`` from the sums, and the sums against the
    reference's eval on the trained weights."""
    t = Trainer(_cfg(tmp_path))
    assert t.spec.task == "ctc" and t.spec.num_classes == 29
    params, stats = convert.export_flax_variables(t.model)
    ts, density = t.ts, t.cfg.density
    jspec = jcomp("gaussian_fused", density=density)
    batches, checked = [], []
    steps = {"dense": ts.dense_step, "sparse": ts.sparse_step}

    def recorded(kind):
        def step(state, batch):
            batches.append(tuple(b.numpy().copy() for b in batch))
            if kind == "sparse":
                g = ts.local_grads(state, batch)
                state.model_state["stats"].copy_(
                    g.model_state_before["stats"])
                comp, residual, nsel, _ = ts.compress_phase(state, g.flat_g)
                acc = state.ef_residual + g.flat_g
                assert torch.equal(decompress(comp, ts.ef_numel) + residual,
                                   acc)
                rows = (ts.fused_ef[0], ts.fused_ef[2])
                jr, _ = jspec.fused_ef_fn(
                    jnp.asarray(state.ef_residual.view(rows).numpy()),
                    jnp.asarray(g.flat_g.view(rows).numpy()),
                    jnp.float32(1.0), t.plan.buckets[0].k,
                    jnp.asarray(state.comp_state[0].numpy()))
                for got, want in ((comp.indices, jr.compressed.indices),
                                  (comp.values, jr.compressed.values),
                                  (residual, jr.residual),
                                  (nsel, jr.num_selected)):
                    want = np.asarray(want).reshape(got.shape)
                    if want.dtype == np.float32:
                        got, want = got.view(torch.int32), want.view(np.int32)
                    np.testing.assert_array_equal(got.numpy(), want)
                checked.append(int(nsel))
            return steps[kind](state, batch)
        return step

    ts.dense_step, ts.sparse_step = recorded("dense"), recorded("sparse")
    t.train(4)
    recs = t.records
    assert [r["kind"] for r in recs] == ["dense"] * 2 + ["sparse"] * 2
    assert len(checked) == 2 and checked[0] == t.plan.buckets[0].k
    assert all(r["ctc"] == r["loss"] for r in recs)

    spec = jget_model("lstman4", dtype=jnp.float32, **NARROW)
    mesh = data_parallel_mesh(1)
    cfg = t.cfg
    sched = jschedule(cfg.lr, cfg.nworkers, t.steps_per_epoch,
                      t.total_steps, cfg.warmup_epochs, cfg.lr_milestones,
                      cfg.lr_decay)
    jts = build_dp_train_step(
        jmake_loss(spec), None, jspec, jplan(params, density), mesh,
        flat_opt=JFlatSGDM(lr=sched, momentum=cfg.momentum,
                           weight_decay=cfg.weight_decay), wire="off")
    jstate = jts.init_state(
        jax.tree.map(jnp.asarray, params), jax.random.PRNGKey(1),
        model_state={"batch_stats": jax.tree.map(jnp.asarray, stats)})
    for rec, batch in zip(recs, batches):
        fn = jts.dense_step if rec["kind"] == "dense" else jts.sparse_step
        jstate, jm = fn(jstate, shard_batch(mesh, batch))
        np.testing.assert_allclose(rec["loss"], float(jm.loss), rtol=1e-5)

    out = t.test()
    assert set(out) == {"val_loss", "cer"} and 0.0 <= out["cer"]
    params, stats = convert.export_flax_variables(t.model)
    jeval = jmake_eval(spec)
    totals = dict.fromkeys(("loss_sum", "cer_edit_sum", "cer_ref_sum", "n"),
                           0.0)
    for i, (x, y) in enumerate(t.test_ds.epoch()):
        if i == 2:
            break
        sums = jeval(params, {"batch_stats": stats},
                     (jnp.asarray(x), jnp.asarray(y)))
        for k in totals:
            totals[k] += float(sums[k])
    np.testing.assert_allclose(out["val_loss"],
                               totals["loss_sum"] / totals["n"], rtol=1e-5)
    assert out["cer"] == totals["cer_edit_sum"] / totals["cer_ref_sum"]
