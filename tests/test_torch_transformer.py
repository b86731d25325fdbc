"""Parity of the port's Transformer (``models/transformer.py``) and the
seq2seq loss and eval (``training/losses.py``) with the reference's flax
``Transformer`` and ``make_loss_fn(spec, label_smoothing)``.

The reference's weights go through numpy into the port, at a small width
(vocabulary 64, width 32, 4 heads, 2 + 2 layers, ffn 48, dropout off:
the two packages' dropout draws cannot match), on batches whose sources
and targets end in pads. In f32 the logits agree at rtol 1e-4 / atol 1e-5,
the label-smoothed loss at rtol 1e-5, the eval sums at rtol 1e-5 (the
token counts exactly) and the gradient at 1e-4 relative L2 (the MLP's ReLU
gates; both packages sum matmuls in their own order). At bf16 both round
at every layer in their own order (XLA may keep an f32 intermediate where
the port rounds), so the bf16 logits are held by relative L2 against
flax's own bf16-vs-f32 gap, which a missing or extra cast would reach.

Query position 0 of the decoder is a pad on every step (the decoder input
is the target shifted right behind id 0), so its self- and
cross-attention rows are fully masked: flax gives them uniform weights
over every key, future ones included, and so does the port (ROADMAP C).
"""

import jax
import jax.numpy as jnp
import flax.linen as nn
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

from gaussiank_sgd_tpu.models import get_model as jget_model
from gaussiank_sgd_tpu.training.losses import make_eval_fn as jmake_eval
from gaussiank_sgd_tpu.training.losses import make_loss_fn as jmake_loss
from gaussiank_sgd_torch import convert
from gaussiank_sgd_torch.models import get_model
from gaussiank_sgd_torch.models.transformer import (Transformer, mlp,
                                                    sinusoidal_positions)
from gaussiank_sgd_torch.training.losses import (decoder_input, make_eval_fn,
                                                 make_loss_fn)

V = 64
KW = dict(dim=32, heads=4, enc_layers=2, dec_layers=2, ffn=48, dropout=0.0,
          max_len=64)
TOL = dict(rtol=1e-4, atol=1e-5)


def _paths(tree):
    return [("/".join(k.key for k in path), tuple(leaf.shape))
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]]


def _flax(seed=0, dtype=jnp.float32):
    spec = jget_model("transformer", vocab_size=V, dtype=dtype, **KW)
    x = jnp.ones((2, 8), jnp.int32)
    v = spec.module.init({"params": jax.random.PRNGKey(seed)}, x, x,
                         train=False)
    return spec, jax.tree.map(np.asarray, v["params"])


def _port(params, dtype=torch.float32):
    m = get_model("transformer", vocab_size=V, dtype=dtype, device="cpu",
                  **KW).module
    convert.load_flax_variables(m, params)
    return m


def _batch(seed, b=3, s=12, t=10):
    """Pairs whose sources and targets end in pads (id 0)."""
    rng = np.random.default_rng(seed)
    src = rng.integers(1, V, size=(b, s)).astype(np.int32)
    tgt = rng.integers(1, V, size=(b, t)).astype(np.int32)
    for i in range(b):
        src[i, s - 2 * i:] = 0
        tgt[i, t - 3 * i:] = 0
    return src, tgt


def _rel(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def test_layout_is_flax_ravel_order():
    """Transformer-base at full width (60,524,544 parameters) path for path
    and shape for shape, flax's 3-D attention kernels included; the
    sinusoidal table is a buffer, not a parameter."""
    spec = jget_model("transformer")
    x = jnp.ones((2, 64), jnp.int32)
    v = jax.eval_shape(lambda: spec.module.init(
        {"params": jax.random.PRNGKey(0)}, x, x, train=False))
    m = Transformer(device=torch.device("meta"))
    assert m.param_layout == _paths(v["params"])
    assert m.n_params == 60_524_544
    shapes = dict(m.param_layout)
    att = "dec_3/MultiHeadDotProductAttention_1"
    assert shapes[f"{att}/query/kernel"] == (512, 8, 64)
    assert shapes[f"{att}/query/bias"] == (8, 64)
    assert shapes[f"{att}/out/kernel"] == (8, 64, 512)
    assert shapes["shared_embed/embedding"] == (32_000, 512)
    assert [p for p, _ in m.param_layout][:3] == [
        "LayerNorm_0/bias", "LayerNorm_0/scale", "LayerNorm_1/bias"]
    np.testing.assert_array_equal(m.positions.shape, (512, 512))
    small = Transformer(vocab_size=V, device=torch.device("meta"),
                        **{k: x for k, x in KW.items()})
    assert small.param_layout == _paths(_flax()[1])


def test_init_fan_in_of_attention_kernels():
    """flax's DenseGeneral draws a ``[D, heads, hd]`` kernel with fan-in D
    and an ``[heads, hd, D]`` one with fan-in heads x hd; the shared
    embedding from N(0, 1/D)."""
    m = get_model("transformer", vocab_size=500, dim=128, heads=4,
                  enc_layers=1, dec_layers=1, ffn=64, device="cpu").module
    leaves = m.leaves()
    for name in ("query", "out"):
        w = leaves[f"enc_0/MultiHeadDotProductAttention_0/{name}/kernel"]
        assert abs(float(w.std()) * np.sqrt(128) - 1.0) < 0.05, name
    emb = leaves["shared_embed/embedding"]
    assert abs(float(emb.std()) * np.sqrt(128) - 1.0) < 0.03
    assert bool((leaves["LayerNorm_1/scale"] == 1).all())


def test_positions_are_the_reference_table():
    from gaussiank_sgd_tpu.models.transformer import \
        sinusoidal_positions as jpos
    np.testing.assert_array_equal(sinusoidal_positions(70, 32),
                                  jpos(70, 32))


@pytest.mark.parametrize("train", [False, True])
def test_f32_logits_match_flax(train):
    spec, params = _flax(1)
    src, tgt = _batch(2)
    dec = np.asarray(jnp.pad(tgt[:, :-1], ((0, 0), (1, 0))))
    np.testing.assert_array_equal(decoder_input(torch.from_numpy(tgt)),
                                  dec)
    want = spec.module.apply({"params": params}, jnp.asarray(src),
                             jnp.asarray(dec), train=False)
    m = _port(params)
    got = m(torch.from_numpy(src), torch.from_numpy(dec), train=train)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.detach().numpy(), want, **TOL)


def test_bf16_logits_cast_like_flax():
    """Config 5's dtype flow at bf16: the embedding, attention and MLP
    outputs and the residual stream in bf16, every LayerNorm's output in
    f32, and bf16 logits (the tied projection casts the f32 decoder output
    and the table to bf16). The values are held by relative L2: the port's
    bf16 logits no farther from flax's bf16 logits than those are from
    flax's f32 ones (measured 0.0063 against 0.0072: both packages round
    at bf16 in their own places), and elementwise within 0.05."""
    spec16, params = _flax(3, jnp.bfloat16)
    spec32, _ = _flax(3)
    src, tgt = _batch(4)
    dec = np.asarray(decoder_input(torch.from_numpy(tgt)))
    args = (jnp.asarray(src), jnp.asarray(dec))
    want = spec16.module.apply({"params": params}, *args, train=False)
    want32 = spec32.module.apply({"params": params}, *args, train=False)
    assert want.dtype == jnp.bfloat16
    m = _port(params, torch.bfloat16)
    with torch.no_grad():
        got = m(torch.from_numpy(src), torch.from_numpy(dec), train=False)
        p = m.leaves()
        x = m._embed(p, torch.from_numpy(src))
        h = m._layer_norm(p, x, "enc_0/LayerNorm_0")
        a = m._attention(p, "enc_0/MultiHeadDotProductAttention_0", h, h,
                         m.masks(torch.from_numpy(src),
                                 torch.from_numpy(dec))[0], False)
        f = mlp(m, p, "enc_0/MLP_0", h, False)
    assert (x.dtype, h.dtype, a.dtype, (x + a).dtype, f.dtype,
            got.dtype) == (torch.bfloat16, torch.float32, torch.bfloat16,
                           torch.bfloat16, torch.bfloat16, torch.bfloat16)
    got = got.float().numpy()
    want = np.asarray(want, np.float32)
    assert 0 < _rel(got, want) < _rel(want, np.asarray(want32))
    np.testing.assert_allclose(got, want, rtol=0, atol=0.05)


def test_fully_masked_first_decoder_row_is_uniform():
    """Position 0 of the decoder input is a pad, so its self-attention row
    and its cross-attention row are fully masked; the softmax over
    ``finfo.min`` everywhere is uniform over every key, as in flax (a
    boolean mask in ``scaled_dot_product_attention`` gives NaN there)."""
    spec, params = _flax(5)
    src, tgt = _batch(6)
    m = _port(params)
    dec = decoder_input(torch.from_numpy(tgt))
    _, dec_mask, cross_mask = m.masks(torch.from_numpy(src), dec)
    assert not dec_mask[:, :, 0].any() and not cross_mask[:, :, 0].any()
    assert dec_mask[:, :, 1].any()
    rng = np.random.default_rng(7)
    xq = rng.normal(size=(3, 10, 32)).astype(np.float32)
    xkv = rng.normal(size=(3, 12, 32)).astype(np.float32)
    name = "dec_1/MultiHeadDotProductAttention_1"
    p = m.leaves()
    got = m._attention(p, name, torch.from_numpy(xq), torch.from_numpy(xkv),
                       cross_mask, train=False).detach().numpy()
    layer = nn.MultiHeadDotProductAttention(num_heads=4, dtype=jnp.float32)
    want = layer.apply({"params": params["dec_1"][
        "MultiHeadDotProductAttention_1"]}, jnp.asarray(xq),
        jnp.asarray(xkv), mask=jnp.asarray(cross_mask.numpy()))
    np.testing.assert_allclose(got, want, **TOL)
    # row 0 is the output projection of the mean value over all 12 keys
    v = (xkv @ p[f"{name}/value/kernel"].detach().numpy().reshape(32, -1)
         + p[f"{name}/value/bias"].detach().numpy().reshape(-1))
    o = v.mean(axis=1) @ p[f"{name}/out/kernel"].detach().numpy().reshape(
        -1, 32) + p[f"{name}/out/bias"].detach().numpy()
    np.testing.assert_allclose(got[:, 0], o, **TOL)


@pytest.mark.parametrize("smoothing", [0.0, 0.1])
def test_seq2seq_loss_and_masked_acc(smoothing):
    """The train loss over the target tokens that are not pad, label
    smoothed as the reference's soft-target cross-entropy, and the masked
    token accuracy; in f32 and in bf16 (config 5)."""
    for dtype, tdtype, rtol in ((jnp.float32, torch.float32, 1e-5),
                                (jnp.bfloat16, torch.bfloat16, 1e-2)):
        spec, params = _flax(8, dtype)
        src, tgt = _batch(9)
        (jl, (_, jaux)) = jmake_loss(spec, label_smoothing=smoothing)(
            params, {}, (jnp.asarray(src), jnp.asarray(tgt)),
            jax.random.PRNGKey(0))
        m = _port(params, tdtype)
        loss, aux = make_loss_fn(m, "seq2seq", label_smoothing=smoothing)(
            (torch.from_numpy(src), torch.from_numpy(tgt)))
        assert loss.dtype == torch.float32
        np.testing.assert_allclose(float(loss.detach()), float(jl),
                                   rtol=rtol)
        assert abs(float(aux["acc"]) - float(jaux["acc"])) <= (
            0 if dtype == jnp.float32 else 2 / (tgt != 0).sum())


def test_seq2seq_eval_sums():
    for dtype, tdtype, rtol in ((jnp.float32, torch.float32, 1e-5),
                                (jnp.bfloat16, torch.bfloat16, 1e-2)):
        spec, params = _flax(10, dtype)
        src, tgt = _batch(11)
        want = jmake_eval(spec)(params, {}, (jnp.asarray(src),
                                             jnp.asarray(tgt)))
        got = make_eval_fn(_port(params, tdtype), "seq2seq")(
            (torch.from_numpy(src), torch.from_numpy(tgt)))
        assert sorted(got) == sorted(want) == ["loss_sum", "n", "top1"]
        assert float(got["n"]) == float(want["n"]) == (tgt != 0).sum()
        np.testing.assert_allclose(float(got["loss_sum"]),
                                   float(want["loss_sum"]), rtol=rtol)
        assert abs(float(got["top1"]) - float(want["top1"])) <= (
            0 if dtype == jnp.float32 else 2)


def test_gradient_matches_flax():
    """The label-smoothed loss's flat gradient in the reference's ravel
    order, f32, by relative L2 (and each leaf within 1e-3). The key biases'
    gradient is zero in exact arithmetic (it shifts a softmax row by a
    constant): both packages leave rounding noise there, held below 1e-6
    of the whole gradient's norm."""
    spec, params = _flax(12)
    src, tgt = _batch(13)
    jloss = jmake_loss(spec, label_smoothing=0.1)
    (_, _), jg = jax.value_and_grad(jloss, has_aux=True)(
        params, {}, (jnp.asarray(src), jnp.asarray(tgt)),
        jax.random.PRNGKey(0))
    jg = np.asarray(ravel_pytree(jg)[0])
    m = _port(params)
    loss, _ = make_loss_fn(m, "seq2seq", label_smoothing=0.1)(
        (torch.from_numpy(src), torch.from_numpy(tgt)))
    (g,) = torch.autograd.grad(loss, m.flat)
    g = g.numpy()
    assert _rel(g, jg) < 1e-4
    off, total = 0, np.linalg.norm(jg)
    for path, shape in m.param_layout:
        n = int(np.prod(shape))
        a, b = g[off:off + n], jg[off:off + n]
        if path.endswith("key/bias"):
            assert max(np.linalg.norm(a), np.linalg.norm(b)) < 1e-6 * total
        else:
            assert _rel(a, b) < 1e-3, path
        off += n


def test_get_model_spec_and_attention_dropout():
    spec = get_model("transformer", vocab_size=V, seq_len=16, device="cpu",
                     **{**KW, "dropout": 0.5})
    assert (spec.task, spec.input_shape, spec.input_dtype,
            spec.num_classes) == ("seq2seq", (16,), torch.int32, V)
    assert spec.module.n_params == spec.module.flat.numel()
    lstm = get_model("lstm", vocab_size=V, device="cpu", embed_dim=8,
                     hidden_dim=8)
    assert (lstm.task, lstm.input_shape, lstm.input_dtype,
            lstm.num_classes) == ("lm", (35,), torch.int32, V)
    # attention dropout draws one [q, k] mask for every row and head
    m = spec.module
    w = torch.ones(3, 4, 5, 6)
    out = m._drop(w, True, shape=(1, 1, 5, 6))
    assert torch.equal(out, out[:1, :1].expand_as(out))
    assert set(out.unique().tolist()) <= {0.0, 2.0}
