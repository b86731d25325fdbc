"""Parity of the port's ``transformer_lm`` (``models/transformer_lm.py``),
its sequence-parallel path and the ``(dp, sp)`` trainer with the
reference's flax ``TransformerLM``, ``dp_sp_mesh`` and ``Trainer``.

The reference's weights go through numpy into the port, at a small width
(vocabulary 64, width 32, 4 heads, 2 layers, ffn 48, dropout off: the two
packages' dropout draws cannot match):
* f32 logits within rtol 1e-5 / atol 1e-5 and the lm loss's gradient
  within 1e-5 relative L2 of flax's;
* bf16 (the CLI's dtype) against the reference jitted with
  ``xla_allow_excess_precision=False`` (each bf16 op rounded, as the
  port's eager ops round; ``tests/test_torch_speech.py``): by relative L2
  at half the reference's own bf16-vs-f32 gap, and the logits' argmax;
* the layout is flax's ``ravel_pytree`` order, 24,035,328 parameters at
  the reference's default width with PTB's 10,000 words.
Sequence parallelism: the model at sp = 2 over gloo (each rank its block
of the sequence, attention a ring) gives the single-process model's
logits and, averaged over the ranks, its gradient; the sp model's initial
weights are the sp-free twin's. A ``(dp = 2, sp = 2)`` trainer of 4 gloo
processes, 2 dense + 2 sparse steps of ``gaussian_warm``, follows the
reference's ``Trainer`` on its ``(2, 2)`` mesh from the same weights: the
losses within rtol 1e-5, and the four ranks' parameters bit for bit equal
after every step. The sp refusals are the reference's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

from gaussiank_sgd_tpu.models import get_model as jget_model
from gaussiank_sgd_tpu.training.config import TrainConfig as JTrainConfig
from gaussiank_sgd_tpu.training.trainer import Trainer as JTrainer
from gaussiank_sgd_torch import convert
from gaussiank_sgd_torch.compressors import get_compressor
from gaussiank_sgd_torch.models import get_model
from gaussiank_sgd_torch.models.transformer_lm import TransformerLM
from gaussiank_sgd_torch.parallel.bucketing import plan_for_params
from gaussiank_sgd_torch.parallel.flat_opt import FlatSGDM, OptaxSGD
from gaussiank_sgd_torch.parallel.mesh import DPMesh
from gaussiank_sgd_torch.parallel.trainstep import DPTrainStep
from gaussiank_sgd_torch.training.config import TrainConfig
from gaussiank_sgd_torch.training.losses import make_loss_fn
from gaussiank_sgd_torch.training.trainer import Trainer
from test_torch_distributed import _spawn

V = 64
KW = dict(dim=32, heads=4, num_layers=2, ffn=48, dropout=0.0, max_len=64)
_ROUNDED = {"xla_allow_excess_precision": False}


def _paths(tree):
    return [("/".join(k.key for k in path), tuple(leaf.shape))
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]]


def _flax(seed=0):
    spec = jget_model("transformer_lm", vocab_size=V, **KW)
    v = spec.module.init({"params": jax.random.PRNGKey(seed)},
                         jnp.zeros((2, 8), jnp.int32), train=False)
    return jax.tree.map(np.asarray, v["params"])


def _port(params, dtype=torch.float32, **kw):
    m = get_model("transformer_lm", vocab_size=V, dtype=dtype, device="cpu",
                  **KW, **kw).module
    convert.load_flax_variables(m, params)
    return m


def _tokens(seed, b=3, t=16):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, V, size=(b, t)).astype(np.int32),
            rng.integers(0, V, size=(b, t)).astype(np.int32))


def _rel(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _jloss(spec, params, x, y, jit_kw=None):
    def loss(p):
        logits = spec.module.apply({"params": p}, x, train=False)
        logp = jax.nn.log_softmax(logits.astype(jnp.float32))
        return -jnp.mean(jnp.take_along_axis(logp, y[..., None], -1))
    return jax.jit(jax.value_and_grad(loss), **(jit_kw or {}))(params)


def _port_loss(m, x, y):
    logits = m(torch.from_numpy(x), train=False).float()
    loss = torch.nn.functional.cross_entropy(
        logits.reshape(-1, V), torch.from_numpy(y).long().reshape(-1))
    (g,) = torch.autograd.grad(loss, m.flat)
    return logits, loss, g[:m.n_params]


def test_layout_is_flax_ravel_order():
    """The reference's default width with PTB's vocabulary, path for path
    and shape for shape (``DenseGeneral``'s ``[D, 3, H, D/H]`` kernel
    included): 24,035,328 parameters; the small model's layout too."""
    spec = jget_model("transformer_lm", vocab_size=10_000)
    v = jax.eval_shape(lambda: spec.module.init(
        {"params": jax.random.PRNGKey(0)}, jnp.zeros((2, 256), jnp.int32),
        train=False))
    m = TransformerLM(vocab_size=10_000, device=torch.device("meta"))
    assert m.param_layout == _paths(v["params"])
    assert m.n_params == 24_035_328
    shapes = dict(m.param_layout)
    assert shapes["attn_5/qkv/kernel"] == (512, 3, 8, 64)
    assert shapes["attn_5/qkv/bias"] == (3, 8, 64)
    assert _port(_flax()).param_layout == _paths(_flax())
    spec = get_model("transformerlm", device="cpu", vocab_size=V, **KW)
    assert (spec.name, spec.input_shape, spec.task) == (
        "transformer_lm", (256,), "lm")


def test_qkv_kernel_draws_with_fan_in_dim():
    """flax's ``DenseGeneral((3, H, D/H))`` draws its kernel with fan-in
    D, as a Dense of D inputs does."""
    m = get_model("transformer_lm", vocab_size=500, dim=128, heads=4,
                  num_layers=1, ffn=64, device="cpu").module
    w = m.leaves()["attn_0/qkv/kernel"].detach()
    assert abs(float(w.std()) * np.sqrt(128) - 1.0) < 0.05


@pytest.mark.parametrize("train", [False, True])
def test_f32_logits_and_gradient_match_flax(train):
    params = _flax(1)
    x, y = _tokens(2)
    spec = jget_model("transformer_lm", vocab_size=V, **KW)
    want = spec.module.apply({"params": params}, jnp.asarray(x), train=False)
    m = _port(params)
    got = m(torch.from_numpy(x), train=train)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)
    jl, jg = _jloss(spec, params, jnp.asarray(x), jnp.asarray(y))
    _, loss, g = _port_loss(m, x, y)
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5)
    assert _rel(g.numpy(), np.asarray(ravel_pytree(jg)[0])) < 1e-5


def test_bf16_logits_match_flax_rounded_op_by_op():
    """bf16 compute: logits are bf16 (flax's ``Embed.attend`` casts to the
    compute dtype), within half the reference's own bf16-vs-f32 gap of the
    rounded reference, with the same argmax almost everywhere."""
    params = _flax(3)
    x, _ = _tokens(4)

    def flax_logits(dtype):
        spec = jget_model("transformer_lm", vocab_size=V, dtype=dtype, **KW)
        f = jax.jit(lambda v, t: spec.module.apply(v, t, train=False),
                    compiler_options=_ROUNDED)
        return np.asarray(f({"params": params}, jnp.asarray(x))
                          .astype(jnp.float32))

    j16, j32 = flax_logits(jnp.bfloat16), flax_logits(jnp.float32)
    got = _port(params, torch.bfloat16)(torch.from_numpy(x), train=False)
    assert got.dtype == torch.bfloat16
    got = got.detach().float().numpy()
    assert _rel(got, j16) < 0.5 * _rel(j16, j32)
    assert np.mean(got.argmax(-1) == j16.argmax(-1)) > 0.95


# ---------------------------------------------------------- sequence split

def _w_sp_model(rank, world, params, x, y):
    """One rank of the sp model: its block of the sequence through the
    ring over the default group; its logits and the gradient of its
    block's mean cross-entropy, and the initial weights of an sp model and
    of its sp-free twin drawn from one seed."""
    import torch
    import torch.distributed as dist
    from gaussiank_sgd_torch import convert
    from gaussiank_sgd_torch.models import get_model
    kw = dict(vocab_size=64, dim=32, heads=4, num_layers=2, ffn=48,
              dropout=0.0, max_len=64, device="cpu")
    m = get_model("transformer_lm", sp_group=dist.group.WORLD, **kw).module
    twin = get_model("transformer_lm", **kw).module
    same_init = bool(torch.equal(m.flat, twin.flat))
    convert.load_flax_variables(m, params)
    t = x.shape[1] // world
    xb = torch.from_numpy(x[:, rank * t:(rank + 1) * t].copy())
    yb = torch.from_numpy(y[:, rank * t:(rank + 1) * t].copy()).long()
    logits = m(xb, train=False)
    loss = torch.nn.functional.cross_entropy(logits.reshape(-1, 64),
                                             yb.reshape(-1))
    (g,) = torch.autograd.grad(loss, m.flat)
    return {"logits": logits.detach().numpy(), "grad": g.numpy(),
            "same_init": same_init}


def test_sp_model_matches_its_single_process_twin(tmp_path):
    """sp = 2 over gloo: the concatenated logits equal the single-process
    model's (the reference holds its sp model at rtol 3e-4 / atol 3e-4);
    the ranks' gradients of their blocks' mean loss average to the full
    sequence's gradient (equal blocks), within 1e-5 relative L2."""
    params = _flax(5)
    x, y = _tokens(6, b=2, t=32)
    outs = _spawn(tmp_path, 2, _w_sp_model, params=params, x=x, y=y)
    assert all(o["same_init"] for o in outs)
    m = _port(params)
    logits, _, g = _port_loss(m, x, y)
    np.testing.assert_allclose(
        np.concatenate([o["logits"] for o in outs], axis=1),
        logits.detach().numpy(), rtol=3e-4, atol=3e-4)
    mean_g = (outs[0]["grad"] + outs[1]["grad"])[:m.n_params] / 2
    assert _rel(mean_g, g.numpy()) < 1e-5


def test_max_len_bounds_the_global_sequence(monkeypatch):
    """As the reference asserts: an sp model whose ``max_len`` is shorter
    than ``sp * T_local`` refuses (checked before any hop)."""
    import gaussiank_sgd_torch.models.transformer_lm as tlm
    m = get_model("transformer_lm", vocab_size=V, device="cpu", dim=32,
                  heads=4, num_layers=1, ffn=48, max_len=16,
                  sp_group=object()).module
    monkeypatch.setattr(tlm, "world_size", lambda group: 4)
    with pytest.raises(ValueError, match="max_len=16 < global sequence"):
        m(torch.zeros(1, 8, dtype=torch.int32), train=False)


# --------------------------------------------------------- (dp, sp) trainer

SP_CFG = dict(dnn="transformer_lm", dataset="ptb", nworkers=2, sp_size=2,
              batch_size=2, compressor="gaussian_warm", density=0.01,
              compress_warmup_steps=2, max_steps=4, lr=0.01, momentum=0.9,
              weight_decay=0.0, warmup_epochs=0.0, compute_dtype="float32",
              log_every=1, eval_every_epochs=0, save_every_epochs=0, seed=0,
              model_kwargs=dict(dim=32, heads=2, num_layers=2, ffn=64,
                                dropout=0.0, seq_len=32, max_len=64),
              dataset_kwargs=dict(vocab_size=128, bptt=32,
                                  synthetic_tokens_n=8192),
              eval_max_batches=2)


def _w_sp_trainer(rank, world, cfg, out_dir):
    """One rank of the (dp, sp) trainer: 2 dense + 2 sparse steps, then an
    eval pass; the losses, the parameters after every step, the layout."""
    from gaussiank_sgd_torch.training.config import TrainConfig
    from gaussiank_sgd_torch.training.trainer import Trainer
    t = Trainer(TrainConfig(**cfg, device="cpu", output_dir=out_dir))
    params = []
    for _ in range(4):
        t.train(1)
        params.append(t.state.params.detach()[:t.plan.total_numel]
                      .numpy().copy())
    out = {"losses": [r["loss"] for r in t.records], "params": params,
           "kinds": [r["kind"] for r in t.records],
           "mesh": (t.mesh.names, t.mesh.sizes), "nworkers": t.cfg.nworkers,
           "batch": tuple(t.next_batch()[0].shape),
           "eval": t.test()}
    t.close()
    return out


def test_dp_sp_trainer_matches_the_reference_mesh(tmp_path):
    outs = _spawn(tmp_path, 4, _w_sp_trainer, cfg=SP_CFG,
                  out_dir=str(tmp_path / "port"))
    for o in outs:
        assert o["mesh"] == (("dp", "sp"), (2, 2)) and o["nworkers"] == 2
        assert o["kinds"] == ["dense", "dense", "sparse", "sparse"]
        assert o["batch"] == (2, 16)        # its rows, its half sequence
        assert o["losses"] == outs[0]["losses"]
        for a, b in zip(o["params"], outs[0]["params"]):
            np.testing.assert_array_equal(a, b)
        assert o["eval"] == outs[0]["eval"]
    assert np.isfinite(outs[0]["eval"]["val_loss"])
    jt = JTrainer(JTrainConfig(**SP_CFG, output_dir=str(tmp_path / "ref")))
    assert tuple(jt.mesh.axis_names) == ("dp", "sp") and jt.mesh.size == 4
    m = get_model("transformer_lm", vocab_size=128, seed=0, device="cpu",
                  **{k: v for k, v in SP_CFG["model_kwargs"].items()
                     if k != "seq_len"}).module
    params, _ = convert.export_flax_variables(m)
    jt.state = jt.ts.init_state(jax.tree.map(jnp.asarray, params),
                                jax.random.PRNGKey(0), model_state={})
    jlosses = [jt.train(1)["loss"] for _ in range(4)]
    np.testing.assert_allclose(outs[0]["losses"], jlosses, rtol=1e-5)
    jt.close()


def test_sp_rejects_bad_configs(tmp_path):
    """The reference's refusals: an sp axis that is not the mesh's last, a
    recurrent carry with sp, ``FlatSGDM`` on the 2-D mesh; at the trainer,
    ``--sp-size`` for another model and beside ``--ici/--dcn-size``."""
    mesh = DPMesh(("dp", "sp"), (None, None), (2, 4))
    spec = get_model("transformer_lm", vocab_size=V, device="cpu", **KW)
    plan = plan_for_params(spec.module.param_layout, 0.1)
    comp = get_compressor("topk", density=0.1)
    args = (make_loss_fn(spec.module, "lm"), spec.module.flat, {}, comp,
            plan)
    opt = OptaxSGD(lr=lambda count: 0.1)
    with pytest.raises(ValueError, match="last axis"):
        DPTrainStep(*args, optimizer=opt, mesh=mesh, sp_axis="dp")
    with pytest.raises(ValueError, match="recurrent carry"):
        DPTrainStep(*args, optimizer=opt, mesh=mesh, sp_axis="sp",
                    recurrent=True)
    with pytest.raises(ValueError, match="flat_opt supports 1-D"):
        DPTrainStep(*args, flat_opt=FlatSGDM(lr=lambda s: 0.1), mesh=mesh,
                    sp_axis="sp")
    base = dict(device="cpu", output_dir=str(tmp_path), sp_size=2)
    with pytest.raises(ValueError, match="transformer_lm long-context"):
        Trainer(TrainConfig(dnn="vgg16", **base))
    with pytest.raises(ValueError, match="mutually exclusive"):
        TrainConfig(dnn="transformer_lm", dataset="ptb", ici_size=2,
                    dcn_size=1, **base)
