"""Parity of the port's LSTM language model (``models/lstm.py``), the lm
loss and eval (``training/losses.py``), the carried hidden state in the
train step (``parallel/trainstep.py``) and the trainer
(``training/trainer.py``: the carry's reset at an epoch wrap, the eval pass
from a fresh carry, resume) with the reference's flax ``LSTMLM`` and its
``build_dp_train_step(..., recurrent=True)``.

The reference's weights go through numpy into the port. The LSTM has no
ReLU gates (ROADMAP's standing differences), so f32 values agree closely:
logits and carries at rtol 1e-5 / atol 1e-6, the gradient at 1e-5
relative L2, losses over a trajectory at rtol 1e-5 and its carries at atol
1e-5 (both packages sum the matmuls in their own order). Dropout is off
wherever the two packages are compared: their dropout draws cannot match.
The port's carry is one tensor ``[layers, 2, B, H]``; the reference's a
tuple of ``(c, h)`` a layer.
"""

import json
import math
import os
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

from gaussiank_sgd_tpu.compressors.registry import get_compressor as jcomp
from gaussiank_sgd_tpu.data.synthetic import synthetic_tokens as jtokens
from gaussiank_sgd_tpu.models import get_model as jget_model
from gaussiank_sgd_tpu.parallel.bucketing import plan_for_params as jplan
from gaussiank_sgd_tpu.parallel.flat_opt import FlatSGDM as JFlatSGDM
from gaussiank_sgd_tpu.parallel.mesh import data_parallel_mesh, shard_batch
from gaussiank_sgd_tpu.parallel.trainstep import build_dp_train_step
from gaussiank_sgd_tpu.training.losses import make_eval_fn as jmake_eval
from gaussiank_sgd_tpu.training.losses import make_loss_fn as jmake_loss
from gaussiank_sgd_torch import convert
from gaussiank_sgd_torch.compressors import decompress, get_compressor
from gaussiank_sgd_torch.data.ptb import PTBDataset, make_ptb
from gaussiank_sgd_torch.models import get_model
from gaussiank_sgd_torch.models.lstm import LSTMLM
from gaussiank_sgd_torch.parallel.bucketing import plan_for_params
from gaussiank_sgd_torch.parallel.flat_opt import FlatSGDM
from gaussiank_sgd_torch.parallel.trainstep import DPTrainStep, flat_numel
from gaussiank_sgd_torch.training import trainer as trainer_mod
from gaussiank_sgd_torch.training.config import add_args, from_args
from gaussiank_sgd_torch.training.losses import make_eval_fn, make_loss_fn
from test_torch_distributed import _spawn

REPO = pathlib.Path(__file__).resolve().parents[1]
CONFIG4 = str(REPO / "exp_configs" / "config4_lstm_ptb_gaussian.json")
V = 50
KW = dict(embed_dim=12, hidden_dim=16, num_layers=2, dropout=0.0)
TOL = dict(rtol=1e-5, atol=1e-6)
OPT = dict(lr=0.1, momentum=0.0, weight_decay=0.0)     # config 4's SGD
DENSITY = 0.05


def _paths(tree):
    return [("/".join(k.key for k in path), tuple(leaf.shape))
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]]


def _flax(seed=0):
    spec = jget_model("lstm", vocab_size=V, dtype=jnp.float32, **KW)
    v = spec.module.init({"params": jax.random.PRNGKey(seed)},
                         jnp.zeros((2, 5), jnp.int32), train=False)
    return spec, jax.tree.map(np.asarray, v["params"])


def _port(params, pad_to=None):
    m = get_model("lstm", vocab_size=V, device="cpu", **KW).module
    if pad_to is not None:
        m.pad_flat(pad_to)
    convert.load_flax_variables(m, params)
    return m


def _to_ref(carry):
    c = carry.numpy()
    return tuple((jnp.asarray(c[i, 0]), jnp.asarray(c[i, 1]))
                 for i in range(c.shape[0]))


def _from_ref(carry):
    return np.stack([np.stack([np.asarray(c), np.asarray(h)])
                     for c, h in carry])


def _rel(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def test_layout_is_flax_ravel_order():
    """Path for path and shape for shape at config 4's full width
    (19,775,200 parameters) and at a small one: Dense_0, Embed_0, then each
    layer's bare ``wh`` before its ``wx`` Dense."""
    for kw, n in ((dict(vocab_size=10_000), 19_775_200),
                  (dict(vocab_size=V, **KW), None)):
        spec = jget_model("lstm", **kw)
        v = jax.eval_shape(lambda: spec.module.init(
            {"params": jax.random.PRNGKey(0)},
            jnp.zeros((2, 35), jnp.int32), train=False))
        m = LSTMLM(**{k: x for k, x in kw.items() if k != "dropout"},
                   device=torch.device("meta"))
        assert m.param_layout == _paths(v["params"])
        if n is not None:
            assert m.n_params == n
    assert [p for p, _ in m.param_layout] == [
        "Dense_0/bias", "Dense_0/kernel", "Embed_0/embedding", "lstm_0/wh",
        "lstm_0/wx/bias", "lstm_0/wx/kernel", "lstm_1/wh", "lstm_1/wx/bias",
        "lstm_1/wx/kernel"]


def test_init_families():
    """``wh`` is four orthogonal ``[H, H]`` blocks; the embedding is drawn
    from N(0, 1/E) as flax's ``Embed``; biases start at zero."""
    m = get_model("lstm", vocab_size=400, embed_dim=64, hidden_dim=32,
                  device="cpu", seed=1).module
    leaves = m.leaves()
    wh = leaves["lstm_0/wh"].detach()
    for g in range(4):
        blk = wh[:, 32 * g:32 * (g + 1)]
        torch.testing.assert_close(blk.T @ blk, torch.eye(32), atol=1e-5,
                                   rtol=0)
    emb = leaves["Embed_0/embedding"].detach().numpy()
    flax_emb = np.asarray(jax.nn.initializers.variance_scaling(
        1.0, "fan_in", "normal", out_axis=0)(jax.random.PRNGKey(0),
                                             (400, 64)))
    for w in (emb, flax_emb):
        assert abs(w.std() * 8.0 - 1.0) < 0.03
    assert not leaves["lstm_1/wx/bias"].any()


def test_unknown_model_kwarg_raises():
    """A keyword the LSTM does not take raises: the reference's ``unroll``
    (a scan setting of XLA, with no meaning for an eager loop) is one."""
    with pytest.raises(TypeError, match="unroll"):
        get_model("lstm", vocab_size=50, embed_dim=8, hidden_dim=8,
                  unroll=35, device="cpu")


@pytest.mark.parametrize("with_carry", [False, True])
def test_logits_and_carry_match_flax(with_carry):
    spec, params = _flax(1)
    rng = np.random.default_rng(2)
    x = rng.integers(0, V, size=(3, 9)).astype(np.int32)
    carry = (torch.from_numpy(rng.normal(size=(2, 2, 3, 16)).astype(
        np.float32)) if with_carry else None)
    jlogits, jcarry = spec.module.apply(
        {"params": params}, jnp.asarray(x), train=False,
        initial_carry=_to_ref(carry) if with_carry else None,
        return_carry=True)
    m = _port(params)
    logits, new_carry = m(torch.from_numpy(x), train=False, carry=carry)
    assert logits.dtype == torch.float32 and not new_carry.requires_grad
    np.testing.assert_allclose(logits.detach().numpy(), jlogits, **TOL)
    np.testing.assert_allclose(new_carry.numpy(), _from_ref(jcarry), **TOL)


def test_gradient_matches_flax():
    """The lm loss (cross-entropy per token) and its flat gradient in the
    reference's ravel order, from a carried state."""
    spec, params = _flax(3)
    rng = np.random.default_rng(4)
    x, y = (rng.integers(0, V, size=(4, 7)).astype(np.int32)
            for _ in range(2))
    carry = torch.from_numpy(rng.normal(size=(2, 2, 4, 16)).astype(
        np.float32))
    jloss_fn = jmake_loss(spec, recurrent=True)
    (jl, (_, jaux, jc)), jg = jax.value_and_grad(jloss_fn, has_aux=True)(
        params, {}, (jnp.asarray(x), jnp.asarray(y)), jax.random.PRNGKey(0),
        _to_ref(carry))
    m = _port(params)
    loss, aux, c = make_loss_fn(m, "lm", recurrent=True)(
        (torch.from_numpy(x), torch.from_numpy(y)), carry)
    (g,) = torch.autograd.grad(loss, m.flat)
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-6)
    np.testing.assert_allclose(float(aux["ce_per_token"]),
                               float(jaux["ce_per_token"]), rtol=1e-6)
    np.testing.assert_allclose(c.numpy(), _from_ref(jc), **TOL)
    assert _rel(g.numpy(), np.asarray(ravel_pytree(jg)[0])) < 1e-5
    plain_loss, _ = make_loss_fn(m, "lm")((torch.from_numpy(x),
                                           torch.from_numpy(y)))
    jplain, _ = jmake_loss(spec)(params, {}, (jnp.asarray(x),
                                              jnp.asarray(y)),
                                 jax.random.PRNGKey(0))
    np.testing.assert_allclose(float(plain_loss.detach()), float(jplain),
                               rtol=1e-6)


def _reference_run(params, windows, kinds, n_micro=1, batch=4, world=1):
    spec = jget_model("lstm", vocab_size=V, dtype=jnp.float32, **KW)
    mesh = data_parallel_mesh(world)
    jts = build_dp_train_step(
        jmake_loss(spec, recurrent=True), None,
        jcomp("gaussian_fused", density=DENSITY), jplan(params, DENSITY),
        mesh, num_microbatches=n_micro, clip_norm=0.25, recurrent=True,
        flat_opt=JFlatSGDM(**OPT), wire="off")
    state = jts.init_state(jax.tree.map(jnp.asarray, params),
                           jax.random.PRNGKey(1),
                           carry=spec.module.initial_carry(batch))
    out = []
    for kind, (x, y) in zip(kinds, windows):
        fn = jts.dense_step if kind == "dense" else jts.sparse_step
        state, met = fn(state, shard_batch(mesh, (x, y)))
        out.append((float(met.loss), _from_ref(state.carry)))
    return out


def _port_step(params, n_micro=1, batch=4):
    plan = plan_for_params(get_model(
        "lstm", vocab_size=V, device="cpu", **KW).module.param_layout,
        DENSITY)
    spec = get_compressor("gaussian_fused", density=DENSITY)
    m = _port(params, pad_to=flat_numel(spec, plan))
    ts = DPTrainStep(make_loss_fn(m, "lm", recurrent=True), m.flat,
                     {"stats": m.stats}, spec, plan,
                     flat_opt=FlatSGDM(**OPT), wire="off",
                     num_microbatches=n_micro, clip_norm=0.25,
                     recurrent=True)
    return m, ts, ts.init_state(m.initial_carry(batch))


def test_carry_threads_three_windows_like_the_reference():
    """Three contiguous bptt windows (a dense step, then two sparse steps
    of gaussian_fused, clip 0.25): the losses and the carried state after
    every step against the reference's; the port's EF bookkeeping exact."""
    _, params = _flax(5)
    ds = PTBDataset(jtokens(2000, V, seed=6), 4, 7)
    windows = list(ds.epoch())[:3]
    kinds = ["dense", "sparse", "sparse"]
    ref = _reference_run(params, windows, kinds)
    _, ts, state = _port_step(params)
    assert not state.carry.any()
    for (kind, (x, y)), (jl, jc) in zip(zip(kinds, windows), ref):
        tb = (torch.from_numpy(x), torch.from_numpy(y))
        if kind == "sparse":
            g = ts.local_grads(state, tb)
            comp, residual, _, _ = ts.compress_phase(state, g.flat_g)
            assert torch.equal(decompress(comp, ts.ef_numel) + residual,
                               state.ef_residual + g.flat_g)
        fn = ts.dense_step if kind == "dense" else ts.sparse_step
        met = fn(state, tb)
        np.testing.assert_allclose(float(met.loss), jl, rtol=1e-5)
        np.testing.assert_allclose(state.carry.numpy(), jc, atol=1e-5,
                                   rtol=0)
        assert state.carry.any()


def test_microbatched_carry_split_by_rows():
    """``--nsteps-update 2``: the carry's rows split with the batch's and
    come back in row order, against the reference's scan; each half's new
    carry is what that half alone gives."""
    _, params = _flax(7)
    ds = PTBDataset(jtokens(2000, V, seed=8), 4, 7)
    windows = list(ds.epoch())[:2]
    ref = _reference_run(params, windows, ["dense", "dense"], n_micro=2)
    m, ts, state = _port_step(params, n_micro=2)
    for (x, y), (jl, jc) in zip(windows, ref):
        met = ts.dense_step(state, (torch.from_numpy(x),
                                    torch.from_numpy(y)))
        np.testing.assert_allclose(float(met.loss), jl, rtol=1e-5)
        np.testing.assert_allclose(state.carry.numpy(), jc, atol=1e-5,
                                   rtol=0)
    # the second window's first half from the first window's carry rows
    m2, ts2, state2 = _port_step(params, n_micro=2)
    x, y = windows[0]
    ts2.dense_step(state2, (torch.from_numpy(x), torch.from_numpy(y)))
    x, y = windows[1]
    with torch.no_grad():
        halves = [m2(torch.from_numpy(x[r]), train=False,
                     carry=state2.carry[:, :, r])[1]
                  for r in (slice(0, 2), slice(2, 4))]
    g = ts2.local_grads(state2, (torch.from_numpy(x), torch.from_numpy(y)))
    np.testing.assert_array_equal(g.carry.numpy(),
                                  torch.cat(halves, dim=2).numpy())


def test_guard_skip_keeps_the_old_carry():
    """A step whose loss is not finite commits nothing: parameters, EF row
    and the carry keep their bits, in the port as in the reference."""
    _, params = _flax(9)
    ds = PTBDataset(jtokens(2000, V, seed=10), 4, 7)
    w0, w1 = list(ds.epoch())[:2]
    m, ts, state = _port_step(params)
    ts.dense_step(state, tuple(map(torch.from_numpy, w0)))
    carry = state.carry.clone()
    off = {p: o for o, p in zip(np.cumsum([0] + [math.prod(s) for _, s in
                                                 m.param_layout]),
                                [p for p, _ in m.param_layout])}
    with torch.no_grad():
        m.flat[off["lstm_1/wx/bias"]] = float("nan")
    bad = m.flat.detach().clone()
    met = ts.sparse_step(state, tuple(map(torch.from_numpy, w1)))
    assert float(met.skipped) == 1.0 and not math.isfinite(float(met.loss))
    assert torch.equal(state.carry, carry)
    assert torch.equal(m.flat.detach().view(torch.int32),
                       bad.view(torch.int32)) and state.step == 2
    assert not state.ef_residual.any()
    # the reference keeps its carry too
    spec, _ = _flax(9)
    jparams = jax.tree.map(np.copy, params)
    jparams["lstm_1"]["wx"]["bias"][0] = np.nan
    mesh = data_parallel_mesh(1)
    jts = build_dp_train_step(
        jmake_loss(spec, recurrent=True), None,
        jcomp("gaussian_fused", density=DENSITY), jplan(params, DENSITY),
        mesh, recurrent=True, flat_opt=JFlatSGDM(**OPT), wire="off")
    jstate = jts.init_state(jax.tree.map(jnp.asarray, jparams),
                            jax.random.PRNGKey(1), carry=_to_ref(carry))
    jstate, jm = jts.sparse_step(jstate, shard_batch(mesh, w1))
    assert float(jm.skipped) == 1.0
    np.testing.assert_array_equal(_from_ref(jstate.carry), carry.numpy())


def _small_ptb(monkeypatch, tokens=400, bptt=5):
    """The trainer's PTB at a small vocabulary and stream (the config
    carries no dataset kwargs): 400 tokens at batch 4 make 19 windows of
    5 an epoch."""
    def make(name, data_dir=None, train=True, batch_size=20, **kw):
        return make_ptb(None, "train" if train else "valid", batch_size,
                        bptt=bptt, vocab_size=V,
                        synthetic_tokens_n=tokens)
    monkeypatch.setattr(trainer_mod, "make_dataset", make)


def _config4(tmp_path, *flags):
    p = __import__("argparse").ArgumentParser()
    add_args(p)
    argv = ["--config", CONFIG4, "--device", "cpu", "--nworkers", "1",
            "--batch-size", "4", "--model-kwargs",
            json.dumps({k: v for k, v in KW.items()}),
            "--output-dir", str(tmp_path), *flags]
    return trainer_mod.Trainer(from_args(p.parse_args(argv), argv))


def test_epoch_wrap_resets_the_carry(tmp_path, monkeypatch):
    """Config 4's trainer (at a toy width): the carry threads through an
    epoch's windows and is zero again at the first window of the next, as
    the reference's train loop resets it; ``--no-carry-hidden`` keeps
    none."""
    _small_ptb(monkeypatch)
    t = _config4(tmp_path, "--max-steps", "21", "--compressor", "none",
                 "--lr", "0.5")
    assert t.recurrent and t.steps_per_epoch == 19
    assert tuple(t.state.carry.shape) == (2, 2, 4, 16)
    seen = []
    local = t.ts.local_grads

    def spy(state, batch):
        seen.append(state.carry.clone())
        return local(state, batch)

    t.ts.local_grads = spy
    t.train(21)
    recs = t.records
    assert all(np.isfinite(r["loss"]) for r in recs)
    assert not seen[0].any() and seen[1].any() and seen[18].any()
    assert not seen[19].any() and seen[20].any()       # step 19: the wrap
    off = _config4(tmp_path, "--no-carry-hidden", "--run-id", "off")
    assert not off.recurrent and off.state.carry is None


def test_recurrent_eval_sums_and_perplexity(tmp_path, monkeypatch):
    """The eval pass from a fresh carry threaded through the validation
    windows: its sums against the reference's recurrent eval on the same
    weights, and ``perplexity = exp(min(val_loss, 30))``."""
    _small_ptb(monkeypatch)
    t = _config4(tmp_path, "--max-steps", "2", "--eval-max-batches", "3")
    t.train(2)
    out = t.test()
    spec = jget_model("lstm", vocab_size=V, dtype=jnp.float32, **KW)
    params, _ = convert.export_flax_variables(t.model)
    jeval = jmake_eval(spec, recurrent=True)
    carry, total, n = spec.module.initial_carry(4), 0.0, 0.0
    ds, _ = make_ptb(None, "valid", 4, bptt=5, vocab_size=V,
                     synthetic_tokens_n=400)
    port_eval = make_eval_fn(t.model, "lm", recurrent=True)
    pc = t.model.initial_carry(4)
    for i, (x, y) in enumerate(ds.epoch()):
        if i == 3:
            break
        sums, carry = jeval(params, {}, (jnp.asarray(x), jnp.asarray(y)),
                            carry)
        psums, pc = port_eval((torch.from_numpy(x), torch.from_numpy(y)), pc)
        np.testing.assert_allclose(float(psums["loss_sum"]),
                                   float(sums["loss_sum"]), rtol=1e-5)
        assert float(psums["n"]) == float(sums["n"]) == 20.0
        total += float(sums["loss_sum"])
        n += float(sums["n"])
    np.testing.assert_allclose(pc.numpy(), _from_ref(carry), atol=1e-5,
                               rtol=0)
    np.testing.assert_allclose(out["val_loss"], total / n, rtol=1e-5)
    assert out["perplexity"] == math.exp(min(out["val_loss"], 30.0))
    assert set(out) == {"val_loss", "perplexity"}


def test_toy_resume_is_bit_for_bit(tmp_path, monkeypatch):
    """Config 4 as shipped (compressor gaussian, clip 0.25, the carry on)
    at a toy width: a run checkpointed at step 3 and a fresh trainer
    resumed there reach step 6 with the same losses, parameters, EF row
    and carry, bit for bit; the carry is in the rank's file."""
    _small_ptb(monkeypatch)
    flags = ["--max-steps", "6", "--compress-warmup-steps", "2",
             "--save-every-steps", "3", "--eval-every-epochs", "0",
             "--density", str(DENSITY), "--lr", "0.5"]
    t = _config4(tmp_path, *flags, "--run-id", "a")
    assert t.comp.name == "gaussian"
    t.fit()
    losses = [r["loss"] for r in t.records]
    step3 = os.path.join(t.ckpt_dir, "step_00000003")
    row = torch.load(os.path.join(step3, "rank_00000.pt"),
                     weights_only=True)
    assert tuple(row["carry"].shape) == (2, 2, 4, 16) and row["carry"].any()
    r = _config4(tmp_path, *flags, "--run-id", "b", "--resume", step3)
    assert r.state.step == 3 and torch.equal(r.state.carry, row["carry"])
    r.fit()
    resumed = [x["loss"] for x in r.records]
    assert resumed == losses[3:]
    for a, b in ((t.state.params, r.state.params),
                 (t.state.ef_residual, r.state.ef_residual),
                 (t.state.carry, r.state.carry)):
        assert torch.equal(a.detach().view(torch.int32),
                           b.detach().view(torch.int32))


def _w_lstm(rank, world, params, windows, kinds, kw):
    import torch
    from gaussiank_sgd_torch import convert
    from gaussiank_sgd_torch.compressors import get_compressor
    from gaussiank_sgd_torch.models import get_model
    from gaussiank_sgd_torch.parallel.bucketing import plan_for_params
    from gaussiank_sgd_torch.parallel.flat_opt import FlatSGDM
    from gaussiank_sgd_torch.parallel.trainstep import (DPTrainStep,
                                                        flat_numel)
    from gaussiank_sgd_torch.training.losses import make_loss_fn
    m = get_model("lstm", vocab_size=50, device="cpu", **kw).module
    plan = plan_for_params(m.param_layout, 0.05)
    spec = get_compressor("gaussian_fused", density=0.05)
    m.pad_flat(flat_numel(spec, plan))
    convert.load_flax_variables(m, params)
    ts = DPTrainStep(make_loss_fn(m, "lm", recurrent=True), m.flat,
                     {"stats": m.stats}, spec, plan,
                     flat_opt=FlatSGDM(lr=0.1), wire="off", clip_norm=0.25,
                     recurrent=True)
    rows = windows[0][0].shape[0] // world
    state = ts.init_state(m.initial_carry(rows))
    out = []
    for kind, (x, y) in zip(kinds, windows):
        mine = slice(rank * rows, (rank + 1) * rows)
        batch = (torch.from_numpy(x[mine]), torch.from_numpy(y[mine]))
        fn = ts.dense_step if kind == "dense" else ts.sparse_step
        met = fn(state, batch)
        out.append((float(met.loss), state.carry.numpy().copy()))
    return {"steps": out, "params": state.params.detach().numpy()}


def test_two_workers_carry_their_own_rows(tmp_path):
    """At P = 2 over gloo each rank carries the hidden state of its own
    rows of the global batch, never averaged, against the reference's
    2-device mesh whose carry is sharded by rows: losses at rtol 1e-5,
    each rank's carry against the reference's rows at atol 1e-5, and both
    ranks' parameters bit-identical."""
    _, params = _flax(11)
    ds = PTBDataset(jtokens(4000, V, seed=12), 8, 7)
    windows = [(x.copy(), y.copy()) for x, y in list(ds.epoch())[:3]]
    kinds = ["dense", "sparse", "sparse"]
    ref = _reference_run(params, windows, kinds, batch=8, world=2)
    outs = _spawn(tmp_path, 2, _w_lstm, params=params, windows=windows,
                  kinds=kinds, kw=KW)
    for i, (jl, jc) in enumerate(ref):
        for r, o in enumerate(outs):
            loss, carry = o["steps"][i]
            np.testing.assert_allclose(loss, jl, rtol=1e-5)
            np.testing.assert_allclose(carry, jc[:, :, 4 * r:4 * r + 4],
                                       atol=1e-5, rtol=0)
        assert not np.array_equal(outs[0]["steps"][i][1],
                                  outs[1]["steps"][i][1])
    np.testing.assert_array_equal(outs[0]["params"], outs[1]["params"])


def test_carry_restarts_from_zeros_at_another_worker_count(tmp_path,
                                                           monkeypatch):
    """The carry's rows are one worker's batch rows: a checkpoint written
    by two workers restores at one with a zero carry (and the EF rows'
    mean), as the reference restores it; at the same worker count it comes
    back as saved."""
    from gaussiank_sgd_torch.training import checkpoint as ck
    _small_ptb(monkeypatch)
    t = _config4(tmp_path, "--max-steps", "3", "--compress-warmup-steps",
                 "1", "--density", str(DENSITY), "--run-id", "a")
    t.train(3)
    path = t.save_checkpoint()
    with torch.no_grad():
        t.state.carry.zero_()
    ck.restore_checkpoint(path, t.state, t.ts.ef_numel)
    saved = torch.load(os.path.join(path, "rank_00000.pt"),
                       weights_only=True)
    assert saved["carry"].any()
    assert torch.equal(t.state.carry, saved["carry"])
    # the same directory as if two workers had written it
    row = saved["ef_residual"]
    torch.save({**saved, "ef_residual": 3 * row},
               os.path.join(path, "rank_00001.pt"))
    ck._write_manifest(path, 3, 2)
    ck.restore_checkpoint(path, t.state, t.ts.ef_numel)
    assert tuple(t.state.carry.shape) == (2, 2, 4, 16)
    assert not t.state.carry.any()
    n = t.plan.total_numel
    torch.testing.assert_close(t.state.ef_residual[:n], 4 * row, rtol=0,
                               atol=0)


# the reference compiled with every bf16 op rounded, as the port's eager ops
# round (XLA keeps some bf16 intermediates of the scan body in f32 unless
# told not to)
_ROUNDED = {"xla_allow_excess_precision": False}


@pytest.mark.parametrize("with_carry", [False, True])
def test_bf16_logits_match_flax(with_carry):
    """bf16 compute (the CLI's default dtype for ``--dnn lstm``) against the
    reference's bf16 model on the same weights, jitted as ``_ROUNDED`` says:
    the gates through ``flat.sigmoid`` round as ``jax.nn.sigmoid``'s ops
    do, so the logits and the carry are equal bit for bit
    (``torch.sigmoid`` rounds once and lands about 1e-2 away)."""
    _, params = _flax(7)
    rng = np.random.default_rng(8)
    x = rng.integers(0, V, size=(3, 9)).astype(np.int32)
    carry = (rng.normal(size=(2, 2, 3, 16)).astype(np.float32)
             if with_carry else None)
    spec = jget_model("lstm", vocab_size=V, dtype=jnp.bfloat16, **KW)
    jcarry0 = (tuple((jnp.asarray(carry[i, 0], jnp.bfloat16),
                      jnp.asarray(carry[i, 1], jnp.bfloat16))
                     for i in range(2)) if with_carry else None)
    run = jax.jit(lambda p, xx, c: spec.module.apply(
        {"params": p}, xx, train=False, initial_carry=c, return_carry=True),
        compiler_options=_ROUNDED)
    jlogits, jcarry = run(params, jnp.asarray(x), jcarry0)
    m = get_model("lstm", vocab_size=V, device="cpu", dtype=torch.bfloat16,
                  **KW).module
    convert.load_flax_variables(m, params)
    logits, new_carry = m(torch.from_numpy(x), train=False, carry=(
        torch.from_numpy(carry).to(torch.bfloat16) if with_carry else None))
    assert logits.dtype == torch.float32 and new_carry.dtype == torch.bfloat16
    np.testing.assert_array_equal(logits.detach().numpy(),
                                  np.asarray(jlogits, np.float32))
    np.testing.assert_array_equal(
        new_carry.float().numpy(),
        _from_ref(jax.tree.map(lambda a: np.asarray(a, np.float32), jcarry)))
