"""Parity of the port's optax path (``parallel/flat_opt.py:OptaxSGD`` in
``parallel/trainstep.py``), ``fold_lr``, ``sigma_scale`` and
``dataset_kwargs`` with the reference, on the CPU.

1. One update of ``OptaxSGD`` against ``optax.chain(add_decayed_weights,
   sgd)`` for nesterov on and off, weight decay 0 and 5e-4, momentum 0
   and 0.9, two updates each (so the trace is live): bit for bit against
   optax run op by op, and against optax under ``jax.jit`` within the FMA
   bound: XLA on the CPU contracts ``g + wd * p``, ``u + mu * t`` and
   ``p + (-lr) * u`` into fused multiply-adds where the port rounds each
   operation, so each element of an update from the same inputs may
   differ by 4 ulp of the largest of ``|p|``, ``|p'|`` and ``|lr * u|``
   (measured: at most 3).
2. The train step on the optax path under ``fold_lr`` against the
   reference's ``build_dp_train_step(..., fold_lr=sched)``: 2 dense + 4
   sparse steps of an injected gradient (the loss ``sum(p * G)``), the
   last with a NaN (the guard skips it), on the fused path (kernel B1 at
   ``scale = lr(step)``), on the unfused ``gaussian`` path and on the
   gtopk exchange (one worker). With
   powers of two for the schedule, momentum and weight decay every product
   is exact and params, trace, count, EF row and thresholds agree bit for
   bit (warm thresholds within 1 ulp: XLA's f32 ``pow``). At config 2's
   hyper-parameters (lr 0.1, momentum 0.9, wd 5e-4, nesterov) the
   trajectory is held within rtol 1e-5 / atol 1e-6 (measured: params of
   magnitude up to 5.5 apart by 7.2e-7 at most, trace 8.9e-8, EF row
   3.0e-8; every num_selected equal): the FMA contractions above, and in
   the EF accumulate ``res + lr * g``.
3. The guard's count: a skipped step advances the count (the learning
   rate tracks the step) and keeps the trace bit for bit, after
   ``tests/test_resilience.py:104-125``.
4. A resume on the optax path is bit for bit (params, trace, count, EF
   row, thresholds, BatchNorm statistics, losses).
5. ``sigma_scale``: ``gaussian_threshold_estimate`` bit for bit with the
   reference's where the two packages' mean and std agree, and within 2
   ulp where their sums' order moves the mean (up to 4 ulp) or the std (1
   ulp); the ``gaussian`` and ``gaussian_fused(warm-fallback)`` selections
   bit for bit with the reference's from the port's threshold.
6. ``dataset_kwargs`` reach the dataset, and the new flags parse.
"""

import argparse
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.flatten_util import ravel_pytree

from gaussiank_sgd_tpu.compressors import base as jbase
from gaussiank_sgd_tpu.compressors import gaussian as jgauss
from gaussiank_sgd_tpu.compressors.registry import get_compressor as jcomp
from gaussiank_sgd_tpu.data import make_dataset as jmake_dataset
from gaussiank_sgd_tpu.parallel.bucketing import plan_for_params as jplan
from gaussiank_sgd_tpu.parallel.mesh import data_parallel_mesh, shard_batch
from gaussiank_sgd_tpu.parallel.trainstep import build_dp_train_step
from gaussiank_sgd_tpu.training.lr_schedule import \
    warmup_milestone_schedule as jschedule
from gaussiank_sgd_torch.compressors import get_compressor
from gaussiank_sgd_torch.compressors.gaussian import \
    gaussian_threshold_estimate
from gaussiank_sgd_torch.parallel.bucketing import make_bucket_plan
from gaussiank_sgd_torch.parallel.flat_opt import FlatSGDM, OptaxSGD
from gaussiank_sgd_torch.parallel.trainstep import DPTrainStep, flat_numel
from gaussiank_sgd_torch.training import checkpoint as ck
from gaussiank_sgd_torch.training.config import (TrainConfig, add_args,
                                                 from_args)
from gaussiank_sgd_torch.training.lr_schedule import \
    warmup_milestone_schedule
from gaussiank_sgd_torch.training.trainer import Trainer

SHAPES = {"a": (300, 200), "b": (40_001,)}       # ravel order: a, then b
NARROW = [8, "M", 8, "M", 16, "M", 16, "M", 16, "M"]


def _bits(a):
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


def _same(port, ref):
    port = port.detach().numpy() if isinstance(port, torch.Tensor) else port
    np.testing.assert_array_equal(_bits(port), _bits(np.asarray(ref)))


def _chain(lr, momentum, weight_decay, nesterov):
    """The reference trainer's optax chain (training/trainer.py:362-371)."""
    parts = [optax.add_decayed_weights(weight_decay)] if weight_decay else []
    return optax.chain(*parts, optax.sgd(lr, momentum=momentum or None,
                                         nesterov=nesterov))


def _ulp(x):
    return np.spacing(np.abs(x).astype(np.float32))


# ------------------------------------------------------------ one update

@pytest.mark.parametrize("nesterov", [False, True])
@pytest.mark.parametrize("weight_decay", [0.0, 5e-4])
@pytest.mark.parametrize("momentum", [0.0, 0.9])
def test_one_update_matches_optax_chain(nesterov, weight_decay, momentum):
    n = 20_000
    rng = np.random.default_rng(3)
    p0 = rng.normal(size=n).astype(np.float32)
    grads = [rng.normal(size=n).astype(np.float32) for _ in range(2)]
    p0[:50], grads[0][50:100] = 0.0, -0.0          # signed zeros
    # a schedule read at the count, with no arithmetic of its own (XLA
    # would contract a schedule's multiply-add inside the jitted update)
    opt = _chain(lambda c: jnp.where(c < 1, jnp.float32(0.1),
                                     jnp.float32(0.01)),
                 momentum, weight_decay, nesterov)
    port = OptaxSGD(lambda c: 0.1 if c < 1 else 0.01, momentum,
                    weight_decay, nesterov)

    def jstep(p, s, g):
        u, s = opt.update(g, s, p)
        return optax.apply_updates(p, u), s, u

    for mode, fn in (("op by op", jstep), ("jit", jax.jit(jstep))):
        jp, js = jnp.asarray(p0), opt.init(jnp.asarray(p0))
        tp, ts = torch.from_numpy(p0.copy()), port.init(n)
        assert set(ts) == ({"count", "trace"} if momentum else {"count"})
        for i, g in enumerate(grads):
            jp_new, js, ju = fn(jp, js, jnp.asarray(g))
            upd, ts = port.update(ts, torch.from_numpy(g), tp)
            tp_new = tp + upd
            assert int(ts["count"]) == i + 1
            leaves = jax.tree_util.tree_leaves(js)
            assert [int(x) for x in leaves if x.dtype == jnp.int32] == [i + 1]
            jtrace = [np.asarray(x) for x in leaves if x.dtype == jnp.float32]
            if mode == "op by op":
                _same(tp_new, jp_new)
                _same(upd, ju)
                if momentum:
                    _same(ts["trace"], jtrace[0])
            else:
                a = np.asarray(jp_new)
                scale = np.maximum(np.maximum(np.abs(a), np.abs(tp.numpy())),
                                   np.abs(upd.numpy()))
                gap = np.abs(tp_new.numpy() - a) / _ulp(scale)
                assert gap.max() <= 4.0, gap.max()
                # the next update from the same inputs on both sides
                tp_new = torch.from_numpy(a.copy())
                if momentum:
                    ts["trace"] = torch.from_numpy(jtrace[0].copy())
            jp, tp = jp_new, tp_new


# --------------------------------------------------- the step on fold_lr

# exact products: the schedule's values, momentum and weight decay are
# powers of two; config 2's: lr 0.1 (0.1 x 2 = 0.2 peak at two workers is
# not used here: one worker), momentum 0.9, wd 5e-4
EXACT = dict(lr=2.0 ** -4, momentum=0.5, weight_decay=2.0 ** -11,
             decay=0.5)
CONFIG2 = dict(lr=0.1, momentum=0.9, weight_decay=5e-4, decay=0.1)


def _fold_lr_steps(compressor, hp, nesterov=True, exchange="allgather"):
    """2 dense + 4 sparse steps of the injected gradient, the last with a
    NaN, on both packages under ``fold_lr`` (the schedule decays by
    ``decay`` at step 3). Yields (step, port state, reference state)."""
    density = 0.001
    rng = np.random.default_rng(0)
    p0 = {k: rng.normal(size=s).astype(np.float32)
          for k, s in SHAPES.items()}
    grads = [{k: rng.normal(size=s).astype(np.float32)
              for k, s in SHAPES.items()} for _ in range(6)]
    grads[5]["b"][17] = np.nan
    sched_args = (hp["lr"], 1, 1, 6, 0.0, (0.5,), hp["decay"])
    jsched, tsched = jschedule(*sched_args), warmup_milestone_schedule(
        *sched_args)

    def jloss(p, mstate, batch, rng_):
        return sum(jnp.sum(p[k] * batch[k][0]) for k in SHAPES), (mstate, {})

    mesh = data_parallel_mesh(1)
    plan = jplan(p0, density)
    jts = build_dp_train_step(
        jloss, _chain(lambda s: 1.0, hp["momentum"], hp["weight_decay"],
                      nesterov),
        jcomp(compressor, density=density), plan, mesh, fold_lr=jsched,
        wire="off", exchange=exchange)
    jstate = jts.init_state(jax.tree.map(jnp.asarray, p0),
                            jax.random.PRNGKey(0))
    tplan = make_bucket_plan([int(np.prod(s)) for s in SHAPES.values()],
                             density)
    spec = get_compressor(compressor, density=density)
    n, n_pad = tplan.total_numel, flat_numel(spec, tplan, exchange)
    assert n_pad == jts.ef_numel

    def padded(flat):
        return torch.from_numpy(np.pad(flat, (0, n_pad - n)))

    params = torch.nn.Parameter(padded(ravel_pytree(p0)[0]))
    ts = DPTrainStep(lambda g: ((params * g).sum(), {}), params, {}, spec,
                     tplan, optimizer=OptaxSGD(
                         lambda c: 1.0, hp["momentum"], hp["weight_decay"],
                         nesterov), fold_lr=tsched, wire="off",
                     exchange=exchange)
    assert (ts.fused_ef is not None) == (compressor == "gaussian_fused"
                                         and exchange == "allgather")
    state = ts.init_state()
    for i, g in enumerate(grads):
        kind = "dense" if i < 2 else "sparse"
        jb = shard_batch(mesh, {k: v[None] for k, v in g.items()})
        jstate, jm = getattr(jts, f"{kind}_step")(jstate, jb)
        tm = getattr(ts, f"{kind}_step")(state, padded(ravel_pytree(g)[0]))
        assert float(tm.skipped) == float(jm.skipped) == (i == 5)
        assert ts.scale(i) == float(jsched(i))
        yield i, n, state, jstate, tm, jm


def _trace(jstate):
    return [np.asarray(x) for x in jax.tree_util.tree_leaves(
        jstate.opt_state) if x.dtype == jnp.float32]


def _count(jstate):
    return [int(x) for x in jax.tree_util.tree_leaves(jstate.opt_state)
            if x.dtype == jnp.int32]


@pytest.mark.parametrize("compressor,exchange", [
    ("gaussian_fused", "allgather"), ("gaussian", "allgather"),
    ("gaussian_fused", "gtopk")])
def test_fold_lr_trajectory_matches_reference_bitwise(compressor, exchange):
    """Exact products: params, trace, count, EF row, num_selected and the
    thresholds bit for bit over the 6 steps; the guard's step keeps every
    float and advances the count. On the gtopk exchange (one worker: no
    round) the unfused accumulate takes the scale and the global pairs go
    through the optax path's dense buffer."""
    for i, n, state, jstate, tm, jm in _fold_lr_steps(compressor, EXACT,
                                                      exchange=exchange):
        _same(state.params[:n], ravel_pytree(jstate.params)[0])
        _same(state.opt_state["trace"][:n], ravel_pytree(_trace(jstate))[0])
        assert int(state.opt_state["count"]) == _count(jstate)[0] == i + 1
        assert not state.params[n:].any()
        assert not state.opt_state["trace"][n:].any()
        _same(state.ef_residual, jstate.ef_residual)
        if i < 5:
            assert float(tm.num_selected) == float(jm.num_selected)
        if compressor == "gaussian_fused":
            np.testing.assert_array_max_ulp(
                state.comp_state.numpy(), np.asarray(jstate.comp_state), 1)


def test_fold_lr_trajectory_at_config2_hyperparameters():
    """lr 0.1 (then 0.01), momentum 0.9, wd 5e-4, nesterov, fused path:
    within rtol 1e-5 / atol 1e-6 (the FMA contractions)."""
    for i, n, state, jstate, tm, jm in _fold_lr_steps("gaussian_fused",
                                                      CONFIG2):
        for port, ref in ((state.params[:n], ravel_pytree(jstate.params)[0]),
                          (state.opt_state["trace"][:n],
                           ravel_pytree(_trace(jstate))[0]),
                          (state.ef_residual, jstate.ef_residual)):
            np.testing.assert_allclose(port.detach().numpy(),
                                       np.asarray(ref), rtol=1e-5,
                                       atol=1e-6)
        assert int(state.opt_state["count"]) == _count(jstate)[0]
        if i < 5:
            assert float(tm.num_selected) == float(jm.num_selected)


# ------------------------------------------------------- trainer options

def _cfg(out_dir, run_id, **kw):
    base = dict(dnn="vgg16", batch_size=16, compressor="gaussian_fused",
                density=0.01, compress_warmup_steps=2, max_steps=6,
                save_every_steps=4, eval_every_epochs=0, lr=0.05,
                nesterov=True, fold_lr=True, sigma_scale=2.5,
                compute_dtype="float32", device="cpu",
                model_kwargs={"cfg": NARROW}, output_dir=str(out_dir),
                run_id=run_id)
    return TrainConfig(**{**base, **kw})


@pytest.mark.parametrize("nesterov,fold_lr,momentum,weight_decay,want", [
    (False, False, 0.9, 5e-4, FlatSGDM),
    (True, False, 0.9, 5e-4, OptaxSGD),
    (False, True, 0.9, 5e-4, OptaxSGD),
    (False, False, 0.0, 0.0, OptaxSGD),
    (False, False, 0.0, 5e-4, FlatSGDM)])
def test_trainer_picks_the_references_optimizer(
        tmp_path, nesterov, fold_lr, momentum, weight_decay, want):
    """``trainer.py:378-380``: the flat update only on a 1-D mesh without
    nesterov or fold_lr, and with momentum or weight decay."""
    t = Trainer(_cfg(tmp_path, "pick", nesterov=nesterov, fold_lr=fold_lr,
                     momentum=momentum, weight_decay=weight_decay,
                     max_steps=1))
    opt = t.ts.flat_opt or t.ts.optimizer
    assert type(opt) is want
    assert (t.ts.fold_lr is not None) == fold_lr
    if want is OptaxSGD:
        assert opt.lr_at(0) == (1.0 if fold_lr else t.schedule(0))
        assert opt.nesterov == nesterov
    rec = t.train(1)
    assert np.isfinite(rec["loss"])


def test_guard_skip_advances_the_optax_count(tmp_path):
    """On the optax path (nesterov) a skipped step advances the count and
    keeps the trace and the params bit for bit; the next step reads the
    learning rate at the new count."""
    t = Trainer(_cfg(tmp_path, "guard", fold_lr=False, max_steps=4,
                     compress_warmup_steps=1))
    t.train(1)
    assert int(t.state.opt_state["count"]) == 1
    before = {k: v.clone() for k, v in t.state.opt_state.items()}
    params = t.state.params.detach().clone()
    real = t.next_batch

    def poisoned():
        x, y = real()
        return torch.full_like(x, float("nan")), y
    t.next_batch = poisoned
    rec = t.train(1)
    assert rec["skipped"] == 1.0 and t.state.step == 2
    assert int(t.state.opt_state["count"]) == 2
    assert torch.equal(t.state.opt_state["trace"], before["trace"])
    assert torch.equal(t.state.params.detach(), params)
    t.next_batch = real
    assert t.train(1)["skipped"] == 0.0
    assert int(t.state.opt_state["count"]) == 3


@pytest.mark.parametrize("kw", [
    {},                                            # nesterov, fold_lr
    dict(nesterov=False, fold_lr=False, momentum=0.0, weight_decay=0.0)])
def test_optax_path_resume_is_bit_for_bit(tmp_path, kw):
    """A run resumed from its step-4 checkpoint repeats steps 5-6: losses,
    params, trace (or none at momentum 0), count, EF row, thresholds and
    BatchNorm statistics bit for bit."""
    t = Trainer(_cfg(tmp_path, "a", **kw))
    assert isinstance(t.ts.optimizer, OptaxSGD)
    t.train(6)
    losses = [r["loss"] for r in t.records]
    path = os.path.join(t.ckpt_dir, "step_00000004")
    assert ck.is_committed(path)
    shared = torch.load(os.path.join(path, "state.pt"), weights_only=True)
    assert int(shared["opt_state"]["count"]) == 4
    assert ("trace" in shared["opt_state"]) == bool(t.cfg.momentum)
    r = Trainer(_cfg(tmp_path, "b", resume=path, **kw))
    assert r.state.step == 4 and int(r.state.opt_state["count"]) == 4
    r.train(2)
    assert [x["loss"] for x in r.records] == losses[4:]
    for a, b in ((t.state.params, r.state.params),
                 (t.state.ef_residual, r.state.ef_residual),
                 (t.state.comp_state, r.state.comp_state),
                 (t.model.stats, r.model.stats),
                 *((t.state.opt_state[k], r.state.opt_state[k])
                   for k in t.state.opt_state)):
        assert torch.equal(a.detach(), b.detach())
    # a checkpoint of the other optimizer is refused
    with pytest.raises(RuntimeError, match="optimizer state"):
        Trainer(_cfg(tmp_path, "c", resume=path, nesterov=False,
                     fold_lr=False, momentum=0.9, weight_decay=5e-4))


# ---------------------------------------------------------- sigma_scale

@pytest.mark.parametrize("sigma_scale", [2.5, 1.7])
@pytest.mark.parametrize("dist", ["normal", "laplace"])
def test_threshold_estimate_with_sigma_scale(sigma_scale, dist):
    rng = np.random.default_rng(11)
    for n in (1000, 10_001, 100_003):
        x = getattr(rng, dist)(size=n).astype(np.float32) * np.float32(3e-3)
        x += np.float32(1e-4)
        tx, jx = torch.from_numpy(x), jnp.asarray(x)
        t = gaussian_threshold_estimate(tx, 0.001, sigma_scale)
        j = jgauss.gaussian_threshold_estimate(jx, 0.001, sigma_scale)
        moments_agree = (
            np.array_equal(_bits(tx.mean().numpy()), _bits(jnp.mean(jx)))
            and np.array_equal(_bits(tx.std(correction=0).numpy()),
                               _bits(jnp.std(jx))))
        if moments_agree:
            _same(t, j)
        else:
            np.testing.assert_array_max_ulp(t.numpy(), np.asarray(j), 2)
        # sigma_scale replaces the density's quantile
        assert float(t) != float(gaussian_threshold_estimate(tx, 0.001))


@pytest.mark.parametrize("name,density", [("gaussian", 0.001),
                                          ("gaussian_fused", 0.05)])
def test_selection_at_the_ports_threshold_matches_reference(name, density):
    """The registry binds ``sigma_scale``; the port's selection equals the
    reference's from the port's t0 (its bisection, mask and pack), bit for
    bit. ``gaussian_fused`` at density 0.05 is its warm fallback, whose
    cold call estimates."""
    rng = np.random.default_rng(5)
    x = (rng.laplace(size=50_000) * 1e-2).astype(np.float32)
    acc = torch.from_numpy(x)
    k = int(np.ceil(density * x.size))
    spec = get_compressor(name, density=density, sigma_scale=2.5)
    if spec.stateful:
        assert spec.name == "gaussian_fused(warm-fallback)"
        r, _ = spec.fn(acc, k, torch.zeros(()))
    else:
        r = spec.fn(acc, k)
    t0 = gaussian_threshold_estimate(acc, density, 2.5)
    jabs = jnp.abs(jnp.asarray(x))
    t = jbase.bisect_threshold(jabs, k, jnp.asarray(t0.numpy()))
    sent, val, nsel = jbase.select_by_mask(jnp.asarray(x), jabs > t, k)
    comp, residual = jbase.finish_pack(jnp.asarray(x), sent, val)
    _same(r.compressed.indices, comp.indices)
    _same(r.compressed.values, comp.values)
    _same(r.residual, residual)
    assert int(r.num_selected) == int(nsel)
    # the kernel path of gaussian_fused never estimates: sigma_scale is
    # bound and changes nothing, as in the reference
    assert spec.fn.keywords["sigma_scale"] == 2.5
    fused = get_compressor("gaussian_fused", density=0.001, sigma_scale=2.5)
    plain = get_compressor("gaussian_fused", density=0.001)
    st = torch.zeros(())
    a, _ = fused.fn(acc, 50, st)
    b, _ = plain.fn(acc, 50, st)
    assert torch.equal(a.compressed.indices, b.compressed.indices)


# ------------------------------------------------- dataset_kwargs, flags

def test_dataset_kwargs_reach_the_dataset(tmp_path):
    kw = {"synthetic_examples": 256, "augment": False}
    t = Trainer(_cfg(tmp_path, "ds", dataset_kwargs=kw, max_steps=1))
    assert t.train_ds.num_examples == 256 and t.train_ds.augment is None
    assert t.test_ds.num_examples == 256
    ref, _ = jmake_dataset("cifar10", None, train=True, batch_size=16, **kw)
    np.testing.assert_array_equal(t.train_ds.x, ref.arrays[0])
    assert np.isfinite(t.train(1)["loss"])


def test_new_flags_and_config_keys_parse(tmp_path):
    p = argparse.ArgumentParser()
    add_args(p)
    argv = ["--nesterov", "--fold-lr", "--sigma-scale", "2.5",
            "--dataset-kwargs", '{"synthetic_examples": 64}',
            "--ici-size", "2", "--dcn-size", "4"]
    cfg = from_args(p.parse_args(argv), argv)
    assert (cfg.nesterov, cfg.fold_lr, cfg.sigma_scale, cfg.dataset_kwargs,
            cfg.ici_size, cfg.dcn_size) == (
        True, True, 2.5, {"synthetic_examples": 64}, 2, 4)
    cfg = from_args(p.parse_args(["--no-nesterov"]), ["--no-nesterov"])
    assert (cfg.nesterov, cfg.fold_lr, cfg.sigma_scale, cfg.dataset_kwargs,
            cfg.ici_size, cfg.dcn_size) == (False, False, None, {}, 0, 0)
    path = tmp_path / "c.json"
    path.write_text(json.dumps({"dnn": "vgg16", "nesterov": True,
                                "fold_lr": True, "sigma_scale": 2.5,
                                "ici_size": 2, "dcn_size": 2,
                                "dataset_kwargs": {"augment": False}}))
    argv = ["--config", str(path), "--dcn-size", "1"]
    cfg = from_args(p.parse_args(argv), argv)
    assert (cfg.nesterov, cfg.fold_lr, cfg.sigma_scale, cfg.ici_size,
            cfg.dcn_size, cfg.dataset_kwargs) == (True, True, 2.5, 2, 1,
                                                  {"augment": False})
