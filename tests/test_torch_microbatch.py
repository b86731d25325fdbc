"""Microbatching (``--nsteps-update``) and gradient clipping (``--clip-norm``)
in the port's train step, against the reference's ``build_dp_train_step(...,
num_microbatches=2, clip_norm=c)``.

A narrow VGG and resnet20, both in f32 with dropout off (the two packages'
per-microbatch dropout draws cannot match), from the same flax weights and
batches, run a dense and a sparse step on a one-device mesh. The momentum
starts at zero and weight decay is off, so after the dense step it holds
the step's post-clip gradient exactly, in both packages. The loss and the
accuracy agree within 1e-6; the gradient is held by relative L2 (a ReLU
gate within f32 noise of zero opens differently in the two frameworks,
ROADMAP's standing differences); the post-clip norm is ``c`` in both within
1e-6 relative when the clip bites, and each package's own unclipped norm
when it does not. The port's EF bookkeeping stays exact on the sparse step.
A batch that does not split into equal microbatches raises in both
packages. At P = 2 the port's gloo processes match the reference's
2-device mesh.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from gaussiank_sgd_tpu.compressors.registry import get_compressor as jcomp
from gaussiank_sgd_tpu.models import get_model as jget_model
from gaussiank_sgd_tpu.parallel.bucketing import plan_for_params as jplan
from gaussiank_sgd_tpu.parallel.flat_opt import FlatSGDM as JFlatSGDM
from gaussiank_sgd_tpu.parallel.mesh import data_parallel_mesh, shard_batch
from gaussiank_sgd_tpu.parallel.trainstep import (_clip_by_global_norm as
                                                  jclip)
from gaussiank_sgd_tpu.parallel.trainstep import build_dp_train_step
from gaussiank_sgd_tpu.training.losses import make_loss_fn as jmake_loss
from gaussiank_sgd_torch import convert
from gaussiank_sgd_torch.compressors import decompress, get_compressor
from gaussiank_sgd_torch.models import get_model
from gaussiank_sgd_torch.parallel.bucketing import plan_for_params
from gaussiank_sgd_torch.parallel.flat_opt import FlatSGDM
from gaussiank_sgd_torch.parallel.trainstep import (DPTrainStep,
                                                    _clip_by_global_norm,
                                                    flat_numel)
from gaussiank_sgd_torch.training.losses import make_loss_fn
from test_torch_distributed import _spawn

NARROW = [8, "M", 8, "M", 16, "M", 16, "M", 16, "M"]
CASES = {"vgg": ("vgg16", dict(cfg=NARROW, dropout=0.0)),
         "resnet20": ("resnet20", {})}
# a small lr keeps resnet20's flipped-gate gradient gap (4.7e-3 relative
# L2 here) out of the second step's loss: at lr 0.01 it moved it by 9.7e-7
OPT = dict(lr=0.002, momentum=0.5, weight_decay=0.0)
CLIPS = {"bites": 1e-3, "idle": 1e4}
DENSITY = 0.01


def _rel(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _flax(case, seed=0):
    dnn, kw = CASES[case]
    spec = jget_model(dnn, "cifar10", num_classes=10, dtype=jnp.float32,
                      **{k: tuple(v) if isinstance(v, list) else v
                         for k, v in kw.items()})
    v = spec.module.init({"params": jax.random.PRNGKey(seed),
                          "dropout": jax.random.PRNGKey(seed)},
                         jnp.zeros((2, 32, 32, 3)), train=False)
    return (spec, jax.tree.map(np.asarray, v["params"]),
            jax.tree.map(np.asarray, v["batch_stats"]))


def _batches(n_steps, rows, seed=1):
    rng = np.random.default_rng(seed)
    return [(rng.normal(size=(rows, 32, 32, 3)).astype(np.float32),
             rng.integers(0, 10, size=rows).astype(np.int32))
            for _ in range(n_steps)]


def _reference(spec, params, stats, batches, kinds, clip, world=1):
    """The reference's losses, accs and post-dense-step momentum."""
    mesh = data_parallel_mesh(world)
    jts = build_dp_train_step(
        jmake_loss(spec), None, jcomp("gaussian_fused", density=DENSITY),
        jplan(params, DENSITY), mesh, num_microbatches=2, clip_norm=clip,
        flat_opt=JFlatSGDM(**OPT), wire="off")
    state = jts.init_state(jax.tree.map(jnp.asarray, params),
                           jax.random.PRNGKey(1),
                           model_state={"batch_stats": jax.tree.map(
                               jnp.asarray, stats)})
    out = {"loss": [], "acc": []}
    for kind, batch in zip(kinds, batches):
        fn = jts.dense_step if kind == "dense" else jts.sparse_step
        state, m = fn(state, shard_batch(mesh, batch))
        out["loss"].append(float(m.loss))
        out["acc"].append(float(m.aux["acc"]))
        if kind == "dense":
            out["g"] = np.asarray(state.opt_state["m"])
    return out


def _port_step(dnn, kw, params, stats, clip, n_micro=2):
    model = get_model(dnn, num_classes=10, dtype=torch.float32,
                      device="cpu", **kw).module
    plan = plan_for_params(model.param_layout, DENSITY)
    spec = get_compressor("gaussian_fused", density=DENSITY)
    model.pad_flat(flat_numel(spec, plan))
    convert.load_flax_variables(model, params, stats)
    ts = DPTrainStep(make_loss_fn(model), model.flat, {"stats": model.stats},
                     spec, plan, flat_opt=FlatSGDM(**OPT), wire="off",
                     num_microbatches=n_micro, clip_norm=clip)
    return ts, ts.init_state()


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("clip", list(CLIPS))
def test_microbatched_clipped_step_matches_reference(case, clip):
    c = CLIPS[clip]
    kinds = ["dense", "sparse"]
    spec, params, stats = _flax(case)
    batches = _batches(2, 8)
    ref = _reference(spec, params, stats, batches, kinds, c)
    ts, state = _port_step(*CASES[case], params, stats, c)
    n = ts.n_total
    readings = {}
    for i, (kind, (x, y)) in enumerate(zip(kinds, batches)):
        tb = (torch.from_numpy(x), torch.from_numpy(y))
        if kind == "sparse":
            g = ts.local_grads(state, tb)
            state.model_state["stats"].copy_(g.model_state_before["stats"])
            comp, residual, _, _ = ts.compress_phase(state, g.flat_g)
            assert torch.equal(decompress(comp, ts.ef_numel) + residual,
                               state.ef_residual + g.flat_g)
            assert not g.flat_g[n:].any()           # the pad stays zero
        fn = ts.dense_step if kind == "dense" else ts.sparse_step
        m = fn(state, tb)
        readings[f"loss_{i}"] = abs(float(m.loss) / ref["loss"][i] - 1)
        np.testing.assert_allclose(float(m.loss), ref["loss"][i], rtol=1e-6)
        np.testing.assert_allclose(float(m.aux["acc"]), ref["acc"][i],
                                   atol=1e-6)
        if kind == "dense":
            got = state.opt_state["m"][:n].numpy()
            readings["grad_rel_l2"] = _rel(got, ref["g"])
            # readings: vgg 1.7e-6, resnet20 4.7e-3 (one flipped gate)
            assert readings["grad_rel_l2"] < 1e-2
            norms = (np.linalg.norm(got.astype(np.float64)),
                     np.linalg.norm(ref["g"].astype(np.float64)))
            if clip == "bites":
                for norm in norms:
                    np.testing.assert_allclose(norm, c, rtol=1e-6)
            else:
                assert max(norms) < c
                np.testing.assert_allclose(norms[0], norms[1], rtol=1e-3)
    print(case, clip, readings)


def test_clip_by_global_norm_matches_reference():
    """The scale on the same vector: within 1e-6 relative (the norm sums in
    another order); a norm below the clip leaves the vector bit for bit;
    a non-finite entry makes every entry non-finite in both."""
    rng = np.random.default_rng(3)
    g = (rng.normal(size=50_001) * 1e-3).astype(np.float32)
    norm = float(np.linalg.norm(g.astype(np.float64)))
    for clip in (0.25 * norm, 0.9 * norm, 2.0 * norm):
        got = _clip_by_global_norm(torch.from_numpy(g), clip).numpy()
        want = np.asarray(jclip(jnp.asarray(g), clip))
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
        np.testing.assert_allclose(np.linalg.norm(got.astype(np.float64)),
                                   min(clip, norm), rtol=1e-6)
        if clip > norm:
            np.testing.assert_array_equal(got, g)
    g[7] = np.nan
    got = _clip_by_global_norm(torch.from_numpy(g), 1.0).numpy()
    assert np.isnan(got).all() and np.isnan(np.asarray(
        jclip(jnp.asarray(g), 1.0))).all()


def test_indivisible_batch_raises_in_both():
    spec, params, stats = _flax("vgg")
    (x, y), = _batches(1, 6)
    ts, state = _port_step(*CASES["vgg"], params, stats, None, n_micro=4)
    with pytest.raises(ValueError, match="nsteps_update=4"):
        ts.local_grads(state, (torch.from_numpy(x), torch.from_numpy(y)))
    with pytest.raises(ValueError, match="nsteps_update=4"):
        mesh = data_parallel_mesh(1)
        jts = build_dp_train_step(
            jmake_loss(spec), None, jcomp("gaussian_fused", density=DENSITY),
            jplan(params, DENSITY), mesh, num_microbatches=4,
            flat_opt=JFlatSGDM(**OPT))
        jstate = jts.init_state(jax.tree.map(jnp.asarray, params),
                                jax.random.PRNGKey(1),
                                model_state={"batch_stats": jax.tree.map(
                                    jnp.asarray, stats)})
        jts.dense_step(jstate, shard_batch(mesh, (x, y)))


def test_one_microbatch_is_the_plain_step():
    """``num_microbatches=1`` and no clip compute what the step computed
    before either existed: the same bits as a direct forward and
    backward."""
    _, params, stats = _flax("vgg")
    (x, y), = _batches(1, 8)
    tb = (torch.from_numpy(x), torch.from_numpy(y))
    ts, state = _port_step(*CASES["vgg"], params, stats, None, n_micro=1)
    before = state.model_state["stats"].clone()
    g = ts.local_grads(state, tb)
    state.model_state["stats"].copy_(before)
    loss, _ = ts.loss_fn(tb)
    (want,) = torch.autograd.grad(loss, state.params)
    assert torch.equal(g.flat_g, want) and torch.equal(g.loss,
                                                       loss.detach())


def _w_micro(rank, world, params, stats, batches, kinds, clip, density, opt,
             narrow):
    from gaussiank_sgd_torch import convert
    from gaussiank_sgd_torch.compressors import get_compressor
    from gaussiank_sgd_torch.models import get_model
    from gaussiank_sgd_torch.parallel.bucketing import plan_for_params
    from gaussiank_sgd_torch.parallel.flat_opt import FlatSGDM
    from gaussiank_sgd_torch.parallel.mesh import shard_batch
    from gaussiank_sgd_torch.parallel.trainstep import DPTrainStep, flat_numel
    from gaussiank_sgd_torch.training.losses import make_loss_fn
    model = get_model("vgg16", num_classes=10, dtype=torch.float32,
                      cfg=narrow, dropout=0.0, device="cpu").module
    plan = plan_for_params(model.param_layout, density)
    spec = get_compressor("gaussian_fused", density=density)
    model.pad_flat(flat_numel(spec, plan))
    convert.load_flax_variables(model, params, stats)
    ts = DPTrainStep(make_loss_fn(model), model.flat, {"stats": model.stats},
                     spec, plan, flat_opt=FlatSGDM(**opt), wire="off",
                     num_microbatches=2, clip_norm=clip)
    state = ts.init_state()
    out = {"loss": [], "acc": []}
    for kind, batch in zip(kinds, batches):
        x, y = shard_batch(batch, rank, world)
        tb = (torch.from_numpy(x.copy()), torch.from_numpy(y.copy()))
        fn = ts.dense_step if kind == "dense" else ts.sparse_step
        m = fn(state, tb)
        out["loss"].append(float(m.loss))
        out["acc"].append(float(m.aux["acc"]))
        if kind == "dense":
            out["g"] = state.opt_state["m"][:ts.n_total].numpy().copy()
    out["params"] = state.params.detach().numpy().copy()
    return out


def test_two_workers_match_reference(tmp_path):
    """P = 2 over gloo against the reference's 2-device mesh, 2
    microbatches a worker and the clip biting: the worker-mean loss and
    accuracy, the averaged post-clip gradient, and both ranks' parameters
    bit-identical."""
    world, c, kinds = 2, CLIPS["bites"], ["dense", "sparse"]
    spec, params, stats = _flax("vgg")
    batches = _batches(2, 16)
    outs = _spawn(tmp_path, world, _w_micro, params=params, stats=stats,
                  batches=batches, kinds=kinds, clip=c, density=DENSITY,
                  opt=OPT, narrow=NARROW)
    ref = _reference(spec, params, stats, batches, kinds, c, world=world)
    for out in outs:
        np.testing.assert_allclose(out["loss"], ref["loss"], rtol=1e-6)
        np.testing.assert_allclose(out["acc"], ref["acc"], atol=1e-6)
        assert _rel(out["g"], ref["g"]) < 1e-2
        np.testing.assert_array_equal(out["params"], outs[0]["params"])
    # the mean of two gradients each clipped to c
    assert np.linalg.norm(ref["g"].astype(np.float64)) <= c * (1 + 1e-6)
