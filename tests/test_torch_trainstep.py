"""Parity of the port's train step (gaussiank_sgd_torch/parallel/trainstep.py)
with the reference's ``build_dp_train_step`` on a one-device mesh.

1. An injected flat gradient (the loss ``sum(p * G)`` has gradient exactly
   ``G`` in both frameworks) drives a dense step, a cold and a warm sparse
   step, and a guard-skipped step through the FlatSGDM path with weight
   decay and the non-finite guard on. Residual, thresholds, momentum and
   params are compared bit for bit. The hyper-parameters are powers of two
   so every product of the update is exact: XLA on the CPU contracts
   ``a * b + c`` into fused multiply-adds (the port rounds each operation,
   on the CPU and on the card alike), and with exact products the two
   agree to the bit. The warm step's next threshold goes through XLA's own
   f32 ``pow`` and is held to 1 ulp. The same steps run on the legacy
   (i32, f32) wire of the whole-model bucket and on the packed u16|bf16
   wire of a uniform 65,536-element plan, whose bf16 rounding the EF row
   absorbs.
2. A narrow VGG (f32, dropout off) from the same flax weights runs 1 dense
   and 3 sparse steps in both packages; losses agree within rtol 1e-4
   (convolution sums in another order; a selection can flip at the
   threshold under that noise), and the port's EF bookkeeping is exact on
   every sparse step.
3. The unfused path: ``compress_buckets`` against the reference's over a
   single-bucket, a greedy multi-bucket and a uniform plan, and unfused
   sparse steps on an injected gradient, bitwise but for the warm
   thresholds (XLA's f32 ``pow``, 2 ulp) and the Gaussian estimate's
   summation order (which the tests below show does not move a selection
   at these inputs).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.flatten_util import ravel_pytree

from gaussiank_sgd_tpu.compressors.registry import get_compressor as jcomp
from gaussiank_sgd_tpu.models import get_model as jget_model
from gaussiank_sgd_tpu.parallel.bucketing import plan_for_params as jplan
from gaussiank_sgd_tpu.parallel.flat_opt import FlatSGDM as JFlatSGDM
from gaussiank_sgd_tpu.parallel.mesh import data_parallel_mesh, shard_batch
from gaussiank_sgd_tpu.parallel.trainstep import build_dp_train_step
from gaussiank_sgd_tpu.parallel.trainstep import \
    compress_buckets as jcompress_buckets
from gaussiank_sgd_tpu.training.losses import make_loss_fn as jmake_loss
from gaussiank_sgd_torch import convert
from gaussiank_sgd_torch.compressors import decompress, get_compressor
from gaussiank_sgd_torch.models import get_model
from gaussiank_sgd_torch.parallel.bucketing import (make_bucket_plan,
                                                    plan_for_params)
from gaussiank_sgd_torch.parallel.flat_opt import FlatSGDM
from gaussiank_sgd_torch.parallel.trainstep import (DPTrainStep,
                                                    compress_buckets,
                                                    flat_numel)
from gaussiank_sgd_torch.training.losses import make_loss_fn

SHAPES = {"a": (300, 200), "b": (40_001,)}       # ravel order: a, then b


def _bits(a):
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


def _same(port, ref):
    port = port.detach().numpy() if isinstance(port, torch.Tensor) else port
    np.testing.assert_array_equal(_bits(port), _bits(np.asarray(ref)))


def _jax_flat(tree):
    return np.asarray(ravel_pytree(tree)[0])


def _injected_steps(bucket, wire):
    """Dense, cold sparse, warm sparse and guard-skipped steps of the fused
    path on an injected gradient, port against reference, bit for bit."""
    density = 0.001
    opt = dict(lr=2.0 ** -4, momentum=0.5, weight_decay=2.0 ** -11)
    rng = np.random.default_rng(0)
    p0 = {k: rng.normal(size=s).astype(np.float32)
          for k, s in SHAPES.items()}
    grads = [{k: rng.normal(size=s).astype(np.float32)
              for k, s in SHAPES.items()} for _ in range(4)]
    grads[3]["b"][17] = np.nan                    # the guard's step

    def jloss(p, mstate, batch, rng_):
        loss = sum(jnp.sum(p[k] * batch[k][0]) for k in SHAPES)
        return loss, (mstate, {})

    mesh = data_parallel_mesh(1)
    jspec = jcomp("gaussian_fused", density=density)
    plan = jplan(p0, density, **bucket)
    jts = build_dp_train_step(jloss, None, jspec, plan, mesh,
                              flat_opt=JFlatSGDM(**opt), wire=wire)
    jstate = jts.init_state(jax.tree.map(jnp.asarray, p0),
                            jax.random.PRNGKey(0))

    tplan = make_bucket_plan([int(np.prod(s)) for s in SHAPES.values()],
                             density, **bucket)
    assert tplan == plan
    tspec = get_compressor("gaussian_fused", density=density)
    n, n_pad = tplan.total_numel, flat_numel(tspec, tplan)
    assert n_pad == jts.ef_numel > n

    def padded(flat):            # the port's flat vectors carry a zero pad
        return torch.from_numpy(np.pad(flat, (0, n_pad - n)))

    params = torch.nn.Parameter(padded(_jax_flat(p0)))
    ts = DPTrainStep(lambda g: ((params * g).sum(), {}), params, {}, tspec,
                     tplan, flat_opt=FlatSGDM(**opt), wire=wire)
    assert ts.ef_numel == n_pad and ts.fused_ef is not None
    assert ts.wire_format == jts.wire_format
    state = ts.init_state()

    kinds = ["dense", "sparse", "sparse", "sparse"]
    for i, (kind, g) in enumerate(zip(kinds, grads)):
        jb = shard_batch(mesh, {k: v[None] for k, v in g.items()})
        jfn = jts.dense_step if kind == "dense" else jts.sparse_step
        jstate, jm = jfn(jstate, jb)
        tfn = ts.dense_step if kind == "dense" else ts.sparse_step
        tm = tfn(state, padded(_jax_flat(g)))
        assert state.step == int(jstate.step) == i + 1
        _same(state.params[:n], _jax_flat(jstate.params))
        _same(state.opt_state["m"][:n], jstate.opt_state["m"])
        for pad in (state.params[n:], state.opt_state["m"][n:]):
            assert not pad.any()
        _same(state.ef_residual, jstate.ef_residual)
        assert float(tm.skipped) == float(jm.skipped) == (1.0 if i == 3
                                                          else 0.0)
        assert float(tm.nonfinite) == float(jm.nonfinite)
        assert tm.bytes_sent == float(jm.bytes_sent)
        if i < 3:
            assert float(tm.num_selected) == float(jm.num_selected)
        if i == 2 or i == 3:      # after a warm update: XLA's f32 pow
            np.testing.assert_array_max_ulp(
                state.comp_state.numpy(), np.asarray(jstate.comp_state), 1)
        else:
            _same(state.comp_state, jstate.comp_state)
    return ts, state, padded(_jax_flat(grads[0]))


def test_injected_gradient_step_matches_reference_bitwise():
    ts, _, _ = _injected_steps({}, "off")
    assert ts.wire_format == "i32f32"


def test_injected_gradient_step_on_the_packed_wire_matches_reference():
    """The same steps on a uniform 65,536-element plan with ``wire="auto"``:
    the select pass's words (``pack_wire_words``), the decode, and the EF
    row absorbing the bf16 rounding, bit for bit; then the EF invariant of
    one more step against the decoded values, exact."""
    ts, state, g = _injected_steps(dict(bucket_size=65_536,
                                        policy="uniform"), "auto")
    assert ts.wire_format == "u16bf16" and ts.fused_ef == (2, 65_536, 65_536)
    acc = state.ef_residual + g
    payload, residual, _, _ = ts.pack_phase(state, g)
    assert len(payload) == 1 and payload[0].dtype == torch.int32
    sent = ts.unpack(payload, workers=1)
    assert torch.equal(decompress(sent, ts.ef_numel) + residual, acc)
    comp, residual_pre, _, _ = ts.compress_phase(state, g)
    assert not torch.equal(residual_pre, residual)   # the rounding moved
    with pytest.raises(ValueError, match="wire"):
        DPTrainStep(lambda b: (b.sum(), {}), state.params, {}, ts.spec,
                    ts.plan, flat_opt=ts.flat_opt, wire="on")


NARROW = [8, "M", 8, "M", 16, "M", 16, "M", 16, "M"]


def _narrow_vgg_trajectory(density, batch, opt, kinds,
                           compressor="gaussian_fused"):
    """Losses of the port and of the reference over ``kinds`` steps of a
    narrow VGG from the same flax weights and batches."""
    spec = jget_model("vgg16", "cifar10", num_classes=10, dtype=jnp.float32,
                      cfg=tuple(NARROW), dropout=0.0)
    v = spec.module.init({"params": jax.random.PRNGKey(0),
                          "dropout": jax.random.PRNGKey(0)},
                         jnp.zeros((2, 32, 32, 3)), train=False)
    params = jax.tree.map(np.asarray, v["params"])
    stats = jax.tree.map(np.asarray, v["batch_stats"])
    mesh = data_parallel_mesh(1)
    plan = jplan(params, density)
    jts = build_dp_train_step(jmake_loss(spec), None,
                              jcomp(compressor, density=density),
                              plan, mesh, flat_opt=JFlatSGDM(**opt),
                              wire="off")
    jstate = jts.init_state(jax.tree.map(jnp.asarray, params),
                            jax.random.PRNGKey(1),
                            model_state={"batch_stats": jax.tree.map(
                                jnp.asarray, stats)})

    model = get_model("vgg16", num_classes=10, dtype=torch.float32,
                      cfg=NARROW, dropout=0.0, device="cpu").module
    tplan = plan_for_params(model.param_layout, density)
    assert tplan == plan
    tspec = get_compressor(compressor, density=density)
    model.pad_flat(flat_numel(tspec, tplan))
    convert.load_flax_variables(model, params, stats)
    ts = DPTrainStep(make_loss_fn(model), model.flat,
                     {"stats": model.stats}, tspec, tplan,
                     flat_opt=FlatSGDM(**opt), wire="off")
    state = ts.init_state()

    rng = np.random.default_rng(1)
    losses = []
    for i, kind in enumerate(kinds):
        x = rng.normal(size=(batch, 32, 32, 3)).astype(np.float32)
        y = rng.integers(0, 10, size=batch).astype(np.int32)
        jfn = jts.dense_step if kind == "dense" else jts.sparse_step
        jstate, jm = jfn(jstate, shard_batch(mesh, (x, y)))
        tb = (torch.from_numpy(x), torch.from_numpy(y))
        if kind == "sparse":
            # the EF invariant of this step, exact, before committing it
            g = ts.local_grads(state, tb)
            assert g.flat_g.shape == (ts.ef_numel,)
            assert not g.flat_g[ts.n_total:].any()
            state.model_state["stats"].copy_(
                g.model_state_before["stats"])
            comp, residual, _, _ = ts.compress_phase(state, g.flat_g)
            acc = state.ef_residual + g.flat_g
            assert torch.equal(decompress(comp, ts.ef_numel) + residual, acc)
        tfn = ts.dense_step if kind == "dense" else ts.sparse_step
        tm = tfn(state, tb)
        losses.append((float(tm.loss), float(jm.loss)))
        np.testing.assert_allclose(float(tm.loss), float(jm.loss),
                                   rtol=1e-4)
        assert state.step == i + 1
    np.testing.assert_allclose(
        model.stats.numpy(),
        convert.flatten_tree(jax.tree.map(
            np.asarray, jstate.model_state["batch_stats"]),
            model.stats_layout), rtol=1e-3, atol=1e-4)
    return losses


def test_narrow_vgg_trajectory_matches_reference():
    _narrow_vgg_trajectory(0.01, 16, dict(lr=0.05, momentum=0.9,
                                          weight_decay=5e-4),
                           ["dense"] + ["sparse"] * 3)


def test_narrow_vgg_trajectory_at_config2_hyperparameters():
    """Config 2's optimizer (lr 0.1 with no warm-up at one worker, momentum
    0.9, wd 5e-4, density 0.001) and its smoke schedule, 2 dense + 4 sparse
    steps: the port follows the reference's losses, whatever their course."""
    losses = _narrow_vgg_trajectory(0.001, 32, dict(
        lr=0.1, momentum=0.9, weight_decay=5e-4),
        ["dense"] * 2 + ["sparse"] * 4)
    print("port, reference losses:", losses)


def test_narrow_vgg_trajectory_with_config2_gaussian():
    """The same with config 2's own compressor, ``gaussian``, on the
    unfused path."""
    losses = _narrow_vgg_trajectory(0.001, 32, dict(
        lr=0.1, momentum=0.9, weight_decay=5e-4),
        ["dense"] * 2 + ["sparse"] * 4, "gaussian")
    print("port, reference losses:", losses)


def test_unported_paths_raise():
    """What the reference refuses, the port refuses with its reasons: the
    flat optimizer on a two-level mesh or under ``fold_lr``, the gtopk
    exchange on a two-level mesh, and two optimizers or none; a trainer
    whose ``nworkers`` is not the world size raises. Every
    bucket plan builds: a uniform plan whose chunks are not block-aligned
    takes the unfused path, where gaussian_fused's batched form (kernel B2)
    runs per chunk; a flat parameter of the wrong size is refused; a
    block-aligned uniform plan keeps the fused path."""
    from gaussiank_sgd_torch.parallel.flat_opt import OptaxSGD
    from gaussiank_sgd_torch.parallel.mesh import hierarchical_dp_mesh
    from gaussiank_sgd_torch.training.config import TrainConfig
    from gaussiank_sgd_torch.training.trainer import Trainer
    with pytest.raises(ValueError, match="world size is 1"):
        Trainer(TrainConfig(nworkers=2, device="cpu"))
    density = 0.001
    p = torch.nn.Parameter(torch.zeros(300_000))
    spec = get_compressor("gaussian_fused", density=density)
    opt = FlatSGDM(lr=0.1)
    two_level = hierarchical_dp_mesh(1, 1)       # (dcn_dp, ici_dp), 1 x 1
    args = (lambda b: ((p * b).sum(), {}), p, {},
            get_compressor("gaussian", density=density),
            make_bucket_plan([300_000], density))
    for kw in (dict(flat_opt=opt, mesh=two_level),
               dict(flat_opt=opt, fold_lr=lambda s: 0.1)):
        with pytest.raises(ValueError, match="flat_opt supports 1-D meshes "
                                             "without fold_lr"):
            DPTrainStep(*args, **kw)
    with pytest.raises(ValueError, match="1-D dp meshes only"):
        DPTrainStep(*args, optimizer=OptaxSGD(lr=0.1), mesh=two_level,
                    exchange="gtopk")
    for kw in ({}, dict(flat_opt=opt, optimizer=OptaxSGD(lr=0.1))):
        with pytest.raises(ValueError, match="exactly one optimizer"):
            DPTrainStep(*args, **kw)
    assert DPTrainStep(*args, optimizer=OptaxSGD(lr=0.1),
                       mesh=two_level).mesh.names == ("dcn_dp", "ici_dp")
    plan = make_bucket_plan([300_000], density, 100_000, policy="uniform")
    ts = DPTrainStep(lambda b: ((p * b).sum(), {}), p, {}, spec, plan,
                     flat_opt=opt)
    assert ts.fused_ef is None and ts.ef_numel == 300_000
    state = ts.init_state()
    m = ts.sparse_step(state, torch.from_numpy(np.random.default_rng(
        1).normal(size=300_000).astype(np.float32)))
    assert float(m.num_selected) == 3 * 100           # cold: k per chunk
    assert (state.comp_state > 0).all()
    with pytest.raises(ValueError):
        DPTrainStep(lambda b: (p.sum(), {}), p, {}, spec,
                    make_bucket_plan([10], density), flat_opt=opt)
    # a block-aligned uniform plan takes the fused path, chunk by chunk
    aligned = make_bucket_plan([3 * 131_072], density, 131_072,
                               policy="uniform")
    q = torch.nn.Parameter(torch.zeros(3 * 131_072))
    ts = DPTrainStep(lambda b: ((q * b).sum(), {}), q, {}, spec, aligned,
                     flat_opt=opt)
    assert ts.fused_ef == (3, 131_072, 131_072)
    state = ts.init_state()
    g = torch.from_numpy(np.random.default_rng(0).normal(
        size=3 * 131_072).astype(np.float32))
    m = ts.sparse_step(state, g)
    assert state.comp_state.shape == (1, 3)
    assert float(m.num_selected) == 3 * 132        # cold: k per chunk


# ------------------------------------------------------- the unfused path

BUCKET_SIZES = [60_000, 3_000, 40_001, 900, 25_000]
PLANS = {"single": dict(), "greedy": dict(bucket_size=30_000),
         "uniform": dict(bucket_size=25_000, policy="uniform")}


@pytest.mark.parametrize("plan_kind", list(PLANS))
@pytest.mark.parametrize("compressor",
                         ["gaussian", "gaussian_warm", "gaussian_pallas"])
def test_compress_buckets_matches_reference(plan_kind, compressor):
    """Pairs with global indices, residual and per-bucket counts bit for
    bit; gaussian_warm runs a cold and then a warm call, and its thresholds
    are held to 2 ulp (XLA's f32 pow)."""
    density = 0.01
    plan = make_bucket_plan(BUCKET_SIZES, density, **PLANS[plan_kind])
    jplan_ = jplan({f"p{i}": np.zeros(s, np.float32)
                    for i, s in enumerate(BUCKET_SIZES)}, density,
                   **({"bucket_size": PLANS[plan_kind]["bucket_size"],
                       "policy": PLANS[plan_kind].get("policy", "greedy")}
                      if PLANS[plan_kind] else {}))
    assert plan == jplan_
    spec, jspec = (get_compressor(compressor, density=density),
                   jcomp(compressor, density=density))
    rng = np.random.default_rng(8)
    nb = len(plan.buckets)
    jst = np.zeros(nb, np.float32) if spec.stateful else None
    tst = torch.zeros(nb) if spec.stateful else None
    for _ in range(2 if spec.stateful else 1):
        acc = (rng.normal(size=plan.total_numel) * 0.01).astype(np.float32)
        jcomp_, jres, jnsel, jst_new = jcompress_buckets(
            jspec, plan, jnp.asarray(acc), jax.random.PRNGKey(0),
            jnp.asarray(jst) if spec.stateful else ())
        comp, res, nsel, tst_new = compress_buckets(
            spec, plan, torch.from_numpy(acc.copy()), tst)
        _same(comp.indices, jcomp_.indices)
        _same(comp.values, jcomp_.values)
        _same(res, jres)
        _same(nsel, jnsel)
        assert torch.equal(decompress(comp, plan.total_numel) + res,
                           torch.from_numpy(acc))
        if spec.stateful:
            np.testing.assert_array_max_ulp(tst_new.numpy(),
                                            np.asarray(jst_new), 2)
            jst, tst = np.asarray(jst_new), tst_new
        else:
            assert tst_new is None


@pytest.mark.parametrize("compressor,plan_kw", [
    ("gaussian", {}),
    ("gaussian_warm", dict(bucket_size=30_000, policy="uniform")),
    ("gaussian_pallas", dict(bucket_size=50_000)),
])
def test_unfused_steps_match_reference(compressor, plan_kw):
    """One dense and two sparse steps of the unfused path on an injected
    gradient against ``build_dp_train_step``, with power-of-two
    hyper-parameters (exact products, see the module docstring): params,
    momentum, EF row and counts bit for bit; warm thresholds within 2 ulp."""
    density = 0.01
    opt = dict(lr=2.0 ** -4, momentum=0.5, weight_decay=2.0 ** -11)
    rng = np.random.default_rng(9)
    p0 = {k: rng.normal(size=s).astype(np.float32)
          for k, s in SHAPES.items()}
    grads = [{k: (rng.normal(size=s) * 0.1).astype(np.float32)
              for k, s in SHAPES.items()} for _ in range(3)]

    def jloss(p, mstate, batch, rng_):
        return sum(jnp.sum(p[k] * batch[k][0]) for k in SHAPES), (mstate, {})

    mesh = data_parallel_mesh(1)
    plan = jplan(p0, density, **plan_kw)
    jts = build_dp_train_step(jloss, None, jcomp(compressor, density=density),
                              plan, mesh, flat_opt=JFlatSGDM(**opt),
                              wire="off", overlap="off")
    jstate = jts.init_state(jax.tree.map(jnp.asarray, p0),
                            jax.random.PRNGKey(0))
    tplan = make_bucket_plan([int(np.prod(s)) for s in SHAPES.values()],
                             density, **plan_kw)
    assert tplan == plan
    tspec = get_compressor(compressor, density=density)
    params = torch.nn.Parameter(torch.from_numpy(_jax_flat(p0).copy()))
    ts = DPTrainStep(lambda g: ((params * g).sum(), {}), params, {}, tspec,
                     tplan, flat_opt=FlatSGDM(**opt), wire="off")
    assert ts.fused_ef is None and ts.ef_numel == tplan.total_numel
    state = ts.init_state()
    for i, (kind, g) in enumerate(zip(["dense", "sparse", "sparse"], grads)):
        jb = shard_batch(mesh, {k: v[None] for k, v in g.items()})
        jfn = jts.dense_step if kind == "dense" else jts.sparse_step
        jstate, jm = jfn(jstate, jb)
        tfn = ts.dense_step if kind == "dense" else ts.sparse_step
        tm = tfn(state, torch.from_numpy(_jax_flat(g).copy()))
        _same(state.params, _jax_flat(jstate.params))
        _same(state.opt_state["m"], jstate.opt_state["m"])
        _same(state.ef_residual, jstate.ef_residual)
        assert float(tm.num_selected) == float(jm.num_selected)
        if tspec.stateful:
            np.testing.assert_array_max_ulp(
                state.comp_state.numpy(), np.asarray(jstate.comp_state), 2)
        else:
            assert state.comp_state is None
