"""Parity of the port's ResNets (gaussiank_sgd_torch/models/resnet.py), its
flat-parameter base (models/flat.py) and its weight transfer (convert.py)
with the reference's flax CifarResNet and ResNet50.

The reference's weights go through numpy into the port. Forward, loss,
logits in train and eval mode, and the updated BatchNorm statistics are
compared in f32 at rtol 1e-4 / atol 1e-5 (the two frameworks sum
convolutions in another order), on resnet20 at full width and on ResNet-50
at full width with one block a stage. The flat gradient (in the reference's
``ravel_pytree`` order) is held by relative L2 error: where a ReLU's input
lies within the f32 noise of zero the two frameworks open different gates,
and that one element's change spreads into every earlier layer's gradient.
On resnet20's inputs here one gate flips (``BasicBlock_3/BatchNorm_0``,
|z| = 3e-6 against activations that agree to 3e-6) and moves the earlier
leaves by up to 2.8e-3; with the same activations both packages' block
gradients agree with an f64 evaluation to 1e-6.
"""

import json
import pathlib

import numpy as np
import jax
import jax.numpy as jnp
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
from gaussiank_sgd_tpu.training.losses import IMAGENET_NORM as JNORM
from gaussiank_sgd_tpu.training.losses import make_loss_fn as jmake_loss
from gaussiank_sgd_torch import convert
from gaussiank_sgd_torch.compressors import decompress, get_compressor
from gaussiank_sgd_torch.models import get_model
from gaussiank_sgd_torch.models.flat import FlatModel
from gaussiank_sgd_torch.models.resnet import CifarResNet, ResNet50
from gaussiank_sgd_torch.parallel.bucketing import plan_for_params
from gaussiank_sgd_torch.parallel.flat_opt import FlatSGDM
from gaussiank_sgd_torch.parallel.trainstep import DPTrainStep, flat_numel
from gaussiank_sgd_torch.training.losses import IMAGENET_NORM, make_loss_fn

TOL = dict(rtol=1e-4, atol=1e-5)
CONFIG1 = str(pathlib.Path(__file__).resolve().parents[1] / "exp_configs"
              / "config1_resnet20_cifar10_dense.json")
# (dnn, dataset, model kwargs, input shape NHWC, classes)
CASES = {
    "resnet20": ("resnet20", "cifar10", {}, (4, 32, 32, 3), 10),
    "resnet50_1111": ("resnet50", "imagenet", {"stage_sizes": (1, 1, 1, 1)},
                      (8, 64, 64, 3), 10),
}


def _paths(tree):
    return [("/".join(k.key for k in path), tuple(leaf.shape))
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]]


@pytest.mark.parametrize("dnn,n_params,n_stats", [
    ("resnet20", 269_722, 1_376), ("resnet32", 464_154, 2_272),
    ("resnet50", 25_557_032, 53_120)])
def test_layout_is_flax_ravel_order(dnn, n_params, n_stats):
    """Every leaf in the reference's ravel order, path for path and shape
    for shape: keys sort as strings at every level, so resnet32 puts
    BasicBlock_10 before BasicBlock_2 and ResNet-50 puts BottleneckBlock_10
    before BottleneckBlock_2."""
    spec = jget_model(dnn, "imagenet" if dnn == "resnet50" else "cifar10")
    x = jnp.zeros((2,) + spec.input_shape)
    v = jax.eval_shape(lambda: spec.module.init(
        {"params": jax.random.PRNGKey(0)}, x, train=False))
    m = (ResNet50(device=torch.device("meta")) if dnn == "resnet50" else
         CifarResNet(int(dnn[6:]), device=torch.device("meta")))
    assert m.param_layout == _paths(v["params"])
    assert m.stats_layout == _paths(v["batch_stats"])
    assert (m.n_params, m.stats.numel()) == (n_params, n_stats)
    order = [p for p, _ in m.param_layout]
    block = "BottleneckBlock" if dnn == "resnet50" else "BasicBlock"
    if dnn != "resnet20":
        assert (order.index(f"{block}_10/Conv_0/kernel")
                < order.index(f"{block}_2/Conv_0/kernel"))
    if dnn == "resnet50":
        assert order[:3] == ["BatchNorm_0/bias", "BatchNorm_0/scale",
                             "BottleneckBlock_0/BatchNorm_0/bias"]


def _perturbed(tree, rng, stats=False):
    """Non-trivial BatchNorm leaves (every block's scale away from 0 and
    1), at any depth of the tree."""
    def leaf(path, a):
        key = path[-1].key
        if key == "scale":
            return (1 + 0.1 * rng.normal(size=a.shape)).astype(np.float32)
        if key == "bias" and path[-2].key.startswith("BatchNorm"):
            return (0.1 * rng.normal(size=a.shape)).astype(np.float32)
        if stats and key == "var":
            return rng.uniform(0.5, 2.0, a.shape).astype(np.float32)
        if stats and key == "mean":
            return (0.1 * rng.normal(size=a.shape)).astype(np.float32)
        return np.asarray(a)
    return jax.tree_util.tree_map_with_path(leaf, tree)


def _flax_case(case, seed, dtype=jnp.float32):
    dnn, dataset, kw, shape, nc = CASES[case]
    spec = jget_model(dnn, dataset, num_classes=nc, dtype=dtype, **kw)
    v = spec.module.init({"params": jax.random.PRNGKey(seed)},
                         jnp.zeros((2,) + shape[1:]), train=False)
    rng = np.random.default_rng(seed)
    return (spec, _perturbed(v["params"], rng),
            _perturbed(v["batch_stats"], rng, stats=True))


def _port_case(case, params, stats, dtype=torch.float32):
    dnn, dataset, kw, _, nc = CASES[case]
    m = get_model(dnn, dataset, num_classes=nc, dtype=dtype, device="cpu",
                  **kw).module
    convert.load_flax_variables(m, params, stats)
    return m


def _flax_run(spec, params, stats, x, y):
    def jloss(p):
        logits, upd = spec.module.apply(
            {"params": p, "batch_stats": stats}, jnp.asarray(x), train=True,
            mutable=["batch_stats"])
        loss = optax.softmax_cross_entropy_with_integer_labels(
            logits, jnp.asarray(y)).mean()
        return loss, (logits, upd["batch_stats"])

    (loss, (logits, new_stats)), grad = jax.value_and_grad(
        jloss, has_aux=True)(params)
    evals = spec.module.apply({"params": params, "batch_stats": stats},
                              jnp.asarray(x), train=False)
    return (float(loss), np.asarray(logits), np.asarray(ravel_pytree(grad)[0]),
            jax.tree.map(np.asarray, new_stats), np.asarray(evals))


def _rel(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _inputs(case, seed):
    shape, nc = CASES[case][3], CASES[case][4]
    rng = np.random.default_rng(seed)
    return (rng.normal(size=shape).astype(np.float32),
            rng.integers(0, nc, size=shape[0]).astype(np.int32))


@pytest.mark.parametrize("case", list(CASES))
def test_forward_grad_and_stats_match_flax(case):
    spec, params, stats = _flax_case(case, 2)
    x, y = _inputs(case, 3)
    jl, jlogits, jgrad, jstats, jeval = _flax_run(spec, params, stats, x, y)
    m = _port_case(case, params, stats)
    tl, aux = make_loss_fn(m)((torch.from_numpy(x), torch.from_numpy(y)))
    (tgrad,) = torch.autograd.grad(tl, m.flat)
    np.testing.assert_allclose(float(tl.detach()), jl, **TOL)
    # gradients by relative L2 error (see the module docstring; measured
    # 9.7e-4 overall and 2.8e-3 at worst a leaf on resnet20, 4.7e-3 and
    # 9.8e-3 on ResNet-50): a leaf in the wrong place or a wrong backward
    # is off by O(1)
    tgrad = tgrad.numpy()
    assert _rel(tgrad, jgrad) < 1e-2
    off = 0
    for path, shape in m.param_layout:
        n = int(np.prod(shape))
        assert _rel(tgrad[off:off + n], jgrad[off:off + n]) < 2e-2, path
        off += n
    np.testing.assert_allclose(tgrad[-n:], jgrad[-n:], **TOL)  # Dense_0
    np.testing.assert_allclose(
        m.stats.numpy(), convert.flatten_tree(jstats, m.stats_layout), **TOL)
    assert float(aux["acc"]) == float((jlogits.argmax(-1) == y).mean())
    m2 = _port_case(case, params, stats)
    np.testing.assert_allclose(
        m2(torch.from_numpy(x), train=False).detach().numpy(), jeval, **TOL)
    np.testing.assert_allclose(
        m2(torch.from_numpy(x), train=True).detach().numpy(), jlogits, **TOL)


@pytest.mark.parametrize("case", list(CASES))
def test_bf16_compute_casts_like_flax(case):
    """bf16 compute against flax's bf16 model on the same weights: convs in
    bf16, BatchNorm, the residual add, the pool and Dense_0 in f32. Both
    round to bf16 in their own order, and a rounding that flips spreads
    through the blocks (more in train mode, where it also moves the batch
    statistics, and most in the gradient), so values are held by relative
    L2 error against flax's own bf16-vs-f32 gap, which a cast left out or
    added would approach: eval logits within half of it (measured 0.19 and
    0.25 of it), train logits within 0.75 (0.47, 0.45) and the gradient
    within 0.9 (0.68, 0.65)."""
    spec, params, stats = _flax_case(case, 4, jnp.bfloat16)
    spec32 = _flax_case(case, 4)[0]
    x, y = _inputs(case, 5)
    jl, jlogits, jgrad, jstats, jeval = _flax_run(spec, params, stats, x, y)
    _, jlogits32, jgrad32, _, jeval32 = _flax_run(spec32, params, stats, x, y)
    m = _port_case(case, params, stats, torch.bfloat16)
    teval = m(torch.from_numpy(x), train=False)
    assert teval.dtype == torch.float32
    teval = teval.detach().numpy()
    np.testing.assert_allclose(teval, jeval, rtol=2e-2, atol=1e-2)
    tl, _ = make_loss_fn(m)((torch.from_numpy(x), torch.from_numpy(y)))
    (tgrad,) = torch.autograd.grad(tl, m.flat)
    m2 = _port_case(case, params, stats, torch.bfloat16)
    tlogits = m2(torch.from_numpy(x), train=True).detach().numpy()
    np.testing.assert_allclose(float(tl.detach()), jl, rtol=5e-3)
    np.testing.assert_allclose(
        m.stats.numpy(), convert.flatten_tree(jstats, m.stats_layout),
        rtol=1e-3, atol=1e-3)
    for got, want, want32, share in ((teval, jeval, jeval32, 0.5),
                                     (tlogits, jlogits, jlogits32, 0.75),
                                     (tgrad.numpy(), jgrad, jgrad32, 0.9)):
        assert _rel(got, want) < share * _rel(want, want32)


def test_init_is_flax_lecun_normal():
    """Fault 2 of the first slices: kernels are drawn from a normal
    truncated at +-2 and scaled by 1/(0.87962566 sqrt(fan_in)), as flax's
    lecun_normal; ResNet-50's last BatchNorm scale of each block starts at
    zero, the others at one."""
    m = FlatModel({"Conv_0/kernel": (3, 3, 256, 64)}, {}, torch.float32)
    m.reset_parameters(torch.Generator().manual_seed(0))
    w = m.leaves()["Conv_0/kernel"].detach().numpy()
    fan_in = 3 * 3 * 256
    assert abs(w.std() * np.sqrt(fan_in) - 1.0) < 0.02
    assert np.abs(w).max() * np.sqrt(fan_in) <= 2 / 0.87962566 + 1e-6
    assert np.abs(w).max() * np.sqrt(fan_in) > 2.2     # reaches the cut
    flax_w = np.asarray(jax.nn.initializers.lecun_normal()(
        jax.random.PRNGKey(0), (3, 3, 256, 64)))
    assert abs(w.std() - flax_w.std()) < 0.02 * flax_w.std()
    r = get_model("resnet50", device="cpu", stage_sizes=(1, 1, 1, 1)).module
    leaves = r.leaves()
    for path, leaf in leaves.items():
        if path.endswith("BatchNorm_2/scale"):
            assert not leaf.any(), path
        elif path.endswith("/scale"):
            assert bool((leaf == 1).all()), path
        elif path.endswith("/bias"):
            assert not leaf.any(), path
    assert sum(p.endswith("BatchNorm_2/scale") for p in leaves) == 4


def test_convert_three_level_tree():
    """Fault 1 of the first slices: the transfer takes paths of any depth,
    round-trips, and still refuses a missing, extra or misshaped leaf."""
    _, params, stats = _flax_case("resnet20", 1)
    m = _port_case("resnet20", params, stats)
    np.testing.assert_array_equal(m.flat.detach().numpy(),
                                  np.asarray(ravel_pytree(params)[0]))
    p2, s2 = convert.export_flax_variables(m)
    for a, b in ((params, p2), (stats, s2)):
        assert jax.tree.structure(a) == jax.tree.structure(b)
        for u, v in zip(jax.tree.leaves(a), jax.tree.leaves(b)):
            np.testing.assert_array_equal(u, v)
    bad = jax.tree.map(lambda a: a, params)
    bad["BasicBlock_3"].pop("Conv_1")
    with pytest.raises(ValueError, match="missing.*BasicBlock_3/Conv_1"):
        convert.flatten_tree(bad, m.param_layout)
    bad = jax.tree.map(lambda a: a, params)
    bad["BasicBlock_3"]["Conv_9"] = {"kernel": np.zeros(3, np.float32)}
    with pytest.raises(ValueError, match="extra.*BasicBlock_3/Conv_9"):
        convert.flatten_tree(bad, m.param_layout)
    bad = jax.tree.map(lambda a: a, params)
    bad["BasicBlock_3"]["Conv_1"]["kernel"] = np.zeros((3, 3, 16, 8))
    with pytest.raises(ValueError, match="BasicBlock_3/Conv_1/kernel: shape"):
        convert.flatten_tree(bad, m.param_layout)


def test_get_model_builds_the_resnet_family():
    with pytest.raises(RuntimeError, match="device='cpu'"):
        get_model("resnet20")                    # no GPU here
    for dnn, depth in (("resnet20", 20), ("resnet32", 32), ("resnet44", 44),
                       ("resnet56", 56), ("resnet110", 110)):
        spec = get_model(dnn, device="cpu")
        assert (spec.module.depth, spec.num_classes) == (depth, 10)
        assert len(spec.module.blocks) == (depth - 2) // 2
        assert spec.input_shape == (32, 32, 3)
    assert get_model("resnet20", "cifar100", device="cpu").num_classes == 100
    spec = get_model("resnet50", device="cpu", stage_sizes=(1, 1, 1, 1))
    assert spec.num_classes == 1000 and spec.input_shape == (224, 224, 3)
    assert spec.input_dtype == torch.float32
    with pytest.raises(ValueError, match="6n\\+2"):
        get_model("resnet21", device="cpu")
    with pytest.raises(NotImplementedError, match="A7"):
        get_model("mnistnet", device="cpu")
    a = get_model("resnet20", device="cpu", seed=3).module.flat
    b = get_model("resnet20", device="cpu", seed=3).module.flat
    assert torch.equal(a, b)


def _trajectory(case, compressor, kinds, batch, u8=False, seeds=(6, 7)):
    """Losses of the port and of the reference over ``kinds`` steps from
    the same flax weights and batches (uint8 pixels through each package's
    ImageNet normalisation when ``u8``), at rtol 1e-4 while both sent the
    same entries and 1e-3 after (an entry sent by one and not the other
    moves the loss by ~lr * |g_i|^2; read 3.8e-5 to 6.7e-4 over six seeds,
    2.1e-4 here). On every sparse step (fused EF path) the port's selection
    is held bit for bit against the reference's compressor on the port's
    own EF row, gradient and threshold: indices, values, residual and
    num_selected. The port's EF bookkeeping is held exact. Returns the
    step, the losses and the readings: each step's loss gap, the entries
    each sparse step sent in one trajectory and not the other, and the
    final BatchNorm statistics' largest gap.

    Between the two trajectories, entries near the threshold change sides
    under the gradient's gap (the module docstring's ReLU gates): on the
    cold step 0.3% to 6.3% of k over six seeds (4.1% here), held at most
    13%. After it the EF rows differ at those entries and the gap compounds
    (10% to 25% of k on the next step), so there the same-accumulator check
    alone holds the selection. ``analysis/resnet_trajectory_seeds.py``
    takes these readings over seeds."""
    dnn, dataset, kw, shape, nc = CASES[case]
    density = 0.001
    # a small lr keeps the flipped-gate gradient gap (module docstring)
    # under the 1e-4 loss tolerance over these steps (at lr 0.01 the
    # losses part by 2e-4 to 3e-4 after two updates)
    opt = dict(lr=0.002, momentum=0.9, weight_decay=5e-4)
    spec, params, stats = _flax_case(case, seeds[0])
    mesh = data_parallel_mesh(1)
    plan = jplan(params, density)
    jspec = jcomp(compressor, density=density)
    jts = build_dp_train_step(
        jmake_loss(spec, input_norm=JNORM if u8 else None), None,
        jspec, plan, mesh,
        flat_opt=JFlatSGDM(**opt), wire="off")
    jstate = jts.init_state(jax.tree.map(jnp.asarray, params),
                            jax.random.PRNGKey(1),
                            model_state={"batch_stats": jax.tree.map(
                                jnp.asarray, stats)})
    model = get_model(dnn, dataset, num_classes=nc, device="cpu",
                      **kw).module
    tplan = plan_for_params(model.param_layout, density)
    assert tplan == plan
    tspec = get_compressor(compressor, density=density)
    model.pad_flat(flat_numel(tspec, tplan))
    convert.load_flax_variables(model, params, stats)
    ts = DPTrainStep(make_loss_fn(model, input_norm=IMAGENET_NORM
                                  if u8 else None),
                     model.flat, {"stats": model.stats}, tspec, tplan,
                     flat_opt=FlatSGDM(**opt), wire="off")
    state = ts.init_state()
    rng = np.random.default_rng(seeds[1])
    losses, sent_differs = [], False
    readings = {"loss_gap": [], "moved": []}
    for i, kind in enumerate(kinds):
        size = (batch,) + shape[1:]
        x = (rng.integers(0, 256, size=size).astype(np.uint8) if u8 else
             rng.normal(size=size).astype(np.float32))
        y = rng.integers(0, nc, size=batch).astype(np.int32)
        jfn = jts.dense_step if kind == "dense" else jts.sparse_step
        jstate, jm = jfn(jstate, shard_batch(mesh, (x, y)))
        tb = (torch.from_numpy(x), torch.from_numpy(y))
        if kind == "sparse":
            g = ts.local_grads(state, tb)
            state.model_state["stats"].copy_(g.model_state_before["stats"])
            comp, residual, nsel, _ = ts.compress_phase(state, g.flat_g)
            acc = state.ef_residual + g.flat_g
            assert torch.equal(decompress(comp, ts.ef_numel) + residual, acc)
            rows = (ts.fused_ef[0], ts.fused_ef[2])
            jr, _ = jspec.fused_ef_fn(
                jnp.asarray(state.ef_residual.view(rows).numpy()),
                jnp.asarray(g.flat_g.view(rows).numpy()), jnp.float32(1.0),
                tplan.buckets[0].k, jnp.asarray(state.comp_state[0].numpy()))
            for got, want in ((comp.indices, jr.compressed.indices),
                              (comp.values, jr.compressed.values),
                              (residual, jr.residual),
                              (nsel, jr.num_selected)):
                want = np.asarray(want).reshape(got.shape)
                if want.dtype == np.float32:
                    got, want = got.view(torch.int32), want.view(np.int32)
                np.testing.assert_array_equal(got.numpy(), want)
        tfn = ts.dense_step if kind == "dense" else ts.sparse_step
        tm = tfn(state, tb)
        losses.append((float(tm.loss), float(jm.loss)))
        readings["loss_gap"].append(abs(losses[-1][0] / losses[-1][1] - 1))
        np.testing.assert_allclose(float(tm.loss), float(jm.loss),
                                   rtol=1e-3 if sent_differs else 1e-4)
        if kind == "sparse":
            # sent: the EF row's new zeros where acc was not zero
            live = acc[:ts.n_total].numpy() != 0
            port_sent = live & (state.ef_residual[:ts.n_total].numpy() == 0)
            ref_sent = live & (np.asarray(jstate.ef_residual).reshape(-1)[
                :ts.n_total] == 0)
            moved = int((port_sent != ref_sent).sum())
            readings["moved"].append(moved / tplan.buckets[0].k)
            if kinds[i - 1] == "dense":                 # cold: k
                k = tplan.buckets[0].k
                assert moved <= 0.13 * k, (moved, k)
                assert float(tm.num_selected) == float(jm.num_selected) == k
            sent_differs |= moved > 0
    jstats = convert.flatten_tree(jax.tree.map(
        np.asarray, jstate.model_state["batch_stats"]), model.stats_layout)
    readings["stats_gap"] = float(np.abs(model.stats.numpy() - jstats).max())
    np.testing.assert_allclose(
        model.stats.numpy(), jstats,
        **(dict(rtol=1e-2, atol=1e-3) if sent_differs else
           dict(rtol=1e-3, atol=1e-4)))
    return ts, losses, readings


def test_dense_resnet20_trajectory_matches_reference():
    """Config 1's step (compressor ``none``, dense) for 3 steps."""
    _, losses, _ = _trajectory("resnet20", "none", ["dense"] * 3, 8)
    print("port, reference losses:", losses)


def test_resnet50_gaussian_fused_trajectory_matches_reference():
    """Config 3's default selector on ResNet-50 at full width with one
    block a stage, uint8 pixels: 1 dense + 2 sparse steps on the fused EF
    path (kernel B1's plain version)."""
    ts, losses, _ = _trajectory("resnet50_1111", "gaussian_fused",
                             ["dense", "sparse", "sparse"], 4, u8=True)
    assert ts.fused_ef is not None
    print("port, reference losses:", losses)


def test_config1_trains_on_the_cpu(tmp_path):
    """BASELINE config 1 from its JSON file through the CLI entry point:
    resnet20, compressor none, bf16, two dense steps."""
    from gaussiank_sgd_torch.train import main
    recs = main(["--config", CONFIG1,
                 "--device", "cpu", "--batch-size", "8", "--max-steps", "2",
                 "--output-dir", str(tmp_path), "--run-id", "c1"])
    assert [r["kind"] for r in recs] == ["dense", "dense"]
    assert all(np.isfinite(r["loss"]) for r in recs)
    assert recs[0]["num_selected"] == recs[0]["k"] == 269_722
    lines = (tmp_path / "c1" / "metrics.jsonl").read_text().splitlines()
    # two step lines, then fit's eval pass and final checkpoint
    assert [json.loads(line).get("event") for line in lines] == [
        None, None, "eval", "checkpoint"]
