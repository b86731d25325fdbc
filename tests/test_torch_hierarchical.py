"""Parity of the two-level exchange (``--ici-size I --dcn-size D``) with
the reference's ``hierarchical_dp_mesh`` on the 8-virtual-device CPU
mesh.

The torch side runs ``I * D`` gloo processes (``_spawn`` of
``tests/test_torch_distributed.py``); worker ``r = d * I + i`` is ``i`` in
node ``d``'s ici group and ``d`` in the dcn group of the workers ``i``
(``parallel/mesh.py:hierarchical_dp_mesh``). At (I, D) = (2, 2), (2, 1)
and (1, 2) every subgroup sums at most two values, and a sum of two is
the same in either order, so everything is held bit for bit:

* ``hierarchical_sparse_allgather_sum`` alone (pairs with duplicate
  indices within a node and across nodes, padding slots), the two-level
  mean (the BatchNorm statistics' ``pmean``: dcn first, then ici, as the
  reference's ``_pmean``) and the two-level sum;
* the train step on the optax path (momentum 0.5, weight decay 2^-11, lr
  2^-4: exact products) with ``gaussian_fused``, 1 dense + 2 sparse steps
  of an injected gradient, each rank fed its own worker's, on the legacy
  (i32, f32) wire of the whole-model bucket and on the packed u16|bf16
  wire of 65,536-element buckets: params, trace, count, every rank's EF
  row, thresholds (warm ones within XLA's f32 ``pow``, 1 ulp),
  num_selected and bytes_sent (the k-pair payload only: the dcn dense
  all-reduce is not in it, as in the reference); the loss equal on every
  rank and within rtol 1e-6 of the reference's (each worker's ``sum(p *
  g)`` adds 100k products in its own order).

Then a narrow VGG (f32, dropout 0) in the 2 x 2 layout against the
reference: losses within rtol 1e-4 and BatchNorm statistics at rtol 1e-3
/ atol 1e-4 (the single-worker test's tolerances: convolutions sum in
another order), the four ranks bit-identical. The CLI trains the 2 x 2
layout under ``torchrun`` with ``--nesterov --fold-lr --sigma-scale``; the
reference's refusals are raised.
"""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.flatten_util import ravel_pytree
from jax.sharding import PartitionSpec as P

from gaussiank_sgd_tpu import compat
from gaussiank_sgd_tpu.compressors import CompressedGrad as JComp
from gaussiank_sgd_tpu.compressors.registry import get_compressor as jcomp
from gaussiank_sgd_tpu.models import get_model as jget_model
from gaussiank_sgd_tpu.parallel import collectives as jcoll
from gaussiank_sgd_tpu.parallel.bucketing import plan_for_params as jplan
from gaussiank_sgd_tpu.parallel.mesh import hierarchical_dp_mesh, shard_batch
from gaussiank_sgd_tpu.parallel.trainstep import build_dp_train_step
from gaussiank_sgd_tpu.training.losses import make_loss_fn as jmake_loss
from gaussiank_sgd_torch import convert
from test_torch_distributed import REPO, _spawn

SHAPES = {"a": (300, 200), "b": (40_001,)}       # ravel order: a, then b
NARROW = [8, "M", 8, "M", 16, "M", 16, "M", 16, "M"]
OPT = dict(lr=2.0 ** -4, momentum=0.5, weight_decay=2.0 ** -11)
PLANS = {"i32f32": {}, "u16bf16": dict(bucket_size=65_536, policy="uniform")}
AXES = ("dcn_dp", "ici_dp")


def _bits(a):
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


def _same(port, ref):
    np.testing.assert_array_equal(_bits(port), _bits(np.asarray(ref)))


def _chain():
    return optax.chain(optax.add_decayed_weights(OPT["weight_decay"]),
                       optax.sgd(OPT["lr"], momentum=OPT["momentum"]))


def _w_two_level(rank, world, ici, dcn, idx, val, stats, numel, p0, grads,
                 sizes, density, opt, plans):
    from gaussiank_sgd_torch.compressors import (CompressedGrad,
                                                 get_compressor)
    from gaussiank_sgd_torch.parallel import collectives as C
    from gaussiank_sgd_torch.parallel.bucketing import make_bucket_plan
    from gaussiank_sgd_torch.parallel.flat_opt import OptaxSGD
    from gaussiank_sgd_torch.parallel.mesh import hierarchical_dp_mesh
    from gaussiank_sgd_torch.parallel.trainstep import DPTrainStep, flat_numel
    mesh = hierarchical_dp_mesh(ici, dcn)
    dcn_group, ici_group = mesh.groups
    k = idx.shape[0] // world
    mine = CompressedGrad(torch.from_numpy(idx[rank * k:(rank + 1) * k]),
                          torch.from_numpy(val[rank * k:(rank + 1) * k]))
    x = torch.from_numpy(stats[rank].copy())
    out = {"sizes": mesh.sizes, "names": mesh.names,
           "ranks": (C.rank(dcn_group), C.rank(ici_group)),
           "exchange": C.hierarchical_sparse_allgather_sum(
               mine, numel, ici_group, dcn_group).numpy(),
           "pmean": mesh.pmean(x).numpy(), "psum": mesh.psum(x).numpy(),
           "steps": {}}
    for wire, bucket in plans.items():
        plan = make_bucket_plan(sizes, density, **bucket)
        spec = get_compressor("gaussian_fused", density=density)
        n, n_pad = plan.total_numel, flat_numel(spec, plan)

        def padded(a):
            return torch.from_numpy(np.pad(a, (0, n_pad - n)))

        params = torch.nn.Parameter(padded(p0))
        ts = DPTrainStep(lambda g: ((params * g).sum(), {}), params, {},
                         spec, plan, optimizer=OptaxSGD(**opt), mesh=mesh)
        state = ts.init_state()
        steps = []
        for i, g in enumerate(grads[rank]):
            fn = ts.dense_step if i == 0 else ts.sparse_step
            m = fn(state, padded(g))
            steps.append({
                "wire": ts.wire_format, "n_pad": n_pad,
                "params": state.params.detach().numpy().copy(),
                "trace": state.opt_state["trace"].numpy().copy(),
                "count": int(state.opt_state["count"]),
                "ef": state.ef_residual.numpy().copy(),
                "cs": state.comp_state.numpy().copy(),
                "loss": float(m.loss), "nsel": float(m.num_selected),
                "bytes": m.bytes_sent})
        out["steps"][wire] = steps
    return out


@pytest.mark.parametrize("ici,dcn", [(2, 2), (2, 1), (1, 2)])
def test_two_level_exchange_matches_reference_bitwise(tmp_path, ici, dcn):
    world, density, numel = ici * dcn, 0.001, 3000
    rng = np.random.default_rng(ici * 10 + dcn)
    idx, val = [], []
    for _ in range(world):             # duplicates within and across nodes
        i = rng.choice(numel // 4, size=200, replace=False).astype(np.int32)
        v = rng.normal(size=200).astype(np.float32)
        pad = rng.random(200) < 0.1
        i[pad], v[pad] = 0, 0.0
        idx.append(i)
        val.append(v)
    idx, val = np.concatenate(idx), np.concatenate(val)
    stats = rng.normal(size=(world, 257)).astype(np.float32)
    p0 = {k: rng.normal(size=s).astype(np.float32) for k, s in SHAPES.items()}
    grads = [[{k: rng.normal(size=s).astype(np.float32)
               for k, s in SHAPES.items()} for _ in range(3)]
             for _ in range(world)]
    outs = _spawn(tmp_path, world, _w_two_level, ici=ici, dcn=dcn, idx=idx,
                  val=val, stats=stats, numel=numel,
                  p0=np.asarray(ravel_pytree(p0)[0]),
                  grads=[[np.asarray(ravel_pytree(g)[0]) for g in gw]
                         for gw in grads],
                  sizes=[int(np.prod(s)) for s in SHAPES.values()],
                  density=density, opt=OPT, plans=PLANS)

    mesh = hierarchical_dp_mesh(ici_size=ici, dcn_size=dcn)
    assert mesh.axis_names == AXES

    def smap(fn, n_in):
        return jax.jit(compat.shard_map(
            fn, mesh=mesh, in_specs=(P(AXES),) * n_in, out_specs=P(),
            check_vma=False))

    def jpmean(x):
        for a in AXES:
            x = jax.lax.pmean(x, a)
        return x

    jexchange = smap(lambda i, v: jcoll.hierarchical_sparse_allgather_sum(
        JComp(i, v), numel, "ici_dp", "dcn_dp"), 2)(jnp.asarray(idx),
                                                     jnp.asarray(val))
    flat_stats = jnp.asarray(stats.reshape(-1))
    jmean = smap(jpmean, 1)(flat_stats)
    jsum = smap(lambda x: jax.lax.psum(jax.lax.psum(x, "dcn_dp"), "ici_dp"),
                1)(flat_stats)
    for r, out in enumerate(outs):
        assert out["sizes"] == (dcn, ici) and out["names"] == AXES
        assert out["ranks"] == (r // ici, r % ici)
        _same(out["exchange"], jexchange)
        _same(out["pmean"], jmean)
        _same(out["psum"], jsum)

    def jloss(p, mstate, batch, rng_):
        return sum(jnp.sum(p[k] * batch[k][0]) for k in SHAPES), (mstate, {})

    for wire, bucket in PLANS.items():
        plan = jplan(p0, density, **bucket)
        jts = build_dp_train_step(jloss, _chain(),
                                  jcomp("gaussian_fused", density=density),
                                  plan, mesh, wire="auto")
        assert jts.wire_format == wire
        jstate = jts.init_state(jax.tree.map(jnp.asarray, p0),
                                jax.random.PRNGKey(0))
        n = plan.total_numel
        for i in range(3):
            batch = {k: np.stack([grads[w][i][k] for w in range(world)])
                     for k in SHAPES}
            jfn = jts.dense_step if i == 0 else jts.sparse_step
            jstate, jm = jfn(jstate, shard_batch(mesh, batch))
            jtrace = ravel_pytree([x for x in jax.tree_util.tree_leaves(
                jstate.opt_state) if x.dtype == jnp.float32])[0]
            jef = np.asarray(jstate.ef_residual).reshape(world, -1)
            jcs = np.asarray(jstate.comp_state)
            for r, out in enumerate(outs):
                st = out["steps"][wire][i]
                assert st["wire"] == wire and st["n_pad"] == jts.ef_numel
                _same(st["params"][:n], ravel_pytree(jstate.params)[0])
                _same(st["trace"][:n], jtrace)
                assert not st["params"][n:].any()
                assert not st["trace"][n:].any()
                assert st["count"] == i + 1
                _same(st["ef"], jef[r])
                if i == 2:       # after a warm update: XLA's f32 pow
                    np.testing.assert_array_max_ulp(st["cs"][0], jcs[r], 1)
                else:
                    _same(st["cs"][0], jcs[r])
                # each worker's loss sum(p * g) sums 100k products in its
                # own order; the two-level mean of the four is exact
                np.testing.assert_allclose(st["loss"], float(jm.loss),
                                           rtol=1e-6)
                assert st["loss"] == outs[0]["steps"][wire][i]["loss"]
                assert st["nsel"] == float(jm.num_selected)
                assert st["bytes"] == float(jm.bytes_sent)
        assert outs[0]["steps"][wire][1]["bytes"] == plan.total_k * (
            8 if wire == "i32f32" else 4)


# ------------------------------------------------------------ narrow VGG

def _w_vgg(rank, world, ici, dcn, params, stats, batches, kinds, density,
           opt, narrow):
    from gaussiank_sgd_torch import convert
    from gaussiank_sgd_torch.compressors import get_compressor
    from gaussiank_sgd_torch.models import get_model
    from gaussiank_sgd_torch.parallel.bucketing import plan_for_params
    from gaussiank_sgd_torch.parallel.flat_opt import OptaxSGD
    from gaussiank_sgd_torch.parallel.mesh import (hierarchical_dp_mesh,
                                                   shard_batch)
    from gaussiank_sgd_torch.parallel.trainstep import DPTrainStep, flat_numel
    from gaussiank_sgd_torch.training.losses import make_loss_fn
    model = get_model("vgg16", num_classes=10, dtype=torch.float32,
                      cfg=narrow, dropout=0.0, device="cpu").module
    plan = plan_for_params(model.param_layout, density)
    spec = get_compressor("gaussian_fused", density=density)
    model.pad_flat(flat_numel(spec, plan))
    convert.load_flax_variables(model, params, stats)
    ts = DPTrainStep(make_loss_fn(model), model.flat, {"stats": model.stats},
                     spec, plan, optimizer=OptaxSGD(**opt),
                     mesh=hierarchical_dp_mesh(ici, dcn))
    state = ts.init_state()
    out = {"losses": [], "params": [], "stats": []}
    for kind, batch in zip(kinds, batches):
        x, y = shard_batch(batch, rank, world)
        fn = ts.dense_step if kind == "dense" else ts.sparse_step
        out["losses"].append(float(fn(state, (torch.from_numpy(x.copy()),
                                              torch.from_numpy(y.copy())))
                                   .loss))
        out["params"].append(state.params.detach().numpy().copy())
        out["stats"].append(model.stats.numpy().copy())
    return out


def test_narrow_vgg_two_by_two_matches_reference(tmp_path):
    ici, dcn, density, per_worker = 2, 2, 0.01, 8
    world = ici * dcn
    opt = dict(lr=0.05, momentum=0.9, weight_decay=5e-4)
    kinds = ["dense", "sparse", "sparse"]
    spec = jget_model("vgg16", "cifar10", num_classes=10, dtype=jnp.float32,
                      cfg=tuple(NARROW), dropout=0.0)
    v = spec.module.init({"params": jax.random.PRNGKey(0),
                          "dropout": jax.random.PRNGKey(0)},
                         jnp.zeros((2, 32, 32, 3)), train=False)
    params = jax.tree.map(np.asarray, v["params"])
    stats = jax.tree.map(np.asarray, v["batch_stats"])
    rng = np.random.default_rng(1)
    batches = [(rng.normal(size=(world * per_worker, 32, 32, 3)
                           ).astype(np.float32),
                rng.integers(0, 10, size=world * per_worker).astype(np.int32))
               for _ in kinds]
    outs = _spawn(tmp_path, world, _w_vgg, ici=ici, dcn=dcn, params=params,
                  stats=stats, batches=batches, kinds=kinds,
                  density=density, opt=opt, narrow=NARROW)
    mesh = hierarchical_dp_mesh(ici_size=ici, dcn_size=dcn)
    jts = build_dp_train_step(
        jmake_loss(spec), optax.chain(
            optax.add_decayed_weights(opt["weight_decay"]),
            optax.sgd(opt["lr"], momentum=opt["momentum"])),
        jcomp("gaussian_fused", density=density),
        jplan(params, density), mesh, wire="auto")
    jstate = jts.init_state(jax.tree.map(jnp.asarray, params),
                            jax.random.PRNGKey(1),
                            model_state={"batch_stats": jax.tree.map(
                                jnp.asarray, stats)})
    jlosses = []
    for kind, batch in zip(kinds, batches):
        jfn = jts.dense_step if kind == "dense" else jts.sparse_step
        jstate, jm = jfn(jstate, shard_batch(mesh, batch))
        jlosses.append(float(jm.loss))
    from gaussiank_sgd_torch.models import get_model
    layout = get_model("vgg16", cfg=NARROW, device="cpu").module.stats_layout
    for out in outs:
        np.testing.assert_allclose(out["losses"], jlosses, rtol=1e-4)
        for key in ("params", "stats"):
            for a, b in zip(out[key], outs[0][key]):
                _same(a, b)
        np.testing.assert_allclose(
            out["stats"][-1], convert.flatten_tree(jax.tree.map(
                np.asarray, jstate.model_state["batch_stats"]), layout),
            rtol=1e-3, atol=1e-4)


# ------------------------------------------------------------- CLI, refusals

def test_cli_trains_two_by_two_under_torchrun(tmp_path):
    """``torchrun --nproc-per-node 4`` on one host as two 'nodes' of two:
    the optax path with nesterov and fold_lr, the threshold scale set;
    rank 0's metrics hold the k-pair bytes of the packed wire."""
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc-per-node", "4", "-m", "gaussiank_sgd_torch.train",
           "--device", "cpu", "--dnn", "vgg16", "--ici-size", "2",
           "--dcn-size", "2", "--compressor", "gaussian_fused",
           "--bucket-size", "4096", "--bucket-policy", "uniform",
           "--nesterov", "--fold-lr", "--sigma-scale", "2.5",
           "--max-steps", "3", "--compress-warmup-steps", "1",
           "--batch-size", "4", "--density", "0.01", "--compute-dtype",
           "float32", "--eval-every-epochs", "0",
           "--dataset-kwargs", json.dumps({"synthetic_examples": 64}),
           "--model-kwargs", json.dumps({"cfg": NARROW}),
           "--output-dir", str(tmp_path), "--run-id", "twolevel"]
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    proc = subprocess.run(cmd, cwd=REPO, env=env, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert ("rank=3/4 wire=u16bf16 exchange=allgather mesh=dcn_dp=2x"
            "ici_dp=2 optimizer=optimizer" in proc.stderr)
    assert "nworkers=1: the 2 x 2 layout has 4 workers" in proc.stderr
    lines = (tmp_path / "twolevel" / "steps.jsonl").read_text()
    recs = [json.loads(line) for line in lines.splitlines()]
    assert [r["kind"] for r in recs] == ["dense", "sparse", "sparse"]
    assert all(np.isfinite(r["loss"]) for r in recs)
    assert recs[1]["bytes_sent"] == recs[1]["k"] * 4


def test_two_level_refusals(tmp_path):
    """The reference's refusals, with its reasons: gtopk on a 2-D mesh, the
    flat optimizer there, and a sequence-parallel width beside the
    two-level layout; a layout that is not the world size."""
    import argparse
    from gaussiank_sgd_torch.compressors import get_compressor
    from gaussiank_sgd_torch.parallel.bucketing import make_bucket_plan
    from gaussiank_sgd_torch.parallel.flat_opt import FlatSGDM, OptaxSGD
    from gaussiank_sgd_torch.parallel.mesh import \
        hierarchical_dp_mesh as two_level
    from gaussiank_sgd_torch.parallel.trainstep import DPTrainStep
    from gaussiank_sgd_torch.training.config import add_args, from_args
    p = torch.nn.Parameter(torch.zeros(1000))
    args = (lambda b: ((p * b).sum(), {}), p, {},
            get_compressor("gaussian", density=0.01),
            make_bucket_plan([1000], 0.01))
    mesh = two_level(1, 1)
    with pytest.raises(ValueError, match="gtopk exchange supports 1-D dp "
                                         "meshes only"):
        DPTrainStep(*args, optimizer=OptaxSGD(lr=0.1), mesh=mesh,
                    exchange="gtopk")
    with pytest.raises(ValueError, match="flat_opt supports 1-D meshes"):
        DPTrainStep(*args, flat_opt=FlatSGDM(lr=0.1, momentum=0.9),
                    mesh=mesh)
    with pytest.raises(ValueError, match="lay out 8 workers, but the world "
                                         "size is 1"):
        two_level(2, 4)
    with pytest.raises(ValueError, match=">= 1"):
        two_level(0, 1)
    parser = argparse.ArgumentParser()
    add_args(parser)
    path = tmp_path / "c.json"
    path.write_text(json.dumps({"dnn": "vgg16", "sp_size": 2}))
    argv = ["--config", str(path), "--ici-size", "2", "--dcn-size", "2"]
    with pytest.raises(ValueError, match="--sp-size and --ici-size/"
                                         "--dcn-size are mutually "
                                         "exclusive mesh layouts"):
        from_args(parser.parse_args(argv), argv)
