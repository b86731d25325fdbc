"""Multi-worker parity of the port: the ordered scatter of gathered pairs,
the collectives over ``torch.distributed`` and the data-parallel step at
P = 2 and 4, against the reference on the 8-virtual-device CPU mesh.

The torch side runs as P gloo processes, spawned with a ``FileStore`` in
``tmp_path``. Each runs one worker function of this file (its source is
handed to ``python -c``; it imports torch and the port only), writes its
results to ``tmp_path``, and this process compares them with the
reference's ``data_parallel_mesh(P)`` run and across ranks.

* Scatter: ``FlatSGDM.sparse_step`` and ``decompress`` on a gathered buffer
  with P-fold duplicate indices, out-of-range and padding slots, and signed
  zeros, bit for bit (the reference adds in the buffer's order on the CPU).
* Collectives: ``sparse_allgather_sum`` bit for bit; ``dense_allreduce``
  bit for bit at P = 2 (a sum of two is commutative) and within a few f32
  ulps at P = 4 (gloo and XLA sum in their own orders).
* Step: the injected-gradient step of ``tests/test_torch_trainstep.py`` at
  P = 2, each rank fed its own worker's gradient, 1 dense + 3 sparse steps,
  the last with a NaN on rank 0 only, on the legacy and the packed wire:
  params, momentum, every rank's EF row, thresholds and the guard bit for
  bit (warm thresholds within XLA's f32 ``pow``, 1 ulp).
* Narrow VGG (f32, dropout 0) at P = 2: losses within rtol 1e-4, averaged
  BatchNorm statistics at the single-worker test's tolerance, both ranks
  bit-identical in params and statistics, and the EF invariant exact
  against the decoded wire values on every sparse step.
* The CLI under ``torchrun`` with ``--nworkers 2 --device cpu``; a world
  size other than ``--nworkers`` is refused, and a process whose launcher
  environment names a group that cannot form raises.
"""

import inspect
import json
import os
import pathlib
import pickle
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree
from jax.sharding import PartitionSpec as P

from gaussiank_sgd_tpu import compat
from gaussiank_sgd_tpu.compressors import CompressedGrad as JComp
from gaussiank_sgd_tpu.compressors import decompress as jdecompress
from gaussiank_sgd_tpu.compressors.registry import get_compressor as jcomp
from gaussiank_sgd_tpu.models import get_model as jget_model
from gaussiank_sgd_tpu.parallel import collectives as jcoll
from gaussiank_sgd_tpu.parallel.bucketing import plan_for_params as jplan
from gaussiank_sgd_tpu.parallel.flat_opt import FlatSGDM as JFlatSGDM
from gaussiank_sgd_tpu.parallel.mesh import data_parallel_mesh, shard_batch
from gaussiank_sgd_tpu.parallel.trainstep import build_dp_train_step
from gaussiank_sgd_tpu.training.losses import make_loss_fn as jmake_loss
from gaussiank_sgd_torch import convert
from gaussiank_sgd_torch.compressors import CompressedGrad, decompress
from gaussiank_sgd_torch.compressors.base import scatter_add_ordered
from gaussiank_sgd_torch.parallel.flat_opt import FlatSGDM
from gaussiank_sgd_torch.training.config import TrainConfig
from gaussiank_sgd_torch.training.trainer import Trainer

REPO = pathlib.Path(__file__).resolve().parents[1]
CONFIG2 = str(REPO / "exp_configs" / "config2_vgg16_cifar10_gaussian.json")
NARROW = [8, "M", 8, "M", 16, "M", 16, "M", 16, "M"]
SHAPES = {"a": (300, 200), "b": (40_001,)}       # ravel order: a, then b


def _bits(a):
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


def _same(port, ref):
    port = port.detach().numpy() if isinstance(port, torch.Tensor) else port
    np.testing.assert_array_equal(_bits(port), _bits(np.asarray(ref)))


# ------------------------------------------------------ spawning workers

_PRELUDE = """
import os, pickle, sys
import numpy as np
import torch
import torch.distributed as dist
from gaussiank_sgd_torch.parallel.mesh import init_distributed
"""

_MAIN = """
rank, world, d = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
init_distributed("cpu", rank, world, "file://" + os.path.join(d, "store"))
with open(os.path.join(d, "args.pkl"), "rb") as f:
    args = pickle.load(f)
out = {fn}(rank, world, **args)
with open(os.path.join(d, "out%d.pkl" % rank), "wb") as f:
    pickle.dump(out, f)
dist.barrier()
dist.destroy_process_group()
"""


def _spawn(tmp_path, world, fn, **args):
    """Run ``fn(rank, world, **args)`` in ``world`` gloo processes; return
    each rank's result."""
    src = (_PRELUDE + textwrap.dedent(inspect.getsource(fn))
           + _MAIN.format(fn=fn.__name__))
    (tmp_path / "args.pkl").write_bytes(pickle.dumps(args))
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-c", src, str(r), str(world), str(tmp_path)],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for r in range(world)]
    try:
        errs = [p.communicate(timeout=300)[1] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for r, (p, err) in enumerate(zip(procs, errs)):
        assert p.returncode == 0, f"rank {r}: {err[-3000:]}"
    return [pickle.loads((tmp_path / f"out{r}.pkl").read_bytes())
            for r in range(world)]


def _shard_map(fn, world, n_in, out_specs):
    return jax.jit(compat.shard_map(
        fn, mesh=data_parallel_mesh(world), in_specs=(P("dp"),) * n_in,
        out_specs=out_specs, check_vma=False))


# --------------------------------------------------------------- scatter

def _gathered_pairs(world, n, k, seed):
    """``world`` payloads of k pairs, tiled: valid indices distinct within
    a payload and drawn from n/10 coordinates (most repeat across
    payloads), ~10% padding slots (their 1000-element bucket's base, value
    +0.0), ~3% out of range, a few -0.0 values; then ``/ world``."""
    rng = np.random.default_rng(seed)
    idx, val = [], []
    for _ in range(world):
        i = rng.choice(n // 10, size=k, replace=False).astype(np.int32)
        v = (rng.normal(size=k)
             * 10.0 ** rng.integers(-4, 3, size=k)).astype(np.float32)
        v[rng.random(k) < 0.02] = -0.0
        pad = rng.random(k) < 0.1
        i[pad], v[pad] = (i[pad] // 1000) * 1000, 0.0
        oor = rng.random(k) < 0.03
        i[oor] = n + rng.integers(0, 100, size=int(oor.sum()))
        idx.append(i)
        val.append(v)
    return np.concatenate(idx), np.concatenate(val) / np.float32(world)


@pytest.mark.parametrize("world", [2, 8])
def test_scatter_of_gathered_pairs_matches_reference_bitwise(world):
    n = 20_000
    idx, val = _gathered_pairs(world, n, 400, seed=world)
    rng = np.random.default_rng(100 + world)
    m, p = (rng.normal(size=n).astype(np.float32) for _ in range(2))
    m[rng.random(n) < 0.05] = -0.0
    m[rng.random(n) < 0.05] = 0.0
    kw = dict(lr=2.0 ** -3, momentum=0.5, weight_decay=2.0 ** -10)
    jupd, jm = JFlatSGDM(**kw).sparse_step(
        jnp.asarray(m), jnp.asarray(idx), jnp.asarray(val), jnp.asarray(p), 0)
    jdense = jdecompress(JComp(jnp.asarray(idx), jnp.asarray(val)), n)
    for rounds in (world, None):
        upd, m_new = FlatSGDM(**kw).sparse_step(
            torch.from_numpy(m), torch.from_numpy(idx), torch.from_numpy(val),
            torch.from_numpy(p), 0, rounds=rounds)
        _same(upd, jupd)
        _same(m_new, jm)
    _same(decompress(CompressedGrad(torch.from_numpy(idx),
                                    torch.from_numpy(val)), n), jdense)
    # the case the rounds exist for: a coordinate several workers send
    assert np.bincount(idx[(idx < n) & (val != 0)]).max() >= 2


def test_scatter_add_ordered_is_the_sequential_sum():
    """Against a left-to-right f32 loop: heavy duplicates, magnitudes where
    the order changes the sum, +0.0 and -0.0 values into ±0.0 entries."""
    rng = np.random.default_rng(7)
    n, m = 64, 4000
    idx = rng.integers(-3, n + 3, size=m).astype(np.int32)
    val = (rng.normal(size=m) * 10.0 ** rng.integers(-6, 7, size=m)
           ).astype(np.float32)
    val[rng.random(m) < 0.2] = 0.0
    val[rng.random(m) < 0.2] = -0.0
    dest = rng.normal(size=n).astype(np.float32)
    dest[::3], dest[1::3] = -0.0, 0.0
    want = dest.copy()
    for i, v in zip(idx, val):
        if 0 <= i < n:
            want[i] = np.float32(want[i] + v)
    got = scatter_add_ordered(torch.from_numpy(dest.copy()),
                              torch.from_numpy(idx), torch.from_numpy(val))
    _same(got, want)


# ----------------------------------------------------------- collectives

def _w_collectives(rank, world, idx, val, flat, numel):
    from gaussiank_sgd_torch.compressors import CompressedGrad
    from gaussiank_sgd_torch.parallel import collectives as C
    k, n = idx.shape[0] // world, flat.shape[0] // world
    mine = CompressedGrad(torch.from_numpy(idx[rank * k:(rank + 1) * k]),
                          torch.from_numpy(val[rank * k:(rank + 1) * k]))
    x = torch.from_numpy(flat[rank * n:(rank + 1) * n].copy())
    return {"world": C.world_size(), "rank": C.rank(),
            "gathered": C.all_gather(mine.indices).numpy(),
            "sparse": C.sparse_allgather_sum(mine, numel).numpy(),
            "dense": C.dense_allreduce(x).numpy(),
            "pmean": C.pmean(x).numpy(),
            "x_after": x.numpy()}


@pytest.mark.parametrize("world", [2, 4])
def test_collectives_match_reference(tmp_path, world):
    numel = 3000
    idx, val = _gathered_pairs(world, numel, 200, seed=10 + world)
    val = val * np.float32(world)               # un-averaged worker values
    flat = np.random.default_rng(world).normal(
        size=world * 5000).astype(np.float32)
    outs = _spawn(tmp_path, world, _w_collectives, idx=idx, val=val,
                  flat=flat, numel=numel)
    jsparse = _shard_map(
        lambda i, v: jcoll.sparse_allgather_sum(JComp(i, v), numel, "dp"),
        world, 2, P())(jnp.asarray(idx), jnp.asarray(val))
    jdense = _shard_map(lambda x: jcoll.dense_allreduce(x, "dp"),
                        world, 1, P())(jnp.asarray(flat))
    jpmean = _shard_map(lambda x: jax.lax.pmean(x, "dp"),
                        world, 1, P())(jnp.asarray(flat))
    for r, out in enumerate(outs):
        assert (out["world"], out["rank"]) == (world, r)
        np.testing.assert_array_equal(out["gathered"], idx)
        _same(out["sparse"], jsparse)
        _same(out["x_after"], flat[r * 5000:(r + 1) * 5000])   # untouched
        _same(out["dense"], outs[0]["dense"])
        _same(out["pmean"], out["dense"])
        if world == 2:
            _same(out["dense"], jdense)
            _same(out["pmean"], jpmean)
        else:
            np.testing.assert_allclose(out["dense"], jdense, rtol=0,
                                       atol=2e-6)


def test_unported_exchange_and_wrong_world_size_raise():
    """The two-level exchange is ported: in a world of one it is the
    scatter of the worker's own pairs. A layout or a worker count that is
    not the world size is refused."""
    from gaussiank_sgd_torch.parallel import collectives as C
    from gaussiank_sgd_torch.parallel.mesh import hierarchical_dp_mesh
    comp = CompressedGrad(torch.tensor([3, 1, 3], dtype=torch.int32),
                          torch.tensor([1.5, -2.0, 0.25]))
    got = C.hierarchical_sparse_allgather_sum(comp, 4, None, None)
    _same(got, np.array([0.0, -2.0, 0.0, 1.75], np.float32))
    with pytest.raises(ValueError, match="world size is 1"):
        hierarchical_dp_mesh(2, 2)
    with pytest.raises(ValueError, match="world size is 1"):
        Trainer(TrainConfig(nworkers=8, device="cpu"))
    with pytest.raises(ValueError, match="lay out 4 workers, but the "
                                         "world size is 1"):
        Trainer(TrainConfig(ici_size=2, dcn_size=2, nworkers=4,
                            device="cpu"))


# ------------------------------------------------------------------ step

def _w_step(rank, world, p0, grads, sizes, density, opt, wire, bucket):
    from gaussiank_sgd_torch.compressors import get_compressor
    from gaussiank_sgd_torch.parallel.bucketing import make_bucket_plan
    from gaussiank_sgd_torch.parallel.flat_opt import FlatSGDM
    from gaussiank_sgd_torch.parallel.trainstep import DPTrainStep, flat_numel
    plan = make_bucket_plan(sizes, density, **bucket)
    spec = get_compressor("gaussian_fused", density=density)
    n, n_pad = plan.total_numel, flat_numel(spec, plan)

    def padded(a):
        return torch.from_numpy(np.pad(a, (0, n_pad - n)))

    params = torch.nn.Parameter(padded(p0))
    ts = DPTrainStep(lambda g: ((params * g).sum(), {}), params, {}, spec,
                     plan, flat_opt=FlatSGDM(**opt), wire=wire)
    assert ts.fused_ef is not None
    state = ts.init_state()
    out = {"wire": ts.wire_format, "n_pad": n_pad, "steps": []}
    for i, g in enumerate(grads[rank]):
        fn = ts.dense_step if i == 0 else ts.sparse_step
        m = fn(state, padded(g))
        out["steps"].append({
            "params": state.params.detach().numpy().copy(),
            "m": state.opt_state["m"].numpy().copy(),
            "ef": state.ef_residual.numpy().copy(),
            "cs": state.comp_state.numpy().copy(),
            "loss": float(m.loss), "skipped": float(m.skipped),
            "nonfinite": float(m.nonfinite),
            "nsel": float(m.num_selected), "bytes": m.bytes_sent})
    return out


@pytest.mark.parametrize("wire,bucket", [
    ("i32f32", {}),
    ("u16bf16", dict(bucket_size=65_536, policy="uniform"))])
def test_injected_gradient_step_two_workers_matches_reference(
        tmp_path, wire, bucket):
    world, density = 2, 0.001
    opt = dict(lr=2.0 ** -4, momentum=0.5, weight_decay=2.0 ** -11)
    rng = np.random.default_rng(0)
    p0 = {k: rng.normal(size=s).astype(np.float32) for k, s in SHAPES.items()}
    # grads[worker][step]: 1 dense + 3 sparse; the last has a NaN on rank 0
    grads = [[{k: rng.normal(size=s).astype(np.float32)
               for k, s in SHAPES.items()} for _ in range(4)]
             for _ in range(world)]
    grads[0][3]["b"][17] = np.nan

    def jloss(p, mstate, batch, rng_):
        return sum(jnp.sum(p[k] * batch[k][0]) for k in SHAPES), (mstate, {})

    mesh = data_parallel_mesh(world)
    plan = jplan(p0, density, **bucket)
    jts = build_dp_train_step(jloss, None, jcomp("gaussian_fused",
                                                 density=density),
                              plan, mesh, flat_opt=JFlatSGDM(**opt),
                              wire="auto")
    assert jts.wire_format == wire
    jstate = jts.init_state(jax.tree.map(jnp.asarray, p0),
                            jax.random.PRNGKey(0))
    flat = [[ravel_pytree(g)[0] for g in gw] for gw in grads]
    outs = _spawn(tmp_path, world, _w_step,
                  p0=np.asarray(ravel_pytree(p0)[0]),
                  grads=[[np.asarray(g) for g in gw] for gw in flat],
                  sizes=[int(np.prod(s)) for s in SHAPES.values()],
                  density=density, opt=opt, wire="auto", bucket=bucket)
    n, n_pad = plan.total_numel, outs[0]["n_pad"]
    assert n_pad == jts.ef_numel
    for i in range(4):
        batch = {k: np.stack([grads[w][i][k] for w in range(world)])
                 for k in SHAPES}
        jfn = jts.dense_step if i == 0 else jts.sparse_step
        jstate, jm = jfn(jstate, shard_batch(mesh, batch))
        jef = np.asarray(jstate.ef_residual).reshape(world, n_pad)
        jcs = np.asarray(jstate.comp_state)
        for r, out in enumerate(outs):
            assert out["wire"] == wire
            st = out["steps"][i]
            _same(st["params"][:n], ravel_pytree(jstate.params)[0])
            _same(st["m"][:n], jstate.opt_state["m"])
            assert not st["params"][n:].any() and not st["m"][n:].any()
            _same(st["ef"], jef[r])
            if i >= 2:         # after a warm update: XLA's f32 pow
                np.testing.assert_array_max_ulp(st["cs"][0], jcs[r], 1)
            else:
                _same(st["cs"][0], jcs[r])
            assert st["skipped"] == float(jm.skipped) == (i == 3)
            assert st["nonfinite"] == float(jm.nonfinite)
            assert st["bytes"] == float(jm.bytes_sent)
            if i < 3:
                assert st["nsel"] == float(jm.num_selected)
            # every rank commits and reports the same
            for key in ("params", "m"):
                _same(st[key], outs[0]["steps"][i][key])
            np.testing.assert_equal(st["loss"], outs[0]["steps"][i]["loss"])
    k_total = plan.total_k
    assert outs[0]["steps"][1]["bytes"] == k_total * (8 if wire == "i32f32"
                                                      else 4)


# ------------------------------------------------------------ narrow VGG

def _w_vgg(rank, world, params, stats, batches, kinds, density, opt,
           compressor, bucket, narrow):
    from gaussiank_sgd_torch import convert
    from gaussiank_sgd_torch.compressors import decompress, get_compressor
    from gaussiank_sgd_torch.models import get_model
    from gaussiank_sgd_torch.parallel.bucketing import plan_for_params
    from gaussiank_sgd_torch.parallel.flat_opt import FlatSGDM
    from gaussiank_sgd_torch.parallel.mesh import shard_batch
    from gaussiank_sgd_torch.parallel.trainstep import DPTrainStep, flat_numel
    from gaussiank_sgd_torch.training.losses import make_loss_fn
    model = get_model("vgg16", num_classes=10, dtype=torch.float32,
                      cfg=narrow, dropout=0.0, device="cpu").module
    plan = plan_for_params(model.param_layout, density, **bucket)
    spec = get_compressor(compressor, density=density)
    model.pad_flat(flat_numel(spec, plan))
    convert.load_flax_variables(model, params, stats)
    ts = DPTrainStep(make_loss_fn(model), model.flat, {"stats": model.stats},
                     spec, plan, flat_opt=FlatSGDM(**opt), wire="auto")
    state = ts.init_state()
    out = {"wire": ts.wire_format, "fused": ts.fused_ef is not None,
           "losses": [], "params": [], "stats": [], "ef_exact": []}
    for kind, batch in zip(kinds, batches):
        x, y = shard_batch(batch, rank, world)
        tb = (torch.from_numpy(x.copy()), torch.from_numpy(y.copy()))
        if kind == "sparse":
            # the EF invariant against the decoded wire values, exact
            g = ts.local_grads(state, tb)
            state.model_state["stats"].copy_(g.model_state_before["stats"])
            acc = state.ef_residual + g.flat_g
            payload, residual, _, _ = ts.pack_phase(state, g.flat_g)
            sent = ts.unpack(payload, workers=1)
            out["ef_exact"].append(bool(torch.equal(
                decompress(sent, ts.ef_numel) + residual, acc)))
        fn = ts.dense_step if kind == "dense" else ts.sparse_step
        out["losses"].append(float(fn(state, tb).loss))
        out["params"].append(state.params.detach().numpy().copy())
        out["stats"].append(model.stats.numpy().copy())
    return out


@pytest.mark.parametrize("compressor,bucket,wire", [
    ("gaussian", {}, "u16bf16"),
    ("gaussian_fused", dict(bucket_size=4096, policy="uniform"), "u16bf16")])
def test_narrow_vgg_two_workers_matches_reference(tmp_path, compressor,
                                                  bucket, wire):
    world, density, per_worker = 2, 0.01, 16
    opt = dict(lr=0.05, momentum=0.9, weight_decay=5e-4)
    kinds = ["dense"] * 2 + ["sparse"] * 3
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
    outs = _spawn(tmp_path, world, _w_vgg, params=params, stats=stats,
                  batches=batches, kinds=kinds, density=density, opt=opt,
                  compressor=compressor, bucket=bucket, narrow=NARROW)

    mesh = data_parallel_mesh(world)
    jts = build_dp_train_step(jmake_loss(spec), None,
                              jcomp(compressor, density=density),
                              jplan(params, density, **bucket), mesh,
                              flat_opt=JFlatSGDM(**opt), wire="auto")
    assert jts.wire_format == wire
    jstate = jts.init_state(jax.tree.map(jnp.asarray, params),
                            jax.random.PRNGKey(1),
                            model_state={"batch_stats": jax.tree.map(
                                jnp.asarray, stats)})
    jlosses = []
    for kind, batch in zip(kinds, batches):
        jfn = jts.dense_step if kind == "dense" else jts.sparse_step
        jstate, jm = jfn(jstate, shard_batch(mesh, batch))
        jlosses.append(float(jm.loss))
    for out in outs:
        assert out["wire"] == wire
        assert out["fused"] == (compressor == "gaussian_fused")
        assert out["ef_exact"] == [True] * 3
        np.testing.assert_allclose(out["losses"], jlosses, rtol=1e-4)
        for key in ("params", "stats"):
            for a, b in zip(out[key], outs[0][key]):
                _same(a, b)
    model_stats = outs[0]["stats"][-1]
    from gaussiank_sgd_torch.models import get_model
    layout = get_model("vgg16", cfg=NARROW, device="cpu").module.stats_layout
    np.testing.assert_allclose(
        model_stats, convert.flatten_tree(jax.tree.map(
            np.asarray, jstate.model_state["batch_stats"]), layout),
        rtol=1e-3, atol=1e-4)


# ------------------------------------------------------------------- CLI

def test_cli_trains_two_workers_under_torchrun(tmp_path):
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc-per-node", "2", "-m", "gaussiank_sgd_torch.train",
           "--device", "cpu", "--config", CONFIG2, "--nworkers", "2",
           "--compressor", "gaussian_fused", "--bucket-size", "4096",
           "--bucket-policy", "uniform", "--max-steps", "3",
           "--compress-warmup-steps", "1", "--batch-size", "8",
           "--density", "0.01", "--compute-dtype", "float32",
           "--model-kwargs", json.dumps({"cfg": NARROW}),
           "--output-dir", str(tmp_path), "--run-id", "cli2"]
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    proc = subprocess.run(cmd, cwd=REPO, env=env, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "rank=1/2 wire=u16bf16" in proc.stderr
    assert "overlap=auto: pipelined" in proc.stderr
    lines = (tmp_path / "cli2" / "metrics.jsonl").read_text().splitlines()
    recs = [json.loads(line) for line in lines]          # rank 0 alone
    # the run's config, the train record, fit's eval pass and final
    # checkpoint; the step lines in steps.jsonl
    assert [r["event"] for r in recs] == ["config", "train", "eval",
                                          "checkpoint"]
    recs = [json.loads(line) for line in
            (tmp_path / "cli2" / "steps.jsonl").read_text().splitlines()]
    assert [r["kind"] for r in recs] == ["dense", "sparse", "sparse"]
    assert all(np.isfinite(r["loss"]) for r in recs)
    assert recs[1]["bytes_sent"] == recs[1]["k"] * 4


def test_maybe_initialize_distributed_from_the_environment(monkeypatch):
    """No launcher environment: a no-op. An environment that says this is
    one of two processes and a group that cannot form: it raises rather
    than train as an unsynchronised single process."""
    import torch.distributed as dist
    from gaussiank_sgd_torch.parallel import mesh
    for var in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
                "MASTER_PORT"):
        monkeypatch.delenv(var, raising=False)
    assert mesh.maybe_initialize_distributed("cpu") == torch.device("cpu")
    assert not dist.is_initialized()
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("MASTER_ADDR", "localhost")
    monkeypatch.setenv("MASTER_PORT", "not-a-port")
    with pytest.raises(RuntimeError, match="rank 0 of 2.*gloo.*refusing"):
        mesh.maybe_initialize_distributed("cpu")
    assert not dist.is_initialized()
    assert mesh.shard_batch((np.arange(8), np.arange(8) * 2), 1, 2)[1] \
        .tolist() == [8, 10, 12, 14]


def test_one_round_scatter_of_one_payload_matches_reference_bitwise():
    """One payload (P = 1): valid indices distinct, padding slots +0.0 on
    them and on their own, out-of-range slots, signed zeros in the
    momentum. ``rounds=1`` takes one ``index_add_``, bit for bit with the
    reference."""
    n = 20_000
    idx, val = _gathered_pairs(1, n, 1500, seed=5)
    m = np.random.default_rng(6).normal(size=n).astype(np.float32)
    m[::7], m[1::7] = -0.0, 0.0
    kw = dict(lr=2.0 ** -3, momentum=0.5)
    jupd, jm = JFlatSGDM(**kw).sparse_step(
        jnp.asarray(m), jnp.asarray(idx), jnp.asarray(val), None, 0)
    upd, m_new = FlatSGDM(**kw).sparse_step(
        torch.from_numpy(m), torch.from_numpy(idx), torch.from_numpy(val),
        None, 0, rounds=1)
    _same(upd, jupd)
    _same(m_new, jm)
    want = m.copy()
    for i, v in zip(idx, val):
        if i < n:
            want[i] = np.float32(want[i] + v)
    _same(scatter_add_ordered(torch.from_numpy(m.copy()),
                              torch.from_numpy(idx), torch.from_numpy(val),
                              rounds=1), want)
