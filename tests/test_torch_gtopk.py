"""Parity of the port's gTop-k exchange (``parallel/gtopk.py``, the P2P
hop of ``parallel/collectives.py`` and ``DPTrainStep(exchange="gtopk")``)
with the reference's butterfly on the CPU mesh.

* ``merge_sparse`` bit for bit: colliding indices that sum, sums that
  cancel to 0, padding slots (index 0, value 0) beside a real index 0,
  and magnitude ties, which go to the lowest index as ``lax.top_k`` sends
  them.
* ``gtopk_allreduce`` at P = 2 and 4 over gloo (the spawn harness of
  ``tests/test_torch_distributed.py``) against the reference's on
  ``data_parallel_mesh(P)``, on the legacy and the packed wire: the global
  pairs bit for bit and equal on every rank, and bytes_sent equal to the
  reference's ``comm.bytes_sent``.
* The injected-gradient step at P = 2 (1 dense + 3 sparse steps, the last
  with a NaN on rank 0) against ``build_dp_train_step(...,
  exchange="gtopk", overlap="off")``: params, momentum, every rank's EF
  row (unpadded: gtopk refuses the fused EF layout), bytes_sent and the
  guard bit for bit, with ``topk`` on the legacy wire and
  ``gaussian_fused`` on the packed one.
* A world whose size is not a power of 2 is refused when the step is built.
* A P = 2 gtopk run through ``Trainer.fit()`` resumes from its step-4
  checkpoint bit for bit, and its checkpoint holds the unpadded EF rows.
* The CLI under ``torchrun`` with ``--nworkers 2 --exchange gtopk``.
"""

import json
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree
from jax.sharding import PartitionSpec as P

from gaussiank_sgd_tpu.compressors import CompressedGrad as JComp
from gaussiank_sgd_tpu.compressors.registry import get_compressor as jcomp
from gaussiank_sgd_tpu.parallel import gtopk as jgtopk
from gaussiank_sgd_tpu.parallel import wire as jwire
from gaussiank_sgd_tpu.parallel.bucketing import plan_for_params as jplan
from gaussiank_sgd_tpu.parallel.flat_opt import FlatSGDM as JFlatSGDM
from gaussiank_sgd_tpu.parallel.mesh import data_parallel_mesh, shard_batch
from gaussiank_sgd_tpu.parallel.trainstep import build_dp_train_step
from gaussiank_sgd_torch.compressors import get_compressor
from gaussiank_sgd_torch.parallel import gtopk, trainstep
from gaussiank_sgd_torch.parallel.bucketing import make_bucket_plan
from gaussiank_sgd_torch.parallel.flat_opt import FlatSGDM
from gaussiank_sgd_torch.training.config import TrainConfig
from test_torch_checkpoint import _w_ckpt
from test_torch_distributed import _shard_map, _spawn

REPO = pathlib.Path(__file__).resolve().parents[1]
CONFIG2 = str(REPO / "exp_configs" / "config2_vgg16_cifar10_gaussian.json")
NARROW = [8, "M", 8, "M", 16, "M", 16, "M", 16, "M"]
SHAPES = {"a": (300, 200), "b": (40_001,)}       # ravel order: a, then b
# the packed wire of the allreduce tests: 5 buckets of 4,096
CHUNK, N_BUCKETS = 4096, 5


def _bits(a):
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


def _same(port, ref):
    port = port.detach().numpy() if isinstance(port, torch.Tensor) else port
    np.testing.assert_array_equal(_bits(port), _bits(np.asarray(ref)))


def _sets(world, k, n, seed):
    """``world`` sparse sets of k pairs: valid indices distinct within a
    set and drawn from n/4 coordinates (most collide across sets), values
    at a few magnitudes (ties) with some pairs cancelling another set's,
    and ~10% padding slots (their bucket's base index, value +0.0)."""
    rng = np.random.default_rng(seed)
    idx = np.stack([rng.choice(n // 4, size=k, replace=False)
                    for _ in range(world)]).astype(np.int32) * 4
    val = (rng.choice([-1.0, 1.0], size=(world, k))
           * rng.choice([0.5, 1.0, 1.5, 2.0, 0.25], size=(world, k))
           * 10.0 ** rng.integers(-1, 2, size=(world, k))).astype(np.float32)
    for w in range(1, world):        # a pair that cancels set 0's
        shared = np.intersect1d(idx[0], idx[w])[:5]
        for i in shared:
            val[w][idx[w] == i] = -val[0][idx[0] == i]
    pad = rng.random((world, k)) < 0.1
    idx[pad] = (idx[pad] // CHUNK) * CHUNK
    val[pad] = 0.0
    return idx, val


def test_merge_sparse_matches_reference_bitwise():
    cases = [
        ([1, 5, 9], [1.0, -4.0, 2.0], [5, 2, 9], [-4.0, 0.5, -2.0], 3),
        ([0, 0], [0.0, 0.0], [7, 3], [2.0, -1.0], 2),
        ([0, 4, 0], [0.0, 3.0, 0.0], [0, 4, 8], [1.5, -3.0, 1.5], 3),
        ([2, 6, 10, 14], [1.0, -1.0, 1.0, -1.0],
         [14, 6, 3, 0], [1.0, -1.0, 1.0, 1.0], 4),
    ]
    idx, val = _sets(2, 400, 4000, seed=3)
    cases.append((idx[0], val[0], idx[1], val[1], 400))
    for ia, va, ib, vb, k in cases:
        arrays = [np.asarray(ia, np.int32), np.asarray(va, np.float32),
                  np.asarray(ib, np.int32), np.asarray(vb, np.float32)]
        got = gtopk.merge_sparse(*map(torch.from_numpy, arrays), k)
        want = jgtopk.merge_sparse(*map(jnp.asarray, arrays), k)
        for g, w in zip(got, want):
            _same(g, w)
    got = dict(zip(*(t.tolist() for t in gtopk.merge_sparse(
        *map(torch.tensor, ([1, 5, 9], [1.0, -4.0, 2.0], [5, 2, 9],
                            [-4.0, 0.5, -2.0])), 3))))
    assert got == {5: -8.0, 1: 1.0, 2: 0.5}


def _w_allreduce(rank, world, idx, val, chunk, n_buckets):
    from gaussiank_sgd_torch.compressors import CompressedGrad
    from gaussiank_sgd_torch.parallel import gtopk
    from gaussiank_sgd_torch.parallel.wire import WIRE_PACKED, WireFormat
    comp = CompressedGrad(torch.from_numpy(idx[rank]),
                          torch.from_numpy(val[rank]))
    out = {}
    for name, wf in (("legacy", None),
                     ("packed", WireFormat(WIRE_PACKED, chunk, n_buckets))):
        g, stats = gtopk.gtopk_allreduce(comp, wf)
        out[name] = (g.indices.numpy(), g.values.numpy(), stats.bytes_sent,
                     stats.rounds)
    return out


@pytest.mark.parametrize("world", [2, 4])
def test_gtopk_allreduce_matches_reference(tmp_path, world):
    k = 300
    idx, val = _sets(world, k, CHUNK * N_BUCKETS, seed=world)
    outs = _spawn(tmp_path, world, _w_allreduce, idx=idx, val=val,
                  chunk=CHUNK, n_buckets=N_BUCKETS)
    for name, wf in (("legacy", None),
                     ("packed", jwire.WireFormat(jwire.WIRE_PACKED, CHUNK,
                                                 N_BUCKETS))):
        sent = []

        def worker(i, v, wf=wf):
            g, comm = jgtopk.gtopk_allreduce(JComp(i, v), world, "dp",
                                             wire=wf)
            sent.append(comm.bytes_sent)
            return g.indices, g.values

        gi, gv = _shard_map(worker, world, 2, P("dp"))(
            jnp.asarray(idx.reshape(-1)), jnp.asarray(val.reshape(-1)))
        gi, gv = np.asarray(gi).reshape(world, k), np.asarray(gv).reshape(
            world, k)
        for r, out in enumerate(outs):
            o_idx, o_val, nbytes, rounds = out[name]
            _same(o_idx, gi[r])
            _same(o_val, gv[r])
            _same(o_idx, outs[0][name][0])           # the same on all ranks
            _same(o_val, outs[0][name][1])
            assert nbytes == sent[0] and rounds == int(np.log2(world))
        per_round = k * 8 if wf is None else (k + N_BUCKETS) * 4
        assert sent[0] == per_round * int(np.log2(world))


def _w_step(rank, world, p0, grads, sizes, density, opt, name, bucket):
    from gaussiank_sgd_torch.compressors import get_compressor
    from gaussiank_sgd_torch.parallel.bucketing import make_bucket_plan
    from gaussiank_sgd_torch.parallel.flat_opt import FlatSGDM
    from gaussiank_sgd_torch.parallel.trainstep import DPTrainStep
    plan = make_bucket_plan(sizes, density, **bucket)
    params = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    ts = DPTrainStep(lambda g: ((params * g).sum(), {}), params, {},
                     get_compressor(name, density=density), plan,
                     flat_opt=FlatSGDM(**opt), exchange="gtopk",
                     overlap="off")
    state = ts.init_state()
    out = {"wire": ts.wire_format, "fused": ts.fused_ef, "steps": [],
           "ef_numel": ts.ef_numel}
    for i, g in enumerate(grads[rank]):
        fn = ts.dense_step if i == 0 else ts.sparse_step
        m = fn(state, torch.from_numpy(g.copy()))
        out["steps"].append({
            "params": state.params.detach().numpy().copy(),
            "m": state.opt_state["m"].numpy().copy(),
            "ef": state.ef_residual.numpy().copy(),
            "skipped": float(m.skipped), "nsel": float(m.num_selected),
            "bytes": m.bytes_sent})
    return out


@pytest.mark.parametrize("name,bucket,wire", [
    ("topk", {}, "i32f32"),
    ("gaussian_fused", dict(bucket_size=65_536, policy="uniform"),
     "u16bf16")])
def test_gtopk_step_two_workers_matches_reference(tmp_path, name, bucket,
                                                  wire):
    world, density = 2, 0.001
    opt = dict(lr=2.0 ** -4, momentum=0.5, weight_decay=2.0 ** -11)
    rng = np.random.default_rng(1)
    p0 = {k: rng.normal(size=s).astype(np.float32) for k, s in SHAPES.items()}
    grads = [[{k: rng.normal(size=s).astype(np.float32)
               for k, s in SHAPES.items()} for _ in range(4)]
             for _ in range(world)]
    grads[0][3]["b"][17] = np.nan

    def jloss(p, mstate, batch, rng_):
        return sum(jnp.sum(p[k] * batch[k][0]) for k in SHAPES), (mstate, {})

    mesh = data_parallel_mesh(world)
    plan = jplan(p0, density, **bucket)
    jts = build_dp_train_step(jloss, None, jcomp(name, density=density),
                              plan, mesh, flat_opt=JFlatSGDM(**opt),
                              wire="auto", exchange="gtopk", overlap="off")
    assert jts.wire_format == wire
    jstate = jts.init_state(jax.tree.map(jnp.asarray, p0),
                            jax.random.PRNGKey(0))
    flat = [[np.asarray(ravel_pytree(g)[0]) for g in gw] for gw in grads]
    outs = _spawn(tmp_path, world, _w_step,
                  p0=np.asarray(ravel_pytree(p0)[0]), grads=flat,
                  sizes=[int(np.prod(s)) for s in SHAPES.values()],
                  density=density, opt=opt, name=name, bucket=bucket)
    n = plan.total_numel
    for i in range(4):
        batch = {k: np.stack([grads[w][i][k] for w in range(world)])
                 for k in SHAPES}
        jfn = jts.dense_step if i == 0 else jts.sparse_step
        jstate, jm = jfn(jstate, shard_batch(mesh, batch))
        jef = np.asarray(jstate.ef_residual).reshape(world, n)
        for r, out in enumerate(outs):
            assert out["wire"] == wire and out["fused"] is None
            assert out["ef_numel"] == n == jts.ef_numel
            st = out["steps"][i]
            _same(st["params"], ravel_pytree(jstate.params)[0])
            _same(st["m"], jstate.opt_state["m"])
            _same(st["ef"], jef[r])
            assert st["skipped"] == float(jm.skipped) == (i == 3)
            assert st["bytes"] == float(jm.bytes_sent)
            if i < 3:
                assert st["nsel"] == float(jm.num_selected)
    per_round = (plan.total_k * 8 if wire == "i32f32"
                 else (plan.total_k + len(plan.buckets)) * 4)
    assert outs[0]["steps"][1]["bytes"] == per_round


def test_gtopk_refuses_a_world_that_is_not_a_power_of_2(monkeypatch):
    monkeypatch.setattr(trainstep, "world_size", lambda: 3)
    p = torch.nn.Parameter(torch.zeros(100))
    args = (lambda g: ((p * g).sum(), {}), p, {}, get_compressor("topk"),
            make_bucket_plan([100], 0.1))
    with pytest.raises(ValueError, match="power-of-2 number of workers, "
                                         "got 3"):
        trainstep.DPTrainStep(*args, flat_opt=FlatSGDM(lr=0.1),
                              exchange="gtopk")
    trainstep.DPTrainStep(*args, flat_opt=FlatSGDM(lr=0.1))   # allgather
    with pytest.raises(ValueError, match="unknown exchange"):
        trainstep.DPTrainStep(*args, flat_opt=FlatSGDM(lr=0.1),
                              exchange="tree")
    comp = torch.zeros(4, dtype=torch.int32), torch.zeros(4)
    with pytest.raises(ValueError, match="got 6"):
        gtopk.butterfly_rounds(*comp, 6, 0)
    # a world of one runs no round and sends nothing
    g, stats = gtopk.gtopk_allreduce(gtopk.CompressedGrad(*comp))
    assert (stats.rounds, stats.bytes_sent) == (0, 0)
    assert g.indices is comp[0]


def test_gtopk_two_workers_resume_bit_for_bit(tmp_path):
    kw = TrainConfig(dnn="vgg16", batch_size=8, nworkers=2,
                     compressor="gaussian_fused", exchange="gtopk",
                     density=0.01, compress_warmup_steps=2, max_steps=8,
                     save_every_steps=4, eval_every_epochs=0, lr=0.05,
                     compute_dtype="float32", device="cpu",
                     model_kwargs={"cfg": NARROW}, output_dir=str(tmp_path),
                     run_id="g2").__dict__
    outs = _spawn(tmp_path, 2, _w_ckpt, cfg_kw=kw)
    for o in outs:
        assert o["resumed"] == o["losses"][4:]
        for a, b in zip(o["state"], o["resumed_state"]):
            np.testing.assert_array_equal(a, b)
    for a, b in zip(outs[0]["state"][:2], outs[1]["state"][:2]):
        np.testing.assert_array_equal(a, b)           # replicated
    n = outs[0]["state"][0].shape[0]
    assert outs[0]["state"][2].shape == (n,)          # no pad on gtopk
    row = torch.load(os.path.join(outs[0]["ckpt"], "step_00000004",
                                  "rank_00001.pt"), weights_only=True)
    assert row["ef_residual"].shape == (n,)
    assert not np.array_equal(outs[0]["state"][2], outs[1]["state"][2])


def test_cli_trains_two_workers_on_gtopk(tmp_path):
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc-per-node", "2", "-m", "gaussiank_sgd_torch.train",
           "--device", "cpu", "--config", CONFIG2, "--nworkers", "2",
           "--compressor", "gaussian_fused", "--exchange", "gtopk",
           "--bucket-size", "4096", "--bucket-policy", "uniform",
           "--max-steps", "3", "--compress-warmup-steps", "1",
           "--batch-size", "8", "--density", "0.01",
           "--compute-dtype", "float32", "--eval-every-epochs", "0",
           "--model-kwargs", json.dumps({"cfg": NARROW}),
           "--output-dir", str(tmp_path), "--run-id", "gtopk"]
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    proc = subprocess.run(cmd, cwd=REPO, env=env, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "rank=1/2 wire=u16bf16 exchange=gtopk" in proc.stderr
    lines = (tmp_path / "gtopk" / "steps.jsonl").read_text().splitlines()
    recs = [json.loads(line) for line in lines]
    assert [r["kind"] for r in recs] == ["dense", "sparse", "sparse"]
    assert all(np.isfinite(r["loss"]) for r in recs)
    # one round on the default (pipelined) schedule: the k u32 words go a
    # bucket at a time, with no count vector (the sequential round sends
    # k words and one i32 count a bucket)
    assert "overlap=auto: pipelined" in proc.stderr
    assert recs[1]["bytes_sent"] == recs[1]["k"] * 4
