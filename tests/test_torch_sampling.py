"""Parity of the port's DGC sampling and RedSync compressors
(``compressors/sampling.py`` and the registry's ``dgcsampling``,
``redsync`` and ``redsynctrim``) with the reference's.

* DGC: JAX's PRNG cannot be reproduced in torch, so the compress is held
  on the reference's own sample (``jax.random.randint`` of the same key):
  threshold, indices, values, residual and num_selected bit for bit. The
  port's draw comes from the compressor stream of (seed, step, bucket):
  every rank draws the same sample (each its own under
  ``decorrelate_comp_rng``), and a run resumed from a checkpoint redraws
  the uninterrupted run's samples, bit for bit to the end.
* RedSync's 20-pass threshold bit for bit, also where the passes miss the
  band [k, 2k]; ``redsync`` packs 2k slots and ``redsynctrim`` k, both bit
  for bit.
* The injected-gradient step at P = 1 with ``redsync`` on the packed wire
  (uniform 4,096-element buckets, 2k slots a bucket): params, momentum and
  EF row bit for bit against the reference's sequential step (its
  pipelined one, ``overlap="auto"``, shapes the payload of a bucket as k
  slots and fails on redsync's 2k; the port refuses it), bytes_sent 2k x
  4 B a bucket, and the EF invariant after the wire exact.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

from gaussiank_sgd_tpu.compressors import sampling as jsampling
from gaussiank_sgd_tpu.compressors.registry import get_compressor as jcomp
from gaussiank_sgd_tpu.parallel.bucketing import plan_for_params as jplan
from gaussiank_sgd_tpu.parallel.flat_opt import FlatSGDM as JFlatSGDM
from gaussiank_sgd_tpu.parallel.mesh import data_parallel_mesh, shard_batch
from gaussiank_sgd_tpu.parallel.trainstep import build_dp_train_step
from gaussiank_sgd_torch.compressors import decompress, get_compressor
from gaussiank_sgd_torch.compressors.sampling import (dgc_compress_at,
                                                      dgc_num_samples,
                                                      dgc_sample,
                                                      redsync_threshold)
from gaussiank_sgd_torch.parallel import trainstep
from gaussiank_sgd_torch.parallel.bucketing import make_bucket_plan
from gaussiank_sgd_torch.parallel.flat_opt import FlatSGDM
from gaussiank_sgd_torch.parallel.trainstep import DPTrainStep
from gaussiank_sgd_torch.training.config import TrainConfig
from gaussiank_sgd_torch.training.trainer import Trainer

NARROW = [8, "M", 8, "M", 16, "M", 16, "M", 16, "M"]


def _bits(t):
    a = (t.detach().numpy() if isinstance(t, torch.Tensor)
         else np.asarray(t))
    return a.view(np.int32) if a.dtype == np.float32 else a


def _same(got, want):
    np.testing.assert_array_equal(_bits(got), _bits(want))


def _same_result(r, jr):
    for got, want in ((r.compressed.indices, jr.compressed.indices),
                      (r.compressed.values, jr.compressed.values),
                      (r.residual, jr.residual),
                      (r.num_selected, jr.num_selected)):
        _same(got, want)


def _acc(n, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=n) * 10.0 ** rng.integers(-2, 2, size=n)
            ).astype(np.float32)


@pytest.mark.parametrize("n,k,density", [(20_000, 20, 0.001),
                                         (50_001, 501, 0.01),
                                         (3000, 300, 0.1)])
def test_dgc_on_the_reference_sample_bit_for_bit(n, k, density):
    acc = _acc(n, k)
    acc[::7] = acc[1]                      # ties at many magnitudes
    key = jax.random.PRNGKey(k)
    jr = jcomp("dgcsampling", density=density).fn(jnp.asarray(acc), k, key)
    num = dgc_num_samples(n, k)
    sample = np.array(jax.random.randint(key, (num,), 0, n))
    r = dgc_compress_at(torch.from_numpy(acc),
                        torch.from_numpy(sample).long(), k, density)
    _same_result(r, jr)
    assert r.compressed.k == k
    assert torch.equal(decompress(r.compressed, n) + r.residual,
                       torch.from_numpy(acc))


def test_dgc_draw_ranks_and_resumed_steps(monkeypatch):
    """The sample of (seed, step, bucket): in range, with replacement, the
    same on every rank and on a second draw of the step; each rank its own
    under ``decorrelate_comp_rng``; another step another sample."""
    n, k = 100_000, 100
    assert dgc_num_samples(n, k) == 1000
    assert dgc_num_samples(14_986_698, 14_987) == 149_867
    assert dgc_num_samples(50, 10) == 10            # max(k, ...)
    p = torch.nn.Parameter(torch.zeros(n))
    plan = make_bucket_plan([n], 0.001)

    def draws(decorrelate, step):
        out = []
        for r in (0, 1):
            monkeypatch.setattr(trainstep, "rank", lambda r=r: r)
            ts = DPTrainStep(lambda g: ((p * g).sum(), {}), p, {},
                             get_compressor("dgcsampling"), plan,
                             flat_opt=FlatSGDM(lr=0.1), seed=3,
                             decorrelate_comp_rng=decorrelate)
            out.append(dgc_sample(n, k, ts.comp_rng(step, p.device)(0)))
        return out

    a, b = draws(False, 5)
    assert torch.equal(a, b) and torch.equal(a, draws(False, 5)[1])
    assert a.dtype == torch.int64 and a.shape == (1000,)
    assert 0 <= int(a.min()) and int(a.max()) < n
    assert len(set(a.tolist())) < 1000           # drawn with replacement
    assert not torch.equal(a, draws(False, 6)[0])
    c, d = draws(True, 5)
    assert not torch.equal(c, d)


def test_dgc_run_resumes_bit_for_bit(tmp_path):
    """A narrow VGG with ``dgcsampling`` (2 dense + 6 sparse steps) saves at
    step 4; a fresh trainer resumed there draws the same samples and ends
    with the same losses, params, momentum and EF row."""
    def cfg(run_id, **kw):
        return TrainConfig(dnn="vgg16", batch_size=16, compressor="dgcsampling",
                           density=0.01, compress_warmup_steps=2, max_steps=8,
                           save_every_steps=4, eval_every_epochs=0, lr=0.05,
                           compute_dtype="float32", device="cpu",
                           model_kwargs={"cfg": NARROW},
                           output_dir=str(tmp_path), run_id=run_id, **kw)

    def snapshot(t):
        st = t.state
        return [st.params.detach().clone(), st.opt_state["m"].clone(),
                st.ef_residual.clone()]

    t = Trainer(cfg("a"))
    assert t.comp.requires_rng and t.ts.fused_ef is None
    t.fit()
    recs = t.records
    assert all(r["num_selected"] > 0 for r in recs if r["kind"] == "sparse")
    r = Trainer(cfg("b", resume=os.path.join(t.ckpt_dir, "step_00000004")))
    r.fit()
    assert [x["loss"] for x in r.records] == [x["loss"] for x in recs[4:]]
    for a, b in zip(snapshot(r), snapshot(t)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("kind", ["random", "miss", "flat", "zeros"])
def test_redsync_threshold_bit_for_bit(kind):
    n, k = 10_000, 50
    acc = _acc(n, 7)
    if kind == "miss":           # counts jump from < k to > 2k
        acc = np.where(np.arange(n) < 400, 1.0, 0.25).astype(np.float32)
    elif kind == "flat":
        acc = np.full(n, 0.5, np.float32)
    elif kind == "zeros":
        acc = np.zeros(n, np.float32)
    t = redsync_threshold(torch.from_numpy(acc).abs(), k)
    jt = jsampling._redsync_threshold(jnp.abs(jnp.asarray(acc)), k)
    _same(t, jt)
    cnt = int((np.abs(acc) > t.numpy()).sum())
    assert (k <= cnt <= 2 * k) == (kind == "random"), cnt


@pytest.mark.parametrize("name,slots", [("redsync", 2), ("redsynctrim", 1)])
@pytest.mark.parametrize("kind", ["random", "miss"])
def test_redsync_packs_bit_for_bit(name, slots, kind):
    n, k = 20_000, 40
    acc = _acc(n, 11)
    if kind == "miss":
        acc[:500] = 3.0                          # 500 > 2k at one magnitude
    spec, jspec = get_compressor(name), jcomp(name)
    assert spec.out_k(k) == jspec.out_k(k) == slots * k
    assert spec.name == jspec.name and not spec.requires_rng
    r = spec.fn(torch.from_numpy(acc), k)
    _same_result(r, jspec.fn(jnp.asarray(acc), k))
    assert r.compressed.k == slots * k
    assert torch.equal(decompress(r.compressed, n) + r.residual,
                       torch.from_numpy(acc))


def test_redsync_step_on_the_packed_wire_matches_reference():
    shapes = {"a": (300, 200), "b": (40_001,)}
    density, bucket = 0.01, dict(bucket_size=4096, policy="uniform")
    opt = dict(lr=2.0 ** -4, momentum=0.5, weight_decay=2.0 ** -11)
    rng = np.random.default_rng(0)
    p0 = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: rng.normal(size=s).astype(np.float32)
              for k, s in shapes.items()} for _ in range(3)]

    def jloss(p, mstate, batch, rng_):
        return sum(jnp.sum(p[k] * batch[k][0]) for k in shapes), (mstate, {})

    mesh = data_parallel_mesh(1)
    plan = jplan(p0, density, **bucket)
    jts = build_dp_train_step(jloss, None, jcomp("redsync", density=density),
                              plan, mesh, flat_opt=JFlatSGDM(**opt),
                              wire="auto", overlap="off")
    jstate = jts.init_state(jax.tree.map(jnp.asarray, p0),
                            jax.random.PRNGKey(0))
    tplan = make_bucket_plan([int(np.prod(s)) for s in shapes.values()],
                             density, **bucket)
    assert tplan == plan
    flat = [np.array(ravel_pytree(g)[0]) for g in grads]
    params = torch.nn.Parameter(torch.from_numpy(
        np.array(ravel_pytree(p0)[0])))
    ts = DPTrainStep(lambda g: ((params * g).sum(), {}), params, {},
                     get_compressor("redsync", density=density), tplan,
                     flat_opt=FlatSGDM(**opt), wire="auto", overlap="off")
    assert ts.wire_format == jts.wire_format == "u16bf16"
    state = ts.init_state()
    for i, g in enumerate(flat):
        jb = shard_batch(mesh, {k: v[i:i + 1] for k, v in
                                {k: np.stack([gr[k] for gr in grads])
                                 for k in shapes}.items()})
        if i:
            # the EF invariant after the wire, on this step's gradient
            acc = state.ef_residual + torch.from_numpy(g)
            payload, residual, _, _ = ts.pack_phase(state,
                                                    torch.from_numpy(g))
            sent = ts.unpack(payload, workers=1)
            assert torch.equal(decompress(sent, ts.ef_numel) + residual, acc)
        jfn = jts.sparse_step if i else jts.dense_step
        tfn = ts.sparse_step if i else ts.dense_step
        jstate, jm = jfn(jstate, jb)
        tm = tfn(state, torch.from_numpy(g))
        _same(state.params, ravel_pytree(jstate.params)[0])
        _same(state.opt_state["m"], jstate.opt_state["m"])
        _same(state.ef_residual, jstate.ef_residual)
        assert tm.bytes_sent == float(jm.bytes_sent)
        if i:
            assert float(tm.num_selected) == float(jm.num_selected)
            assert tm.bytes_sent == 2 * tplan.total_k * 4
