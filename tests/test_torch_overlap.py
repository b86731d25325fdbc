"""The port's bucket-pipelined step (``DPTrainStep(overlap="auto")``,
``parallel/trainstep.py``) against its sequential step and against the
reference's ``build_dp_train_step(..., overlap="auto")``; mirrors
``tests/test_overlap.py``.

* The batched compressors' host tail is independent across rows: a 1-row
  call on row i gives the bits row i of the batched call gives (B1's plain
  version and its stable sort, ``finish_pack`` and controller; B2's;
  ``gaussian_warm``'s, with one lane cold so the batch takes the other
  branch). The pipelined schedule rests on it.
* Pipelined against sequential, bit for bit after 3 sparse steps (params,
  momentum or trace, every rank's EF row, thresholds), on an injected
  gradient (the loss ``sum(p * G)`` has gradient exactly ``G``; each rank
  its own): allgather on both wires, ``randomk``, ``gaussian``,
  ``gaussian_warm``, ``FlatSGDM`` and the optax path, ``gaussian_fused``
  on a block-aligned uniform plan (B1's plain version a chunk) and on an
  unaligned one (B2's), at P = 1 in this process and at P = 2 over gloo
  (the spawn harness of ``tests/test_torch_distributed.py``); gtopk on
  both wires at P = 2 and 4; the two-level layout at 2 x 1 and 1 x 2.
  Every rank commits the same parameters.
* The port's ``overlap``, ``bytes_sent``, ``overlapped_bytes_sent``,
  ``pipeline_chunks`` and ``comm_rounds`` equal the reference's as
  integers, and its state the reference's bit for bit (warm thresholds
  within XLA's f32 ``pow``, 1 ulp, as ``tests/test_torch_trainstep.py``
  holds them), at P = 1, at P = 2 (gtopk on both wires, allgather with
  B1) and at P = 4 (gtopk).
* The gate: greedy and one-bucket plans and gtopk at one worker stay
  ``"off"``; an unknown ``overlap`` raises; ``redsync``'s 2k slots are
  refused on the pipelined schedule (the reference's fails there).
* The ``sparse_noexch`` twin: at P = 1 bit for bit the sparse step on
  either schedule; at P = 2 it issues no payload collective (counted);
  ``make_multi_step`` refuses an unknown kind; ``make_probes`` gives
  ``grads``, ``select`` and ``noexch``, none of which writes the caller's
  state.
* A checkpoint saved under one schedule restores under the other.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

from gaussiank_sgd_tpu.compressors.registry import get_compressor as jcomp
from gaussiank_sgd_tpu.parallel.bucketing import plan_for_params as jplan
from gaussiank_sgd_tpu.parallel.flat_opt import FlatSGDM as JFlatSGDM
from gaussiank_sgd_tpu.parallel.mesh import data_parallel_mesh, shard_batch
from gaussiank_sgd_tpu.parallel.trainstep import build_dp_train_step
from gaussiank_sgd_torch.compressors import get_compressor
from gaussiank_sgd_torch.compressors.gaussian import \
    gaussian_warm_compress_batched
from gaussiank_sgd_torch.ops import fused_select as fs
from gaussiank_sgd_torch.parallel.bucketing import make_bucket_plan
from gaussiank_sgd_torch.parallel.flat_opt import FlatSGDM, OptaxSGD
from gaussiank_sgd_torch.parallel.trainstep import DPTrainStep, flat_numel
from gaussiank_sgd_torch.training.checkpoint import (restore_checkpoint,
                                                     save_checkpoint)
from test_torch_distributed import _spawn

SHAPES = {"a": (300, 200), "b": (40_001,)}       # ravel order: a, then b
SIZES = [int(np.prod(s)) for s in SHAPES.values()]
OPT = dict(lr=2.0 ** -4, momentum=0.5, weight_decay=2.0 ** -11)
STEPS = 3

# name, density, uniform bucket size, wire, exchange, optimizer, layout
_CASES = {
    "topk-legacy": ("topk", 0.01, 20_000, "off", "allgather", "flat", None),
    "topk-packed": ("topk", 0.01, 20_000, "auto", "allgather", "flat", None),
    "randomk": ("randomk", 0.01, 20_000, "auto", "allgather", "flat", None),
    "gaussian": ("gaussian", 0.01, 20_000, "auto", "allgather", "flat",
                 None),
    "gaussian_warm": ("gaussian_warm", 0.01, 20_000, "auto", "allgather",
                      "flat", None),
    "optax": ("topk", 0.01, 20_000, "auto", "allgather", "optax", None),
    "fused-b1": ("gaussian_fused", 0.001, 65_536, "auto", "allgather",
                 "flat", None),
    "fused-b1-legacy": ("gaussian_fused", 0.001, 65_536, "off", "allgather",
                        "optax", None),
    "fused-b2": ("gaussian_fused", 0.01, 20_000, "auto", "allgather", "flat",
                 None),
    "gtopk-legacy": ("topk", 0.01, 20_000, "off", "gtopk", "flat", None),
    "gtopk-packed": ("topk", 0.01, 20_000, "auto", "gtopk", "flat", None),
    "two-level-2x1": ("gaussian_fused", 0.001, 65_536, "auto", "allgather",
                      "optax", (2, 1)),
    "two-level-1x2": ("topk", 0.01, 20_000, "auto", "allgather", "optax",
                      (1, 2)),
}
ONE_D = [c for c, v in _CASES.items()
         if v[4] == "allgather" and v[6] is None]
GTOPK = ["gtopk-legacy", "gtopk-packed"]
TWO_LEVEL = ["two-level-2x1", "two-level-1x2"]
WORLD_CASES = {1: ONE_D, 2: ONE_D + GTOPK + TWO_LEVEL, 4: GTOPK}
# the cases also held against the reference, by world size
REF_CASES = {1: ["topk-legacy", "topk-packed", "fused-b1", "fused-b2"],
             2: ["fused-b1", "gtopk-legacy", "gtopk-packed"],
             4: ["gtopk-packed"]}


def _bits(a):
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


def _same(a, b):
    np.testing.assert_array_equal(_bits(a), _bits(b))


def _problem(world):
    """Initial params and ``world`` workers' ``STEPS`` gradients, as
    pytrees (the reference's) and flat f32 (the port's)."""
    rng = np.random.default_rng(world)
    p0 = {k: rng.normal(size=s).astype(np.float32) for k, s in SHAPES.items()}
    grads = [[{k: rng.normal(size=s).astype(np.float32)
               for k, s in SHAPES.items()} for _ in range(STEPS)]
             for _ in range(world)]
    flat = [[np.asarray(ravel_pytree(g)[0]) for g in gw] for gw in grads]
    return p0, grads, np.asarray(ravel_pytree(p0)[0]), flat


def _w_schedules(rank, world, p0, grads, sizes, cases, opt, steps,
                 count_collectives=False):
    """Each case on both schedules (``overlap`` off, then auto), ``steps``
    sparse steps on this rank's gradients: the final state, the last
    step's metrics and the schedule's name. With ``count_collectives``,
    also the payload collectives (all-gathers, point-to-point batches) and
    all-reduces one ``sparse`` and one ``sparse_noexch`` step issue."""
    from gaussiank_sgd_torch.compressors import get_compressor
    from gaussiank_sgd_torch.parallel.bucketing import make_bucket_plan
    from gaussiank_sgd_torch.parallel.flat_opt import FlatSGDM, OptaxSGD
    from gaussiank_sgd_torch.parallel.mesh import hierarchical_dp_mesh
    from gaussiank_sgd_torch.parallel.trainstep import (DPTrainStep,
                                                        flat_numel)
    calls = {"payload": 0, "all_reduce": 0}
    if count_collectives:
        import torch.distributed as dist

        def counted(fn, key):
            def wrapper(*a, **kw):
                calls[key] += 1
                return fn(*a, **kw)
            return wrapper
        for name in ("all_gather_single", "all_gather_into_tensor",
                     "batch_isend_irecv"):
            if hasattr(dist, name):
                setattr(dist, name, counted(getattr(dist, name), "payload"))
        dist.all_reduce = counted(dist.all_reduce, "all_reduce")
    out = {}
    for cid, (name, density, bucket, wire, exchange, optim,
              layout) in cases.items():
        plan = make_bucket_plan(sizes, density, bucket, policy="uniform")
        out[cid] = {}
        for overlap in ("off", "auto"):
            spec = get_compressor(name, density=density)
            n, npad = plan.total_numel, flat_numel(spec, plan, exchange)
            params = torch.nn.Parameter(torch.from_numpy(
                np.pad(p0, (0, npad - n))))
            kw = (dict(flat_opt=FlatSGDM(**opt)) if optim == "flat"
                  else dict(optimizer=OptaxSGD(**opt)))
            mesh = hierarchical_dp_mesh(*layout) if layout else None
            ts = DPTrainStep(lambda g, p=params: ((p * g).sum(), {}), params,
                             {}, spec, plan, wire=wire, exchange=exchange,
                             overlap=overlap, mesh=mesh, **kw)
            state = ts.init_state()
            padded = [torch.from_numpy(np.pad(g, (0, npad - n)))
                      for g in grads[rank]]
            for g in padded[:steps]:
                m = ts.sparse_step(state, g)
            res = {"overlap": ts.overlap, "wire": ts.wire_format,
                   "fused": ts.fused_ef, "ef_numel": npad,
                   "params": state.params.detach().numpy().copy(),
                   "opt": {k: v.numpy().copy()
                           for k, v in state.opt_state.items()},
                   "ef": state.ef_residual.numpy().copy(),
                   "comp_state": (None if state.comp_state is None
                                  else state.comp_state.numpy().copy()),
                   "metrics": {k: float(getattr(m, k)) for k in (
                       "bytes_sent", "overlapped_bytes_sent",
                       "pipeline_chunks", "comm_rounds", "num_selected")}}
            if count_collectives:
                for kind in ("sparse", "sparse_noexch"):
                    before = dict(calls)
                    ts.make_multi_step(kind, 1)(state, padded[0])
                    res[kind] = {k: calls[k] - before[k] for k in calls}
            out[cid][overlap] = res
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every world's run of its cases: P = 1 in this process (no process
    group), P = 2 and 4 as gloo processes; P = 2 also counts the twin's
    collectives."""
    out = {}
    for world, cids in WORLD_CASES.items():
        _, _, p0, flat = _problem(world)
        args = dict(p0=p0, grads=flat, sizes=SIZES, opt=OPT, steps=STEPS,
                    cases={c: _CASES[c] for c in cids},
                    count_collectives=world == 2)
        if world == 1:
            out[world] = [_w_schedules(0, 1, **args)]
        else:
            out[world] = _spawn(tmp_path_factory.mktemp(f"p{world}"), world,
                                _w_schedules, **args)
    return out


# --------------------------------------------------- the batched host tail

def _rows_equal(batched, rows):
    """Row i of each of the batched call's outputs equals the 1-row call's
    output on row i."""
    (rb, sb), parts = batched, rows
    for i, (r, s) in enumerate(parts):
        for a, b in ((rb.compressed.indices[i], r.compressed.indices[0]),
                     (rb.compressed.values[i], r.compressed.values[0]),
                     (rb.residual[i], r.residual[0]),
                     (rb.num_selected.reshape(-1)[i],
                      r.num_selected.reshape(-1)[0]),
                     (sb[i], s[0])):
            _same(a.numpy(), b.numpy())


@pytest.mark.parametrize("name", ["fused_ef (B1)", "fused (B2)",
                                  "gaussian_warm"])
def test_batched_host_tail_is_row_independent(name):
    """A 1-row call on each row of a ``[6, 4096]`` batch gives that row's
    bits of the batched call: candidates, the stable sort, ``finish_pack``,
    the count and the controller. Thresholds: cold rows (0), warm rows,
    and one warm row far too high (``gaussian_warm``: unusable, so the
    batch takes the estimate branch while the other rows' 1-row calls take
    the warm one)."""
    density, chunk = 0.01, 4096
    k = int(np.ceil(density * chunk))
    rng = np.random.default_rng(5)
    res = torch.from_numpy(rng.normal(size=(6, chunk)).astype(np.float32))
    g = torch.from_numpy(rng.normal(size=(6, chunk)).astype(np.float32))
    t = torch.tensor([0.0, 0.0, 2.4, 2.6, 2.5, 50.0])
    if name == "fused_ef (B1)":
        fn = lambda i: fs.gaussian_fused_ef_compress_batched(  # noqa: E731
            res[i], g[i], 0.5, k, t[i], density=density)
    elif name == "fused (B2)":
        fn = lambda i: fs.gaussian_fused_compress_batched(  # noqa: E731
            res[i], k, t[i], density=density)
    else:
        fn = lambda i: gaussian_warm_compress_batched(  # noqa: E731
            res[i], k, t[i], density=density)
    _rows_equal(fn(slice(None)), [fn(slice(i, i + 1)) for i in range(6)])


# ------------------------------------------------- pipelined vs sequential

@pytest.mark.parametrize("world,cid", [(w, c) for w, cs in
                                       WORLD_CASES.items() for c in cs])
def test_pipelined_is_bitwise_the_sequential_step(runs, world, cid):
    for r, out in enumerate(runs[world]):
        seq, pipe = out[cid]["off"], out[cid]["auto"]
        assert (seq["overlap"], pipe["overlap"]) == ("off", "pipelined")
        for key in ("params", "ef"):
            _same(seq[key], pipe[key])
        for key in seq["opt"]:
            _same(seq["opt"][key], pipe["opt"][key])
        if seq["comp_state"] is not None:
            _same(seq["comp_state"], pipe["comp_state"])
        ms, mp = seq["metrics"], pipe["metrics"]
        assert ms["overlapped_bytes_sent"] == ms["pipeline_chunks"] == 0
        assert 0 < mp["overlapped_bytes_sent"] < mp["bytes_sent"]
        assert mp["pipeline_chunks"] == -(-sum(SIZES) // _CASES[cid][2])
        assert ms["num_selected"] == mp["num_selected"]
        if _CASES[cid][4] == "allgather":
            assert ms["bytes_sent"] == mp["bytes_sent"]
        # every rank commits the same parameters
        _same(pipe["params"], runs[world][0][cid]["auto"]["params"])
    if _CASES[cid][0] == "gaussian_fused" and _CASES[cid][2] == 65_536:
        assert runs[world][0][cid]["auto"]["fused"] == (2, 65_536, 65_536)


# --------------------------------------------------------- the reference

def _reference(world, cid):
    """The reference's pipelined step on the case: its final state and
    last metrics."""
    name, density, bucket, wire, exchange, optim, _ = _CASES[cid]
    assert optim == "flat"
    p0, grads, _, _ = _problem(world)

    def jloss(p, mstate, batch, rng_):
        return sum(jnp.sum(p[k] * batch[k][0]) for k in SHAPES), (mstate, {})

    mesh = data_parallel_mesh(world)
    plan = jplan(p0, density, bucket, policy="uniform")
    jts = build_dp_train_step(jloss, None, jcomp(name, density=density),
                              plan, mesh, flat_opt=JFlatSGDM(**OPT),
                              wire=wire, exchange=exchange, overlap="auto")
    jstate = jts.init_state(jax.tree.map(jnp.asarray, p0),
                            jax.random.PRNGKey(0))
    for i in range(STEPS):
        batch = {k: np.stack([grads[w][i][k] for w in range(world)])
                 for k in SHAPES}
        jstate, jm = jts.sparse_step(jstate, shard_batch(mesh, batch))
    return jts, jstate, jm


@pytest.mark.parametrize("world,cid", [(w, c) for w, cs in
                                       REF_CASES.items() for c in cs])
def test_schedule_and_state_match_the_reference(runs, world, cid):
    jts, jstate, jm = _reference(world, cid)
    n = sum(SIZES)
    jef = np.asarray(jstate.ef_residual).reshape(world, -1)
    for r, out in enumerate(runs[world]):
        pipe = out[cid]["auto"]
        assert pipe["overlap"] == jts.overlap == "pipelined"
        assert pipe["wire"] == jts.wire_format
        assert pipe["ef_numel"] == jts.ef_numel
        for key in ("bytes_sent", "overlapped_bytes_sent", "pipeline_chunks",
                    "comm_rounds"):
            want = int(float(getattr(jm, key)))
            assert int(pipe["metrics"][key]) == want, key
        assert pipe["metrics"]["num_selected"] == float(jm.num_selected)
        _same(pipe["params"][:n], ravel_pytree(jstate.params)[0])
        _same(pipe["opt"]["m"][:n], jstate.opt_state["m"])
        _same(pipe["ef"], jef[r])
        if pipe["comp_state"] is not None:
            # warm thresholds: XLA's f32 pow, within 1 ulp
            np.testing.assert_array_max_ulp(
                pipe["comp_state"][0],
                np.asarray(jstate.comp_state).reshape(world, -1)[r], 1)


# ---------------------------------------------------------------- the gate

def _step(spec_name="topk", bucket=20_000, policy="uniform", density=0.01,
          **kw):
    plan = make_bucket_plan(SIZES, density, bucket, policy=policy)
    spec = get_compressor(spec_name, density=density)
    params = torch.nn.Parameter(torch.zeros(flat_numel(spec, plan)))
    return DPTrainStep(lambda g: ((params * g).sum(), {}), params, {}, spec,
                       plan, flat_opt=FlatSGDM(**OPT), **kw)


def test_ineligible_plans_stay_sequential():
    """Greedy and one-bucket plans keep the sequential step under
    ``auto``, and so does gtopk at one worker (no partner for round 1);
    ``overlap="off"`` always does; an unknown value and ``redsync``'s 2k
    slots on the pipelined schedule are refused."""
    assert _step(bucket=30_000, policy="greedy").overlap == "off"
    assert len(_step(bucket=1 << 20).plan.buckets) == 1
    assert _step(bucket=1 << 20).overlap == "off"
    assert _step(exchange="gtopk").overlap == "off"
    assert _step(overlap="off").overlap == "off"
    assert _step().overlap == "pipelined"
    with pytest.raises(ValueError, match="overlap"):
        _step(overlap="always")
    with pytest.raises(ValueError, match="overlap='off'"):
        _step("redsync")
    assert _step("redsync", overlap="off").overlap == "off"
    ts = _step(bucket=30_000, policy="greedy")
    m = ts.sparse_step(ts.init_state(), torch.ones(sum(SIZES)))
    assert (m.overlapped_bytes_sent, m.pipeline_chunks, m.comm_rounds) == (
        0.0, 0, 1)


# ------------------------------------------------------------ the twin

@pytest.mark.parametrize("cid", ["topk-packed", "fused-b1", "optax"])
def test_noexch_twin_at_one_worker_is_the_sparse_step(cid):
    """At one worker the twin's tile is the gather's result: 3 steps of
    ``sparse_noexch`` equal 3 sparse steps bit for bit on both
    schedules."""
    name, density, bucket, wire, _, optim, _ = _CASES[cid]
    _, _, p0, flat = _problem(1)
    plan = make_bucket_plan(SIZES, density, bucket, policy="uniform")
    for overlap in ("off", "auto"):
        states = []
        for kind in ("sparse", "sparse_noexch"):
            spec = get_compressor(name, density=density)
            npad = flat_numel(spec, plan)
            params = torch.nn.Parameter(torch.from_numpy(
                np.pad(p0, (0, npad - p0.size))))
            kw = (dict(flat_opt=FlatSGDM(**OPT)) if optim == "flat"
                  else dict(optimizer=OptaxSGD(**OPT)))
            ts = DPTrainStep(lambda g, p=params: ((p * g).sum(), {}), params,
                             {}, spec, plan, wire=wire, overlap=overlap, **kw)
            run = ts.make_multi_step(kind, 1)
            state = ts.init_state()
            for g in flat[0]:
                state, m = run(state, torch.from_numpy(
                    np.pad(g, (0, npad - g.size))))
            states.append((state, m))
        (a, ma), (b, mb) = states
        for x, y in [(a.params, b.params), (a.ef_residual, b.ef_residual)] + [
                (a.opt_state[k], b.opt_state[k]) for k in a.opt_state]:
            _same(x.detach().numpy(), y.detach().numpy())
        assert ma.bytes_sent == mb.bytes_sent
        assert ma.overlapped_bytes_sent == mb.overlapped_bytes_sent


@pytest.mark.parametrize("cid", ["topk-legacy", "topk-packed", "optax",
                                 "gtopk-legacy", "gtopk-packed",
                                 "two-level-1x2"])
def test_noexch_twin_issues_no_payload_collective(runs, cid):
    """At P = 2 a sparse step issues payload collectives (one all-gather a
    payload tensor, or a chunk of it; gtopk's hops) and the twin none,
    while the twin keeps the metric all-reduces."""
    n_chunks = -(-sum(SIZES) // _CASES[cid][2])
    for out in runs[2]:
        for overlap in ("off", "auto"):
            res = out[cid][overlap]
            assert res["sparse"]["payload"] > 0
            assert res["sparse_noexch"]["payload"] == 0
            assert res["sparse_noexch"]["all_reduce"] > 0
            if cid.startswith("topk") and overlap == "auto":
                n_tensors = 2 if cid == "topk-legacy" else 1
                assert res["sparse"]["payload"] == n_chunks * n_tensors


def test_multi_step_kinds_and_probes():
    """``make_multi_step`` refuses an unknown kind; the probes are
    ``grads`` and ``select`` (scalars) and ``noexch`` (a state copy one
    step on, and metrics), and none writes the caller's state: not the
    parameter, not a float buffer the forward updates in place (as
    BatchNorm's statistics), not the EF row, momentum, thresholds or
    step, and they leave the dropout generator they are given where it
    was."""
    plan = make_bucket_plan(SIZES, 0.001, 65_536, policy="uniform")
    spec = get_compressor("gaussian_fused", density=0.001)
    params = torch.nn.Parameter(torch.randn(flat_numel(spec, plan)))
    buf = torch.zeros(4)
    gen = torch.Generator().manual_seed(0)

    def loss_fn(g):
        with torch.no_grad():
            buf.mul_(0.5).add_(1.0)          # a running statistic
        keep = (torch.rand(4, generator=gen) > 0.1).float()   # a dropout draw
        return (params * g).sum() + 0.0 * keep.sum(), {}

    ts = DPTrainStep(loss_fn, params, {"stats": buf}, spec, plan,
                     flat_opt=FlatSGDM(**OPT))
    assert ts.overlap == "pipelined"
    with pytest.raises(ValueError, match="multi-step kind"):
        ts.make_multi_step("bogus", 2)
    state = ts.init_state()
    g = torch.randn(ts.ef_numel)
    g[sum(SIZES):] = 0.0
    ts.sparse_step(state, g)
    before = (state.step, params.detach().clone(), buf.clone(),
              state.ef_residual.clone(), state.opt_state["m"].clone(),
              state.comp_state.clone())
    gen_before = gen.get_state()
    probes = ts.make_probes(gen)
    assert set(probes) == {"grads", "select", "noexch"}
    assert probes["grads"](state, g).dim() == 0
    assert probes["select"](state, g).dim() == 0
    st, m = probes["noexch"](state, g)
    assert st.step == state.step + 1 and np.isfinite(float(m.loss))
    after = (state.step, params.detach(), buf, state.ef_residual,
             state.opt_state["m"], state.comp_state)
    assert before[0] == after[0]
    for x, y in zip(before[1:], after[1:]):
        _same(x.numpy(), y.numpy())
    assert torch.equal(gen.get_state(), gen_before)


# ------------------------------------------------------------ checkpoints

def test_checkpoint_crosses_schedules(tmp_path):
    """A checkpoint sealed under one schedule restores under the other:
    the schedule is a property of the step, not of the state; the restored
    step then matches the saved run's next step bit for bit."""
    _, _, p0, flat = _problem(1)
    plan = make_bucket_plan(SIZES, 0.001, 65_536, policy="uniform")
    spec = get_compressor("gaussian_fused", density=0.001)
    npad = flat_numel(spec, plan)
    grads = [torch.from_numpy(np.pad(g, (0, npad - g.size))) for g in flat[0]]

    def build(overlap):
        params = torch.nn.Parameter(torch.from_numpy(
            np.pad(p0, (0, npad - p0.size))))
        ts = DPTrainStep(lambda g: ((params * g).sum(), {}), params, {},
                         get_compressor("gaussian_fused", density=0.001),
                         plan, flat_opt=FlatSGDM(**OPT), overlap=overlap)
        return ts, ts.init_state()

    for src, dst in (("auto", "off"), ("off", "auto")):
        ts_s, state = build(src)
        ts_s.sparse_step(state, grads[0])
        assert state.ef_residual.abs().sum() > 0
        path = save_checkpoint(str(tmp_path / f"ck_{src}"), state, sum(SIZES))
        ts_s.sparse_step(state, grads[1])
        ts_d, fresh = build(dst)
        assert ts_d.overlap != ts_s.overlap
        restore_checkpoint(path, fresh, ts_d.ef_numel)
        ts_d.sparse_step(fresh, grads[1])
        for a, b in ((state.params, fresh.params),
                     (state.ef_residual, fresh.ef_residual),
                     (state.opt_state["m"], fresh.opt_state["m"]),
                     (state.comp_state, fresh.comp_state)):
            _same(a.detach().numpy(), b.detach().numpy())
