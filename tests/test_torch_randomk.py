"""Parity of the port's RandomK and RandomKEC (``compressors/randomk.py``,
the registry and the train step's compressor stream) with the reference's.

JAX's PRNG cannot be reproduced in torch, so the draw and the compress are
held apart. The compress is held bit for bit against the reference's
functions on the indices the reference's own draw gives (indices, values,
residual, num_selected), with the EF bookkeeping ``decompress(sent) +
residual == acc`` exact for ``randomkec`` and a zero residual for
``randomk``. The draw is held by its statistics: k distinct indices in
range, uniform by a chi-squared test at a fixed seed (p > 1e-3). The
compressor stream comes from (seed, step, bucket) alone: every rank of a
P = 2 gloo group draws the same indices in a sparse step, bit for bit, and
under ``decorrelate_comp_rng`` each rank draws its own.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats

from gaussiank_sgd_tpu.compressors import randomk as jrk
from gaussiank_sgd_tpu.compressors.registry import get_compressor as jcomp
from gaussiank_sgd_torch.compressors import decompress, get_compressor
from gaussiank_sgd_torch.compressors.randomk import (comp_generator,
                                                     random_indices,
                                                     randomk_compress_at,
                                                     randomkec_compress_at)
from gaussiank_sgd_torch.parallel.bucketing import make_bucket_plan
from gaussiank_sgd_torch.parallel.trainstep import compress_buckets
from test_torch_distributed import _spawn


def _bits(t):
    a = t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
    return a.view(np.int32) if a.dtype == np.float32 else a


@pytest.mark.parametrize("name", ["randomk", "randomkec"])
@pytest.mark.parametrize("n,k", [(1000, 10), (50_001, 51)])
def test_compress_on_the_reference_draw_bit_for_bit(name, n, k):
    rng = np.random.default_rng(n + k)
    acc = rng.normal(size=n).astype(np.float32)
    key = jax.random.PRNGKey(k)
    jr = jcomp(name).fn(jnp.asarray(acc), k, key)
    idx = torch.from_numpy(np.asarray(jrk._random_indices(key, n, k)))
    at = randomk_compress_at if name == "randomk" else randomkec_compress_at
    r = at(torch.from_numpy(acc), idx)
    for got, want in ((r.compressed.indices, jr.compressed.indices),
                      (r.compressed.values, jr.compressed.values),
                      (r.residual, jr.residual),
                      (r.num_selected, jr.num_selected)):
        np.testing.assert_array_equal(_bits(got), _bits(want))
    sent = decompress(r.compressed, n)
    if name == "randomkec":
        assert torch.equal(sent + r.residual, torch.from_numpy(acc))
    else:
        assert not r.residual.any()
        assert torch.equal(sent[idx.long()], torch.from_numpy(acc)[
            idx.long()])


def test_registry_specs_match_the_reference():
    for name in ("randomk", "randomkec"):
        spec, jspec = get_compressor(name), jcomp(name)
        assert spec.name == jspec.name == name
        assert spec.requires_rng and jspec.requires_rng
        assert spec.uses_error_feedback == jspec.uses_error_feedback
        assert not spec.stateful and spec.out_k(9) == 9
        r = spec.fn(torch.arange(20.0), 4,
                    comp_generator(0, 0, 0, torch.device("cpu")))
        assert int(r.num_selected) == 4
    assert get_compressor("randomkec").uses_error_feedback
    assert not get_compressor("randomk").uses_error_feedback


def test_draw_is_k_distinct_uniform_indices():
    """Each draw k distinct in-range int32 indices; over 4,000 draws of 10
    of 100 (the generator of each (seed, step)), every index is drawn as
    often as uniformity predicts (chi-squared, 99 degrees of freedom)."""
    n, k, draws = 100, 10, 4000
    counts = np.zeros(n)
    for step in range(draws):
        idx = random_indices(n, k, comp_generator(7, step, 0,
                                                  torch.device("cpu")))
        assert idx.dtype == torch.int32 and idx.shape == (k,)
        assert len(set(idx.tolist())) == k
        assert 0 <= int(idx.min()) and int(idx.max()) < n
        counts[idx.numpy()] += 1
    p = stats.chisquare(counts).pvalue
    assert p > 1e-3, p
    # a large n: the top of 2^63 integer keys leaves no ties
    idx = random_indices(1_000_003, 1000, comp_generator(
        1, 2, 3, torch.device("cpu")))
    assert len(set(idx.tolist())) == 1000


def test_stream_depends_on_seed_step_bucket_and_rank():
    dev = torch.device("cpu")

    def draw(*a, **kw):
        return random_indices(10_000, 20, comp_generator(*a, dev, **kw))

    base = draw(3, 5, 0)
    assert torch.equal(base, draw(3, 5, 0))
    for other in (draw(4, 5, 0), draw(3, 6, 0), draw(3, 5, 1),
                  draw(3, 5, 0, rank=0)):
        assert not torch.equal(base, other)
    assert torch.equal(draw(3, 5, 0, rank=1), draw(3, 5, 0, rank=1))


def test_each_bucket_draws_its_own_indices():
    """A multi-bucket plan hands bucket i the generator of (seed, step,
    i), as the reference hands bucket i ``fold_in(rng, i)``; the indices
    come back global and the EF bookkeeping stays exact."""
    spec = get_compressor("randomkec", density=0.01)
    plan = make_bucket_plan([3000, 3000, 2500], 0.01, 3000,
                            policy="uniform")
    acc = torch.from_numpy(np.random.default_rng(0).normal(
        size=8500).astype(np.float32))
    dev = torch.device("cpu")
    comp, residual, nsel, st = compress_buckets(
        spec, plan, acc, None, lambda i: comp_generator(9, 4, i, dev))
    assert st is None and nsel.tolist() == [b.k for b in plan.buckets]
    assert torch.equal(decompress(comp, 8500) + residual, acc)
    for i, b in enumerate(plan.buckets):
        want = random_indices(b.size, b.k, comp_generator(9, 4, i, dev))
        got = comp.indices[sum(c.k for c in plan.buckets[:i]):][:b.k]
        assert torch.equal(got, want + b.offset)
    with pytest.raises(ValueError, match="needs a generator"):
        compress_buckets(spec, plan, acc, None, None)


def _w_randomk(rank, world, decorrelate):
    import torch
    from gaussiank_sgd_torch.compressors import get_compressor
    from gaussiank_sgd_torch.parallel.bucketing import make_bucket_plan
    from gaussiank_sgd_torch.parallel.flat_opt import FlatSGDM
    from gaussiank_sgd_torch.parallel.trainstep import DPTrainStep
    params = torch.zeros(40_000, requires_grad=True)
    g = torch.Generator().manual_seed(100 + rank)
    grads = [torch.randn(40_000, generator=g) for _ in range(2)]

    def loss_fn(batch):
        (i,) = batch
        return (params * grads[int(i)]).sum(), {}

    ts = DPTrainStep(loss_fn, params, {}, get_compressor("randomkec",
                                                         density=0.001),
                     make_bucket_plan([40_000], 0.001),
                     flat_opt=FlatSGDM(lr=0.1), seed=5,
                     decorrelate_comp_rng=decorrelate)
    state = ts.init_state()
    out = []
    for i in range(2):
        gr = ts.local_grads(state, (torch.tensor(i),))
        comp, residual, _, _ = ts.compress_phase(state, gr.flat_g)
        out.append((comp.indices.numpy(), comp.values.numpy()))
        ts.sparse_step(state, (torch.tensor(i),))
    return {"sent": out, "params": state.params.detach().numpy()}


@pytest.mark.parametrize("decorrelate", [False, True])
def test_ranks_draw_the_same_indices_unless_decorrelated(tmp_path,
                                                         decorrelate):
    """Two gloo ranks, each with its own gradient: in every sparse step
    both send the same index set (their values differ), so the exchange
    adds aligned coordinates, as the reference's shared key makes it; the
    next step draws another set; both ranks commit the same parameters.
    Under ``decorrelate_comp_rng`` the ranks' sets differ."""
    outs = _spawn(tmp_path, 2, _w_randomk, decorrelate=decorrelate)
    for step in range(2):
        (i0, v0), (i1, v1) = (o["sent"][step] for o in outs)
        assert len(set(i0.tolist())) == len(i0) == 40
        assert np.array_equal(i0, i1) != decorrelate
        assert not np.array_equal(v0, v1)
    assert not np.array_equal(outs[0]["sent"][0][0], outs[0]["sent"][1][0])
    np.testing.assert_array_equal(outs[0]["params"], outs[1]["params"])
