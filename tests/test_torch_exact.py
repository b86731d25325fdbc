"""Parity of the port's exact top-k compressors (``compressors/exact.py``
and the registry's ``topk``, ``approxtopk``, ``approxtopk16``) with the
reference's, on inputs made from a numpy seed.

* ``topk`` and ``approxtopk``: indices, values, residual and num_selected
  bit for bit against ``lax.top_k`` and the reference's
  ``approx_max_k`` (which XLA on the CPU lowers to the exact top-k), on
  random, all-equal, all-zero and repeated-magnitude inputs, with k = n,
  and through ``compress_buckets`` on a plan of several buckets. At k = n
  ``approx_max_k`` returns every index in an order of its own among ties,
  so there ``approxtopk``'s pairs are held sorted by index.
* ``approxtopk16`` ranks ``bf16(|acc|)``. The reference's bf16
  ``approx_max_k`` orders ties its own way, so the contract is: the
  multiset of sent bf16 magnitudes equal to the reference's; the index
  sets equal outside the entries tied with the k-th bf16 magnitude; the
  sent values ``acc[idx]`` bit for bit; the EF invariant exact; and the
  port's own order, larger bf16 magnitude first and ties lowest index
  first.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussiank_sgd_tpu.compressors.exact import (approx_topk_compress,
                                                 topk_compress as jtopk)
from gaussiank_sgd_tpu.compressors.registry import get_compressor as jcomp
from gaussiank_sgd_tpu.parallel.bucketing import make_bucket_plan as jplan
from gaussiank_sgd_tpu.parallel.trainstep import \
    compress_buckets as jcompress_buckets
from gaussiank_sgd_torch.compressors import decompress, get_compressor
from gaussiank_sgd_torch.compressors.base import magnitude_key
from gaussiank_sgd_torch.parallel.bucketing import make_bucket_plan
from gaussiank_sgd_torch.parallel.trainstep import compress_buckets


def _bits(t):
    a = t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
    return a.view(np.int32) if a.dtype == np.float32 else a


def _same(got, want):
    np.testing.assert_array_equal(_bits(got), _bits(want))


def _same_result(r, jr):
    for got, want in ((r.compressed.indices, jr.compressed.indices),
                      (r.compressed.values, jr.compressed.values),
                      (r.residual, jr.residual),
                      (r.num_selected, jr.num_selected)):
        _same(got, want)


def _input(kind, n):
    rng = np.random.default_rng(n)
    if kind == "random":
        x = rng.normal(size=n) * 10.0 ** rng.integers(-3, 3, size=n)
    elif kind == "all-equal":
        x = np.full(n, -0.75)
    elif kind == "all-zero":
        x = np.zeros(n)
        x[::3] = -0.0
    else:              # repeated magnitudes of both signs, and zeros
        x = rng.choice([-2.0, -1.0, -0.0, 0.0, 1.0, 2.0, 0.5], size=n)
    return x.astype(np.float32)


def _by_index(comp):
    order = np.argsort(np.asarray(comp.indices), kind="stable")
    return type(comp)(np.asarray(comp.indices)[order],
                      np.asarray(comp.values)[order])


CASES = [("random", 1000, 10), ("random", 50_001, 51), ("all-equal", 300, 7),
         ("all-zero", 300, 5), ("repeated", 2000, 300), ("repeated", 64, 64),
         ("random", 64, 64)]


@pytest.mark.parametrize("kind,n,k", CASES)
@pytest.mark.parametrize("name", ["topk", "approxtopk"])
def test_exact_topk_bit_for_bit(name, kind, n, k):
    acc = _input(kind, n)
    jfn = jtopk if name == "topk" else approx_topk_compress
    jr = jfn(jnp.asarray(acc), k)
    spec = get_compressor(name)
    before = acc.copy()
    r = spec.fn(torch.from_numpy(acc), k)
    if name == "approxtopk" and k == n:
        # every index: XLA's approx_max_k returns them in an order of its
        # own, so the pairs are held sorted by index
        _same_result(r._replace(compressed=_by_index(r.compressed)),
                     jr._replace(compressed=_by_index(jr.compressed)))
    else:
        _same_result(r, jr)
    _same(acc, before)                                  # acc untouched
    assert int(r.num_selected) == k == r.compressed.k
    assert torch.equal(decompress(r.compressed, n) + r.residual,
                       torch.from_numpy(acc))


def test_specs_match_the_reference():
    for name, alias, ours in (
            ("topk", "topk", "topk"),
            ("approxtopk", "approx_topk", "approxtopk(exact)"),
            ("approxtopk16", "approx_topk16", "approxtopk16(exact-bf16)")):
        for n in (name, alias):
            spec, jspec = get_compressor(n), jcomp(n)
            assert spec.name == ours and jspec.name == name
            for f in ("requires_rng", "uses_error_feedback", "stateful"):
                assert getattr(spec, f) == getattr(jspec, f), f
            assert spec.out_k(13) == jspec.out_k(13) == 13
            assert spec.fused_ef_fn is None and spec.batched_fn is None


@pytest.mark.parametrize("name", ["topk", "approxtopk"])
@pytest.mark.parametrize("kw", [dict(bucket_size=1000),
                                dict(bucket_size=700, policy="uniform")])
def test_compress_buckets_bit_for_bit(name, kw):
    sizes = [640, 3, 900, 5, 1200, 17]
    density = 0.01
    acc = _input("random", sum(sizes))
    acc[100:200] = 0.25                     # ties inside one bucket
    plan = make_bucket_plan(sizes, density, **kw)
    jp = jplan(sizes, density, **kw)
    assert plan == jp and len(plan.buckets) > 1
    comp, residual, nsel, st = compress_buckets(
        get_compressor(name, density=density), plan, torch.from_numpy(acc),
        None)
    jc, jres, jnsel, _ = jcompress_buckets(jcomp(name, density=density), jp,
                                           jnp.asarray(acc),
                                           jax.random.PRNGKey(0))
    _same(comp.indices, jc.indices)
    _same(comp.values, jc.values)
    _same(residual, jres)
    _same(nsel, jnsel)
    assert st is None and comp.k == plan.total_k


def _bf16_mag(x):
    return torch.from_numpy(x).abs().to(torch.bfloat16).float().numpy()


@pytest.mark.parametrize("n,k,seed", [(100_000, 1000, 0), (5000, 700, 1),
                                      (300, 7, 2)])
def test_approxtopk16_contract(n, k, seed):
    rng = np.random.default_rng(seed)
    acc = rng.normal(size=n).astype(np.float32)
    if n == 300:
        acc[:] = rng.choice([0.1, -0.1, 0.2], size=n)   # mostly ties
    jr = approx_topk_compress(jnp.asarray(acc), k,
                              select_dtype=jnp.bfloat16)
    r = get_compressor("approxtopk16").fn(torch.from_numpy(acc), k)
    idx = r.compressed.indices.numpy()
    jidx = np.asarray(jr.compressed.indices)
    mag = _bf16_mag(acc)
    np.testing.assert_array_equal(np.sort(mag[idx]), np.sort(mag[jidx]))
    kth = mag[idx].min()
    tied = set(np.flatnonzero(mag == kth).tolist())
    assert set(idx.tolist()) - tied == set(jidx.tolist()) - tied
    assert len(set(idx.tolist())) == k
    _same(r.compressed.values, acc[idx])
    _same(jr.compressed.values, acc[jidx])
    assert torch.equal(decompress(r.compressed, n) + r.residual,
                       torch.from_numpy(acc))
    assert int(r.num_selected) == k
    # the port's order: larger bf16 magnitude first, ties lowest index first
    order = sorted(range(n), key=lambda i: (-mag[i], i))[:k]
    np.testing.assert_array_equal(idx, order)


def test_magnitude_key_orders_as_lax_top_k():
    """Distinct, positive (zeros included), and ``torch.topk`` over it
    gives ``lax.top_k``'s indices on ties, signed zeros, denormals and
    infinities."""
    x = np.array([0.0, -0.0, 1.0, -1.0, 1e-45, -1e-45, np.inf, -np.inf,
                  3.5, -3.5, 1.0, 0.0], np.float32)
    key = magnitude_key(torch.from_numpy(x))
    assert (key > 0).all() and len(set(key.tolist())) == len(x)
    got = torch.topk(key, len(x)).indices.numpy()
    _, want = jax.lax.top_k(jnp.abs(jnp.asarray(x)), len(x))
    np.testing.assert_array_equal(got, np.asarray(want))
