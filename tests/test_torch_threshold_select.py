"""Parity of the port's three-pass threshold estimate
(gaussiank_sgd_torch/ops/threshold_select.py) with the reference's Pallas
estimator (gaussiank_sgd_tpu/ops/pallas_select.py).

The same numpy inputs go to both. The reference's Pallas kernels run in
interpret mode on the CPU, as tests/test_pallas_select.py runs them; the
port runs its kernels' plain versions, which is what its wrappers take for
CPU tensors. The kernels themselves are held to those plain versions on the
card by chip_smoke.py and tests/test_torch_kernels_cuda.py.

Tolerances, each with its reason:

* counts, max|x|, brackets, packs and residuals: bit for bit;
* the two sums of ``fused_stats`` differ only in summation order:
  ``|d sum| <= 1e-6 * sum|x|`` and ``|d sumsq| <= 1e-5 * sumsq``;
* the candidate thresholds go through f32 ``exp``/``log`` that are not
  XLA's, and XLA may fuse ``lo + (hi - lo) * f`` into one multiply-add:
  log candidates within 4 ulp, linear ones within 2 ulp of the
  reference's on identical inputs;
* the estimate itself then sits on a candidate a few ulp from the
  reference's (rtol 1e-5), and the count it selects is within 5% of k, the
  reference's own contract.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from gaussiank_sgd_tpu.compressors.base import k_for
from gaussiank_sgd_tpu.ops import pallas_select as J
from gaussiank_sgd_torch.compressors import base as tbase
from gaussiank_sgd_torch.compressors import get_compressor
from gaussiank_sgd_torch.ops import threshold_select as T


def _bits(a):
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


def _eq(a, b):
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    np.testing.assert_array_equal(_bits(a), _bits(b))


def _t(a):
    return torch.from_numpy(np.array(a))


def _grad(n=300_000, dist="normal", seed=0, scale=0.01):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=n) if dist == "normal" else rng.laplace(size=n)
    return (x * scale).astype(np.float32)


def test_fused_stats_matches_reference():
    x = _grad(100_001)             # deliberately not a multiple of 8192
    js, jss, jm = J.fused_stats(jnp.asarray(x))
    ts, tss, tm = T.fused_stats(_t(x))
    _eq(tm, jm)
    assert abs(float(ts) - float(js)) <= 1e-6 * float(np.abs(x).sum())
    assert abs(float(tss) - float(jss)) <= 1e-5 * float(jss)
    assert T.LAUNCHES == {"fused_stats": 0, "multi_threshold_counts": 0}


def _count_case(case):
    """``(x, thresholds)`` for one edge of the counting contract. Only
    thresholds >= 0 (or NaN): the reference pads x with zeros to a multiple
    of 8192 and counts the padding at a negative threshold; the port counts
    the n real elements only (the card tests hold negative ones)."""
    x = _grad(100_001, seed=1)
    rng = np.random.default_rng(2)
    t = np.sort(np.abs(rng.normal(size=32)) * 0.02).astype(np.float32)
    if case == "mixed":
        t[[3, 17]] = t[[17, 3]]                    # any order
        t[5] = t[6]                                # a duplicate
        t[0], t[31] = 0.0, np.abs(x).max()         # ends: all and none
        t[9] = np.abs(x)[123]                      # exactly on an entry
    elif case == "nan_inf_in_x":
        x[[7, 70_000]] = np.nan
        x[[8, 9]] = np.inf, -np.inf
        x[10] = -0.0
    elif case == "nan_threshold":
        t[[4, 20]] = np.nan
    elif case == "inf_threshold":
        t[[12, 31]] = np.inf
    elif case == "neg_zero_threshold":
        t[[0, 6]] = -0.0, 0.0
        x[:1000:7] = 0.0
    elif case == "all_equal":
        t[:] = t[16]
    elif case == "descending":
        t = t[::-1].copy()
    elif case == "random_with_duplicates":
        t = rng.permutation(np.repeat(t[::4], 4)).astype(np.float32)
    return x, t


@pytest.mark.parametrize("case", [
    "mixed", "nan_inf_in_x", "nan_threshold", "inf_threshold",
    "neg_zero_threshold", "all_equal", "descending",
    "random_with_duplicates"])
def test_multi_threshold_counts_match_reference_bitwise(case):
    x, t = _count_case(case)
    jc = J.multi_threshold_counts(jnp.asarray(x), jnp.asarray(t))
    tc = T.multi_threshold_counts(_t(x), _t(t))
    _eq(tc, jc)
    assert tc.dtype == torch.float32
    if case == "mixed":
        assert float(tc[0]) == 100_001 and float(tc[31]) == 0


@pytest.mark.parametrize("k", [5, 400, 90_000, 200_000])
def test_bracket_matches_reference(k):
    """A bracket inside the candidates (k = 400, 5) and both degenerate
    cases: k above every count (-> [0, t_0]) and below every count
    (-> [t_31, t_31])."""
    x = _grad(100_000, seed=3)
    t = np.geomspace(0.02, 0.05, 32).astype(np.float32)
    if k == 90_000:
        t = np.geomspace(1e-6, 2e-5, 32).astype(np.float32)
    counts = np.asarray(J.multi_threshold_counts(jnp.asarray(x),
                                                 jnp.asarray(t)))
    jlo, jhi = J._bracket(jnp.asarray(t), jnp.asarray(counts), k)
    tlo, thi = T._bracket(_t(t), _t(counts), k)
    _eq(tlo, jlo)
    _eq(thi, jhi)
    if k == 200_000:
        assert float(tlo) == 0.0 and float(thi) == t[0]
    if k == 90_000:
        assert float(tlo) == float(thi) == t[31]


def test_candidate_thresholds_match_reference():
    """The fractions are ``jnp.linspace(0, 1, 32)`` bit for bit (which is
    not ``np.linspace``'s correctly rounded i/31); the candidates are held
    at the ulp bounds of the module docstring."""
    frac = T._fractions("cpu")
    _eq(frac, jnp.linspace(0.0, 1.0, 32))
    assert not np.array_equal(frac.numpy(),
                              np.linspace(0, 1, 32, dtype=np.float32))
    rng = np.random.default_rng(4)
    for lo0, hi0 in rng.uniform(1e-6, 1.0, size=(20, 2)).astype(np.float32):
        lo0, hi0 = min(lo0, hi0), max(lo0, hi0) * 3
        jl = lo0 * jnp.exp(jnp.linspace(0.0, 1.0, 32)
                           * jnp.log(jnp.float32(hi0) / lo0))
        tl = T._log_candidates(torch.tensor(lo0), torch.tensor(hi0))
        np.testing.assert_array_max_ulp(tl.numpy(), np.asarray(jl), 4)
        jlin = lo0 + (hi0 - lo0) * jnp.linspace(0.0, 1.0, 32)
        tlin = T._lin_candidates(torch.tensor(lo0), torch.tensor(hi0))
        np.testing.assert_array_max_ulp(tlin.numpy(), np.asarray(jlin), 2)


@pytest.mark.parametrize("dist", ["normal", "laplace"])
@pytest.mark.parametrize("density", [0.001, 0.01, 0.1])
def test_threshold_estimate_matches_reference(dist, density):
    """The count the estimate selects is within 5% of k (the reference's
    contract), and the threshold is the reference's within rtol 1e-5."""
    x = _grad(dist=dist)
    k = k_for(x.size, density)
    jt = float(J.pallas_threshold_estimate(jnp.asarray(x), k))
    tt = T.pallas_threshold_estimate(_t(x), k)
    assert tt.dtype == torch.float32 and tt.dim() == 0
    cnt = int((np.abs(x) > float(tt)).sum())
    assert abs(cnt - k) <= max(0.05 * k, 3), (cnt, k)
    np.testing.assert_allclose(float(tt), jt, rtol=1e-5)


def test_edge_cases_match_reference():
    """All zeros: threshold 0. All ones: the bracket degenerates and any
    threshold selects all or nothing; the pack still sends exactly k and
    the residual keeps the rest."""
    z = np.zeros(4096, np.float32)
    assert float(T.pallas_threshold_estimate(_t(z), 10)) == 0.0 == float(
        J.pallas_threshold_estimate(jnp.asarray(z), 10))
    ones = np.ones(4096, np.float32)
    # on the linear candidates, so within their ulp bound
    np.testing.assert_array_max_ulp(
        T.pallas_threshold_estimate(_t(ones), 41).numpy(),
        np.asarray(J.pallas_threshold_estimate(jnp.asarray(ones), 41)), 4)
    r = T.pallas_gaussian_compress(_t(ones), 41)
    jr = J.pallas_gaussian_compress(jnp.asarray(ones), 41)
    _eq(r.compressed.indices, jr.compressed.indices)
    _eq(r.residual, jr.residual)
    sent = tbase.decompress(r.compressed, 4096)
    assert torch.equal(sent + r.residual, _t(ones))


@pytest.mark.parametrize("density", [0.001, 0.01])
def test_pallas_gaussian_compress_matches_reference(density):
    """The EF invariant is exact; with the reference's threshold injected
    into the port's pack, the pairs, residual and count are bitwise."""
    x = _grad(200_000, seed=5)
    k = k_for(x.size, density)
    spec = get_compressor("gaussian_pallas", density=density)
    r = spec.fn(_t(x), k)
    sent = tbase.decompress(r.compressed, x.size)
    assert torch.equal(sent + r.residual, _t(x))
    assert r.compressed.indices.shape == (k,)
    jr = J.pallas_gaussian_compress(jnp.asarray(x), k)
    jt = J.pallas_threshold_estimate(jnp.asarray(x), k)
    tr = tbase.pack_by_threshold(_t(x), _t(np.asarray(jt)), k)
    for a, b in ((tr.compressed.indices, jr.compressed.indices),
                 (tr.compressed.values, jr.compressed.values),
                 (tr.residual, jr.residual),
                 (tr.num_selected, jr.num_selected)):
        _eq(a, b)


def test_wrappers_reject_what_the_kernels_do_not_take():
    x = torch.zeros(1000)
    t = torch.zeros(32)
    with pytest.raises(TypeError):
        T.fused_stats(x.double())
    with pytest.raises(ValueError):
        T.fused_stats(torch.zeros(10, 100))
    with pytest.raises(ValueError):
        T.fused_stats(torch.zeros(0))
    with pytest.raises(ValueError):
        T.fused_stats(torch.zeros(2000)[::2])
    with pytest.raises(ValueError):
        T.multi_threshold_counts(x, torch.zeros(31))
    with pytest.raises(ValueError):
        T.multi_threshold_counts(x, t.double())
    with pytest.raises(ValueError):
        T.fused_stats(torch.zeros(8, device="meta"))
