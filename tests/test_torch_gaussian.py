"""Parity of the port's GaussianK compressors (gaussiank_sgd_torch/compressors/
base.py selection and gaussian.py) with the reference's.

The same numpy inputs go to both packages. Selections, packs, residuals and
counts are compared bit for bit. Two places of the reference are not
reproducible bit for bit, and each test that meets one says what it holds
instead: XLA's f32 reductions add in another order than torch's (the mean
of the Gaussian estimate can differ in the last bit; XLA may also fuse
``|mu| + s * sigma`` into one multiply-add), and the warm controller's
``ratio ** gain`` is XLA's own f32 ``pow``, so next thresholds are held to
2 ulp.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch
from scipy.special import ndtri

from gaussiank_sgd_tpu.compressors import base as jbase
from gaussiank_sgd_tpu.compressors import gaussian as jg
from gaussiank_sgd_tpu.compressors.registry import get_compressor as jcomp
from gaussiank_sgd_torch.compressors import base as tbase
from gaussiank_sgd_torch.compressors import gaussian as tg
from gaussiank_sgd_torch.compressors import get_compressor, k_for
from gaussiank_sgd_torch.compressors.registry import none_compress
from gaussiank_sgd_torch.ops import fused_select as T


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


def _same_result(tr, jr):
    _eq(tr.compressed.indices, jr.compressed.indices)
    _eq(tr.compressed.values, jr.compressed.values)
    _eq(tr.residual, jr.residual)
    _eq(tr.num_selected, jr.num_selected)


def _ef_exact(r, acc):
    sent = tbase.decompress(r.compressed, acc.shape[-1])
    assert torch.equal(sent + r.residual, acc)


@pytest.mark.parametrize("n", [100_003, (1 << 21) + 3])
@pytest.mark.parametrize("priority", ["index", "magnitude"])
def test_select_by_mask_matches_reference(n, priority):
    """Index priority: the first k masked entries in index order, bitwise
    at both sizes. Magnitude priority: the bf16 key with ties to the lowest
    index (values are drawn from few levels so bf16 ties are many), and a
    masked entry whose magnitude rounds to bf16 zero is not packed.

    Above 2^21 elements the reference takes ``approx_max_k``. On the CPU it
    returns the exact top-k keys in order, and for the distinct index keys
    exactly the same slots; among equal bf16 magnitudes its order is its
    own. There the port (lowest index first, as ``lax.top_k`` below 2^21)
    is held to the same keys slot by slot, the same entries above the
    k-th key, and the same number of entries at it."""
    rng = np.random.default_rng(n % 97)
    acc = (np.round(rng.normal(size=n) * 4) / 4).astype(np.float32)
    mask = rng.random(n) < 0.01
    tiny = np.nonzero(mask)[0][:5]
    acc[tiny] = np.float32(1e-45)                  # bf16(1e-45) == 0
    count = int(mask.sum())
    exact = priority == "index" or n <= (1 << 21)
    for k in (count // 3, count + 50):             # truncation, padding
        jsi, jv, jns = jbase.select_by_mask(jnp.asarray(acc),
                                            jnp.asarray(mask), k, priority)
        tsi, tv, tns = tbase.select_by_mask(_t(acc), _t(mask), k, priority)
        _eq(tns, jns)
        if exact:
            _eq(tsi, jsi)
            _eq(tv, jv)
            continue
        jsi, tsi = np.asarray(jsi), tsi.numpy()
        _eq(tv.abs(), np.abs(np.asarray(jv)))
        kth = np.abs(tv.numpy())[tsi < n].min()
        above = np.abs(tv.numpy()) > kth
        assert set(tsi[above]) == set(jsi[above])
        at_kth = tsi[(np.abs(tv.numpy()) == kth) & (tsi < n)]
        assert np.all(np.diff(at_kth) > 0)         # lowest index first
        tied = np.nonzero(mask & (np.abs(acc) == kth))[0]
        np.testing.assert_array_equal(at_kth, tied[:len(at_kth)])
    if priority == "magnitude":
        assert not np.isin(tiny, tsi).any()
    # the pack: residual zeroes exactly the sent entries, input untouched
    r = tbase.pack_by_mask(_t(acc), _t(mask), k, priority)
    _ef_exact(r, _t(acc))
    if exact:
        _same_result(r, jbase.pack_by_mask(jnp.asarray(acc),
                                           jnp.asarray(mask), k, priority))


def test_select_by_mask_along_rows_matches_vmapped_reference():
    import jax
    rng = np.random.default_rng(4)
    x = rng.normal(size=(3, 5000)).astype(np.float32)
    mask = np.abs(x) > np.array([[2.0], [2.5], [9.0]], np.float32)
    for prio in ("index", "magnitude"):
        j = jax.vmap(lambda a, m: jbase.select_by_mask(a, m, 40, prio))(
            jnp.asarray(x), jnp.asarray(mask))
        t = tbase.select_by_mask(_t(x), _t(mask), 40, prio)
        for a, b in zip(t, j):
            _eq(a, b)


@pytest.mark.parametrize("t0", [0.0, -1.0, 1.5, 2.9, 3.3, 50.0])
def test_bisect_threshold_matches_reference(t0):
    """From the same t0 (including below 0 and above max|x|, which clip):
    every operation is exactly rounded, so the result is bitwise."""
    rng = np.random.default_rng(1)
    a = np.abs(rng.normal(size=60_000)).astype(np.float32)
    for k in (1, 60, 600):
        j = jbase.bisect_threshold(jnp.asarray(a), k, jnp.float32(t0))
        t = tbase.bisect_threshold(_t(a), k, torch.tensor(np.float32(t0)))
        _eq(t, j)


def test_tolerance_band_rounds_like_jax():
    for k in (1, 7, 20, 149, 14_987, 1_000_003):
        lo = int(jnp.maximum(1, jnp.floor((1.0 - 0.05) * k)).astype(
            jnp.int32))
        hi = int(jnp.ceil((1.0 + 0.05) * k).astype(jnp.int32))
        assert tbase._tolerance_band(k, 0.05) == (lo, hi)


@pytest.mark.parametrize("density", [0.0005, 0.001, 0.01, 0.05, 0.5])
def test_quantile_is_scipys_rounded_to_f32(density):
    s = np.float32(ndtri(1.0 - min(max(density, 1e-12), 0.5) / 2.0))
    assert tg._quantile(density) == float(s)


def test_threshold_estimate_uses_the_population_std():
    """rtol 1e-6: the mean may differ in its last bit (summation order) and
    XLA may fuse the final multiply-add. ``torch.std``'s default
    ``correction=1`` would be 5e-5 off at this n, far outside."""
    rng = np.random.default_rng(2)
    x = (rng.normal(size=10_001) * 0.01 + 0.001).astype(np.float32)
    for density in (0.001, 0.01, 0.1):
        j = float(jg.gaussian_threshold_estimate(jnp.asarray(x), density))
        t = float(tg.gaussian_threshold_estimate(_t(x), density))
        np.testing.assert_allclose(t, j, rtol=1e-6)
        tx = _t(x)
        sample_std = (tx.mean().abs()
                      + tg._quantile(density) * tx.std(correction=1))
        assert abs(float(sample_std) - j) > 1e-6 * abs(j)


@pytest.mark.parametrize("density", [0.001, 0.01])
def test_gaussiank_compress_matches_reference(density):
    rng = np.random.default_rng(3)
    acc = (rng.normal(size=120_000) * 0.01).astype(np.float32)
    k = k_for(acc.size, density)
    jr = jg.gaussiank_compress(jnp.asarray(acc), k, density=density)
    tr = tg.gaussiank_compress(_t(acc), k, density=density)
    _same_result(tr, jr)
    _ef_exact(tr, _t(acc))
    assert abs(int(tr.num_selected) - k) <= 0.05 * k


def test_gaussian_warm_cold_and_warm_steps_match_reference():
    """A cold step (state 0: estimate + bisection, index priority), a warm
    step from the threshold it carries (magnitude priority), and a step
    whose carried threshold drifted out of [k/4, 4k] (cold again)."""
    density = 0.01
    rng = np.random.default_rng(5)
    acc = (rng.normal(size=(3, 80_000)) * 0.01).astype(np.float32)
    k = k_for(80_000, density)
    jst = tst = np.float32(0.0)
    for step, drift in enumerate((1.0, 1.0, 0.2)):
        jstate = np.float32(jst * drift)
        jr, jnew = jg.gaussian_warm_compress(jnp.asarray(acc[step]), k,
                                             jnp.float32(jstate),
                                             density=density)
        tr, tnew = tg.gaussian_warm_compress(_t(acc[step]), k,
                                             torch.tensor(jstate),
                                             density=density)
        _same_result(tr, jr)
        _ef_exact(tr, _t(acc[step]))
        np.testing.assert_array_max_ulp(tnew.numpy(), np.asarray(jnew), 2)
        jst, tst = np.asarray(jnew), tnew
    assert tst.dtype == torch.float32 and tst.dim() == 0


def test_gaussian_warm_batched_one_cold_lane():
    """Lane 2 is cold among warm lanes: the recovery branch runs, lane 2
    adopts a fresh threshold, and the warm lanes keep theirs (their next
    threshold is their own, nudged)."""
    density = 0.01
    rng = np.random.default_rng(6)
    x = (rng.normal(size=(4, 30_000)) * 0.01).astype(np.float32)
    k = k_for(30_000, density)
    warm_t = np.float32(0.0255)                   # ~k above it at 0.01 std
    for state in (np.array([warm_t, warm_t, 0.0, warm_t], np.float32),
                  np.full(4, warm_t, np.float32)):
        jr, jnew = jg.gaussian_warm_compress_batched(
            jnp.asarray(x), k, jnp.asarray(state), density=density)
        tr, tnew = tg.gaussian_warm_compress_batched(
            _t(x), k, _t(state), density=density)
        _same_result(tr, jr)
        for i in range(4):
            _ef_exact(tbase.CompressResult(
                tbase.CompressedGrad(tr.compressed.indices[i],
                                     tr.compressed.values[i]),
                tr.residual[i], tr.num_selected[i]), _t(x[i]))
        np.testing.assert_array_max_ulp(tnew.numpy(), np.asarray(jnew), 2)
        kept = tg._next_threshold(_t(state), tr.num_selected, k, 0.18)
        warm = state > 0
        _eq(tnew[_t(warm)], kept[_t(warm)])
    assert float(tnew[2]) > 0


def test_gaussian_fused_warm_fallback_at_density_005():
    """Above density 1/32 the registry's gaussian_fused is the warm pack,
    under its own name, flat and batched; a direct call of the fused
    functions routes there too."""
    density = 0.05
    spec, jspec = (get_compressor("gaussian_fused", density=density),
                   jcomp("gaussian_fused", density=density))
    assert spec.name == jspec.name == "gaussian_fused(warm-fallback)"
    assert spec.stateful and spec.fused_ef_fn is None
    rng = np.random.default_rng(7)
    x = (rng.normal(size=(2, 20_000)) * 0.01).astype(np.float32)
    k = k_for(20_000, density)
    st = np.zeros(2, np.float32)
    jr, jt = jspec.batched_fn(jnp.asarray(x), k, jnp.asarray(st), None)
    for tr, tt in (spec.batched_fn(_t(x), k, _t(st)),
                   T.gaussian_fused_compress_batched(_t(x), k, _t(st),
                                                     density=density)):
        _same_result(tr, jr)
        np.testing.assert_array_max_ulp(tt.numpy(), np.asarray(jt), 2)
    jr, jt = jspec.fn(jnp.asarray(x[0]), k, jnp.float32(0.0))
    for tr, tt in (spec.fn(_t(x[0]), k, torch.tensor(0.0)),
                   T.gaussian_fused_compress(_t(x[0]), k, torch.tensor(0.0),
                                             density=density)):
        _same_result(tr, jr)
        np.testing.assert_array_max_ulp(tt.numpy(), np.asarray(jt), 2)


def test_gaussian_fused_routes_k_above_capacity_to_warm():
    """Below 1/32 but with k above the candidate capacity (640 slots for
    20,000 elements at density 0.01), both fused forms are the warm pack,
    in the reference and in the port."""
    from gaussiank_sgd_tpu.ops import pallas_pack as J
    density, k = 0.01, 1000
    assert T._chunk_geometry(20_000, density)[3] < k
    rng = np.random.default_rng(8)
    x = (rng.normal(size=(2, 20_000)) * 0.01).astype(np.float32)
    st = np.zeros(2, np.float32)
    jr, jt = J.gaussian_fused_compress_batched(jnp.asarray(x), k,
                                               jnp.asarray(st),
                                               density=density)
    tr, tt = T.gaussian_fused_compress_batched(_t(x), k, _t(st),
                                               density=density)
    _same_result(tr, jr)
    np.testing.assert_array_max_ulp(tt.numpy(), np.asarray(jt), 2)
    jr, jt = J.gaussian_fused_compress(jnp.asarray(x[0]), k,
                                       jnp.float32(0.0), density=density)
    tr, tt = T.gaussian_fused_compress(_t(x[0]), k, torch.tensor(0.0),
                                       density=density)
    _same_result(tr, jr)
    np.testing.assert_array_max_ulp(tt.numpy(), np.asarray(jt), 2)
    assert T.LAUNCHES == {"fused_ef_select": 0, "fused_select": 0}


def test_none_compress_counts_on_the_input_device():
    r = none_compress(torch.zeros(7, device="meta"), 1)
    assert r.num_selected.device.type == "meta"
    r = none_compress(torch.arange(7.0), 1)
    assert r.num_selected.device.type == "cpu" and int(r.num_selected) == 7
