"""Parity of the port's fused select (gaussiank_sgd_torch/ops/fused_select.py)
with the reference's Pallas select+pack (gaussiank_sgd_tpu/ops/pallas_pack.py).

The same numpy inputs go to both. The reference's Pallas kernels run in
interpret mode on the CPU, as tests/test_pallas_pack.py runs them; the port
runs its kernels' plain versions, which is what its wrappers take for CPU
tensors. The kernels themselves are held to those plain versions on the card
by chip_smoke.py and by tests/test_torch_kernels_cuda.py.

Tolerances: candidates, counts, sent pairs, residuals and cold thresholds
are compared bit for bit. Two places of the reference are not reproducible
bit for bit, and each test that meets one says what it holds instead:
XLA on the CPU contracts ``res + scale * g`` into a fused multiply-add (the
port rounds the product first, as its CUDA kernel does), so the two acc
differ by at most one rounding of the product where it is inexact; and the
warm controller's ``ratio ** gain`` is XLA's own f32 ``pow``
approximation, so warm thresholds are held to 1-2 ulp.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from gaussiank_sgd_tpu.compressors import base as jbase
from gaussiank_sgd_tpu.compressors.base import k_for
from gaussiank_sgd_tpu.ops import pallas_pack as J
from gaussiank_sgd_torch.compressors import base as tbase
from gaussiank_sgd_torch.ops import fused_select as T


def _bits(a):
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


def _eq(a, b):
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = b.numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    np.testing.assert_array_equal(_bits(a), _bits(b))


def _t(a):
    return torch.from_numpy(np.array(a))      # a contiguous copy, 0-d kept


@pytest.mark.parametrize("density", [0.0005, 0.001, 0.01, 1 / 32, 0.05])
def test_geometry_matches_reference(density):
    assert T.segment_span(density) == J.segment_span(density)
    assert T.supports_density(density) == J.supports_density(density)
    for n in (1, 127, 128, 4096, 65536, 131073, 300_001, 14_986_698):
        k = k_for(n, density)
        assert (T.ef_padded_chunk(n, k, density=density)
                == J.ef_padded_chunk(n, k, density=density))
        if J.supports_density(density):
            assert T.rows_per_block(density) == J.rows_per_block(density)
            assert (T._chunk_geometry(n, density)
                    == J._chunk_geometry(n, density))
        else:
            with pytest.raises(ValueError):
                T.rows_per_block(density)


def test_vgg16_geometry():
    """The slice's shape: one whole-model bucket of VGG-16."""
    n, density = 14_986_698, 0.001
    assert k_for(n, density) == 14_987
    assert T._chunk_geometry(n, density) == (1024, 64, 115, 235_520)
    assert T.ef_padded_chunk(n, 14_987, density=density) == 15_073_280


@pytest.mark.parametrize("n_chunks,chunk,density",
                         [(1, 200_001, 0.001), (3, 70_000, 0.01)])
@pytest.mark.parametrize("warm", [False, True])
def test_plain_select_matches_pallas_bitwise(n_chunks, chunk, density, warm):
    rng = np.random.default_rng(n_chunks)
    x = rng.normal(size=(n_chunks, chunk)).astype(np.float32)
    t = (np.linspace(2.0, 3.0, n_chunks) if warm
         else np.zeros(n_chunks)).astype(np.float32)
    jv, ji, jc = J.fused_select_candidates_chunked(jnp.asarray(x),
                                                   jnp.asarray(t), density)
    tv, ti, tc = T.fused_select_candidates_chunked(_t(x), _t(t), density)
    _eq(tv, jv)
    _eq(ti, ji)
    _eq(tc, jc)
    assert T.LAUNCHES == {"fused_ef_select": 0, "fused_select": 0}


@pytest.mark.parametrize("n_chunks,density", [(1, 0.001), (2, 0.01)])
@pytest.mark.parametrize("scale", [1.0, 0.37])
def test_plain_ef_select_matches_pallas(n_chunks, density, scale):
    """acc: the port rounds ``scale * g`` and then ``+ res`` (its CUDA
    kernel's __fmul_rn/__fadd_rn). XLA on the CPU contracts the pair into
    one fused multiply-add, so the reference's acc equals the port's bit
    for bit where the product is exact (scale 1.0) and within one rounding
    of the product otherwise (scale 0.37). Candidates are compared on the port's own acc:
    the reference's select kernel run on it must give the port's candidates
    bit for bit."""
    rng = np.random.default_rng(7)
    chunk_pad = (J.ef_padded_chunk(100_000, k_for(100_000, density),
                                   density=density) if n_chunks == 1
                 else 1024 * 128)
    res = (rng.normal(size=(n_chunks, chunk_pad)) * 0.5).astype(np.float32)
    g = rng.normal(size=(n_chunks, chunk_pad)).astype(np.float32)
    t = np.full(n_chunks, 1.5, np.float32)
    jacc, jv, ji, jc = J.fused_ef_select_candidates_chunked(
        jnp.asarray(res), jnp.asarray(g), jnp.float32(scale), jnp.asarray(t),
        density)
    tacc, tv, ti, tc = T.fused_ef_select_candidates_chunked(
        _t(res), _t(g), scale, _t(t), density)
    # the port's acc is the separately rounded sum, bit for bit
    _eq(tacc, res + (g * np.float32(scale)).astype(np.float32))
    if scale == 1.0:
        _eq(tacc, jacc)
    else:
        # one rounding of the product apart, plus the final rounding
        prod = np.abs(g * np.float32(scale)).astype(np.float32)
        bound = np.spacing(prod) + np.spacing(np.abs(np.asarray(jacc)))
        assert (np.abs(tacc.numpy() - np.asarray(jacc)) <= bound).all()
        assert not np.array_equal(tacc.numpy(), np.asarray(jacc))
    rv, ri, rc = J.fused_select_candidates_chunked(jnp.asarray(tacc.numpy()),
                                                   jnp.asarray(t), density)
    _eq(tv, rv)
    _eq(ti, ri)
    _eq(tc, rc)


def test_ef_compress_batched_chained_matches_reference():
    """Three chained steps of gaussian_fused_ef_compress_batched (scale 1,
    as the train step runs it), each package carrying its own residual and
    threshold: sent indices and values, residual and num_selected bit for
    bit every step; the threshold bit for bit from the cold step and within
    2 ulp after warm ones (XLA's f32 pow, see the module docstring)."""
    density, n_chunks = 0.001, 1
    n = 150_000
    k = k_for(n, density)
    chunk_pad = J.ef_padded_chunk(n, k, density=density)
    rng = np.random.default_rng(3)
    jres = np.zeros((n_chunks, chunk_pad), np.float32)
    tres = _t(jres.copy())
    jst = np.zeros(n_chunks, np.float32)
    tst = _t(jst.copy())
    for step in range(3):
        g = np.zeros((n_chunks, chunk_pad), np.float32)
        g[:, :n] = rng.normal(size=(n_chunks, n))
        jr, jst_new = J.gaussian_fused_ef_compress_batched(
            jnp.asarray(jres), jnp.asarray(g), jnp.float32(1.0), k,
            jnp.asarray(jst), density=density)
        tr, tst_new = T.gaussian_fused_ef_compress_batched(
            tres, _t(g), 1.0, k, tst, density=density)
        _eq(tr.compressed.indices, jr.compressed.indices)
        _eq(tr.compressed.values, jr.compressed.values)
        _eq(tr.residual, jr.residual)
        _eq(tr.num_selected, jr.num_selected)
        if step == 0:
            _eq(tst_new, jst_new)
        else:
            np.testing.assert_array_max_ulp(tst_new.numpy(),
                                            np.asarray(jst_new), 2)
        # the EF invariant, exact, on the port's side
        acc = tres + _t(g)
        sent = tbase.decompress(tr.compressed, chunk_pad)
        assert torch.equal(sent + tr.residual.reshape(-1), acc.reshape(-1))
        assert (tr.residual[:, n:] == 0).all()     # the pad stays zero
        jres, jst = np.asarray(jr.residual), np.asarray(jst_new)
        tres, tst = tr.residual, tst_new


@pytest.mark.parametrize("warm", [False, True])
def test_flat_and_batched_compress_match_reference(warm):
    """The B2 forms (flat and per-chunk) on the same input and state."""
    density = 0.01
    rng = np.random.default_rng(11)
    x = rng.normal(size=(2, 40_000)).astype(np.float32)
    k = k_for(40_000, density)
    st = np.full(2, 2.4 if warm else 0.0, np.float32)
    jr, jt = J.gaussian_fused_compress_batched(jnp.asarray(x), k,
                                               jnp.asarray(st),
                                               density=density)
    tr, tt = T.gaussian_fused_compress_batched(_t(x), k, _t(st),
                                               density=density)
    for a, b in ((tr.compressed.indices, jr.compressed.indices),
                 (tr.compressed.values, jr.compressed.values),
                 (tr.residual, jr.residual),
                 (tr.num_selected, jr.num_selected)):
        _eq(a, b)
    np.testing.assert_array_max_ulp(tt.numpy(), np.asarray(jt),
                                    1 if warm else 0)
    # the flat form on chunk 0
    jf, jft = J.gaussian_fused_compress(jnp.asarray(x[0]), k,
                                        jnp.asarray(st[0]), density=density)
    tx = _t(x[0])
    tf, tft = T.gaussian_fused_compress(tx, k, _t(st[0]), density=density)
    _eq(tf.compressed.indices, jf.compressed.indices)
    _eq(tf.compressed.values, jf.compressed.values)
    _eq(tf.residual, jf.residual)
    _eq(tf.num_selected, jf.num_selected)
    np.testing.assert_array_max_ulp(tft.numpy(), np.asarray(jft),
                                    1 if warm else 0)
    _eq(tx, x[0])                                   # input untouched


def test_tie_break_lowest_candidate_position():
    """Equal magnitudes everywhere: the k sent entries are the k lowest
    candidate positions ((block, segment) x lane order), as lax.top_k
    breaks ties; inside one cell equal keys' tie goes to the higher row."""
    density = 0.001
    n = 64 * 128 * 4                                # 4 segments of 64 rows
    k = k_for(n, density)                            # 33
    x = np.zeros(n, np.float32)
    rows = np.arange(n) // 128
    lanes = np.arange(n) % 128
    # one entry of magnitude 1 in 200 cells, spread over segments 3..0
    cells = [(s, l) for s in (3, 2, 1, 0) for l in range(0, 128, 2)][:200]
    for s, l in cells:
        x[(s * 64 + 5) * 128 + l] = -1.0 if l % 4 else 1.0
    # two equal entries in cell (0, 0): rows 3 and 10 -> row 10 wins
    x[3 * 128] = 1.0
    x[10 * 128] = -1.0
    jr, _ = J.gaussian_fused_compress(jnp.asarray(x), k, jnp.float32(0.0),
                                      density=density)
    tr, tt = T.gaussian_fused_compress(_t(x), k, torch.tensor(0.0),
                                       density=density)
    _eq(tr.compressed.indices, jr.compressed.indices)
    _eq(tr.compressed.values, jr.compressed.values)
    sent = tr.compressed.indices.numpy()
    # lowest candidate positions = segment 0's cells by lane, then seg 1...
    order = sorted({(r // 64, l) for r, l in zip(rows[x != 0],
                                                  lanes[x != 0])})
    expect = []
    for s, l in order[:k]:
        hits = np.nonzero((x != 0) & (rows // 64 == s) & (lanes == l))[0]
        expect.append(hits.max())                  # the higher row wins
    np.testing.assert_array_equal(sent, np.asarray(expect, np.int32))
    assert sent[0] == 10 * 128
    assert float(tt) == 1.0                        # cold: k-th magnitude


def test_cand_top_k_above_exact_ceiling_matches_reference():
    """VGG-16's 235,520 candidates take the reference's approx_max_k path,
    which on the CPU returns exactly the lowest-index-first top-k; the
    port's stable sort gives the same positions and values, ties included."""
    rng = np.random.default_rng(5)
    vals = np.round(rng.normal(size=235_520) * 8).astype(np.float32) / 8
    vals[rng.random(235_520) < 0.5] = 0.0
    k = 14_987
    jv, jp = J._cand_top_k(jnp.asarray(vals), k)
    tv, tp = T._cand_top_k(_t(vals), k)
    _eq(tv, jv)
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))


def test_controller_update_matches_reference():
    k = 149
    rng = np.random.default_rng(2)
    count = rng.integers(0, 5000, size=64).astype(np.int32)
    val = rng.normal(size=(64, k)).astype(np.float32)
    valid = rng.random((64, k)) < 0.9
    valid[0] = False                                # a dead bucket
    for state in (np.zeros(64, np.float32),
                  rng.uniform(0.1, 3.0, 64).astype(np.float32)):
        j = J._controller_update(jnp.asarray(state), jnp.asarray(count),
                                 jnp.asarray(val), jnp.asarray(valid), k,
                                 0.18)
        t = T._controller_update(_t(state), _t(count), _t(val), _t(valid),
                                 k, 0.18)
        if state[0] == 0:
            _eq(t, j)                               # cold: exact
            assert float(t[0]) == np.float32(1e-8)
        else:
            np.testing.assert_array_max_ulp(t.numpy(), np.asarray(j), 1)


def test_finish_pack_matches_reference():
    """Sentinel slots drop, the packed index maps to 0, the residual zeroes
    exactly the sent entries — including element 0 sent beside sentinels,
    where the in-place scatter must stay deterministic."""
    rng = np.random.default_rng(9)
    acc = rng.normal(size=(3, 50)).astype(np.float32)
    sent = np.array([[0, 7, 50, 50], [3, 50, 9, 0], [50, 50, 50, 50]],
                    np.int32)
    val = np.take_along_axis(acc, np.minimum(sent, 49), 1)
    val[sent == 50] = 0.0
    for r in range(3):
        jc, jres = jbase.finish_pack(jnp.asarray(acc[r]),
                                     jnp.asarray(sent[r]),
                                     jnp.asarray(val[r]))
        tc, tres = tbase.finish_pack(_t(acc[r].copy()), _t(sent[r]),
                                     _t(val[r]))
        _eq(tc.indices, jc.indices)
        _eq(tres, jres)
    tc, tres = tbase.finish_pack(_t(acc.copy()), _t(sent), _t(val))
    for r in range(3):
        jc, jres = jbase.finish_pack(jnp.asarray(acc[r]),
                                     jnp.asarray(sent[r]),
                                     jnp.asarray(val[r]))
        _eq(tres[r], jres)
    idx = np.array([0, 7, 0, 3, 7], np.int32)      # duplicates sum
    v = np.array([1.5, -2.0, 0.0, 0.25, 0.5], np.float32)
    _eq(tbase.decompress(tbase.CompressedGrad(_t(idx), _t(v)), 10),
        jbase.decompress(jbase.CompressedGrad(jnp.asarray(idx),
                                              jnp.asarray(v)), 10))
    assert tbase.k_for(14_986_698, 0.001) == jbase.k_for(14_986_698, 0.001)


def test_wrappers_reject_what_the_kernel_does_not_take():
    x = torch.zeros(2, 1000)
    t = torch.zeros(2)
    with pytest.raises(TypeError):
        T.fused_select_candidates_chunked(x.double(), t, 0.01)
    with pytest.raises(ValueError):
        T.fused_select_candidates_chunked(x, torch.zeros(3), 0.01)
    with pytest.raises(ValueError):
        T.fused_select_candidates_chunked(torch.zeros(1000, 2).t(), t, 0.01)
    with pytest.raises(ValueError):              # not block-aligned
        T.fused_ef_select_candidates_chunked(x, x, 1.0, t, 0.01)
    with pytest.raises(ValueError):              # no candidate geometry
        T.fused_select_candidates_chunked(x, t, 0.05)
