"""The port's CUDA kernels on the card, against their plain versions.

A hand-written CUDA kernel has no CPU mode, so every test here needs a GPU
and skips without one. This file imports only torch and the port, so it
runs where JAX is not installed; ``tests/conftest.py`` provisions JAX, so
on such a machine run it without the conftest::

    python -m pytest --noconftest -p no:cacheprovider \
        tests/test_torch_kernels_cuda.py -q
"""

import numpy as np
import pytest
import torch

from gaussiank_sgd_torch.compressors import get_compressor
from gaussiank_sgd_torch.ops import fused_select as T
from gaussiank_sgd_torch.parallel.bucketing import make_bucket_plan
from gaussiank_sgd_torch.parallel.flat_opt import FlatSGDM
from gaussiank_sgd_torch.parallel.trainstep import DPTrainStep, flat_numel


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("n_chunks,chunk,density",
                         [(1, 300_001, 0.001), (3, 70_000, 0.01)])
def test_select_kernel_matches_plain(cuda_device, n_chunks, chunk, density):
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    x = torch.randn(n_chunks, chunk, device=cuda_device, generator=gen)
    t = torch.linspace(0.0, 2.5, n_chunks, device=cuda_device)
    before = T.LAUNCHES["fused_select"]
    out = T.fused_select_candidates_chunked(x, t, density)
    assert T.LAUNCHES["fused_select"] == before + 1
    for a, b in zip(out, T.fused_select_plain(x, t, density)):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("scale", [1.0, 0.37])
def test_ef_select_kernel_matches_plain(cuda_device, scale):
    gen = torch.Generator(device=cuda_device).manual_seed(1)
    density, chunk_pad = 0.001, 1024 * 128 * 3
    res = torch.randn(2, chunk_pad, device=cuda_device, generator=gen)
    g = torch.randn(2, chunk_pad, device=cuda_device, generator=gen)
    t = torch.tensor([0.0, 2.0], device=cuda_device)
    before = T.LAUNCHES["fused_ef_select"]
    out = T.fused_ef_select_candidates_chunked(res, g, scale, t, density)
    assert T.LAUNCHES["fused_ef_select"] == before + 1
    ref = T.fused_ef_select_plain(res, g, scale, t, density)
    for a, b in zip(out, ref):
        assert torch.equal(a.view(torch.int32) if a.is_floating_point()
                           else a, b.view(torch.int32)
                           if b.is_floating_point() else b)


@pytest.mark.cuda
@pytest.mark.parametrize("t0", [0.0, 0.03])
def test_ef_select_kernel_at_resnet50s_gradient(cuda_device, t0):
    """B1 at ResNet-50's padded EF row, [1, 25,559,040] (n = 25,557,032
    parameters and a zero tail, 399,360 candidates at density 0.001), cold
    and warm, bit for bit against its plain version."""
    n, density = 25_557_032, 0.001
    chunk_pad = T.ef_padded_chunk(n, 25_558, density=density)
    assert chunk_pad == 25_559_040
    gen = torch.Generator(device=cuda_device).manual_seed(5)
    res = torch.zeros(1, chunk_pad, device=cuda_device)
    g = torch.zeros(1, chunk_pad, device=cuda_device)
    res[:, :n] = torch.randn(1, n, device=cuda_device, generator=gen) * 0.01
    g[:, :n] = torch.randn(1, n, device=cuda_device, generator=gen) * 0.01
    t = torch.tensor([t0], device=cuda_device)
    out = T.fused_ef_select_candidates_chunked(res, g, 1.0, t, density)
    assert out[1].shape == (1, 399_360)
    for a, b in zip(out, T.fused_ef_select_plain(res, g, 1.0, t, density)):
        assert torch.equal(a.view(torch.int32) if a.is_floating_point()
                           else a, b.view(torch.int32)
                           if b.is_floating_point() else b)


@pytest.mark.cuda
def test_sparse_step_on_the_card_equals_the_cpu(cuda_device):
    """One dense and two sparse steps on an injected gradient: the card
    (kernel B1) and the CPU (its plain version) commit bit-identical
    params, momentum, EF row and thresholds."""
    n, density = 300_000, 0.001
    spec = get_compressor("gaussian_fused", density=density)
    plan = make_bucket_plan([n], density)
    n_pad = flat_numel(spec, plan)              # the zero tail of the EF row
    rng = np.random.default_rng(0)
    p0, *grads = (np.pad(rng.normal(size=n).astype(np.float32),
                         (0, n_pad - n)) for _ in range(4))
    states = {}
    for dev in ("cpu", cuda_device):
        params = torch.nn.Parameter(torch.from_numpy(p0.copy()).to(dev))
        ts = DPTrainStep(lambda g, p=params: ((p * g).sum(), {}), params,
                         {}, spec, plan,
                         flat_opt=FlatSGDM(lr=0.1, momentum=0.9,
                                           weight_decay=5e-4))
        state = ts.init_state()
        for i, g in enumerate(grads):
            step = ts.dense_step if i == 0 else ts.sparse_step
            step(state, torch.from_numpy(g).to(dev))
        states[str(dev)] = state
    cpu, card = states["cpu"], states[str(cuda_device)]
    for a, b in ((cpu.params, card.params),
                 (cpu.opt_state["m"], card.opt_state["m"]),
                 (cpu.ef_residual, card.ef_residual),
                 (cpu.comp_state, card.comp_state)):
        assert torch.equal(a.detach().view(torch.int32),
                           b.detach().cpu().view(torch.int32))


@pytest.mark.cuda
def test_packed_wire_step_on_the_card_equals_the_cpu(cuda_device):
    """The same on a uniform plan of 65,536-element buckets, whose packed
    u16|bf16 wire the fused select pass writes and whose rounding the EF
    row absorbs: one dense and three sparse steps commit the same bits on
    the card and on the CPU."""
    n, density = 300_000, 0.001
    spec = get_compressor("gaussian_fused", density=density)
    plan = make_bucket_plan([n], density, 65_536, policy="uniform")
    n_pad = flat_numel(spec, plan)
    rng = np.random.default_rng(1)
    p0, *grads = (np.pad(rng.normal(size=n).astype(np.float32),
                         (0, n_pad - n)) for _ in range(5))
    states = {}
    for dev in ("cpu", cuda_device):
        params = torch.nn.Parameter(torch.from_numpy(p0.copy()).to(dev))
        ts = DPTrainStep(lambda g, p=params: ((p * g).sum(), {}), params,
                         {}, spec, plan,
                         flat_opt=FlatSGDM(lr=0.1, momentum=0.9,
                                           weight_decay=5e-4))
        assert ts.wire_format == "u16bf16" and ts.fused_ef is not None
        state = ts.init_state()
        for i, g in enumerate(grads):
            step = ts.dense_step if i == 0 else ts.sparse_step
            step(state, torch.from_numpy(g).to(dev))
        states[str(dev)] = state
    cpu, card = states["cpu"], states[str(cuda_device)]
    for a, b in ((cpu.params, card.params),
                 (cpu.opt_state["m"], card.opt_state["m"]),
                 (cpu.ef_residual, card.ef_residual),
                 (cpu.comp_state, card.comp_state)):
        assert torch.equal(a.detach().view(torch.int32),
                           b.detach().cpu().view(torch.int32))


@pytest.mark.cuda
def test_ordered_scatter_on_the_card_equals_the_cpu(cuda_device):
    """Eight payloads whose indices repeat across them, with padding slots,
    out-of-range slots and signed zeros, scattered into a momentum: twice
    on the card and once on the CPU, bit-identical (``index_add_`` alone
    adds the duplicates by atomics in no fixed order on the card)."""
    from gaussiank_sgd_torch.compressors.base import scatter_add_ordered
    world, k, n = 8, 20_000, 2_000_000
    rng = np.random.default_rng(2)
    idx = np.concatenate([rng.choice(k * 2, size=k, replace=False)
                          for _ in range(world)]).astype(np.int32)
    val = (rng.normal(size=world * k)
           * 10.0 ** rng.integers(-6, 7, size=world * k)).astype(np.float32)
    val[rng.random(world * k) < 0.05] = 0.0
    val[rng.random(world * k) < 0.02] = -0.0
    idx[rng.random(world * k) < 0.01] = n + 3
    m = rng.normal(size=n).astype(np.float32)
    outs = [scatter_add_ordered(torch.from_numpy(m.copy()).to(dev),
                                torch.from_numpy(idx).to(dev),
                                torch.from_numpy(val).to(dev),
                                rounds=world).cpu()
            for dev in (cuda_device, cuda_device, "cpu")]
    for out in outs[1:]:
        assert torch.equal(outs[0].view(torch.int32), out.view(torch.int32))


@pytest.mark.cuda
def test_wire_codec_on_the_card_equals_the_cpu(cuda_device):
    """Words and decoded values of every f32 class (NaN payloads, ±inf,
    ±0.0, subnormals, ties) and rel at both u16 ends."""
    from gaussiank_sgd_torch.parallel import wire
    rng = np.random.default_rng(3)
    bits = np.concatenate([
        rng.integers(0, 2 ** 32, size=100_000, dtype=np.uint64),
        [0x7FC00000, 0xFFC00001, 0x7F800001, 0x7F800000, 0x80000000, 0,
         0x00000001, 0x00018000, 0x3F808000, 0x7F7FFFFF]]).astype(np.uint32)
    val = torch.from_numpy(bits.view(np.float32))
    rel = torch.from_numpy(rng.integers(0, 65_536, size=bits.size,
                                        dtype=np.int64).astype(np.int32))
    words = wire.encode_entries(rel, val)
    words_card = wire.encode_entries(rel.to(cuda_device), val.to(cuda_device))
    assert torch.equal(words, words_card.cpu())
    for a, b in zip(wire.decode_entries(words),
                    wire.decode_entries(words_card)):
        assert torch.equal(a.view(torch.int32), b.cpu().view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 3, 4, 7, 100_001, 3_000_001])
@pytest.mark.parametrize("offset", [0, 1, 2, 3])
def test_stats_and_count_kernels_match_plain(cuda_device, n, offset):
    """B3 and B4 on a buffer that starts at each 4-byte offset of a 16-byte
    line (a bucket's slice of the flat gradient), including buffers shorter
    than one float4. B3: max bit for bit, the sums within the summation-
    order tolerance of ``fused_stats``, and a second launch bit-identical;
    B4: counts bit for bit."""
    from gaussiank_sgd_torch.ops import threshold_select as S
    gen = torch.Generator(device=cuda_device).manual_seed(n + offset)
    base = torch.randn(n + offset, device=cuda_device, generator=gen)
    x = base[offset:]
    before = dict(S.LAUNCHES)
    out = S.fused_stats(x)
    again = S.fused_stats(x)
    s, ss, m = S.fused_stats_plain(x)
    assert torch.equal(out[2], m)
    assert abs(float(out[0] - s)) <= 1e-6 * float(x.abs().sum())
    assert abs(float(out[1] - ss)) <= 1e-5 * float(ss)
    for a, b in zip(out, again):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    t = torch.rand(32, device=cuda_device, generator=gen) * 3.0
    t[0], t[1] = 0.0, float(m)
    counts = S.multi_threshold_counts(x, t)
    assert torch.equal(counts, S.multi_threshold_counts_plain(x, t))
    assert S.LAUNCHES["fused_stats"] == before["fused_stats"] + 2
    assert (S.LAUNCHES["multi_threshold_counts"]
            == before["multi_threshold_counts"] + 1)


def _count_case(case, n=1_000_003):
    """``(x, thresholds)`` as numpy f32 for one edge of B4's contract:
    NaN, +-inf, -0.0 and negative thresholds, ties and orders, and inputs
    whose |x| all fall in one bin, below every threshold or above all."""
    rng = np.random.default_rng(7)
    x = rng.normal(size=n).astype(np.float32)
    t = np.sort(np.abs(rng.normal(size=32)) * 0.5).astype(np.float32)
    if case == "nan_inf_in_x":
        x[[7, n // 2]] = np.nan
        x[[8, 9]] = np.inf, -np.inf
        x[10] = -0.0
    elif case == "nan_inf_neg_zero_thresholds":
        t[[4, 20]] = np.nan
        t[[12, 31]] = np.inf
        t[[0, 6]] = -0.0, 0.0
        x[:1000:7] = 0.0
    elif case == "negative_thresholds":
        t[[3, 9]] = -1.0, -np.inf
        x[[5, 6]] = np.nan, np.inf
    elif case == "all_nan_thresholds":
        t[:] = np.nan
    elif case == "all_equal":
        t[:] = t[16]
    elif case == "descending":
        t = t[::-1].copy()
    elif case == "random_order":
        t = rng.permutation(t)
    elif case == "random_with_duplicates":
        t = rng.permutation(np.repeat(t[::4], 4)).astype(np.float32)
    elif case == "one_bin":            # every |x| between sorted t[20], t[21]
        t = rng.permutation(t)
        s = np.sort(t)
        x = np.where(x < 0, -1, 1).astype(np.float32) * (s[20] + s[21]) / 2
    elif case == "below_min":
        x *= t[0] / np.abs(x).max() / 2
    elif case == "above_max":
        x = np.where(x < 0, -1, 1).astype(np.float32) * (t[31] * 2 + 1)
    return x.astype(np.float32), t


@pytest.mark.cuda
@pytest.mark.parametrize("case", [
    "nan_inf_in_x", "nan_inf_neg_zero_thresholds", "negative_thresholds",
    "all_nan_thresholds", "all_equal", "descending", "random_order",
    "random_with_duplicates", "one_bin", "below_min", "above_max"])
@pytest.mark.parametrize("offset", [0, 1])
def test_count_kernel_edges_match_plain(cuda_device, case, offset):
    """B4 against its plain version, bit for bit, on each edge of the
    contract, from an aligned and an unaligned start."""
    from gaussiank_sgd_torch.ops import threshold_select as S
    x, t = _count_case(case)
    base = torch.from_numpy(np.concatenate([np.zeros(offset, np.float32),
                                            x])).to(cuda_device)
    xd, td = base[offset:], torch.from_numpy(t).to(cuda_device)
    before = S.LAUNCHES["multi_threshold_counts"]
    counts = S.multi_threshold_counts(xd, td)
    assert S.LAUNCHES["multi_threshold_counts"] == before + 1
    ref = S.multi_threshold_counts_plain(xd, td)
    assert torch.equal(counts, ref), (counts.tolist(), ref.tolist())
    if case == "below_min":
        assert not counts.any()
    if case == "above_max":
        assert bool((counts == x.size).all())


@pytest.mark.cuda
def test_count_kernel_above_2_to_the_24(cuda_device):
    """n = 2^24 + 3: the kernel counts in integers and rounds each count to
    f32 once, as the plain version does."""
    from gaussiank_sgd_torch.ops import threshold_select as S
    n = 2 ** 24 + 3
    gen = torch.Generator(device=cuda_device).manual_seed(11)
    x = torch.randn(n, device=cuda_device, generator=gen)
    t = torch.rand(32, device=cuda_device, generator=gen) * 3.0
    t[0], t[1] = -1.0, 0.0
    counts = S.multi_threshold_counts(x, t)
    assert float(counts[0]) == float(np.float32(n))
    assert torch.equal(counts, S.multi_threshold_counts_plain(x, t))


@pytest.mark.cuda
def test_gaussian_pallas_on_the_card(cuda_device):
    """The three-pass estimate launches B3 once and B4 twice; its count is
    within 5% of k, and its pack keeps the EF invariant exact."""
    from gaussiank_sgd_torch.compressors import decompress
    from gaussiank_sgd_torch.ops import threshold_select as S
    gen = torch.Generator(device=cuda_device).manual_seed(3)
    x = torch.randn(1_000_003, device=cuda_device, generator=gen) * 0.01
    k = 1001
    before = dict(S.LAUNCHES)
    r = get_compressor("gaussian_pallas").fn(x, k)
    assert S.LAUNCHES["fused_stats"] == before["fused_stats"] + 1
    assert (S.LAUNCHES["multi_threshold_counts"]
            == before["multi_threshold_counts"] + 2)
    assert abs(int(r.num_selected) - k) <= 0.05 * k
    assert torch.equal(decompress(r.compressed, x.numel()) + r.residual, x)
