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


# ------------------------------------------------------------------ B5

# (shape as the layer sees it, channel axis): ResNet-50's stem, a stage-1
# and a stage-4 BatchNorm at batch 64; VGG-16's first and last at batch
# 1,024 (32^2 CIFAR); lstman4's channels-last BatchNorm_1 at batch 16
B5_SHAPES = {
    "resnet50_stem": ((64, 64, 112, 112), 1),
    "resnet50_stage1": ((64, 256, 56, 56), 1),
    "resnet50_stage4": ((64, 2048, 7, 7), 1),
    "vgg16_first": ((1024, 64, 32, 32), 1),
    "vgg16_last": ((1024, 512, 2, 2), 1),
    "lstman4_bn1": ((16, 100, 41, 32), -1),
}


def _b5_input(shape, axis, layout, dtype, gen, dev):
    """``x`` at ``shape`` in one of the two memory orders the port hands
    a BatchNorm: channels-last (cuDNN's, for the convnets) or the other
    (NCHW for axis 1; for axis -1, lstman4's permuted NCHW conv output)."""
    x = torch.randn(shape, device=dev, generator=gen) * 1.5 + 0.3
    if axis == 1:
        fmt = (torch.channels_last if layout == "channels_last"
               else torch.contiguous_format)
        return x.to(dtype).contiguous(memory_format=fmt)
    if layout == "channels_last":
        return x.to(dtype).contiguous()
    return x.to(dtype).permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1)


def _rel(a, b):
    return float((a.float() - b.float()).norm() / b.float().norm())


def _b5_pair(x, axis, gen, dy="independent"):
    """B5 and its plain version on the same ``x``, per-channel parameters
    and running statistics, and the same upstream gradient: ``(kernel,
    plain)``, each ``(y, running mean, running var, dx, d scale, d
    bias)``. ``dy="correlated"`` makes the upstream gradient affine in
    ``x`` per channel plus noise: dx's mean and variance terms then cancel
    most of ``dy * mul``, where for an independent one they are ~1/sqrt(M)
    of dx and a kernel that dropped them would pass at large M."""
    from gaussiank_sgd_torch.ops import batch_norm as B
    dev, c = x.device, x.shape[axis]
    scale = torch.randn(c, device=dev, generator=gen) * 0.5 + 1.0
    bias = torch.randn(c, device=dev, generator=gen) * 0.1
    stats = torch.rand(2, c, device=dev, generator=gen) + 0.5
    g = torch.randn(x.shape, device=dev, generator=gen)
    if dy == "correlated":
        view = [1] * x.dim()
        view[axis] = c
        slope = torch.randn(c, device=dev, generator=gen).view(view)
        g = x.float() * slope + 0.5 * g
    out = []
    for fn in (B.batch_norm_train, B.batch_norm_train_plain):
        xx = x.detach().clone().requires_grad_(True)
        s = scale.clone().requires_grad_(True)
        b = bias.clone().requires_grad_(True)
        rm, rv = stats[0].clone(), stats[1].clone()
        y = fn(xx, s, b, rm, rv, axis, 0.9, 1e-5)
        grads = torch.autograd.grad((y * g).sum(), [xx, s, b])
        out.append((y.detach(), rm, rv, *grads))
    torch.cuda.synchronize()
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("dy", ["independent", "correlated"])
@pytest.mark.parametrize("layout", ["channels_last", "other"])
@pytest.mark.parametrize("name", sorted(B5_SHAPES))
def test_batch_norm_kernel_matches_plain(cuda_device, name, layout, dy):
    """B5 against its plain version at the cells' shapes, bf16 input.
    y and the running statistics by relative L2 < 1e-5: both take the
    batch statistics in f32 in different orders, which moves them by
    ~1e-6 of their size. d scale and d bias < 1e-4: sums of up to 800k
    products, in different orders. dx < 2e-4: it is rounded to bf16, and
    the two sides' f32 values, ~1e-7 apart relative, fall on either side
    of a rounding boundary for ~1e-7 / 2^-8 of the elements, each then one
    bf16 ulp (2^-8) apart: ~2e-5 in all, a few times more where the
    correlated dy's cancellation enlarges the f32 differences; a kernel
    that dropped dx's mean and variance terms reads ~1 on the correlated
    dy at every shape."""
    shape, axis = B5_SHAPES[name]
    gen = torch.Generator(device=cuda_device).manual_seed(22)
    x = _b5_input(shape, axis, layout, torch.bfloat16, gen, cuda_device)
    kern, plain = _b5_pair(x, axis, gen, dy)
    assert kern[0].dtype == torch.float32 and kern[0].stride() == x.stride()
    assert kern[3].dtype == torch.bfloat16
    for i, (what, tol) in enumerate((("y", 1e-5), ("running mean", 1e-5),
                                     ("running var", 1e-5), ("dx", 2e-4),
                                     ("d scale", 1e-4), ("d bias", 1e-4))):
        err = _rel(kern[i], plain[i])
        assert err < tol, f"{name} {layout} {what}: {err}"


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["resnet50_stage4", "vgg16_last",
                                  "lstman4_bn1"])
def test_batch_norm_kernel_matches_plain_in_f32(cuda_device, name):
    """B5 on f32 input (the models' f32 compute): the same tolerances,
    dx by 1e-4 as it is not rounded to bf16."""
    shape, axis = B5_SHAPES[name]
    gen = torch.Generator(device=cuda_device).manual_seed(23)
    x = _b5_input(shape, axis, "channels_last", torch.float32, gen,
                  cuda_device)
    kern, plain = _b5_pair(x, axis, gen)
    for i, tol in enumerate((1e-5, 1e-5, 1e-5, 1e-4, 1e-4, 1e-4)):
        assert _rel(kern[i], plain[i]) < tol, (name, i)


@pytest.mark.cuda
def test_batch_norm_kernel_constant_channel_and_unaligned_rows(cuda_device):
    """A constant channel (the clamp binds or nearly: its rstd follows how
    each side rounded E[x^2] - E[x]^2, so it is compared by itself), a
    zero scale, and 20 channels of a 2-D NCHW view whose rows of 20 x 49
    bf16 do not fill 16 bytes (the scalar path)."""
    gen = torch.Generator(device=cuda_device).manual_seed(24)
    x = _b5_input((64, 20, 7, 7), 1, "other", torch.bfloat16, gen,
                  cuda_device)
    x[:, 3] = 0.7
    kern, plain = _b5_pair(x, 1, gen, "correlated")
    keep = [c for c in range(20) if c != 3]
    for i, tol in enumerate((1e-5, 1e-5, 1e-5, 2e-4, 1e-4, 1e-4)):
        a, b = kern[i], plain[i]
        if i == 0 or i == 3:
            a, b = a[:, keep], b[:, keep]
        elif i != 5:
            a, b = a[keep], b[keep]
        assert _rel(a, b) < tol, i
    # the constant channel: y is its bias up to rounding noise times rstd
    assert torch.allclose(kern[0][:, 3], plain[0][:, 3], atol=0.05)


@pytest.mark.cuda
def test_batch_norm_kernel_repeats_and_counts(cuda_device):
    """Two runs bit for bit (no atomics); each forward counts one
    ``batch_norm_forward`` launch and, under an installed trace context,
    one ``bn_kernel``; each backward one ``batch_norm_backward``."""
    from gaussiank_sgd_torch.ops import batch_norm as B
    from gaussiank_sgd_torch.telemetry import EventBus, TraceContext
    gen = torch.Generator(device=cuda_device).manual_seed(25)
    x = _b5_input((64, 256, 14, 14), 1, "channels_last", torch.bfloat16,
                  gen, cuda_device)
    B.reset_launches()
    trace = TraceContext(EventBus()).install()
    try:
        first = _b5_pair(x, 1, torch.Generator(
            device=cuda_device).manual_seed(1))[0]
        again = _b5_pair(x, 1, torch.Generator(
            device=cuda_device).manual_seed(1))[0]
        counts = [e["counts"] for e in trace.steps().values()]
    finally:
        trace.uninstall()
    for a, b in zip(first, again):
        assert torch.equal(a, b)
    assert B.LAUNCHES == {"batch_norm_forward": 2, "batch_norm_backward": 2}
    assert sum(c.get("bn_kernel", 0) for c in counts) == 2


@pytest.mark.cuda
def test_every_batch_norm_of_a_model_takes_the_kernel(cuda_device):
    """resnet20 in bf16 on the card: one B5 forward and one backward for
    each of its 19 BatchNorms, and its loss and gradient near the same
    model's on the CPU (plain version)."""
    from gaussiank_sgd_torch.models import get_model
    from gaussiank_sgd_torch.ops import batch_norm as B
    rng = np.random.default_rng(26)
    x = torch.from_numpy(rng.normal(size=(8, 32, 32, 3)).astype(np.float32))
    grads = {}
    for dev in ("cpu", "cuda"):
        model = get_model("resnet20", "cifar10", dtype=torch.float32,
                          device=dev, seed=3).module
        B.reset_launches()
        out = model(x.to(dev), train=True)
        (g,) = torch.autograd.grad(out.square().mean(), [model.flat])
        grads[dev] = (g.cpu(), model.stats.cpu(), dict(B.LAUNCHES))
    assert grads["cuda"][2] == {"batch_norm_forward": 19,
                                "batch_norm_backward": 19}
    assert grads["cpu"][2] == {"batch_norm_forward": 0,
                               "batch_norm_backward": 0}
    # f32 on both; the card's convolutions run in TF32 unless pinned, so
    # the model is held by relative L2 as test_torch_resnet.py holds it
    assert _rel(grads["cuda"][0], grads["cpu"][0]) < 1e-2
    assert _rel(grads["cuda"][1], grads["cpu"][1]) < 1e-3
