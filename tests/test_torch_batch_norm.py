"""Train-mode BatchNorm (``ops/batch_norm.py``) on the CPU: the plain
version of kernel B5 against the eager ``FlatModel._batch_norm`` it
replaced, bit for bit, and the geometry and tiling the kernel is given.

The kernel itself has no CPU mode (``tests/test_torch_kernels_cuda.py``
holds it to the plain version on a card); here its backward's closed form
is held to autograd of the plain version.
"""

import numpy as np
import pytest
import torch

from gaussiank_sgd_torch.models.flat import (_BN_EPS, _BN_MOMENTUM,
                                             FlatModel, add_batch_norm)
from gaussiank_sgd_torch.ops import batch_norm as B


def _eager_batch_norm(model, p, x, name, axis):
    """``FlatModel._batch_norm(train=True)`` as the port had it before
    B5: eager ops, autograd's backward."""
    x = x.float()
    axis %= x.dim()
    dims = tuple(d for d in range(x.dim()) if d != axis)
    mean = x.mean(dim=dims)
    var = torch.clamp((x * x).mean(dim=dims) - mean * mean, min=0.0)
    with torch.no_grad():
        for stat, batch in (("mean", mean), ("var", var)):
            ra = model.stat(f"{name}/{stat}")
            ra.copy_(_BN_MOMENTUM * ra + (1.0 - _BN_MOMENTUM) * batch)
    shape = [1] * x.dim()
    shape[axis] = -1
    mul = torch.rsqrt(var + _BN_EPS) * p[f"{name}/scale"]
    y = (x - mean.view(shape)) * mul.view(shape)
    return y + p[f"{name}/bias"].view(shape)


def _model(c: int, seed: int, zero_scale: bool) -> FlatModel:
    params, stats = {}, {}
    add_batch_norm(params, stats, "BatchNorm_0", c)
    model = FlatModel(params, stats, torch.float32)
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        model.flat.copy_(torch.from_numpy(
            rng.normal(1.0, 0.5, size=model.n_params).astype(np.float32)))
        if zero_scale:     # ResNet-50's BatchNorm_2 of a block starts so
            model.leaves()["BatchNorm_0/scale"].zero_()
        model.stats.copy_(torch.from_numpy(
            rng.uniform(0.5, 1.5, size=model.stats.numel()).astype(
                np.float32)))
    return model


# (shape as stored, the permutation that gives the layer's view, axis)
LAYOUTS = {
    "nchw": ((4, 6, 5, 3), (0, 1, 2, 3), 1),
    "3d": ((4, 6, 7), (0, 1, 2), 1),
    "channels_last_memory": ((4, 5, 3, 6), (0, 3, 1, 2), 1),
    "channels_last_axis": ((3, 5, 4, 6), (0, 1, 2, 3), -1),
    "permuted_axis": ((3, 6, 5, 4), (0, 2, 3, 1), -1),    # lstman4's
}


def _input(layout: str, dtype, seed: int) -> torch.Tensor:
    stored, perm, axis = LAYOUTS[layout]
    rng = np.random.default_rng(seed)
    x = rng.normal(0.3, 2.0, size=stored).astype(np.float32)
    x = torch.from_numpy(x).permute(*perm)
    # one constant channel: E[x^2] - E[x]^2 rounds to <= 0 there, the
    # clamp binds (or nearly) and the variance term of the gradient is 0
    idx = [slice(None)] * x.dim()
    idx[axis % x.dim()] = 1
    x[tuple(idx)] = 0.7
    return x.to(dtype).detach().requires_grad_(True)


def _run(fn, model, x, axis, w):
    p = model.leaves()
    ys = [fn(model, p, x, "BatchNorm_0", axis) for _ in range(2)]
    loss = sum((y * w).sum() for y in ys)
    gx, gflat = torch.autograd.grad(loss, [x, model.flat])
    return ys, gx, gflat, model.stats.clone()


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("zero_scale", [False, True])
def test_plain_version_is_the_eager_batch_norm(layout, dtype, zero_scale):
    """Output, running statistics after two calls, and the gradients of
    x, scale and bias, bit for bit."""
    x = _input(layout, dtype, 0)
    axis = LAYOUTS[layout][2]
    c = x.shape[axis]
    w = torch.from_numpy(np.random.default_rng(1).normal(
        size=x.shape).astype(np.float32))
    got = _run(lambda m, p, xx, name, ax: m._batch_norm(p, xx, name, True,
                                                        ax),
               _model(c, 2, zero_scale), x, axis, w)
    want = _run(_eager_batch_norm, _model(c, 2, zero_scale), x, axis, w)
    for a, b in zip(got[0], want[0]):
        assert a.dtype == torch.float32 and torch.equal(a, b)
        assert a.stride() == b.stride()
    for a, b in zip(got[1:], want[1:]):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert got[1].dtype == dtype


def test_eval_mode_reads_the_running_statistics():
    model = _model(6, 3, False)
    x = _input("nchw", torch.float32, 4)
    before = model.stats.clone()
    p = model.leaves()
    y = model._batch_norm(p, x, "BatchNorm_0", False)
    mean = model.stat("BatchNorm_0/mean").view(1, -1, 1, 1)
    var = model.stat("BatchNorm_0/var").view(1, -1, 1, 1)
    mul = torch.rsqrt(var + _BN_EPS) * p["BatchNorm_0/scale"].view(
        1, -1, 1, 1)
    assert torch.equal(y, (x - mean) * mul
                       + p["BatchNorm_0/bias"].view(1, -1, 1, 1))
    assert torch.equal(model.stats, before)


def _closed_form(x, g, scale, axis):
    """B5's backward as ``csrc/batch_norm.cu`` computes it: d scale, d
    bias and dx from the per-channel sums of dy and dy * (x - mean), with
    the variance term dropped where the clamp binds; the batch statistics
    in f32 as the forward takes them, the rest in f64. (In a constant
    channel E[x^2] - E[x]^2 is rounding, ~1e-7 against eps 1e-5, so rstd
    there follows how the forward rounded it.)"""
    axis %= x.dim()
    dims = tuple(d for d in range(x.dim()) if d != axis)
    shape = [1] * x.dim()
    shape[axis] = -1
    m = x.numel() // x.shape[axis]
    mean = x.mean(dim=dims)
    var_raw = ((x * x).mean(dim=dims) - mean * mean).double()
    x, g, mean = x.double(), g.double(), mean.double()
    rstd = torch.rsqrt(var_raw.clamp(min=0.0) + _BN_EPS)
    mul = rstd * scale.double()
    d = x - mean.view(shape)
    sg, sgd = g.sum(dim=dims), (g * d).sum(dim=dims)
    dvar = torch.where(var_raw >= 0, -0.5 * sgd * scale.double() * rstd ** 3,
                       0.0)
    a, b = -mul * sg / m, 2 * dvar / m
    dx = g * mul.view(shape) + a.view(shape) + b.view(shape) * d
    return dx, sgd * rstd, sg


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_backward_closed_form_is_autograds(layout):
    """dx, d scale and d bias of the closed form B5 computes against
    autograd of the plain version, both on f32 input: within f32 rounding
    (the plain version rounds every op in f32; the closed form runs in
    f64)."""
    x = _input(layout, torch.float32, 5)
    axis = LAYOUTS[layout][2]
    c = x.shape[axis]
    rng = np.random.default_rng(6)
    g = torch.from_numpy(rng.normal(size=x.shape).astype(np.float32))
    scale = torch.from_numpy(rng.normal(1.0, 0.5, size=c).astype(
        np.float32)).requires_grad_(True)
    bias = torch.zeros(c, requires_grad=True)
    y = B.batch_norm_train_plain(x, scale, bias, torch.zeros(c),
                                 torch.ones(c), axis, _BN_MOMENTUM, _BN_EPS)
    want = torch.autograd.grad((y * g).sum(), [x, scale, bias])
    got = _closed_form(x.detach(), g, scale.detach(), axis)
    for a, b in zip(got, want):
        err = float((a - b.double()).norm() / b.double().norm())
        assert err < 1e-5, err


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_memory_geometry_of_each_layout(layout):
    stored, perm, axis = LAYOUTS[layout]
    x = torch.zeros(stored).permute(*perm)
    outer, c, inner = B.memory_geometry(x.shape, x.stride(), axis)
    assert c == x.shape[axis] and outer * c * inner == x.numel()
    # the channel's stride is inner, the slowest axis's extent folds into
    # outer
    assert x.stride(axis % x.dim()) == inner


@pytest.mark.parametrize("shape,strides,axis,want", [
    # ResNet-50's stem as cuDNN gives it on a card: channels-last memory
    ((64, 64, 112, 112), (802816, 1, 7168, 64), 1, (802816, 64, 1)),
    ((64, 64, 112, 112), (802816, 12544, 112, 1), 1, (64, 64, 12544)),
    # lstman4's BatchNorm_1: NCHW memory seen through its channels-last
    # permutation
    ((16, 100, 41, 32), (131200, 41, 1, 4100), -1, (16, 32, 4100)),
    ((16, 100, 41, 32), (131200, 1312, 32, 1), -1, (65600, 32, 1)),
    ((1, 8, 1, 1), (8, 1, 8, 8), 1, (1, 8, 1)),
    ((4, 1, 3), (3, 3, 1), 1, (12, 1, 1)),
    ((4, 6, 5), (60, 10, 2), 1, None),               # a strided slice
    ((4, 6, 5), (30, 0, 1), 1, None),                # an expanded axis
])
def test_memory_geometry_cases(shape, strides, axis, want):
    assert B.memory_geometry(shape, strides, axis) == want


# the cells' BatchNorm shapes as [outer, C * inner] in bf16, on 132 SMs
@pytest.mark.parametrize("rows,cols", [
    (802816, 64), (200704, 256), (3136, 2048), (50176, 512),
    (1048576, 64), (4096, 512), (64, 64 * 12544), (1024, 512 * 4),
    (16, 32 * 8100), (7, 24), (1, 8)])
@pytest.mark.parametrize("vec", [8, 1])
def test_tiling_fills_the_card_and_bounds_the_partials(rows, cols, vec):
    sms = 132
    tc, block_rows = B.tiling(rows, cols, vec, sms)
    vcols = cols // vec
    tr = 256 // tc
    col_tiles = -(-vcols // tc)
    # a warp across 32 vector columns, wider only where rows are few
    assert 1 <= tc <= max(32, 256 // max(1, rows // 8))
    assert tc * tr <= 256 and tr * tc > 128
    assert block_rows >= 1 and col_tiles * block_rows <= 8 * sms + col_tiles
    # every row in one of the block rows' chunks
    chunk = -(-rows // block_rows)
    assert (block_rows - 1) * chunk < rows <= block_rows * chunk
    if block_rows > 1:       # at least 8 rows a thread, when rows allow
        assert rows >= 8 * tr * (block_rows - 1)


def test_cpu_tensor_takes_the_plain_version_and_counts_no_launch():
    B.reset_launches()
    x = _input("nchw", torch.bfloat16, 7)
    model = _model(x.shape[1], 8, False)
    y = model._batch_norm(model.leaves(), x, "BatchNorm_0", True)
    y.sum().backward()
    assert B.LAUNCHES == {"batch_norm_forward": 0, "batch_norm_backward": 0}


def test_unsupported_device_raises():
    x = torch.zeros(2, 3, 4, device="meta")
    c = torch.zeros(3, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        B.batch_norm_train(x, c, c, c, c)


def test_plan_is_made_once_a_layout():
    """A layout's plan is kept; a row of C x inner that is no whole number
    of 16 bytes, or an unaligned pointer, takes the scalar form."""
    B._PLANS.clear()
    shape, strides = (64, 256, 14, 14), (50176, 1, 3584, 256)
    plan = B.plan_for(shape, strides, 1, 2, 132)
    assert plan == B.Plan(12544, 256, 1, 8, 32, 196,
                          float(np.float32(1) / np.float32(12544)))
    assert B.plan_for(shape, strides, 1, 2, 132) is plan
    assert plan.part == 196 * 2 * 256
    assert B.plan_for((64, 20, 7, 7), (980, 49, 7, 1), 1, 2, 132).vec == 1
    assert B.plan_for((64, 20, 7, 7), (980, 49, 7, 1), 1, 4, 132).vec == 4
    assert B.plan_for((4, 6, 5), (60, 10, 2), 1, 2, 132) is None
    aligned = torch.zeros(64)
    assert B._unaligned(plan, 132, aligned) is plan
    scalar = B._unaligned(plan, 132, aligned[1:])
    assert (scalar.vec, scalar.tc) == (1, 32)
    assert scalar[:3] == plan[:3] and scalar.inv_m == plan.inv_m
