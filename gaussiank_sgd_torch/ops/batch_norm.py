"""Train-mode BatchNorm, forward and backward: kernel B5 and its plain
version.

``batch_norm_train`` is ``FlatModel._batch_norm`` in train mode: flax's
``BatchNorm`` in f32 over every axis of ``x`` but the channel ``axis``,
with the biased batch variance ``E[x^2] - E[x]^2`` clamped at 0, the
running statistics updated in place as ``m * running + (1 - m) * batch``,
and ``y = (x - mean) * (rsqrt(var + eps) * scale) + bias`` in f32.

For a CUDA tensor it is kernel B5 (``csrc/batch_norm.cu``): a
``torch.autograd.Function`` whose forward and backward are three launches
each, saving ``x`` in its own dtype and the per-channel mean and rstd. For
a CPU tensor it is the plain version, today's eager ops and autograd, op
for op. There is no fallback: a CUDA tensor launches B5 or raises.

The kernel sees ``x`` as it lies in memory, ``[outer, C, inner]``:
``memory_geometry`` reads that from the strides (an NCHW tensor is ``[N,
C, H*W]``; a channels-last one, as cuDNN hands the convnets' activations
on, ``[N*H*W, C, 1]``), and ``tiling`` picks the kernel's blocking from
the shape alone.
"""

from __future__ import annotations

import functools
import math
from typing import Dict, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.autograd.function import once_differentiable

from ..telemetry import tracing
from . import _build

_THREADS = 256          # csrc/batch_norm.cu's kThreads
_TILE_COLS = 32         # vector columns a block, where rows allow
_ROWS_A_THREAD = 8      # rows a thread at least (partials <= 1/16 of x)
_BLOCKS_A_SM = 4        # blocks a multiprocessor at most, in all

# Calls of each direction of B5 on a CUDA tensor (three launches each),
# counted by the wrapper where it launches. Plain-version calls (CPU
# tensors) do not count.
LAUNCHES = {"batch_norm_forward": 0, "batch_norm_backward": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


# ------------------------------------------------------------- plain

def normalise(x: torch.Tensor, mean: torch.Tensor, var: torch.Tensor,
              scale: torch.Tensor, bias: torch.Tensor, axis: int,
              eps: float) -> torch.Tensor:
    """``(x - mean) * (rsqrt(var + eps) * scale) + bias`` in f32, the
    per-channel vectors along ``axis``: eval mode's BatchNorm on the
    running statistics, and the plain version's tail on the batch's."""
    x = x.float()
    shape = [1] * x.dim()
    shape[axis % x.dim()] = -1
    mul = torch.rsqrt(var + eps) * scale
    y = (x - mean.view(shape)) * mul.view(shape)
    return y + bias.view(shape)


def batch_norm_train_plain(x: torch.Tensor, scale: torch.Tensor,
                           bias: torch.Tensor, running_mean: torch.Tensor,
                           running_var: torch.Tensor, axis: int,
                           momentum: float, eps: float) -> torch.Tensor:
    """Plain version of kernel B5 (any device): the eager ops, whose
    backward is autograd's."""
    x = x.float()
    axis %= x.dim()
    dims = tuple(d for d in range(x.dim()) if d != axis)
    mean = x.mean(dim=dims)
    var = torch.clamp((x * x).mean(dim=dims) - mean * mean, min=0.0)
    with torch.no_grad():
        for ra, batch in ((running_mean, mean), (running_var, var)):
            ra.copy_(momentum * ra + (1.0 - momentum) * batch)
    return normalise(x, mean, var, scale, bias, axis, eps)


# ---------------------------------------------------------- geometry

def memory_geometry(shape: Sequence[int], strides: Sequence[int],
                    axis: int) -> Optional[Tuple[int, int, int]]:
    """``(outer, C, inner)`` of a tensor laid out densely in some order of
    its axes: C is the channel ``axis``'s extent, outer and inner the
    products of the extents laid out before and after it. None when the
    memory has gaps or overlaps. Axes of extent 1 go anywhere."""
    axis %= len(shape)
    c = shape[axis]
    order = sorted((d for d in range(len(shape))
                    if shape[d] != 1 and d != axis),
                   key=lambda d: -strides[d])
    if c != 1:
        order.append(axis)
        order.sort(key=lambda d: -strides[d])
    expected = 1
    for d in reversed(order):
        if strides[d] != expected:
            return None
        expected *= shape[d]
    if c == 1:
        return math.prod(shape), 1, 1
    at = order.index(axis)
    return (math.prod(shape[d] for d in order[:at]), c,
            math.prod(shape[d] for d in order[at + 1:]))


def tiling(rows: int, cols: int, vec: int, sms: int) -> Tuple[int, int]:
    """``(tc, block_rows)``: a block of B5's reductions and elementwise
    passes covers ``tc`` vectors of ``vec`` columns by ``256 // tc`` rows,
    and the grid ``ceil(cols / vec / tc)`` column tiles by ``block_rows``
    chunks of rows. A warp spans 32 vector columns of a row, or more where
    the rows are too few for ``_ROWS_A_THREAD`` a thread (lstman4's NCHW
    ``[16, 32, 8100]``); at most ``_BLOCKS_A_SM`` blocks a multiprocessor
    in all, and at least ``_ROWS_A_THREAD`` rows a thread where the rows
    allow it."""
    vcols = cols // vec
    tc = min(vcols, max(_TILE_COLS,
                        _THREADS // max(1, rows // _ROWS_A_THREAD)))
    tr = _THREADS // tc
    col_tiles = -(-vcols // tc)
    block_rows = max(1, min(-(-_BLOCKS_A_SM * sms // col_tiles),
                            -(-rows // (_ROWS_A_THREAD * tr))))
    # the kernel's chunks are ceil(rows / block_rows) rows: none is empty
    return tc, -(-rows // -(-rows // block_rows))


class Plan(NamedTuple):
    """B5's launch for one input layout: the memory's ``[rows, C,
    inner]``, the vector width (16 bytes of elements, or 1 where a row of
    C * inner is not a whole number of them), the tiling and ``1 / (rows *
    inner)``."""
    rows: int
    c: int
    inner: int
    vec: int
    tc: int
    block_rows: int
    inv_m: float

    @property
    def part(self) -> int:
        """Floats of the partial sums: a row of 2 x C x inner a block
        row."""
        return self.block_rows * 2 * self.c * self.inner


_PLANS: Dict[tuple, Plan] = {}


def plan_for(shape: Sequence[int], strides: Sequence[int], axis: int,
             element_size: int, sms: int) -> Optional[Plan]:
    """The plan of an input layout, made once and kept; None for memory
    with gaps or overlaps."""
    key = (tuple(shape), tuple(strides), axis, element_size, sms)
    plan = _PLANS.get(key)
    if plan is None:
        geo = memory_geometry(shape, strides, axis)
        if geo is None:
            return None
        rows, c, inner = geo
        vec = 16 // element_size
        if c * inner % vec:
            vec = 1
        plan = _PLANS[key] = Plan(
            rows, c, inner, vec, *tiling(rows, c * inner, vec, sms),
            float(np.float32(1.0) / np.float32(rows * inner)))
    return plan


def _unaligned(plan: Plan, sms: int, *tensors: torch.Tensor) -> Plan:
    """``plan``, or its scalar form where a pointer is not 16-byte
    aligned."""
    if plan.vec == 1 or not any(t.data_ptr() % 16 for t in tensors):
        return plan
    tc, block_rows = tiling(plan.rows, plan.c * plan.inner, 1, sms)
    return plan._replace(vec=1, tc=tc, block_rows=block_rows)


_SMS: Dict[int, int] = {}


def _sms(index: int) -> int:
    if index not in _SMS:
        _SMS[index] = torch.cuda.get_device_properties(
            index).multi_processor_count
    return _SMS[index]


@functools.lru_cache(maxsize=None)
def _consts(momentum: float, eps: float) -> Tuple[float, float, float]:
    """m, 1 - m and eps as the eager ops round them to f32."""
    return (float(np.float32(momentum)), float(np.float32(1.0 - momentum)),
            float(np.float32(eps)))


def _check(x: torch.Tensor, c: int, *per_channel: torch.Tensor) -> None:
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"B5 takes float32 or bfloat16 input, got {x.dtype}")
    dev = x.get_device()
    for t in per_channel:
        if (t.dtype is not torch.float32 or t.dim() != 1 or t.shape[0] != c
                or t.get_device() != dev or not t.is_contiguous()):
            raise ValueError(f"B5's per-channel tensors must be contiguous "
                             f"float32 [{c}] on {x.device}")


# ------------------------------------------------------------ kernel

class Saved(NamedTuple):
    """What B5's backward reads: the input in its own dtype and layout,
    the scale, the forward's buffer (the per-channel [4, C] mean, rstd,
    mul and clamp-passed at its head) and the plan."""
    x: torch.Tensor
    scale: torch.Tensor
    stats: torch.Tensor
    plan: Plan


def forward_kernel(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                   running_mean: torch.Tensor, running_var: torch.Tensor,
                   axis: int, momentum: float, eps: float
                   ) -> Tuple[torch.Tensor, Saved]:
    """B5's forward on a CUDA tensor, no autograd: ``(y, saved)``."""
    index = x.get_device()
    sms = _sms(index)
    plan = plan_for(x.shape, x.stride(), axis, x.element_size(), sms)
    if plan is None:
        x = x.contiguous()
        plan = plan_for(x.shape, x.stride(), axis, x.element_size(), sms)
    c = plan.c
    _check(x, c, scale, bias, running_mean, running_var)
    y = torch.empty_like(x, dtype=torch.float32)
    plan = _unaligned(plan, sms, x, y)
    # [4, C] saved statistics, then the partials
    work = torch.empty(4 * c + plan.part, dtype=torch.float32,
                       device=x.device)
    ptr = work.data_ptr()
    m, one_minus, eps32 = _consts(momentum, eps)
    _build.check(_build.load("batch_norm").lib.gk_bn_forward(
        x.data_ptr(), int(x.dtype is torch.bfloat16), plan.rows, c,
        plan.inner, plan.vec, plan.tc, plan.block_rows, scale.data_ptr(),
        bias.data_ptr(), running_mean.data_ptr(), running_var.data_ptr(), m,
        one_minus, eps32, plan.inv_m, y.data_ptr(), ptr + 16 * c, ptr,
        torch._C._cuda_getCurrentRawStream(index)), "batch_norm forward")
    LAUNCHES["batch_norm_forward"] += 1
    trace = tracing.active()
    if trace is not None:
        trace.count("bn_kernel")
    return y, Saved(x, scale, work, plan)


def backward_kernel(dy: torch.Tensor, saved: Saved
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """B5's backward, no autograd: ``(dx, d scale, d bias)``."""
    x, plan = saved.x, saved.plan
    if dy.dtype is not torch.float32 or (
            dy.stride() != x.stride() and _strides(dy) != _strides(x)):
        dy = torch.empty_like(x, dtype=torch.float32).copy_(dy)
    index = x.get_device()
    dx = torch.empty_like(x)
    plan = _unaligned(plan, _sms(index), x, dy, dx)
    c = plan.c
    # [2, C] d scale and d bias, [2, C] dx's coefficients, the partials
    work = torch.empty(4 * c + plan.part, dtype=torch.float32,
                       device=x.device)
    ptr = work.data_ptr()
    _build.check(_build.load("batch_norm").lib.gk_bn_backward(
        dy.data_ptr(), x.data_ptr(), int(x.dtype is torch.bfloat16),
        plan.rows, c, plan.inner, plan.vec, plan.tc, plan.block_rows,
        saved.scale.data_ptr(), saved.stats.data_ptr(), plan.inv_m,
        dx.data_ptr(), ptr, ptr + 16 * c, ptr + 8 * c,
        torch._C._cuda_getCurrentRawStream(index)), "batch_norm backward")
    LAUNCHES["batch_norm_backward"] += 1
    return dx, work[:c], work[c:2 * c]


class _BatchNormB5(torch.autograd.Function):
    """B5: forward and backward are three launches each."""

    @staticmethod
    def forward(ctx, x, scale, bias, running_mean, running_var, axis,
                momentum, eps):
        y, saved = forward_kernel(x, scale, bias, running_mean, running_var,
                                  axis, momentum, eps)
        ctx.save_for_backward(saved.x, saved.scale, saved.stats)
        ctx.plan = saved.plan
        return y

    @staticmethod
    @once_differentiable
    def backward(ctx, dy):
        saved = Saved(*ctx.saved_tensors, ctx.plan)
        return (*backward_kernel(dy, saved), None, None, None, None, None)


def _strides(t: torch.Tensor) -> Tuple[int, ...]:
    """The strides of the axes of extent > 1 (the others say nothing)."""
    return tuple(s for s, n in zip(t.stride(), t.shape) if n != 1)


def batch_norm_train(x: torch.Tensor, scale: torch.Tensor,
                     bias: torch.Tensor, running_mean: torch.Tensor,
                     running_var: torch.Tensor, axis: int = 1,
                     momentum: float = 0.9,
                     eps: float = 1e-5) -> torch.Tensor:
    """Train-mode BatchNorm of ``x`` (f32 or bf16) over every axis but
    ``axis``: f32 ``y`` in ``x``'s layout, the running statistics updated
    in place. Kernel B5 on a CUDA tensor; the plain version on a CPU
    tensor.

    B5 against the plain version: the sums are taken in another order (per
    thread, per block in a fixed tree, then across blocks), so the batch
    statistics, and through them y, the running statistics and the
    gradients, differ by rounding; each elementwise operation is rounded
    as the eager op rounds it. ``dx`` comes back in ``x``'s dtype, as the
    gradient of ``x.float()`` does."""
    if x.device.type == "cpu":
        return batch_norm_train_plain(x, scale, bias, running_mean,
                                      running_var, axis, momentum, eps)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    return _BatchNormB5.apply(x, scale, bias, running_mean, running_var,
                              axis, momentum, eps)
