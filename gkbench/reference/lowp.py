"""The control's precision: the reference's rounding of matmul and
convolution operands moved one step below the configuration's bfloat16,
to 8-bit floats as fp8 training takes them.

``fp8`` rounds a tensor to float8 e4m3 on the way forward and its
gradient to float8 e5m2 on the way back, each with one scale a tensor
(its largest magnitude maps to the format's largest finite value), and
hands both back in float32. ``bf16`` does the same with bfloat16 both
ways, unscaled: the program's own precision, for the CPU tests.
"""

from __future__ import annotations

from typing import Callable, Dict

import torch


def _scaled_round(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    amax = x.detach().abs().amax().float()
    top = torch.finfo(dtype).max
    scale = torch.where(amax > 0, top / amax, torch.ones_like(amax))
    return ((x.float() * scale).to(dtype).float() / scale).to(x.dtype)


class _Fp8(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x: torch.Tensor) -> torch.Tensor:
        return _scaled_round(x, torch.float8_e4m3fn)

    @staticmethod
    def backward(ctx, g: torch.Tensor) -> torch.Tensor:
        return _scaled_round(g, torch.float8_e5m2)


class _Bf16(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x: torch.Tensor) -> torch.Tensor:
        return x.to(torch.bfloat16).to(x.dtype)

    @staticmethod
    def backward(ctx, g: torch.Tensor) -> torch.Tensor:
        return g.to(torch.bfloat16).to(g.dtype)


def _f32(x: torch.Tensor) -> torch.Tensor:
    return x


ROUNDINGS: Dict[str, Callable[[torch.Tensor], torch.Tensor]] = {
    "float32": _f32, "bfloat16": _Bf16.apply, "fp8": _Fp8.apply}
