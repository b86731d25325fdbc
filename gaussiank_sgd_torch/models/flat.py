"""The flat-parameter base of the port's models.

Parameters live in ONE flat f32 ``nn.Parameter`` in the reference's flat
order, which is ``ravel_pytree``'s: at every level of the variable tree the
keys are sorted as strings (``BasicBlock_10`` before ``BasicBlock_2``), so
the layout sorts leaf paths by their tuples of components. Each leaf keeps
flax's layout — HWIO for a conv kernel, ``[in, out]`` for a dense kernel. A
forward splits the vector once into per-leaf views, so autograd hands back
the flat gradient in exactly the reference's order; the split's backward
writes each leaf's gradient into one flat buffer (slicing every leaf on its
own would make each leaf's backward a full-size zero buffer plus an add).
``pad_flat`` lengthens the vector by a zero tail that no layer reads, so the
gradient comes back at the train step's padded length. The BatchNorm running
statistics live the same way in one flat buffer.

Numerics follow flax: a conv casts its input, kernel and bias to the
compute dtype and pads as flax's ``Conv`` does (an int pads both sides,
``"SAME"`` pads each axis ``total // 2`` before and the rest after); flax's
``max_pool`` is ``'VALID'``, as ``F.max_pool2d`` without padding is;
``hard_tanh`` is ``jax.nn.hard_tanh``'s ``where`` form, whose gradient is
1 at exactly +-1; BatchNorm runs in f32 over every axis but the channel
axis (1 for NCHW, -1 for channels-last) with the biased batch variance
``E[x^2] - E[x]^2`` and ``running = 0.9 * running + 0.1 * batch``;
LayerNorm likewise over the last axis with eps 1e-6; dropout keeps an
entry with probability ``1 - rate`` and scales it by ``1 / (1 - rate)``.
"""

from __future__ import annotations

import math
from typing import (Dict, Iterable, List, Mapping, Optional, Tuple,
                    Union)

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.batch_norm import batch_norm_train, normalise

_BN_MOMENTUM = 0.9     # flax convention: running = m*running + (1-m)*batch
_BN_EPS = 1e-5
_LN_EPS = 1e-6
# flax's lecun_normal: a unit normal truncated at +-2, whose std is
# 0.87962566, scaled back to 1 / sqrt(fan_in)
_TRUNC = 2.0
_TRUNC_STD = 0.87962566103423978

Shape = Tuple[int, ...]
Layout = List[Tuple[str, Shape]]


def _sorted_layout(leaves: Mapping[str, Shape]) -> Layout:
    """``(path, shape)`` in ``ravel_pytree`` order: paths sorted by their
    ``/``-separated components, level by level."""
    return [(path, tuple(leaves[path]))
            for path in sorted(leaves, key=lambda p: tuple(p.split("/")))]


def add_conv(params: Dict[str, Shape], name: str, k: Union[int, Shape],
             cin: int, cout: int, bias: bool = False) -> None:
    """An HWIO kernel ``k x k`` (or ``kh x kw``), and a bias when asked
    (flax's ``use_bias``)."""
    kh, kw = (k, k) if isinstance(k, int) else k
    params[f"{name}/kernel"] = (kh, kw, cin, cout)
    if bias:
        params[f"{name}/bias"] = (cout,)


def add_batch_norm(params: Dict[str, Shape], stats: Dict[str, Shape],
                   name: str, c: int) -> None:
    params[f"{name}/bias"] = params[f"{name}/scale"] = (c,)
    stats[f"{name}/mean"] = stats[f"{name}/var"] = (c,)


def add_dense(params: Dict[str, Shape], name: str, cin: int,
              cout: int) -> None:
    params[f"{name}/bias"] = (cout,)
    params[f"{name}/kernel"] = (cin, cout)


class FlatModel(nn.Module):
    """Owns the flat parameter and statistics of the leaves ``params`` and
    ``stats`` (``{path: shape}``) and the layers' shared numerics.
    ``fill`` gives leaves a constant init in place of their family's;
    ``fan_in`` gives a kernel's fan-in where it is not the product of its
    leading axes (flax's ``DenseGeneral`` kernels of attention);
    ``orthogonal`` names the ``[H, m*H]`` kernels drawn as m orthogonal
    blocks (recurrent kernels)."""

    def __init__(self, params: Mapping[str, Shape],
                 stats: Mapping[str, Shape], dtype: torch.dtype,
                 device: Optional[torch.device] = None,
                 fill: Optional[Mapping[str, float]] = None,
                 fan_in: Optional[Mapping[str, int]] = None,
                 orthogonal: Iterable[str] = ()):
        super().__init__()
        self.dtype = dtype
        self.fan_in = dict(fan_in or {})
        self.orthogonal = frozenset(orthogonal)
        self.param_layout = _sorted_layout(params)
        self.stats_layout = _sorted_layout(stats)
        self._stats_at: Dict[str, Tuple[int, Shape]] = {}
        off = 0
        for path, shape in self.stats_layout:
            self._stats_at[path] = (off, shape)
            off += math.prod(shape)
        self.n_params = sum(math.prod(s) for _, s in self.param_layout)
        self.fill = dict(fill or {})
        self.flat = nn.Parameter(torch.zeros(self.n_params, device=device))
        self.register_buffer("stats", torch.zeros(off, device=device))
        self.dropout_generator: Optional[torch.Generator] = None

    # ------------------------------------------------------------ state
    def leaves(self) -> Dict[str, torch.Tensor]:
        """Every parameter leaf as a view of ``flat``, by path."""
        parts = torch.split(self.flat, [math.prod(s) for _, s in
                                        self.param_layout]
                            + [self.flat.numel() - self.n_params])
        return {path: part.view(shape) for (path, shape), part
                in zip(self.param_layout, parts)}

    @torch.no_grad()
    def pad_flat(self, numel: int) -> None:
        """Re-allocate ``flat`` at ``numel`` elements: the parameters, then
        a zero tail that no layer reads. Call it before anything holds the
        parameter (an optimizer, a train step)."""
        if numel < self.n_params:
            raise ValueError(f"numel {numel} < {self.n_params} parameters")
        flat = torch.zeros(numel, device=self.flat.device)
        flat[:self.n_params] = self.flat[:self.n_params]
        self.flat = nn.Parameter(flat)

    def stat(self, path: str) -> torch.Tensor:
        off, shape = self._stats_at[path]
        return self.stats[off:off + math.prod(shape)].view(shape)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """Random init from ``generator`` with flax's default families:
        lecun-normal kernels (a normal truncated at +-2, scaled so that the
        std is 1/sqrt(fan_in)), embeddings from N(0, 1/features), each
        ``orthogonal`` leaf ``[H, m*H]`` (an LSTM's recurrent kernel) as
        independent orthogonal ``[H, H]`` blocks, zero biases,
        unit scales (``fill`` overrides), zero running means and unit
        running variances. Drawn on the CPU so a seed gives the same
        weights on every device. The dropout generator, on the model's
        device, is seeded from ``generator`` after the weights."""
        for path, leaf in self.leaves().items():
            kind = path.rsplit("/", 1)[1]
            if path in self.fill:
                leaf.fill_(self.fill[path])
            elif path in self.orthogonal:
                h = leaf.shape[0]
                for gate in range(leaf.shape[1] // h):
                    w = torch.empty(h, h)
                    nn.init.orthogonal_(w, generator=generator)
                    leaf[:, gate * h:(gate + 1) * h] = w
            elif kind == "kernel":
                w = torch.empty(leaf.shape)
                nn.init.trunc_normal_(w, 0.0, 1.0, -_TRUNC, _TRUNC,
                                      generator=generator)
                fan_in = self.fan_in.get(path, math.prod(leaf.shape[:-1]))
                leaf.copy_(w / (_TRUNC_STD * math.sqrt(fan_in)))
            elif kind == "embedding":
                w = torch.empty(leaf.shape)
                nn.init.normal_(w, 0.0, 1.0 / math.sqrt(leaf.shape[-1]),
                                generator=generator)
                leaf.copy_(w)
            elif kind == "scale":
                leaf.fill_(1.0)
            else:
                leaf.zero_()
        for path, _ in self.stats_layout:
            self.stat(path).fill_(1.0 if path.endswith("/var") else 0.0)
        seed = int(torch.randint(2 ** 62, (), generator=generator))
        self.dropout_generator = torch.Generator(
            self.flat.device).manual_seed(seed)

    # ----------------------------------------------------------- layers
    def _conv(self, p: Dict[str, torch.Tensor], x: torch.Tensor, name: str,
              stride: Union[int, Tuple[int, int]] = 1,
              padding: Union[int, str] = 0) -> torch.Tensor:
        """flax ``Conv`` on NCHW ``x``: input, HWIO kernel and (where the
        leaf exists) bias cast to the compute dtype, the bias added to the
        product's result in that dtype. ``padding`` is an int
        for both sides of both axes, or ``"SAME"``: per axis ``total =
        max((out - 1) * s + k - in, 0)`` with ``out = ceil(in / s)``,
        ``total // 2`` before and the rest after (asymmetric when odd)."""
        w = p[f"{name}/kernel"]
        strides = (stride, stride) if isinstance(stride, int) else stride
        x = x.to(self.dtype)
        if padding == "SAME":
            pads = []          # F.pad's order: the last axis first
            for size, k, s in reversed(tuple(zip(x.shape[2:], w.shape[:2],
                                                 strides))):
                total = max((-(-size // s) - 1) * s + k - size, 0)
                pads += [total // 2, total - total // 2]
            x, padding = F.pad(x, pads), 0
        y = F.conv2d(x, w.permute(3, 2, 0, 1).to(self.dtype),  # OIHW
                     stride=strides, padding=padding)
        bias = p.get(f"{name}/bias")
        return y if bias is None else y + bias.to(self.dtype).view(-1, 1, 1)

    def _batch_norm(self, p: Dict[str, torch.Tensor], x: torch.Tensor,
                    name: str, train: bool, axis: int = 1) -> torch.Tensor:
        """flax ``BatchNorm`` in f32 over every axis of ``x`` but the
        channel ``axis`` (1 for NCHW, -1 for channels-last), computed in
        ``ops.batch_norm``: in train mode on the batch's statistics, which
        update the running ones in place (kernel B5 on a card); in eval
        mode on the running statistics."""
        scale, bias = p[f"{name}/scale"], p[f"{name}/bias"]
        mean, var = self.stat(f"{name}/mean"), self.stat(f"{name}/var")
        if train:
            return batch_norm_train(x, scale, bias, mean, var, axis,
                                    _BN_MOMENTUM, _BN_EPS)
        return normalise(x, mean, var, scale, bias, axis, _BN_EPS)

    @staticmethod
    def _dense(p: Dict[str, torch.Tensor], x: torch.Tensor, name: str,
               dtype: torch.dtype) -> torch.Tensor:
        w = p[f"{name}/kernel"].to(dtype)
        return x.to(dtype) @ w + p[f"{name}/bias"].to(dtype)

    def _layer_norm(self, p: Dict[str, torch.Tensor], x: torch.Tensor,
                    name: str) -> torch.Tensor:
        """flax ``LayerNorm(dtype=float32)`` over the last axis: f32 out,
        the variance ``E[x^2] - E[x]^2`` clipped at 0, eps 1e-6."""
        x = x.float()
        mean = x.mean(dim=-1, keepdim=True)
        var = torch.clamp((x * x).mean(dim=-1, keepdim=True) - mean * mean,
                          min=0.0)
        mul = torch.rsqrt(var + _LN_EPS) * p[f"{name}/scale"]
        return (x - mean) * mul + p[f"{name}/bias"]

    def _drop(self, x: torch.Tensor, train: bool,
              shape: Optional[Shape] = None) -> torch.Tensor:
        """``_dropout`` in training with a nonzero rate, else ``x``."""
        return self._dropout(x, shape=shape) if train and self.dropout else x

    def _dropout(self, x: torch.Tensor,
                 shape: Optional[Shape] = None) -> torch.Tensor:
        """flax's ``Dropout`` at the model's ``dropout`` rate: keep with
        probability ``1 - rate`` and scale the kept entries by
        ``1 / (1 - rate)``; the mask is drawn at ``shape`` (broadcast
        against ``x``, default ``x``'s shape) from the model's own
        generator."""
        if self.dropout_generator is None:
            raise RuntimeError("dropout needs the model's generator: call "
                               "reset_parameters first")
        keep_prob = 1.0 - self.dropout
        keep = torch.rand(x.shape if shape is None else shape,
                          generator=self.dropout_generator,
                          device=x.device) < keep_prob
        return torch.where(keep, x / keep_prob, 0.0)


class _Logistic(torch.autograd.Function):
    """``jax.nn.sigmoid`` (``lax.logistic``): the value ``1 / (1 +
    exp(-x))`` with each of its ops rounded to ``x``'s dtype, as the
    reference lowers it, and the gradient ``g * (s * (1 - s))`` from the
    value ``s``. In bf16 ``torch.sigmoid`` rounds once and differs from it
    by one unit in the last place on about a third of its inputs."""

    @staticmethod
    def forward(ctx, x: torch.Tensor) -> torch.Tensor:
        s = torch.exp(-x).add_(1.0).reciprocal_()
        ctx.save_for_backward(s)
        return s

    @staticmethod
    def backward(ctx, g: torch.Tensor) -> torch.Tensor:
        (s,) = ctx.saved_tensors
        return g * (s * (1.0 - s))


def sigmoid(x: torch.Tensor) -> torch.Tensor:
    return _Logistic.apply(x)


def hard_tanh(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.hard_tanh``: ``where(x > 1, 1, where(x < -1, -1, x))``,
    whose gradient is 1 on the closed interval [-1, 1] (``F.hardtanh``'s
    is 0 at exactly +-1)."""
    return torch.where(x > 1.0, 1.0, torch.where(x < -1.0, -1.0, x))
