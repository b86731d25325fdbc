"""Transformer-base encoder-decoder for WMT14 En-De (port of
``gaussiank_sgd_tpu/models/transformer.py``), pre-LN, on the flat parameter
of ``models/flat.py``.

Leaves keep flax's names and layouts: ``shared_embed/embedding`` ``[V, D]``
(the source and target embedding and the tied output projection);
``enc_i``/``dec_i`` layers of ``LayerNorm_j`` (``bias``, ``scale``),
``MultiHeadDotProductAttention_j`` with ``query``/``key``/``value``
kernels ``[D, heads, D/heads]`` and biases ``[heads, D/heads]`` and an
``out`` kernel ``[heads, D/heads, D]``, and ``MLP_0`` (``Dense_0``,
``Dense_1``); the final ``LayerNorm_0`` (encoder) and ``LayerNorm_1``
(decoder).

The dtype flow is flax's at compute dtype ``dt``: the embedding is cast to
``dt`` and scaled by ``sqrt(D)`` rounded to ``dt``, plus the sinusoidal
table (a constant, not a parameter) in ``dt``; each LayerNorm computes in
f32 and hands f32 to the next dense layer, which casts it to ``dt``; the
residual stream stays in ``dt``. Attention divides the query by
``sqrt(D/heads)`` in ``dt`` before ``Q K^T``, masks with ``finfo(dt).min``
(not ``-inf``) and takes the softmax in ``dt``: a fully masked row (query
position 0 of the decoder, a pad on every step) gets uniform weights over
every key, as in the reference. The tied output projection casts the f32
decoder output and the table to ``dt``, so at bf16 the logits are bf16.
Attention dropout draws one ``[q, k]`` mask shared by the batch and the
heads (flax's ``broadcast_dropout``).
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import numpy as np
import torch

from .flat import FlatModel, Shape, add_dense


def sinusoidal_positions(max_len: int, dim: int) -> np.ndarray:
    pos = np.arange(max_len)[:, None]
    div = np.exp(np.arange(0, dim, 2) * (-np.log(10000.0) / dim))
    pe = np.zeros((max_len, dim), np.float32)
    pe[:, 0::2] = np.sin(pos * div)
    pe[:, 1::2] = np.cos(pos * div)
    return pe


def _add_layer_norm(params: Dict[str, Shape], name: str, dim: int) -> None:
    params[f"{name}/bias"] = params[f"{name}/scale"] = (dim,)


def add_mlp(params: Dict[str, Shape], prefix: str, dim: int,
            ffn: int) -> None:
    add_dense(params, f"{prefix}/Dense_0", dim, ffn)
    add_dense(params, f"{prefix}/Dense_1", ffn, dim)


def mlp(model: FlatModel, p: Dict[str, torch.Tensor], prefix: str,
        h: torch.Tensor, train: bool) -> torch.Tensor:
    """flax's ``MLP`` (the reference's ``models/transformer.py``) under
    ``prefix``: ``Dense_0``, relu, dropout, ``Dense_1``, dropout, in the
    model's compute dtype."""
    dt = model.dtype
    h = torch.relu(model._dense(p, h, f"{prefix}/Dense_0", dt))
    h = model._drop(h, train)
    h = model._dense(p, h, f"{prefix}/Dense_1", dt)
    return model._drop(h, train)


class Transformer(FlatModel):
    """``forward(src [B, S] int, tgt [B, T] int, train)`` -> logits
    ``[B, T, V]`` in the compute dtype; ``tgt`` is the decoder's input
    (the target shifted right)."""

    def __init__(self, vocab_size: int = 32000, dim: int = 512,
                 heads: int = 8, enc_layers: int = 6, dec_layers: int = 6,
                 ffn: int = 2048, dropout: float = 0.1, max_len: int = 512,
                 pad_id: int = 0, dtype: torch.dtype = torch.float32,
                 device: Optional[torch.device] = None):
        if dim % heads:
            raise ValueError(f"dim {dim} is not divisible by {heads} heads")
        hd = dim // heads
        params: Dict[str, Shape] = {"shared_embed/embedding":
                                    (vocab_size, dim)}
        fan_in: Dict[str, int] = {}

        def attention(name: str) -> None:
            for part in ("query", "key", "value"):
                params[f"{name}/{part}/kernel"] = (dim, heads, hd)
                params[f"{name}/{part}/bias"] = (heads, hd)
                fan_in[f"{name}/{part}/kernel"] = dim
            params[f"{name}/out/kernel"] = (heads, hd, dim)
            params[f"{name}/out/bias"] = (dim,)


        for i in range(enc_layers):
            _add_layer_norm(params, f"enc_{i}/LayerNorm_0", dim)
            attention(f"enc_{i}/MultiHeadDotProductAttention_0")
            _add_layer_norm(params, f"enc_{i}/LayerNorm_1", dim)
            add_mlp(params, f"enc_{i}/MLP_0", dim, ffn)
        for i in range(dec_layers):
            for j in range(3):
                _add_layer_norm(params, f"dec_{i}/LayerNorm_{j}", dim)
            for j in range(2):
                attention(f"dec_{i}/MultiHeadDotProductAttention_{j}")
            add_mlp(params, f"dec_{i}/MLP_0", dim, ffn)
        _add_layer_norm(params, "LayerNorm_0", dim)
        _add_layer_norm(params, "LayerNorm_1", dim)
        super().__init__(params, {}, dtype, device, fan_in=fan_in)
        self.vocab_size = vocab_size
        self.dim, self.heads, self.hd = dim, heads, hd
        self.enc_layers, self.dec_layers = enc_layers, dec_layers
        self.dropout = dropout
        self.pad_id = pad_id
        self.register_buffer("positions", torch.from_numpy(
            sinusoidal_positions(max_len, dim)).to(device), persistent=False)

    # ----------------------------------------------------------- blocks
    def _attention(self, p: Dict[str, torch.Tensor], name: str,
                   xq: torch.Tensor, xkv: torch.Tensor, mask: torch.Tensor,
                   train: bool) -> torch.Tensor:
        """flax's ``MultiHeadDotProductAttention`` with its default
        ``dot_product_attention``; ``mask`` is boolean ``[B, 1, q, k]``."""
        dt = self.dtype

        def proj(x, part):                      # [B, L, D] -> [B, H, L, hd]
            w = p[f"{name}/{part}/kernel"].to(dt)
            y = x.to(dt) @ w.reshape(self.dim, -1) + p[
                f"{name}/{part}/bias"].to(dt).reshape(-1)
            return y.reshape(x.shape[0], x.shape[1], self.heads,
                             self.hd).transpose(1, 2)

        q, k, v = proj(xq, "query"), proj(xkv, "key"), proj(xkv, "value")
        q = q / torch.tensor(math.sqrt(self.hd), dtype=dt)
        w = q @ k.transpose(-1, -2)                          # [B, H, q, k]
        w = torch.where(mask, w, torch.finfo(dt).min)
        w = torch.softmax(w, dim=-1)
        w = self._drop(w, train, shape=(1, 1) + tuple(w.shape[-2:]))
        o = (w @ v).transpose(1, 2).reshape(xq.shape[0], xq.shape[1], -1)
        return (o @ p[f"{name}/out/kernel"].to(dt).reshape(-1, self.dim)
                + p[f"{name}/out/bias"].to(dt))

    def _embed(self, p, ids: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        scale = torch.tensor(math.sqrt(self.dim), dtype=torch.float32).to(dt)
        table = p["shared_embed/embedding"].to(dt)
        return (table[ids.long()] * scale
                + self.positions[:ids.shape[1]].to(dt))

    # ---------------------------------------------------------- forward
    def masks(self, src: torch.Tensor, tgt: torch.Tensor):
        """``(encoder, decoder, cross)`` boolean masks ``[B, 1, q, k]``:
        both positions real, and for the decoder also causal."""
        sp, tp = src != self.pad_id, tgt != self.pad_id
        t = tgt.shape[1]
        causal = torch.ones(t, t, dtype=torch.bool,
                            device=tgt.device).tril()
        return (sp[:, None, :, None] & sp[:, None, None, :],
                tp[:, None, :, None] & tp[:, None, None, :] & causal,
                tp[:, None, :, None] & sp[:, None, None, :])

    def forward(self, src: torch.Tensor, tgt: torch.Tensor,
                train: bool = True) -> torch.Tensor:
        p = self.leaves()
        enc_mask, dec_mask, cross_mask = self.masks(src, tgt)
        x = self._drop(self._embed(p, src), train)
        for i in range(self.enc_layers):
            n = f"enc_{i}"
            h = self._layer_norm(p, x, f"{n}/LayerNorm_0")
            h = self._attention(p, f"{n}/MultiHeadDotProductAttention_0",
                                h, h, enc_mask, train)
            x = x + self._drop(h, train)
            h = self._layer_norm(p, x, f"{n}/LayerNorm_1")
            x = x + mlp(self, p, f"{n}/MLP_0", h, train)
        enc = self._layer_norm(p, x, "LayerNorm_0")

        y = self._drop(self._embed(p, tgt), train)
        for i in range(self.dec_layers):
            n = f"dec_{i}"
            h = self._layer_norm(p, y, f"{n}/LayerNorm_0")
            h = self._attention(p, f"{n}/MultiHeadDotProductAttention_0",
                                h, h, dec_mask, train)
            y = y + self._drop(h, train)
            h = self._layer_norm(p, y, f"{n}/LayerNorm_1")
            h = self._attention(p, f"{n}/MultiHeadDotProductAttention_1",
                                h, enc, cross_mask, train)
            y = y + self._drop(h, train)
            h = self._layer_norm(p, y, f"{n}/LayerNorm_2")
            y = y + mlp(self, p, f"{n}/MLP_0", h, train)
        y = self._layer_norm(p, y, "LayerNorm_1")
        table = p["shared_embed/embedding"].to(self.dtype)
        return y.to(self.dtype) @ table.t()
