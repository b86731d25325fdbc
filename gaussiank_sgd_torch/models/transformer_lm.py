"""Decoder-only Transformer LM with optional ring-attention sequence
parallelism (port of ``gaussiank_sgd_tpu/models/transformer_lm.py``),
pre-LN, on the flat parameter of ``models/flat.py``.

Leaves keep flax's names and layouts: ``embed/embedding`` ``[V, D]`` (the
input embedding and the tied output projection); per layer ``i``
``ln1_i``/``ln2_i`` (``bias``, ``scale``), ``attn_i/qkv`` (flax's
``DenseGeneral((3, H, D/H))``: kernel ``[D, 3, H, D/H]``, bias ``[3, H,
D/H]``), ``attn_i/proj`` (``Dense(D)``) and ``mlp_i`` (``Dense_0``,
``Dense_1``); the final ``ln_f``.

The dtype flow is flax's at compute dtype ``dt``: the table cast to ``dt``,
the embedding scaled by ``sqrt(D)`` rounded to ``dt``, plus the sinusoidal
positions in ``dt``; every LayerNorm in f32; the dense layers cast their
input and kernel to ``dt``. Local attention (no group): ``Q K^T`` in f32
(the products of ``dt`` values are exact there), scaled by ``(D/H)^-0.5``,
future keys masked with ``-1e30``, the softmax in f32, its weights cast to
``dt`` before ``P V``. The tied head casts the f32 final LayerNorm's
output and the table to ``dt`` (flax's ``Embed.attend``), so at bf16 the
logits are bf16.

With ``sp_group`` the model runs one block of the sequence on each rank of
that group (``parallel/ring_attention.py``): ``tokens`` are this rank's
``T_local`` positions, their positions start at ``rank * T_local`` (the
reference asserts ``max_len >= sp * T_local``), and attention is the ring.
Everything else is local, and the parameters are those of the model
without a group: the initial weights depend on the seed only.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch

from ..parallel.collectives import Group, rank, world_size
from ..parallel.ring_attention import NEG_INF, ring_attention
from .flat import FlatModel, Shape, add_dense
from .transformer import _add_layer_norm, add_mlp, mlp, sinusoidal_positions


class TransformerLM(FlatModel):
    """``forward(tokens [B, T_local] int, train)`` -> logits ``[B,
    T_local, V]`` in the compute dtype."""

    def __init__(self, vocab_size: int = 32000, dim: int = 512,
                 heads: int = 8, num_layers: int = 6, ffn: int = 2048,
                 dropout: float = 0.1, max_len: int = 2048,
                 dtype: torch.dtype = torch.float32,
                 device: Optional[torch.device] = None,
                 sp_group: Group = None):
        if dim % heads:
            raise ValueError(f"dim {dim} is not divisible by {heads} heads")
        hd = dim // heads
        params: Dict[str, Shape] = {"embed/embedding": (vocab_size, dim)}
        fan_in: Dict[str, int] = {}
        for i in range(num_layers):
            _add_layer_norm(params, f"ln1_{i}", dim)
            params[f"attn_{i}/qkv/kernel"] = (dim, 3, heads, hd)
            params[f"attn_{i}/qkv/bias"] = (3, heads, hd)
            fan_in[f"attn_{i}/qkv/kernel"] = dim
            add_dense(params, f"attn_{i}/proj", dim, dim)
            _add_layer_norm(params, f"ln2_{i}", dim)
            add_mlp(params, f"mlp_{i}", dim, ffn)
        _add_layer_norm(params, "ln_f", dim)
        super().__init__(params, {}, dtype, device, fan_in=fan_in)
        self.vocab_size = vocab_size
        self.dim, self.heads, self.hd = dim, heads, hd
        self.num_layers = num_layers
        self.dropout = dropout
        self.max_len = max_len
        self.sp_group = sp_group
        self.register_buffer("positions", torch.from_numpy(
            sinusoidal_positions(max_len, dim)).to(device), persistent=False)

    def _attention(self, p: Dict[str, torch.Tensor], i: int,
                   x: torch.Tensor) -> torch.Tensor:
        """The reference's ``RingSelfAttention``: causal, local or the
        ring."""
        dt, hd = self.dtype, self.hd
        w = p[f"attn_{i}/qkv/kernel"].to(dt).reshape(self.dim, -1)
        qkv = x.to(dt) @ w + p[f"attn_{i}/qkv/bias"].to(dt).reshape(-1)
        qkv = qkv.reshape(x.shape[0], x.shape[1], 3, self.heads, hd)
        q, k, v = (qkv[:, :, j].transpose(1, 2) for j in range(3))
        if self.sp_group is not None:
            out = ring_attention(q, k, v, self.sp_group, causal=True)
        else:
            s = torch.matmul(q.float(), k.float().transpose(-1, -2))
            s = s * hd ** -0.5
            t = s.shape[-1]
            mask = torch.ones(t, t, dtype=torch.bool,
                              device=s.device).tril()
            s = torch.where(mask, s, NEG_INF)
            out = torch.softmax(s, dim=-1).to(dt) @ v
        out = out.transpose(1, 2).reshape(x.shape[0], x.shape[1], self.dim)
        return self._dense(p, out, f"attn_{i}/proj", dt)

    def forward(self, tokens: torch.Tensor,
                train: bool = True) -> torch.Tensor:
        p = self.leaves()
        dt = self.dtype
        t_local = tokens.shape[1]
        if self.sp_group is not None:
            sp = world_size(self.sp_group)
            if self.max_len < sp * t_local:
                raise ValueError(f"max_len={self.max_len} < global sequence "
                                 f"{sp}x{t_local}; raise max_len")
            start = rank(self.sp_group) * t_local
            pos = self.positions[start:start + t_local]
        else:
            pos = self.positions[:t_local]
        table = p["embed/embedding"].to(dt)
        scale = torch.tensor(math.sqrt(self.dim), dtype=torch.float32).to(dt)
        x = table[tokens.long()] * scale + pos.to(dt)
        x = self._drop(x, train)
        for i in range(self.num_layers):
            h = self._layer_norm(p, x, f"ln1_{i}")
            x = x + self._drop(self._attention(p, i, h), train)
            h = self._layer_norm(p, x, f"ln2_{i}")
            x = x + mlp(self, p, f"mlp_{i}", h, train)
        x = self._layer_norm(p, x, "ln_f")
        return x.to(dt) @ table.t()
