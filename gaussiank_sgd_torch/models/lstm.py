"""2-layer LSTM language model for PTB (port of
``gaussiank_sgd_tpu/models/lstm.py``), on the flat parameter of
``models/flat.py``.

Leaves, in the reference's flat order: ``Dense_0`` (the output projection,
``[H, V]`` and its bias), ``Embed_0/embedding`` ``[V, E]``, then per layer
``lstm_i/wh`` ``[H, 4H]`` (a bare recurrent kernel) and ``lstm_i/wx``
(a dense ``[in, 4H]`` kernel with a bias). The gates are packed i|f|g|o
along the output axis.

As in the reference, a layer's input projection ``x @ wx + b`` is one
``[B*T, in] @ [in, 4H]`` product outside the recurrence, and each of the T
serial steps is ``gates = xw_t + h @ wh``, then ``c = sig(f) c + sig(i)
tanh(g)``, ``h = sig(o) tanh(c)``, where ``sig`` is ``flat.sigmoid``
(``jax.nn.sigmoid``'s ops, each rounded, so bf16 rounds as the reference
does). Dropout follows the embedding and every
layer, the last one included. The output projection runs in f32.

The carry is one tensor ``[num_layers, 2, B, H]``: layer i's ``(c, h)``,
the reference's tuple of ``(c, h)`` pairs stacked. ``forward(tokens,
train, carry)`` starts from ``carry`` (zeros when None) and returns the
logits and the final carry, detached: no gradient flows into an earlier
window (the reference's truncated bptt).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from .flat import FlatModel, Shape, add_dense, sigmoid


class LSTMLM(FlatModel):
    """``forward(tokens [B, T] int, train, carry)`` -> ``(logits [B, T, V]
    f32, carry [L, 2, B, H])``."""

    def __init__(self, vocab_size: int = 10000, embed_dim: int = 650,
                 hidden_dim: int = 650, num_layers: int = 2,
                 dropout: float = 0.5, dtype: torch.dtype = torch.float32,
                 device: Optional[torch.device] = None):
        params: Dict[str, Shape] = {"Embed_0/embedding": (vocab_size,
                                                          embed_dim)}
        din = embed_dim
        for i in range(num_layers):
            params[f"lstm_{i}/wh"] = (hidden_dim, 4 * hidden_dim)
            add_dense(params, f"lstm_{i}/wx", din, 4 * hidden_dim)
            din = hidden_dim
        add_dense(params, "Dense_0", hidden_dim, vocab_size)
        super().__init__(params, {}, dtype, device, orthogonal=[
            f"lstm_{i}/wh" for i in range(num_layers)])
        self.vocab_size = vocab_size
        self.hidden_dim = hidden_dim
        self.num_layers = num_layers
        self.dropout = dropout

    def initial_carry(self, batch_size: int,
                      device: Optional[torch.device] = None) -> torch.Tensor:
        """Zero carry for ``batch_size`` rows."""
        return torch.zeros(self.num_layers, 2, batch_size, self.hidden_dim,
                           dtype=self.dtype,
                           device=device or self.flat.device)

    def _layer(self, p: Dict[str, torch.Tensor], x: torch.Tensor, i: int,
               c: torch.Tensor, h: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        dt = self.dtype
        xw = self._dense(p, x, f"lstm_{i}/wx", dt)             # [B, T, 4H]
        wh = p[f"lstm_{i}/wh"].to(dt)
        hs = []
        for t in range(x.shape[1]):
            gates = xw[:, t] + h @ wh
            gi, gf, gg, go = gates.chunk(4, dim=-1)
            c = sigmoid(gf) * c + sigmoid(gi) * torch.tanh(gg)
            h = sigmoid(go) * torch.tanh(c)
            hs.append(h)
        return torch.stack(hs, dim=1), c, h

    def forward(self, tokens: torch.Tensor, train: bool = True,
                carry: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        p = self.leaves()
        if carry is None:
            carry = self.initial_carry(tokens.shape[0], tokens.device)
        x = p["Embed_0/embedding"].to(self.dtype)[tokens.long()]
        if train and self.dropout:
            x = self._dropout(x)
        finals = []
        for i in range(self.num_layers):
            x, c, h = self._layer(p, x, i, carry[i, 0], carry[i, 1])
            finals.append(torch.stack([c, h]))
            if train and self.dropout:
                x = self._dropout(x)
        logits = self._dense(p, x, "Dense_0", torch.float32)
        return logits, torch.stack(finals).detach()
