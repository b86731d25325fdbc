"""The DeepSpeech-style bidirectional LSTM of the ``lstman4`` workload
(port of ``gaussiank_sgd_tpu/models/speech.py``), on the flat parameter of
``models/flat.py``.

Input: a log-spectrogram ``[B, F, T]`` f32 (F = 161 frequency bins).
Front end, on ``[B, 1, T, F]`` (time is the conv's first spatial axis, as
in the reference's NHWC ``[B, T, F, 1]``): Conv (11, 41) stride (2, 2)
with bias, BatchNorm, ``hard_tanh``, Conv (11, 21) stride (1, 2),
BatchNorm (channels-last), ``hard_tanh``; both convs pad ``"SAME"`` as
flax does (at T = 200 the first pads time by (4, 5)). The frequency and
channel axes fold into one, channels fastest as the reference's reshape of
``[B, T', F', C]``. Then ``num_layers`` BiLSTM layers, each the sum of a
forward and a backward pass (the backward one runs over the time-reversed
sequence, padded frames included, and is reversed back), and an f32 Dense
to ``num_labels`` CTC labels: logits ``[B, T', num_labels]``, T' =
ceil(T / 2).

Leaves, in the reference's flat order: ``BatchNorm_0``, ``BatchNorm_1``,
``Conv_0``, ``Conv_1``, ``Dense_0``, then per layer ``bilstm_i/`` with
``OptimizedLSTMCell_0`` (the forward pass) and ``OptimizedLSTMCell_1``
(the backward pass), each flax's ``OptimizedLSTMCell``: input kernels
``ii, if, ig, io`` ``[in, H]`` without bias and hidden kernels ``hi, hf,
hg, ho`` ``[H, H]`` with bias (orthogonal at init), sorted by name. A cell
step is the reference's: ``gates = (h @ Wh + b) + x @ Wi`` for i|f|g|o,
``c = sig(f) c + sig(i) tanh(g)``, ``h = sig(o) tanh(c)``, the carry in
f32 from zeros; ``sig`` is ``flat.sigmoid`` and each op rounds to the
compute dtype as the reference's ops do. Each layer's input projection
is one batched product for both directions outside the recurrence, and
each of the T' serial steps advances both directions in one batched
product.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from .flat import (FlatModel, Shape, add_batch_norm, add_conv, add_dense,
                   hard_tanh, sigmoid)

# the gates in the order their kernels are packed in: the three sigmoid
# gates first, so that one split feeds the sigmoid and the tanh
_GATES = "ifog"


def _cell(layer: int, direction: int) -> str:
    return f"bilstm_{layer}/OptimizedLSTMCell_{direction}"


class LSTMAN4(FlatModel):
    """``forward(spec [B, freq, T], train)`` -> f32 logits ``[B, ceil(T /
    2), num_labels]``. ``freq`` sizes the fold (the reference reads it off
    the input it is initialised with, ``[161, 200]``)."""

    def __init__(self, num_labels: int = 29, hidden: int = 512,
                 num_layers: int = 3, freq: int = 161,
                 dtype: torch.dtype = torch.float32,
                 device: Optional[torch.device] = None):
        params: Dict[str, Shape] = {}
        stats: Dict[str, Shape] = {}
        add_conv(params, "Conv_0", (11, 41), 1, 32, bias=True)
        add_batch_norm(params, stats, "BatchNorm_0", 32)
        add_conv(params, "Conv_1", (11, 21), 32, 32, bias=True)
        add_batch_norm(params, stats, "BatchNorm_1", 32)
        half = -(-freq // 2)                      # Conv_0's frequencies
        din = 32 * -(-half // 2)                  # F' x C after Conv_1
        orthogonal = []
        for i in range(num_layers):
            for d in (0, 1):
                for g in _GATES:
                    params[f"{_cell(i, d)}/i{g}/kernel"] = (din, hidden)
                    add_dense(params, f"{_cell(i, d)}/h{g}", hidden, hidden)
                    orthogonal.append(f"{_cell(i, d)}/h{g}/kernel")
            din = hidden
        add_dense(params, "Dense_0", hidden, num_labels)
        super().__init__(params, stats, dtype, device, orthogonal=orthogonal)
        self.num_labels = num_labels
        self.hidden = hidden
        self.num_layers = num_layers
        self.freq = freq

    def _bilstm(self, p: Dict[str, torch.Tensor], x: torch.Tensor,
                i: int) -> torch.Tensor:
        """Layer ``i`` on ``x`` ``[B, T, in]``: the forward pass plus the
        backward pass, ``[B, T, H]`` f32."""
        dt = self.dtype
        b, t, din = x.shape

        def packed(kind: str, leaf: str) -> torch.Tensor:
            return torch.stack([torch.cat([p[f"{_cell(i, d)}/{kind}{g}/"
                                             f"{leaf}"] for g in _GATES], -1)
                                for d in (0, 1)]).to(dt)

        wi, wh, bh = packed("i", "kernel"), packed("h", "kernel"), \
            packed("h", "bias").unsqueeze(1)
        xs = torch.stack([x, x.flip(1)]).to(dt).view(2, b * t, din)
        xw = torch.bmm(xs, wi).view(2, b, t, -1)            # [2, B, T, 4H]
        c = torch.zeros(2, b, self.hidden, device=x.device)
        h = torch.zeros_like(c)
        hs = []
        for s in range(t):
            # rounded as the reference's (h Wh + b) + x Wi, op by op
            gates = torch.bmm(h.to(dt), wh) + bh + xw[:, :, s]
            ifo, g = gates.split([3 * self.hidden, self.hidden], dim=-1)
            si, sf, so = sigmoid(ifo).chunk(3, dim=-1)
            c = sf * c + si * torch.tanh(g)
            h = so * torch.tanh(c)
            hs.append(h)
        out = torch.stack(hs, dim=2)                        # [2, B, T, H]
        return out[0] + out[1].flip(1)

    def forward(self, spec: torch.Tensor, train: bool = True
                ) -> torch.Tensor:
        p = self.leaves()
        x = spec.to(self.dtype).unsqueeze(1).transpose(2, 3)  # [B, 1, T, F]
        x = self._conv(p, x, "Conv_0", 2, "SAME")
        x = hard_tanh(self._batch_norm(p, x, "BatchNorm_0", train))
        x = self._conv(p, x, "Conv_1", (1, 2), "SAME").permute(0, 2, 3, 1)
        x = hard_tanh(self._batch_norm(p, x, "BatchNorm_1", train, axis=-1))
        x = x.reshape(x.shape[0], x.shape[1], -1)   # [B, T', F' * C]
        for i in range(self.num_layers):
            x = self._bilstm(p, x, i)
        return self._dense(p, x, "Dense_0", torch.float32)
