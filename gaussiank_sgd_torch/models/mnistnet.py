"""The small MNIST convnet (port of ``gaussiank_sgd_tpu/models/mnistnet.py``),
on the flat parameter of ``models/flat.py``.

Two 5x5 convs with bias (pad 2; 32 and 64 channels), each followed by a
ReLU and a 2x2 max pool, then Dense 512, dropout 0.5 and Dense 10 (in f32).
The public input is NHWC ``[N, 28, 28, 1]``; the flatten before
``Dense_0`` is in NHWC order. 1,663,370 parameters.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F

from .flat import FlatModel, Shape, add_conv, add_dense


class MnistNet(FlatModel):
    """``forward(x [N, 28, 28, 1], train)`` -> f32 logits ``[N, classes]``."""

    def __init__(self, num_classes: int = 10,
                 dtype: torch.dtype = torch.float32,
                 device: Optional[torch.device] = None):
        params: Dict[str, Shape] = {}
        add_conv(params, "Conv_0", 5, 1, 32, bias=True)
        add_conv(params, "Conv_1", 5, 32, 64, bias=True)
        add_dense(params, "Dense_0", 7 * 7 * 64, 512)
        add_dense(params, "Dense_1", 512, num_classes)
        super().__init__(params, {}, dtype, device)
        self.num_classes = num_classes
        self.dropout = 0.5

    def forward(self, x: torch.Tensor, train: bool = True) -> torch.Tensor:
        p = self.leaves()
        x = x.to(self.dtype).permute(0, 3, 1, 2)           # NHWC -> NCHW
        for i in range(2):
            x = F.max_pool2d(F.relu(self._conv(p, x, f"Conv_{i}",
                                               padding=2)), 2, 2)
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)   # NHWC flatten
        x = F.relu(self._dense(p, x, "Dense_0", self.dtype))
        if train:
            x = self._dropout(x)
        return self._dense(p, x, "Dense_1", torch.float32)
