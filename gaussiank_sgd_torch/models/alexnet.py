"""AlexNet, the CIFAR variant of the compression literature (port of
``gaussiank_sgd_tpu/models/alexnet.py``), on the flat parameter of
``models/flat.py``.

Five 3x3 convs with bias (the first at stride 2; all pad 1), ReLUs and
three 2x2 max pools take a 32x32 image to ``[2, 2, 256]``; the flatten
(1,024, NHWC order) goes through dropout, Dense 4096, dropout, Dense 4096
and Dense 10 (in f32). The dropout rate is fixed at 0.5, as in the
reference. 23,272,266 parameters.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F

from .flat import FlatModel, Shape, add_conv, add_dense

# (output channels, stride, pool after) of each conv
_CONVS = ((64, 2, True), (192, 1, True), (384, 1, False), (256, 1, False),
          (256, 1, True))


class AlexNet(FlatModel):
    """``forward(x [N, 32, 32, 3], train)`` -> f32 logits ``[N, classes]``."""

    def __init__(self, num_classes: int = 10,
                 dtype: torch.dtype = torch.float32,
                 device: Optional[torch.device] = None):
        params: Dict[str, Shape] = {}
        cin = 3
        for i, (cout, _, _) in enumerate(_CONVS):
            add_conv(params, f"Conv_{i}", 3, cin, cout, bias=True)
            cin = cout
        add_dense(params, "Dense_0", 2 * 2 * 256, 4096)
        add_dense(params, "Dense_1", 4096, 4096)
        add_dense(params, "Dense_2", 4096, num_classes)
        super().__init__(params, {}, dtype, device)
        self.num_classes = num_classes
        self.dropout = 0.5

    def forward(self, x: torch.Tensor, train: bool = True) -> torch.Tensor:
        p = self.leaves()
        x = x.to(self.dtype).permute(0, 3, 1, 2)           # NHWC -> NCHW
        for i, (_, stride, pool) in enumerate(_CONVS):
            x = F.relu(self._conv(p, x, f"Conv_{i}", stride, padding=1))
            if pool:
                x = F.max_pool2d(x, 2, 2)
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)   # NHWC flatten
        for i in range(2):
            if train:
                x = self._dropout(x)
            x = F.relu(self._dense(p, x, f"Dense_{i}", self.dtype))
        return self._dense(p, x, "Dense_2", torch.float32)
