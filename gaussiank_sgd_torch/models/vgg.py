"""VGG-16, CIFAR variant with BatchNorm (port of
``gaussiank_sgd_tpu/models/vgg.py``), on the flat parameter of
``models/flat.py``.

The input and the conv/dense kernels are cast to the compute dtype,
BatchNorm runs in f32 and the last dense layer runs in f32. The public input
is NHWC, as in the reference; the flatten before ``Dense_0`` is in NHWC
order. Dropout draws its mask from the model's own generator, seeded by
``reset_parameters``, so a seed fixes a run.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from .flat import FlatModel, Shape, add_batch_norm, add_conv, add_dense

# Standard VGG-16 layout; 'M' = 2x2 max-pool.
_CFG = (64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
        512, 512, 512, "M", 512, 512, 512, "M")


class VGG16(FlatModel):
    """``forward(x [N, H, W, C], train)`` -> f32 logits ``[N, classes]``."""

    def __init__(self, num_classes: int = 10,
                 dtype: torch.dtype = torch.float32,
                 cfg: Sequence = _CFG, dropout: float = 0.5,
                 input_shape: Tuple[int, int, int] = (32, 32, 3),
                 device: Optional[torch.device] = None):
        h, w, cin = input_shape
        params: Dict[str, Shape] = {}
        stats: Dict[str, Shape] = {}
        n_conv = 0
        for v in cfg:
            if v == "M":
                h, w = h // 2, w // 2
                continue
            add_conv(params, f"Conv_{n_conv}", 3, cin, v)
            add_batch_norm(params, stats, f"BatchNorm_{n_conv}", v)
            cin = v
            n_conv += 1
        add_dense(params, "Dense_0", h * w * cin, 512)
        add_dense(params, "Dense_1", 512, num_classes)
        super().__init__(params, stats, dtype, device)
        self.num_classes = num_classes
        self.cfg = tuple(cfg)
        self.dropout = dropout
        self.n_conv = n_conv

    def forward(self, x: torch.Tensor, train: bool = True) -> torch.Tensor:
        p = self.leaves()
        x = x.to(self.dtype).permute(0, 3, 1, 2)           # NHWC -> NCHW
        i = 0
        for v in self.cfg:
            if v == "M":
                x = F.max_pool2d(x, 2, 2)
                continue
            x = self._conv(p, x, f"Conv_{i}", padding=1)
            x = F.relu(self._batch_norm(p, x, f"BatchNorm_{i}", train))
            i += 1
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)   # NHWC flatten
        x = F.relu(self._dense(p, x, "Dense_0", self.dtype))
        if train and self.dropout:
            x = self._dropout(x)
        return self._dense(p, x, "Dense_1", torch.float32)
