"""ResNets (port of ``gaussiank_sgd_tpu/models/resnet.py``): the CIFAR
ResNet-{20,32,44,56,110} and the ImageNet ResNet-50, on the flat parameter
of ``models/flat.py``.

Leaves are named as flax names them: ``Conv_i`` and ``BatchNorm_i`` count
per type inside each block (``BasicBlock_j``, ``BottleneckBlock_j``) and at
the top level. With a bf16 compute dtype every conv casts its input and
kernel to bf16, every BatchNorm computes in f32, so the residual stream is
f32 after the stem, ``y + x`` adds in f32, and the global mean pool and
``Dense_0`` run in f32. The public input is NHWC, as in the reference.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from .flat import FlatModel, Shape, add_batch_norm, add_conv, add_dense


class CifarResNet(FlatModel):
    """depth = 6n+2: three stages of n basic blocks at widths 16/32/64 with
    option-A shortcuts (subsample, zero-pad channels; no parameters).
    ``forward(x [N, H, W, C], train)`` -> f32 logits ``[N, classes]``."""

    def __init__(self, depth: int = 20, num_classes: int = 10,
                 dtype: torch.dtype = torch.float32,
                 device: Optional[torch.device] = None):
        if depth < 8 or (depth - 2) % 6:
            raise ValueError(f"bad CIFAR resnet depth {depth}: want 6n+2")
        params: Dict[str, Shape] = {}
        stats: Dict[str, Shape] = {}
        add_conv(params, "Conv_0", 3, 3, 16)
        add_batch_norm(params, stats, "BatchNorm_0", 16)
        # (name, in width, out width, stride) of each block
        self.blocks: List[Tuple[str, int, int, int]] = []
        cin = 16
        for i, filters in enumerate((16, 32, 64)):
            for b in range((depth - 2) // 6):
                name = f"BasicBlock_{len(self.blocks)}"
                add_conv(params, f"{name}/Conv_0", 3, cin, filters)
                add_batch_norm(params, stats, f"{name}/BatchNorm_0", filters)
                add_conv(params, f"{name}/Conv_1", 3, filters, filters)
                add_batch_norm(params, stats, f"{name}/BatchNorm_1", filters)
                self.blocks.append((name, cin, filters,
                                    2 if i > 0 and b == 0 else 1))
                cin = filters
        add_dense(params, "Dense_0", cin, num_classes)
        super().__init__(params, stats, dtype, device)
        self.depth = depth
        self.num_classes = num_classes

    def forward(self, x: torch.Tensor, train: bool = True) -> torch.Tensor:
        p = self.leaves()
        x = x.permute(0, 3, 1, 2)                          # NHWC -> NCHW
        x = F.relu(self._batch_norm(p, self._conv(p, x, "Conv_0", 1, 1),
                                    "BatchNorm_0", train))
        for name, cin, filters, stride in self.blocks:
            y = self._conv(p, x, f"{name}/Conv_0", stride, 1)
            y = F.relu(self._batch_norm(p, y, f"{name}/BatchNorm_0", train))
            y = self._conv(p, y, f"{name}/Conv_1", 1, 1)
            y = self._batch_norm(p, y, f"{name}/BatchNorm_1", train)
            if stride != 1 or cin != filters:
                # option A: subsample, then zero channels at the end
                x = F.pad(x[:, :, ::stride, ::stride],
                          (0, 0, 0, 0, 0, filters - cin))
            x = F.relu(y + x)
        return self._dense(p, x.mean(dim=(2, 3)), "Dense_0", torch.float32)


class ResNet50(FlatModel):
    """ImageNet ResNet-50: a 7x7/2 stem and 3x3/2 max-pool, then bottleneck
    blocks (1x1, 3x3 carrying the stride, 1x1 to 4x the width) with a
    projection shortcut (``Conv_3``/``BatchNorm_3``) where the stride or
    the width changes; each block's last BatchNorm scale starts at zero.
    ``stage_sizes`` blocks per stage at widths 64/128/256/512."""

    def __init__(self, num_classes: int = 1000,
                 dtype: torch.dtype = torch.float32,
                 stage_sizes: Sequence[int] = (3, 4, 6, 3),
                 device: Optional[torch.device] = None):
        params: Dict[str, Shape] = {}
        stats: Dict[str, Shape] = {}
        fill: Dict[str, float] = {}
        add_conv(params, "Conv_0", 7, 3, 64)
        add_batch_norm(params, stats, "BatchNorm_0", 64)
        # (name, width, stride, projection) of each block
        self.blocks: List[Tuple[str, int, int, bool]] = []
        cin = 64
        for i, (n_blocks, filters) in enumerate(
                zip(stage_sizes, (64, 128, 256, 512))):
            for b in range(n_blocks):
                name = f"BottleneckBlock_{len(self.blocks)}"
                stride, out = (2 if i > 0 and b == 0 else 1), 4 * filters
                add_conv(params, f"{name}/Conv_0", 1, cin, filters)
                add_batch_norm(params, stats, f"{name}/BatchNorm_0", filters)
                add_conv(params, f"{name}/Conv_1", 3, filters, filters)
                add_batch_norm(params, stats, f"{name}/BatchNorm_1", filters)
                add_conv(params, f"{name}/Conv_2", 1, filters, out)
                add_batch_norm(params, stats, f"{name}/BatchNorm_2", out)
                fill[f"{name}/BatchNorm_2/scale"] = 0.0
                project = stride != 1 or cin != out
                if project:
                    add_conv(params, f"{name}/Conv_3", 1, cin, out)
                    add_batch_norm(params, stats, f"{name}/BatchNorm_3", out)
                self.blocks.append((name, filters, stride, project))
                cin = out
        add_dense(params, "Dense_0", cin, num_classes)
        super().__init__(params, stats, dtype, device, fill=fill)
        self.num_classes = num_classes
        self.stage_sizes = tuple(stage_sizes)

    def forward(self, x: torch.Tensor, train: bool = True) -> torch.Tensor:
        p = self.leaves()

        def conv_bn(h, name, i, stride=1, padding=0):
            h = self._conv(p, h, f"{name}Conv_{i}", stride, padding)
            return self._batch_norm(p, h, f"{name}BatchNorm_{i}", train)

        x = x.permute(0, 3, 1, 2)                          # NHWC -> NCHW
        x = F.relu(conv_bn(x, "", 0, 2, 3))
        x = F.max_pool2d(x, 3, 2, 1)                       # pads with -inf
        for name, _, stride, project in self.blocks:
            y = F.relu(conv_bn(x, f"{name}/", 0))
            y = F.relu(conv_bn(y, f"{name}/", 1, stride, 1))
            y = conv_bn(y, f"{name}/", 2)
            if project:
                x = conv_bn(x, f"{name}/", 3, stride)
            x = F.relu(y + x)
        return self._dense(p, x.mean(dim=(2, 3)), "Dense_0", torch.float32)
