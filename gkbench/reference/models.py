"""Plain VGG-16 (with BatchNorm, the CIFAR-10 head) and ResNet-50 (the
ImageNet model), in float32, for the benchmark's check of what the timed
path computed.

Written from the published architectures: VGG-16 (Simonyan and Zisserman,
arXiv:1409.1556) with a BatchNorm after each convolution and a CIFAR head
of one 512-wide hidden dense layer with dropout; ResNet-50 (He et al.,
arXiv:1512.03385) with bottleneck blocks, the stride on the 3x3
convolution and a projection shortcut where the stride or the width
changes. Parameters are named leaves (``Conv_0/kernel``, HWIO; dense
kernels ``[in, out]``), laid out in one flat vector sorted by their path
components, level by level (``flat_layout``). The benchmark hands the same
flat vector of weights to the program, after checking that the program
lays its parameters out the same way.

BatchNorm normalises with the batch statistics of the worker's rows (the
training forward), with eps 1e-5. ``q`` rounds the operands and the
outputs of every convolution and of the hidden dense layer, the tensors
the configuration computes in bfloat16: the identity for the float32
reference, a lower precision for the control (``lowp.py``). Nothing here
imports the program.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

Shape = Tuple[int, ...]
Layout = List[Tuple[str, Shape]]
Round = Callable[[torch.Tensor], torch.Tensor]

BN_EPS = 1e-5
# the published VGG-16 convolution widths; "M" is a 2x2 max-pool
VGG16_WIDTHS = (64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
                512, 512, 512, "M", 512, 512, 512, "M")
VGG_HIDDEN = 512
RESNET50_STAGES = (3, 4, 6, 3)
RESNET_WIDTHS = (64, 128, 256, 512)
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def _identity(x: torch.Tensor) -> torch.Tensor:
    return x


def _conv(leaves: Dict[str, Shape], name: str, k: int, cin: int,
          cout: int) -> None:
    leaves[f"{name}/kernel"] = (k, k, cin, cout)


def _bn(leaves: Dict[str, Shape], name: str, c: int) -> None:
    leaves[f"{name}/scale"] = (c,)
    leaves[f"{name}/bias"] = (c,)


def _dense(leaves: Dict[str, Shape], name: str, cin: int, cout: int) -> None:
    leaves[f"{name}/kernel"] = (cin, cout)
    leaves[f"{name}/bias"] = (cout,)


def vgg16_leaves(num_classes: int = 10,
                 image: Sequence[int] = (32, 32, 3),
                 widths: Sequence = VGG16_WIDTHS) -> Dict[str, Shape]:
    h, w, cin = image
    leaves: Dict[str, Shape] = {}
    i = 0
    for v in widths:
        if v == "M":
            h, w = h // 2, w // 2
            continue
        _conv(leaves, f"Conv_{i}", 3, cin, v)
        _bn(leaves, f"BatchNorm_{i}", v)
        cin, i = v, i + 1
    _dense(leaves, "Dense_0", h * w * cin, VGG_HIDDEN)
    _dense(leaves, "Dense_1", VGG_HIDDEN, num_classes)
    return leaves


def _resnet_blocks(stages: Sequence[int]):
    """(name, width, stride, projection, input width) of each bottleneck
    block."""
    blocks, cin = [], RESNET_WIDTHS[0]
    for i, (n, width) in enumerate(zip(stages, RESNET_WIDTHS)):
        for b in range(n):
            stride = 2 if i > 0 and b == 0 else 1
            blocks.append((f"BottleneckBlock_{len(blocks)}", width, stride,
                           stride != 1 or cin != 4 * width, cin))
            cin = 4 * width
    return blocks


def resnet50_leaves(num_classes: int = 1000,
                    stages: Sequence[int] = RESNET50_STAGES
                    ) -> Dict[str, Shape]:
    leaves: Dict[str, Shape] = {}
    _conv(leaves, "Conv_0", 7, 3, RESNET_WIDTHS[0])
    _bn(leaves, "BatchNorm_0", RESNET_WIDTHS[0])
    for name, width, _, project, cin in _resnet_blocks(stages):
        _conv(leaves, f"{name}/Conv_0", 1, cin, width)
        _bn(leaves, f"{name}/BatchNorm_0", width)
        _conv(leaves, f"{name}/Conv_1", 3, width, width)
        _bn(leaves, f"{name}/BatchNorm_1", width)
        _conv(leaves, f"{name}/Conv_2", 1, width, 4 * width)
        _bn(leaves, f"{name}/BatchNorm_2", 4 * width)
        if project:
            _conv(leaves, f"{name}/Conv_3", 1, cin, 4 * width)
            _bn(leaves, f"{name}/BatchNorm_3", 4 * width)
    _dense(leaves, "Dense_0", 4 * RESNET_WIDTHS[len(stages) - 1],
           num_classes)
    return leaves


def flat_layout(leaves: Dict[str, Shape]) -> Layout:
    """``(path, shape)`` sorted by the path's ``/``-separated components,
    compared as strings level by level (``BottleneckBlock_10`` before
    ``BottleneckBlock_2``)."""
    return [(p, tuple(leaves[p]))
            for p in sorted(leaves, key=lambda p: tuple(p.split("/")))]


def numel(layout: Layout) -> int:
    return sum(math.prod(s) for _, s in layout)


def split_flat(flat: torch.Tensor, layout: Layout) -> Dict[str, torch.Tensor]:
    """Each leaf as a view of ``flat`` (whose first ``numel(layout)``
    entries are the parameters)."""
    sizes = [math.prod(s) for _, s in layout]
    parts = torch.split(flat[:sum(sizes)], sizes)
    return {p: t.view(s) for (p, s), t in zip(layout, parts)}


def _bn_train(x: torch.Tensor, p: Dict[str, torch.Tensor],
              name: str) -> torch.Tensor:
    return F.batch_norm(x.float(), None, None, p[f"{name}/scale"],
                        p[f"{name}/bias"], training=True, eps=BN_EPS)


def _conv2d(x: torch.Tensor, kernel: torch.Tensor, q: Round,
            stride: int = 1, padding: int = 0) -> torch.Tensor:
    return q(F.conv2d(q(x), q(kernel).permute(3, 2, 0, 1), stride=stride,
                      padding=padding))


def vgg16_forward(p: Dict[str, torch.Tensor], x: torch.Tensor,
                  keep: Optional[torch.Tensor], keep_prob: float,
                  q: Round = _identity,
                  widths: Sequence = VGG16_WIDTHS) -> torch.Tensor:
    """Logits ``[N, classes]`` of NHWC float32 images. ``keep`` is the
    dropout mask of the hidden dense layer's output ``[N, 512]`` (kept
    entries scaled by ``1 / keep_prob``); None for no dropout."""
    h = x.permute(0, 3, 1, 2)
    i = 0
    for v in widths:
        if v == "M":
            h = F.max_pool2d(h, 2, 2)
            continue
        h = F.relu(_bn_train(_conv2d(h, p[f"Conv_{i}/kernel"], q,
                                     padding=1), p, f"BatchNorm_{i}"))
        i += 1
    h = h.permute(0, 2, 3, 1).reshape(h.shape[0], -1)
    h = F.relu(q(q(h) @ q(p["Dense_0/kernel"]) + p["Dense_0/bias"]))
    if keep is not None:
        h = torch.where(keep, h / keep_prob, 0.0)
    return h.float() @ p["Dense_1/kernel"] + p["Dense_1/bias"]


def imagenet_pixels(x_u8: torch.Tensor) -> torch.Tensor:
    """uint8 NHWC pixels -> ``(x / 255 - mean) / std`` in float32."""
    mean = torch.tensor(IMAGENET_MEAN, device=x_u8.device)
    std = torch.tensor(IMAGENET_STD, device=x_u8.device)
    return (x_u8.float() / 255.0 - mean) / std


def resnet50_forward(p: Dict[str, torch.Tensor], x: torch.Tensor,
                     q: Round = _identity,
                     stages: Sequence[int] = RESNET50_STAGES
                     ) -> torch.Tensor:
    """Logits ``[N, classes]`` of NHWC float32 (normalised) images."""
    h = x.permute(0, 3, 1, 2)
    h = F.relu(_bn_train(_conv2d(h, p["Conv_0/kernel"], q, 2, 3), p,
                         "BatchNorm_0"))
    h = F.max_pool2d(h, 3, 2, 1)
    for name, _, stride, project, _ in _resnet_blocks(stages):
        y = F.relu(_bn_train(_conv2d(h, p[f"{name}/Conv_0/kernel"], q), p,
                             f"{name}/BatchNorm_0"))
        y = F.relu(_bn_train(_conv2d(y, p[f"{name}/Conv_1/kernel"], q,
                                     stride, 1), p, f"{name}/BatchNorm_1"))
        y = _bn_train(_conv2d(y, p[f"{name}/Conv_2/kernel"], q), p,
                      f"{name}/BatchNorm_2")
        if project:
            h = _bn_train(_conv2d(h, p[f"{name}/Conv_3/kernel"], q, stride),
                          p, f"{name}/BatchNorm_3")
        h = F.relu(y + h)
    return h.mean(dim=(2, 3)) @ p["Dense_0/kernel"] + p["Dense_0/bias"]


def cross_entropy(logits: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Mean over the rows of ``logsumexp(logits) - logits[label]``."""
    picked = logits.gather(-1, y.long().unsqueeze(-1)).squeeze(-1)
    return (torch.logsumexp(logits, dim=-1) - picked).mean()
