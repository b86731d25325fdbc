"""Model zoo (port of ``gaussiank_sgd_tpu/models``): ``get_model`` mirrors
the reference's ``--dnn`` dispatch. Ported: ``vgg16``, ``resnet20`` …
``resnet110`` and ``resnet50``; every other name of the reference raises
``NotImplementedError`` naming its ROADMAP item."""

from __future__ import annotations

from typing import Any, NamedTuple, Optional, Tuple

import torch

from ..device import resolve_device
from .resnet import CifarResNet, ResNet50
from .vgg import VGG16


class ModelSpec(NamedTuple):
    name: str
    module: Any                       # nn.Module on its device
    input_shape: Tuple[int, ...]      # one example, NHWC (no batch dim)
    # what the module takes: f32 (uint8 ImageNet batches reach it through
    # training/losses.py:_prep_pixels), as the reference states it
    input_dtype: torch.dtype
    num_classes: int
    task: str                         # 'classify'


_CIFAR = (32, 32, 3)
_IMAGENET = (224, 224, 3)

_NOT_PORTED = {"mnistnet": "A7", "mnist": "A7", "alexnet": "A11",
               "lstm": "A11", "lstman4": "A11", "transformer": "A11",
               "transformer_lm": "A11", "transformerlm": "A11"}


def get_model(dnn: str, dataset: Optional[str] = None, *,
              num_classes: Optional[int] = None,
              dtype: torch.dtype = torch.float32,
              device=None, seed: int = 0, **kw) -> ModelSpec:
    """Build ``dnn`` on ``device`` (cuda unless the caller asks for the
    CPU) with random weights drawn from ``seed``; ``**kw`` goes to the
    module (e.g. ``cfg``, ``dropout``, ``stage_sizes``). The CIFAR ResNets
    take their depth from the name and 100 classes on ``cifar100``."""
    dnn = dnn.lower()
    if dnn in _NOT_PORTED:
        raise NotImplementedError(
            f"model {dnn!r} is not ported yet (ROADMAP {_NOT_PORTED[dnn]})")
    if dnn.startswith("resnet") and dnn != "resnet50":
        nc = num_classes or (100 if dataset == "cifar100" else 10)
        kw.setdefault("depth", int(dnn[len("resnet"):]))
        cls, shape = CifarResNet, _CIFAR
    elif dnn == "resnet50":
        nc, cls, shape = num_classes or 1000, ResNet50, _IMAGENET
    elif dnn == "vgg16":
        nc, cls, shape = num_classes or 10, VGG16, _CIFAR
        kw.setdefault("input_shape", _CIFAR)
    else:
        raise ValueError(f"unknown dnn {dnn!r}")
    module = cls(num_classes=nc, dtype=dtype, device=resolve_device(device),
                 **kw)
    module.reset_parameters(torch.Generator().manual_seed(seed))
    return ModelSpec(dnn, module, shape, torch.float32, nc, "classify")
