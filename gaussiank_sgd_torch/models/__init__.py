"""Model zoo (port of ``gaussiank_sgd_tpu/models``): ``get_model`` mirrors
the reference's ``--dnn`` dispatch. Ported: ``vgg16``, ``resnet20`` …
``resnet110``, ``resnet50``, ``lstm`` and ``transformer``; every other name
of the reference raises ``NotImplementedError`` naming its ROADMAP item."""

from __future__ import annotations

from typing import Any, NamedTuple, Optional, Tuple

import torch

from ..device import resolve_device
from .lstm import LSTMLM
from .resnet import CifarResNet, ResNet50
from .transformer import Transformer
from .vgg import VGG16


class ModelSpec(NamedTuple):
    name: str
    module: Any                       # nn.Module on its device
    input_shape: Tuple[int, ...]      # one example, NHWC or tokens (no
                                      # batch dim)
    # what the module takes, as the reference states it: f32 images
    # (uint8 ImageNet batches reach it through
    # training/losses.py:_prep_pixels) or int32 token ids
    input_dtype: torch.dtype
    num_classes: int                  # classes, or the vocabulary's size
    task: str                         # 'classify' | 'lm' | 'seq2seq'


_CIFAR = (32, 32, 3)
_IMAGENET = (224, 224, 3)

# reference names that wait for a later slice, with their ROADMAP item
_NOT_PORTED = {"mnistnet": 6, "mnist": 6, "alexnet": 6, "lstman4": 7,
               "transformer_lm": 7, "transformerlm": 7}


def get_model(dnn: str, dataset: Optional[str] = None, *,
              num_classes: Optional[int] = None,
              dtype: torch.dtype = torch.float32,
              device=None, seed: int = 0, **kw) -> ModelSpec:
    """Build ``dnn`` on ``device`` (cuda unless the caller asks for the
    CPU) with random weights drawn from ``seed``; ``**kw`` goes to the
    module (e.g. ``cfg``, ``dropout``, ``stage_sizes``). The CIFAR ResNets
    take their depth from the name and 100 classes on ``cifar100``; the
    language models take ``vocab_size`` (``num_classes`` is ignored), and
    the transformer ``seq_len`` for its spec's input shape."""
    dnn = dnn.lower()
    if dnn in _NOT_PORTED:
        raise NotImplementedError(
            f"model {dnn!r} is not ported yet (ROADMAP A item "
            f"{_NOT_PORTED[dnn]})")
    if dnn in ("lstm", "transformer"):
        vocab = kw.pop("vocab_size", 10000 if dnn == "lstm" else 32000)
        if dnn == "lstm":
            cls, shape, task = LSTMLM, (35,), "lm"
        else:
            cls, task = Transformer, "seq2seq"
            shape = (kw.pop("seq_len", 64),)
        module = cls(vocab_size=vocab, dtype=dtype,
                     device=resolve_device(device), **kw)
        module.reset_parameters(torch.Generator().manual_seed(seed))
        return ModelSpec(dnn, module, shape, torch.int32, vocab, task)
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
