"""Model zoo (port of ``gaussiank_sgd_tpu/models``): ``get_model`` mirrors
the reference's ``--dnn`` dispatch. Ported: ``vgg16``, ``resnet20`` …
``resnet110``, ``resnet50``, ``alexnet``, ``mnistnet`` (``mnist``),
``lstm``, ``lstman4``, ``transformer`` and ``transformer_lm``
(``transformerlm``)."""

from __future__ import annotations

from typing import Any, NamedTuple, Optional, Tuple

import torch

from ..device import resolve_device
from .alexnet import AlexNet
from .lstm import LSTMLM
from .mnistnet import MnistNet
from .resnet import CifarResNet, ResNet50
from .speech import LSTMAN4
from .transformer import Transformer
from .transformer_lm import TransformerLM
from .vgg import VGG16


class ModelSpec(NamedTuple):
    name: str
    module: Any                       # nn.Module on its device
    input_shape: Tuple[int, ...]      # one example, NHWC, tokens or a
                                      # [freq, time] spectrogram (no
                                      # batch dim)
    # what the module takes, as the reference states it: f32 images
    # (uint8 ImageNet batches reach it through
    # training/losses.py:_prep_pixels) or int32 token ids
    input_dtype: torch.dtype
    num_classes: int                  # classes, the vocabulary's size, or
                                      # the CTC labels (blank included)
    task: str                         # 'classify' | 'lm' | 'ctc' |
                                      # 'seq2seq'


_CIFAR = (32, 32, 3)
_IMAGENET = (224, 224, 3)
_MNIST = (28, 28, 1)


def get_model(dnn: str, dataset: Optional[str] = None, *,
              num_classes: Optional[int] = None,
              dtype: torch.dtype = torch.float32,
              device=None, seed: int = 0, **kw) -> ModelSpec:
    """Build ``dnn`` on ``device`` (cuda unless the caller asks for the
    CPU) with random weights drawn from ``seed``; ``**kw`` goes to the
    module (e.g. ``cfg``, ``dropout``, ``stage_sizes``). The CIFAR ResNets
    take their depth from the name and 100 classes on ``cifar100``; the
    language models take ``vocab_size`` (``num_classes`` is ignored), and
    the transformers ``seq_len`` for their spec's input shape
    (``transformer_lm``'s ``sp_group`` is the process group of its ring,
    none for local attention); ``lstman4``
    takes ``num_labels`` (else ``num_classes``, else 29: the CTC blank and
    28 characters) and
    ``freq`` (161 bins) for its ``[freq, 200]`` input."""
    dnn = dnn.lower()
    if dnn == "transformerlm":
        dnn = "transformer_lm"
    if dnn in ("lstm", "transformer", "transformer_lm"):
        vocab = kw.pop("vocab_size", 10000 if dnn == "lstm" else 32000)
        if dnn == "lstm":
            cls, shape, task = LSTMLM, (35,), "lm"
        elif dnn == "transformer":
            cls, task = Transformer, "seq2seq"
            shape = (kw.pop("seq_len", 64),)
        else:
            cls, task = TransformerLM, "lm"
            shape = (kw.pop("seq_len", 256),)
        module = cls(vocab_size=vocab, dtype=dtype,
                     device=resolve_device(device), **kw)
        module.reset_parameters(torch.Generator().manual_seed(seed))
        return ModelSpec(dnn, module, shape, torch.int32, vocab, task)
    if dnn == "lstman4":
        labels = kw.pop("num_labels", num_classes or 29)
        module = LSTMAN4(num_labels=labels, dtype=dtype,
                         device=resolve_device(device), **kw)
        module.reset_parameters(torch.Generator().manual_seed(seed))
        return ModelSpec(dnn, module, (module.freq, 200), torch.float32,
                         labels, "ctc")
    if dnn.startswith("resnet") and dnn != "resnet50":
        nc = num_classes or (100 if dataset == "cifar100" else 10)
        kw.setdefault("depth", int(dnn[len("resnet"):]))
        cls, shape = CifarResNet, _CIFAR
    elif dnn == "resnet50":
        nc, cls, shape = num_classes or 1000, ResNet50, _IMAGENET
    elif dnn == "vgg16":
        nc, cls, shape = num_classes or 10, VGG16, _CIFAR
        kw.setdefault("input_shape", _CIFAR)
    elif dnn == "alexnet":
        nc, cls, shape = num_classes or 10, AlexNet, _CIFAR
    elif dnn in ("mnistnet", "mnist"):
        dnn, nc, cls, shape = "mnistnet", num_classes or 10, MnistNet, _MNIST
    else:
        raise ValueError(f"unknown dnn {dnn!r}")
    module = cls(num_classes=nc, dtype=dtype, device=resolve_device(device),
                 **kw)
    module.reset_parameters(torch.Generator().manual_seed(seed))
    return ModelSpec(dnn, module, shape, torch.float32, nc, "classify")
