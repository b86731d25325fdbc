"""The reference for ``"model": "vgg16"`` in a configuration's
``architecture``: plain VGG-16 with BatchNorm and the CIFAR head
(``models.vgg16_forward``), with dropout on the hidden dense layer."""

from __future__ import annotations

from typing import Dict

import torch

from . import models
from .sgd import Model


def build(arch: Dict) -> Model:
    """The model of ``arch``: ``num_classes``, ``image`` (HWC),
    ``dropout`` and, optionally, ``widths`` (the published ones by
    default)."""
    widths = arch.get("widths", models.VGG16_WIDTHS)
    dropout = arch["dropout"]

    def loss(p, x, y, gen, q):
        keep = (torch.rand((x.shape[0], models.VGG_HIDDEN), generator=gen,
                           device=x.device) < 1.0 - dropout
                if dropout else None)
        logits = models.vgg16_forward(p, x.float(), keep, 1.0 - dropout, q,
                                      widths)
        return models.cross_entropy(logits, y)
    return Model(models.flat_layout(models.vgg16_leaves(
        arch["num_classes"], arch["image"], widths)), loss)
