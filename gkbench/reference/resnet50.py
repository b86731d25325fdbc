"""The reference for ``"model": "resnet50"`` in a configuration's
``architecture``: plain ResNet-50 (``models.resnet50_forward``) on uint8
ImageNet pixels, normalised as the ImageNet pipeline normalises them."""

from __future__ import annotations

from typing import Dict

from . import models
from .sgd import Model


def build(arch: Dict) -> Model:
    """The model of ``arch``: ``num_classes`` and, optionally, ``stages``
    (the published (3, 4, 6, 3) by default)."""
    stages = arch.get("stages", models.RESNET50_STAGES)

    def loss(p, x, y, gen, q):
        logits = models.resnet50_forward(p, models.imagenet_pixels(x), q,
                                         stages)
        return models.cross_entropy(logits, y)
    return Model(models.flat_layout(models.resnet50_leaves(
        arch["num_classes"], stages)), loss)
