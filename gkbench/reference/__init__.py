"""The plain float32 reference of the benchmark's check: models and the
first steps of data-parallel GaussianK SGD, in plain PyTorch. It imports
nothing of the program.

A configuration's ``architecture.model`` names the module here that
builds its reference (``reference/<model>.py``, whose ``build(arch)``
returns an ``sgd.Model``): a new model family adds a file."""

from __future__ import annotations

from pathlib import Path
from typing import Dict, Optional

SHARED = ("lowp", "models", "sgd")


def build(arch: Dict, base: Optional[Path] = None):
    """The reference model of a configuration's ``architecture``, from
    ``reference/<model>.py`` under ``base`` (this benchmark's by
    default)."""
    from ..manifest import HERE, module
    if arch["model"] in SHARED:
        raise ValueError(f"{arch['model']!r} is no model")
    return module("reference", arch["model"],
                  HERE if base is None else base).build(arch)
