"""A cell's traffic: the parameters of its traffic file
(``traffic/<name>.json``) read by the generator the file names
(``"generator"``, found as ``generators/<generator>.py``), which makes a
pool of distinct global batches from the run's seed. The trainer is fed
the pool round and round (``cycle``).

A generator module gives ``make_pool(traffic, seed, device)`` (a list of
numpy ``(x, y)`` global batches whose rows split evenly over the
workers), ``input_spec(traffic, rows)`` (the shapes and dtypes of
``rows`` rows, for the FLOP count) and, where a configuration states
``data_files``, ``write_split_files(pool, rows, path)``.
"""

from __future__ import annotations

from pathlib import Path
from types import ModuleType
from typing import Dict, List, Optional

import torch

from . import manifest


def generator(traffic: Dict, base: Optional[Path] = None) -> ModuleType:
    """The generator module a traffic file names, under ``base`` (this
    benchmark's by default)."""
    return manifest.module("generators", traffic["generator"],
                           manifest.HERE if base is None else base)


def make_pool(traffic: Dict, seed: int, device: torch.device) -> List:
    return generator(traffic).make_pool(traffic, seed, device)


def cycle(pool: List):
    """The closed loop's feed: the pool's batches in order, round and
    round."""
    while True:
        yield from pool
