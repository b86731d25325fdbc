"""The layer ranges of the traced run: ``record_function`` ranges around
the calls into each layer, put on the train step's instance by wrapping
its methods (the program itself is not edited).

A wrapper that finds its method gone raises: a layer the benchmark cannot
see must fail the run, not read as zero.
"""

from __future__ import annotations

import functools
from typing import Any

import torch

WINDOW = "gk.window"
FWD_BWD = "gk.fwd_bwd"
COMPRESS = "gk.compress"
EXCHANGE = "gk.exchange"
UPDATE = "gk.update"
RANGES = (FWD_BWD, COMPRESS, EXCHANGE, UPDATE)

# (method of DPTrainStep, range)
STEP_METHODS = (("local_grads", FWD_BWD), ("pack_phase", COMPRESS),
                ("_apply_pairs", UPDATE), ("_commit", UPDATE))


def _method(obj: Any, name: str):
    if not callable(getattr(type(obj), name, None)):
        raise RuntimeError(
            f"{type(obj).__name__}.{name} is gone: the benchmark's layer "
            f"range around it has nothing to wrap")
    return getattr(obj, name)


def _ranged(fn, label: str):
    @functools.wraps(fn)
    def call(*args, **kwargs):
        with torch.profiler.record_function(label):
            return fn(*args, **kwargs)
    return call


class _MeshRanges:
    """The step's mesh with ``gather`` inside the exchange range; every
    other attribute is the mesh's own."""

    def __init__(self, mesh: Any):
        self._gather = _ranged(_method(mesh, "gather"), EXCHANGE)
        self._mesh = mesh

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        return self._gather(x)

    def __getattr__(self, name: str):
        return getattr(self._mesh, name)


def install(step: Any) -> None:
    """Put the layer ranges on ``step`` (a ``DPTrainStep``)."""
    for name, label in STEP_METHODS:
        setattr(step, name, _ranged(_method(step, name), label))
    step.mesh = _MeshRanges(step.mesh)
