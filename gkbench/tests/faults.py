"""Faults planted under the timed path, for the test that sees ``correct``
come out false: each breaks the program's train step the way a later
change might, and the check has to catch it. ``planted`` installs one on
rank 0's step as the harness builds it.

* ``unchanged``: the step returns its state unchanged (only the step
  counter advances);
* ``half_batch``: the loss and gradient over the first half of each
  worker's rows, the mean taken over them;
* ``no_exchange``: the worker's own payload stands in for what the
  all-gather brought, so it sees no other worker's pairs (the collective
  still runs, so the other ranks do not wait on it).
"""

from __future__ import annotations

import contextlib
from typing import Any, Callable, Dict

import torch

from gkbench import harness
from gkbench.layers import _method


def _unchanged(step: Any) -> None:
    def commit(state, *args, **kwargs):
        state.step += 1
    _method(step, "_commit")
    step._commit = commit


def _half_batch(step: Any) -> None:
    local_grads = _method(step, "local_grads")

    def half(state, batch):
        return local_grads(state, tuple(x[:x.shape[0] // 2] for x in batch))
    step.local_grads = half


class _OwnPayload:
    def __init__(self, mesh: Any):
        self._mesh = mesh

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        self._mesh.gather(x)
        return x.repeat(self._mesh.sizes[-1])

    def __getattr__(self, name: str):
        return getattr(self._mesh, name)


def _no_exchange(step: Any) -> None:
    _method(step.mesh, "gather")
    step.mesh = _OwnPayload(step.mesh)


PLANTS: Dict[str, Callable[[Any], None]] = {
    "unchanged": _unchanged, "half_batch": _half_batch,
    "no_exchange": _no_exchange}


@contextlib.contextmanager
def planted(monkeypatch, fault: str):
    """While open, every trainer the harness builds in this process gets
    ``fault`` on its step (ranks past 0 run in processes of their own and
    stay sound)."""
    build = harness.build

    def broken(*args, **kwargs):
        trainer, model, spans = build(*args, **kwargs)
        PLANTS[fault](trainer.ts)
        return trainer, model, spans
    with monkeypatch.context() as m:
        m.setattr(harness, "build", broken)
        yield
