"""Elastic autoscaling training service (port of
``gaussiank_sgd_tpu/service``).

Built on the pod launcher's target-N reconcile loop: the
:class:`ElasticSupervisor` resize engine reacts to preemption drains,
relaunch-budget pressure, sustained critical health verdicts and
operator commands by re-meshing the job at a new width (checkpoint ->
teardown -> elastic restore -> resume) inside step and wall-clock
budgets; the :class:`JobScheduler` admits several jobs over one
:class:`DevicePool` with fair grants and per-job health routing.

Lazy exports (PEP 562), as in the reference: the supervisor and the
scheduler are pure stdlib plus the package's telemetry and import no
``torch``; only the spawned workers do.
"""

from typing import TYPE_CHECKING

if TYPE_CHECKING:            # static analyzers see the eager imports
    from .control import ControlPlane                      # noqa: F401
    from .resize import (ResizeDirective, ResizePlanner,   # noqa: F401
                         ResizePolicy)
    from .scheduler import (DevicePool, JobScheduler,      # noqa: F401
                            ServiceJob)
    from .supervisor import ElasticSupervisor              # noqa: F401

__all__ = ["ControlPlane", "DevicePool", "ElasticSupervisor",
           "JobScheduler", "ResizeDirective", "ResizePlanner",
           "ResizePolicy", "ServiceJob"]

_LAZY = {"ControlPlane": "control",
         "ResizeDirective": "resize", "ResizePlanner": "resize",
         "ResizePolicy": "resize",
         "DevicePool": "scheduler", "JobScheduler": "scheduler",
         "ServiceJob": "scheduler",
         "ElasticSupervisor": "supervisor"}


def __getattr__(name: str):
    target = _LAZY.get(name)
    if target is None:
        raise AttributeError(
            f"module {__name__!r} has no attribute {name!r}")
    import importlib
    return getattr(importlib.import_module(f".{target}", __name__), name)


def __dir__():
    return sorted(set(globals()) | set(__all__))
