"""GaussianK-SGD in PyTorch for one NVIDIA H100 — the port of
``gaussiank_sgd_tpu`` (JAX/Pallas), which stays beside it as the reference.

Modules mirror the reference's layout and names. Every Pallas kernel of
the reference is hand-written CUDA C++ here: the fused error-feedback
accumulate + threshold-select candidate extraction in
``csrc/fused_select.cu``, the threshold estimate's statistics and
multi-threshold counts in ``csrc/threshold_select.cu``. Every kernel
wrapper runs its plain PyTorch version only for tensors on the CPU.

Entry points (``training.trainer.Trainer``, ``train.py``) run on ``cuda``
unless the caller asks for the CPU; see :func:`device.resolve_device`.

Importing the package imports no ``torch``: the pod supervisor
(``training/launch.py``) and the telemetry CLI run without it, so
``resolve_device`` is loaded on first use.
"""

__all__ = ["resolve_device"]


def __getattr__(name):
    if name == "resolve_device":
        from .device import resolve_device
        return resolve_device
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
