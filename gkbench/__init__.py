"""The benchmark of the PyTorch/CUDA port ``gaussiank_sgd_torch``: see
``run.py`` and ``BENCHMARK.json`` at the root of the repository."""
