"""The benchmark's own CPU tests: ``python -m pytest gkbench/tests`` from
the root of the repository. Tests that need a card carry the ``cuda``
marker and skip without one (decided inside the test)."""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA device; skips without one")
