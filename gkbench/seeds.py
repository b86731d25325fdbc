"""Seeds the benchmark derives from a run's ``--seed``: one stream a
purpose (and rank), so the weights, the traffic and each worker's dropout
masks never share draws, and any whole number is a seed."""

from __future__ import annotations

import zlib

import numpy as np


def derive(seed: int, purpose: str, rank: int = 0) -> int:
    """A 63-bit seed for ``torch.Generator.manual_seed`` from ``(seed,
    purpose, rank)``."""
    words = [int(seed) & 0xFFFFFFFF, (int(seed) >> 32) & 0xFFFFFFFF,
             zlib.crc32(purpose.encode()), int(rank)]
    return int(np.random.SeedSequence(words).generate_state(
        1, np.uint64)[0] >> np.uint64(1))
