"""RandomK and RandomKEC: k uniformly random indices (port of
``gaussiank_sgd_tpu/compressors/randomk.py``).

The draw and the compress are separate. ``random_indices`` draws k distinct
indices from a ``torch.Generator``: one uniform 63-bit integer key per
element and a top-k over the keys (sampling without replacement; integer
keys leave no float ties to break). ``randomk_compress`` and
``randomkec_compress`` take the indices the draw gave. The reference draws
from JAX's PRNG, which torch cannot reproduce, so the two packages agree on
the compress given the same indices and on the draw's distribution only.

Every worker must draw the same indices, as the reference's shared
compressor key makes them: ``comp_generator`` derives the stream from the
run's seed, the step and the bucket alone, so the ranks agree bit for bit
and a resumed run draws what the uninterrupted one would, with no saved
state. ``decorrelate_comp_rng`` folds the rank in, so every worker draws its
own.

``randomk`` discards the mass it does not send (a zero residual);
``randomkec`` keeps it in the EF residual.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .base import CompressedGrad, CompressResult

_KEY_HIGH = 2 ** 63 - 1


def comp_generator(seed: int, step: int, bucket: int,
                   device: torch.device,
                   rank: Optional[int] = None) -> torch.Generator:
    """The compressor's generator for one bucket of one step, seeded from
    ``(seed, step, 1, [rank,] bucket)`` (1 separates it from the dropout
    stream; ``rank`` only under ``decorrelate_comp_rng``)."""
    words = [seed, step, 1] + ([] if rank is None else [rank]) + [bucket]
    state = np.random.SeedSequence(words).generate_state(1, np.uint64)[0]
    return torch.Generator(device).manual_seed(int(state >> np.uint64(1)))


def random_indices(n: int, k: int, generator: torch.Generator
                   ) -> torch.Tensor:
    """k distinct int32 indices in ``[0, n)``, uniformly at random: the k
    largest of n independent uniform integer keys."""
    keys = torch.randint(0, _KEY_HIGH, (n,), dtype=torch.int64,
                         generator=generator, device=generator.device)
    return torch.topk(keys, k).indices.to(torch.int32)


def randomk_compress_at(acc: torch.Tensor, idx: torch.Tensor
                        ) -> CompressResult:
    """RandomK on the given distinct indices: send ``acc[idx]``; the rest
    is discarded (the residual is zero)."""
    return CompressResult(CompressedGrad(idx, acc[idx.long()]),
                          torch.zeros_like(acc), _count(idx))


def randomkec_compress_at(acc: torch.Tensor, idx: torch.Tensor
                          ) -> CompressResult:
    """RandomKEC on the given distinct indices: send ``acc[idx]``; the
    rest stays in the residual (``acc`` with the sent entries zeroed; the
    input is not modified)."""
    residual = acc.clone()
    residual[idx.long()] = 0.0
    return CompressResult(CompressedGrad(idx, acc[idx.long()]), residual,
                          _count(idx))


def _count(idx: torch.Tensor) -> torch.Tensor:
    """The count as an i32 scalar on ``idx``'s device, by a fill: a
    ``torch.tensor`` there would be a host-to-device copy that waits for
    the queued kernels."""
    return torch.full((), idx.shape[0], dtype=torch.int32,
                      device=idx.device)


def randomk_compress(acc: torch.Tensor, k: int,
                     generator: torch.Generator) -> CompressResult:
    """RandomK without error compensation: k random entries, the residual
    zero."""
    return randomk_compress_at(acc, random_indices(acc.shape[0], k,
                                                   generator))


def randomkec_compress(acc: torch.Tensor, k: int,
                       generator: torch.Generator) -> CompressResult:
    """RandomK with error compensation: k random entries; what is not sent
    stays in the residual."""
    return randomkec_compress_at(acc, random_indices(acc.shape[0], k,
                                                     generator))
