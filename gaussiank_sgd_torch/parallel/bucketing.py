"""Static gradient bucketing over the flat parameter space (port of
``gaussiank_sgd_tpu/parallel/bucketing.py``).

Buckets are static ``(offset, size, k)`` slices of the flat gradient, whose
order is the reference's ``ravel_pytree`` order: dict keys sorted as
strings (``BatchNorm_0, BatchNorm_1, BatchNorm_10, ..., Conv_0, ...``), each
leaf flattened in flax's layout. A model of the port exposes that order as
its ``param_layout``.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Sequence, Tuple

from ..compressors.base import k_for


class Bucket(NamedTuple):
    offset: int  # start into the flat gradient buffer
    size: int    # number of elements
    k: int       # packed slots selected from this bucket


class BucketPlan(NamedTuple):
    """A static partition of the flat gradient into compression units;
    ``uniform`` when every bucket has the same size and k."""

    buckets: Tuple[Bucket, ...]
    total_numel: int
    uniform: bool = False

    @property
    def total_k(self) -> int:
        return sum(b.k for b in self.buckets)


def leaf_sizes(layout: Sequence[Tuple[str, Tuple[int, ...]]]) -> list:
    """Numels of the parameter leaves of a ``(path, shape)`` layout, in the
    layout's (flax ravel) order."""
    return [math.prod(shape) for _, shape in layout]


def make_bucket_plan(sizes: Sequence[int], density: float,
                     bucket_size: Optional[int] = None,
                     min_k: int = 1, policy: str = "greedy") -> BucketPlan:
    """Partition tensors (``sizes``, in flat order) into buckets with
    ``k = max(min_k, ceil(density * bucket_numel))``.

    ``bucket_size=None`` is one whole-model bucket; ``0`` one bucket per
    tensor; ``B`` a greedy merge until a bucket holds >= B elements;
    ``policy="uniform"`` equal ``B``-element chunks ignoring boundaries."""
    sizes = [int(s) for s in sizes]
    total = sum(sizes)
    if total == 0:
        raise ValueError("empty parameter layout")

    if policy == "uniform":
        if not bucket_size or bucket_size <= 0:
            raise ValueError("policy='uniform' needs bucket_size > 0")
        chunk = min(int(bucket_size), total)
        n_chunks = -(-total // chunk)
        k = max(min_k, k_for(chunk, density))
        buckets = tuple(Bucket(i * chunk, chunk, k) for i in range(n_chunks))
        return BucketPlan(buckets, total, uniform=True)
    if policy != "greedy":
        raise ValueError(f"unknown bucket policy {policy!r}")

    if bucket_size is None:
        groups = [total]
    elif bucket_size == 0:
        groups = list(sizes)
    else:
        groups, cur = [], 0
        for s in sizes:
            cur += s
            if cur >= bucket_size:
                groups.append(cur)
                cur = 0
        if cur:
            groups.append(cur)

    buckets, off = [], 0
    for g in groups:
        buckets.append(Bucket(off, g, max(min_k, k_for(g, density))))
        off += g
    uniform = len({(b.size, b.k) for b in buckets}) == 1
    return BucketPlan(tuple(buckets), total, uniform=uniform)


def plan_for_params(layout: Sequence[Tuple[str, Tuple[int, ...]]],
                    density: float, bucket_size: Optional[int] = None,
                    policy: str = "greedy") -> BucketPlan:
    """The bucket plan of a model's ``param_layout`` (by default one
    whole-model bucket; see :func:`make_bucket_plan`)."""
    return make_bucket_plan(leaf_sizes(layout), density, bucket_size,
                            policy=policy)
