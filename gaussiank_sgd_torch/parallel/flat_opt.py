"""Flat sparse-aware SGD (+momentum, +weight decay) — port of
``gaussiank_sgd_tpu/parallel/flat_opt.py``.

The gathered ``(index, value)`` pairs are scatter-added straight into the
decayed momentum, so no dense gradient buffer exists on the sparse path::

    m' = mu * m (+ wd * p)      # dense half
    m'[idx] += val              # k-sized scatter-add
    p  = p - lr(step) * m'

The warm-up (dense) path uses the same state and rule with ``+ g_dense``.
Every operation rounds to f32 on its own (no fused multiply-add), in this
order, on the CPU and on the card alike.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Union

import numpy as np
import torch

from ..compressors.base import scatter_add_ordered


class FlatSGDM(NamedTuple):
    """Config of the flat sparse-aware SGD update."""

    lr: Union[float, Callable[[int], float]]   # value or step -> lr
    momentum: float = 0.0
    weight_decay: float = 0.0

    def lr_at(self, step: int) -> float:
        """The learning rate at ``step``, rounded to f32."""
        lr = self.lr(step) if callable(self.lr) else self.lr
        return float(np.float32(lr))

    def init(self, n: int, dtype=torch.float32, device=None) -> dict:
        """Optimizer state: one flat momentum buffer."""
        return {"m": torch.zeros(n, dtype=dtype, device=device)}

    def decay(self, m: torch.Tensor,
              flat_params: Optional[torch.Tensor]) -> torch.Tensor:
        """The dense half of the update: mu*m (+ wd*p), as a new tensor."""
        m = m * self.momentum if self.momentum else torch.zeros_like(m)
        if self.weight_decay:
            if flat_params is None:
                raise ValueError("weight decay needs the flat params")
            m = m + flat_params.to(m.dtype) * self.weight_decay
        return m

    def sparse_step(self, m: torch.Tensor, idx: torch.Tensor,
                    val: torch.Tensor, flat_params: Optional[torch.Tensor],
                    step: int, rounds: Optional[int] = None) -> tuple:
        """``(flat_updates, m')`` from gathered pairs whose values already
        carry the 1/P average, added in the buffer's order (duplicates from
        several workers sum as the reference's CPU scatter sums them; see
        ``scatter_add_ordered`` for ``rounds``). Indices outside ``[0, n)``
        are dropped; padding slots ``(0, 0.0)`` add zero."""
        m_new = scatter_add_ordered(self.decay(m, flat_params), idx, val,
                                    rounds)
        return m_new * -self.lr_at(step), m_new

    def dense_step(self, m: torch.Tensor, flat_g: torch.Tensor,
                   flat_params: Optional[torch.Tensor], step: int) -> tuple:
        """``(flat_updates, m')`` from an averaged dense flat gradient."""
        m_new = self.decay(m, flat_params) + flat_g.to(m.dtype)
        return m_new * -self.lr_at(step), m_new
