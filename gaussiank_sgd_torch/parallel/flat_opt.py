"""The two optimizers of the train step: the flat sparse-aware SGD
(``FlatSGDM``, port of ``gaussiank_sgd_tpu/parallel/flat_opt.py``) and the
reference's optax path on the dense gradient (``OptaxSGD``).

The gathered ``(index, value)`` pairs are scatter-added straight into the
decayed momentum, so no dense gradient buffer exists on the sparse path::

    m' = mu * m (+ wd * p)      # dense half
    m'[idx] += val              # k-sized scatter-add
    p  = p - lr(step) * m'

The warm-up (dense) path uses the same state and rule with ``+ g_dense``.
Every operation rounds to f32 on its own (no fused multiply-add), in this
order, on the CPU and on the card alike.

``OptaxSGD`` takes a dense flat gradient; the reference picks it for
Nesterov momentum, ``fold_lr``, the two-level mesh, and SGD with neither
momentum nor weight decay.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Union

import numpy as np
import torch

from ..compressors.base import scatter_add_ordered


def _lr_at(lr: Union[float, Callable[[int], float]], step: int) -> float:
    """A learning rate (value or step -> value) at ``step``, rounded to
    f32."""
    return float(np.float32(lr(step) if callable(lr) else lr))


class FlatSGDM(NamedTuple):
    """Config of the flat sparse-aware SGD update."""

    lr: Union[float, Callable[[int], float]]   # value or step -> lr
    momentum: float = 0.0
    weight_decay: float = 0.0

    def lr_at(self, step: int) -> float:
        """The learning rate at ``step``, rounded to f32."""
        return _lr_at(self.lr, step)

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


class OptaxSGD(NamedTuple):
    """The reference's optax path on the flat dense gradient: the chain
    ``add_decayed_weights(wd)`` then ``optax.sgd(lr, momentum or None,
    nesterov)`` that ``gaussiank_sgd_tpu/training/trainer.py:362-371``
    builds and ``parallel/trainstep.py:_apply`` (:684-692) applies::

        u  = g (+ wd * p)
        t' = u + mu * t                  # optax.trace; no trace at mu = 0
        u  = u + mu * t' if nesterov else t'
        p  = p + (-lr(count)) * u        # lr read at the optimizer's count

    The state is ``{"count": int64 []}`` on the host, the number of updates
    made (a guard-skipped step advances it too, as the reference's
    ``_guard_commit`` keeps integer leaves new), and ``{"trace": f32
    [n]}`` when ``momentum`` is set. Under ``fold_lr`` the trainer passes
    ``lr = 1``: the learning rate is then in the gradient. Each operation
    rounds to f32 on its own; XLA on the CPU contracts ``g + wd * p`` and
    ``u + mu * t`` into fused multiply-adds, so the two agree bit for bit
    where those products are exact and one product rounding apart
    elsewhere. The trainer's choice between the two optimizers is the
    reference's (``trainer.py:378-380``): ``FlatSGDM`` only on a 1-D mesh,
    without nesterov or ``fold_lr``, and with momentum or weight decay."""

    lr: Union[float, Callable[[int], float]]   # value or count -> lr
    momentum: float = 0.0
    weight_decay: float = 0.0
    nesterov: bool = False

    def lr_at(self, count: int) -> float:
        """The learning rate at ``count``, rounded to f32."""
        return _lr_at(self.lr, count)

    def init(self, n: int, dtype=torch.float32, device=None) -> dict:
        """The count, and a zero trace of ``n`` when there is momentum."""
        state = {"count": torch.zeros((), dtype=torch.int64)}
        if self.momentum:
            state["trace"] = torch.zeros(n, dtype=dtype, device=device)
        return state

    def update(self, state: dict, dense: torch.Tensor,
               flat_params: Optional[torch.Tensor]) -> tuple:
        """``(flat_updates, new state)`` from an averaged dense flat
        gradient. ``state`` is not written."""
        count = int(state["count"])
        u = dense
        if self.weight_decay:
            if flat_params is None:
                raise ValueError("weight decay needs the flat params")
            u = u + flat_params.to(u.dtype) * self.weight_decay
        new = {"count": torch.tensor(count + 1, dtype=torch.int64)}
        if self.momentum:
            t = u + state["trace"] * self.momentum
            u = u + t * self.momentum if self.nesterov else t
            new["trace"] = t
        return u * -self.lr_at(count), new
