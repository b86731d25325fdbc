"""Ring attention: exact attention with the sequence split over a process
group (port of ``gaussiank_sgd_tpu/parallel/ring_attention.py``).

Each of the ``sp`` ranks of the group holds one contiguous block of the
sequence, ``T_local = T / sp`` positions. It keeps its Q block and passes
its K/V blocks around the ring: at each hop a rank sends the blocks it
holds to rank ``(j - 1) % sp`` and receives its right neighbour's, one
``batch_isend_irecv`` of a K and a V pair. The softmax accumulates online
(a running max, a running sum and an unnormalised output, as in flash
attention), so no rank ever holds the ``[T, T]`` scores; the result equals
full softmax attention up to the order of f32 sums.

As in the reference: ``sp - 1`` hops run inside the loop and the block
held after the last hop attends outside it, so no dead hop is paid; the
causal bias of a block comes from the rank it started on, ``(my + i) %
sp`` after ``i`` hops; scores, the running statistics and the output
accumulate in f32 (``NEG_INF = -1e30`` marks a masked score, and a row
with no unmasked score yet keeps a finite max so ``exp`` gives 0, not
NaN); the output is cast back to q's dtype. Explicit matmuls, not
``scaled_dot_product_attention``, keep the reference's order of
operations.

The hop is differentiable: its backward sends the blocks' gradients the
other way round the ring (``ppermute``'s transpose), so each rank's
backward hands the gradient of the other ranks' losses with respect to its
K/V back to it. Gloo sends no CUDA tensor point to point, so on a gloo
group a CUDA block goes through host memory (``collectives.send_recv``);
NCCL sends the CUDA tensors.

``ring_attention_blocks`` runs the same ring for every rank in one
process, the rotation a roll of a list of blocks: a check on one card of
what ``sp`` cards would compute.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from .collectives import Group, rank, send_recv, world_size

NEG_INF = -1e30


def _block_attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  bias: torch.Tensor, m_prev: torch.Tensor,
                  l_prev: torch.Tensor, o_prev: torch.Tensor,
                  scale: float) -> Tuple[torch.Tensor, torch.Tensor,
                                         torch.Tensor]:
    """One online-softmax step (the reference's ``_block_attend``).

    ``q`` ``[B, H, Tq, D]``, ``k``/``v`` ``[B, H, Tk, D]`` (f32), ``bias``
    ``[Tq, Tk]`` additive; the carries: ``m`` the running max ``[B, H,
    Tq]``, ``l`` the running denominator, ``o`` the unnormalised output
    ``[B, H, Tq, D]``."""
    s = torch.matmul(q, k.transpose(-1, -2)) * scale
    s = s + bias
    m_new = torch.maximum(m_prev, s.amax(dim=-1))
    # a row masked so far keeps a finite max, so exp gives 0, not NaN
    m_safe = torch.where(m_new <= NEG_INF / 2, 0.0, m_new)
    p = torch.exp(s - m_safe[..., None])
    p = torch.where(s <= NEG_INF / 2, 0.0, p)
    alpha = torch.where(m_prev <= NEG_INF / 2, 0.0,
                        torch.exp(m_prev - m_safe))
    l_new = alpha * l_prev + p.sum(dim=-1)
    o_new = alpha[..., None] * o_prev + torch.matmul(p.to(v.dtype), v)
    return m_new, l_new, o_new


def _bias(my: int, src: int, t_local: int, causal: bool,
          device: torch.device) -> torch.Tensor:
    """The additive bias of rank ``my``'s Q block against the K/V block
    that started on rank ``src``: 0, or ``NEG_INF`` where the key's global
    position is after the query's."""
    if not causal:
        return torch.zeros(t_local, t_local, device=device)
    pos = torch.arange(t_local, device=device)
    pos_q, pos_k = my * t_local + pos, src * t_local + pos
    return torch.where(pos_q[:, None] >= pos_k[None, :], 0.0, NEG_INF)


def _init(q: torch.Tensor):
    """``(m, l, o)`` before the first block."""
    return (torch.full(q.shape[:-1], NEG_INF, device=q.device),
            torch.zeros(q.shape[:-1], device=q.device),
            torch.zeros(q.shape, device=q.device))


def _finish(o: torch.Tensor, l: torch.Tensor,
            dtype: torch.dtype) -> torch.Tensor:
    return (o / torch.clamp(l[..., None], min=1e-30)).to(dtype)


# ------------------------------------------------------------------ hop

def _rotate(tensors: Sequence[torch.Tensor], group: Group,
            shift: int) -> List[torch.Tensor]:
    """Send each tensor to group rank ``(j + shift) % sp`` and receive the
    same shapes from ``(j - shift) % sp``: one ``batch_isend_irecv``."""
    sp, my = world_size(group), rank(group)

    def peer(r):
        r %= sp
        return r if group is None else dist.get_global_rank(group, r)

    recvs, reqs = send_recv(tensors, peer(my + shift), peer(my - shift),
                            group)
    for req in reqs:
        req.wait()
    return recvs


class _Hop(torch.autograd.Function):
    """The K/V hop: forward from the right neighbour, and the gradients
    back to it (to the left neighbour's blocks' owner, the reverse
    rotation)."""

    @staticmethod
    def forward(ctx, group, k, v):
        ctx.group = group
        return tuple(_rotate((k, v), group, -1))

    @staticmethod
    def backward(ctx, gk, gv):
        gk, gv = _rotate((gk, gv), ctx.group, +1)
        return None, gk, gv


def ring_hop(k: torch.Tensor, v: torch.Tensor,
             group: Group) -> Tuple[torch.Tensor, torch.Tensor]:
    """The blocks held by the right neighbour (group rank ``j + 1``),
    differentiably."""
    return _Hop.apply(group, k, v)


# ----------------------------------------------------------------- ring

def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   group: Group, causal: bool = True,
                   scale: Optional[float] = None) -> torch.Tensor:
    """Exact attention with the sequence split over ``group`` (this rank's
    place in it is its block's): ``q``, ``k``, ``v`` ``[B, H, T_local, D]``
    are this rank's block, the global ``T = T_local * sp`` in rank order.
    Returns ``[B, H, T_local, D]`` in q's dtype."""
    sp, my = world_size(group), rank(group)
    t_local, d = q.shape[-2], q.shape[-1]
    scale = d ** -0.5 if scale is None else scale
    qf = q.float()
    m, l, o = _init(qf)
    kb, vb = k, v
    for i in range(sp - 1):
        m, l, o = _block_attend(qf, kb.float(), vb.float(),
                                _bias(my, (my + i) % sp, t_local, causal,
                                      q.device), m, l, o, scale)
        kb, vb = ring_hop(kb, vb, group)
    m, l, o = _block_attend(qf, kb.float(), vb.float(),
                            _bias(my, (my + sp - 1) % sp, t_local, causal,
                                  q.device), m, l, o, scale)
    return _finish(o, l, q.dtype)


def ring_attention_blocks(qs: Sequence[torch.Tensor],
                          ks: Sequence[torch.Tensor],
                          vs: Sequence[torch.Tensor], causal: bool = True,
                          scale: Optional[float] = None
                          ) -> List[torch.Tensor]:
    """``ring_attention`` of ``sp = len(qs)`` ranks in one process: rank
    ``j`` holds ``qs[j]``, ``ks[j]``, ``vs[j]``; a hop rolls the lists of
    K/V blocks by one. Returns each rank's output block."""
    sp = len(qs)
    t_local, d = qs[0].shape[-2], qs[0].shape[-1]
    scale = d ** -0.5 if scale is None else scale
    qf = [q.float() for q in qs]
    carry = [_init(q) for q in qf]
    kb, vb = list(ks), list(vs)
    for i in range(sp):
        carry = [_block_attend(qf[j], kb[j].float(), vb[j].float(),
                               _bias(j, (j + i) % sp, t_local, causal,
                                     qf[j].device), *carry[j], scale)
                 for j in range(sp)]
        if i < sp - 1:
            kb, vb = kb[1:] + kb[:1], vb[1:] + vb[:1]
    return [_finish(o, l, q.dtype) for (_, l, o), q in zip(carry, qs)]
