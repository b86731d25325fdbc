"""The data-parallel train step — port of
``gaussiank_sgd_tpu/parallel/trainstep.py`` for one worker.

The algorithmic contract is the reference's::

    acc      = residual + g_local               (the reference's scale is 1)
    (idx, v) = select(acc, k)  per bucket
    residual'= acc - sent                       (error feedback)
    G        = scatter_sum(all_gather(idx, v)) / P
    params  '= FlatSGDM(params, G)              (momentum + weight decay)

plus the dense warm-up step ``G = all_reduce(g_local) / P``. Two forms of
the sparse step, chosen when the step is built (``fused_ef_layout``):

* fused EF (``gaussian_fused`` where its kernel geometry allows): the live
  EF row is kept block-padded so kernel B1 reads it and the flat gradient
  as free ``[n_chunks, chunk_pad]`` views, and writes the new accumulator
  in the same pass. The model's flat parameter is allocated at that padded
  length (``flat_numel``) with a zero tail no layer reads, so autograd hands
  back the gradient already padded;
* unfused (every other compressor and plan): ``acc`` is materialised, and
  ``compress_buckets`` runs the compressor per bucket.

PyTorch idiom, and what it changes: the step runs eagerly, and state is
updated in place — the flat parameter (the model's own ``nn.Parameter``)
and the BatchNorm buffers are written in place; the momentum, the EF row
and the thresholds are replaced by new tensors. The non-finite guard keeps
the reference's contract without a host sync: a step whose loss or
gradient holds a non-finite value commits nothing (elementwise
``torch.where`` on a device-side predicate) and the step counter still
advances.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import torch

from ..compressors.base import CompressedGrad
from ..compressors.registry import CompressorSpec
from .bucketing import BucketPlan
from .collectives import all_gather, dense_allreduce, world_size
from .flat_opt import FlatSGDM


@dataclass
class TrainState:
    step: int
    params: torch.Tensor             # flat f32 [ef_numel], updated in place
    model_state: Dict[str, torch.Tensor]  # float buffers (BatchNorm
                                     # running stats), updated in place
    opt_state: Dict[str, torch.Tensor]    # {"m": flat momentum [ef_numel]}
    ef_residual: torch.Tensor        # f32 [P * ef_numel]: this worker's
                                     # un-sent gradient mass; block-padded
                                     # on the fused EF path (pad stays 0)
    comp_state: Optional[torch.Tensor] = None  # f32 [P, n_buckets]: the
                                     # warm thresholds; None if stateless


class StepMetrics(NamedTuple):
    """Device tensors (read them on the host only where needed)."""

    loss: torch.Tensor
    aux: Dict[str, torch.Tensor]
    num_selected: torch.Tensor       # entries over threshold (pre-k), f32;
                                     # n_total on the dense step
    bytes_sent: float                # this worker's exchange payload
    skipped: torch.Tensor            # f32 0/1: the guard made it a no-op
    nonfinite: torch.Tensor          # f32: non-finite grads (+1 for loss)


class LocalGrads(NamedTuple):
    loss: torch.Tensor
    aux: Dict[str, torch.Tensor]
    flat_g: torch.Tensor             # f32 [ef_numel]; the pad is zero
    model_state_before: Dict[str, torch.Tensor]


# loss_fn(batch) -> (scalar loss, aux dict); a closure over the model whose
# flat parameter is ``params`` and whose float buffers are ``model_state``
LossFn = Callable[[Any], Tuple[torch.Tensor, Dict[str, torch.Tensor]]]


def fused_ef_layout(spec: CompressorSpec,
                    plan: BucketPlan) -> Optional[Tuple[int, int, int]]:
    """(n_chunks, chunk, chunk_pad) when the fused EF+select kernel can own
    the EF accumulate for this (spec, plan), else None: one whole-model
    bucket pads at its tail; a uniform multi-chunk plan qualifies only when
    its chunk is already block-aligned."""
    if spec.fused_ef_fn is None or spec.ef_pad is None:
        return None
    b0 = plan.buckets[0]
    cp = spec.ef_pad(b0.size, b0.k)
    if cp is None:
        return None
    if len(plan.buckets) == 1:
        return (1, b0.size, cp)
    if plan.uniform and cp == b0.size:
        return (len(plan.buckets), b0.size, cp)
    return None


def flat_numel(spec: CompressorSpec, plan: BucketPlan) -> int:
    """Length of the flat parameter, gradient and EF row the step works on:
    the model's parameters, zero-padded to the kernel's block-aligned
    length on the fused EF path."""
    layout = fused_ef_layout(spec, plan)
    return (layout[0] * layout[2] if layout is not None
            else plan.total_numel)


def _compressor_call(spec: CompressorSpec, chunk: torch.Tensor, k: int,
                     st: Optional[torch.Tensor]):
    """``(CompressResult, new state)`` for a stateful or stateless spec;
    a stateless one passes ``st`` through."""
    if spec.stateful:
        return spec.fn(chunk, k, st)
    return spec.fn(chunk, k), st


def compress_buckets(spec: CompressorSpec, plan: BucketPlan,
                     acc: torch.Tensor, comp_state: Optional[torch.Tensor],
                     ) -> Tuple[CompressedGrad, torch.Tensor, torch.Tensor,
                                Optional[torch.Tensor]]:
    """Run the compressor over every bucket of a flat ``acc``: ``(comp with
    global indices, residual [n], num_selected [n_buckets] int32, new
    comp_state [n_buckets] or None)``. ``acc`` is not modified.

    A uniform plan of several buckets views the buffer, zero-padded to a
    whole number of chunks, as ``[n_chunks, chunk]``: the spec's
    ``batched_fn`` takes it at once, or else the compressor runs row by
    row; the pad is stripped from the residual. Any other plan runs the
    compressor on each bucket's slice in turn."""
    n = acc.shape[0]
    chunks = [acc[b.offset:b.offset + b.size] for b in plan.buckets]
    if plan.uniform and len(plan.buckets) > 1:
        n_chunks = len(plan.buckets)
        chunk, k = plan.buckets[0].size, plan.buckets[0].k
        pad = n_chunks * chunk - n
        x = (torch.nn.functional.pad(acc, (0, pad)) if pad
             else acc).view(n_chunks, chunk)
        if spec.batched_fn is not None:
            r, st_new = spec.batched_fn(x, k, comp_state)
            offs = (torch.arange(n_chunks, dtype=torch.int32,
                                 device=acc.device) * chunk)[:, None]
            comp = CompressedGrad((r.compressed.indices + offs).reshape(-1),
                                  r.compressed.values.reshape(-1))
            return (comp, r.residual.reshape(-1)[:n],
                    r.num_selected.to(torch.int32).reshape(-1), st_new)
        chunks = list(x)
    parts = [_compressor_call(spec, c, b.k,
                              comp_state[i] if spec.stateful else None)
             for i, (c, b) in enumerate(zip(chunks, plan.buckets))]
    comp = CompressedGrad(
        torch.cat([r.compressed.indices + b.offset
                   for (r, _), b in zip(parts, plan.buckets)]),
        torch.cat([r.compressed.values for r, _ in parts]))
    residuals = [r.residual for r, _ in parts]
    residual = (residuals[0] if len(residuals) == 1
                else torch.cat(residuals)[:n])
    return (comp, residual,
            torch.stack([r.num_selected.to(torch.int32) for r, _ in parts]),
            torch.stack([st for _, st in parts]) if spec.stateful else None)


class DPTrainStep:
    """The step bundle the trainer drives: ``sparse_step`` / ``dense_step``
    ``(state, batch) -> StepMetrics``, plus ``init_state``.

    ``local_grads`` and ``compress_phase`` are the two halves of the
    sparse step, exposed so a check can hold the EF bookkeeping of one step
    (``decompress(sent) + residual == acc``) without committing it.
    """

    def __init__(self, loss_fn: LossFn, params: torch.Tensor,
                 model_state: Dict[str, torch.Tensor], spec: CompressorSpec,
                 plan: BucketPlan, *, flat_opt: FlatSGDM):
        self.fused_ef = fused_ef_layout(spec, plan)
        self.n_total = plan.total_numel
        self.ef_numel = flat_numel(spec, plan)
        if params.dim() != 1 or params.numel() != self.ef_numel:
            raise ValueError(
                f"this (compressor, bucket plan) needs a flat parameter of "
                f"{self.ef_numel} elements ({self.n_total} params and a zero "
                f"pad), got shape {tuple(params.shape)}")
        if params.dtype != torch.float32:
            raise TypeError("the flat parameter must be float32")
        self.loss_fn = loss_fn
        self.params = params
        self.model_state = model_state
        self.spec = spec
        self.plan = plan
        self.flat_opt = flat_opt

    # ------------------------------------------------------------ state
    def init_state(self) -> TrainState:
        p = world_size()
        dev = self.params.device
        return TrainState(
            step=0, params=self.params, model_state=self.model_state,
            opt_state=self.flat_opt.init(self.ef_numel, device=dev),
            ef_residual=torch.zeros(p * self.ef_numel, device=dev),
            comp_state=(torch.full((p, len(self.plan.buckets)),
                                   self.spec.init_state, device=dev)
                        if self.spec.stateful else None))

    # ----------------------------------------------------------- phases
    def local_grads(self, state: TrainState, batch: Any) -> LocalGrads:
        """Forward and backward: the loss, aux, and the flat f32 gradient
        in the reference's flat order at ``ef_numel`` (the pad, which no
        layer reads, gets a zero gradient). The forward updates the
        BatchNorm buffers in place; their values from before are returned
        for the guard."""
        before = {k: v.clone() for k, v in state.model_state.items()}
        loss, aux = self.loss_fn(batch)
        (grad,) = torch.autograd.grad(loss, state.params)
        # the reference averages float model state over workers here; a
        # world of one has nothing to average (the multi-worker slice does)
        return LocalGrads(loss.detach(), aux, grad, before)

    def compress_phase(self, state: TrainState, flat_g: torch.Tensor):
        """EF accumulate + per-bucket selection: ``(comp with global
        indices, new residual, nsel [n_buckets], new comp_state [n_buckets]
        or None)``. Writes nothing of ``state``. On the fused path one
        kernel pass (B1) does both, and the residual is the padded EF row;
        otherwise ``acc = residual + g`` goes through ``compress_buckets``.
        (The reference's ``scale`` is 1 unless it folds the learning rate
        into the accumulator, which the port does not.)"""
        if self.fused_ef is None:
            return compress_buckets(
                self.spec, self.plan, state.ef_residual + flat_g,
                state.comp_state[0] if self.spec.stateful else None)
        n_chunks, chunk, chunk_pad = self.fused_ef
        r, cstate = self.spec.fused_ef_fn(
            state.ef_residual.view(n_chunks, chunk_pad),
            flat_g.view(n_chunks, chunk_pad), 1.0, self.plan.buckets[0].k,
            state.comp_state[0])
        # chunk-local -> global offsets use the unpadded chunk (offset 0
        # for the single bucket; chunk_pad == chunk for multi-chunk plans)
        offs = (torch.arange(n_chunks, dtype=torch.int32,
                             device=flat_g.device) * chunk)[:, None]
        comp = CompressedGrad((r.compressed.indices + offs).reshape(-1),
                              r.compressed.values.reshape(-1))
        return (comp, r.residual.reshape(-1),
                r.num_selected.to(torch.int32).reshape(-1), cstate)

    @staticmethod
    def _guard(g: LocalGrads):
        """(ok, skipped, nonfinite) on the device."""
        cnt = ((~torch.isfinite(g.flat_g)).sum()
               + (~torch.isfinite(g.loss)).to(torch.int64))
        return cnt == 0, (cnt > 0).float(), cnt.float()

    def _params_if_wd(self, state: TrainState) -> Optional[torch.Tensor]:
        return state.params.detach() if self.flat_opt.weight_decay else None

    @torch.no_grad()
    def _commit(self, state: TrainState, g: LocalGrads, ok,
                upd: torch.Tensor, m_new: torch.Tensor,
                residual: torch.Tensor,
                cstate: Optional[torch.Tensor]) -> None:
        """Commit the new training state when ``ok``, else keep the old one
        bit for bit; the step always advances."""
        def keep(new, old):
            return torch.where(ok, new, old)
        params = state.params.detach()
        params.copy_(keep(params + upd, params))
        state.opt_state["m"] = keep(m_new, state.opt_state["m"])
        state.ef_residual = keep(residual, state.ef_residual)
        if cstate is not None:
            state.comp_state = keep(cstate, state.comp_state)
        for name, buf in state.model_state.items():
            buf.copy_(torch.where(ok, buf, g.model_state_before[name]))
        state.step += 1

    # ------------------------------------------------------------ steps
    def sparse_step(self, state: TrainState, batch: Any) -> StepMetrics:
        g = self.local_grads(state, batch)
        comp, residual, nsel, cstate = self.compress_phase(state, g.flat_g)
        ok, skipped, nonfinite = self._guard(g)
        # legacy (i32, f32) exchange; the 1/P average rides the k values
        g_idx = all_gather(comp.indices)
        g_val = all_gather(comp.values) / world_size()
        upd, m_new = self.flat_opt.sparse_step(
            state.opt_state["m"], g_idx, g_val, self._params_if_wd(state),
            state.step)
        self._commit(state, g, ok, upd, m_new, residual,
                     None if cstate is None else cstate[None, :])
        return StepMetrics(
            g.loss, g.aux, nsel.float().sum(),
            float(comp.indices.numel() * comp.indices.element_size()
                  + comp.values.numel() * comp.values.element_size()),
            skipped, nonfinite)

    def dense_step(self, state: TrainState, batch: Any) -> StepMetrics:
        g = self.local_grads(state, batch)
        ok, skipped, nonfinite = self._guard(g)
        dense = dense_allreduce(g.flat_g)
        upd, m_new = self.flat_opt.dense_step(
            state.opt_state["m"], dense, self._params_if_wd(state),
            state.step)
        # warm-up is compression-off: the EF row is untouched
        self._commit(state, g, ok, upd, m_new, state.ef_residual, None)
        return StepMetrics(
            g.loss, g.aux,
            torch.tensor(float(self.n_total), device=g.flat_g.device),
            float(self.n_total * 4), skipped, nonfinite)
