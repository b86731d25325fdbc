"""The data-parallel train step — port of the sequential step of
``gaussiank_sgd_tpu/parallel/trainstep.py``, one worker a process.

The algorithmic contract is the reference's::

    acc      = residual + scale * g_local       (scale = lr(step) under
                                                 fold_lr, else 1)
    (idx, v) = select(acc, k)  per bucket
    residual'= acc - sent                       (error feedback)
    G        = scatter_sum(all_gather(idx, v)) / P
    params  '= opt(params, G)

plus the dense warm-up step ``G = all_reduce(scale * g_local) / P``. Every
process holds the replicated parameters, optimizer state and BatchNorm
statistics and its own EF row and thresholds; after the forward the
BatchNorm statistics, the loss and the aux values are averaged over the
workers.

Two optimizers (``parallel/flat_opt.py``), as in the reference:
``flat_opt`` (``FlatSGDM``) scatters the gathered pairs straight into its
momentum, with no dense gradient; ``optimizer`` (``OptaxSGD``, the
reference's optax path) scatters them into a dense zero buffer of
``n_total`` (the padded tail stays zero) and applies the chain to it.
``FlatSGDM`` is refused on a 2-D mesh and under ``fold_lr``, as the
reference refuses it.

``mesh`` (``parallel/mesh.py:DPMesh``) is the layout: the default group,
or the two-level ``(dcn_dp, ici_dp)`` groups. On the two-level layout the
pairs are all-gathered over the node's ici group, divided by ``I * D``,
scattered dense, and that dense partial is summed over the dcn group
before the optimizer (the reference's ``_gather`` then ``_psum_outer``);
the dense step sums over the dcn group, then the ici group, then divides
by ``I * D``; every mean (loss, aux, BatchNorm statistics, num_selected)
is taken one axis after the other, dcn first, as the reference's
``_pmean`` is.

A recurrent model (``recurrent``: the LSTM with its hidden state carried
across bptt windows) keeps its carry in ``TrainState.carry``: this worker's
rows, never averaged, split by rows across microbatches as the batch is and
reassembled after; a guard-skipped step keeps the old carry.

A compressor that draws (``requires_rng``: randomk) gets one generator a
bucket a step from ``compressors/randomk.py:comp_generator``, seeded from
(seed, step, bucket) and with ``decorrelate_comp_rng`` the rank, as the
reference derives its compressor key from the step.

The exchange (``parallel/collectives.py``) takes one of two wire formats,
chosen when the step is built (``wire``, ``parallel/wire.py``): the packed
u16|bf16 words where the gate admits the plan, whose bf16 rounding the
sender's EF row absorbs, else the legacy (i32, f32) pairs. The gathered
pairs are added to the momentum in the gathered buffer's order, so every
rank commits the same bits (``compressors/base.py:scatter_add_ordered``).

``exchange="gtopk"`` replaces the all-gather with the gTop-k butterfly
(``parallel/gtopk.py``; a power-of-2 number of workers): the global k
pairs, the same on every rank, are divided by P and added to the
momentum, and the EF row becomes ``global_residual(acc, global pairs)``,
with no correction for the wire's bf16 rounding (the published gTop-k
residual absorbs it). It needs the unpadded accumulator, so it always
takes the unfused form below.

Two forms of the sparse step, chosen when the step is built
(``fused_ef_layout``):

* fused EF (``gaussian_fused`` where its kernel geometry allows): the live
  EF row is kept block-padded so kernel B1 reads it and the flat gradient
  as free ``[n_chunks, chunk_pad]`` views, and writes the new accumulator
  in the same pass. The model's flat parameter is allocated at that padded
  length (``flat_numel``) with a zero tail no layer reads, so autograd hands
  back the gradient already padded;
* unfused (every other compressor, plan and the gtopk exchange): ``acc``
  is materialised, and ``compress_buckets`` runs the compressor per
  bucket.

PyTorch idiom, and what it changes: the step runs eagerly, and state is
updated in place — the flat parameter (the model's own ``nn.Parameter``)
and the BatchNorm buffers are written in place; the momentum, the EF row
and the thresholds are replaced by new tensors. The non-finite guard keeps
the reference's contract without a host sync: a step whose loss or
gradient holds a non-finite value on any worker commits nothing on every
worker (the non-finite count is all-reduced; elementwise ``torch.where``
on a device-side predicate) and the step counter still advances.

The reference's pipelined schedule (``overlap``) is bit-identical to its
sequential step, which this module ports; the pipeline is not ported.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..compressors.base import CompressedGrad, scatter_add_ordered
from ..compressors.randomk import comp_generator
from ..compressors.registry import CompressorSpec
from ..ops.fused_select import pack_wire_words
from .bucketing import BucketPlan
from .collectives import all_reduce_sum, rank, world_size
from .flat_opt import FlatSGDM, OptaxSGD
from .gtopk import global_residual, gtopk_allreduce
from .mesh import DPMesh, data_parallel_mesh
from .wire import (WIRE_LEGACY, bf16_roundtrip, decode_grouped,
                   encode_grouped, plan_wire_format)


@dataclass
class TrainState:
    step: int
    params: torch.Tensor             # flat f32 [ef_numel], updated in place
    model_state: Dict[str, torch.Tensor]  # float buffers (BatchNorm
                                     # running stats), updated in place
    opt_state: Dict[str, torch.Tensor]    # FlatSGDM: {"m": flat momentum
                                     # [ef_numel]}; OptaxSGD: {"count":
                                     # int64 [] on the host, "trace":
                                     # [ef_numel] with momentum}
    ef_residual: torch.Tensor        # f32 [ef_numel]: this worker's own
                                     # un-sent gradient mass; block-padded
                                     # on the fused EF path (pad stays 0)
    comp_state: Optional[torch.Tensor] = None  # f32 [1, n_buckets]: this
                                     # worker's warm thresholds; None if
                                     # stateless
    carry: Optional[torch.Tensor] = None  # recurrent hidden state of this
                                     # worker's rows [L, 2, B, H]; None
                                     # unless recurrent


class StepMetrics(NamedTuple):
    """Device tensors (read them on the host only where needed)."""

    loss: torch.Tensor
    aux: Dict[str, torch.Tensor]
    num_selected: torch.Tensor       # entries over threshold (pre-k), f32,
                                     # the worker mean; n_total on the
                                     # dense step
    bytes_sent: float                # this worker's exchange payload, read
                                     # from the buffers handed to the
                                     # collective
    skipped: torch.Tensor            # f32 0/1: the guard made it a no-op
    nonfinite: torch.Tensor          # f32: non-finite grads (+1 for loss);
                                     # skipped and nonfinite are 0 with
                                     # the guard off
    grad_norm: torch.Tensor          # f32: this worker's ||g||_2 (after
                                     # the clip); not yet averaged
    sel_per_bucket: torch.Tensor     # f32 [n_buckets]: the worker mean of
                                     # each bucket's count (num_selected is
                                     # their sum); the bucket sizes on the
                                     # dense step


class LocalGrads(NamedTuple):
    loss: torch.Tensor               # worker mean
    aux: Dict[str, torch.Tensor]     # worker means
    flat_g: torch.Tensor             # f32 [ef_numel], this worker's; the
                                     # pad is zero
    model_state_before: Dict[str, torch.Tensor]
    carry: Optional[torch.Tensor] = None  # the new carry (recurrent)


# loss_fn(batch) -> (scalar loss, aux dict); a closure over the model whose
# flat parameter is ``params`` and whose float buffers are ``model_state``.
# A recurrent one is loss_fn(batch, carry) -> (loss, aux, new carry), the
# new carry detached (no gradient flows into an earlier window).
LossFn = Callable[..., Tuple]


EXCHANGES = ("allgather", "gtopk")


def fused_ef_layout(spec: CompressorSpec, plan: BucketPlan,
                    exchange: str = "allgather"
                    ) -> Optional[Tuple[int, int, int]]:
    """(n_chunks, chunk, chunk_pad) when the fused EF+select kernel can own
    the EF accumulate for this (spec, plan, exchange), else None: one
    whole-model bucket pads at its tail; a uniform multi-chunk plan
    qualifies only when its chunk is already block-aligned. gtopk never
    does: ``global_residual`` needs the unpadded accumulator."""
    if (exchange != "allgather" or spec.fused_ef_fn is None
            or spec.ef_pad is None):
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


def flat_numel(spec: CompressorSpec, plan: BucketPlan,
               exchange: str = "allgather") -> int:
    """Length of the flat parameter, gradient and EF row the step works on:
    the model's parameters, zero-padded to the kernel's block-aligned
    length on the fused EF path."""
    layout = fused_ef_layout(spec, plan, exchange)
    return (layout[0] * layout[2] if layout is not None
            else plan.total_numel)


def _clip_by_global_norm(flat_g: torch.Tensor,
                         clip: float) -> torch.Tensor:
    """``flat_g * min(1, clip / (||flat_g||_2 + 1e-12))`` in f32, as a new
    tensor; a non-finite norm makes every entry non-finite, as in the
    reference. The norm accumulates in f64: torch's f32 norm on the CPU
    sums in one running order (1.4e-3 relative error at ResNet-50's 25.6M
    entries), where XLA's pairwise sum holds ~1e-8. (``clip / t`` on a
    tensor would multiply by its reciprocal: the division is written out
    to round as the reference's does.)"""
    norm = torch.linalg.vector_norm(flat_g, dtype=torch.float64).float()
    scale = torch.minimum(norm.new_tensor(1.0),
                          torch.div(norm.new_tensor(clip), norm + 1e-12))
    return flat_g * scale


# bucket index -> that bucket's compressor generator for this step
RngFn = Callable[[int], torch.Generator]


def _compressor_call(spec: CompressorSpec, chunk: torch.Tensor, k: int,
                     st: Optional[torch.Tensor],
                     gen: Optional[torch.Generator] = None):
    """``(CompressResult, new state)`` for a stateful or stateless spec,
    with the bucket's generator last when it draws; a stateless one passes
    ``st`` through."""
    args = (chunk, k) + ((st,) if spec.stateful else ())
    r = spec.fn(*args, *((gen,) if spec.requires_rng else ()))
    return r if spec.stateful else (r, st)


def compress_buckets(spec: CompressorSpec, plan: BucketPlan,
                     acc: torch.Tensor, comp_state: Optional[torch.Tensor],
                     rng: Optional[RngFn] = None,
                     ) -> Tuple[CompressedGrad, torch.Tensor, torch.Tensor,
                                Optional[torch.Tensor]]:
    """Run the compressor over every bucket of a flat ``acc``: ``(comp with
    global indices, residual [n], num_selected [n_buckets] int32, new
    comp_state [n_buckets] or None)``. ``acc`` is not modified. A drawing
    compressor gets ``rng(i)`` for bucket ``i``.

    A uniform plan of several buckets views the buffer, zero-padded to a
    whole number of chunks, as ``[n_chunks, chunk]``: the spec's
    ``batched_fn`` takes it at once, or else the compressor runs row by
    row; the pad is stripped from the residual. Any other plan runs the
    compressor on each bucket's slice in turn."""
    if spec.requires_rng and rng is None:
        raise ValueError(f"compressor {spec.name!r} draws indices and needs "
                         f"a generator a bucket")
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
                              comp_state[i] if spec.stateful else None,
                              rng(i) if spec.requires_rng else None)
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

    ``local_grads``, ``compress_phase`` and ``pack_phase`` are the parts of
    the sparse step before its exchange, exposed so a check can hold the EF
    bookkeeping of one step (``decompress(sent) + residual == acc``, before
    and after the wire) without committing it.

    ``wire`` is ``"auto"`` (the packed format where ``plan_wire_format``
    admits the plan) or ``"off"`` (always the legacy pairs). ``exchange``
    is ``"allgather"`` or ``"gtopk"`` (refused unless the world size is a
    power of 2).

    ``guard_nonfinite`` (default on): a step whose loss or gradient is not
    finite on any worker commits nothing (``StepMetrics.skipped``).

    ``recurrent``: ``loss_fn`` takes and returns the carry (``LossFn``),
    and ``init_state`` takes the initial one. ``seed`` and
    ``decorrelate_comp_rng`` set the compressor stream of a drawing
    compressor.

    Exactly one of ``flat_opt`` (``FlatSGDM``) and ``optimizer``
    (``OptaxSGD``) is given. ``fold_lr`` (step -> lr) makes the EF row
    accumulate ``lr(step) * g`` and the dense step exchange ``lr(step) *
    g``; the optimizer then runs at lr 1. ``mesh`` is the worker layout
    (default: the 1-D mesh of the default group).
    """

    def __init__(self, loss_fn: LossFn, params: torch.Tensor,
                 model_state: Dict[str, torch.Tensor], spec: CompressorSpec,
                 plan: BucketPlan, *, flat_opt: Optional[FlatSGDM] = None,
                 optimizer: Optional[OptaxSGD] = None,
                 fold_lr: Optional[Callable[[int], float]] = None,
                 mesh: Optional[DPMesh] = None, wire: str = "auto",
                 num_microbatches: int = 1,
                 clip_norm: Optional[float] = None, recurrent: bool = False,
                 seed: int = 0, decorrelate_comp_rng: bool = False,
                 exchange: str = "allgather", guard_nonfinite: bool = True):
        if exchange not in EXCHANGES:
            raise ValueError(f"unknown exchange {exchange!r}; expected one "
                             f"of {EXCHANGES}")
        self.mesh = mesh if mesh is not None else data_parallel_mesh()
        if exchange == "gtopk" and len(self.mesh.names) != 1:
            raise ValueError("gtopk exchange supports 1-D dp meshes only")
        p = world_size()
        if exchange == "gtopk" and p & (p - 1):
            raise ValueError(f"the gtopk exchange needs a power-of-2 number "
                             f"of workers, got {p}")
        if (flat_opt is None) == (optimizer is None):
            raise ValueError("pass exactly one optimizer: flat_opt "
                             "(FlatSGDM) or optimizer (OptaxSGD)")
        if flat_opt is not None and (len(self.mesh.names) > 1
                                     or fold_lr is not None):
            raise ValueError("flat_opt supports 1-D meshes without fold_lr; "
                             "use the optax path otherwise")
        self.exchange = exchange
        self.fused_ef = fused_ef_layout(spec, plan, exchange)
        self.n_total = plan.total_numel
        self.ef_numel = flat_numel(spec, plan, exchange)
        if params.dim() != 1 or params.numel() != self.ef_numel:
            raise ValueError(
                f"this (compressor, bucket plan) needs a flat parameter of "
                f"{self.ef_numel} elements ({self.n_total} params and a zero "
                f"pad), got shape {tuple(params.shape)}")
        if params.dtype != torch.float32:
            raise TypeError("the flat parameter must be float32")
        if wire not in ("auto", "off"):
            raise ValueError(f"unknown wire {wire!r}; expected 'auto' or "
                             f"'off'")
        self.loss_fn = loss_fn
        self.params = params
        self.model_state = model_state
        self.spec = spec
        self.plan = plan
        self.flat_opt = flat_opt
        self.optimizer = optimizer
        self.fold_lr = fold_lr
        if num_microbatches < 1:
            raise ValueError(f"num_microbatches={num_microbatches} < 1")
        self.num_microbatches = int(num_microbatches)
        self.clip_norm = clip_norm
        self.recurrent = recurrent
        self.seed = int(seed)
        self.decorrelate_comp_rng = decorrelate_comp_rng
        self.guard_nonfinite = guard_nonfinite
        # None: the legacy (i32, f32) exchange
        self.wire_fmt = (plan_wire_format(plan, params.dtype)
                         if wire == "auto" else None)

    @property
    def wire_format(self) -> str:
        """The exchange's format: ``u16bf16`` or ``i32f32``."""
        return self.wire_fmt.name if self.wire_fmt is not None else WIRE_LEGACY

    # ------------------------------------------------------------ state
    def init_state(self, carry: Optional[torch.Tensor] = None) -> TrainState:
        """Step 0: zero momentum and EF row, the compressor's initial
        thresholds, and ``carry`` (required when recurrent)."""
        if self.recurrent != (carry is not None):
            raise ValueError("a recurrent step needs an initial carry, and "
                             "only a recurrent one takes it")
        dev = self.params.device
        return TrainState(
            step=0, params=self.params, model_state=self.model_state,
            opt_state=(self.flat_opt or self.optimizer).init(
                self.ef_numel, device=dev),
            ef_residual=torch.zeros(self.ef_numel, device=dev),
            comp_state=(torch.full((1, len(self.plan.buckets)),
                                   self.spec.init_state, device=dev)
                        if self.spec.stateful else None),
            carry=carry)

    def comp_rng(self, step: int, device: torch.device) -> RngFn:
        """Bucket -> the compressor generator of ``step``: the same on every
        rank unless ``decorrelate_comp_rng``."""
        r = rank() if self.decorrelate_comp_rng else None
        return lambda bucket: comp_generator(self.seed, step, bucket,
                                             device, r)

    def scale(self, step: int) -> float:
        """The EF accumulate's scale at ``step``: ``lr(step)`` (f32) under
        ``fold_lr``, else 1."""
        return (float(np.float32(self.fold_lr(step)))
                if self.fold_lr is not None else 1.0)

    # ----------------------------------------------------------- phases
    def local_grads(self, state: TrainState, batch: Any) -> LocalGrads:
        """Forward and backward on this worker's batch: the worker-mean
        loss and aux, and this worker's flat f32 gradient in the
        reference's flat order at ``ef_numel`` (the pad, which no layer
        reads, gets a zero gradient). The forward updates the BatchNorm
        buffers in place, and they are then averaged over the workers; their
        values from before are returned for the guard.

        With ``num_microbatches`` n > 1 (``--nsteps-update``) the batch's
        rows split into n equal contiguous chunks, run one after another
        (the BatchNorm statistics thread through them in order); loss, aux
        and gradient are summed in that order into one buffer each, then
        multiplied by ``1.0 / n``, as the reference's scan does, so memory
        stays constant in n. A recurrent carry splits by rows with the
        batch, and the microbatches' new carries are put back together in
        row order. With ``clip_norm`` the flat gradient is then scaled by
        ``min(1, clip / (||g||_2 + 1e-12))`` (the zero pad leaves the norm
        unchanged), before the guard and the compressor."""
        before = {k: v.clone() for k, v in state.model_state.items()}
        n = self.num_microbatches
        chunks = [batch]
        carries = [state.carry] * n
        if n > 1:
            for x in batch:
                if x.shape[0] % n:
                    raise ValueError(
                        f"per-worker batch dim {x.shape[0]} is not divisible"
                        f" by nsteps_update={n}; pick a batch size that "
                        f"splits into equal microbatches")
            chunks = list(zip(*(torch.chunk(x, n) for x in batch)))
            if self.recurrent:
                carries = list(torch.chunk(state.carry, n, dim=2))
        loss = aux = grad = None
        new_carries = []
        for mb, mb_carry in zip(chunks, carries):
            if self.recurrent:
                mb_loss, mb_aux, c = self.loss_fn(mb, mb_carry)
                new_carries.append(c)
            else:
                mb_loss, mb_aux = self.loss_fn(mb)
            (mb_grad,) = torch.autograd.grad(mb_loss, state.params)
            if grad is None:
                loss, aux, grad = mb_loss.detach(), mb_aux, mb_grad
            else:
                loss = loss + mb_loss.detach()
                aux = {k: v + mb_aux[k] for k, v in aux.items()}
                grad += mb_grad
            del mb_grad          # freed before the next microbatch's forward
        if n > 1:
            inv = 1.0 / n
            loss, grad = loss * inv, grad.mul_(inv)
            aux = {k: v * inv for k, v in aux.items()}
        if self.clip_norm is not None:
            grad = _clip_by_global_norm(grad, self.clip_norm)
        with torch.no_grad():
            for buf in state.model_state.values():
                if buf.is_floating_point():
                    buf.copy_(self.mesh.pmean(buf))
        carry = torch.cat(new_carries, dim=2) if self.recurrent else None
        return LocalGrads(self.mesh.pmean(loss),
                          {k: self.mesh.pmean(v) for k, v in aux.items()},
                          grad, before, carry)

    def _compress_acc(self, state: TrainState, acc: torch.Tensor):
        """``compress_buckets`` over a materialised accumulator, with the
        state's thresholds and this step's compressor stream."""
        return compress_buckets(
            self.spec, self.plan, acc,
            state.comp_state[0] if self.spec.stateful else None,
            self.comp_rng(state.step, acc.device))

    def accumulate(self, state: TrainState,
                   flat_g: torch.Tensor) -> torch.Tensor:
        """The unfused EF accumulator ``residual + scale * g``, each
        operation rounded (kernel B1 computes the same on the fused
        path)."""
        scale = self.scale(state.step)
        return state.ef_residual + (flat_g if scale == 1.0
                                    else flat_g * scale)

    def _compress(self, state: TrainState, flat_g: torch.Tensor):
        """``compress_phase`` and, on the fused path with the packed wire,
        the wire words straight from the select pass (else None)."""
        if self.fused_ef is None:
            return self._compress_acc(
                state, self.accumulate(state, flat_g)) + (None,)
        n_chunks, chunk, chunk_pad = self.fused_ef
        r, cstate = self.spec.fused_ef_fn(
            state.ef_residual.view(n_chunks, chunk_pad),
            flat_g.view(n_chunks, chunk_pad), self.scale(state.step),
            self.plan.buckets[0].k, state.comp_state[0])
        # chunk-local -> global offsets use the unpadded chunk (offset 0
        # for the single bucket; chunk_pad == chunk for multi-chunk plans)
        offs = (torch.arange(n_chunks, dtype=torch.int32,
                             device=flat_g.device) * chunk)[:, None]
        comp = CompressedGrad((r.compressed.indices + offs).reshape(-1),
                              r.compressed.values.reshape(-1))
        words = (pack_wire_words(r.compressed.indices,
                                 r.compressed.values).reshape(-1)
                 if self.wire_fmt is not None else None)
        return (comp, r.residual.reshape(-1),
                r.num_selected.to(torch.int32).reshape(-1), cstate, words)

    def compress_phase(self, state: TrainState, flat_g: torch.Tensor):
        """EF accumulate + per-bucket selection: ``(comp with global
        indices, new residual, nsel [n_buckets], new comp_state [n_buckets]
        or None)``. Writes nothing of ``state``. On the fused path one
        kernel pass (B1) does both, at ``scale(step)``, and the residual is
        the padded EF row; otherwise ``acc = residual + scale * g``
        (``accumulate``) goes through ``compress_buckets``."""
        return self._compress(state, flat_g)[:4]

    def pack_phase(self, state: TrainState, flat_g: torch.Tensor):
        """``compress_phase`` and the wire pack: ``(payload, residual, nsel,
        comp_state)``, where ``payload`` is the tuple of tensors this worker
        hands to the all-gather — ``(words,)`` on the packed wire,
        ``(indices, values)`` on the legacy one. On the packed wire the
        residual absorbs the bf16 rounding in f32: ``values -
        bf16(values)`` is added back at each sent index (indices at or
        above its length dropped), so no rounding error accumulates.
        Writes nothing of ``state``."""
        comp, residual, nsel, cstate, words = self._compress(state, flat_g)
        if self.wire_fmt is None:
            return (comp.indices, comp.values), residual, nsel, cstate
        if words is None:            # unfused: encode from the global pairs
            words = encode_grouped(comp, self.wire_fmt)
        # one worker's valid indices are distinct and its padding values
        # +0.0, so one round of the ordered scatter is the reference's add
        scatter_add_ordered(residual, comp.indices,
                            comp.values - bf16_roundtrip(comp.values),
                            rounds=1)
        return (words,), residual, nsel, cstate

    def unpack(self, gathered: Tuple[torch.Tensor, ...],
               workers: Optional[int] = None) -> CompressedGrad:
        """The (global index, value) pairs of a payload gathered from
        ``workers`` workers (default: the all-gather's group; 1 for a
        worker's own), values as every receiver decodes them and not yet
        averaged."""
        if self.wire_fmt is None:
            return CompressedGrad(*gathered)
        (words,) = gathered
        workers = self.mesh.sizes[-1] if workers is None else workers
        return decode_grouped(words, self.wire_fmt,
                              words.shape[0] // workers)

    def _guard(self, g: LocalGrads):
        """(ok, skipped, nonfinite) on the device, the same on every
        worker: the non-finite gradient entries summed over the workers,
        plus one for a non-finite worker-mean loss. With the guard off
        every step commits and both counts are 0, as in the reference."""
        if not self.guard_nonfinite:
            zero = torch.zeros((), device=g.flat_g.device)
            return torch.ones((), dtype=torch.bool,
                              device=g.flat_g.device), zero, zero
        cnt = (all_reduce_sum((~torch.isfinite(g.flat_g)).sum())
               + (~torch.isfinite(g.loss)).to(torch.int64))
        return cnt == 0, (cnt > 0).float(), cnt.float()

    def _params_if_wd(self, state: TrainState) -> Optional[torch.Tensor]:
        wd = (self.flat_opt or self.optimizer).weight_decay
        return state.params.detach() if wd else None

    def _apply_dense(self, state: TrainState, dense: torch.Tensor):
        """``(updates, new opt_state)`` of an averaged dense gradient, on
        either optimizer."""
        if self.flat_opt is not None:
            upd, m_new = self.flat_opt.dense_step(
                state.opt_state["m"], dense, self._params_if_wd(state),
                state.step)
            return upd, {"m": m_new}
        return self.optimizer.update(state.opt_state, dense,
                                     self._params_if_wd(state))

    def _apply_pairs(self, state: TrainState, idx: torch.Tensor,
                     val: torch.Tensor, rounds: int):
        """``(updates, new opt_state)`` of gathered pairs whose values carry
        the average: ``FlatSGDM`` scatters them into its momentum; the
        optax path scatters them into a dense zero buffer of ``n_total``
        (indices at or above it dropped, the padded tail left zero), sums
        it over the outer mesh axes, and applies the chain."""
        if self.flat_opt is not None:
            upd, m_new = self.flat_opt.sparse_step(
                state.opt_state["m"], idx, val, self._params_if_wd(state),
                state.step, rounds=rounds)
            return upd, {"m": m_new}
        dense = torch.zeros(self.ef_numel, device=val.device)
        scatter_add_ordered(dense[:self.n_total], idx, val, rounds)
        return self.optimizer.update(state.opt_state,
                                     self.mesh.psum(dense, outer_only=True),
                                     self._params_if_wd(state))

    @torch.no_grad()
    def _commit(self, state: TrainState, g: LocalGrads, ok,
                upd: torch.Tensor, opt_new: Dict[str, torch.Tensor],
                residual: torch.Tensor,
                cstate: Optional[torch.Tensor]) -> None:
        """Commit the new training state when ``ok``, else keep the old one
        bit for bit; the step always advances, and so do the optimizer's
        integer leaves (its count), as the reference's ``_guard_commit``
        keeps them."""
        def keep(new, old):
            return torch.where(ok, new, old)
        params = state.params.detach()
        params.copy_(keep(params + upd, params))
        state.opt_state = {k: keep(v, state.opt_state[k])
                           if v.is_floating_point() else v
                           for k, v in opt_new.items()}
        state.ef_residual = keep(residual, state.ef_residual)
        if cstate is not None:
            state.comp_state = keep(cstate, state.comp_state)
        if g.carry is not None:
            state.carry = keep(g.carry, state.carry)
        for name, buf in state.model_state.items():
            buf.copy_(torch.where(ok, buf, g.model_state_before[name]))
        state.step += 1

    # ------------------------------------------------------------ steps
    def sparse_step(self, state: TrainState, batch: Any) -> StepMetrics:
        if self.exchange == "gtopk":
            return self._gtopk_step(state, batch)
        g = self.local_grads(state, batch)
        payload, residual, nsel, cstate = self.pack_phase(state, g.flat_g)
        ok, skipped, nonfinite = self._guard(g)
        got = self.unpack(tuple(self.mesh.gather(t) for t in payload))
        # the 1/P average (P = every worker of the mesh) rides the gathered
        # values; at most one pair of an index a gathered worker carries a
        # value other than +0.0
        upd, opt_new = self._apply_pairs(state, got.indices,
                                         got.values / self.mesh.size,
                                         self.mesh.sizes[-1])
        self._commit(state, g, ok, upd, opt_new, residual,
                     None if cstate is None else cstate[None, :])
        per_bucket = self.mesh.pmean(nsel.float())
        return StepMetrics(
            g.loss, g.aux, per_bucket.sum(),
            float(sum(t.numel() * t.element_size() for t in payload)),
            skipped, nonfinite, torch.linalg.vector_norm(g.flat_g),
            per_bucket)

    def _gtopk_step(self, state: TrainState, batch: Any) -> StepMetrics:
        """The sparse step on the gTop-k butterfly: compress, the global
        pairs, their values divided by P, the global residual."""
        g = self.local_grads(state, batch)
        acc = self.accumulate(state, g.flat_g)
        comp, _, nsel, cstate = self._compress_acc(state, acc)
        ok, skipped, nonfinite = self._guard(g)
        gcomp, comm = gtopk_allreduce(comp, self.wire_fmt)
        gcomp = gcomp._replace(values=gcomp.values / self.mesh.size)
        residual = global_residual(acc, gcomp)
        # the global pairs' indices are distinct wherever the value is not
        # +0.0, so one round of the ordered scatter is the reference's add
        upd, opt_new = self._apply_pairs(state, gcomp.indices, gcomp.values,
                                         1)
        self._commit(state, g, ok, upd, opt_new, residual,
                     None if cstate is None else cstate[None, :])
        per_bucket = self.mesh.pmean(nsel.float())
        return StepMetrics(g.loss, g.aux, per_bucket.sum(),
                           float(comm.bytes_sent), skipped, nonfinite,
                           torch.linalg.vector_norm(g.flat_g), per_bucket)

    def dense_step(self, state: TrainState, batch: Any) -> StepMetrics:
        g = self.local_grads(state, batch)
        ok, skipped, nonfinite = self._guard(g)
        scale = self.scale(state.step)
        dense = g.flat_g if scale == 1.0 else g.flat_g * scale
        upd, opt_new = self._apply_dense(
            state, self.mesh.psum(dense) / self.mesh.size)
        # warm-up is compression-off: the EF row is untouched
        self._commit(state, g, ok, upd, opt_new, state.ef_residual, None)
        dev = g.flat_g.device
        return StepMetrics(
            g.loss, g.aux, torch.tensor(float(self.n_total), device=dev),
            float(self.n_total * 4), skipped, nonfinite,
            torch.linalg.vector_norm(g.flat_g),
            torch.tensor([float(b.size) for b in self.plan.buckets],
                         device=dev))
