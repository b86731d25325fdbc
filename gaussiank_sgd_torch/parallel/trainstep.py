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

Two schedules of the sparse step, chosen when the step is built
(``overlap``, the reference's gate): ``"auto"`` takes the bucket-pipelined
schedule for a uniform plan of two or more buckets (on gtopk with a
gather group of two or more), else the sequential one. The pipelined step
compresses chunk 0, then for each later chunk issues the previous chunk's
collective (``all_gather_async``, or gtopk's round-1 hop) and compresses
the chunk meanwhile; after the loop it issues the last chunk's, waits on
all, and reassembles the received payloads chunk-major -> worker-major,
into exactly the buffer the sequential step's one all-gather makes. Each
chunk is one 1-row call of the batched compressor (B1 on ``[1, chunk]`` on
the fused EF layout), and the host tail of a batched call is independent
across rows, so the two schedules commit the same bits.

``ablate=True`` builds the ``sparse_noexch`` timing twin
(``make_multi_step``, ``make_probes``): the payload all-gather becomes
``x.repeat(P)``, and the dcn sum and gtopk's hops become identities;
every compute op, the reassembly and the byte counts stay. Its numbers
are wrong by construction: it only times (the sparse step less the twin
is the exposed exchange), and never trains.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import contextlib
import dataclasses
import math

import numpy as np
import torch

from ..compressors.base import CompressedGrad, scatter_add_ordered
from ..compressors.randomk import comp_generator
from ..compressors.registry import CompressorSpec
from ..ops.fused_select import pack_wire_words
from .bucketing import BucketPlan
from .collectives import (all_reduce_sum, exchange_with_async, rank,
                          world_size)
from .flat_opt import FlatSGDM, OptaxSGD
from .gtopk import (butterfly_rounds, global_residual, gtopk_allreduce,
                    merge_sparse)
from .mesh import DPMesh, data_parallel_mesh
from .wire import (WIRE_LEGACY, bf16_roundtrip, decode_entries,
                   decode_grouped, encode_entries, encode_grouped,
                   plan_wire_format)


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
    overlapped_bytes_sent: float = 0.0  # the part of bytes_sent issued
                                     # inside the pipelined loop (every
                                     # chunk but the last); 0 on the
                                     # sequential and dense steps
    pipeline_chunks: int = 0         # chunks the pipelined schedule ran; 0
                                     # on the sequential and dense steps
    comm_rounds: int = 1             # collective rounds: log2(P) on a
                                     # gtopk step of P > 1 workers


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
OVERLAPS = ("auto", "off")


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
    power of 2). ``overlap`` is ``"auto"`` (the pipelined schedule where
    the gate admits the plan; ``self.overlap`` says ``"pipelined"``) or
    ``"off"`` (always sequential). A compressor that packs other than k
    slots a bucket (``redsync``'s 2k) is refused on the pipelined
    schedule: the reference's shapes each chunk's payload as k slots and
    fails there.

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

    ``sp_axis`` names the mesh's sequence-parallel axis (``dp_sp_mesh``'s
    ``"sp"``; it must be the last): each worker's batch is a block of the
    sequence and the model inside ``loss_fn`` runs its ring over that
    axis's group. The gradient math is unchanged: every (dp, sp) worker's
    gradient is one of the ``dp * sp`` the exchange averages. A recurrent
    carry is refused with it, and ``flat_opt`` with any 2-D mesh.
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
                 exchange: str = "allgather", guard_nonfinite: bool = True,
                 overlap: str = "auto", sp_axis: Optional[str] = None):
        if exchange not in EXCHANGES:
            raise ValueError(f"unknown exchange {exchange!r}; expected one "
                             f"of {EXCHANGES}")
        if overlap not in OVERLAPS:
            raise ValueError(f"unknown overlap {overlap!r}; expected 'auto' "
                             f"or 'off'")
        self.mesh = mesh if mesh is not None else data_parallel_mesh()
        if sp_axis is not None:
            if sp_axis != self.mesh.names[-1]:
                raise ValueError(f"sp_axis {sp_axis!r} must be the mesh's "
                                 f"last axis {self.mesh.names!r}")
            if recurrent:
                raise ValueError("recurrent carry + sequence parallelism is "
                                 "not supported (carry rows are batch rows)")
        self.sp_axis = sp_axis
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
        # the dense step's sel_per_bucket, on the device once
        self._bucket_sizes = torch.tensor([float(b.size)
                                           for b in plan.buckets],
                                          device=params.device)
        # the reference's gate: a uniform plan of two or more buckets (one
        # payload shape a chunk), and on gtopk a partner for round 1
        self.pipelined = (overlap == "auto" and plan.uniform
                          and len(plan.buckets) >= 2
                          and (exchange != "gtopk"
                               or self.mesh.sizes[-1] >= 2))
        k0 = plan.buckets[0].k
        if (self.pipelined and spec.out_k is not None
                and spec.out_k(k0) != k0):
            raise ValueError(
                f"{spec.name!r} packs {spec.out_k(k0)} slots a bucket, not "
                f"k={k0}: the pipelined schedule shapes each chunk's payload"
                f" as k slots (the reference's fails on it); pass "
                f"overlap='off'")

    @property
    def wire_format(self) -> str:
        """The exchange's format: ``u16bf16`` or ``i32f32``."""
        return self.wire_fmt.name if self.wire_fmt is not None else WIRE_LEGACY

    @property
    def overlap(self) -> str:
        """The sparse step's schedule: ``pipelined`` or ``off``."""
        return "pipelined" if self.pipelined else "off"

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
        _absorb_rounding(residual, comp)
        return (words,), residual, nsel, cstate

    # ------------------------------------------------- pipelined schedule
    def _compress_chunks(self, state: TrainState, flat_g: torch.Tensor):
        """``(compress_one, acc)`` for the pipelined schedule:
        ``compress_one(i)`` runs chunk ``i`` as a 1-row call of the
        machinery ``_compress`` runs over every row at once (B1 on the
        fused EF layout, else the spec's ``batched_fn``, or the compressor
        with bucket ``i``'s generator, as ``compress_buckets`` derives it)
        and returns ``(chunk-local indices [k], values [k], residual row,
        count, new threshold or None)``; ``acc`` is the unfused
        accumulator (None on the fused layout)."""
        spec, n_chunks = self.spec, len(self.plan.buckets)
        chunk, k = self.plan.buckets[0].size, self.plan.buckets[0].k
        st = state.comp_state[0] if spec.stateful else None
        if self.fused_ef is not None:
            # the multi-chunk fused gate keeps chunk_pad == chunk: the
            # padded rows are the chunks
            res2d = state.ef_residual.view(n_chunks, chunk)
            g2d = flat_g.view(n_chunks, chunk)
            scale = self.scale(state.step)

            def compress_one(i):
                r, s = spec.fused_ef_fn(res2d[i:i + 1], g2d[i:i + 1], scale,
                                        k, st[i:i + 1])
                return _row(r, s)
            return compress_one, None
        acc = self.accumulate(state, flat_g)
        pad = n_chunks * chunk - acc.shape[0]
        x = (torch.nn.functional.pad(acc, (0, pad)) if pad
             else acc).view(n_chunks, chunk)
        rng = self.comp_rng(state.step, acc.device)

        def compress_one(i):
            if spec.batched_fn is not None:
                return _row(*spec.batched_fn(
                    x[i:i + 1], k, None if st is None else st[i:i + 1]))
            r, s = _compressor_call(spec, x[i], k,
                                    None if st is None else st[i],
                                    rng(i) if spec.requires_rng else None)
            return (r.compressed.indices, r.compressed.values, r.residual,
                    r.num_selected, s)
        return compress_one, acc

    def _chunk_payload(self, idx: torch.Tensor, val: torch.Tensor,
                       off: int) -> Tuple[torch.Tensor, ...]:
        """One chunk's payload from its chunk-local selection. Packed wire:
        the chunk-local index is the u16 (``encode_entries``), the bucket
        is the chunk's place. Legacy wire: the global (i32, f32) pairs;
        gtopk's hop takes them as one int32 buffer, as its rounds do."""
        if self.wire_fmt is not None:
            return (encode_entries(idx, val),)
        if self.exchange == "gtopk":
            return (torch.cat([idx + off, val.view(torch.int32)]),)
        return (idx + off, val)

    def _launch(self, payload: Tuple[torch.Tensor, ...], i: int,
                ablate: bool) -> list:
        """Issue chunk ``i``'s collective: ``[(out, [handles])]`` a payload
        tensor. gtopk's is its round-1 hop with the partner ``rank ^ 1``,
        tagged by the chunk; the twin's is the identity (gtopk) or the
        tile (all-gather)."""
        if self.exchange == "gtopk":
            if ablate:
                return [(payload[0], [])]
            out, reqs = exchange_with_async(rank() ^ 1, payload[0], tag=i)
            return [(out, reqs)]
        if ablate:
            return [(t.repeat(self.mesh.sizes[-1]), []) for t in payload]
        sent = []
        for t in payload:
            out, work = self.mesh.gather_async(t)
            sent.append((out, [] if work is None else [work]))
        return sent

    def _pipelined_phase(self, state: TrainState, flat_g: torch.Tensor,
                         ablate: bool):
        """EF accumulate and per-chunk compression with chunk i's
        collective issued before chunk i + 1 compresses: ``(comp,
        residual, nsel, cstate, acc, payloads, received)``, the first
        five as ``_compress`` (with ``acc``) makes them, ``payloads`` each
        chunk's tuple of sent tensors and ``received`` each chunk's
        tensors, waited on, stacked chunk-major ``[n_chunks, ...]``. Every
        payload stays referenced until its collective has been waited on.
        Writes nothing of ``state``."""
        n_chunks = len(self.plan.buckets)
        chunk = self.plan.buckets[0].size
        compress_one, acc = self._compress_chunks(state, flat_g)
        parts, payloads, inflight = [], [], []
        for i in range(n_chunks):
            if i:
                inflight.append(self._launch(payloads[-1], i - 1, ablate))
            parts.append(compress_one(i))
            payloads.append(self._chunk_payload(parts[-1][0], parts[-1][1],
                                                i * chunk))
        # the last chunk's collective has no compress left to hide behind
        inflight.append(self._launch(payloads[-1], n_chunks - 1, ablate))
        for sent in inflight:
            for _, handles in sent:
                for h in handles:
                    h.wait()
        received = tuple(torch.stack([sent[j][0] for sent in inflight])
                         for j in range(len(payloads[0])))
        comp = CompressedGrad(
            torch.cat([p[0] + i * chunk for i, p in enumerate(parts)]),
            torch.cat([p[1] for p in parts]))
        residual = torch.cat([p[2] for p in parts])
        if acc is not None:
            residual = residual[:acc.shape[0]]
        nsel = torch.stack([p[3].to(torch.int32) for p in parts])
        cstate = (torch.stack([p[4] for p in parts]) if self.spec.stateful
                  else None)
        return comp, residual, nsel, cstate, acc, payloads, received

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
                     val: torch.Tensor, rounds: int, ablate: bool = False):
        """``(updates, new opt_state)`` of gathered pairs whose values carry
        the average: ``FlatSGDM`` scatters them into its momentum; the
        optax path scatters them into a dense zero buffer of ``n_total``
        (indices at or above it dropped, the padded tail left zero), sums
        it over the outer mesh axes (not in the twin), and applies the
        chain."""
        if self.flat_opt is not None:
            upd, m_new = self.flat_opt.sparse_step(
                state.opt_state["m"], idx, val, self._params_if_wd(state),
                state.step, rounds=rounds)
            return upd, {"m": m_new}
        dense = torch.zeros(self.ef_numel, device=val.device)
        scatter_add_ordered(dense[:self.n_total], idx, val, rounds)
        if not ablate:
            dense = self.mesh.psum(dense, outer_only=True)
        return self.optimizer.update(state.opt_state, dense,
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
        return self._sparse_step(state, batch, ablate=False)

    def _metrics(self, g: LocalGrads, nsel: torch.Tensor, bytes_sent: float,
                 skipped, nonfinite, overlapped: float) -> StepMetrics:
        per_bucket = self.mesh.pmean(nsel.float())
        p = self.mesh.size
        return StepMetrics(
            g.loss, g.aux, per_bucket.sum(), float(bytes_sent), skipped,
            nonfinite, torch.linalg.vector_norm(g.flat_g), per_bucket,
            float(overlapped),
            len(self.plan.buckets) if self.pipelined else 0,
            int(math.log2(p)) if self.exchange == "gtopk" and p > 1 else 1)

    def _sparse_step(self, state: TrainState, batch: Any,
                     ablate: bool) -> StepMetrics:
        """The sparse step on the built schedule; ``ablate`` makes it the
        ``sparse_noexch`` twin (the module docstring)."""
        if self.exchange == "gtopk":
            return self._gtopk_step(state, batch, ablate)
        g = self.local_grads(state, batch)
        if self.pipelined:
            comp, residual, nsel, cstate, _, payloads, received = (
                self._pipelined_phase(state, g.flat_g, ablate))
            if self.wire_fmt is not None:
                _absorb_rounding(residual, comp)
            # [n_chunks, P * slots] chunk-major -> the worker-major
            # [P, n_chunks, slots] buffer the one-shot all-gather makes
            workers = self.mesh.sizes[-1]
            gathered = tuple(
                r.view(r.shape[0], workers, -1).transpose(0, 1).reshape(-1)
                for r in received)
            sizes = [sum(t.numel() * t.element_size() for t in p)
                     for p in payloads]
            sent, overlapped = sum(sizes), sum(sizes[:-1])
        else:
            payload, residual, nsel, cstate = self.pack_phase(state, g.flat_g)
            gathered = tuple(t.repeat(self.mesh.sizes[-1]) if ablate
                             else self.mesh.gather(t) for t in payload)
            sent = sum(t.numel() * t.element_size() for t in payload)
            overlapped = 0
        ok, skipped, nonfinite = self._guard(g)
        got = self.unpack(gathered)
        # the 1/P average (P = every worker of the mesh) rides the gathered
        # values; at most one pair of an index a gathered worker carries a
        # value other than +0.0
        upd, opt_new = self._apply_pairs(state, got.indices,
                                         got.values / self.mesh.size,
                                         self.mesh.sizes[-1], ablate)
        self._commit(state, g, ok, upd, opt_new, residual,
                     None if cstate is None else cstate[None, :])
        return self._metrics(g, nsel, sent, skipped, nonfinite, overlapped)

    def _gtopk_step(self, state: TrainState, batch: Any,
                    ablate: bool) -> StepMetrics:
        """The sparse step on the gTop-k butterfly: compress, the global
        pairs, their values divided by P, the global residual. Pipelined,
        round 1 runs a chunk at a time inside the compress loop and rounds
        2.. on the merged set after it."""
        g = self.local_grads(state, batch)
        overlapped = 0
        if self.pipelined:
            comp, _, nsel, cstate, acc, payloads, (recv,) = (
                self._pipelined_phase(state, g.flat_g, ablate))
            k_packed, n_chunks = comp.indices.shape[0], recv.shape[0]
            round1 = sum(p.numel() * p.element_size() for (p,) in payloads)
            if self.wire_fmt is not None:
                rel, o_val = decode_entries(recv)
                offs = torch.arange(n_chunks, dtype=torch.int32,
                                    device=recv.device)[:, None]
                o_idx = rel + offs * self.plan.buckets[0].size
                # the local half at the precision the partner decodes
                local_val = bf16_roundtrip(comp.values)
            else:
                k = recv.shape[1] // 2
                o_idx = recv[:, :k]
                o_val = recv[:, k:].contiguous().view(torch.float32)
                local_val = comp.values
            idx, val = merge_sparse(comp.indices, local_val,
                                    o_idx.reshape(-1), o_val.reshape(-1),
                                    k_packed)
            idx, val, tail = butterfly_rounds(
                idx, val, self.mesh.size, rank(), self.wire_fmt,
                start_round=1, ablate_comm=ablate)
            gcomp, sent = CompressedGrad(idx, val), round1 + tail
            overlapped = round1 * (n_chunks - 1) // n_chunks
        else:
            acc = self.accumulate(state, g.flat_g)
            comp, _, nsel, cstate = self._compress_acc(state, acc)
            gcomp, comm = gtopk_allreduce(comp, self.wire_fmt,
                                          ablate_comm=ablate)
            sent = comm.bytes_sent
        ok, skipped, nonfinite = self._guard(g)
        gcomp = gcomp._replace(values=gcomp.values / self.mesh.size)
        residual = global_residual(acc, gcomp)
        # the global pairs' indices are distinct wherever the value is not
        # +0.0, so one round of the ordered scatter is the reference's add
        upd, opt_new = self._apply_pairs(state, gcomp.indices, gcomp.values,
                                         1)
        self._commit(state, g, ok, upd, opt_new, residual,
                     None if cstate is None else cstate[None, :])
        return self._metrics(g, nsel, sent, skipped, nonfinite, overlapped)

    def dense_step(self, state: TrainState, batch: Any) -> StepMetrics:
        g = self.local_grads(state, batch)
        ok, skipped, nonfinite = self._guard(g)
        scale = self.scale(state.step)
        dense = g.flat_g if scale == 1.0 else g.flat_g * scale
        upd, opt_new = self._apply_dense(
            state, self.mesh.psum(dense) / self.mesh.size)
        # warm-up is compression-off: the EF row is untouched
        self._commit(state, g, ok, upd, opt_new, state.ef_residual, None)
        # no host-to-device copy here: on the card it would wait for the
        # step's queued kernels, and the host could not run ahead
        return StepMetrics(
            g.loss, g.aux,
            torch.full((), float(self.n_total), device=g.flat_g.device),
            float(self.n_total * 4), skipped, nonfinite,
            torch.linalg.vector_norm(g.flat_g), self._bucket_sizes.clone())

    # ------------------------------------------------ bench and probes
    def make_multi_step(self, kind: str, n: int) -> Callable:
        """``run(state, batch) -> (state, metrics of the last step)``: ``n``
        steps of ``kind`` in one call, on ``state`` (updated in place):
        ``sparse``, ``dense``, or ``sparse_noexch``, the twin
        (``benchlib`` times the sparse step less it)."""
        fns = {"sparse": self.sparse_step, "dense": self.dense_step,
               "sparse_noexch": lambda state, batch: self._sparse_step(
                   state, batch, ablate=True)}
        if kind not in fns:
            raise ValueError(f"unknown multi-step kind {kind!r}")
        fn = fns[kind]

        def run(state: TrainState, batch: Any):
            m = None
            for _ in range(n):
                m = fn(state, batch)
            return state, m
        return run

    @contextlib.contextmanager
    def kept(self, state: TrainState,
             generator: Optional[torch.Generator] = None):
        """A copy of ``state`` to run on, whose writes to the model's
        parameter and float buffers (shared with ``state``) are undone on
        exit, as is any draw from ``generator`` (the model's dropout
        generator); every other tensor a step replaces, so the caller's
        state is left as it was."""
        params = state.params.detach().clone()
        bufs = {k: v.clone() for k, v in state.model_state.items()}
        gen_state = generator.get_state() if generator is not None else None
        try:
            yield dataclasses.replace(state)
        finally:
            with torch.no_grad():
                state.params.copy_(params)
                for k, v in bufs.items():
                    state.model_state[k].copy_(v)
            if generator is not None:
                generator.set_state(gen_state)

    def make_probes(self, generator: Optional[torch.Generator] = None
                    ) -> Dict[str, Callable]:
        """The phase-timing probes, ``(state, batch) ->``: ``grads``, the
        forward and backward folded to a scalar; ``select``, that and the
        compress phase (the sequential one, on either schedule) folded to
        a scalar; ``noexch``, the ``sparse_noexch`` twin of the step,
        ``(state copy, metrics)``. None writes the caller's state or moves
        ``generator``, the model's dropout generator (``kept``), so a run's
        dropout masks are the same with the probes as without."""
        def grads(state, batch):
            with self.kept(state, generator) as st:
                g = self.local_grads(st, batch)
                return (self.mesh.pmean(torch.linalg.vector_norm(g.flat_g))
                        + 0.0 * g.loss)

        def select(state, batch):
            with self.kept(state, generator) as st:
                g = self.local_grads(st, batch)
                comp, residual, nsel, _ = self.compress_phase(st, g.flat_g)
                sink = (nsel.sum().float() + comp.values.sum()
                        + residual[:1].sum() + residual[-1:].sum())
                return self.mesh.pmean(sink) + 0.0 * g.loss

        def noexch(state, batch):
            with self.kept(state, generator) as st:
                return st, self._sparse_step(st, batch, ablate=True)

        return {"grads": grads, "select": select, "noexch": noexch}


def _row(r, s):
    """Row 0 of a 1-row batched compressor call: ``(indices, values,
    residual row, count, new threshold)``."""
    return (r.compressed.indices[0], r.compressed.values[0], r.residual[0],
            r.num_selected.reshape(-1)[0], s[0])


def _absorb_rounding(residual: torch.Tensor, comp: CompressedGrad) -> None:
    """The packed wire's EF correction, in f32 in place: ``values -
    bf16(values)`` added back at each sent index (indices at or above the
    residual's length dropped), so no rounding error accumulates. One
    worker's valid indices are distinct and its padding values +0.0, so
    one round of the ordered scatter is the reference's add."""
    scatter_add_ordered(residual, comp.indices,
                        comp.values - bf16_roundtrip(comp.values), rounds=1)
