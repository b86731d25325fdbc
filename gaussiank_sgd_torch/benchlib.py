"""Benchmark machinery: the port of ``gaussiank_sgd_tpu/benchlib.py``.

The method is the reference's. Every program is a ``make_multi_step``
call of ``n_steps`` steps on a fresh state; its time is taken with CUDA
events around the call and a ``torch.cuda.synchronize()`` after it (the
host clock on the CPU), divided by ``n_steps``. The programs of one cell
(dense and sparse, or the sequential and pipelined schedules with their
``sparse_noexch`` twins) run in interleaved rounds whose order rotates from
round to round, so drift of the card's speed lands on every program
alike; each program reports its min over rounds, and two programs are
compared by the median of their per-round differences
(``paired_delta_ms``), floored at the rounds' own noise
(``noise_floored_delta_ms``).

``bench_model`` and ``bench_overlap`` run on the card (``device="cuda"``,
the default) or where the caller says; they never fall back to the CPU.
MFU's FLOPs are ``FlopCounterMode``'s count of the matmuls and
convolutions of one call, where the reference reads XLA's cost analysis
of the compiled program (which also counts elementwise work).
"""

from __future__ import annotations

import statistics
import time
from typing import Callable, Dict, Optional, Sequence

import torch

# Dense bf16 tensor-core peak FLOP/s of one card, by the start of its
# ``torch.cuda.get_device_name()``: NVIDIA's data sheets, each figure
# quoted "with sparsity" halved. Longest prefix first.
PEAK_FLOPS_BY_NAME = (
    ("NVIDIA H100 PCIe", 756.5e12),
    ("NVIDIA H100 NVL", 835.5e12),
    ("NVIDIA H100", 989.4e12),         # SXM5 (80GB HBM3)
)


def device_peak_flops(device=None) -> Optional[float]:
    """The card's dense bf16 peak FLOP/s, or None on the CPU or for a card
    the table does not hold (then no MFU). ``device`` defaults to the
    current CUDA device, if there is one."""
    if device is None:
        if not torch.cuda.is_available():
            return None
        device = torch.device("cuda")
    device = torch.device(device)
    if device.type != "cuda":
        return None
    name = torch.cuda.get_device_name(device)
    for prefix, peak in PEAK_FLOPS_BY_NAME:
        if name.startswith(prefix):
            return peak
    return None


def program_flops(fn: Callable, *args) -> Optional[float]:
    """FLOPs of one call ``fn(*args)``: ``FlopCounterMode``'s analytic
    count of its matmuls and convolutions, forward and backward, from
    their shapes (None when it counts none). The call runs: pass a copy of
    any state it writes."""
    from torch.utils.flop_counter import FlopCounterMode
    with FlopCounterMode(display=False) as counter:
        fn(*args)
    flops = counter.get_total_flops()
    return float(flops) if flops else None


def mfu(flops_per_step: Optional[float], step_seconds: float,
        peak: Optional[float]) -> Optional[float]:
    """Model-FLOPs utilization; None when FLOPs or peak are unknown."""
    if not flops_per_step or not peak or step_seconds <= 0:
        return None
    return flops_per_step / (step_seconds * peak)


def paired_delta_ms(rounds: dict, a: str, b: str) -> Optional[float]:
    """The median over rounds of the per-round ``a_r - b_r``, in ms,
    rounded to 3 decimals. Every program runs in every rotated round, so
    the paired median cancels the drift that min-of-rounds differences
    carry. None when the two have different round counts (a partial run
    would misalign the pairs) or none."""
    ra, rb = rounds.get(a, []), rounds.get(b, [])
    if not ra or len(ra) != len(rb):
        return None
    pairs = [1e3 * (x - y) for x, y in zip(ra, rb)]
    return round(statistics.median(pairs), 3)


def noise_floored_delta_ms(rounds: dict, a: str, b: str) -> Optional[float]:
    """``paired_delta_ms`` as a duration, which is never negative: the
    paired median when it exceeds the noise floor, the median absolute
    deviation of the same per-round differences, else None ("< noise").
    With one round there is no dispersion, and only the sign rule
    applies."""
    ra, rb = rounds.get(a, []), rounds.get(b, [])
    if not ra or len(ra) != len(rb):
        return None
    pairs = [1e3 * (x - y) for x, y in zip(ra, rb)]
    med = statistics.median(pairs)
    if med <= 0:
        return None
    if len(pairs) >= 2:
        mad = statistics.median([abs(p - med) for p in pairs])
        if med <= mad:
            return None
    return round(med, 3)


def ablation_specs() -> dict:
    """Probe compressors that run a prefix of the sparse step, for the
    phase decomposition; bench probes only, never reachable from a
    training config.

    ``ef_only``: the EF accumulate and the exchange of a fixed k-slice (no
    selection), the floor every sparse step pays; a selector's delta over
    it is its select + pack. ``sel_nores``: ``|acc|`` in bf16, its top-k
    and the gather, but no residual scatter (EF-incorrect, measurement
    only). The reference takes ``approx_max_k`` there; the port takes the
    exact top-k (``compressors/exact.py``), as it does for
    ``approxtopk16``."""
    from .compressors.base import CompressedGrad, CompressResult, magnitude_key
    from .compressors.registry import CompressorSpec

    def ef_only(acc, k):
        idx = torch.arange(k, dtype=torch.int32, device=acc.device)
        residual = acc.clone()
        residual[:k] = 0.0
        return CompressResult(CompressedGrad(idx, acc[:k].clone()), residual,
                              torch.full((), k, dtype=torch.int32,
                                         device=acc.device))

    def sel_nores(acc, k):
        idx = torch.topk(magnitude_key(acc, bf16=True), k,
                         sorted=True).indices.to(torch.int32)
        return CompressResult(CompressedGrad(idx, acc[idx]), acc,
                              torch.full((), k, dtype=torch.int32,
                                         device=acc.device))

    return {
        "ef_only": CompressorSpec("ef_only", ef_only, False, True,
                                  lambda k: k),
        "sel_nores": CompressorSpec("sel_nores", sel_nores, False, True,
                                    lambda k: k),
    }


def make_batch(spec, batch_size: int,
               generator: Optional[torch.Generator] = None,
               device=None) -> tuple:
    """A synthetic ``(x, y)`` batch of the model's task, drawn from
    ``generator`` (a CPU one; default seeded 0) and moved to ``device``:
    the reference's shapes, dtypes and ranges. ``classify``: f32 normal
    images, int32 labels in ``[0, classes)``; ``lm``: int32 tokens and
    targets in ``[0, vocab)``; ``seq2seq``: int32 source and target in
    ``[1, vocab)``; ``ctc``: f32 normal spectrograms, 16 int32 labels a row
    in ``[1, labels)``."""
    gen = (torch.Generator().manual_seed(0) if generator is None
           else generator)
    n, shape = batch_size, tuple(spec.input_shape)
    if spec.task == "classify":
        x = torch.randn((n,) + shape, generator=gen)
        y = torch.randint(0, spec.num_classes, (n,), generator=gen)
    elif spec.task in ("lm", "seq2seq"):
        lo = 0 if spec.task == "lm" else 1
        x = torch.randint(lo, spec.num_classes, (n, shape[0]), generator=gen)
        y = torch.randint(lo, spec.num_classes, (n, shape[0]), generator=gen)
    elif spec.task == "ctc":
        x = torch.randn((n,) + shape, generator=gen)
        y = torch.randint(1, spec.num_classes, (n, 16), generator=gen)
    else:
        raise ValueError(spec.task)
    ids = (torch.int64, torch.int32)
    return tuple(t.to(torch.int32 if t.dtype in ids else t.dtype).to(device)
                 for t in (x, y))


def _run_once(multi_step, mk_state, batch, n_steps) -> float:
    """Seconds a step of one ``multi_step`` call on a fresh state: CUDA
    events around the call and a synchronise after it on the card, the
    host clock on the CPU."""
    state = mk_state()
    cuda = batch[0].device.type == "cuda"
    if cuda:
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        multi_step(state, batch)
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / 1e3 / n_steps
    t0 = time.perf_counter()
    multi_step(state, batch)
    return (time.perf_counter() - t0) / n_steps


def _time_programs(programs, batch, n_steps, rounds, windows):
    """Interleaved rotated-round timing over ``name -> (multi_step,
    mk_state)``: ``(min seconds, per-round samples, the samples grouped by
    window)`` a program. The order within a round rotates continuously
    across rounds and windows, so no program always takes the first
    slot."""
    out = {k: float("inf") for k in programs}
    round_times = {k: [] for k in programs}
    window_times = {k: [] for k in programs}
    names = list(programs)
    for w in range(max(1, int(windows))):
        wt = {k: [] for k in programs}
        for r in range(rounds):
            g = w * rounds + r
            for name in names[g % len(names):] + names[:g % len(names)]:
                fn, mk = programs[name]
                t = _run_once(fn, mk, batch, n_steps)
                wt[name].append(t)
                round_times[name].append(t)
                out[name] = min(out[name], t)
        for k in programs:
            window_times[k].append(wt[k])
    return out, round_times, window_times


def _arm(model: str, dataset: str, batch_size: int, dtype, model_kwargs,
         device, comp, density, bucket_size, bucket_policy,
         overlap: str = "auto"):
    """One program arm: its own model (seed 0; the flat parameter padded as
    ``comp`` and the plan need), its step (``FlatSGDM(lr=0.1,
    momentum=0.9)``), and ``mk_state``, which puts the initial weights and
    statistics back and returns a fresh state: ``(model spec, step,
    mk_state)``."""
    from .models import get_model
    from .parallel.bucketing import plan_for_params
    from .parallel.flat_opt import FlatSGDM
    from .parallel.trainstep import DPTrainStep, flat_numel
    from .training.losses import make_loss_fn
    spec = get_model(model, dataset, dtype=dtype, device=device, seed=0,
                     **(model_kwargs or {}))
    net = spec.module
    plan = plan_for_params(net.param_layout, density, bucket_size,
                           policy=bucket_policy)
    net.pad_flat(flat_numel(comp, plan))
    recurrent = model == "lstm"
    ts = DPTrainStep(make_loss_fn(net, spec.task, recurrent=recurrent),
                     net.flat, {"stats": net.stats}, comp, plan,
                     flat_opt=FlatSGDM(lr=0.1, momentum=0.9),
                     recurrent=recurrent, overlap=overlap)
    p0, s0 = net.flat.detach().clone(), net.stats.clone()

    def mk():
        with torch.no_grad():
            net.flat.copy_(p0)
            net.stats.copy_(s0)
        return ts.init_state(net.initial_carry(batch_size) if recurrent
                             else None)
    return spec, ts, mk


def _shard(spec, batch_size: int, device) -> tuple:
    """This worker's rows, on ``device``, of a global batch of
    ``batch_size`` rows a worker drawn by ``make_batch``."""
    from .parallel.collectives import rank, world_size
    from .parallel.mesh import shard_batch
    world = world_size()
    x, y = make_batch(spec, batch_size * world)
    return tuple(t.to(device) for t in shard_batch((x, y), rank(), world))


def bench_model(model: str, dataset: str, batch_size: int, density: float,
                compressors: Sequence[str], n_steps: int, rounds: int = 8,
                windows: int = 1, include_dense: bool = True,
                model_kwargs: Optional[dict] = None,
                dtype=torch.bfloat16, bucket_policy: str = "greedy",
                bucket_size: Optional[int] = None,
                device="cuda") -> Dict[str, object]:
    """Seconds a step of the dense program and of each compressor's sparse
    program on one model (``batch_size`` a worker), in ``windows`` blocks
    of ``rounds`` interleaved rotated rounds. Timing keys: ``dense`` and
    the compressor names (``ablation_specs``' probes included).
    Underscored keys are not timings: ``_rounds`` (every round's sample,
    a list a program), ``_windows`` (the same grouped by window),
    ``_exchange`` (a compressor's wire format, schedule, plan total_k and
    the warm run's measured ``bytes_sent``), ``_dense_step_flops`` and
    ``_peak_flops`` (MFU's inputs)."""
    from .compressors import get_compressor
    from .device import resolve_device
    dev = resolve_device(device)
    probes = ablation_specs()
    programs, exchange_meta = {}, {}
    dense_ts = dense_mk = None
    batch = None
    for name in compressors:
        comp = probes.get(name) or get_compressor(name, density=density)
        spec, ts, mk = _arm(model, dataset, batch_size, dtype, model_kwargs,
                            dev, comp, density, bucket_size, bucket_policy)
        if batch is None:
            batch = _shard(spec, batch_size, dev)
        if include_dense and "dense" not in programs:
            programs["dense"] = (ts.make_multi_step("dense", n_steps), mk)
            dense_ts, dense_mk = ts, mk
        programs[name] = (ts.make_multi_step("sparse", n_steps), mk)
        exchange_meta[name] = {"wire_format": ts.wire_format,
                               "overlap": ts.overlap,
                               "total_k": int(ts.plan.total_k)}
    for name, (fn, mk) in programs.items():      # warm up, drain the bytes
        _, m = fn(mk(), batch)
        float(m.loss)
        if name in exchange_meta:
            exchange_meta[name]["bytes_sent"] = int(m.bytes_sent)
    out, round_times, window_times = _time_programs(
        programs, batch, n_steps, rounds, windows)
    result: Dict[str, object] = dict(out)
    result["_rounds"] = round_times
    result["_windows"] = window_times
    result["_exchange"] = exchange_meta
    if include_dense and dense_ts is not None:
        # model FLOPs of a dense step, every program's MFU numerator
        result["_dense_step_flops"] = program_flops(
            dense_ts.dense_step, dense_mk(), batch)
        result["_peak_flops"] = device_peak_flops(dev)
    return result


def bench_overlap(model: str, dataset: str, batch_size: int,
                  density: float, compressor: str, n_steps: int,
                  rounds: int = 4, windows: int = 1,
                  bucket_size: int = 1 << 22,
                  model_kwargs: Optional[dict] = None,
                  dtype=torch.bfloat16, device="cuda") -> Dict[str, object]:
    """One model and selector under both step schedules on one uniform
    plan of ``bucket_size`` chunks, each with its ``sparse_noexch`` twin,
    the four programs in the same rotated rounds. Timing keys: ``seq``,
    ``seq_noexch`` (``overlap="off"``), ``pipe``, ``pipe_noexch``
    (``"auto"``). ``exposed_exchange_ms`` a schedule is
    ``noise_floored_delta_ms`` of the program against its twin (None: below
    the rounds' noise). ``_meta``: the plan's bucket count and total_k,
    each build's schedule (``auto`` must say ``pipelined``; the caller
    checks), the wire format, each schedule's measured ``bytes_sent`` and
    the pipelined one's ``overlapped_bytes_sent``."""
    from .compressors import get_compressor
    from .device import resolve_device
    dev = resolve_device(device)
    programs = {}
    meta: Dict[str, object] = {"bucket_size": bucket_size}
    batch = None
    for arm, overlap in (("seq", "off"), ("pipe", "auto")):
        spec, ts, mk = _arm(model, dataset, batch_size, dtype, model_kwargs,
                            dev, get_compressor(compressor, density=density),
                            density, bucket_size, "uniform", overlap)
        if batch is None:
            batch = _shard(spec, batch_size, dev)
            meta["n_buckets"] = len(ts.plan.buckets)
            meta["total_k"] = int(ts.plan.total_k)
        meta[f"{arm}_overlap"] = ts.overlap
        meta.setdefault("wire_format", ts.wire_format)
        programs[arm] = (ts.make_multi_step("sparse", n_steps), mk)
        programs[f"{arm}_noexch"] = (
            ts.make_multi_step("sparse_noexch", n_steps), mk)
    for arm in ("seq", "pipe"):                   # warm up, drain the meta
        fn, mk = programs[arm]
        _, m = fn(mk(), batch)
        float(m.loss)
        meta[f"{arm}_bytes_sent"] = int(m.bytes_sent)
        if arm == "pipe":
            meta["overlapped_bytes_sent"] = int(m.overlapped_bytes_sent)
        fn_nx, mk_nx = programs[f"{arm}_noexch"]
        _, m = fn_nx(mk_nx(), batch)
        float(m.loss)
    out, round_times, window_times = _time_programs(
        programs, batch, n_steps, rounds, windows)
    result: Dict[str, object] = {k: out[k] for k in programs}
    result["_rounds"] = round_times
    result["_windows"] = window_times
    result["_meta"] = meta
    result["exposed_exchange_ms"] = {
        "seq": noise_floored_delta_ms(round_times, "seq", "seq_noexch"),
        "pipe": noise_floored_delta_ms(round_times, "pipe", "pipe_noexch"),
    }
    return result
