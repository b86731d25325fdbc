#!/usr/bin/env python3
"""Smoke test of the PyTorch port (``gaussiank_sgd_torch``) on one GPU.

Run from the repository root, with no arguments: ``python3 chip_smoke.py``.
It needs one CUDA device and ``nvcc``; it exits nonzero, printing no result,
when either is missing or any phase fails. Phases, one output line each:

1. the card's ``name, power.limit`` as ``nvidia-smi`` gives them;
2. the kernel build (one ``nvcc`` for sm_90a per ``csrc/`` source, started
   together), with its seconds, and B4's registers, spills and shared
   memory from ``-Xptxas -v`` (at most 64 registers);
3. kernel B1 (fused EF accumulate + candidate select) against its plain
   PyTorch version on the card at VGG-16's padded shape [1, 15,073,280],
   cold (t = 0) and warm (t > 0): acc, values, indices and counts must be
   bit-identical; its device time per call (CUDA events around replays of
   a CUDA graph of 20 calls, so the host's launch overhead is left out) and
   the median of 20 eager calls (CUDA events, launch included) beside its
   bound and its plain version's device time;
4. kernel B2 (candidate select) the same way at [1, n] and [4, 65536];
5. kernels B3 (sum, sum of squares, max|x|) and B4 (counts over 32
   thresholds) at [n] = [14,986,698]: B3's max bit for bit and its sums
   within the summation-order tolerance, a second B3 launch bit-identical,
   B4's counts bit for bit on the estimate's log-spaced and linear
   candidates and on a skewed input (every |x| in one bin, so every
   element takes B4's whole search); their times beside their bounds, B4's
   on each of those three inputs, and B3's beside the three library
   reductions it replaces;
6. the main path: BASELINE config 2 (VGG-16 / CIFAR-shaped synthetic data,
   full width, batch 128, bf16, density 0.001) through ``Trainer``, with
   every launch count zeroed just before each run and read just after:
   a. ``gaussian_fused`` for 2 dense + 4 sparse steps, then one call of the
      registry's flat ``gaussian_fused`` on the run's EF residual: B1 once
      per sparse step, B2 at least once; then the EF invariant
      ``decompress(sent) + residual == acc`` of one more sparse step, bit
      for bit; then 3 sparse steps under ``torch.profiler``;
   b. ``gaussian_pallas`` (the unfused step) for 2 dense + 4 sparse steps:
      B3 exactly 4 and B4 exactly 8 times, no B1 or B2, every sparse
      step's num_selected within 5% of k, then the EF invariant of one more
      sparse step;
   c. config 2 as shipped (``gaussian``) for 2 dense + 2 sparse steps and
      the EF invariant of one more step; every compressor call of the run
      replayed on the CPU from the card's Gaussian estimate, whose
      num_selected, indices and values must equal the card's exactly; a
      count outside the 5% band its ten bisection passes aim at prints each
      pass's count, the witness that the passes ran out;
   d. ``gaussian_warm`` (one host sync a sparse step) for 2 dense + 4
      sparse steps: the same, with a cold first sparse step;
   b, c and d end with 3 more sparse steps under ``torch.profiler``;
   then config 2 with ``gaussian_fused`` again from the same seed, whose
   first loss must repeat bit for bit; and two small narrow-VGG f32 runs
   (``gaussian_fused``, and ``gaussian_pallas`` on a uniform bucket plan)
   that must agree with the same runs on the CPU (the kernels' plain
   versions);
7. the exchange (``torch.distributed``) on this one card:
   a. B1 at the uniform plan's shape [229, 65,536], bit for bit and timed;
   b. config 2 with ``gaussian_fused`` for 2 dense + 3 sparse steps on two
      plans, the whole-model bucket (legacy (i32, f32) wire) and 65,536-
      element uniform buckets (packed u16|bf16 wire), each first without a
      process group and then in an NCCL group of one (``parallel/mesh.py``,
      a FileStore): losses, params, momentum, EF row and thresholds bit
      for bit between the two, bytes_sent as the wire says, B1 once a
      sparse step, num_selected = k on the cold first sparse step (as on
      the main path), and the EF invariant of one more step against the
      decoded wire
      values; then the device time of one all-gather of each payload and
      of the 60 MB dense all-reduce;
   c. the ordered scatter: 8 payloads of 15,114 pairs whose coordinates
      repeat across payloads, with padding slots, into a 15M momentum,
      twice on the card and once on the CPU, bit for bit; its time beside
      one plain ``index_add_`` (whose duplicates the card adds in no fixed
      order);
   d. two workers on this card, one process each, in a gloo group (CUDA
      tensors): config 2 on the uniform plan for 1 dense + 2 sparse steps,
      both ranks' parameters bit-identical after every step;
8. the ResNet family:
   a. BASELINE config 1 as shipped (resnet20, dense, bf16, batch 128) for
      5 steps; its first loss again from the same seed, bit for bit; and
      resnet20 in f32 at batch 8 for 2 steps, card against CPU;
   b. B1 at ResNet-50's padded EF row [1, 25,559,040] as in phase 3;
   c. BASELINE config 3 (ResNet-50, synthetic ImageNet-shaped uint8 data at
      224^2, batch 64, bf16, density 0.001) at one worker with
      ``gaussian_fused`` for 2 dense + 4 sparse steps, then the registry's
      flat call on its EF row: B1 once a sparse step, num_selected = k on
      the cold step, bytes_sent k x 8 B (the legacy wire), the EF
      invariant, the peak device memory; B2 at the flat call's shape
      [1, 25,557,032] bit for bit and timed as in phase 4; then 3 sparse
      steps under ``torch.profiler``;
   d. config 3 as shipped (``gaussian``) for 2 dense + 2 sparse steps:
      num_selected within 5% of k, the EF invariant, and the CPU replay of
      6c;
   e. config 3 with ``gaussian_pallas`` for 2 dense + 4 sparse steps: B3
      exactly 4 and B4 exactly 8 times, num_selected within 5% of k, the EF
      invariant; then B3 and B4 at [25,557,032] on the run's EF row as in
      phase 5;
9. the training loop as users run it (every run up to here takes its
   steps through ``Trainer.train``, without eval passes or checkpoints):
   a. config 3 with ``gaussian_fused`` through ``Trainer.fit()`` for 20
      steps (1,024 synthetic images a split, 16 steps an epoch), an eval
      pass and a checkpoint every epoch, written to a temporary directory:
      eval lines at steps 16 and 20 over 1,024 images (val_loss finite,
      top1 <= top5 in [0, 1]), sealed checkpoints at steps 16 and 20, B1
      once a sparse step; each eval pass's wall time and images/s, each
      checkpoint's bytes and save time;
   b. a fresh trainer resumed from step 16 runs steps 17-20: its losses
      and, at step 20, its params, momentum, EF row (pad zero), thresholds
      and BatchNorm statistics equal the uninterrupted run's bit for bit
      (cuDNN pinned deterministic by ``device.py``); the restore's time;
   c. config 3 with ``--nsteps-update 2 --clip-norm 1.0`` for 2 dense + 2
      sparse steps of two 64-row microbatches: every post-clip gradient
      norm within 1.0 x (1 + 1e-6), the EF invariant exact on one more
      sparse step, peak memory beside phase 8c's;
   d. config 1 (resnet20, f32) after 2 steps, the same state evaluated on
      the card and on the CPU over 512 test images: top1 and top5 equal,
      val_loss within 1e-4;
10. a ``{"kernels": [...]}`` line with each kernel's launches, error,
   device time (``ms``), eager call time (``call_ms``), plain-version time,
   bound and library time; B4's ``ms`` is on the linear candidates, with
   ``ms_log`` and ``call_ms_log`` on the log-spaced ones; B1 also at
   [229, 65,536] and its launches on the exchange runs; under
   ``resnet50`` each kernel's launches on config 3's runs and B1's, B2's,
   B3's and B4's times at ResNet-50's shapes; under ``training_loop`` B1's
   launches on phase 9's runs.

The last line is ``{"ok": true, "device": {...}}``. ``--worker RANK WORLD
DIR`` runs one rank of phase 7d (the script starts those processes
itself).
"""

from __future__ import annotations

import contextlib
import hashlib
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))
RUN_DIR = os.path.join(REPO, "chiprun_out", "chip_smoke")
CONFIG1 = os.path.join(REPO, "exp_configs",
                       "config1_resnet20_cifar10_dense.json")
CONFIG2 = os.path.join(REPO, "exp_configs",
                       "config2_vgg16_cifar10_gaussian.json")
CONFIG3 = os.path.join(REPO, "exp_configs",
                       "config3_resnet50_imagenet_gaussian.json")
# ResNet-50's n, k at density 0.001 and its padded EF row
RESNET50 = (25_557_032, 25_558, 25_559_040)
NARROW = [8, "M", 8, "M", 16, "M", 16, "M", 16, "M"]
# the exchange phase's plans: flags over config 2
PLANS = {"whole bucket": [],
         "uniform 65536": ["--bucket-size", "65536", "--bucket-policy",
                           "uniform"]}
EXCHANGE_ARGV = ["--compressor", "gaussian_fused", "--max-steps", "5",
                 "--compress-warmup-steps", "2"]
# each plan's wire, bytes a sent entry and fused EF layout (n_chunks,
# chunk, chunk_pad) at config 2's full width
EXCHANGE_WANT = {"whole bucket": ("i32f32", 8, (1, 14_986_698, 15_073_280)),
                 "uniform 65536": ("u16bf16", 4, (229, 65_536, 65_536))}

# device-memory rate by card name (bytes/s), from NVIDIA's data sheets
_MEM_RATE = (("H100 PCIe", 2.0e12), ("H100 NVL", 3.9e12), ("H200", 4.8e12),
             ("H100", 3.35e12))
_F32_RATE = 67e12        # H100 SXM f32 outside the tensor cores, op/s
# operations per element of each kernel
_OPS_SELECT = 8          # B1/B2: abs, compare, key mask/or, max, count
                         # (+ mul, add)
_OPS_STATS = 4           # B3: add, multiply-add (2), max of |x|
_OPS_COUNTS = 65         # B4's function as 32 compare-and-counts: abs, 32
                         # compares, 32 adds (its binary search does less;
                         # the bound is by bytes either way)


def _mem_rate(name: str) -> float:
    for key, rate in _MEM_RATE:
        if key in name:
            return rate
    raise RuntimeError(f"no memory rate known for {name!r}")


def _bound_ms(n_bytes: int, n_ops: int, mem_rate: float):
    t_bytes = n_bytes / mem_rate * 1e3
    t_ops = n_ops / _F32_RATE * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _median_ms(fn, reps: int) -> float:
    import torch
    fn()                                       # warm-up
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _device_ms(fn, reps: int = 20) -> float:
    """Device time of one ``fn()``: ``reps`` calls captured in one CUDA
    graph, the graph replayed 5 times between CUDA events, the median
    replay over ``reps``. Unlike ``_median_ms`` this leaves out the host's
    time to launch (Python, argument checks, ctypes), which at these sizes
    is as long as the kernels themselves."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()                                   # warm-up off the capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(5):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    del graph
    return statistics.median(times)


def _time_kernel(what: str, kernel_fn, plain_fn, bound, lib_fn=None,
                 lib_what: str = "") -> dict:
    """Time a kernel's wrapper, its plain version and, where there is one,
    the library composition computing the same, and print them beside the
    bound: ``ms`` is device time (``_device_ms``), ``call_ms`` the eager
    call with its host launch overhead (``_median_ms``)."""
    bound_ms, bound_by = bound
    out = {"ms": _device_ms(kernel_fn, 20),
           "call_ms": _median_ms(kernel_fn, 20),
           "plain_ms": _device_ms(plain_fn, 5),
           "bound_ms": bound_ms, "bound_by": bound_by,
           "library_ms": _device_ms(lib_fn, 20) if lib_fn else None}
    lib = (f", library {lib_what} {out['library_ms']:.4f} ms" if lib_fn
           else "")
    print(f"phase {what} time: {out['ms']:.4f} ms device time per call "
          f"(bound {bound_ms:.4f} ms by {bound_by}, "
          f"{bound_ms / out['ms']:.0%} of it); {out['call_ms']:.4f} ms per "
          f"eager call with its launch; plain version {out['plain_ms']:.4f} "
          f"ms{lib}")
    return out


def _b1_phase(n: int, density: float, gen, mem_rate: float):
    """Kernel B1 at a model's padded EF row ``[1, chunk_pad]`` (random
    residual and gradient on the first ``n`` elements, a zero tail), cold
    (t = 0) and warm (t > 0): acc, values, indices and counts bit for bit
    against its plain version, then timed. Returns ``(times, max abs
    error, res, g, warm threshold)``."""
    import torch
    from gaussiank_sgd_torch.compressors import k_for
    from gaussiank_sgd_torch.ops import fused_select as fs
    dev = gen.device
    k = k_for(n, density)
    R, _, bpc, nc = fs._chunk_geometry(n, density)
    chunk_pad = bpc * R * 128
    res = torch.zeros(1, chunk_pad, device=dev)
    g = torch.zeros(1, chunk_pad, device=dev)
    res[:, :n] = torch.randn(1, n, device=dev, generator=gen) * 0.01
    g[:, :n] = torch.randn(1, n, device=dev, generator=gen) * 0.01
    cold = torch.zeros(1, device=dev)
    _, warm = fs.gaussian_fused_ef_compress_batched(res, g, 1.0, k, cold,
                                                    density=density)
    err = 0.0
    for name, t in (("cold", cold), ("warm", warm)):
        out = fs.fused_ef_select_candidates_chunked(res, g, 1.0, t, density)
        ref = fs.fused_ef_select_plain(res, g, 1.0, t, density)
        torch.cuda.synchronize()
        err = max(err, _same(out, ref, f"B1 [1, {chunk_pad}] {name}"))
        print(f"phase B1 [1, {chunk_pad}] {name}: t={float(t[0]):.6g} "
              f"count={int(out[3][0])} bit-identical (acc, vals, idx, "
              f"counts)")
    times = _time_kernel(
        f"B1 [1, {chunk_pad}]",
        lambda: fs.fused_ef_select_candidates_chunked(res, g, 1.0, warm,
                                                      density),
        lambda: fs.fused_ef_select_plain(res, g, 1.0, warm, density),
        _bound_ms(3 * chunk_pad * 4 + nc * 8 + 8, _OPS_SELECT * chunk_pad,
                  mem_rate))
    return times, err, res, g, warm


def _b3_b4_phase(flat, k: int, mem_rate: float):
    """Kernels B3 and B4 at ``[n]`` on ``flat``: B3's max bit for bit and
    its sums within the summation-order tolerance, a second B3 launch
    bit-identical; B4's counts bit for bit on the estimate's log-spaced
    and linear candidates and on a skewed input (every |x| in one bin);
    then each timed. Returns ``(b3 times, b4 times, b3 error, b4
    error)``."""
    import torch
    from gaussiank_sgd_torch.ops import threshold_select as ts_ops
    n = flat.numel()
    stats = ts_ops.fused_stats(flat)
    again = ts_ops.fused_stats(flat)
    plain = ts_ops.fused_stats_plain(flat)
    torch.cuda.synchronize()
    if not torch.equal(stats[2], plain[2]):
        raise AssertionError("B3: max|x| differs from the plain version")
    sum_abs = float(flat.abs().sum())
    d_sum = abs(float(stats[0] - plain[0]))
    d_sumsq = abs(float(stats[1] - plain[1]))
    if d_sum > 1e-6 * sum_abs or d_sumsq > 1e-5 * float(plain[1]):
        raise AssertionError(f"B3: sums {stats[:2]} vs plain {plain[:2]}")
    _same(again, stats, "B3 repeat")
    b3_err = max(d_sum, d_sumsq)
    print(f"phase B3 [{n}]: max|x| bit-identical, |d sum| {d_sum:.3g} <= "
          f"1e-6 * sum|x| ({sum_abs:.6g}), |d sumsq| {d_sumsq:.3g} <= 1e-5 * "
          f"sumsq ({float(plain[1]):.6g}); a second launch bit-identical")
    s, ss, amax = plain
    mu = s / n
    sigma = torch.sqrt(torch.clamp(ss / n - mu * mu, min=1e-30))
    lo0 = torch.maximum(0.05 * sigma, amax * 1e-7) + 1e-30
    log_cand = ts_ops._log_candidates(lo0, torch.maximum(amax, lo0 * 2.0))
    c1 = ts_ops.multi_threshold_counts(flat, log_cand)
    lin_cand = ts_ops._lin_candidates(*ts_ops._bracket(log_cand, c1, k))
    # a skewed input: every |x| in one bin of the linear candidates, so
    # every element takes the whole search
    mid = lin_cand.sort().values[15:17].mean()
    skewed = torch.where(flat < 0, -mid, mid)
    b4_inputs = (("log", flat, log_cand), ("linear", flat, lin_cand),
                 ("skewed", skewed, lin_cand))
    b4_err = 0.0
    for name, xx, cand in b4_inputs:
        out = ts_ops.multi_threshold_counts(xx, cand)
        ref = ts_ops.multi_threshold_counts_plain(xx, cand)
        torch.cuda.synchronize()
        b4_err = max(b4_err, _same((out,), (ref,), f"B4 [{n}] {name}"))
        print(f"phase B4 [{n}] {name} candidates: counts bit-identical "
              f"{[int(c) for c in out.tolist()]}")
    b3 = _time_kernel(
        f"B3 [{n}]", lambda: ts_ops.fused_stats(flat),
        lambda: ts_ops.fused_stats_plain(flat),
        _bound_ms(n * 4 + 12, _OPS_STATS * n, mem_rate),
        lambda: (flat.sum(), (flat * flat).sum(), flat.abs().amax()),
        "x.sum() + (x*x).sum() + x.abs().amax()")
    b4_by_input = {
        name: _time_kernel(
            f"B4 [{n}] x 32 {name}",
            lambda xx=xx, cand=cand: ts_ops.multi_threshold_counts(xx, cand),
            lambda xx=xx, cand=cand: ts_ops.multi_threshold_counts_plain(
                xx, cand),
            _bound_ms(n * 4 + 2 * 32 * 4, _OPS_COUNTS * n, mem_rate))
        for name, xx, cand in b4_inputs}
    b4 = {**b4_by_input["linear"],
          "ms_log": b4_by_input["log"]["ms"],
          "call_ms_log": b4_by_input["log"]["call_ms"]}
    return b3, b4, b3_err, b4_err


def _ptxas_usage(log: str, kernel: str):
    """``(registers, spill line, usage line)`` that ``-Xptxas -v`` reported
    for the entry function whose name contains ``kernel``, or None."""
    lines = log.splitlines()
    for i, line in enumerate(lines):
        if "Compiling entry function" in line and kernel in line:
            spills = next(ln.strip() for ln in lines[i:] if "spill" in ln)
            used = next(ln.split(":", 1)[1].strip() for ln in lines[i:]
                        if "Used" in ln and "registers" in ln)
            return int(used.split()[1]), spills, used
    return None


def _bits(t):
    import torch
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def _same(kernel_out, plain_out, what: str) -> float:
    """Assert bit-identical outputs; return the max abs error (0.0)."""
    import torch
    err = 0.0
    for i, (a, b) in enumerate(zip(kernel_out, plain_out)):
        if not torch.equal(_bits(a), _bits(b)):
            raise AssertionError(f"{what}: output {i} differs from the "
                                 f"plain version")
        if a.dtype == torch.float32:
            err = max(err, float((a - b).abs().max()))
    return err


def _reset_launches() -> None:
    from gaussiank_sgd_torch.ops import fused_select, threshold_select
    fused_select.reset_launches()
    threshold_select.reset_launches()


def _launches() -> dict:
    from gaussiank_sgd_torch.ops import fused_select, threshold_select
    return {**fused_select.LAUNCHES, **threshold_select.LAUNCHES}


def _config(path: str, extra, run_id: str, out_dir: str = RUN_DIR):
    """A config file through the trainer's own flag parsing, at one
    worker; ``extra`` flags override the file."""
    import argparse
    from gaussiank_sgd_torch.training.config import add_args, from_args
    from gaussiank_sgd_torch.training.trainer import Trainer
    argv = ["--config", path, "--nworkers", "1", *extra,
            "--output-dir", out_dir, "--run-id", run_id]
    p = argparse.ArgumentParser()
    add_args(p)
    return Trainer(from_args(p.parse_args(argv), argv))


def _steps(trainer) -> list:
    """The trainer's steps up to ``max_steps`` (``Trainer.train``: no eval
    pass and no checkpoint, which phase 9 drives through ``fit``)."""
    return trainer.train(trainer.total_steps - trainer.state.step)


def _drive(trainer, what: str, then=None):
    """``_steps(trainer)``, then ``then()`` if given, with every launch
    count zeroed just before and read just after: ``(records, launches,
    what then() returned)``."""
    import torch
    _reset_launches()
    records = _steps(trainer)
    extra = then() if then is not None else None
    torch.cuda.synchronize()
    launches = _launches()
    if not all(math.isfinite(rec["loss"]) for rec in records):
        raise AssertionError(f"{what}: non-finite loss: {records}")
    for rec in records:
        print(f"phase {what} step {rec['step']} {rec['kind']}: loss "
              f"{rec['loss']:.4f} num_selected {rec['num_selected']:.0f} "
              f"k {rec['k']} {rec['step_ms']:.2f} ms")
    return records, launches, extra


def _within_5pct_of_k(records, what: str) -> list:
    """The reference's count contract on every sparse step."""
    ratios = [rec["num_selected"] / rec["k"] for rec in records
              if rec["kind"] == "sparse"]
    if not ratios or any(abs(r - 1.0) > 0.05 for r in ratios):
        raise AssertionError(f"{what}: num_selected / k = {ratios}, not "
                             f"within 5% on every sparse step")
    return ratios


@contextlib.contextmanager
def _recorded_calls(trainer):
    """Wrap the trainer's compressor so that each call keeps, on the card,
    its input, its carried threshold and its result (indices, values,
    num_selected) for ``_replay_on_cpu``; the wrapper goes on exit."""
    ts = trainer.ts
    spec, calls = ts.spec, []

    def fn(acc, k, *state):
        out = spec.fn(acc, k, *state)
        r = out[0] if spec.stateful else out
        calls.append((acc.clone(), k, state[0].clone() if state else None,
                      r.compressed.indices.clone(),
                      r.compressed.values.clone(), r.num_selected.clone()))
        return out

    ts.spec = spec._replace(fn=fn)
    try:
        yield calls
    finally:
        ts.spec = spec


def _traced_bisection(abs_acc, k: int, t0, band):
    """``bisect_threshold``'s passes one at a time: ``(t, each pass's
    count, the last bracket (lo, hi))``."""
    import torch
    hi = abs_acc.amax(dim=-1)
    lo = torch.zeros_like(hi)
    t = torch.minimum(torch.maximum(t0, lo), hi)
    counts = []
    for _ in range(10):
        cnt = int((abs_acc > t).sum())
        counts.append(cnt)
        if band[0] <= cnt <= band[1]:
            break
        if cnt > k:
            lo = t
        else:
            hi = t
        t = 0.5 * (lo + hi)
    return t, counts, (float(lo), float(hi))


def _replay_on_cpu(calls, density: float, what: str) -> list:
    """Each recorded call of ``gaussian`` or ``gaussian_warm`` replayed on
    the CPU from the card's Gaussian estimate t0 (the CPU's own t0 must
    agree within 1e-5: the reductions sum in another order). From there the
    CPU's bisection, count and pack must give the card's num_selected,
    indices and values exactly. The bisection is traced pass by pass, the
    trace held bit for bit against ``bisect_threshold`` (which
    ``tests/test_torch_gaussian.py`` holds bit for bit against the
    reference's). A count outside the 5% band comes with each pass's count
    and the last bracket: the witness that the ten passes ran out. Returns
    one description a call."""
    import torch
    from gaussiank_sgd_torch.compressors.base import (
        _tolerance_band, bisect_threshold, finish_pack, select_by_mask)
    from gaussiank_sgd_torch.compressors.gaussian import (
        _usable, gaussian_threshold_estimate)
    out = []
    for i, (acc, k, st, idx, val, nsel) in enumerate(calls):
        t0 = gaussian_threshold_estimate(acc, density).cpu()
        a = acc.cpu()
        abs_a = a.abs()
        t0_cpu = gaussian_threshold_estimate(a, density)
        if abs(float(t0) - float(t0_cpu)) > 1e-5 * float(t0_cpu):
            raise AssertionError(f"{what} call {i}: t0 {float(t0)} on the "
                                 f"card, {float(t0_cpu)} on the CPU")
        band = _tolerance_band(k, 0.05)
        st = st.cpu() if st is not None else None
        if st is not None and bool(_usable(
                (abs_a > st).sum(dtype=torch.int32), st, k)):
            t, priority, counts = st, "magnitude", None
        else:
            t, counts, (lo, hi) = _traced_bisection(abs_a, k, t0, band)
            if not torch.equal(t, bisect_threshold(abs_a, k, t0)):
                raise AssertionError(f"{what} call {i}: the traced "
                                     f"bisection differs")
            priority = "index"
        sent, v, n_sel = select_by_mask(a, abs_a > t, k, priority)
        comp, _ = finish_pack(a.clone(), sent, v)
        if (int(n_sel) != int(nsel)
                or not torch.equal(comp.indices, idx.cpu())
                or not torch.equal(comp.values.view(torch.int32),
                                   val.cpu().view(torch.int32))):
            raise AssertionError(f"{what} call {i}: the card selected "
                                 f"{int(nsel)}, the CPU {int(n_sel)} from "
                                 f"the card's t0, or the packs differ")
        desc = f"{int(nsel) / k:.4f}"
        if counts is None:
            desc += " warm"
        elif not band[0] <= int(nsel) <= band[1]:
            if len(counts) != 10 or any(band[0] <= c <= band[1]
                                        for c in counts):
                raise AssertionError(f"{what} call {i}: out of the band "
                                     f"with passes {counts}")
            desc += (f" cold, outside the band {list(band)}: passes' "
                     f"counts {counts}, last bracket [{lo:.6g}, {hi:.6g}] "
                     f"= {(hi - lo) / float(abs_a.max()):.2e} of max|acc|")
        else:
            desc += " cold"
        out.append(desc)
    return out


def _ef_invariant(trainer, what: str) -> int:
    """``decompress(sent) + residual == acc`` of one more sparse step, bit
    for bit, without committing it; returns num_selected."""
    import torch
    from gaussiank_sgd_torch.compressors import decompress
    ts, state = trainer.ts, trainer.state
    grads = ts.local_grads(state, trainer.next_batch())
    state.model_state["stats"].copy_(grads.model_state_before["stats"])
    acc = state.ef_residual + grads.flat_g
    comp, residual, nsel, _ = ts.compress_phase(state, grads.flat_g)
    if not torch.equal(decompress(comp, ts.ef_numel) + residual, acc):
        raise AssertionError(f"{what}: decompress(sent) + residual != acc")
    return int(nsel.sum())


def _profile(trainer, what: str) -> None:
    """Three more sparse steps under ``torch.profiler``: wall time, device
    time and its busy share, the host reads of device values inside the
    steps and the host time they take, and the ten operators with the most
    device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(3):
            trainer.ts.sparse_step(trainer.state, trainer.next_batch())
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # kernel rows carry the device time; operator rows carry the device
    # time of the kernels they launched (the top list names operators)
    events = prof.key_averages()
    device_ms = sum(e.self_device_time_total for e in events
                    if e.device_type == DeviceType.CUDA) / 1e3
    ops = sorted(((e.self_device_time_total / 1e3, e.count, e.key)
                  for e in events if e.device_type == DeviceType.CPU),
                 reverse=True)
    # a device-to-host read inside the step (the warm compressor's branch)
    # blocks the host in _local_scalar_dense until the queue drains
    reads = [e for e in events if e.key == "aten::_local_scalar_dense"]
    n_reads = sum(e.count for e in reads)
    read_ms = sum(e.cpu_time_total for e in reads) / 1e3
    if device_ms > 0:
        print(f"phase {what}: 3 sparse steps {wall_ms:.2f} ms wall, "
              f"{device_ms:.2f} ms device time ({device_ms / wall_ms:.0%} "
              f"busy); {n_reads} host reads of device values in them, "
              f"{read_ms:.3f} ms of host time; operators by device time: "
              + "; ".join(f"{name} x{cnt} {ms:.3f} ms"
                          for ms, cnt, name in ops[:10]))
    else:
        print(f"phase {what}: torch.profiler saw no device time; device "
              f"breakdown not measured")


def _small_run(device: str, compressor: str, **kw) -> list:
    from gaussiank_sgd_torch.training.config import TrainConfig
    from gaussiank_sgd_torch.training.trainer import Trainer
    small = TrainConfig(
        dnn="vgg16", batch_size=32, compressor=compressor, density=0.01,
        compress_warmup_steps=1, max_steps=3, lr=0.02,
        compute_dtype="float32", device=device,
        model_kwargs={"cfg": NARROW, "dropout": 0.0},
        output_dir=RUN_DIR, run_id=f"small_{compressor}_{device}", **kw)
    return [rec["loss"] for rec in _steps(Trainer(small))]


def _run_id(plan: str, how: str) -> str:
    return f"exchange_{plan.replace(' ', '_')}_{how}"


def _state_copy(trainer) -> dict:
    st = trainer.state
    return {"params": st.params.detach().clone(),
            "momentum": st.opt_state["m"].clone(),
            "EF row": st.ef_residual.clone(),
            "thresholds": st.comp_state.clone()}


def _config1_phase() -> None:
    """Phase 8a: BASELINE config 1 as shipped (resnet20, dense, bf16, batch
    128) for 5 steps; its first loss again from the same seed, bit for bit;
    and resnet20 in f32 at batch 8 for 2 steps on the card and on the CPU,
    whose losses must agree."""
    trainer = _config(CONFIG1, ["--max-steps", "5"], "config1")
    if (trainer.cfg.dnn, trainer.comp.name, trainer.cfg.compute_dtype,
            trainer.cfg.batch_size) != ("resnet20", "none", "bfloat16", 128):
        raise AssertionError(f"config 1 runs {trainer.cfg}")
    records, _, _ = _drive(trainer, "config1")
    if [rec["kind"] for rec in records] != ["dense"] * 5:
        raise AssertionError(f"config 1 step kinds {records}")
    del trainer
    again = _steps(_config(CONFIG1, ["--max-steps", "1"], "config1_repeat"))
    if again[0]["loss"] != records[0]["loss"]:
        raise AssertionError(f"config 1 from the same seed: first loss "
                             f"{again[0]['loss']} vs {records[0]['loss']}")
    small = ["--compute-dtype", "float32", "--batch-size", "8",
             "--max-steps", "2"]
    losses = {d: [rec["loss"] for rec in _steps(_config(
        CONFIG1, small + ["--device", d], f"config1_small_{d}"))]
        for d in ("cuda", "cpu")}
    gaps = [abs(a - b) / abs(b) for a, b in zip(losses["cuda"],
                                                 losses["cpu"])]
    if max(gaps) > 1e-3:
        raise AssertionError(f"resnet20 f32: card and CPU disagree: "
                             f"{losses}")
    print(f"phase config1: resnet20 dense bf16 batch 128, 5 steps, "
          f"{_step_ms(records)}; first loss repeated bit for bit from the "
          f"same seed; resnet20 f32 batch 8 losses on the card "
          f"{losses['cuda']} vs CPU {losses['cpu']} (max rel gap "
          f"{max(gaps):.2e} <= 1e-3)")


def _step_ms(records) -> str:
    return "step ms " + str([round(rec["step_ms"], 2) for rec in records])


def _config3_phases(mem_rate: float) -> dict:
    """Phases 8c-8e: BASELINE config 3 (ResNet-50, synthetic ImageNet-shaped
    uint8 data at 224^2, batch 64, bf16, density 0.001) at one worker, with
    ``gaussian_fused``, as shipped (``gaussian``) and with
    ``gaussian_pallas``; then B3 and B4 on the pallas run's EF row. Returns
    the launches and kernel times for the kernels line."""
    import torch
    from gaussiank_sgd_torch.compressors import decompress
    from gaussiank_sgd_torch.ops import fused_select as fs
    steps = ["--compress-warmup-steps", "2", "--max-steps"]
    out = {}
    # c. gaussian_fused, then the registry's flat compressor on the EF row
    torch.cuda.reset_peak_memory_stats()
    trainer = _config(CONFIG3, ["--compressor", "gaussian_fused", *steps,
                                "6"], "config3_fused")
    n, k = trainer.plan.total_numel, trainer.plan.total_k
    if ((n, k), trainer.ts.fused_ef, trainer.ts.wire_format) != (
            RESNET50[:2], (1, n, RESNET50[2]), "i32f32"):
        raise AssertionError(f"config 3: n, k {n, k}, layout "
                             f"{trainer.ts.fused_ef}, wire "
                             f"{trainer.ts.wire_format}")
    records, launches, (r, _) = _drive(
        trainer, "config3 fused", lambda: trainer.comp.fn(
            trainer.state.ef_residual[:n].contiguous(), k,
            trainer.state.comp_state[0, 0]))
    peak = torch.cuda.max_memory_allocated()
    sparse = [rec for rec in records if rec["kind"] == "sparse"]
    if [rec["kind"] for rec in records] != ["dense"] * 2 + ["sparse"] * 4:
        raise AssertionError(f"config 3 step kinds {records}")
    if launches["fused_ef_select"] != 4 or launches["fused_select"] < 1:
        raise AssertionError(f"config 3 fused: launches {launches}")
    ratios = [rec["num_selected"] / rec["k"] for rec in sparse]
    if ratios[0] != 1.0:
        raise AssertionError(f"config 3: cold num_selected / k {ratios}")
    if any(rec["bytes_sent"] != k * 8 for rec in sparse):
        raise AssertionError(f"config 3 bytes_sent "
                             f"{[rec['bytes_sent'] for rec in sparse]}")
    acc = trainer.state.ef_residual[:n]
    if not torch.equal(decompress(r.compressed, n) + r.residual, acc):
        raise AssertionError("config 3 flat compressor: decompress + "
                             "residual != acc")
    del acc, r
    nsel = _ef_invariant(trainer, "config 3 fused sparse step")
    print(f"phase config3 fused: ResNet-50 n={n} k={k}, layout "
          f"{trainer.ts.fused_ef}, wire {trainer.ts.wire_format}, launches "
          f"{launches} (B1 in 4 sparse steps, B2 in the flat call); "
          f"num_selected / k {[round(v, 4) for v in ratios]} (cold step = "
          f"k); bytes_sent {sparse[0]['bytes_sent']:.0f} ({k} x 8 B); EF "
          f"invariant exact on one more sparse step (num_selected {nsel}) "
          f"and on the flat call; peak memory "
          f"{peak / 2 ** 30:.2f} GiB (max_memory_allocated); "
          f"{_step_ms(records)}")
    # B2 at the flat call's shape [1, n], on the run's EF row and warm
    # threshold
    x = trainer.state.ef_residual[:n].contiguous().view(1, n)
    t = trainer.state.comp_state[0, :1].contiguous()
    density = trainer.cfg.density
    out["b2_err"] = _same(fs.fused_select_candidates_chunked(x, t, density),
                          fs.fused_select_plain(x, t, density),
                          f"B2 [1, {n}]")
    print(f"phase B2 [1, {n}] on config 3's EF row: t={float(t[0]):.6g}, "
          f"bit-identical (vals, idx, counts)")
    nc = fs._chunk_geometry(n, density)[3]
    out["b2"] = _time_kernel(
        f"B2 [1, {n}]",
        lambda: fs.fused_select_candidates_chunked(x, t, density),
        lambda: fs.fused_select_plain(x, t, density),
        _bound_ms(n * 4 + nc * 8 + 8, _OPS_SELECT * n, mem_rate))
    del x, t
    _profile(trainer, "config3 profile")
    out["fused"], out["peak"] = launches, peak
    del trainer
    torch.cuda.empty_cache()

    # d. config 3 as shipped: compressor gaussian, no kernel
    trainer = _config(CONFIG3, [*steps, "4"], "config3_shipped")
    if trainer.comp.name != "gaussian":
        raise AssertionError(f"config 3 runs {trainer.comp.name!r}")
    with _recorded_calls(trainer) as calls:
        records, _, _ = _drive(trainer, "config3 shipped")
        nsel = _ef_invariant(trainer, "config 3 gaussian")
    ratios = _within_5pct_of_k(records, "config 3 gaussian")
    replay = _replay_on_cpu(calls, trainer.cfg.density, "config 3 gaussian")
    print(f"phase config3 shipped: compressor gaussian, num_selected / k "
          f"{[round(v, 4) for v in ratios]} (within 5%); EF invariant exact "
          f"on one more step (num_selected {nsel}); each call (2 sparse "
          f"steps and that one) equal to the CPU's from the card's t0: "
          + "; ".join(replay) + f"; {_step_ms(records)}")
    del trainer, calls
    torch.cuda.empty_cache()

    # e. gaussian_pallas: B3 once and B4 twice a sparse step
    trainer = _config(CONFIG3, ["--compressor", "gaussian_pallas", *steps,
                                "6"], "config3_pallas")
    records, launches, _ = _drive(trainer, "config3 pallas")
    want = {"fused_stats": 4, "multi_threshold_counts": 8,
            "fused_ef_select": 0, "fused_select": 0}
    if launches != want:
        raise AssertionError(f"config 3 gaussian_pallas launches "
                             f"{launches}, want {want} in 4 sparse steps")
    ratios = _within_5pct_of_k(records, "config 3 gaussian_pallas")
    nsel = _ef_invariant(trainer, "config 3 unfused sparse step")
    print(f"phase config3 pallas: launches {launches} in 4 sparse steps; "
          f"num_selected / k {[round(v, 4) for v in ratios]}; EF invariant "
          f"exact on one more sparse step (num_selected {nsel}); "
          f"{_step_ms(records)}")
    out["pallas"] = launches
    out["b3"], out["b4"], out["b3_err"], out["b4_err"] = _b3_b4_phase(
        trainer.state.ef_residual.contiguous(), k, mem_rate)
    del trainer
    torch.cuda.empty_cache()
    return out


def _events(trainer) -> list:
    """The ``{"event": ...}`` lines of a run's metrics file."""
    with open(trainer.metrics_path) as f:
        return [rec for rec in map(json.loads, f) if "event" in rec]


def _fit_phase(tmp: str) -> dict:
    """Phase 9a-b: config 3 through ``Trainer.fit()`` for 20 steps (16 an
    epoch), with an eval pass and a checkpoint every epoch, then a fresh
    trainer resumed from step 16 for steps 17-20, which must repeat the
    uninterrupted run bit for bit. Returns B1's launches on each run."""
    import torch
    from gaussiank_sgd_torch.training import checkpoint as ck
    argv = ["--compressor", "gaussian_fused", "--compress-warmup-steps", "2",
            "--max-steps", "20", "--eval-every-epochs", "1",
            "--save-every-epochs", "1"]
    trainer = _config(CONFIG3, argv, "fit", tmp)
    if (trainer.steps_per_epoch, trainer.eval_batch_size,
            trainer.ts.fused_ef) != (16, 64, (1, *RESNET50[::2])):
        raise AssertionError(f"config 3 fit: {trainer.steps_per_epoch} "
                             f"steps an epoch, eval batch "
                             f"{trainer.eval_batch_size}, layout "
                             f"{trainer.ts.fused_ef}")
    _reset_launches()
    records = trainer.fit()
    torch.cuda.synchronize()
    launches = _launches()
    kinds = [rec["kind"] for rec in records]
    if kinds != ["dense"] * 2 + ["sparse"] * 18:
        raise AssertionError(f"config 3 fit: step kinds {kinds}")
    if launches["fused_ef_select"] != 18:
        raise AssertionError(f"config 3 fit: launches {launches} in 18 "
                             f"sparse steps")
    if not all(math.isfinite(rec["loss"]) for rec in records):
        raise AssertionError(f"config 3 fit: losses {records}")
    events = _events(trainer)
    evals = [e for e in events if e["event"] == "eval"]
    saves = [e for e in events if e["event"] == "checkpoint"]
    if ([(e["step"], e["epoch"], e["n"]) for e in evals]
            != [(16, 1, 1024.0), (20, 1, 1024.0)]
            or not all(math.isfinite(e["val_loss"])
                       and 0 <= e["top1"] <= e["top5"] <= 1 for e in evals)):
        raise AssertionError(f"config 3 fit: eval lines {evals}")
    sealed = [step for step, _ in ck.list_checkpoints(trainer.ckpt_dir)]
    if sealed != [16, 20] or [e["step"] for e in saves] != [16, 20]:
        raise AssertionError(f"config 3 fit: sealed {sealed}, saves {saves}")
    want = _state_copy(trainer)
    want["stats"] = trainer.model.stats.clone()
    del trainer
    torch.cuda.empty_cache()
    for e in evals:
        print(f"phase fit eval step {e['step']} epoch {e['epoch']}: "
              f"val_loss {e['val_loss']:.4f} top1 {e['top1']:.4f} top5 "
              f"{e['top5']:.4f} over {e['n']:.0f} images, "
              f"{e['eval_ms']:.1f} ms wall, "
              f"{e['n'] / e['eval_ms'] * 1e3:.0f} images/s")
    for e in saves:
        print(f"phase fit checkpoint step {e['step']}: {e['bytes']} bytes, "
              f"save {e['save_ms']:.1f} ms wall")
    print(f"phase fit: config 3 (ResNet-50, gaussian_fused) through "
          f"Trainer.fit(), 2 dense + 18 sparse steps, B1 "
          f"{launches['fused_ef_select']} launches; eval lines at steps 16 "
          f"and 20 (both epoch 1, as the reference's loop counts an epoch "
          f"cut by max_steps); sealed checkpoints {sealed}; "
          f"{_step_ms(records)}")

    resume = os.path.join(tmp, "fit", "ckpt", "step_00000016")
    _reset_launches()
    again = _config(CONFIG3, argv + ["--resume", resume], "resumed", tmp)
    if again.state.step != 16:
        raise AssertionError(f"resumed at step {again.state.step}")
    later = again.fit()
    torch.cuda.synchronize()
    launches_resumed = _launches()
    if ([(rec["step"], rec["loss"]) for rec in later]
            != [(rec["step"], rec["loss"]) for rec in records[16:]]):
        raise AssertionError(f"resumed losses {later} vs {records[16:]}")
    got = _state_copy(again)
    got["stats"] = again.model.stats.clone()
    for key, t in got.items():
        if not torch.equal(_bits(t), _bits(want[key])):
            raise AssertionError(f"resumed run: {key} differs at step 20")
    n = again.plan.total_numel
    if again.state.ef_residual[n:].any():
        raise AssertionError("resumed run: the EF row's pad is not zero")
    if launches_resumed["fused_ef_select"] != 4:
        raise AssertionError(f"resumed run: launches {launches_resumed}")
    (restore,) = [e for e in _events(again) if e["event"] == "restore"]
    print(f"phase resume: a fresh trainer from {os.path.basename(resume)} "
          f"({restore['restore_ms']:.1f} ms wall to restore) ran steps "
          f"17-20: losses {[round(rec['loss'], 6) for rec in later]} equal "
          f"to the uninterrupted run's, and at step 20 params, momentum, "
          f"EF row (pad zero), thresholds and BatchNorm statistics "
          f"bit-identical; B1 {launches_resumed['fused_ef_select']} "
          f"launches")
    del again, want, got
    torch.cuda.empty_cache()
    return {"fit": launches["fused_ef_select"],
            "resume": launches_resumed["fused_ef_select"]}


def _microbatch_phase(peak_one: int) -> int:
    """Phase 9c: config 3 with ``--nsteps-update 2 --clip-norm 1.0``, 2
    dense + 2 sparse steps of 128 rows (two microbatches of 64): every
    step's post-clip gradient norm within 1.0 x (1 + 1e-6), the EF
    invariant exact on one more sparse step, and the peak memory beside
    the one-microbatch run's. Returns B1's launches."""
    import torch
    from gaussiank_sgd_torch.parallel import trainstep
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    trainer = _config(CONFIG3, ["--compressor", "gaussian_fused",
                                "--compress-warmup-steps", "2",
                                "--max-steps", "4", "--nsteps-update", "2",
                                "--clip-norm", "1.0"], "config3_micro")
    ts = trainer.ts
    if (trainer.train_ds.batch_size, ts.num_microbatches,
            ts.clip_norm) != (128, 2, 1.0):
        raise AssertionError(f"microbatch run: batch "
                             f"{trainer.train_ds.batch_size}, "
                             f"{ts.num_microbatches} microbatches, clip "
                             f"{ts.clip_norm}")
    clip, norms = trainstep._clip_by_global_norm, []

    def recorded(flat_g, c):
        out = clip(flat_g, c)
        norms.append(tuple(float(torch.linalg.vector_norm(
            v, dtype=torch.float64)) for v in (flat_g, out)))
        return out

    trainstep._clip_by_global_norm = recorded
    try:
        records, launches, _ = _drive(trainer, "config3 microbatch")
        peak = torch.cuda.max_memory_allocated()
        nsel = _ef_invariant(trainer, "config 3 microbatched sparse step")
    finally:
        trainstep._clip_by_global_norm = clip
    if [rec["kind"] for rec in records] != ["dense"] * 2 + ["sparse"] * 2:
        raise AssertionError(f"microbatch run: step kinds {records}")
    if launches["fused_ef_select"] != 2:
        raise AssertionError(f"microbatch run: launches {launches}")
    if len(norms) != 5 or any(after > 1.0 * (1 + 1e-6)
                              for _, after in norms):
        raise AssertionError(f"microbatch run: (pre, post)-clip norms "
                             f"{norms}")
    print(f"phase microbatch: config 3 with --nsteps-update 2 --clip-norm "
          f"1.0, 128 rows a step in two microbatches of 64, 2 dense + 2 "
          f"sparse steps and one more for the EF invariant (exact, "
          f"num_selected {nsel}); gradient norms before and after the clip "
          f"{[(round(a, 4), round(b, 7)) for a, b in norms]} (after <= 1.0 "
          f"x (1 + 1e-6)); B1 {launches['fused_ef_select']} launches; peak "
          f"memory {peak / 2 ** 30:.2f} GiB against "
          f"{peak_one / 2 ** 30:.2f} GiB at one microbatch of 64 (phase 8c) "
          f"({peak / peak_one - 1:+.1%}); {_step_ms(records)}")
    del trainer, ts
    torch.cuda.empty_cache()
    return launches["fused_ef_select"]


def _eval_card_vs_cpu_phase() -> None:
    """Phase 9d: config 1 (resnet20) in f32 after 2 dense steps on the
    card; the same state evaluated on the card and on the CPU over 4 test
    batches (512 images): top1 and top5 equal, val_loss within 1e-4."""
    import torch
    flags = ["--compute-dtype", "float32", "--max-steps", "2",
             "--eval-max-batches", "4"]
    card = _config(CONFIG1, flags, "eval_card")
    _steps(card)
    cpu = _config(CONFIG1, flags + ["--device", "cpu"], "eval_cpu")
    with torch.no_grad():
        cpu.model.flat.copy_(card.model.flat.cpu())
        cpu.model.stats.copy_(card.model.stats.cpu())
    outs = {"card": card.test(), "cpu": cpu.test()}
    (n,) = {[e for e in _events(t) if e["event"] == "eval"][-1]["n"]
            for t in (card, cpu)}
    if n != 512 or any(outs["card"][key] != outs["cpu"][key]
                       for key in ("top1", "top5")):
        raise AssertionError(f"eval card vs CPU over {n} images: {outs}")
    gap = abs(outs["card"]["val_loss"] / outs["cpu"]["val_loss"] - 1)
    if gap > 1e-4:
        raise AssertionError(f"eval card vs CPU: val_loss {outs}")
    print(f"phase eval card vs CPU: resnet20 f32 after 2 steps, {n:.0f} "
          f"test images: top1 {outs['card']['top1']:.4f} top5 "
          f"{outs['card']['top5']:.4f} on both; val_loss "
          f"{outs['card']['val_loss']:.6f} vs {outs['cpu']['val_loss']:.6f}"
          f" (rel gap {gap:.2e} <= 1e-4)")


def _exchange_runs(dev) -> dict:
    """Phase 7b: config 2 on both plans without a process group, then in
    an NCCL group of one; returns each plan's B1 launches."""
    import torch
    import torch.distributed as dist
    from gaussiank_sgd_torch.compressors import decompress
    from gaussiank_sgd_torch.parallel import collectives, mesh
    alone = {}
    for name, flags in PLANS.items():
        trainer = _config(CONFIG2, EXCHANGE_ARGV + flags, _run_id(name, "alone"))
        records, _, _ = _drive(trainer, f"exchange {name} alone")
        alone[name] = ([(rec["loss"], rec["num_selected"])
                        for rec in records], _state_copy(trainer))
        del trainer
    store = os.path.join(RUN_DIR, "nccl_store")
    if os.path.exists(store):
        os.remove(store)
    mesh.init_distributed(dev, 0, 1, "file://" + store)
    if ((dist.get_backend(), collectives.world_size())
            != (mesh.backend_for(dev), 1)):
        raise AssertionError(f"group {dist.get_backend()} of "
                             f"{collectives.world_size()}")
    b1_launches, payload_ms = {}, {}
    for name, flags in PLANS.items():
        trainer = _config(CONFIG2, EXCHANGE_ARGV + flags, _run_id(name, "nccl"))
        records, launches, _ = _drive(trainer, f"exchange {name} NCCL")
        ts = trainer.ts
        wire, per_entry, layout = EXCHANGE_WANT[name]
        k_total = trainer.plan.total_k
        if (ts.wire_format, ts.fused_ef) != (wire, layout):
            raise AssertionError(f"{name}: wire {ts.wire_format}, layout "
                                 f"{ts.fused_ef}; want {wire}, {layout}")
        sparse = [rec for rec in records if rec["kind"] == "sparse"]
        if any(rec["bytes_sent"] != k_total * per_entry for rec in sparse):
            raise AssertionError(f"{name}: bytes_sent "
                                 f"{[rec['bytes_sent'] for rec in sparse]}")
        if launches["fused_ef_select"] != len(sparse):
            raise AssertionError(f"{name}: B1 launched "
                                 f"{launches['fused_ef_select']} times in "
                                 f"{len(sparse)} sparse steps")
        # the cold step counts exactly k, as on the main path; the warm
        # controller's later counts trail the loss and are only printed
        ratios = [rec["num_selected"] / rec["k"] for rec in sparse]
        if ratios[0] != 1.0:
            raise AssertionError(f"{name}: num_selected / k {ratios}")
        seen, before = alone[name]
        if [(rec["loss"], rec["num_selected"]) for rec in records] != seen:
            raise AssertionError(f"{name}: losses and counts with NCCL "
                                 f"{records} vs alone {seen}")
        for key, t in _state_copy(trainer).items():
            if not torch.equal(_bits(t), _bits(before[key])):
                raise AssertionError(f"{name}: {key} differs with NCCL")
        # the EF invariant of one more step against the decoded values
        state = trainer.state
        g = ts.local_grads(state, trainer.next_batch())
        state.model_state["stats"].copy_(g.model_state_before["stats"])
        acc = state.ef_residual + g.flat_g
        payload, residual, _, _ = ts.pack_phase(state, g.flat_g)
        sent = ts.unpack(payload, workers=1)
        if not torch.equal(decompress(sent, ts.ef_numel) + residual, acc):
            raise AssertionError(f"{name}: decompress(decoded) + residual "
                                 f"!= acc")
        payload_ms[name] = [
            (str(t.dtype).replace("torch.", ""), t.numel(),
             _median_ms(lambda t=t: collectives.all_gather(t), 20))
            for t in payload]
        b1_launches[name] = launches["fused_ef_select"]
        print(f"phase exchange {name}: NCCL group of one, wire "
              f"{ts.wire_format}, layout {ts.fused_ef}, bytes_sent "
              f"{sparse[0]['bytes_sent']:.0f} ({k_total} x {per_entry} B), "
              f"B1 {launches['fused_ef_select']} launches in {len(sparse)} "
              f"sparse steps, num_selected / k "
              f"{[round(r, 4) for r in ratios]}; losses, counts, params, "
              f"momentum, EF row and thresholds bit-identical to the run "
              f"without a group; EF invariant exact against the decoded "
              f"values")
        del trainer, state, g, acc, payload, residual, sent
    flat = torch.randn(14_986_698, device=dev)
    dense_ms = _median_ms(lambda: dist.all_reduce(flat), 20)
    mean_ms = _median_ms(lambda: collectives.dense_allreduce(flat), 20)
    for name, rows in payload_ms.items():
        print(f"phase exchange all-gather {name}: " + "; ".join(
            f"{dtype}[{numel}] {ms:.4f} ms" for dtype, numel, ms in rows)
            + " (NCCL, world of one, CUDA events, median of 20)")
    print(f"phase exchange dense all-reduce: f32[14986698] (59.9 MB) "
          f"{dense_ms:.4f} ms in place; dense_allreduce (copy, all-reduce, "
          f"/ P) {mean_ms:.4f} ms (NCCL, world of one, median of 20)")
    dist.destroy_process_group()
    return b1_launches


def _scatter_phase(n: int, dev) -> None:
    """Phase 7c: the ordered scatter of 8 gathered payloads, card twice
    and CPU once, bit for bit."""
    import numpy as np
    import torch
    from gaussiank_sgd_torch.compressors.base import scatter_add_ordered
    world, k, chunk = 8, 15_114, 65_536
    rng = np.random.default_rng(0)
    pool = rng.choice(n, size=2 * k, replace=False)
    idx, val = [], []
    for _ in range(world):
        i = rng.choice(pool, size=k, replace=False)
        v = rng.normal(size=k).astype(np.float32) * np.float32(1e-3)
        pad = rng.random(k) < 0.05
        i[pad], v[pad] = (i[pad] // chunk) * chunk, 0.0
        idx.append(i)
        val.append(v)
    idx = torch.from_numpy(np.concatenate(idx).astype(np.int32))
    val = torch.from_numpy(np.concatenate(val) / np.float32(world))
    m = torch.from_numpy(rng.normal(size=n).astype(np.float32))
    real = idx[val != 0].numpy()
    hits = np.bincount(real, minlength=n)
    outs = []
    for d in (dev, dev, "cpu"):
        out = scatter_add_ordered(m.to(d, copy=True), idx.to(d),
                                  val.to(d), rounds=world)
        outs.append(out.cpu())
    for i, out in enumerate(outs[1:], 1):
        if not torch.equal(outs[0].view(torch.int32), out.view(torch.int32)):
            raise AssertionError(f"ordered scatter: run {i} differs")
    m_d, idx_d, val_d = m.to(dev), idx.to(dev), val.to(dev)
    idx64 = idx_d.to(torch.int64)
    plain = [m_d.clone().index_add_(0, idx64, val_d).cpu() for _ in range(2)]
    ms = _median_ms(lambda: scatter_add_ordered(m_d, idx_d, val_d,
                                                rounds=world), 20)
    plain_ms = _median_ms(lambda: m_d.index_add_(0, idx64, val_d), 20)
    print(f"phase ordered scatter: {world} x {k} pairs into [{n}], "
          f"{int((hits >= 2).sum())} coordinates sent by 2 or more payloads "
          f"({int(hits[hits >= 2].sum())} pairs, at most {int(hits.max())} "
          f"a coordinate), {int((val == 0).sum())} padding slots; card "
          f"twice and CPU once bit-identical; {ms:.4f} ms on the card "
          f"(CUDA events, median of 20) against one index_add_ {plain_ms:.4f}"
          f" ms, whose two card runs are "
          f"{'bit-identical' if torch.equal(plain[0].view(torch.int32), plain[1].view(torch.int32)) else 'different'}"
          f" and {'equal' if torch.equal(plain[0].view(torch.int32), outs[0].view(torch.int32)) else 'not equal'}"
          f" to the ordered sum")


def _two_workers_phase() -> None:
    """Phase 7d: two ranks on this card in a gloo group; their parameters
    must be bit-identical after every step."""
    d = os.path.join(RUN_DIR, "two_workers")
    shutil.rmtree(d, ignore_errors=True)
    os.makedirs(d)
    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__),
                               "--worker", str(r), "2", d],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for r in range(2)]
    try:
        outs = [p.communicate(timeout=400) for p in procs]
    finally:
        for p in procs:
            p.kill()
    for r, (p, (_, err)) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            raise AssertionError(f"two workers: rank {r} exited "
                                 f"{p.returncode}: {err[-3000:]}")
    res = []
    for r in range(2):
        with open(os.path.join(d, f"rank{r}.json")) as f:
            res.append(json.load(f))
    if res[0]["hashes"] != res[1]["hashes"]:
        raise AssertionError(f"two workers: parameters differ: {res}")
    if res[0]["losses"] != res[1]["losses"]:
        raise AssertionError(f"two workers: losses differ: {res}")
    for rr in res:
        if rr["launches"]["fused_ef_select"] != 2 or rr["wire"] != "u16bf16":
            raise AssertionError(f"two workers: {rr}")
    print(f"phase two workers: gloo group of 2 on this card (CUDA tensors), "
          f"config 2 on the uniform plan, wire {res[0]['wire']}, 1 dense + 2 "
          f"sparse steps, losses {res[0]['losses']}, parameters "
          f"bit-identical on both ranks after every step (sha256 "
          f"{[h[:12] for h in res[0]['hashes']]}), B1 2 launches a rank, "
          f"bytes_sent {res[0]['bytes_sent']}; {time.perf_counter() - t0:.1f}"
          f" s with the processes' start")


def _worker(rank: int, world: int, d: str) -> int:
    """One rank of phase 7d."""
    import torch
    import torch.distributed as dist
    sys.path.insert(0, REPO)
    from gaussiank_sgd_torch.parallel import mesh
    mesh.init_distributed("cuda:0", rank, world,
                          "file://" + os.path.join(d, "store"),
                          backend="gloo")
    trainer = _config(CONFIG2, ["--compressor", "gaussian_fused", "--nworkers",
                        str(world), "--max-steps", "3",
                        "--compress-warmup-steps", "1",
                        *PLANS["uniform 65536"]], f"two_workers_{rank}")
    _reset_launches()
    hashes, losses, sent = [], [], []
    for _ in range(3):
        rec = trainer.train(1)[0]
        params = trainer.state.params.detach().cpu().numpy()
        hashes.append(hashlib.sha256(params.tobytes()).hexdigest())
        losses.append(rec["loss"])
        sent.append(rec["bytes_sent"])
    torch.cuda.synchronize()
    with open(os.path.join(d, f"rank{rank}.json"), "w") as f:
        json.dump({"hashes": hashes, "losses": losses, "bytes_sent": sent,
                   "launches": _launches(),
                   "wire": trainer.ts.wire_format}, f)
    dist.barrier()
    dist.destroy_process_group()
    return 0


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the GPU",
              file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    from gaussiank_sgd_torch.compressors import decompress, k_for
    from gaussiank_sgd_torch.models.vgg import VGG16
    from gaussiank_sgd_torch.ops import _build
    from gaussiank_sgd_torch.ops import fused_select as fs
    from gaussiank_sgd_torch.ops import threshold_select as ts_ops

    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)

    # 1. the card
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()
    print(smi[0])
    mem_rate = _mem_rate(kind)
    print(f"phase card: {kind}, {torch.cuda.device_count()} device(s), "
          f"memory rate {mem_rate / 1e12:.2f} TB/s, torch "
          f"{torch.__version__}, CUDA {torch.version.cuda}")

    # 2. build, every source at once
    t0 = time.perf_counter()
    built = _build.load_all()
    wall = time.perf_counter() - t0
    for name, lib in built.items():
        regs = [ln.strip() for ln in lib.log.splitlines() if "registers" in ln]
        print(f"phase build {name}: {os.path.relpath(lib.path, REPO)} (nvcc "
              f"{lib.seconds:.2f} s); {' | '.join(regs)}")
    print(f"phase build: {len(built)} sources in {wall:.2f} s")
    usage = _ptxas_usage(built["threshold_select"].log, "count_kernel")
    if usage is None:
        print("phase build count_kernel: no ptxas report (library reused)")
    else:
        regs, spills, used = usage
        print(f"phase build count_kernel (B4): {used}; {spills}")
        if regs > 64:
            raise AssertionError(f"count_kernel uses {regs} registers > 64")

    # 3. B1 at VGG-16's shape
    density = 0.001
    n = VGG16(device=torch.device("meta")).n_params
    k = k_for(n, density)
    nc = fs._chunk_geometry(n, density)[3]
    gen = torch.Generator(device=dev).manual_seed(0)
    b1, b1_err, res, g, warm = _b1_phase(n, density, gen, mem_rate)
    cold = torch.zeros(1, device=dev)

    # 4. B2 at [1, n] and [4, 65536]
    x = (res + g)[:, :n].contiguous()
    b2_err = 0.0
    for name, xx, t in (("[1, n] cold", x, cold), ("[1, n] warm", x, warm),
                        ("[4, 65536]", torch.randn(
                            4, 65536, device=dev, generator=gen),
                         torch.tensor([0.0, 1.0, 2.0, 3.0], device=dev))):
        out = fs.fused_select_candidates_chunked(xx, t, density)
        ref = fs.fused_select_plain(xx, t, density)
        torch.cuda.synchronize()
        b2_err = max(b2_err, _same(out, ref, f"B2 {name}"))
        print(f"phase B2 {name}: counts={out[2].tolist()} bit-identical "
              f"(vals, idx, counts)")
    b2 = _time_kernel(
        f"B2 [1, {n}]",
        lambda: fs.fused_select_candidates_chunked(x, warm, density),
        lambda: fs.fused_select_plain(x, warm, density),
        _bound_ms(n * 4 + nc * 8 + 8, _OPS_SELECT * n, mem_rate))
    del res, g

    # 5. B3 and B4 at [n], on the estimate's own candidates
    b3, b4, b3_err, b4_err = _b3_b4_phase(x[0], k, mem_rate)
    del x

    # 6a. the main path with gaussian_fused, then the registry's flat
    # compressor on the run's residual
    fused_argv = ["--compressor", "gaussian_fused", "--max-steps", "6",
                  "--compress-warmup-steps", "2"]
    trainer = _config(CONFIG2, fused_argv, "config2")
    n_total, k_total = trainer.plan.total_numel, trainer.plan.total_k
    if (n_total, k_total) != (n, k):
        raise AssertionError(f"plan ({n_total}, {k_total}) != ({n}, {k})")
    records, fused_launches, (r, _) = _drive(
        trainer, "main", lambda: trainer.comp.fn(
            trainer.state.ef_residual[:n_total].contiguous(), k_total,
            trainer.state.comp_state[0, 0]))
    kinds = [rec["kind"] for rec in records]
    if kinds != ["dense"] * 2 + ["sparse"] * 4:
        raise AssertionError(f"step kinds {kinds}")
    if fused_launches["fused_ef_select"] != 4:
        raise AssertionError(f"B1 launched {fused_launches['fused_ef_select']}"
                             f" times in 4 sparse steps")
    if fused_launches["fused_select"] < 1:
        raise AssertionError("B2 was not launched on the main path")
    acc = trainer.state.ef_residual[:n_total]
    if not torch.equal(decompress(r.compressed, n_total) + r.residual, acc):
        raise AssertionError("flat compressor: decompress + residual != acc")
    dense_ms = [rec["step_ms"] for rec in records if rec["kind"] == "dense"]
    sparse_ms = [rec["step_ms"] for rec in records if rec["kind"] == "sparse"]
    print(f"phase main path: n={n_total} k={k_total} launches "
          f"{fused_launches}; dense step ms {[round(v, 2) for v in dense_ms]}"
          f", sparse step ms {[round(v, 2) for v in sparse_ms]} (first of "
          f"each includes warm-up); flat compressor num_selected "
          f"{int(r.num_selected)} of k={k_total}, EF invariant exact")
    del acc, r
    nsel = _ef_invariant(trainer, "fused sparse step")
    print(f"phase EF invariant: decompress(sent) + residual == acc bit for "
          f"bit on one sparse step (num_selected {nsel}, k {k_total})")

    # where a sparse step's time goes: 3 steps under torch.profiler
    _profile(trainer, "profile")
    del trainer

    # 6b. gaussian_pallas: the unfused step with kernels B3 and B4
    trainer = _config(CONFIG2, ["--compressor", "gaussian_pallas", "--max-steps",
                        "6", "--compress-warmup-steps", "2"],
                       "config2_pallas")
    records_p, pallas_launches, _ = _drive(trainer, "pallas")
    if trainer.ts.fused_ef is not None:
        raise AssertionError("gaussian_pallas took the fused EF path")
    want = {"fused_stats": 4, "multi_threshold_counts": 8,
            "fused_ef_select": 0, "fused_select": 0}
    if pallas_launches != want:
        raise AssertionError(f"gaussian_pallas launches {pallas_launches}, "
                             f"want {want} in 4 sparse steps")
    ratios = _within_5pct_of_k(records_p, "gaussian_pallas")
    nsel = _ef_invariant(trainer, "unfused sparse step")
    print(f"phase pallas path: launches {pallas_launches} in 4 sparse "
          f"steps; num_selected / k {[round(v, 4) for v in ratios]}; EF "
          f"invariant exact on one more unfused step (num_selected {nsel})")
    _profile(trainer, "pallas profile")
    del trainer

    # 6c. config 2 as the repo ships it (compressor 'gaussian')
    trainer = _config(CONFIG2, ["--max-steps", "4", "--compress-warmup-steps", "2"],
                       "config2_shipped")
    if trainer.comp.name != "gaussian":
        raise AssertionError(f"config 2 runs {trainer.comp.name!r}")
    with _recorded_calls(trainer) as calls:
        _drive(trainer, "shipped")
        nsel = _ef_invariant(trainer, "config 2 gaussian")
    replay = _replay_on_cpu(calls, trainer.cfg.density, "config 2 gaussian")
    print(f"phase shipped config 2: compressor gaussian, EF invariant exact "
          f"on one more step (num_selected {nsel}); num_selected / k of "
          f"each call (2 sparse steps and that one), each equal to the CPU's "
          f"from the card's t0: " + "; ".join(replay))
    del calls
    _profile(trainer, "shipped profile")
    del trainer

    # 6d. gaussian_warm: one host sync per sparse step (its branch)
    trainer = _config(CONFIG2, ["--compressor", "gaussian_warm", "--max-steps", "6",
                        "--compress-warmup-steps", "2"], "config2_warm")
    with _recorded_calls(trainer) as calls:
        _drive(trainer, "warm")
        nsel = _ef_invariant(trainer, "config 2 gaussian_warm")
    replay = _replay_on_cpu(calls, trainer.cfg.density, "gaussian_warm")
    if " cold" not in replay[0]:
        raise AssertionError(f"gaussian_warm: first call {replay[0]}")
    print(f"phase warm path: EF invariant exact on one more step "
          f"(num_selected {nsel}); num_selected / k of each call (4 sparse "
          f"steps and that one; the first is cold: estimate and bisection), "
          f"each equal to the CPU's from the card's t0: " + "; ".join(replay))
    del calls
    _profile(trainer, "warm profile")
    del trainer

    # the seed fixes the run: config 2 again from the same seed (weights,
    # batches and dropout masks); the first loss is a forward only and must
    # repeat bit for bit, later ones carry cuDNN's backward summation order
    again = [rec["loss"] for rec in _steps(_config(CONFIG2, fused_argv,
                                                   "config2_repeat"))]
    first = [rec["loss"] for rec in records]
    if again[0] != first[0]:
        raise AssertionError(f"seeded runs differ at step 1: {first} vs "
                             f"{again}")
    print(f"phase repeat: config 2 from the same seed, losses {again} vs "
          f"{first} (step 1 bit for bit; max rel gap "
          f"{max(abs(a - b) / abs(b) for a, b in zip(again, first)):.2e})")

    # small input: the same narrow runs on the card and on the CPU
    for compressor, kw in (("gaussian_fused", {}),
                           ("gaussian_pallas", dict(bucket_policy="uniform",
                                                    bucket_size=4096))):
        losses = {device: _small_run(device, compressor, **kw)
                  for device in ("cuda", "cpu")}
        gaps = [abs(a - b) / abs(b) for a, b in zip(losses["cuda"],
                                                     losses["cpu"])]
        if max(gaps) > 1e-3:
            raise AssertionError(f"{compressor}: card and CPU disagree: "
                                 f"{losses}")
        print(f"phase small input {compressor} {kw}: narrow VGG f32 losses "
              f"on the card {losses['cuda']} vs CPU {losses['cpu']} (max "
              f"rel gap {max(gaps):.2e} <= 1e-3)")

    # 7. the exchange: B1 at the uniform plan's shape, then config 2 with
    # and without an NCCL group of one, the ordered scatter, two workers
    res = torch.zeros(229, 65_536, device=dev)
    g = torch.zeros(229, 65_536, device=dev)
    res[:, :] = torch.randn(229, 65_536, device=dev, generator=gen) * 0.01
    g[:, :] = torch.randn(229, 65_536, device=dev, generator=gen) * 0.01
    k_u = k_for(65_536, density)
    _, warm_u = fs.gaussian_fused_ef_compress_batched(
        res, g, 1.0, k_u, torch.zeros(229, device=dev), density=density)
    nc_u = fs._chunk_geometry(65_536, density)[3]
    out = fs.fused_ef_select_candidates_chunked(res, g, 1.0, warm_u, density)
    b1_err = max(b1_err, _same(out, fs.fused_ef_select_plain(
        res, g, 1.0, warm_u, density), "B1 [229, 65536]"))
    print(f"phase B1 [229, 65536] warm: {nc_u} candidates a chunk, counts "
          f"{int(out[3].min())}..{int(out[3].max())}, bit-identical")
    b1_u = _time_kernel(
        "B1 [229, 65536]",
        lambda: fs.fused_ef_select_candidates_chunked(res, g, 1.0, warm_u,
                                                      density),
        lambda: fs.fused_ef_select_plain(res, g, 1.0, warm_u, density),
        _bound_ms(3 * 229 * 65_536 * 4 + 229 * nc_u * 8 + 229 * 8,
                  _OPS_SELECT * 229 * 65_536, mem_rate))
    del res, g, out

    b1_exchange = _exchange_runs(dev)
    _scatter_phase(n, dev)
    torch.cuda.empty_cache()
    _two_workers_phase()

    # 8. the ResNet family: config 1, B1 at ResNet-50's padded EF row,
    # config 3 on three paths
    _config1_phase()
    b1_r50, b1_r50_err, res, g, _ = _b1_phase(RESNET50[0], density, gen,
                                              mem_rate)
    b1_err = max(b1_err, b1_r50_err)
    del res, g
    torch.cuda.empty_cache()
    c3 = _config3_phases(mem_rate)
    b2_err = max(b2_err, c3["b2_err"])
    b3_err, b4_err = max(b3_err, c3["b3_err"]), max(b4_err, c3["b4_err"])

    # 9. the training loop as users run it: config 3 through fit() with
    # eval passes and checkpoints (written outside the repository: ~300 MB
    # each), the resume, microbatching and clipping, eval card vs CPU
    tmp = tempfile.mkdtemp(prefix="chip_smoke_fit_")
    try:
        loop = _fit_phase(tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    loop["microbatch"] = _microbatch_phase(c3["peak"])
    _eval_card_vs_cpu_phase()

    # 10. the kernels line
    select_src = "gaussiank_sgd_torch/csrc/fused_select.cu"
    thresh_src = "gaussiank_sgd_torch/csrc/threshold_select.cu"
    kernels = [
        {"name": "fused_ef_select (B1)", "route": "cuda", "source": select_src,
         "replaces": "gaussiank_sgd_tpu/ops/pallas_pack.py:179",
         "launches": fused_launches["fused_ef_select"], "max_abs_err": b1_err,
         **b1, "launches_exchange": b1_exchange,
         **{f"{key}_229x65536": b1_u[key]
            for key in ("ms", "call_ms", "plain_ms", "bound_ms")},
         "resnet50": {"launches": c3["fused"]["fused_ef_select"],
                      "shape": [1, RESNET50[2]], **b1_r50},
         "training_loop": {f"launches_{key}": v for key, v in loop.items()}},
        {"name": "fused_select (B2)", "route": "cuda", "source": select_src,
         "replaces": "gaussiank_sgd_tpu/ops/pallas_pack.py:152",
         "launches": fused_launches["fused_select"], "max_abs_err": b2_err,
         **b2, "resnet50": {"launches": c3["fused"]["fused_select"],
                            "shape": [1, RESNET50[0]], **c3["b2"]}},
        {"name": "fused_stats (B3)", "route": "cuda", "source": thresh_src,
         "replaces": "gaussiank_sgd_tpu/ops/pallas_select.py:76",
         "launches": pallas_launches["fused_stats"], "max_abs_err": b3_err,
         **b3, "resnet50": {"launches": c3["pallas"]["fused_stats"],
                            "shape": [RESNET50[0]], **c3["b3"]}},
        {"name": "multi_threshold_counts (B4)", "route": "cuda",
         "source": thresh_src,
         "replaces": "gaussiank_sgd_tpu/ops/pallas_select.py:112",
         "launches": pallas_launches["multi_threshold_counts"],
         "max_abs_err": b4_err, **b4,
         "resnet50": {"launches": c3["pallas"]["multi_threshold_counts"],
                      "shape": [RESNET50[0]], **c3["b4"]}},
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--worker"]:
        sys.exit(_worker(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]))
    sys.exit(main())
