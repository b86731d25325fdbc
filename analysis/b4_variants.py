#!/usr/bin/env python3
"""Kernel B4 (``count_kernel`` in ``gaussiank_sgd_torch/csrc/threshold_select.cu``)
built at several tunings and timed side by side on one GPU.

    python3 analysis/b4_variants.py [--blocks 6,5] [--extra NAME=PATH ...]

A variant ``bB`` is the checkout's source with ``kCountBlocksPerSM = B``
(the launch bound, so the register cap); ``--extra`` adds another copy of
the source as it is (for example an earlier commit's, unpacked beside the
build). Each is
built with its own ``nvcc`` (all started together) into
``gaussiank_sgd_torch/build/b4_variants/``, its ``-Xptxas -v`` usage of
``count_kernel`` printed, held bit for bit to the plain version on a
VGG-16-sized gradient (n = 14,986,698, N(0, 0.02^2)) against the estimate's
log-spaced and linear candidates, and timed there: device time per launch
of the C entry alone (a CUDA graph of 20 launches, the median of 5 replays),
in the order given and then in reverse, so that drift shows. Prints one
JSON line per variant and pass. Needs a CUDA device and ``nvcc``.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import statistics
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _source(base: str, blocks: int) -> str:
    src, subs = re.subn(r"constexpr int kCountBlocksPerSM = \d+;",
                        f"constexpr int kCountBlocksPerSM = {blocks};", base)
    if subs != 1:
        raise RuntimeError("the source has no kCountBlocksPerSM")
    return src


def _build(name: str, src: str, out_dir: str):
    from gaussiank_sgd_torch.ops import _build as B
    cu = os.path.join(out_dir, f"{name}.cu")
    so = os.path.join(out_dir, f"lib{name}.so")
    with open(cu, "w") as f:
        f.write(src)
    proc = subprocess.run([B._nvcc(), *B.ARCH_FLAGS, "-std=c++17", "-O3",
                           "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
                           "-o", so, cu], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}:\n{proc.stderr}")
    lib = ctypes.CDLL(so)
    fn = lib.gk_multi_threshold_counts
    fn.argtypes = B._SIGNATURES["threshold_select"]["gk_multi_threshold_counts"]
    fn.restype = ctypes.c_int
    log = proc.stdout + proc.stderr
    lines = log.splitlines()
    at = next(i for i, ln in enumerate(lines)
              if "Compiling entry function" in ln and "count_kernel" in ln)
    usage = "; ".join(ln.split(":", 1)[-1].strip() for ln in lines[at + 1:at + 4]
                      if "spill" in ln or "Used" in ln)
    return fn, usage


def _stream() -> int:
    """The current stream, read at each launch: a CUDA graph captures on
    a stream of its own."""
    import torch
    return torch.cuda.current_stream().cuda_stream


def _device_ms(launch, counts, reps: int = 20) -> float:
    import torch
    launch()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        counts.zero_()
        for _ in range(reps):
            launch()
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
    return statistics.median(times)


def main() -> int:
    import torch
    p = argparse.ArgumentParser()
    p.add_argument("--blocks", default="6,5")
    p.add_argument("--extra", action="append", default=[],
                   help="NAME=PATH of another threshold_select.cu to time")
    args = p.parse_args()
    if not torch.cuda.is_available():
        print("b4_variants: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    from gaussiank_sgd_torch.ops import _build as B
    from gaussiank_sgd_torch.ops import threshold_select as S

    with open(os.path.join(B.CSRC_DIR, "threshold_select.cu")) as f:
        base = f.read()
    sources = {}
    for blocks in args.blocks.split(","):
        sources[f"b{blocks}"] = _source(base, int(blocks))
    for item in args.extra:
        name, path = item.split("=", 1)
        with open(path) as f:
            sources[name] = f.read()
    out_dir = os.path.join(B.BUILD_DIR, "b4_variants")
    os.makedirs(out_dir, exist_ok=True)
    with ThreadPoolExecutor(max_workers=len(sources)) as pool:
        futures = {name: pool.submit(_build, name, src, out_dir)
                   for name, src in sources.items()}
        built = {name: fut.result() for name, fut in futures.items()}

    dev = torch.device("cuda")
    n = 14_986_698
    gen = torch.Generator(device=dev).manual_seed(0)
    flat = torch.randn(n, device=dev, generator=gen) * 0.02
    s, ss, amax = S.fused_stats_plain(flat)
    sigma = torch.sqrt(torch.clamp(ss / n - (s / n) ** 2, min=1e-30))
    lo0 = torch.maximum(0.05 * sigma, amax * 1e-7) + 1e-30
    log_cand = S._log_candidates(lo0, torch.maximum(amax, lo0 * 2.0))
    lin_cand = S._lin_candidates(*S._bracket(
        log_cand, S.multi_threshold_counts_plain(flat, log_cand),
        max(1, n // 1000)))
    counts = torch.zeros(32, dtype=torch.int32, device=dev)
    name_of = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi)
    for name, (fn, usage) in built.items():
        for cand_name, cand in (("log", log_cand), ("linear", lin_cand)):
            counts.zero_()
            status = fn(flat.data_ptr(), n, cand.data_ptr(),
                        counts.data_ptr(), _stream())
            if status != 0:
                raise RuntimeError(f"{name}: launch failed ({status})")
            want = S.multi_threshold_counts_plain(flat, cand)
            if not torch.equal(counts.float(), want):
                raise AssertionError(f"{name} {cand_name}: counts differ")
        print(f"{name}: bit-identical on both candidate sets; {usage}")
    order = list(built)
    for pass_no, names in enumerate((order, order[::-1])):
        for name in names:
            fn = built[name][0]
            row = {"variant": name, "pass": pass_no, "device": name_of}
            for cand_name, cand in (("log", log_cand), ("linear", lin_cand)):
                row[f"ms_{cand_name}"] = _device_ms(
                    lambda c=cand: fn(flat.data_ptr(), n, c.data_ptr(),
                                      counts.data_ptr(), _stream()), counts)
            print(json.dumps(row))
    return 0


if __name__ == "__main__":
    sys.exit(main())
