"""Per-config memory floor of the sparse compression path, priced on the
card: the port of ``analysis/roofline.py``.

Run: ``python -m gaussiank_sgd_torch.roofline [--bw-n 57000000]
[--configs vgg16 ...] [--out PATH]`` (``--device cpu`` prices a CPU's
floor, for the tests). It writes ``gaussiank_sgd_torch/artifacts/
roofline.json`` unless ``--out`` says where, and prints one JSON line.

1. **Measured memory rate.** A loop-carried f32 ``a.mul_(c)`` pass over
   ``--bw-n`` elements, one read and one write (8n bytes a step),
   ``n_steps`` steps a round, the median of ``rounds`` rounds. On the card
   CUDA events bracket each round's loop; on the CPU the host clock does.
2. **Bytes that must move** a compression phase, on the fused EF + select
   path (kernel B1, ``csrc/fused_select.cu``)::

     read grad             4n
     read EF residual      4n
     write EF accumulator  4n     (the new residual)
     write candidates      8nc    (f32 value + i32 ranking key)
     re-read candidates    8nc    (the top-k over the candidates)
     k-entry traffic      12k     (pack, exchange staging, scatter: 3
                                   stages of the 4-byte u16|bf16 word)

   = ``12n + 16nc + 12k``; the unfused path pays two more n-sized passes,
   ``24n + 16nc + 12k``. n is the model's parameter count (built on the
   meta device: nothing model-sized is allocated), nc the candidate slots
   of B1's geometry (``ops/fused_select.py:_chunk_geometry``), and k is
   the reference's ``max(1, int(n * density))``. That k is one below the
   step's own ``k_for`` (``max(1, ceil(n * density))``) wherever
   ``n * density`` is not whole (14,986 against 14,987 at VGG-16): the
   reference's arithmetic is kept, so the byte counts equal its
   artifact's, and the gap is 12 bytes.
3. ``floor_ms = bytes / measured rate``; with a ``bench_last.json`` of the
   same platform beside the output, the achieved overhead (sparse - dense
   step ms) against 1.3 x floor.
4. **Overlap floor.** One device's exchange bytes, ``(P-1) k bpe`` on the
   all-gather and ``log2(P) k bpe`` on the gTop-k butterfly (bpe 4 packed,
   8 legacy), priced at the same rate: ``overlap_floor_ms = max(0,
   exchange_ms - floor_ms)``.

The artifact names its ``platform`` (the torch device type), its
``device`` (``torch.cuda.get_device_name()``) and the card's power limit:
``policy/rules.py:load_roofline_floor`` applies a floor only on the card
it was priced on.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import statistics
import sys
import time

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARTIFACTS = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "artifacts")

# (key, model, dataset) of the five BASELINE configs, as the bench driver
# names them; the batch does not enter the byte count
CONFIG_MODELS = (
    ("resnet20", "resnet20", "cifar10"),
    ("vgg16", "vgg16", "cifar10"),
    ("resnet50", "resnet50", "imagenet"),
    ("lstm_ptb", "lstm", "ptb"),
    ("transformer_wmt", "transformer", "wmt"),
)


def param_count(model: str, dataset: str, **model_kwargs) -> int:
    """The model's parameter count, from its layout built on the meta
    device."""
    from .models import get_model
    spec = get_model(model, dataset, device="meta", **model_kwargs)
    return int(spec.module.n_params)


def measure_bandwidth_gbps(n: int, n_steps: int = 20, rounds: int = 5,
                           device="cuda"):
    """Measured streaming rate (GB/s) of a one-read-one-write f32 scale
    pass over n elements: ``(median, per-round rates)``."""
    from .device import resolve_device
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(0)
    a = torch.randn(n, device=dev, generator=gen)
    # the multiplier keeps the loop-carried value finite over any
    # realistic number of steps
    c = 1.0000001

    def run():
        for _ in range(n_steps):
            a.mul_(c)

    run()                                            # warm-up
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.synchronize(dev)
    per_round = []
    for _ in range(rounds):
        if cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            run()
            end.record()
            end.synchronize()
            dt = start.elapsed_time(end) / 1e3 / n_steps
        else:
            t0 = time.perf_counter()
            run()
            dt = (time.perf_counter() - t0) / n_steps
        per_round.append(8.0 * n / dt / 1e9)         # 8n bytes a step
    return statistics.median(per_round), [round(b, 2) for b in per_round]


def floor_bytes(n: int, density: float, wire_bytes_per_entry: int = 4):
    """``(fused_bytes, unfused_bytes, nc, k)`` one compression phase must
    move at n parameters (the byte model of the module docstring)."""
    from .ops.fused_select import _chunk_geometry, supports_density
    k = max(1, int(n * density))
    if supports_density(density):
        _, _, _, nc = _chunk_geometry(n, density)
    else:
        nc = n                       # the warm fallback scans the buffer
    k_term = 3 * wire_bytes_per_entry * k
    return 12 * n + 16 * nc + k_term, 24 * n + 16 * nc + k_term, nc, k


def exchange_bytes(k: int, nworkers: int, wire_bytes_per_entry: int = 4):
    """``(allgather_bytes, gtopk_bytes)`` one device moves a sparse
    exchange: k entries from each of P-1 peers on the all-gather, k
    entries a round for log2(P) rounds on the gTop-k butterfly (None
    unless P is a power of two above 1)."""
    ag = (nworkers - 1) * k * wire_bytes_per_entry
    gt = (int(math.log2(nworkers)) * k * wire_bytes_per_entry
          if nworkers > 1 and (nworkers & (nworkers - 1)) == 0 else None)
    return ag, gt


def _achieved(bench_path: str, platform: str):
    """Each config's achieved overhead (and exposed exchange) from a bench
    artifact priced on ``platform``; nothing for a foreign or absent
    one."""
    achieved, exposed, bench_platform = {}, {}, None
    if not os.path.exists(bench_path):
        return achieved, exposed, bench_platform
    try:
        with open(bench_path) as f:
            bench = json.load(f)
        bench_platform = bench["detail"].get("platform")
        if bench_platform == platform:
            for key, cell in bench["detail"]["configs"].items():
                achieved[key] = round(cell["sparse_step_ms"]
                                      - cell["dense_step_ms"], 3)
                if "exposed_exchange_ms" in cell:
                    exposed[key] = cell["exposed_exchange_ms"]
    except (ValueError, KeyError):
        pass                          # a stale or foreign artifact: floors
    return achieved, exposed, bench_platform


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m gaussiank_sgd_torch.roofline")
    ap.add_argument("--bw-n", type=int, default=57_000_000,
                    help="f32 elements in the bandwidth-probe buffer")
    ap.add_argument("--n-steps", type=int, default=20)
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--bw-gbps", type=float, default=None,
                    help="skip the probe and price the floors at this "
                         "GB/s (re-derive an artifact from a measured rate)")
    ap.add_argument("--density", type=float, default=0.001)
    ap.add_argument("--nworkers", type=int, default=8,
                    help="data-parallel size the exchange bytes are priced "
                         "for (the overlap floor)")
    ap.add_argument("--configs", nargs="*", default=None,
                    help="subset of config keys (default: all five)")
    ap.add_argument("--out", default=os.path.join(ARTIFACTS, "roofline.json"),
                    help="the artifact; a bench_last.json beside it is "
                         "read for the achieved overheads")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu, only when asked")
    args = ap.parse_args(argv)

    from .device import card_line, resolve_device
    dev = resolve_device(args.device)
    platform = dev.type
    name = torch.cuda.get_device_name(dev) if platform == "cuda" else "cpu"
    card = card_line(dev)

    if args.bw_gbps is not None:
        bw_gbps, bw_rounds = args.bw_gbps, []
    else:
        bw_gbps, bw_rounds = measure_bandwidth_gbps(
            args.bw_n, n_steps=args.n_steps, rounds=args.rounds, device=dev)

    out_dir = os.path.dirname(os.path.abspath(args.out))
    achieved, achieved_exposed, bench_platform = _achieved(
        os.path.join(out_dir, "bench_last.json"), platform)

    configs = {}
    for key, model, dataset in CONFIG_MODELS:
        if args.configs and key not in args.configs:
            continue
        n = param_count(model, dataset)
        fused, unfused, nc, k = floor_bytes(n, args.density)
        floor_ms = 1e3 * fused / (bw_gbps * 1e9)
        ag_bytes, gt_bytes = exchange_bytes(k, args.nworkers)
        ag_ms = 1e3 * ag_bytes / (bw_gbps * 1e9)
        cell = {
            "params": n,
            "k": k,
            "candidates": nc,
            "fused_bytes": fused,
            "unfused_bytes": unfused,
            "floor_ms": round(floor_ms, 3),
            "floor_unfused_ms": round(1e3 * unfused / (bw_gbps * 1e9), 3),
            "exchange_bytes_allgather": ag_bytes,
            "exchange_bytes_gtopk": gt_bytes,
            "exchange_ms": round(ag_ms, 3),
            "overlap_floor_ms": round(max(0.0, ag_ms - floor_ms), 3),
        }
        if key in achieved_exposed:
            cell["achieved_exposed_exchange_ms"] = achieved_exposed[key]
            cell["exposed_above_overlap_floor_ms"] = round(
                achieved_exposed[key] - cell["overlap_floor_ms"], 3)
        if key in achieved:
            cell["achieved_overhead_ms"] = achieved[key]
            cell["overhead_vs_floor"] = (
                round(achieved[key] / floor_ms, 3) if floor_ms > 0 else None)
            cell["within_1p3x_floor"] = bool(achieved[key] <= 1.3 * floor_ms)
        configs[key] = cell
        print(f"# {key}: n={n} floor {cell['floor_ms']} ms"
              + (f" achieved {cell.get('achieved_overhead_ms')} ms"
                 f" ({cell.get('overhead_vs_floor')}x)"
                 if key in achieved else ""), flush=True)

    res = {
        "bandwidth_gbps": round(bw_gbps, 2),
        "bandwidth_rounds_gbps": bw_rounds,
        "bw_probe": ({"method": "--bw-gbps override: floors re-priced from "
                                "a previously measured rate (no probe "
                                "this run)"}
                     if args.bw_gbps is not None else
                     {"n": args.bw_n, "n_steps": args.n_steps,
                      "rounds": args.rounds,
                      "bytes_per_step": 8 * args.bw_n,
                      "method": "loop-carried f32 scale pass a.mul_(c) (1 "
                                "read + 1 write), " + (
                                    "CUDA events around each round's loop"
                                    if platform == "cuda" else
                                    "host clock around each round's loop")
                                + "; median of rounds"}),
        "density": args.density,
        "byte_model": "fused: 12n + 16nc + 12k; unfused: 24n + 16nc + 12k "
                      "(u16bf16 packed wire, 4 bytes/entry x 3 stages; k = "
                      "max(1, int(n * density)))",
        "wire_format": "u16bf16",
        "nworkers": args.nworkers,
        "overlap_floor_model": "max(0, exchange_ms - floor_ms): the "
                               "pipeline hides exchange behind later-chunk "
                               "compression, so exchange time beyond the "
                               "compression floor cannot be hidden "
                               "(exchange priced on the all-gather path, "
                               "same measured rate)",
        "configs": configs,
        "bench_platform": bench_platform,
        "platform": platform,
        "device": name,
        "power_limit": card.rsplit(",", 1)[-1].strip() if card else None,
        "gate": "achieved compression overhead <= 1.3 * floor_ms (for "
                "configs below 0.90)",
    }
    os.makedirs(out_dir, exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(res, f, indent=2)
        f.write("\n")
    print(json.dumps({"bandwidth_gbps": res["bandwidth_gbps"],
                      "platform": platform, "device": name,
                      "power_limit": res["power_limit"],
                      "floors_ms": {k: c["floor_ms"]
                                    for k, c in configs.items()},
                      "artifact": os.path.relpath(os.path.abspath(args.out),
                                                  REPO)}))
    return res


if __name__ == "__main__":
    main(sys.argv[1:])
