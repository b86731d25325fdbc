"""The BASELINE config matrix, measured: the port of
``analysis/bench_matrix.py``.

For each BASELINE config's model: the dense step and the sparse step of
each selector in ``COMPRESSORS`` over the density sweep ``DENSITIES``,
with examples a second, the sparse:dense ratio (the min-of-rounds ratio
and the round-paired median with its spread), MFU, and a phase split from
the ``ef_only`` probe timed in the same rotated rounds (forward + backward
+ update = the dense program; exchange = the probe over dense; select +
pack = the selector over the probe; a split below its rounds' own noise
reads ``< noise``). One card: the collective's cost at 8-64 workers is not
in these numbers.

Run: ``python -m gaussiank_sgd_torch.bench_matrix [--quick] [--configs
config2] [--tag NAME] [--densities 0.1,0.01]`` (``--device cpu`` only when
asked). It writes ``bench_matrix[_TAG].json`` after every config and
``bench_matrix[_TAG].md`` at the end, in ``--out-dir`` (default
``gaussiank_sgd_torch/artifacts/``), and prints the markdown table.
``measure`` is the same run as a function, with ``max_steps`` capping each
config's steps a timed run (the A/B harness's ``--measure`` takes 10).
"""

# gklint: disable-file=print-in-library -- this module is the CLI of `python -m gaussiank_sgd_torch.bench_matrix`: its main() prints the report, which is the command's output

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys

ARTIFACTS = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "artifacts")

# (config name, model, dataset, batch a card, model_kwargs, n_steps,
#  bucket policy, bucket size): every config on the whole-model bucket
CONFIGS = [
    ("config1_resnet20", "resnet20", "cifar10", 1024, {}, 40, "greedy", None),
    ("config2_vgg16", "vgg16", "cifar10", 256, {}, 20, "greedy", None),
    ("config3_resnet50", "resnet50", "imagenet", 64, {}, 10, "greedy", None),
    ("config4_lstm_ptb", "lstm", "ptb", 160, {}, 10, "greedy", None),
    ("config5_transformer", "transformer", "wmt", 32, {}, 10, "greedy", None),
]
DENSITIES = (0.1, 0.01, 0.001)
COMPRESSORS = ("approxtopk", "gaussian", "gaussian_warm", "approxtopk16",
               "gaussian_fused")
# the prefix probe of each cell's phase split (benchlib.ablation_specs)
PROBE = "ef_only"


def main(argv=None):
    p = argparse.ArgumentParser(
        prog="python -m gaussiank_sgd_torch.bench_matrix")
    p.add_argument("--quick", action="store_true",
                   help="one density, fewer rounds (smoke)")
    p.add_argument("--configs", default=None,
                   help="comma-separated substring filter on config names")
    p.add_argument("--tag", default="",
                   help="suffix of the artifacts' names (e.g. 'paired' -> "
                        "bench_matrix_paired.{json,md}), so a run never "
                        "overwrites one it is compared with")
    p.add_argument("--densities", default=None,
                   help="comma list overriding the density sweep "
                        "(e.g. '0.1,0.01')")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu, only when asked")
    p.add_argument("--out-dir", default=ARTIFACTS)
    args = p.parse_args(argv)
    densities = (tuple(float(d) for d in args.densities.split(","))
                 if args.densities else None)
    return measure(quick=args.quick, configs=args.configs, tag=args.tag,
                   densities=densities, device=args.device,
                   out_dir=args.out_dir)


def measure(*, quick: bool = False, configs=None, tag: str = "",
            densities=None, device: str = "cuda", out_dir: str = ARTIFACTS,
            max_steps=None):
    """The matrix run of ``main``'s flags; ``max_steps`` caps each
    config's ``n_steps``. The rows it wrote."""
    from .benchlib import bench_model, mfu, noise_floored_delta_ms
    from .device import resolve_device
    from .ops.fused_select import supports_density

    dev = resolve_device(device)
    if densities is None:
        densities = (0.001,) if quick else DENSITIES
    rounds = 3 if quick else 6
    suffix = f"_{tag}" if tag else ""
    os.makedirs(out_dir, exist_ok=True)

    results = []
    for name, model, dataset, batch, mkw, n_steps, policy, bsize in CONFIGS:
        if configs and not any(s in name for s in configs.split(",")):
            continue
        row = {"config": name, "model": model, "batch_per_chip": batch,
               "bucket_policy": policy, "bucket_size": bsize,
               "platform": dev.type, "cells": []}
        for d in densities:
            print(f"=== {name} density={d} ===", flush=True)
            comps = tuple(c for c in COMPRESSORS
                          if c != "gaussian_fused" or supports_density(d))
            times = bench_model(model, dataset, batch, d, comps + (PROBE,),
                                n_steps=min(n_steps, max_steps or n_steps),
                                rounds=rounds, model_kwargs=mkw,
                                bucket_policy=policy, bucket_size=bsize,
                                device=dev)
            dense = times["dense"]
            flops = times.get("_dense_step_flops")
            peak = times.get("_peak_flops")
            rnds = times.get("_rounds", {})
            for c in comps:
                md, ms = mfu(flops, dense, peak), mfu(flops, times[c], peak)
                # ratios paired within a rotated round: robust to drift
                # across rounds
                paired = [dn / sp for dn, sp in
                          zip(rnds.get("dense", []), rnds.get(c, []))]
                row["cells"].append({
                    "density": d, "compressor": c,
                    "dense_ms": round(1e3 * dense, 3),
                    "sparse_ms": round(1e3 * times[c], 3),
                    "ratio": round(dense / times[c], 4),
                    "ratio_median_paired": (round(
                        statistics.median(paired), 4) if paired else None),
                    "ratio_spread_paired": (
                        [round(min(paired), 4), round(max(paired), 4)]
                        if paired else None),
                    "ex_per_s_chip": round(batch / times[c], 1),
                    "flops_per_step": flops,
                    "mfu_dense": round(md, 4) if md else None,
                    "mfu_sparse": round(ms, 4) if ms else None,
                    # the phase split, every figure from the same paired
                    # estimator; None ("< noise") below the rounds' noise
                    "fwd_bwd_ms": (round(1e3 * statistics.median(
                        rnds["dense"]), 3) if rnds.get("dense") else None),
                    "exchange_ms": noise_floored_delta_ms(
                        rnds, PROBE, "dense"),
                    "select_pack_ms": noise_floored_delta_ms(
                        rnds, c, PROBE),
                })
            print(json.dumps(row["cells"][-len(comps):]), flush=True)
        results.append(row)
        # written after every config: a later config's failure keeps the
        # earlier measurements
        with open(os.path.join(out_dir, f"bench_matrix{suffix}.json"),
                  "w") as f:
            json.dump(results, f, indent=2)

    table = render_md(results)
    with open(os.path.join(out_dir, f"bench_matrix{suffix}.md"),
              "w") as f:
        f.write(table + "\n")
    print(table)
    return results


def render_md(results) -> str:
    lines = ["| Config | density | compressor | dense ms | sparse ms | "
             "sparse:dense | paired median | paired spread | ex/s/chip | "
             "MFU dense | MFU sparse | phases fb/ex/sel ms |",
             "|---|---|---|---|---|---|---|---|---|---|---|---|"]
    for row in results:
        for c in row["cells"]:
            def fmt(v):
                return f"{100 * v:.1f}%" if v else "—"
            spread = c.get("ratio_spread_paired")
            ex = c.get("exchange_ms")
            sel = c.get("select_pack_ms")
            lines.append(
                f"| {row['config']} (b={row['batch_per_chip']}) "
                f"| {c['density']} | {c['compressor']} | {c['dense_ms']} "
                f"| {c['sparse_ms']} | {c['ratio']} "
                f"| {c.get('ratio_median_paired') or '—'} "
                f"| {f'{spread[0]}–{spread[1]}' if spread else '—'} "
                f"| {c['ex_per_s_chip']} | {fmt(c['mfu_dense'])} "
                f"| {fmt(c['mfu_sparse'])} "
                f"| {c.get('fwd_bwd_ms') or '—'}"
                f"/{ex if ex is not None else '< noise'}"
                f"/{sel if sel is not None else '< noise'} |")
    return "\n".join(lines)


if __name__ == "__main__":
    main(sys.argv[1:])
