"""The headline bench driver: the port of the repository's ``bench.py``.

Run on the card: ``python -m gaussiank_sgd_torch.bench`` (all five
BASELINE configs, ~minutes), ``--configs vgg16 --overlap-arm``, or
``--smoke`` (mnistnet on a uniform 8,192-element plan, with both gates);
``--device cpu`` runs on the CPU only when asked. It prints one JSON line
last.

The headline metric is sparse-step throughput as a fraction of the dense
step's on the same model and batch, ``sparse_vs_dense_step_throughput_ratio``
(target >= 0.90). Each config runs the registry's ex-ante default selector
(``compressors.registry.DEFAULT_SELECTOR``, ``gaussian_fused``: the warm
GaussianK threshold on kernel B1) against the dense step in
``benchlib.bench_model``'s interleaved rotated rounds, grouped into
``WINDOWS`` windows; a config's binding ratio is the min over its windows'
paired medians, and the value is the worst config's. resnet20 also sweeps
``SWEEP`` and names the fastest as a secondary field only.

Outputs, in ``--out-dir`` (default ``gaussiank_sgd_torch/artifacts/``):
``bench_last.json`` (the whole result), ``bench_events.jsonl`` (one
``bench_model`` record a config, ``bench_overlap`` for each overlap arm and
a ``bench_summary``, schema-validated as they are published) and, unless
``--no-history``, one record appended to ``--history`` (default
``bench_history.jsonl`` there), the regression sentinel's input
(``python -m gaussiank_sgd_torch.telemetry.sentinel``). Each config's
overhead (sparse - dense step ms) is set against its roofline floor when
one was priced on this card (``python -m gaussiank_sgd_torch.roofline``).

Nothing is caught: a kernel that does not build or launch, a missing GPU
or a failed gate stops the run.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time
from typing import List, Optional

import torch

from .compressors import DEFAULT_SELECTOR
from .policy.rules import load_roofline_floor
from .telemetry import EventBus, JSONLExporter
from .telemetry.history import (append_history, build_history_record,
                                git_revision)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARTIFACTS = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "artifacts")

FIXED = DEFAULT_SELECTOR        # the registry's ex-ante policy
SWEEP = (FIXED, "gaussian_warm", "approxtopk16")

# (key, model, dataset, batch a card, n_steps, rounds a window): the
# reference's per-chip batches (config 5's is exp_configs/config5*.json's);
# the noisier cells take more rounds
CONFIGS = (
    ("resnet20", "resnet20", "cifar10", 1024, 40, 3),
    ("vgg16", "vgg16", "cifar10", 256, 20, 4),
    ("resnet50", "resnet50", "imagenet", 64, 10, 3),
    ("lstm_ptb", "lstm", "ptb", 160, 10, 4),
    ("transformer_wmt", "transformer", "wmt", 32, 10, 4),
)
# every config's rounds run WINDOWS independent times; its binding ratio
# is the min over the windows' paired medians, so slow drift between
# windows cannot carry a >= 0.90 claim that a re-measurement would retract
WINDOWS = 2

# --smoke: one tiny config that drives the whole harness and its records,
# not a throughput number, on a uniform 8,192-element plan: within the
# packed wire's chunk limit (65,536) and block-aligned for B1, so both the
# wire and the pipelined schedule are exercised and gated
SMOKE_CONFIGS = (
    ("mnistnet", "mnistnet", "mnist", 8, 2, 2),
)
SMOKE_BUCKETS = {"bucket_policy": "uniform", "bucket_size": 8192}


def _ratios(times, name):
    """Median, min and max sparse:dense ratios of the per-round samples,
    paired by round (both programs ran in every round), with the
    per-window paired medians and their min, the config's binding ratio."""
    dr = times["_rounds"]["dense"]
    sr = times["_rounds"][name]
    per_round = [d / s for d, s in zip(dr, sr)]
    dw = times.get("_windows", {}).get("dense") or [dr]
    sw = times.get("_windows", {}).get(name) or [sr]
    window_medians = [
        round(statistics.median([d / s for d, s in zip(dwin, swin)]), 4)
        for dwin, swin in zip(dw, sw)]
    return {
        "ratio_median": round(statistics.median(per_round), 4),
        "ratio_min": round(min(per_round), 4),
        "ratio_max": round(max(per_round), 4),
        "rounds": len(per_round),
        "round_ratios": [round(r, 4) for r in per_round],
        "windows": len(window_medians),
        "window_medians": window_medians,
        "ratio_window_min": min(window_medians),
    }


def _load_roofline(configs, platform: str, device_name: Optional[str]):
    """Each config's ``floor_ms`` from the roofline artifact priced on this
    platform (on the card: on a card of this name), ``{}`` where none is."""
    floors = {}
    for key, model, *_ in configs:
        floor = load_roofline_floor(model, platform, device_name=device_name)
        if floor is not None:
            floors[key] = floor
    return floors


def main(argv: Optional[List[str]] = None):
    from . import benchlib
    from .device import card_line, resolve_device

    # default [] (not sys.argv): tests call main() inside pytest
    ap = argparse.ArgumentParser(prog="python -m gaussiank_sgd_torch.bench")
    ap.add_argument("--smoke", action="store_true",
                    help="one tiny config: drives the harness, its records "
                         "and both gates, not a real number")
    ap.add_argument("--configs", nargs="*", default=None,
                    help="subset of config keys to run (default: all)")
    ap.add_argument("--overlap-arm", action="store_true",
                    help="also time each config's off-vs-auto schedule "
                         "pair on a pipeline-eligible uniform plan (always "
                         "on under --smoke)")
    ap.add_argument("--history", default=None, metavar="PATH",
                    help="bench-history JSONL to append this run's record "
                         "to (default: bench_history.jsonl in --out-dir)")
    ap.add_argument("--no-history", action="store_true",
                    help="skip the history append (throwaway runs)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu, only when asked")
    ap.add_argument("--out-dir", default=ARTIFACTS,
                    help="where bench_last.json and bench_events.jsonl go")
    args = ap.parse_args([] if argv is None else argv)

    dev = resolve_device(args.device)
    platform = dev.type
    name = torch.cuda.get_device_name(dev) if platform == "cuda" else "cpu"
    card = card_line(dev)
    out_dir = os.path.abspath(args.out_dir)
    os.makedirs(out_dir, exist_ok=True)
    # one schema-validated record a config and a summary: each run a fresh
    # single-run stream (mode 'w'); a schema drift fails here
    bus = EventBus([JSONLExporter(
        os.path.join(out_dir, "bench_events.jsonl"), mode="w")],
        validate=True)

    density = 0.001
    detail_configs = {}
    headline = None
    configs = SMOKE_CONFIGS if args.smoke else CONFIGS
    floors = _load_roofline(configs, platform, name)
    for key, model, dataset, batch, n_steps, rounds in configs:
        if args.configs and key not in args.configs:
            continue
        # the flagship config also runs the selector sweep (a secondary
        # field); the others run the fixed selector only
        comps = SWEEP if key == "resnet20" else (FIXED,)
        times = benchlib.bench_model(
            model, dataset, batch, density, comps, n_steps=n_steps,
            rounds=rounds, windows=WINDOWS, device=dev,
            **(SMOKE_BUCKETS if args.smoke else {}))
        flops = times.get("_dense_step_flops")
        peak = times.get("_peak_flops")
        md = benchlib.mfu(flops, times["dense"], peak)
        ms = benchlib.mfu(flops, times[FIXED], peak)
        cell = {
            "compressor": FIXED,
            "dense_step_ms": round(1e3 * times["dense"], 3),
            "sparse_step_ms": round(1e3 * times[FIXED], 3),
            "ex_per_s_chip": round(batch / times[FIXED], 1),
            "mfu_dense": round(md, 4) if md else None,
            "mfu_sparse": round(ms, 4) if ms else None,
            **_ratios(times, FIXED),
        }
        # the compression overhead against the config's memory floor
        cell["overhead_ms"] = round(cell["sparse_step_ms"]
                                    - cell["dense_step_ms"], 3)
        # a bytes number travels with its wire format
        ex = times.get("_exchange", {}).get(FIXED, {})
        cell["wire_format"] = ex.get("wire_format")
        cell["bytes_sent"] = ex.get("bytes_sent")
        # the schedule the sparse program ran ("off" on a whole bucket)
        cell["overlap"] = ex.get("overlap")
        if key in floors:
            cell["roofline_floor_ms"] = floors[key]
            cell["overhead_vs_floor"] = (
                round(cell["overhead_ms"] / floors[key], 3)
                if floors[key] > 0 else None)
        if key == "resnet20":
            winner = min(SWEEP, key=lambda c: times[c])
            cell["winner_secondary"] = {
                "compressor": winner,
                **_ratios(times, winner),
                "all_sparse_ms": {c: round(1e3 * times[c], 3)
                                  for c in SWEEP},
            }
            headline = cell
        detail_configs[key] = cell
        bus.emit("bench_model", key=key, model=model, dataset=dataset,
                 batch=batch, compressor=FIXED,
                 dense_step_ms=cell["dense_step_ms"],
                 sparse_step_ms=cell["sparse_step_ms"],
                 ratio_median=cell["ratio_median"],
                 ratio_min=cell["ratio_min"],
                 ratio_max=cell["ratio_max"],
                 rounds=cell["rounds"],
                 windows=cell["windows"],
                 window_medians=cell["window_medians"],
                 ratio_window_min=cell["ratio_window_min"],
                 ex_per_s_chip=cell["ex_per_s_chip"],
                 mfu_dense=cell["mfu_dense"],
                 mfu_sparse=cell["mfu_sparse"],
                 overhead_ms=cell["overhead_ms"],
                 roofline_floor_ms=cell.get("roofline_floor_ms"),
                 overhead_vs_floor=cell.get("overhead_vs_floor"),
                 wire_format=cell["wire_format"],
                 bytes_sent=cell["bytes_sent"],
                 overlap=cell["overlap"])
        print(f"# {key}: window_min {cell['ratio_window_min']} "
              f"median {cell['ratio_median']} "
              f"min {cell['ratio_min']} mfu_dense {cell['mfu_dense']}",
              flush=True)
        if args.smoke:
            # the smoke plan is wire-eligible by construction: the payload
            # must be the packed words, <= 0.55 x the i32 + f32 pairs at
            # the same k (a ValueError, not an assert: it fires under -O)
            fp32_bytes = ex["total_k"] * 8
            if (ex.get("wire_format") != "u16bf16"
                    or ex["bytes_sent"] > 0.55 * fp32_bytes):
                raise ValueError(
                    f"smoke wire gate failed: wire_format="
                    f"{ex.get('wire_format')!r}, bytes_sent="
                    f"{ex.get('bytes_sent')} vs fp32+i32 {fp32_bytes} "
                    f"(need u16bf16 and <= 0.55x)")

        if args.overlap_arm or args.smoke:
            # the same model and selector under both step schedules on one
            # pipeline-eligible uniform plan, each with its exchange-ablated
            # twin, in the same rotated rounds
            ob = benchlib.bench_overlap(
                model, dataset, batch, density, FIXED, n_steps=n_steps,
                rounds=rounds, windows=WINDOWS, device=dev,
                bucket_size=(SMOKE_BUCKETS["bucket_size"] if args.smoke
                             else 1 << 22))
            om, oe = ob["_meta"], ob["exposed_exchange_ms"]
            arm = {
                "seq_step_ms": round(1e3 * ob["seq"], 3),
                "pipe_step_ms": round(1e3 * ob["pipe"], 3),
                "pipe_vs_seq": round(ob["seq"] / ob["pipe"], 4),
                "exposed_seq_ms": oe["seq"],
                "exposed_pipe_ms": oe["pipe"],
                "seq_overlap": om["seq_overlap"],
                "pipe_overlap": om["pipe_overlap"],
                "bucket_size": om["bucket_size"],
                "n_buckets": om["n_buckets"],
                "wire_format": om.get("wire_format"),
                "bytes_sent": om.get("pipe_bytes_sent"),
                "overlapped_bytes_sent": om.get("overlapped_bytes_sent"),
            }
            cell["overlap_arm"] = arm
            bus.emit("bench_overlap", key=key, model=model,
                     compressor=FIXED, rounds=rounds, windows=WINDOWS,
                     **{k: v for k, v in arm.items() if v is not None})
            print(f"# {key} overlap arm: seq {arm['seq_step_ms']} ms "
                  f"(exposed {arm['exposed_seq_ms']}) vs pipe "
                  f"{arm['pipe_step_ms']} ms (exposed "
                  f"{arm['exposed_pipe_ms']}), x{arm['pipe_vs_seq']}",
                  flush=True)
            if args.smoke and (arm["pipe_overlap"] != "pipelined"
                               or arm["seq_overlap"] != "off"
                               or not arm["overlapped_bytes_sent"]):
                # the smoke plan is pipeline-eligible by construction: the
                # 'auto' build must be the pipelined schedule and have sent
                # payload bytes before the last chunk compressed
                raise ValueError(
                    f"smoke overlap gate failed: seq_overlap="
                    f"{arm['seq_overlap']!r}, pipe_overlap="
                    f"{arm['pipe_overlap']!r}, overlapped_bytes_sent="
                    f"{arm['overlapped_bytes_sent']}")
        if platform == "cuda":
            torch.cuda.empty_cache()

    # the contract is "every config >= 0.90": the value is the min over
    # the configs' binding ratios, each the min of its window medians
    worst_key, worst = min(detail_configs.items(),
                           key=lambda kv: kv[1]["ratio_window_min"])
    value = worst["ratio_window_min"]
    bus.emit("bench_summary",
             metric="sparse_vs_dense_step_throughput_ratio", value=value,
             worst_config=worst_key, smoke=args.smoke,
             windows=WINDOWS,
             rounds=sum(c["rounds"] for c in detail_configs.values()))
    bus.close()
    result = {
        "metric": "sparse_vs_dense_step_throughput_ratio",
        "value": value,
        "unit": "ratio",
        "vs_baseline": round(value / 0.90, 4),
        "detail": {
            "headline": f"WORST-config min-over-{WINDOWS}-windows paired "
                        f"median ratio ({worst_key}) over all 5 BASELINE "
                        f"configs, ex-ante default selector {FIXED} "
                        f"(registry.DEFAULT_SELECTOR policy), "
                        f"density {density}",
            "worst_config": worst_key,
            "worst_config_ratio_window_min": worst["ratio_window_min"],
            "worst_config_ratio_median": worst["ratio_median"],
            "flagship_ratio_median": (headline["ratio_median"]
                                      if headline else None),
            "configs": detail_configs,
            "methodology": "n_steps-step make_multi_step call a sample, "
                           "CUDA events around it and a synchronise after "
                           "(the host clock on the CPU), interleaved "
                           f"rotated rounds grouped into {WINDOWS} windows; "
                           "ratios paired per round; per-window medians, "
                           "min-across-windows headline, pooled median "
                           "secondary",
            "platform": platform,
            "device": name,
            "card": card,
            "n_devices": 1,
        },
    }
    # the whole result goes to a file; the last stdout line stays compact
    last = os.path.join(out_dir, "bench_last.json")
    with open(last, "w") as f:
        json.dump(result, f, indent=2)
    if not args.no_history:
        append_history(
            args.history or os.path.join(out_dir, "bench_history.jsonl"),
            build_history_record(result, smoke=args.smoke, ts=time.time(),
                                 git_rev=git_revision(REPO)))
    compact = {
        "metric": result["metric"], "value": value, "unit": "ratio",
        "vs_baseline": result["vs_baseline"],
        "detail": {
            "policy": f"fixed ex-ante default selector {FIXED}; value = "
                      f"worst-config min-over-window medians ({worst_key})",
            "worst_config": worst_key,
            "worst_config_ratio_window_min": worst["ratio_window_min"],
            "worst_config_ratio_median": worst["ratio_median"],
            "config_window_mins": {k: c["ratio_window_min"]
                                   for k, c in detail_configs.items()},
            "config_medians": {k: c["ratio_median"]
                               for k, c in detail_configs.items()},
            "config_spreads": {k: [c["ratio_min"], c["ratio_max"]]
                               for k, c in detail_configs.items()},
            "rounds": {k: c["rounds"] for k, c in detail_configs.items()},
            "overhead_vs_floor": {k: c["overhead_vs_floor"]
                                  for k, c in detail_configs.items()
                                  if c.get("overhead_vs_floor")
                                  is not None} or None,
            "overlap_arm": {k: {"exposed_seq_ms":
                                c["overlap_arm"]["exposed_seq_ms"],
                                "exposed_pipe_ms":
                                c["overlap_arm"]["exposed_pipe_ms"],
                                "pipe_vs_seq":
                                c["overlap_arm"]["pipe_vs_seq"]}
                            for k, c in detail_configs.items()
                            if "overlap_arm" in c} or None,
            "platform": platform,
            "full_detail": os.path.relpath(last, REPO),
        },
    }
    print(json.dumps(compact))
    return result


if __name__ == "__main__":
    main(sys.argv[1:])
