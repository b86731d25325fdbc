"""Cross-run regression sentinel over the bench history: the port of
``analysis/regression_sentinel.py``.

    python -m gaussiank_sgd_torch.telemetry.sentinel            # newest vs auto
    python -m gaussiank_sgd_torch.telemetry.sentinel --tol 0.05 --json
    python -m gaussiank_sgd_torch.telemetry.sentinel --self-test

Compares the newest record of ``--history`` (default
``gaussiank_sgd_torch/artifacts/bench_history.jsonl``, which ``python -m
gaussiank_sgd_torch.bench`` appends to) with a baseline (default: the
latest earlier record with the same ``smoke`` flag and at least one shared
config) and classifies every shared config as improved, flat or
regressed, printing a trajectory table. Exit codes: 0 no regression, 1 a
regression beyond the tolerance, 2 a usage or data error.

The classifier is ``benchlib.noise_floored_delta_ms``, the estimator of
the bench's own phase deltas, over the two records' per-window paired
medians: a config counts as regressed (or improved) only when the paired
median of its window-median drops clears both the dispersion of those
drops and the relative tolerance. The estimator multiplies by 1e3
(seconds to ms); ratios have no unit, so they are divided by 1e3 first
and the factor cancels.

``--emit-event`` appends the verdict as a ``bench_regression`` record to
a telemetry stream, which the policy engine's signals
(``policy/signals.py``) and the health monitor ingest.
"""

# gklint: disable-file=print-in-library -- this module is the CLI of `python -m gaussiank_sgd_torch.telemetry.sentinel`: its main() prints the report, which is the command's output

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
from typing import Any, Dict, List, Mapping, Optional, Tuple

from ..benchlib import noise_floored_delta_ms
from .history import load_history

DEFAULT_HISTORY = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "artifacts", "bench_history.jsonl")
DEFAULT_TOL = 0.05      # relative drop in the ratio that counts as real


def _window_medians(rec: Mapping[str, Any], key: str) -> Optional[List[float]]:
    cell = (rec.get("configs") or {}).get(key) or {}
    wm = cell.get("window_medians")
    if isinstance(wm, list) and wm and all(
            isinstance(v, (int, float)) and not isinstance(v, bool)
            for v in wm):
        return [float(v) for v in wm]
    return None


def _scalar(rec: Mapping[str, Any], key: str) -> Optional[float]:
    cell = (rec.get("configs") or {}).get(key) or {}
    for f in ("ratio_window_min", "ratio_median"):
        v = cell.get(f)
        if isinstance(v, (int, float)) and not isinstance(v, bool):
            return float(v)
    return None


def classify_config(base: Mapping[str, Any], new: Mapping[str, Any],
                    key: str, tol: float) -> Tuple[str, Optional[float]]:
    """``(status, delta)`` for one shared config; delta is the signed
    change of the binding ratio (negative: worse), None below the noise.

    With window medians in both records: the noise-floored paired delta
    over them (divided by 1e3 first, so the estimator's seconds-to-ms
    factor cancels). Without (an old or foreign record): a plain threshold
    on ``ratio_window_min``, with no noise floor."""
    wb, wn = _window_medians(base, key), _window_medians(new, key)
    sb, sn = _scalar(base, key), _scalar(new, key)
    if wb is not None and wn is not None and len(wb) == len(wn):
        rounds = {"base": [v / 1e3 for v in wb],
                  "new": [v / 1e3 for v in wn]}
        base_med = float(statistics.median(wb))
        drop = noise_floored_delta_ms(rounds, "base", "new")
        if drop is not None and drop > tol * base_med:
            return "regressed", round(-drop, 4)
        gain = noise_floored_delta_ms(rounds, "new", "base")
        if gain is not None and gain > tol * base_med:
            return "improved", round(gain, 4)
        return "flat", None
    if sb is None or sn is None or sb <= 0:
        return "flat", None
    delta = sn - sb
    if delta < -tol * sb:
        return "regressed", round(delta, 4)
    if delta > tol * sb:
        return "improved", round(delta, 4)
    return "flat", None


def pick_baseline(history: List[Dict[str, Any]], new: Mapping[str, Any],
                  baseline_rev: Optional[str],
                  baseline_index: Optional[int]) -> Optional[Dict[str, Any]]:
    """The record to compare against: an explicit rev or index, else the
    latest earlier record with the same smoke flag and a shared config (a
    smoke timing says nothing of a real run's trajectory). Records marked
    ``"synthetic": true`` (hand-written rows, never bench output) are
    skipped on the automatic path, so a verdict anchors to measured
    numbers; an explicit rev or index still reaches them."""
    if baseline_index is not None:
        return (history[baseline_index]
                if -len(history) <= baseline_index < len(history) else None)
    if baseline_rev is not None:
        for rec in reversed(history):
            if rec.get("git_rev") == baseline_rev and rec is not new:
                return rec
        return None
    new_keys = set((new.get("configs") or {}).keys())
    for rec in reversed(history):
        if rec is new:
            continue
        if rec.get("ts", 0) > new.get("ts", 0):
            continue
        if bool(rec.get("smoke")) != bool(new.get("smoke")):
            continue
        if rec.get("synthetic"):
            continue
        if new_keys & set((rec.get("configs") or {}).keys()):
            return rec
    return None


def compare(base: Mapping[str, Any], new: Mapping[str, Any],
            tol: float) -> Dict[str, Any]:
    """The verdict over the configs both records hold."""
    shared = sorted(set((base.get("configs") or {}))
                    & set((new.get("configs") or {})))
    per_config: Dict[str, Any] = {}
    counts = {"improved": 0, "flat": 0, "regressed": 0}
    worst_key, worst_delta = None, 0.0
    for key in shared:
        status, delta = classify_config(base, new, key, tol)
        counts[status] += 1
        per_config[key] = {
            "status": status, "delta": delta,
            "base": _scalar(base, key), "new": _scalar(new, key),
        }
        if status == "regressed" and delta is not None \
                and delta < worst_delta:
            worst_key, worst_delta = key, delta
    status = "regressed" if counts["regressed"] else (
        "improved" if counts["improved"] else "flat")
    return {
        "status": status,
        "baseline_rev": str(base.get("git_rev", "unknown")),
        "new_rev": str(new.get("git_rev", "unknown")),
        "tolerance": tol,
        "smoke": bool(new.get("smoke")),
        "n_regressed": counts["regressed"],
        "n_improved": counts["improved"],
        "n_flat": counts["flat"],
        "worst_config": worst_key,
        "worst_delta": round(worst_delta, 4) if worst_key else None,
        "configs": per_config,
    }


def format_table(verdict: Mapping[str, Any]) -> str:
    lines = [
        f"bench trajectory: {verdict['baseline_rev']} -> "
        f"{verdict['new_rev']}  (tol {verdict['tolerance']:.0%}"
        f"{', smoke' if verdict['smoke'] else ''})",
        f"{'config':<18} {'base':>8} {'new':>8} {'delta':>8}  status",
    ]
    for key, c in sorted(verdict["configs"].items()):
        base = f"{c['base']:.4f}" if c["base"] is not None else "-"
        new = f"{c['new']:.4f}" if c["new"] is not None else "-"
        delta = (f"{c['delta']:+.4f}" if c["delta"] is not None
                 else "< noise")
        lines.append(f"{key:<18} {base:>8} {new:>8} {delta:>8}  "
                     f"{c['status']}")
    lines.append(
        f"=> {verdict['status'].upper()}: "
        f"{verdict['n_regressed']} regressed, "
        f"{verdict['n_improved']} improved, {verdict['n_flat']} flat"
        + (f"; worst {verdict['worst_config']} "
           f"{verdict['worst_delta']:+.4f}"
           if verdict.get("worst_config") else ""))
    return "\n".join(lines)


def emit_event(path: str, verdict: Mapping[str, Any]) -> None:
    """Append the verdict to ``path`` as a validated ``bench_regression``
    record."""
    from .bus import EventBus
    from .exporters import JSONLExporter
    bus = EventBus([JSONLExporter(path, mode="a")], validate=True)
    bus.emit("bench_regression",
             status=verdict["status"],
             baseline_rev=verdict["baseline_rev"],
             new_rev=verdict["new_rev"],
             n_regressed=verdict["n_regressed"],
             n_improved=verdict["n_improved"],
             n_flat=verdict["n_flat"],
             worst_config=verdict.get("worst_config"),
             worst_delta=verdict.get("worst_delta"),
             tolerance=verdict["tolerance"],
             smoke=verdict["smoke"])
    bus.close()


def _perturb(rec: Dict[str, Any], factor: float,
             jitter: float = 0.0) -> Dict[str, Any]:
    """A deep copy of ``rec`` with every ratio scaled by ``factor`` and the
    window medians nudged by -jitter, +jitter, ... in turn: the
    self-test's synthetic regression and noise."""
    out = json.loads(json.dumps(rec))
    out["git_rev"] = f"synthetic-{factor}"
    out["ts"] = float(out.get("ts", 0)) + 1.0
    for cell in (out.get("configs") or {}).values():
        for f in ("ratio_median", "ratio_window_min"):
            if isinstance(cell.get(f), (int, float)):
                cell[f] = round(cell[f] * factor, 4)
        wm = cell.get("window_medians")
        if isinstance(wm, list):
            cell["window_medians"] = [
                round(v * factor + (jitter if i % 2 else -jitter), 4)
                for i, v in enumerate(wm)]
    return out


def self_test(history: List[Dict[str, Any]], tol: float) -> int:
    """The detector must fire on a synthetic 10% drop of the newest
    record, stay quiet on noise-level jitter, and the real newest-vs-
    baseline comparison must run."""
    if not history:
        print("self-test FAIL: empty history", file=sys.stderr)
        return 2
    new = history[-1]
    base = pick_baseline(history, new, None, None) or new
    real = compare(base, new, tol)
    print(format_table(real))
    degraded = compare(new, _perturb(new, 0.90), tol)
    if degraded["status"] != "regressed":
        print(f"self-test FAIL: 10% degradation classified as "
              f"{degraded['status']}", file=sys.stderr)
        return 1
    jittered = compare(new, _perturb(new, 1.0, jitter=0.003), tol)
    if jittered["status"] == "regressed":
        print("self-test FAIL: noise-level jitter flagged as regression",
              file=sys.stderr)
        return 1
    print(f"self-test OK: detector fires on -10% "
          f"(worst {degraded['worst_config']} "
          f"{degraded['worst_delta']:+.4f}), quiet on ±0.003 jitter, "
          f"real comparison {real['status']}")
    return 0


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m gaussiank_sgd_torch.telemetry.sentinel",
        description="classify the newest bench-history record against a "
                    "baseline with noise-floored paired deltas")
    ap.add_argument("--history", default=DEFAULT_HISTORY)
    ap.add_argument("--tol", type=float, default=DEFAULT_TOL,
                    help="relative ratio drop that counts as a regression "
                         f"(default {DEFAULT_TOL})")
    ap.add_argument("--index", type=int, default=-1,
                    help="record under test (default: newest)")
    ap.add_argument("--baseline-rev", default=None,
                    help="compare against the latest record with this "
                         "git_rev")
    ap.add_argument("--baseline-index", type=int, default=None)
    ap.add_argument("--json", action="store_true", dest="as_json")
    ap.add_argument("--emit-event", default=None, metavar="PATH",
                    help="append the verdict as a bench_regression "
                         "telemetry record to this JSONL stream")
    ap.add_argument("--self-test", action="store_true",
                    help="check that the detector fires on a synthetic 10%% "
                         "regression and stays quiet on jitter")
    args = ap.parse_args(argv)

    history = load_history(args.history)
    if args.self_test:
        return self_test(history, args.tol)
    if not history:
        print(f"error: no history records in {args.history}",
              file=sys.stderr)
        return 2
    if not (-len(history) <= args.index < len(history)):
        print(f"error: --index {args.index} out of range "
              f"({len(history)} record(s))", file=sys.stderr)
        return 2
    new = history[args.index]
    base = pick_baseline(history, new, args.baseline_rev,
                         args.baseline_index)
    if base is None:
        # a single-record history has no trajectory yet: a state, not an
        # error
        print(f"no comparable baseline for record "
              f"{new.get('git_rev', 'unknown')} "
              f"({len(history)} record(s) in {args.history}); "
              f"nothing to compare")
        return 0
    verdict = compare(base, new, args.tol)
    if args.emit_event:
        emit_event(args.emit_event, verdict)
    if args.as_json:
        print(json.dumps(verdict, indent=2))
    else:
        print(format_table(verdict))
    return 1 if verdict["status"] == "regressed" else 0


if __name__ == "__main__":
    sys.exit(main())
