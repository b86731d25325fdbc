"""Cross-run bench history, the regression sentinel's data layer (port
of ``gaussiank_sgd_tpu/telemetry/history.py``).

A bench run appends one schema-versioned record to a JSONL file: each
config's medians and window medians, the overhead against the roofline
floor, the wire and overlap accounting, and the git revision that produced
them. A sentinel then compares the newest record with a baseline instead
of diffing result files by hand.

Append-only and forward-compatible like the event catalog: new fields
only add, and readers skip records whose ``history_schema`` is newer than
theirs. A hand-written row (a fixture, a demo) must carry ``"synthetic":
true``; :func:`build_history_record` never sets it, so a verdict can
anchor to measured numbers only. Pure stdlib.
"""

from __future__ import annotations

import json
import os
import subprocess
from typing import Any, Dict, List, Mapping, Optional

HISTORY_SCHEMA = 1

# per-config fields copied verbatim from a bench_last-style cell; the
# sentinel's comparison keys first (window_medians drives the
# noise-floored classification; ratio_window_min is the binding scalar)
_CELL_FIELDS = (
    "ratio_median", "ratio_window_min", "window_medians", "windows",
    "rounds", "dense_step_ms", "sparse_step_ms", "overhead_ms",
    "overhead_vs_floor", "bytes_sent", "wire_format", "overlap",
)
_OVERLAP_ARM_FIELDS = ("exposed_seq_ms", "exposed_pipe_ms", "pipe_vs_seq",
                       "n_buckets", "overlapped_bytes_sent")


def git_revision(cwd: Optional[str] = None) -> str:
    """Short git rev of the working tree, or "unknown" anywhere git or
    the repo is unavailable (history must never fail a bench run)."""
    try:
        out = subprocess.run(
            ["git", "rev-parse", "--short", "HEAD"], cwd=cwd,
            capture_output=True, text=True, timeout=10)
        rev = out.stdout.strip()
        return rev if out.returncode == 0 and rev else "unknown"
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def build_history_record(result: Mapping[str, Any], *, smoke: bool,
                         ts: float, git_rev: str) -> Dict[str, Any]:
    """Distill one bench ``result`` (the bench_last.json structure) into
    a history record. Tolerant of absent fields — a partial result still
    yields a record naming what it measured."""
    detail = result.get("detail") or {}
    configs_in = detail.get("configs") or {}
    configs: Dict[str, Any] = {}
    any_overlap_arm = False
    for key, cell in configs_in.items():
        if not isinstance(cell, Mapping):
            continue
        out = {f: cell[f] for f in _CELL_FIELDS if cell.get(f) is not None}
        arm = cell.get("overlap_arm")
        if isinstance(arm, Mapping):
            any_overlap_arm = True
            out["overlap_arm"] = {f: arm[f] for f in _OVERLAP_ARM_FIELDS
                                  if arm.get(f) is not None}
        configs[key] = out
    return {
        "history_schema": HISTORY_SCHEMA,
        "ts": round(float(ts), 3),
        "git_rev": git_rev,
        "smoke": bool(smoke),
        "platform": detail.get("platform"),
        "metric": result.get("metric"),
        "value": result.get("value"),
        "worst_config": detail.get("worst_config"),
        # which measurement arms this run exercised; "policy" is reserved
        # for a future bench policy arm (the adaptive engine is trained
        # live, analysis/policy_ab.py, not bench-armed yet)
        "arms": {"wire": True, "overlap": any_overlap_arm, "policy": None},
        "configs": configs,
    }


def append_history(path: str, record: Mapping[str, Any]) -> None:
    """Append one record; atomic enough for the single-writer bench
    (one JSON line, one write syscall on every mainstream filesystem)."""
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    with open(path, "a", encoding="utf-8") as fh:
        fh.write(json.dumps(record, sort_keys=True, default=float) + "\n")


def load_history(path: str) -> List[Dict[str, Any]]:
    """All readable records, oldest first. Skips (never fails on) blank
    lines, partial trailing lines, and records from a NEWER schema —
    the sentinel must keep working against a history file touched by a
    future writer."""
    out: List[Dict[str, Any]] = []
    if not os.path.exists(path):
        return out
    with open(path, "r", encoding="utf-8") as fh:
        for line in fh:
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except json.JSONDecodeError:
                continue
            if not isinstance(rec, dict):
                continue
            sv = rec.get("history_schema", 0)
            if isinstance(sv, int) and sv > HISTORY_SCHEMA:
                continue
            out.append(rec)
    return out
