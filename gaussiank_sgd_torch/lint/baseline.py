"""Baseline workflow: known findings don't gate, new ones do (port of
``gaussiank_sgd_tpu/lint/baseline.py``).

The committed baseline (``.gklint-torch-baseline.json`` at the repo root,
beside the reference's ``.gklint-baseline.json``) maps
finding fingerprints to occurrence counts. A fingerprint hashes
(rule, file basename, stripped source text), so line-number churn never
invalidates it; editing the flagged LINE does — which is the point: touched
code must come clean (fix or suppress with a comment), untouched legacy
findings don't block.

Workflow: ``python -m gaussiank_sgd_torch.lint --write-baseline`` after
intentionally accepting findings; CI runs the plain command and fails on
anything not in the file.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Sequence, Tuple

from .core import Finding

BASELINE_VERSION = 1
DEFAULT_BASENAME = ".gklint-torch-baseline.json"


def default_baseline_path() -> str:
    """<repo root>/.gklint-torch-baseline.json, repo root = the parent of
    the ``gaussiank_sgd_torch`` package this module ships in."""
    pkg_dir = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    return os.path.join(os.path.dirname(pkg_dir), DEFAULT_BASENAME)


def load_baseline(path: str) -> Dict[str, int]:
    if not os.path.exists(path):
        return {}
    with open(path, "r", encoding="utf-8") as fh:
        data = json.load(fh)
    if data.get("version") != BASELINE_VERSION:
        raise ValueError(
            f"baseline {path} has version {data.get('version')!r}, this "
            f"gklint reads version {BASELINE_VERSION} — regenerate with "
            "--write-baseline")
    return {fp: int(entry["count"])
            for fp, entry in data.get("findings", {}).items()}


def write_baseline(path: str, findings: Sequence[Finding]) -> None:
    entries: Dict[str, Dict[str, object]] = {}
    for f in findings:
        e = entries.setdefault(f.fingerprint, {
            "count": 0, "rule": f.rule, "path": f.path,
            "source": f.source_line.strip()})
        e["count"] = int(e["count"]) + 1
    payload = {"version": BASELINE_VERSION, "tool": "gklint",
               "findings": dict(sorted(entries.items()))}
    with open(path, "w", encoding="utf-8") as fh:
        json.dump(payload, fh, indent=2, sort_keys=False)
        fh.write("\n")


def split_new(findings: Sequence[Finding],
              baseline: Dict[str, int]) -> Tuple[List[Finding],
                                                 List[Finding]]:
    """(new, baselined): per-fingerprint multiset difference — the first
    ``baseline[fp]`` occurrences of a fingerprint are baselined, the rest
    are new."""
    remaining = dict(baseline)
    new: List[Finding] = []
    old: List[Finding] = []
    for f in findings:
        if remaining.get(f.fingerprint, 0) > 0:
            remaining[f.fingerprint] -= 1
            old.append(f)
        else:
            new.append(f)
    return new, old
