"""gklint CLI for the port (port of ``gaussiank_sgd_tpu/lint/__main__.py``).

    python -m gaussiank_sgd_torch.lint                  # lint the package
    python -m gaussiank_sgd_torch.lint --json           # machine output
    python -m gaussiank_sgd_torch.lint --changed        # gate changed files
    python -m gaussiank_sgd_torch.lint --write-baseline # accept current set
    python -m gaussiank_sgd_torch.lint --list-rules
    python -m gaussiank_sgd_torch.lint path/to/file.py another/dir
    python -m gaussiank_sgd_torch.lint audit [...]       # step audit tier
    python -m gaussiank_sgd_torch.lint concurrency [...] # host lock/race tier
    python -m gaussiank_sgd_torch.lint events [...]      # event contract tier

Exit codes: 0 clean (or all findings baselined), 1 new findings, 2 usage
error or a suppression without a ``-- justification``. The AST,
``concurrency`` and ``events`` tiers are pure-AST: they import no torch.
The ``audit`` subcommand (lint/program_audit.py) runs a step of each arm,
on the card unless ``--device cpu`` is passed, so it DOES import torch —
its flags are documented in ``... lint audit --help``; the reference's
``--devices`` (its virtual mesh's width) has no counterpart: the audit
runs at the process group's world, one rank unless launched as several.

``--format github`` prints workflow-command annotations
(``::error file=...``) so findings annotate PR diffs in CI.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from typing import Any, Dict, List, Optional, Sequence, Set, Tuple

from .baseline import (default_baseline_path, load_baseline, split_new,
                       write_baseline)
from .core import Finding, Suppression, lint_paths_detailed
from .rules import ALL_RULES, select_rules


def _default_paths() -> List[str]:
    return [os.path.dirname(os.path.dirname(os.path.abspath(__file__)))]


def _repo_root() -> str:
    return os.path.dirname(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _print_findings(findings: Sequence[Finding], fmt: str) -> None:
    for f in findings:
        if fmt == "github":
            sev = "error" if f.severity == "error" else "warning"
            end = f.end_line or f.line
            print(f"::{sev} file={f.path},line={max(f.line, 1)},"
                  f"endLine={max(end, 1)},title=gklint "
                  f"{f.rule}::{f.message}")
        else:
            print(f.human())


def _add_format_flags(ap: argparse.ArgumentParser) -> None:
    ap.add_argument("--json", action="store_true", dest="as_json",
                    help="JSON output (alias for --format json)")
    ap.add_argument("--format", choices=("text", "json", "github"),
                    default="text",
                    help="output format; `github` prints workflow-command "
                         "annotations for PR diffs")


def _resolve_format(args: argparse.Namespace) -> str:
    return "json" if args.as_json else args.format


# -- suppression hygiene (satellite of gklint v3) --------------------------

def check_suppressions(sups: Sequence[Suppression],
                       active_rules: Set[str],
                       full_run: bool) -> Tuple[List[Suppression],
                                                List[Suppression]]:
    """(missing-justification, stale) suppression rows for this run.

    A suppression is *relevant* when it names a rule the run executed (or
    is a ``*`` wildcard on a full-rule-set run) — a ``conc-*`` suppression
    is not stale just because the plain AST tier never runs that rule.
    Stale analysis only applies on ``full_run`` (no ``--rules`` subset, no
    ``--changed`` scoping), where "nothing matched" is meaningful.
    """
    missing = [s for s in sups if not s.justification]
    stale: List[Suppression] = []
    if full_run:
        for s in sups:
            relevant = bool(s.rules & active_rules) or "*" in s.rules
            if relevant and not s.matched:
                stale.append(s)
    return missing, stale


def _suppression_findings(stale: Sequence[Suppression]) -> List[Finding]:
    return [Finding(
        rule="stale-suppression", severity="warning", path=s.path,
        line=s.line, col=1,
        message=f"suppression of {', '.join(sorted(s.rules))} no longer "
                f"masks any finding — remove the comment",
        source_line=s.source_line) for s in stale]


def _gate_suppressions(missing: Sequence[Suppression],
                       stale: Sequence[Suppression],
                       strict: bool, fmt: str) -> Tuple[List[Finding], bool]:
    """Print justification errors / stale warnings. Returns
    ``(stale_as_findings, hard_fail)`` — strict mode turns stale rows into
    findings; a missing justification is always a hard exit-2 failure."""
    for s in missing:
        msg = (f"{s.path}:{s.line}: suppression of "
               f"{', '.join(sorted(s.rules))} has no `-- justification` "
               f"(docs/LINTING.md)")
        if fmt == "github":
            print(f"::error file={s.path},line={s.line},title=gklint "
                  f"suppression::{msg}")
        else:
            print(f"error: {msg}")
    stale_findings = _suppression_findings(stale)
    if not strict:
        for f in stale_findings:
            if fmt == "github":
                print(f"::warning file={f.path},line={f.line},"
                      f"title=gklint {f.rule}::{f.message}")
            elif fmt != "json":
                print(f"warning: {f.path}:{f.line}: {f.message}")
        stale_findings = []
    return stale_findings, bool(missing)


def _changed_py_files(repo_root: str) -> Optional[Set[str]]:
    """Repo-root-relative ``.py`` paths changed vs HEAD (tracked diffs +
    untracked files); None when git is unavailable or this is no repo."""
    changed: Set[str] = set()
    for cmd in (["git", "diff", "--name-only", "HEAD", "--"],
                ["git", "ls-files", "--others", "--exclude-standard"]):
        try:
            res = subprocess.run(cmd, cwd=repo_root, capture_output=True,
                                 text=True, check=True, timeout=30)
        except (OSError, subprocess.SubprocessError):
            return None
        changed |= {os.path.normpath(ln.strip())
                    for ln in res.stdout.splitlines()
                    if ln.strip().endswith(".py")}
    return changed


def main(argv: Optional[List[str]] = None) -> int:
    if argv is None:
        argv = sys.argv[1:]
    if argv and argv[0] == "audit":
        return _audit_main(argv[1:])
    if argv and argv[0] == "concurrency":
        return _concurrency_main(argv[1:])
    if argv and argv[0] == "events":
        return _events_main(argv[1:])
    ap = argparse.ArgumentParser(
        prog="python -m gaussiank_sgd_torch.lint",
        description="static analysis for the PyTorch port")
    ap.add_argument("paths", nargs="*",
                    help="files/dirs to lint (default: the package)")
    _add_format_flags(ap)
    ap.add_argument("--rules", help="comma-separated subset of rules to run")
    ap.add_argument("--baseline", default=None,
                    help="baseline file (default: <repo>/"
                         ".gklint-torch-baseline.json)")
    ap.add_argument("--no-baseline", action="store_true",
                    help="ignore the baseline: every finding gates")
    ap.add_argument("--write-baseline", action="store_true",
                    help="accept the current findings as the new baseline")
    ap.add_argument("--changed", action="store_true",
                    help="report/gate only findings in files changed vs "
                         "git HEAD (the whole package is still analysed)")
    ap.add_argument("--strict-suppressions", action="store_true",
                    help="stale suppressions (masking nothing) become "
                         "gating findings instead of warnings")
    ap.add_argument("--list-rules", action="store_true")
    args = ap.parse_args(argv)

    if args.list_rules:
        for r in ALL_RULES:
            print(f"{r.name:26s} [{r.severity}] {r.description}")
        return 0

    try:
        rules = select_rules(args.rules.split(",") if args.rules else None)
    except KeyError as e:
        print(f"error: {e.args[0]}", file=sys.stderr)
        return 2

    if args.changed and args.paths:
        print("error: --changed scopes the default package lint; it cannot "
              "be combined with explicit paths", file=sys.stderr)
        return 2

    paths = args.paths or _default_paths()
    fmt = _resolve_format(args)
    # findings are repo-root-relative when linting the installed package so
    # the committed baseline matches from any cwd
    pkg_parent = _repo_root()
    findings, sups = lint_paths_detailed(
        paths, rules=rules, rel_to=pkg_parent if not args.paths else None)

    if args.changed:
        changed = _changed_py_files(pkg_parent)
        if changed is None:
            print("error: --changed needs git and a work tree at "
                  f"{pkg_parent}", file=sys.stderr)
            return 2
        findings = [f for f in findings
                    if os.path.normpath(f.path) in changed]

    baseline_path = args.baseline or default_baseline_path()
    if args.write_baseline:
        write_baseline(baseline_path, findings)
        print(f"gklint: wrote {len(findings)} finding(s) to {baseline_path}")
        return 0

    baseline = {} if args.no_baseline else load_baseline(baseline_path)
    new, old = split_new(findings, baseline)

    # suppression hygiene: baselined findings still count as "masked" for
    # staleness (the suppression matched during lint), and a subset run
    # (--rules / --changed / explicit paths) never reports staleness
    full_run = not (args.rules or args.changed or args.paths)
    missing, stale = check_suppressions(
        sups, {r.name for r in rules}, full_run)
    stale_findings, hard_fail = _gate_suppressions(
        missing, stale, args.strict_suppressions, fmt)
    new = sorted(new + stale_findings,
                 key=lambda f: (f.path, f.line, f.col, f.rule))

    if fmt == "json":
        print(json.dumps({
            "tool": "gklint",
            "checked_paths": paths,
            "baseline": None if args.no_baseline else baseline_path,
            "counts": {"total": len(findings), "new": len(new),
                       "baselined": len(old)},
            "new_findings": [f.to_json() for f in new],
            "baselined_findings": [f.to_json() for f in old],
            "suppressions": [s.to_json() for s in sups],
            "stale_suppressions": [s.to_json() for s in stale],
            "unjustified_suppressions": [s.to_json() for s in missing],
        }, indent=2))
    else:
        _print_findings(new, fmt)
        summary = (f"gklint: {len(new)} new finding(s), "
                   f"{len(old)} baselined, "
                   f"{len(ALL_RULES) if not args.rules else len(rules)} "
                   f"rule(s)"
                   + (" [changed files only]" if args.changed else ""))
        print(summary)
        if new:
            print("  fix, suppress with `# gklint: disable=<rule> -- "
                  "<justification>`, or accept via --write-baseline "
                  "(docs/LINTING.md)")
    if hard_fail:
        return 2
    return 1 if new else 0


def _concurrency_main(argv: List[str]) -> int:
    from .concurrency import CONCURRENCY_RULES, lint_concurrency
    ap = argparse.ArgumentParser(
        prog="python -m gaussiank_sgd_torch.lint concurrency",
        description="host-runtime concurrency tier: per-class lock model "
                    "(guarded-state discipline), callback-under-lock, "
                    "thread-escape, blocking-in-critical-section — "
                    "whole-package, pure-AST")
    ap.add_argument("paths", nargs="*",
                    help="files/dirs to analyse (default: the package)")
    _add_format_flags(ap)
    ap.add_argument("--strict-suppressions", action="store_true",
                    help="stale suppressions become gating findings")
    ap.add_argument("--list-rules", action="store_true")
    args = ap.parse_args(argv)
    fmt = _resolve_format(args)

    if args.list_rules:
        for r in CONCURRENCY_RULES:
            print(f"{r.name:26s} [{r.severity}] {r.description}")
        return 0

    paths = args.paths or _default_paths()
    findings, sups = lint_concurrency(
        paths, rel_to=_repo_root() if not args.paths else None)

    conc_names = {r.name for r in CONCURRENCY_RULES}
    missing, stale = check_suppressions(sups, conc_names,
                                        full_run=not args.paths)
    stale_findings, hard_fail = _gate_suppressions(
        missing, stale, args.strict_suppressions, fmt)
    findings = sorted(findings + stale_findings,
                      key=lambda f: (f.path, f.line, f.col, f.rule))

    if fmt == "json":
        print(json.dumps({
            "tool": "gklint-concurrency",
            "checked_paths": paths,
            "counts": {"total": len(findings)},
            "findings": [f.to_json() for f in findings],
            "stale_suppressions": [s.to_json() for s in stale],
            "unjustified_suppressions": [s.to_json() for s in missing],
        }, indent=2))
    else:
        _print_findings(findings, fmt)
        print(f"gklint concurrency: {len(findings)} finding(s), "
              f"{len(CONCURRENCY_RULES)} rule(s)")
        if findings:
            print("  fix, or suppress with `# gklint: disable=<rule> -- "
                  "<justification>` where the pattern is by design "
                  "(docs/LINTING.md)")
    if hard_fail:
        return 2
    return 1 if findings else 0


def _events_main(argv: List[str]) -> int:
    from .event_contract import default_events_path, run_events_check
    ap = argparse.ArgumentParser(
        prog="python -m gaussiank_sgd_torch.lint events",
        description="event-contract tier: statically resolve every "
                    "publish/emit site to its event kind and cross-check "
                    "payload keys against EVENT_SCHEMAS, ratcheted in "
                    ".gklint-torch-events.json")
    ap.add_argument("paths", nargs="*",
                    help="files/dirs to scan (default: the package)")
    _add_format_flags(ap)
    ap.add_argument("--events-file", default=None,
                    help="committed snapshot (default: "
                         "<repo>/.gklint-torch-events.json)")
    ap.add_argument("--write-events", action="store_true",
                    help="re-baseline: write the current contract "
                         "snapshot to the events file")
    ap.add_argument("-o", "--out", default=None,
                    help="also write the full report JSON here (the CI "
                         "artifact)")
    args = ap.parse_args(argv)
    fmt = _resolve_format(args)

    snap_path = args.events_file or default_events_path()
    findings, sites, snap = run_events_check(
        paths=args.paths or None, snap_path=snap_path,
        write=args.write_events, rel_to=_repo_root())

    report = {
        "tool": "gklint-events",
        "counts": {"findings": len(findings), "sites": len(sites),
                   "kinds": len(snap.get("kinds", {}))},
        "findings": [f.to_json() for f in findings],
        "sites": [s.to_json() for s in sites],
        "snapshot": snap,
    }
    if args.out:
        with open(args.out, "w", encoding="utf-8") as fh:
            json.dump(report, fh, indent=2, sort_keys=False)
            fh.write("\n")

    if args.write_events:
        print(f"gklint events: wrote {len(snap.get('kinds', {}))} kind(s) "
              f"({len(sites)} site(s)) to {snap_path}")

    if fmt == "json":
        print(json.dumps(report, indent=2, sort_keys=False))
    else:
        _print_findings(findings, fmt)
        print(f"gklint events: {len(findings)} finding(s), "
              f"{len(sites)} publish site(s), "
              f"{len(snap.get('kinds', {}))} kind(s)")
        if findings:
            print("  align EVENT_SCHEMAS with the publish sites, or "
                  "re-baseline intentional drift with --write-events "
                  "(docs/LINTING.md)")
    return 1 if findings else 0


def _audit_human_report(report: Dict[str, Any], inv_violations: List[str],
                        warnings: List[str]) -> None:
    for name, arm in report["arms"].items():
        if "error" in arm:
            print(f"{name:38s} ERROR {arm['error']}")
            continue
        coll = " ".join(
            f"{k}={v['total']:g}({v['in_pipeline']:g} in-pipeline)"
            for k, v in sorted(arm["collectives"].items()))
        syncs = ("syncs not counted" if arm["syncs"] is None else
                 "syncs " + (", ".join(f"{s}={n:g}"
                                       for s, n in arm["syncs"].items())
                             or "none"))
        print(f"{name:38s} wire={arm['wire_format']:8s} "
              f"overlap={arm['overlap']:9s} {coll}; {syncs}")
    for ident in report["identities"]:
        status = "ok" if ident["equal"] else "BROKEN"
        print(f"identity {ident['group']}: {status} "
              f"({', '.join(ident['arms'])})")
    for w in warnings:
        print(f"warning: {w}")
    for v in report["violations"] + inv_violations:
        print(f"VIOLATION: {v}")
    n_ok = sum(1 for a in report["arms"].values() if "error" not in a)
    print(f"gklint audit: {n_ok}/{len(report['arms'])} arm(s) run on "
          f"{report['device']} ({report['backend']}), "
          f"{len(report['violations']) + len(inv_violations)} "
          f"violation(s); host syncs {report['syncs']}; torch "
          f"{report['torch_version']}")


def _audit_main(argv: List[str]) -> int:
    # deferred import: the audit is the only part of the lint CLI that
    # touches torch, and only once `audit` is actually requested
    from .program_audit import (ARMS, allowed_syncs, compare_programs,
                                default_programs_path, expected,
                                load_programs, programs_snapshot, run_audit)
    ap = argparse.ArgumentParser(
        prog="python -m gaussiank_sgd_torch.lint audit",
        description="step contracts of the port's DPTrainStep: host syncs "
                    "(on the card), the collective inventory and the two "
                    "identities, over the reference's arms")
    ap.add_argument("--programs", default=None,
                    help="committed inventory file (default: "
                         "<repo>/.gklint-torch-programs.json)")
    ap.add_argument("--write-programs", action="store_true",
                    help="re-baseline: write the current inventory to the "
                         "programs file")
    ap.add_argument("--arms", default=None,
                    help="comma-separated subset of config arms")
    ap.add_argument("--list-arms", action="store_true")
    ap.add_argument("--json", action="store_true", dest="as_json",
                    help="print the full report as JSON")
    ap.add_argument("-o", "--out", default=None,
                    help="also write the full report JSON here")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu, only when asked (no host "
                         "sync is counted on the CPU)")
    args = ap.parse_args(argv)

    if args.list_arms:
        for name, spec in ARMS.items():
            exp = expected(spec, 2)
            tag = " [dense]" if spec.get("dense") else ""
            ident = spec.get("identity")
            itag = f" identity={ident}" if ident else ""
            syncs = ", ".join(allowed_syncs(name)) or "none"
            print(f"{name:38s} wire={exp.get('wire_format', '?'):8s} "
                  f"overlap={exp.get('overlap', '?'):9s}{tag}{itag} "
                  f"syncs allowed: {syncs}")
        return 0

    arm_names = ([a.strip() for a in args.arms.split(",") if a.strip()]
                 if args.arms else None)
    try:
        report = run_audit(arm_names, device=args.device)
    except KeyError as e:
        print(f"error: {e.args[0]}", file=sys.stderr)
        return 2
    except (RuntimeError, ValueError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2

    programs_path = args.programs or default_programs_path()
    if args.write_programs:
        snap = programs_snapshot(report)
        with open(programs_path, "w", encoding="utf-8") as fh:
            json.dump(snap, fh, indent=2, sort_keys=True)
            fh.write("\n")
        print(f"gklint audit: wrote {len(snap['arms'])} arm inventory(ies) "
              f"to {programs_path}")
        # structural violations still gate a re-baseline run
        inv_violations: List[str] = []
        warnings: List[str] = []
    else:
        baseline = load_programs(programs_path)
        if baseline is None:
            inv_violations = [
                f"no committed programs file at {programs_path} — generate "
                f"one with --write-programs and commit it"]
            warnings = []
        else:
            inv_violations, warnings = compare_programs(
                report, baseline, partial=arm_names is not None)

    if args.out:
        with open(args.out, "w", encoding="utf-8") as fh:
            json.dump(report, fh, indent=2, sort_keys=True)
            fh.write("\n")

    if args.as_json:
        print(json.dumps({**report,
                          "inventory_violations": inv_violations,
                          "warnings": warnings}, indent=2, sort_keys=True))
    else:
        _audit_human_report(report, inv_violations, warnings)
    return 1 if (report["violations"] or inv_violations) else 0


if __name__ == "__main__":
    sys.exit(main())
