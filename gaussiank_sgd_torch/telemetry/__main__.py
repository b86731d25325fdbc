"""The telemetry CLI (port of ``gaussiank_sgd_tpu/telemetry/__main__.py``).

    python -m gaussiank_sgd_torch.telemetry report run.jsonl        # summary
    python -m gaussiank_sgd_torch.telemetry report run.jsonl --json
    python -m gaussiank_sgd_torch.telemetry validate run.jsonl --strict
    python -m gaussiank_sgd_torch.telemetry trace run.jsonl -o trace.json
    python -m gaussiank_sgd_torch.telemetry health run.jsonl     # verdict
    python -m gaussiank_sgd_torch.telemetry merge \
        pod/proc*/metrics.jsonl pod/supervisor.jsonl -o pod/merged.jsonl

``report`` rebuilds per-phase timing, comms volume, compression,
resilience and run health from the stream alone (``--audit`` joins a
program-audit artifact); ``validate`` checks every record's schema and the
seq envelope (truncation, gaps, mixed-run resets); ``trace`` renders the
stream as Chrome-trace/Perfetto JSON. Exit codes: 0 ok, 1 validation
problems (or, for ``trace --require-overlap``, no exchange/compute
overlap), 2 a usage error.

``merge`` joins the per-process streams of a pod
(``training/launch.py``) into one stream ordered by ``(ts,
process_index)``, with each record's process stamped; ``--strict`` then
validates the merged stream, so a CI gate is one command. Process indices
come from ``--index`` (one an input, in order), else from a ``procNNN``
path component, else the input's position; the supervisor's own records
carry ``process_index`` -1.

``health`` replays the stream through the run-health monitor and exits
by the worst state the run reached, 0 ok, 1 degraded, 2 critical; a
missing or empty stream exits 3.

Pure stdlib: it runs without torch.
"""

from __future__ import annotations

import argparse
import json
import re
import sys
from typing import List, Optional

from .events import merge_streams, validate_file, validate_stream
from .health import format_health, replay_health
from .report import format_report, load_events, summarize
from .tracing import build_chrome_trace, chrome_trace_overlap_pairs


def infer_process_index(path: str, fallback: int) -> int:
    """Process index from a ``procNNN`` path component (the launcher's
    per-worker run-dir naming), else ``fallback`` (input position)."""
    m = re.search(r"(?:^|[/\\_.-])proc(\d+)(?:[/\\_.-]|$)", path)
    return int(m.group(1)) if m else fallback


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m gaussiank_sgd_torch.telemetry",
        description="inspect/validate a telemetry JSONL event stream")
    sub = ap.add_subparsers(dest="cmd", required=True)

    rp = sub.add_parser("report", help="summarize a run's event stream")
    rp.add_argument("path", help="metrics.jsonl / events file")
    rp.add_argument("--json", action="store_true", dest="as_json",
                    help="machine-readable summary")
    rp.add_argument("--audit", default=None,
                    help="program-audit artifact to join: "
                         "the report then names the compiled-program "
                         "fingerprint matching this run's compressor/"
                         "wire/overlap key and the git rev it was "
                         "certified at")

    vp = sub.add_parser("validate", help="schema-check an event stream")
    vp.add_argument("path")
    vp.add_argument("--strict", action="store_true",
                    help="require the full envelope and known event kinds "
                         "on every record (freshly written streams)")
    vp.add_argument("--json", action="store_true", dest="as_json")

    tp = sub.add_parser(
        "trace", help="render a stream into Chrome-trace/Perfetto JSON")
    tp.add_argument("path", help="telemetry JSONL event stream")
    tp.add_argument("-o", "--out", required=True,
                    help="output .json artifact (open at ui.perfetto.dev)")
    tp.add_argument("--pid", type=int, default=0,
                    help="worker id for this stream's track group; merge "
                         "multi-worker runs by rendering each stream with "
                         "a distinct --pid and concatenating traceEvents")
    tp.add_argument("--require-overlap", action="store_true",
                    help="exit 1 unless >= 1 exchange span overlaps a "
                         "compress/compute span (the pipelining gate)")

    mp = sub.add_parser(
        "merge", help="merge per-process pod streams into one JSONL "
                      "stream with process_index provenance")
    mp.add_argument("inputs", nargs="+",
                    help="per-process metrics.jsonl files (+ the "
                         "supervisor stream)")
    mp.add_argument("-o", "--out", required=True,
                    help="merged output stream")
    mp.add_argument("--index", type=int, action="append", default=None,
                    help="process index of each input, in order "
                         "(default: parsed from a procNNN path "
                         "component, else input position)")
    mp.add_argument("--strict", action="store_true",
                    help="strict-validate the merged stream after "
                         "writing; exit 1 on problems")

    hp = sub.add_parser(
        "health", help="replay a stream through the run-health monitor; "
                       "exit 0/1/2 by worst state (3 = no stream)")
    hp.add_argument("path", help="telemetry JSONL event stream")
    hp.add_argument("--json", action="store_true", dest="as_json",
                    help="machine-readable summary")
    hp.add_argument("--floor-ms", type=float, default=None,
                    dest="floor_ms",
                    help="roofline exchange floor for the "
                         "exposed_exchange detector (live runs read it "
                         "from analysis/artifacts/roofline.json when it "
                         "was priced on their device)")

    args = ap.parse_args(argv)

    if args.cmd == "merge":
        indices = args.index
        if indices is not None and len(indices) != len(args.inputs):
            print(f"error: {len(args.inputs)} input(s) but "
                  f"{len(indices)} --index value(s)", file=sys.stderr)
            return 2
        if indices is None:
            indices = [infer_process_index(p, i)
                       for i, p in enumerate(args.inputs)]
        handles = []
        try:
            try:
                for p in args.inputs:
                    handles.append(open(p, "r", encoding="utf-8"))
            except FileNotFoundError as e:
                print(f"error: {e}", file=sys.stderr)
                return 2
            merged, mrep = merge_streams(handles, indices)
        finally:
            for fh in handles:
                fh.close()
        with open(args.out, "w", encoding="utf-8") as fh:
            for rec in merged:
                fh.write(json.dumps(rec) + "\n")
        print(f"wrote {args.out}: {mrep.n_records} record(s) from "
              f"{mrep.n_streams} stream(s), {mrep.n_stamped} "
              f"provenance-stamped, {mrep.dropped_lines} torn line(s) "
              f"dropped")
        if args.strict:
            srep = validate_stream((json.dumps(r) for r in merged),
                                   strict=True)
            for msg in srep.errors:
                print(f"ERROR {msg}")
            for msg in srep.warnings:
                print(f"warn  {msg}")
            print(("OK" if srep.ok else "FAIL")
                  + f": {srep.n_processes} process(es), "
                    f"{srep.seq_gaps} gap(s), "
                    f"{srep.seq_duplicates} duplicate(s), "
                    f"{srep.seq_resets} reset(s)")
            return 0 if srep.ok else 1
        return 0

    if args.cmd == "health":
        # worst-state exit codes 0/1/2 are this subcommand's contract,
        # so its file errors exit 3 — never aliasing a critical verdict
        try:
            events = load_events(args.path)
        except FileNotFoundError as e:
            print(f"error: {e}", file=sys.stderr)
            return 3
        if not events:
            print(f"error: no telemetry records in {args.path}",
                  file=sys.stderr)
            return 3
        _, mon = replay_health(events, floor_ms=args.floor_ms)
        health = mon.summary()
        print(json.dumps(health, indent=2, default=float)
              if args.as_json else format_health(health))
        return int(health["worst_state_code"])

    try:
        if args.cmd == "report":
            events = load_events(args.path)
            if not events:
                print(f"error: no telemetry records in {args.path}",
                      file=sys.stderr)
                return 1
            audit = None
            if args.audit:
                try:
                    with open(args.audit, "r", encoding="utf-8") as fh:
                        audit = json.load(fh)
                except (OSError, ValueError) as e:
                    print(f"error: cannot read audit artifact "
                          f"{args.audit}: {e}", file=sys.stderr)
                    return 2
            summary = summarize(events, audit=audit)
            print(json.dumps(summary, indent=2, default=float)
                  if args.as_json else format_report(summary))
            return 0

        if args.cmd == "trace":
            events = load_events(args.path)
            if not events:
                print(f"error: no telemetry records in {args.path}",
                      file=sys.stderr)
                return 1
            trace = build_chrome_trace(events, pid=args.pid)
            with open(args.out, "w", encoding="utf-8") as fh:
                json.dump(trace, fh)
            pairs = chrome_trace_overlap_pairs(trace)
            n_x = sum(1 for ev in trace["traceEvents"]
                      if ev.get("ph") == "X")
            print(f"wrote {args.out}: {len(trace['traceEvents'])} trace "
                  f"event(s), {n_x} span(s), {pairs} exchange/compute "
                  f"overlap pair(s)")
            if args.require_overlap and pairs < 1:
                print("error: --require-overlap but no exchange span "
                      "overlaps a compress/compute span", file=sys.stderr)
                return 1
            return 0

        rep = validate_file(args.path, strict=args.strict)
        if args.as_json:
            print(json.dumps({
                "path": args.path,
                "ok": rep.ok,
                "n_records": rep.n_records,
                "n_stamped": rep.n_stamped,
                "events": rep.events,
                "seq_gaps": rep.seq_gaps,
                "seq_resets": rep.seq_resets,
                "seq_duplicates": rep.seq_duplicates,
                "n_processes": rep.n_processes,
                "truncated": rep.truncated,
                "span_orphans": rep.span_orphans,
                "span_unclosed": rep.span_unclosed,
                "errors": rep.errors,
                "warnings": rep.warnings,
            }, indent=2))
        else:
            for msg in rep.errors:
                print(f"ERROR {msg}")
            for msg in rep.warnings:
                print(f"warn  {msg}")
            status = "OK" if rep.ok else "FAIL"
            print(f"{status}: {rep.n_records} record(s), "
                  f"{rep.n_stamped} seq-stamped, "
                  f"{len(rep.errors)} error(s), "
                  f"{len(rep.warnings)} warning(s) — "
                  + ", ".join(f"{k}={n}"
                              for k, n in sorted(rep.events.items())))
        return 0 if rep.ok else 1
    except FileNotFoundError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2


if __name__ == "__main__":
    sys.exit(main())
