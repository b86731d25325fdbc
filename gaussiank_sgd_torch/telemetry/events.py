"""The telemetry event catalog — typed, schema-versioned records (the
port's own copy of ``gaussiank_sgd_tpu/telemetry/events.py``: the same
schemas, rules and stream checks, plus the port's ``restore`` event).

Every record on the bus is a flat JSON object with three envelope fields
stamped by :class:`~gaussiank_sgd_torch.telemetry.bus.EventBus`:

    schema_version  int   — SCHEMA_VERSION at write time
    seq             int   — monotonic per-run sequence number (0-based);
                            a gap means records were dropped, a reset
                            means two runs were concatenated into one file
    ts              float — host unix time at publish

plus an ``event`` discriminator naming one of the schemas below. Old
readers keep working because new fields only ever ADD; readers of old
files default absent envelope fields instead of failing (the satellite
contract: schema_version defaults to 0 = "pre-telemetry", seq to None).

The validator is deliberately tolerant of EXTRA fields: the ``train``
event carries the model's auxiliary metrics (top1, perplexity, ...) whose
names are model-specific, and forward-compatible readers must not reject
fields they do not know.
"""

from __future__ import annotations

import heapq
import json
from dataclasses import dataclass, field
from typing import (Any, Dict, Iterable, Iterator, List, Mapping, Optional,
                    Sequence, Tuple)

SCHEMA_VERSION = 1

# envelope fields stamped by the bus on every record
ENVELOPE_FIELDS = ("schema_version", "seq", "ts")

# type vocabulary for schema entries (note bool is an int subclass — a
# flag field declared NUMBER accepts True/False, which is intended)
NUMBER: Tuple[type, ...] = (int, float)
STRING: Tuple[type, ...] = (str,)
ARRAY: Tuple[type, ...] = (list, tuple)
OBJECT: Tuple[type, ...] = (dict,)


@dataclass(frozen=True)
class EventSchema:
    """Field contract for one event kind. ``required`` fields must be
    present with a matching type; ``optional`` fields are type-checked
    only when present; unknown extra fields always pass (see module
    docstring)."""

    required: Mapping[str, Tuple[type, ...]]
    optional: Mapping[str, Tuple[type, ...]] = field(default_factory=dict)


EVENT_SCHEMAS: Dict[str, EventSchema] = {
    # one per run, first record: the resolved operating point
    "config": EventSchema(
        required={"dnn": STRING, "dataset": STRING, "batch_size": NUMBER,
                  "compressor": STRING, "density": NUMBER, "lr": NUMBER,
                  "nworkers": NUMBER, "n_params": NUMBER,
                  "total_steps": NUMBER},
    ),
    # per log interval: step metrics incl. the on-device comms accounting
    "train": EventSchema(
        required={"step": NUMBER, "epoch": NUMBER, "loss": NUMBER,
                  "lr": NUMBER, "grad_norm": NUMBER,
                  "num_selected": NUMBER, "bytes_sent": NUMBER,
                  "density": NUMBER, "io_s": NUMBER, "step_s": NUMBER,
                  "skipped": NUMBER, "nonfinite": NUMBER},
        optional={"density_achieved": NUMBER, "ef_norm": NUMBER,
                  "ex_per_s": NUMBER, "mfu": NUMBER,
                  "sel_per_bucket": ARRAY, "consecutive_skips": NUMBER,
                  "lr_scale": NUMBER, "fwd_bwd_s": NUMBER,
                  "select_s": NUMBER, "comm_update_s": NUMBER,
                  "phase_skipped": STRING,
                  # wire format of the bytes_sent payload
                  # (parallel/wire.py): "u16bf16" packed or "i32f32"
                  # legacy — a bytes claim never travels without its
                  # format name
                  "wire_format": STRING,
                  # bucket-pipelined schedule: which step
                  # schedule produced this interval ("pipelined"/"off"),
                  # how much of bytes_sent was launched while later
                  # chunks were still compressing, and the measured
                  # exchange time the schedule failed to hide (step
                  # minus its exchange-ablated timing twin)
                  "overlap": STRING, "overlapped_bytes_sent": NUMBER,
                  "exposed_exchange_ms": NUMBER,
                  # trace-gated span-source geometry (--trace on only;
                  # telemetry/tracing.py reconstructs per-chunk device
                  # phases from these trace-time-static shape facts)
                  "pipeline_chunks": NUMBER, "comm_rounds": NUMBER},
    ),
    "eval": EventSchema(
        required={"step": NUMBER, "epoch": NUMBER, "val_loss": NUMBER},
        optional={"top1": NUMBER, "top5": NUMBER, "cer": NUMBER,
                  "perplexity": NUMBER, "n": NUMBER, "eval_ms": NUMBER},
    ),
    # resilience runtime (docs/RESILIENCE.md)
    "skip": EventSchema(
        required={"step": NUMBER, "nonfinite": NUMBER},
    ),
    "rollback": EventSchema(
        required={"reason": STRING, "rollback": NUMBER, "to_step": NUMBER,
                  "lr_scale": NUMBER, "checkpoint": STRING},
    ),
    "restore_fallback": EventSchema(
        required={"checkpoint": STRING, "error": STRING},
    ),
    "preempt": EventSchema(
        required={"step": NUMBER, "checkpoint": STRING},
    ),
    "checkpoint": EventSchema(
        required={"step": NUMBER, "path": STRING},
        optional={"bytes": NUMBER, "save_ms": NUMBER},
    ),
    # the port's resume (training/trainer.py:_resume); the reference
    # logs a resume as a text line only
    "restore": EventSchema(
        required={"step": NUMBER, "path": STRING},
        optional={"restore_ms": NUMBER},
    ),
    # data loader retry (data/loader.py prefetch)
    "io_retry": EventSchema(
        required={"attempt": NUMBER, "max_retries": NUMBER,
                  "backoff_s": NUMBER, "error": STRING},
    ),
    # multi-process pod rig (training/launch.py; docs/RESILIENCE.md
    # "Multi-process failure model"). ``bootstrap_retry`` is the
    # io_retry shape applied to the distributed coordinator's bootstrap;
    # ``worker_lost``/``worker_relaunch`` come from the SUPERVISOR's
    # stream (stamped process_index=-1). The lost worker's index is
    # named ``worker`` — NOT process_index — because process_index is
    # the publishing process's provenance stamp, and the supervisor
    # reporting on worker 3 is not worker 3.
    "bootstrap_retry": EventSchema(
        required={"attempt": NUMBER, "max_retries": NUMBER,
                  "backoff_s": NUMBER, "coordinator": STRING,
                  "error": STRING},
    ),
    "worker_lost": EventSchema(
        required={"worker": NUMBER, "reason": STRING,
                  "generation": NUMBER},
        optional={"exit_code": NUMBER, "heartbeat_age_s": NUMBER,
                  "heartbeat_step": NUMBER},
    ),
    "worker_relaunch": EventSchema(
        required={"generation": NUMBER, "nprocs": NUMBER,
                  "checkpoint": STRING},
    ),
    # elastic autoscaling service (service/; docs/RESILIENCE.md "Layer
    # 6"). ``resize_begin``/``resize_commit``/``resize_abort`` bracket
    # one mesh-geometry change: begin when a directive is accepted,
    # commit when the new generation armed (every worker's first
    # heartbeat) inside the step + wall budgets, abort when the change
    # was refused or overran and the supervisor reconciled back to the
    # old width. ``job`` is the scheduler's job id (the run_id when a
    # supervisor runs stand-alone). All three come from the supervisor
    # stream (process_index=-1), like worker_lost.
    "resize_begin": EventSchema(
        required={"job": STRING, "reason": STRING, "from_nprocs": NUMBER,
                  "to_nprocs": NUMBER, "generation": NUMBER},
        optional={"step": NUMBER, "step_budget": NUMBER,
                  "wall_budget_s": NUMBER},
    ),
    "resize_commit": EventSchema(
        required={"job": STRING, "from_nprocs": NUMBER,
                  "to_nprocs": NUMBER, "generation": NUMBER,
                  "checkpoint": STRING, "duration_s": NUMBER},
        optional={"steps_lost": NUMBER, "reason": STRING},
    ),
    "resize_abort": EventSchema(
        required={"job": STRING, "reason": STRING, "from_nprocs": NUMBER,
                  "to_nprocs": NUMBER, "generation": NUMBER},
        optional={"steps_lost": NUMBER, "duration_s": NUMBER},
    ),
    # multi-job scheduler (service/scheduler.py): admission over one
    # device pool and job completion, on the scheduler's own stream
    "job_admit": EventSchema(
        required={"job": STRING, "nprocs": NUMBER, "devices_free": NUMBER},
    ),
    "job_done": EventSchema(
        required={"job": STRING, "outcome": STRING, "exit_code": NUMBER,
                  "generations": NUMBER, "resizes": NUMBER},
    ),
    # profiler trace-session hooks (telemetry/profiler.py)
    "profile": EventSchema(
        required={"action": STRING, "step": NUMBER, "logdir": STRING},
    ),
    # the bench driver's records (bench.py), one per model config
    "bench_model": EventSchema(
        required={"key": STRING, "model": STRING, "dataset": STRING,
                  "batch": NUMBER, "dense_step_ms": NUMBER,
                  "sparse_step_ms": NUMBER, "ratio_median": NUMBER,
                  "compressor": STRING},
        optional={"ratio_min": NUMBER, "ratio_max": NUMBER,
                  "mfu_dense": NUMBER, "mfu_sparse": NUMBER,
                  "ex_per_s_chip": NUMBER,
                  # measurement-protocol + roofline-gate fields:
                  # how many paired rounds back the median, and the
                  # achieved compression overhead against the per-config
                  # memory floor (roofline.py's artifact)
                  "rounds": NUMBER, "overhead_ms": NUMBER,
                  "roofline_floor_ms": NUMBER,
                  "overhead_vs_floor": NUMBER,
                  # measurement-power fields: rounds are run in
                  # M independent windows; per-window paired medians ship
                  # with the record and the config's headline ratio is
                  # their MIN, so a >= 0.90 claim survives re-measurement
                  "windows": NUMBER, "window_medians": ARRAY,
                  "ratio_window_min": NUMBER,
                  # comms wire accounting (parallel/wire.py):
                  # the fixed selector's measured per-step exchange
                  # payload and the format it was packed in
                  "wire_format": STRING, "bytes_sent": NUMBER,
                  # bucket-pipelined schedule: which schedule
                  # the sparse column ran under. (The per-config exposed
                  # exchange time lives on ``bench_overlap`` records —
                  # the main arm never measured it, so the field was
                  # dropped here; lint events flags such dead fields.)
                  "overlap": STRING},
    ),
    # the bench driver's overlap arm: one record per config that ran the
    # off-vs-auto schedule comparison on a pipeline-eligible uniform plan.
    # exposed_*_ms fields are omitted when the paired delta sits below
    # that cell's round-to-round noise (benchlib.noise_floored_delta_ms)
    "bench_overlap": EventSchema(
        required={"key": STRING, "model": STRING, "compressor": STRING,
                  "bucket_size": NUMBER, "n_buckets": NUMBER,
                  "seq_step_ms": NUMBER, "pipe_step_ms": NUMBER,
                  "seq_overlap": STRING, "pipe_overlap": STRING},
        optional={"exposed_seq_ms": NUMBER, "exposed_pipe_ms": NUMBER,
                  "overlapped_bytes_sent": NUMBER, "wire_format": STRING,
                  "bytes_sent": NUMBER, "pipe_vs_seq": NUMBER,
                  "rounds": NUMBER, "windows": NUMBER},
    ),
    "bench_summary": EventSchema(
        required={"metric": STRING, "value": NUMBER,
                  "worst_config": STRING},
        optional={"smoke": NUMBER,      # bool passes NUMBER (see above)
                  "windows": NUMBER, "rounds": NUMBER},
    ),
    # adaptive policy engine (docs/ADAPTIVE.md): knob retunes applied at
    # the recompile-safe boundary, and probation reverts; published from
    # the trainer thread (never from the engine's bus-exporter side)
    "policy_decision": EventSchema(
        required={"step": NUMBER, "rule": STRING, "knob": STRING,
                  "old": STRING, "new": STRING, "reason": STRING},
        # decisions and reverts share one emitter (PolicyEngine._log),
        # which may stamp ``quarantined`` on either kind — the contract
        # checker (lint events) verifies this symmetry statically
        optional={"recompiles": NUMBER, "budget_left": NUMBER,
                  "quarantined": NUMBER},   # bool passes NUMBER
    ),
    "policy_revert": EventSchema(
        required={"step": NUMBER, "rule": STRING, "knob": STRING,
                  "old": STRING, "new": STRING, "reason": STRING},
        optional={"recompiles": NUMBER, "budget_left": NUMBER,
                  "quarantined": NUMBER},   # bool passes NUMBER
    ),
    # step-timeline tracing (telemetry/tracing.py): one record per host
    # phase span. ``ph`` follows the Chrome-trace vocabulary: "X" complete
    # (t0 + dur_ms), "B"/"E" begin/end of a long-lived span (the
    # trajectory), "i" instant marker. ``span_id``/``parent_span`` form
    # the span tree; validate_stream checks its health as WARNINGS only
    # (orphans/unclosed are suspicious, not illegal — a crashed run ends
    # mid-span by design).
    "span": EventSchema(
        required={"name": STRING, "span_id": STRING, "ph": STRING},
        optional={"parent_span": STRING, "trace_id": STRING,
                  "cat": STRING, "t0": NUMBER, "dur_ms": NUMBER,
                  "step": NUMBER, "reason": STRING, "knob": STRING,
                  "path": STRING},
    ),
    # run-health monitor (telemetry/health.py): one verdict per logged
    # train interval when --health on. ``state`` is ok/degraded/critical
    # (``state_code`` 0/1/2 — also the offline CLI's exit code and the
    # Prometheus health_state gauge); every non-ok verdict lists its
    # attributed ``causes`` with the rolling-window evidence inline
    "health_status": EventSchema(
        required={"step": NUMBER, "state": STRING, "state_code": NUMBER},
        optional={"causes": ARRAY, "evidence": OBJECT,
                  "window_intervals": NUMBER, "step_s_p50": NUMBER,
                  "step_s_p95": NUMBER, "step_s_p99": NUMBER,
                  "step_s_trend": NUMBER, "data_wait_frac": NUMBER},
    ),
    # cross-run regression sentinel (telemetry/sentinel.py):
    # the newest bench_history.jsonl record vs a baseline, classified
    # with noise-floored paired deltas. Published so the policy engine's
    # signals can ingest the verdict (policy/signals.py).
    "bench_regression": EventSchema(
        required={"status": STRING, "baseline_rev": STRING,
                  "new_rev": STRING, "n_regressed": NUMBER,
                  "n_improved": NUMBER, "n_flat": NUMBER},
        optional={"worst_config": STRING, "worst_delta": NUMBER,
                  "tolerance": NUMBER, "smoke": NUMBER},  # bool -> NUMBER
    ),
}


def validate_record(record: Mapping[str, Any],
                    strict: bool = False) -> List[str]:
    """Schema-check one record; returns a list of problems (empty = ok).

    Non-strict (the default) implements the compatible-reader contract:
    absent envelope fields and unknown event kinds pass (old files, newer
    writers). ``strict`` additionally requires the full envelope and a
    known event kind — the mode the CI bench smoke validates freshly
    written streams with.
    """
    errors: List[str] = []
    event = record.get("event")
    if not isinstance(event, str):
        return [f"record has no string 'event' field: {record!r:.120}"]
    sv = record.get("schema_version", 0)
    if not isinstance(sv, int) or isinstance(sv, bool):
        errors.append(f"schema_version must be an int, got {sv!r}")
    elif sv > SCHEMA_VERSION:
        errors.append(f"schema_version {sv} is newer than this reader "
                      f"({SCHEMA_VERSION})")
    seq = record.get("seq")
    if seq is not None and (not isinstance(seq, int) or isinstance(seq, bool)
                            or seq < 0):
        errors.append(f"seq must be a non-negative int, got {seq!r}")
    if strict:
        for f_name in ENVELOPE_FIELDS:
            if f_name not in record:
                errors.append(f"{event}: missing envelope field {f_name!r}")
    schema = EVENT_SCHEMAS.get(event)
    if schema is None:
        if strict:
            errors.append(f"unknown event kind {event!r}")
        return errors
    for name, types in schema.required.items():
        if name not in record:
            errors.append(f"{event}: missing required field {name!r}")
        elif record[name] is not None and not isinstance(record[name], types):
            errors.append(
                f"{event}.{name}: expected "
                f"{'/'.join(t.__name__ for t in types)}, "
                f"got {type(record[name]).__name__}")
    for name, types in schema.optional.items():
        if name in record and record[name] is not None and \
                not isinstance(record[name], types):
            errors.append(
                f"{event}.{name}: expected "
                f"{'/'.join(t.__name__ for t in types)}, "
                f"got {type(record[name]).__name__}")
    return errors


@dataclass
class StreamReport:
    """Result of :func:`validate_stream` over one JSONL file/iterable."""

    n_records: int = 0
    events: Dict[str, int] = field(default_factory=dict)
    errors: List[str] = field(default_factory=list)      # fatal problems
    warnings: List[str] = field(default_factory=list)    # suspicious, legal
    n_stamped: int = 0          # records carrying a seq number
    seq_resets: int = 0         # seq went backwards (mixed-run file)
    seq_gaps: int = 0           # seq jumped forward (dropped records)
    seq_duplicates: int = 0     # same seq twice (double-merged stream)
    n_processes: int = 0        # distinct process_index values seen
    truncated: bool = False     # file ends mid-record
    # span-tree health (traced streams only; always warnings, never
    # errors — legacy non-traced streams have neither)
    span_orphans: int = 0       # parent_span ids never declared by a span
    span_unclosed: int = 0      # "B" spans without a matching "E"

    @property
    def ok(self) -> bool:
        return not self.errors and not self.truncated


def validate_stream(lines: Iterable[str], strict: bool = False,
                    max_errors: int = 50) -> StreamReport:
    """Validate a JSONL event stream line by line.

    Detects what the satellite contract asks parsers to detect: truncation
    (a final non-JSON partial line), mixed-run files (seq resets), dropped
    records (seq gaps), and double-merged records (seq duplicates). Legacy
    records without seq/schema_version are counted but not failed
    (non-strict mode).

    Cross-process aware: in a merged pod stream every record carries a
    ``process_index`` provenance stamp, and each process numbers its own
    seq space — so continuity is tracked PER process_index (records
    without the stamp form their own group, which is exactly the old
    single-stream behavior). Interleaving across processes is therefore
    never a false gap, while a record missing from one worker's stream
    still is.
    """
    rep = StreamReport()
    prev_seq_by_proc: Dict[Optional[int], int] = {}
    seen_procs: set = set()
    last_bad_line: Optional[int] = None
    # span-tree bookkeeping: ids are resolved at END of stream because a
    # child "X" span is emitted when it CLOSES — before its still-open
    # parent's own record lands — so a single-pass parent check would
    # flag every legitimate nesting as an orphan
    span_ids: set = set()
    open_spans: Dict[str, int] = {}          # span_id -> B line
    parent_refs: List[Tuple[int, str]] = []  # (line, parent_span)
    for i, line in enumerate(lines, start=1):
        line = line.strip()
        if not line:
            continue
        try:
            record = json.loads(line)
        except json.JSONDecodeError:
            last_bad_line = i
            if len(rep.errors) < max_errors:
                rep.errors.append(f"line {i}: not valid JSON")
            continue
        last_bad_line = None
        if not isinstance(record, dict):
            if len(rep.errors) < max_errors:
                rep.errors.append(f"line {i}: not a JSON object")
            continue
        rep.n_records += 1
        ev = record.get("event")
        key = ev if isinstance(ev, str) else "<missing>"
        rep.events[key] = rep.events.get(key, 0) + 1
        for msg in validate_record(record, strict=strict):
            if len(rep.errors) < max_errors:
                rep.errors.append(f"line {i}: {msg}")
        if key == "span":
            sid = record.get("span_id")
            ph = record.get("ph")
            if isinstance(sid, str):
                if ph in ("X", "B", "i"):
                    span_ids.add(sid)
                if ph == "B":
                    open_spans[sid] = i
                elif ph == "E":
                    if sid in open_spans:
                        del open_spans[sid]
                    else:
                        rep.warnings.append(
                            f"line {i}: span 'E' for {sid!r} without a "
                            f"matching 'B' (double close or lost begin)")
            parent = record.get("parent_span")
            if isinstance(parent, str):
                parent_refs.append((i, parent))
        pidx = record.get("process_index")
        group: Optional[int] = pidx \
            if isinstance(pidx, int) and not isinstance(pidx, bool) else None
        if group is not None:
            seen_procs.add(group)
        seq = record.get("seq")
        if isinstance(seq, int) and not isinstance(seq, bool):
            rep.n_stamped += 1
            prev = prev_seq_by_proc.get(group)
            tag = f" [process {group}]" if group is not None else ""
            if prev is not None:
                if seq == prev:
                    rep.seq_duplicates += 1
                    rep.warnings.append(
                        f"line {i}: duplicate seq {seq}{tag} "
                        f"(record merged or published twice)")
                elif seq < prev:
                    rep.seq_resets += 1
                    rep.warnings.append(
                        f"line {i}: seq reset {prev} -> {seq}{tag} "
                        f"(mixed-run file?)")
                elif seq > prev + 1:
                    rep.seq_gaps += 1
                    rep.warnings.append(
                        f"line {i}: seq gap {prev} -> {seq}{tag} "
                        f"({seq - prev - 1} record(s) missing)")
            prev_seq_by_proc[group] = seq
        elif strict and seq is None:
            pass  # already reported as a missing envelope field above
    if last_bad_line is not None:
        # a bad FINAL line is truncation (a crash mid-write), not noise
        rep.truncated = True
        rep.errors.append(
            f"stream ends with a partial record at line {last_bad_line} "
            f"(truncated file)")
    # span-tree health (warnings only — a crashed run legitimately ends
    # mid-span, and legacy streams without spans trigger neither branch)
    for line_no, parent in parent_refs:
        if parent not in span_ids:
            rep.span_orphans += 1
            rep.warnings.append(
                f"line {line_no}: parent_span {parent!r} never declared "
                f"by any span record (orphan)")
    for sid, line_no in open_spans.items():
        rep.span_unclosed += 1
        rep.warnings.append(
            f"span {sid!r} opened at line {line_no} never closed "
            f"(crashed mid-span, or a missing end())")
    rep.n_processes = len(seen_procs)
    return rep


# ---------------------------------------------------------------------------
# per-process stream merging (the `telemetry merge` subcommand's engine)
# ---------------------------------------------------------------------------

@dataclass
class MergeReport:
    """What :func:`merge_streams` did (and dropped)."""

    n_streams: int = 0
    n_records: int = 0
    dropped_lines: int = 0      # unparsable lines skipped — typically the
                                # torn final line of a SIGKILLed worker
    n_stamped: int = 0          # records that got provenance stamped here


def _parsed_with_ts(lines: Iterable[str],
                    rep: MergeReport) -> Iterator[Tuple[float, Dict[str,
                                                                    Any]]]:
    """Yield (sort_ts, record) per parseable line; a record without a
    usable ``ts`` inherits the previous one in ITS stream (0.0 at start),
    which keeps it adjacent to its neighbours instead of jumping to an
    arbitrary merge position."""
    last_ts = 0.0
    for line in lines:
        line = line.strip()
        if not line:
            continue
        try:
            rec = json.loads(line)
        except json.JSONDecodeError:
            rep.dropped_lines += 1
            continue
        if not isinstance(rec, dict):
            rep.dropped_lines += 1
            continue
        ts = rec.get("ts")
        if isinstance(ts, (int, float)) and not isinstance(ts, bool):
            last_ts = float(ts)
        yield last_ts, rec


def merge_streams(streams: Sequence[Iterable[str]],
                  indices: Sequence[int],
                  ) -> Tuple[List[Dict[str, Any]], MergeReport]:
    """k-way merge of per-process JSONL event streams into one pod
    stream.

    Ordering key is ``(ts, process_index, arrival)``: host timestamps
    interleave the processes (one machine, one clock — the launcher's
    operating regime), ties break by process index, and records from the
    SAME stream always keep their original relative order (the per-stream
    seq contract survives the merge; cross-process seq continuity is then
    checked per process_index by :func:`validate_stream`).

    Provenance: every record is stamped ``process_index = indices[k]``
    via setdefault — a record the worker already live-stamped keeps its
    own value. Unparsable lines (the torn tail a SIGKILL leaves behind)
    are dropped and counted in the report: the merged stream must
    strict-validate even when an input was killed mid-write.
    """
    if len(streams) != len(indices):
        raise ValueError(f"{len(streams)} streams but "
                         f"{len(indices)} process indices")
    rep = MergeReport(n_streams=len(streams))
    heap: List[Tuple[float, int, int, int, Dict[str, Any]]] = []
    iters: List[Iterator[Tuple[float, Dict[str, Any]]]] = []
    positions = [0] * len(streams)
    for sidx, lines in enumerate(streams):
        it = _parsed_with_ts(lines, rep)
        iters.append(it)
        first = next(it, None)
        if first is not None:
            heapq.heappush(heap,
                           (first[0], indices[sidx], sidx, 0, first[1]))
            positions[sidx] = 1
    merged: List[Dict[str, Any]] = []
    while heap:
        _ts, pidx, sidx, _pos, rec = heapq.heappop(heap)
        if "process_index" not in rec:
            rec["process_index"] = pidx
            rep.n_stamped += 1
        merged.append(rec)
        rep.n_records += 1
        nxt = next(iters[sidx], None)
        if nxt is not None:
            heapq.heappush(
                heap, (nxt[0], pidx, sidx, positions[sidx], nxt[1]))
            positions[sidx] += 1
    return merged, rep


def validate_file(path: str, strict: bool = False) -> StreamReport:
    with open(path, "r", encoding="utf-8") as fh:
        return validate_stream(fh, strict=strict)
