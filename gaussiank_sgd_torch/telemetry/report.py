"""Offline report reconstruction from a telemetry JSONL stream (port of
``gaussiank_sgd_tpu/telemetry/report.py``).

``python -m gaussiank_sgd_torch.telemetry report run.jsonl`` rebuilds from
the file alone what the reference printed each display interval: per-phase
timing (io against the device step, and the fwd/bwd | select |
comm+update breakdown when ``--phase-timing`` logged it), the comms volume
(bytes on the wire a step and worker, and the run's estimated total),
compression (achieved against target density, bytes against a dense
exchange), throughput, the resilience history (skips, rollbacks,
preemptions, io retries) and the run's health (replayed at the live
cadence). The summary and its text equal the reference's on the same
stream.

Pure stdlib: it runs without torch.
"""

from __future__ import annotations

import json
import statistics
from typing import Any, Dict, List, Optional, Sequence

from .health import replay_health


def load_events(path: str) -> List[Dict[str, Any]]:
    """Read a JSONL stream tolerantly: undecodable lines are skipped (the
    validator, not the reporter, is the tool that complains about them)."""
    out: List[Dict[str, Any]] = []
    with open(path, "r", encoding="utf-8") as fh:
        for line in fh:
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except json.JSONDecodeError:
                continue
            if isinstance(rec, dict) and isinstance(rec.get("event"), str):
                out.append(rec)
    return out


def _mean(vals: Sequence[float]) -> Optional[float]:
    return float(statistics.fmean(vals)) if vals else None


def _collect(records: List[Dict[str, Any]], key: str) -> List[float]:
    return [float(r[key]) for r in records
            if isinstance(r.get(key), (int, float))
            and not isinstance(r.get(key), bool)]


def _join_program_audit(audit: Dict[str, Any], cfg: Dict[str, Any],
                        train: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Join a run's recorded program key (compressor + wire_format +
    overlap from the stream) to the gklint program-audit artifact
    (``... lint audit -o audit.json``), so the report names the exact
    compiled-program fingerprint the run executed and the git rev the
    audit certified it at."""
    sel = cfg.get("compressor")
    wire = next((r.get("wire_format") for r in reversed(train)
                 if isinstance(r.get("wire_format"), str)), None)
    ovl = next((r.get("overlap") for r in reversed(train)
                if isinstance(r.get("overlap"), str)), None)
    matches: List[Dict[str, Any]] = []
    # a stream that recorded none of the key fields matches nothing —
    # "every arm matched" would misread as a certification
    if sel is not None or wire is not None or ovl is not None:
        for name, arm in sorted((audit.get("arms") or {}).items()):
            if "fingerprint" not in arm:
                continue
            acfg = arm.get("config", {})
            if acfg.get("dense"):
                continue
            if wire is not None and arm.get("wire_format") != wire:
                continue
            if ovl is not None and arm.get("overlap") != ovl:
                continue
            if sel is not None and acfg.get("selector") not in (None, sel):
                continue
            matches.append({"arm": name,
                            "fingerprint": arm["fingerprint"]})
    return {
        "audit_git_rev": audit.get("git_rev"),
        "audit_jax_version": audit.get("jax_version"),
        "audit_ok": audit.get("ok"),
        "run_program_key": {"compressor": sel, "wire_format": wire,
                            "overlap": ovl},
        "matched_arms": matches,
    }


def summarize(events: List[Dict[str, Any]],
              audit: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """Aggregate one run's event list into the report dict (see module
    docstring for the sections). ``audit`` is an optional parsed program-
    audit artifact to join against (``--audit``)."""
    by_kind: Dict[str, List[Dict[str, Any]]] = {}
    for e in events:
        by_kind.setdefault(e["event"], []).append(e)
    train = by_kind.get("train", [])
    cfg = by_kind.get("config", [{}])[0]

    summary: Dict[str, Any] = {
        "stream": {
            "n_records": len(events),
            "events": {k: len(v) for k, v in sorted(by_kind.items())},
            "schema_versions": sorted(
                {e.get("schema_version", 0) for e in events}),
        },
        "run": {k: cfg.get(k) for k in
                ("dnn", "dataset", "compressor", "density", "batch_size",
                 "lr", "nworkers", "n_params", "total_steps")
                if k in cfg},
    }

    steps = _collect(train, "step")
    last_step = int(max(steps)) if steps else 0
    phases: Dict[str, Optional[float]] = {
        "io_s_mean": _mean(_collect(train, "io_s")),
        "step_s_mean": _mean(_collect(train, "step_s")),
    }
    # probe decomposition (only on --phase-timing runs, and only from
    # intervals that were not compile-polluted)
    for k in ("fwd_bwd_s", "select_s", "comm_update_s"):
        vals = _collect(train, k)
        if vals:
            phases[f"{k}_mean"] = _mean(vals)
    summary["steps"] = {
        "logged_intervals": len(train),
        "last_step": last_step,
        "last_loss": train[-1].get("loss") if train else None,
        "last_lr": train[-1].get("lr") if train else None,
    }
    summary["timing"] = phases

    ex_per_s = _collect(train, "ex_per_s")
    summary["throughput"] = {
        "ex_per_s_mean": _mean(ex_per_s),
        "ex_per_s_last": ex_per_s[-1] if ex_per_s else None,
        "mfu_mean": _mean(_collect(train, "mfu")),
    }

    bytes_sent = _collect(train, "bytes_sent")
    n_params = cfg.get("n_params")
    nworkers = cfg.get("nworkers")
    comms: Dict[str, Any] = {
        "bytes_per_step_worker_mean": _mean(bytes_sent),
        "bytes_per_step_worker_last": bytes_sent[-1] if bytes_sent else None,
    }
    if bytes_sent and last_step:
        # logging samples every log_every steps; the run total is the
        # sampled mean extrapolated over all steps — flagged as estimate
        per_worker = _mean(bytes_sent) * last_step
        comms["est_total_bytes_per_worker"] = round(per_worker)
        if isinstance(nworkers, (int, float)) and nworkers:
            comms["est_total_bytes_all_workers"] = round(
                per_worker * nworkers)
    dens_achieved = _collect(train, "density_achieved")
    compression: Dict[str, Any] = {
        "density_target": cfg.get("density"),
        "density_achieved_mean": _mean(dens_achieved),
        "num_selected_mean": _mean(_collect(train, "num_selected")),
        "ef_norm_last": (_collect(train, "ef_norm") or [None])[-1],
    }
    if bytes_sent and isinstance(n_params, (int, float)) and n_params:
        dense_bytes = 4.0 * float(n_params)
        mean_b = _mean(bytes_sent)
        if mean_b:
            compression["bytes_vs_dense"] = mean_b / dense_bytes
    summary["comms"] = comms
    summary["compression"] = compression

    # overlap efficiency: how much of the sparse
    # payload the pipelined schedule launched while later chunks were
    # still compressing, and the exchange time it still left exposed
    pipelined = [r for r in train if r.get("overlap") == "pipelined"]
    if pipelined:
        fracs = [float(r["overlapped_bytes_sent"]) / float(r["bytes_sent"])
                 for r in pipelined
                 if isinstance(r.get("overlapped_bytes_sent"), (int, float))
                 and not isinstance(r.get("overlapped_bytes_sent"), bool)
                 and float(r.get("bytes_sent", 0) or 0) > 0]
        summary["overlap"] = {
            "pipelined_intervals": len(pipelined),
            "overlapped_frac_mean": _mean(fracs),
            "exposed_exchange_ms_mean": _mean(
                _collect(pipelined, "exposed_exchange_ms")),
        }
    bench_ovl = by_kind.get("bench_overlap", [])
    if bench_ovl:
        summary["bench_overlap"] = [
            {k: r.get(k) for k in ("key", "n_buckets", "seq_step_ms",
                                   "pipe_step_ms", "pipe_vs_seq",
                                   "exposed_seq_ms", "exposed_pipe_ms",
                                   "overlapped_bytes_sent")}
            for r in bench_ovl]

    # adaptive policy decision log: applies + reverts
    # in stream order, so the report shows WHAT the closed loop did and
    # why without replaying the run
    decisions = by_kind.get("policy_decision", [])
    reverts = by_kind.get("policy_revert", [])
    if decisions or reverts:
        chron = sorted(decisions + reverts,
                       key=lambda r: (r.get("seq") is None,
                                      r.get("seq", 0)))
        summary["policy"] = {
            "decisions": len(decisions),
            "reverts": len(reverts),
            "log": [{"kind": r["event"], "step": r.get("step"),
                     "rule": r.get("rule"), "knob": r.get("knob"),
                     "old": r.get("old"), "new": r.get("new"),
                     "reason": r.get("reason")} for r in chron],
        }

    rollbacks = by_kind.get("rollback", [])
    summary["resilience"] = {
        "skips": len(by_kind.get("skip", [])),
        "nonfinite_total": sum(_collect(by_kind.get("skip", []),
                                        "nonfinite")),
        "rollbacks": len(rollbacks),
        "last_rollback": ({k: rollbacks[-1].get(k) for k in
                           ("reason", "to_step", "lr_scale")}
                          if rollbacks else None),
        "preempts": len(by_kind.get("preempt", [])),
        "io_retries": len(by_kind.get("io_retry", [])),
        "restore_fallbacks": len(by_kind.get("restore_fallback", [])),
        "checkpoints": len(by_kind.get("checkpoint", [])),
    }

    # run health (telemetry/health.py): replayed from the raw stream at
    # the live cadence (one verdict per train interval), so the section
    # exists even for runs recorded before --health on — and for
    # live-monitored runs it reproduces the exact verdicts they logged
    if train:
        _, health_mon = replay_health(events)
        hs = health_mon.summary()
        if hs["verdicts"]:
            summary["health"] = hs

    evals = by_kind.get("eval", [])
    if evals:
        last = evals[-1]
        summary["eval_last"] = {k: v for k, v in last.items()
                                if k not in ("event", "schema_version",
                                             "seq", "ts")}
    profiles = by_kind.get("profile", [])
    if profiles:
        summary["profile"] = [
            {k: p.get(k) for k in ("action", "step", "logdir")}
            for p in profiles]

    if audit is not None:
        summary["program_audit"] = _join_program_audit(audit, cfg, train)
    return summary


def _fmt(v: Any, unit: str = "", scale: float = 1.0,
         digits: int = 3) -> str:
    if v is None:
        return "n/a"
    if isinstance(v, float):
        return f"{v * scale:.{digits}g}{unit}"
    return f"{v}{unit}"


def format_report(summary: Dict[str, Any]) -> str:
    """Human-readable rendering of :func:`summarize`'s dict."""
    s = summary
    lines: List[str] = []
    run = s.get("run", {})
    lines.append("== run ==")
    if run:
        lines.append(
            f"  {run.get('dnn', '?')} / {run.get('dataset', '?')}  "
            f"compressor={run.get('compressor', '?')} "
            f"density={run.get('density', '?')}  "
            f"workers={run.get('nworkers', '?')}  "
            f"params={_fmt(run.get('n_params'))}")
    st = s["steps"]
    lines.append(
        f"  steps: {st['last_step']}/{run.get('total_steps', '?')} "
        f"({st['logged_intervals']} logged intervals)  "
        f"last loss={_fmt(st['last_loss'], digits=4)} "
        f"lr={_fmt(st['last_lr'])}")

    t = s["timing"]
    lines.append("== per-phase timing (interval means) ==")
    lines.append(f"  io    {_fmt(t['io_s_mean'], ' ms', 1e3)}")
    lines.append(f"  step  {_fmt(t['step_s_mean'], ' ms', 1e3)}")
    for key, label in (("fwd_bwd_s_mean", "fwd+bwd"),
                       ("select_s_mean", "select"),
                       ("comm_update_s_mean", "comm+update")):
        if key in t:
            lines.append(f"    {label:<12}{_fmt(t[key], ' ms', 1e3)}")

    tp = s["throughput"]
    lines.append("== throughput ==")
    lines.append(f"  ex/s  {_fmt(tp['ex_per_s_mean'], digits=4)} mean, "
                 f"{_fmt(tp['ex_per_s_last'], digits=4)} last")
    if tp.get("mfu_mean") is not None:
        lines.append(f"  mfu   {_fmt(tp['mfu_mean'], digits=3)}")

    c = s["comms"]
    lines.append("== comms volume ==")
    lines.append(
        f"  bytes/step/worker  "
        f"{_fmt(c['bytes_per_step_worker_mean'], digits=5)} mean, "
        f"{_fmt(c['bytes_per_step_worker_last'], digits=5)} last")
    if "est_total_bytes_per_worker" in c:
        lines.append(
            f"  est. run total     "
            f"{_fmt(float(c['est_total_bytes_per_worker']), digits=5)} "
            f"per worker"
            + (f", {_fmt(float(c['est_total_bytes_all_workers']), digits=5)}"
               f" all workers"
               if "est_total_bytes_all_workers" in c else ""))

    cp = s["compression"]
    lines.append("== compression efficiency ==")
    lines.append(
        f"  density  target {_fmt(cp['density_target'])}, achieved "
        f"{_fmt(cp['density_achieved_mean'])} (mean)")
    if cp.get("bytes_vs_dense") is not None:
        lines.append(
            f"  wire bytes vs dense exchange  "
            f"{_fmt(cp['bytes_vs_dense'])}x")
    if cp.get("ef_norm_last") is not None:
        lines.append(f"  EF-residual norm (last)  "
                     f"{_fmt(cp['ef_norm_last'], digits=5)}")

    if "overlap" in s:
        ov = s["overlap"]
        lines.append("== overlap efficiency ==")
        lines.append(
            f"  pipelined intervals  {ov['pipelined_intervals']}  "
            f"overlapped payload "
            f"{_fmt(ov['overlapped_frac_mean'])} of bytes_sent  "
            f"exposed exchange "
            f"{_fmt(ov['exposed_exchange_ms_mean'], ' ms', digits=4)}")
    if "bench_overlap" in s:
        lines.append("== bench overlap arm (off vs pipelined) ==")
        for row in s["bench_overlap"]:
            exp = (f"exposed {_fmt(row.get('exposed_seq_ms'), digits=4)}"
                   f" -> {_fmt(row.get('exposed_pipe_ms'), digits=4)} ms"
                   if row.get("exposed_seq_ms") is not None
                   or row.get("exposed_pipe_ms") is not None
                   else "exposed delta below noise floor")
            lines.append(
                f"  {row.get('key', '?'):<24} "
                f"{_fmt(row.get('seq_step_ms'), digits=4)} -> "
                f"{_fmt(row.get('pipe_step_ms'), digits=4)} ms "
                f"({_fmt(row.get('pipe_vs_seq'))}x, "
                f"{row.get('n_buckets', '?')} buckets)  {exp}")

    if "policy" in s:
        p = s["policy"]
        lines.append(f"== policy decision log "
                     f"({p['decisions']} applied, {p['reverts']} "
                     f"reverted) ==")
        for d in p["log"]:
            arrow = "applied" if d["kind"] == "policy_decision" \
                else "REVERTED"
            lines.append(
                f"  step {d.get('step', '?'):>6}  {arrow:<8} "
                f"[{d.get('rule', '?')}] {d.get('knob', '?')}: "
                f"{d.get('old', '?')} -> {d.get('new', '?')}  "
                f"({d.get('reason', '?')})")

    r = s["resilience"]
    lines.append("== resilience ==")
    lines.append(
        f"  skips={r['skips']} (nonfinite={_fmt(r['nonfinite_total'])})  "
        f"rollbacks={r['rollbacks']}  preempts={r['preempts']}  "
        f"io_retries={r['io_retries']}  "
        f"restore_fallbacks={r['restore_fallbacks']}  "
        f"checkpoints={r['checkpoints']}")
    if r.get("last_rollback"):
        lr_ = r["last_rollback"]
        lines.append(
            f"  last rollback: {lr_.get('reason')} -> step "
            f"{lr_.get('to_step')} (lr_scale {lr_.get('lr_scale')})")

    if "health" in s:
        h = s["health"]
        lines.append(f"== run health (worst: {h['worst_state']}, "
                     f"{h['verdicts']} verdicts) ==")
        for cause, steps in sorted(h.get("cause_steps", {}).items(),
                                   key=lambda kv: (-kv[1], kv[0])):
            lines.append(f"  cause {cause:<22} active ~{steps} step(s)")
        incidents = h.get("incidents", [])
        if incidents:
            for i in incidents:
                lines.append(
                    f"  steps {i['start_step']:>6}-{i['end_step']:<6} "
                    f"{i['state']:<9} {', '.join(i['causes'])}")
        else:
            lines.append("  no incidents")

    if "program_audit" in s:
        pa = s["program_audit"]
        key = pa["run_program_key"]
        lines.append("== program audit join ==")
        lines.append(
            f"  audit @ git {pa.get('audit_git_rev') or '?'} "
            f"(jax {pa.get('audit_jax_version') or '?'}, "
            f"{'clean' if pa.get('audit_ok') else 'VIOLATIONS'})")
        lines.append(
            f"  run program key: compressor={key.get('compressor') or '?'} "
            f"wire={key.get('wire_format') or '?'} "
            f"overlap={key.get('overlap') or '?'}")
        if pa["matched_arms"]:
            for m in pa["matched_arms"]:
                lines.append(f"  matched arm {m['arm']:<38} "
                             f"fingerprint {m['fingerprint']}")
        else:
            lines.append("  no audited arm matches this run's program key "
                         "(config outside the audited matrix)")

    if "eval_last" in s:
        lines.append("== eval (last) ==")
        lines.append("  " + "  ".join(
            f"{k}={_fmt(v, digits=4)}" for k, v in s["eval_last"].items()))

    ev = s["stream"]["events"]
    lines.append("== stream ==")
    lines.append(f"  {s['stream']['n_records']} records: " + ", ".join(
        f"{k}={n}" for k, n in ev.items()))
    return "\n".join(lines)
