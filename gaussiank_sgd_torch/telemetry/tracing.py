"""Span-based step tracing over the event bus (the port's own copy of
``gaussiank_sgd_tpu/telemetry/tracing.py``).

Two halves, deliberately decoupled:

*Online* — :class:`TraceContext` wraps an :class:`~.bus.EventBus` and
emits ``span`` records for HOST phases only (data wait, step dispatch,
checkpoint save, rollback). It installs a stamp hook on the bus so every
record published while a span is open carries ``trace_id``/``span_id`` —
producers never change. The device timeline is NOT measured online
(that would need host syncs the hot path avoids).

*Offline* — :func:`build_chrome_trace` renders a finished JSONL stream
into Chrome-trace/Perfetto JSON. Device phases are RECONSTRUCTED from
instrumentation the step already pays for: the per-phase ablation
timings on ``train`` records (fwd_bwd_s/select_s/comm_update_s from the
timing-twin protocol), the pipelined schedule's ``exposed_exchange_ms``
+ ``overlapped_bytes_sent``, and the per-chunk geometry on
``bench_overlap`` records. The reconstruction is a model of the step —
anchored so each interval ENDS at its record's publish timestamp — not
a hardware trace; its value is making overlap visible (did chunk i's
exchange hide behind chunk i+1's compress?), and torch.profiler remains
the ground-truth tool (telemetry/profiler.py).

Everything in this module is pure stdlib.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from typing import (Any, Callable, Dict, Iterable, Iterator, List, Mapping,
                    Optional, Tuple)

__all__ = [
    "TraceContext",
    "build_chrome_trace",
    "chrome_trace_overlap_pairs",
]


def _default_trace_id() -> str:
    # unique enough across runs on one host; injectable for tests
    return f"{os.getpid():x}-{int(time.time() * 1e3):x}"


class TraceContext:
    """Allocates span ids and publishes ``span`` records on a bus.

    Span ids are sequential per-context (``s0001``, ``s0002``, ...) so a
    trace is deterministic given a deterministic schedule; the open-span
    stack is thread-local, so the prefetch thread's io_retry records are
    stamped with ITS innermost span, not the train loop's.

    ``install()`` registers the stamp hook (``trace_id`` always,
    ``span_id`` of the innermost open span when one exists) on the bus;
    without ``install()`` the bus stream is byte-identical to an
    untraced run.
    """

    def __init__(self, bus: Any, trace_id: Optional[str] = None,
                 clock: Callable[[], float] = time.time,
                 perf: Callable[[], float] = time.perf_counter):
        self._bus = bus
        self.trace_id = trace_id or _default_trace_id()
        self._clock = clock
        self._perf = perf
        self._lock = threading.Lock()
        self._n = 0
        self._local = threading.local()
        self._open_names: Dict[str, str] = {}   # B-span id -> name

    # ------------------------------------------------------------- ids
    def _next_id(self) -> str:
        with self._lock:
            self._n += 1
            return f"s{self._n:04x}"

    def _stack(self) -> List[str]:
        st = getattr(self._local, "stack", None)
        if st is None:
            st = []
            self._local.stack = st
        return st

    def current_span(self) -> Optional[str]:
        st = self._stack()
        return st[-1] if st else None

    # ----------------------------------------------------- bus stamping
    def stamp(self) -> Dict[str, Any]:
        """Fields merged (setdefault) onto every published record; called
        under the bus lock by EventBus.publish — must never publish."""
        out: Dict[str, Any] = {"trace_id": self.trace_id}
        cur = self.current_span()
        if cur is not None:
            out["span_id"] = cur
        return out

    def install(self) -> "TraceContext":
        self._bus.set_stamp(self.stamp)
        return self

    def uninstall(self) -> None:
        self._bus.set_stamp(None)

    # ------------------------------------------------------------ spans
    @contextlib.contextmanager
    def span(self, name: str, cat: str = "host",
             **fields: Any) -> Iterator[str]:
        """Complete ("X") span around a host phase. The record is emitted
        at CLOSE — a nested child's record lands before its parent's, so
        readers resolve parents at end-of-stream (events.validate_stream
        does exactly this)."""
        sid = self._next_id()
        parent = self.current_span()
        self._stack().append(sid)
        t0 = self._clock()
        p0 = self._perf()
        try:
            yield sid
        finally:
            st = self._stack()
            if st and st[-1] == sid:
                st.pop()
            elif sid in st:          # defensive: out-of-order close
                st.remove(sid)
            rec = {"name": name, "span_id": sid, "ph": "X", "cat": cat,
                   "t0": round(t0, 6),
                   "dur_ms": round((self._perf() - p0) * 1e3, 3)}
            if parent is not None:
                rec["parent_span"] = parent
            rec.update(fields)
            self._bus.emit("span", **rec)

    def begin(self, name: str, cat: str = "host", **fields: Any) -> str:
        """Open a long-lived ("B") span — e.g. a whole trajectory between
        rollbacks. Must be closed with :meth:`end`."""
        sid = self._next_id()
        parent = self.current_span()
        self._stack().append(sid)
        self._open_names[sid] = name
        rec = {"name": name, "span_id": sid, "ph": "B", "cat": cat,
               "t0": round(self._clock(), 6)}
        if parent is not None:
            rec["parent_span"] = parent
        rec.update(fields)
        self._bus.emit("span", **rec)
        return sid

    def end(self, span_id: str, **fields: Any) -> None:
        name = self._open_names.pop(span_id, "span")
        st = self._stack()
        if span_id in st:
            st.remove(span_id)
        self._bus.emit("span", name=name, span_id=span_id, ph="E",
                       cat="host", **fields)

    def instant(self, name: str, cat: str = "host", **fields: Any) -> str:
        """Zero-duration marker (anomaly pending, preemption signal)."""
        sid = self._next_id()
        parent = self.current_span()
        rec = {"name": name, "span_id": sid, "ph": "i", "cat": cat}
        if parent is not None:
            rec["parent_span"] = parent
        rec.update(fields)
        self._bus.emit("span", **rec)
        return sid


# ---------------------------------------------------------------------
# offline: JSONL -> Chrome-trace JSON
# ---------------------------------------------------------------------

# fixed tid layout, one set per worker (pid). Perfetto shows the thread
# names from the metadata events; numbers keep rows stably ordered.
_TID_HOST = 0
_TID_DEVICE = 1
_TID_COMM = 2
_TID_COMPRESS = 3
_TID_EVENTS = 4

_TID_NAMES = {
    _TID_HOST: "host phases",
    _TID_DEVICE: "device step (reconstructed)",
    _TID_COMM: "exchange (reconstructed)",
    _TID_COMPRESS: "compress chunks (reconstructed)",
    _TID_EVENTS: "events",
}

def _x(name: str, ts_us: float, dur_us: float, tid: int, pid: int,
       cat: str, args: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    ev: Dict[str, Any] = {"name": name, "ph": "X", "ts": round(ts_us, 1),
                          "dur": round(max(dur_us, 0.0), 1), "pid": pid,
                          "tid": tid, "cat": cat}
    if args:
        ev["args"] = args
    return ev


def _pick_ts(rec: Mapping[str, Any]) -> Optional[float]:
    for key in ("t0", "ts"):
        v = rec.get(key)
        if isinstance(v, (int, float)) and not isinstance(v, bool):
            return float(v)
    return None


def _render_span(rec: Mapping[str, Any], us: Callable[[float], float],
                 pid: int, out: List[Dict[str, Any]]) -> None:
    name = str(rec.get("name", "span"))
    ph = rec.get("ph")
    t = _pick_ts(rec)
    if t is None:
        return
    args = {k: rec[k] for k in ("span_id", "parent_span", "step", "reason",
                                "knob", "path") if k in rec}
    cat = str(rec.get("cat", "host"))
    if ph == "X":
        dur_ms = rec.get("dur_ms", 0.0)
        out.append(_x(name, us(t), float(dur_ms) * 1e3, _TID_HOST, pid,
                      cat, args))
    elif ph in ("B", "E"):
        out.append({"name": name, "ph": ph, "ts": round(us(t), 1),
                    "pid": pid, "tid": _TID_HOST, "cat": cat, "args": args})
    elif ph == "i":
        out.append({"name": name, "ph": "i", "s": "t",
                    "ts": round(us(float(rec.get("ts", t))), 1),
                    "pid": pid, "tid": _TID_HOST, "cat": cat, "args": args})


def _render_train(rec: Mapping[str, Any], us: Callable[[float], float],
                  pid: int, out: List[Dict[str, Any]]) -> None:
    """One representative step per log interval, anchored to END at the
    record's publish ts (the interval's metrics are per-step means, so
    this draws the LAST step of the interval to scale)."""
    ts = rec.get("ts")
    step_s = rec.get("step_s")
    if not isinstance(ts, (int, float)) or not isinstance(step_s, (int, float)):
        return
    if isinstance(ts, bool) or isinstance(step_s, bool) or step_s <= 0:
        return
    t_end = float(ts)
    t_start = t_end - float(step_s)
    step = rec.get("step")
    args = {"step": step, "loss": rec.get("loss")}
    phases = [("fwd_bwd", rec.get("fwd_bwd_s")),
              ("select_pack", rec.get("select_s")),
              ("comm_update", rec.get("comm_update_s"))]
    have_phases = all(isinstance(v, (int, float)) and not isinstance(v, bool)
                      for _, v in phases)
    if have_phases:
        t = t_start
        for pname, v in phases:
            out.append(_x(f"{pname} [step {step}]", us(t), float(v) * 1e6,
                          _TID_DEVICE, pid, "device", args))
            t += float(v)
    else:
        out.append(_x(f"step {step}", us(t_start), float(step_s) * 1e6,
                      _TID_DEVICE, pid, "device", args))
    # pipelined exchange: the exposed tail is what the schedule failed to
    # hide (step minus its sparse_noexch twin); the overlapped portion is
    # drawn inside the compute window, scaled by the byte fraction that
    # was launched early (StepMetrics.overlapped_bytes_sent)
    if rec.get("overlap") != "pipelined":
        return
    exposed_ms = rec.get("exposed_exchange_ms")
    exposed_s = (float(exposed_ms) / 1e3
                 if isinstance(exposed_ms, (int, float))
                 and not isinstance(exposed_ms, bool) else 0.0)
    exposed_s = min(max(exposed_s, 0.0), float(step_s))
    if exposed_s > 0:
        out.append(_x(f"exchange exposed [step {step}]",
                      us(t_end - exposed_s), exposed_s * 1e6,
                      _TID_COMM, pid, "exchange",
                      {"exposed_exchange_ms": exposed_ms}))
    bs = rec.get("bytes_sent")
    ob = rec.get("overlapped_bytes_sent")
    if (isinstance(bs, (int, float)) and isinstance(ob, (int, float))
            and not isinstance(bs, bool) and not isinstance(ob, bool)
            and bs > 0 and ob > 0):
        frac = min(float(ob) / float(bs), 1.0)
        hidden_s = frac * max(float(step_s) - exposed_s, 0.0)
        if hidden_s > 0:
            out.append(_x(f"exchange overlapped [step {step}]",
                          us(t_end - exposed_s - hidden_s), hidden_s * 1e6,
                          _TID_COMM, pid, "exchange",
                          {"overlapped_bytes_sent": ob, "bytes_sent": bs}))


def _render_bench_overlap(rec: Mapping[str, Any],
                          us: Callable[[float], float], pid: int,
                          out: List[Dict[str, Any]]) -> None:
    """Per-chunk reconstruction of the pipelined schedule: chunk i's
    exchange launches when its compress finishes and runs while chunk
    i+1 compresses — the geometry the pipelined step executes. Chunk
    durations come from the measured totals: compute = pipe_step_ms
    minus the exposed tail, split evenly over n_buckets; per-chunk
    exchange from the sequential arm's exposed time (the full,
    un-hidden cost) when the noise floor let it through."""
    ts = rec.get("ts")
    pipe_ms = rec.get("pipe_step_ms")
    n = rec.get("n_buckets")
    if not all(isinstance(v, (int, float)) and not isinstance(v, bool)
               for v in (ts, pipe_ms, n)):
        return
    n = int(n)
    if n < 1 or float(pipe_ms) <= 0:
        return
    key = str(rec.get("key", rec.get("model", "?")))
    tail_ms = rec.get("exposed_pipe_ms")
    tail = (float(tail_ms) if isinstance(tail_ms, (int, float))
            and not isinstance(tail_ms, bool) else 0.0)
    tail = min(max(tail, 0.0), float(pipe_ms))
    c = (float(pipe_ms) - tail) / n          # per-chunk compress+compute
    seq_ms = rec.get("exposed_seq_ms")
    if isinstance(seq_ms, (int, float)) and not isinstance(seq_ms, bool) \
            and float(seq_ms) > 0:
        e = float(seq_ms) / n                # per-chunk exchange cost
    elif tail > 0:
        e = tail                             # only the tail was visible
    else:
        # both deltas sat below the noise floor: draw a nominal 20%
        # exchange so the SHAPE of the schedule is still inspectable
        e = 0.2 * float(pipe_ms) / n
    t0 = float(ts) - float(pipe_ms) / 1e3
    args = {"key": key, "n_buckets": n, "pipe_step_ms": pipe_ms,
            "exposed_pipe_ms": rec.get("exposed_pipe_ms"),
            "exposed_seq_ms": rec.get("exposed_seq_ms")}
    for i in range(n):
        cs = t0 + i * c / 1e3
        out.append(_x(f"compress[{i}] {key}", us(cs), c * 1e3,
                      _TID_COMPRESS, pid, "compress", args))
        # chunk i's exchange starts where its compress ends → it runs
        # under compress[i+1] for every i < n-1 (the pipeline's point)
        out.append(_x(f"exchange[{i}] {key}", us(cs + c / 1e3), e * 1e3,
                      _TID_COMM, pid, "exchange", args))


def build_chrome_trace(events: Iterable[Mapping[str, Any]],
                       pid: int = 0) -> Dict[str, Any]:
    """Render parsed event records into a Chrome-trace JSON object.

    ``pid`` names the worker: merge several workers' streams into one
    Perfetto view by rendering each with a distinct pid and
    concatenating the ``traceEvents`` lists. Timestamps are µs relative
    to the earliest record, so cross-worker merges stay aligned as long
    as hosts share a clock.
    """
    recs = [r for r in events if isinstance(r, Mapping)]
    base: Optional[float] = None
    for r in recs:
        t = _pick_ts(r)
        if t is not None:
            base = t if base is None else min(base, t)
        # reconstructed intervals START before their record's ts
        ts = r.get("ts")
        if not isinstance(ts, (int, float)) or isinstance(ts, bool):
            continue
        step_s = r.get("step_s")
        if isinstance(step_s, (int, float)) and not isinstance(step_s, bool):
            start = float(ts) - float(step_s)
            base = start if base is None else min(base, start)
        pm = r.get("pipe_step_ms")
        if isinstance(pm, (int, float)) and not isinstance(pm, bool):
            start = float(ts) - float(pm) / 1e3
            base = start if base is None else min(base, start)
    if base is None:
        base = 0.0

    def us(t: float) -> float:
        return (t - base) * 1e6

    out: List[Dict[str, Any]] = []
    proc_name = "worker"
    for r in recs:
        ev = r.get("event")
        if ev == "span":
            _render_span(r, us, pid, out)
        elif ev == "train":
            _render_train(r, us, pid, out)
        elif ev == "bench_overlap":
            _render_bench_overlap(r, us, pid, out)
        else:
            t = _pick_ts(r)
            if t is None:
                continue
            name = str(ev) if isinstance(ev, str) else "<record>"
            args = {k: v for k, v in r.items()
                    if isinstance(v, (str, int, float))}
            out.append({"name": name, "ph": "i", "s": "t",
                        "ts": round(us(t), 1), "pid": pid,
                        "tid": _TID_EVENTS, "cat": "event", "args": args})
    meta: List[Dict[str, Any]] = [
        {"name": "process_name", "ph": "M", "pid": pid, "tid": 0,
         "args": {"name": f"{proc_name} {pid}"}},
    ]
    for tid, tname in _TID_NAMES.items():
        meta.append({"name": "thread_name", "ph": "M", "pid": pid,
                     "tid": tid, "args": {"name": tname}})
        meta.append({"name": "thread_sort_index", "ph": "M", "pid": pid,
                     "tid": tid, "args": {"sort_index": tid}})
    return {"traceEvents": meta + out, "displayTimeUnit": "ms"}


def chrome_trace_overlap_pairs(trace: Mapping[str, Any]) -> int:
    """Count (exchange span, compress/compute span) pairs whose time
    ranges intersect on the same worker but different tracks — the
    acceptance check "did an exchange actually hide behind compute"."""

    def _ranges(pred: Callable[[Mapping[str, Any]], bool]) \
            -> List[Tuple[int, int, float, float]]:
        rs = []
        for ev in trace.get("traceEvents", []):
            if ev.get("ph") != "X" or not pred(ev):
                continue
            ts, dur = ev.get("ts"), ev.get("dur")
            if not isinstance(ts, (int, float)) \
                    or not isinstance(dur, (int, float)) or dur <= 0:
                continue
            rs.append((int(ev.get("pid", 0)), int(ev.get("tid", 0)),
                       float(ts), float(ts) + float(dur)))
        return rs

    exch = _ranges(lambda e: e.get("cat") == "exchange")
    comp = _ranges(lambda e: e.get("cat") in ("compress", "device"))
    pairs = 0
    for epid, etid, e0, e1 in exch:
        for cpid, ctid, c0, c1 in comp:
            if epid == cpid and etid != ctid and max(e0, c0) < min(e1, c1):
                pairs += 1
    return pairs
