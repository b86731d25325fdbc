"""Exporters — where bus records go, behind one interface (the port's own
copy of ``gaussiank_sgd_tpu/telemetry/exporters.py``).

Three concrete sinks cover the runtime's needs: an append-only JSONL file
(the trainer's metrics stream and bench.py's machine-readable records), a
Prometheus node-exporter textfile (latest numeric gauges for scrape-based
monitoring), and a bounded in-memory ring buffer (tests and interactive
inspection). All are individually thread-safe: the bus serializes its own
fan-out, and an exporter may also be driven directly from several
threads.
"""

from __future__ import annotations

import json
import os
import re
import threading
from collections import deque
from typing import Any, Dict, List, Mapping, Optional


class Exporter:
    """Sink interface: ``emit`` one record; ``flush``/``close`` are
    optional lifecycle hooks (default no-ops)."""

    def emit(self, record: Mapping[str, Any]) -> None:
        raise NotImplementedError

    def flush(self) -> None:
        return None

    def close(self) -> None:
        return None


class JSONLExporter(Exporter):
    """Append-only JSONL stream (one dict per line, line-buffered).

    ``path=None`` is a no-op sink (a rank other than 0 writes no
    file). ``mode='w'`` truncates — bench.py uses it so each run's event
    file validates as a single-run stream; the trainer keeps the default
    append so a resumed run extends its own history.
    """

    def __init__(self, path: Optional[str], mode: str = "a"):
        if mode not in ("a", "w"):
            raise ValueError(f"mode must be 'a' or 'w', got {mode!r}")
        self.path = path
        self._f = None
        self._lock = threading.Lock()
        if path:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            self._f = open(path, mode, buffering=1)

    def emit(self, record: Mapping[str, Any]) -> None:
        # dump OUTSIDE the lock is tempting but the dump+write pair must be
        # atomic per record: interleaved half-lines corrupt the stream for
        # every downstream parser
        line = json.dumps(record, default=float) + "\n"
        with self._lock:
            if self._f:
                # gklint: disable=conc-blocking-under-lock -- per-exporter lock exists to serialize exactly this write; line-buffered, no fsync
                self._f.write(line)

    def flush(self) -> None:
        with self._lock:
            if self._f:
                self._f.flush()

    def close(self) -> None:
        with self._lock:
            if self._f:
                self._f.close()
                self._f = None


class MemoryExporter(Exporter):
    """Bounded ring buffer of the most recent ``capacity`` records."""

    def __init__(self, capacity: int = 1024):
        if capacity <= 0:
            raise ValueError(f"capacity must be positive, got {capacity}")
        self.capacity = capacity
        self._buf: deque = deque(maxlen=capacity)
        self._lock = threading.Lock()

    def emit(self, record: Mapping[str, Any]) -> None:
        with self._lock:
            self._buf.append(dict(record))

    @property
    def records(self) -> List[Dict[str, Any]]:
        with self._lock:
            return list(self._buf)

    def events(self, kind: str) -> List[Dict[str, Any]]:
        return [r for r in self.records if r.get("event") == kind]

    def clear(self) -> None:
        with self._lock:
            self._buf.clear()


_METRIC_CHARS = re.compile(r"[^a-zA-Z0-9_]")


class PrometheusTextfileExporter(Exporter):
    """node-exporter textfile-collector sink.

    Keeps the LATEST numeric value of every ``<event>.<field>`` as a gauge
    ``<prefix>_<event>_<field>`` plus a per-event record counter
    ``<prefix>_events_total{event="..."}``, and rewrites the textfile
    atomically (tmp + rename — the collector must never scrape a torn
    file). Strings/lists are skipped: Prometheus is numbers-only; the
    JSONL stream is the full-fidelity record.

    Comms-volume fields additionally accumulate as monotonic counters
    (``_total`` suffix) so dashboards can ``rate()`` the wire traffic:
    ``<prefix>_train_bytes_sent_total`` and
    ``<prefix>_train_overlapped_bytes_sent_total`` sum the logged
    per-step payloads across intervals (sampled totals — the trainer
    logs every ``log_every`` steps, so multiply by the cadence for an
    absolute estimate). The exposed exchange time stays a gauge
    (``<prefix>_train_exposed_exchange_ms``): it is a level, not a
    volume.

    ``health_status`` records (telemetry/health.py) additionally publish
    ``<prefix>_health_state`` (the 0/1/2 ok/degraded/critical code) and
    one ``<prefix>_health_cause_active{cause="..."}`` gauge per cause
    the monitor has ever attributed — 1 while the cause is named by the
    latest verdict, 0 once it clears — so dashboards can alert on a
    specific cause, not just the aggregate state.
    """

    # per-event numeric fields that accumulate as *_total counters
    # alongside their latest-value gauges
    COUNTER_FIELDS: Mapping[str, tuple] = {
        "train": ("bytes_sent", "overlapped_bytes_sent"),
    }

    def __init__(self, path: str, prefix: str = "gksgd",
                 write_every: int = 1):
        if write_every <= 0:
            raise ValueError(
                f"write_every must be positive, got {write_every}")
        self.path = path
        self.prefix = _METRIC_CHARS.sub("_", prefix)
        self.write_every = write_every
        self._gauges: Dict[str, float] = {}
        self._counts: Dict[str, int] = {}
        self._counters: Dict[str, float] = {}
        self._cause_active: Dict[str, float] = {}
        self._since_write = 0
        self._lock = threading.Lock()
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)

    def emit(self, record: Mapping[str, Any]) -> None:
        event = record.get("event")
        if not isinstance(event, str):
            return
        ev = _METRIC_CHARS.sub("_", event)
        with self._lock:
            self._counts[ev] = self._counts.get(ev, 0) + 1
            for k, v in record.items():
                if k == "event":
                    continue
                if isinstance(v, bool):
                    v = int(v)
                if isinstance(v, (int, float)):
                    name = f"{self.prefix}_{ev}_{_METRIC_CHARS.sub('_', k)}"
                    self._gauges[name] = float(v)
            for k in self.COUNTER_FIELDS.get(event, ()):
                v = record.get(k)
                if isinstance(v, bool):
                    v = int(v)
                if isinstance(v, (int, float)):
                    name = (f"{self.prefix}_{ev}_"
                            f"{_METRIC_CHARS.sub('_', k)}_total")
                    self._counters[name] = (self._counters.get(name, 0.0)
                                            + float(v))
            if event == "health_status":
                code = record.get("state_code")
                if isinstance(code, (int, float)) \
                        and not isinstance(code, bool):
                    self._gauges[f"{self.prefix}_health_state"] = \
                        float(code)
                causes = record.get("causes")
                active = {_METRIC_CHARS.sub("_", c)
                          for c in (causes if isinstance(causes,
                                                         (list, tuple))
                                    else ())
                          if isinstance(c, str)}
                for c in active:
                    self._cause_active[c] = 1.0
                for c in self._cause_active:
                    if c not in active:
                        self._cause_active[c] = 0.0
            self._since_write += 1
            if self._since_write >= self.write_every:
                self._write_locked()

    def _write_locked(self) -> None:
        lines = ["# exported by gaussiank_sgd_torch.telemetry\n"]
        for ev in sorted(self._counts):
            lines.append(
                f'{self.prefix}_events_total{{event="{ev}"}} '
                f"{self._counts[ev]}\n")
        for name in sorted(self._counters):
            lines.append(f"{name} {self._counters[name]:.10g}\n")
        for cause in sorted(self._cause_active):
            lines.append(
                f'{self.prefix}_health_cause_active{{cause="{cause}"}} '
                f"{self._cause_active[cause]:.10g}\n")
        for name in sorted(self._gauges):
            lines.append(f"{name} {self._gauges[name]:.10g}\n")
        tmp = f"{self.path}.tmp.{os.getpid()}"
        # gklint: disable=conc-blocking-under-lock -- atomic tmp+rename snapshot of the locked registry; tiny textfile, rate-limited by _every
        with open(tmp, "w", encoding="utf-8") as fh:
            # gklint: disable=conc-blocking-under-lock -- same atomic snapshot write as the open() above
            fh.writelines(lines)
        os.replace(tmp, self.path)
        self._since_write = 0

    def flush(self) -> None:
        with self._lock:
            self._write_locked()

    def close(self) -> None:
        self.flush()
