"""The event bus — one stamped, ordered stream for every runtime event (the
port's own copy of ``gaussiank_sgd_tpu/telemetry/bus.py``).

Every producer (the train loop, the data loader's prefetch thread, the
resilience runtime, the profiler) publishes a plain dict with an
``event`` discriminator; the bus stamps the envelope (schema_version,
monotonic seq, host timestamp) and fans the record out to every attached
exporter IN ORDER — so the per-exporter streams carry the same total
order the seq numbers promise, even with the prefetch thread publishing
io_retry events concurrently with the train loop.

Delivery discipline: exporters are NEVER invoked while the bus lock is
held. ``publish`` takes a seq ticket
under the lock, stamps/validates outside it, then passes a *delivery
turnstile*: a condition variable admits exactly the thread whose ticket
is next, that thread runs the exporter fan-out with no lock held, and
advancing the turnstile releases the next ticket. A slow exporter
therefore stalls *later deliveries* (the ordering contract demands that)
but never blocks seq assignment, ``attach``, or ``set_stamp`` — and an
exporter that re-enters the bus can no longer deadlock on the bus lock
(re-entrant *publish* remains forbidden: it would wait on its own
ticket). ``ts`` is stamped outside the lock, so across concurrent
publishers timestamps may be microscopically out of order; ``seq`` is
the total order.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable, Dict, Iterable, Mapping, Optional, Tuple

from .events import SCHEMA_VERSION, validate_record
from .exporters import Exporter


class EventBus:
    """Thread-safe publish/fan-out hub for telemetry records.

    ``validate=True`` schema-checks every record at publish time and
    raises on a violation — the fail-loud mode tests run under; trainers
    keep it off (a telemetry bug must not kill a training run that is
    otherwise healthy).

    ``clock`` is injectable for deterministic tests.
    """

    def __init__(self, exporters: Iterable[Exporter] = (),
                 validate: bool = False,
                 clock: Callable[[], float] = time.time):
        self._exporters = list(exporters)
        self._lock = threading.Lock()
        self._seq = 0
        self._validate = validate
        self._clock = clock
        self._closed = False
        self._stamp: Optional[Callable[[], Mapping[str, Any]]] = None
        # delivery turnstile: _delivered counts tickets whose exporter
        # fan-out has completed (or been retired); the condition admits
        # the publisher holding the next ticket
        self._delivery = threading.Condition(threading.Lock())
        self._delivered = 0

    def set_stamp(self, fn: Optional[Callable[[], Mapping[str, Any]]]) -> None:
        """Install (or clear, with None) a per-record stamp hook.

        ``fn()`` is called once per publish — outside the bus lock, on
        the publishing thread — and its fields are merged via
        ``setdefault``: a producer that already set a field wins. With no
        hook installed (the default) the stream is byte-identical to a
        bus without this feature; tracing uses it to stamp
        ``trace_id``/``span_id`` without touching any producer call site.
        """
        with self._lock:
            self._stamp = fn

    def add_stamp(self, fn: Callable[[], Mapping[str, Any]]) -> None:
        """Compose ``fn`` with the installed stamp hook.

        ``set_stamp`` is a single slot (tracing owns it in traced runs);
        a second stamper — the pod launcher marking every record with its
        ``process_index`` — must compose, not clobber. Fields of the
        earlier hook win on a key collision. A later ``set_stamp`` still
        replaces the whole composition (tracing's ``uninstall`` clears it
        at close, when no record follows).
        """
        with self._lock:
            prev = self._stamp
        if prev is None:
            self.set_stamp(fn)
        else:
            self.set_stamp(lambda: {**fn(), **prev()})

    def attach(self, exporter: Exporter) -> Exporter:
        with self._lock:
            self._exporters.append(exporter)
        return exporter

    @property
    def seq(self) -> int:
        """Next sequence number to be assigned (== records published)."""
        with self._lock:
            return self._seq

    def emit(self, event: str, /, **fields: Any) -> Dict[str, Any]:
        """Publish ``{"event": event, **fields}``; returns the stamped
        record."""
        return self.publish({"event": event, **fields})

    def publish(self, record: Mapping[str, Any]) -> Dict[str, Any]:
        """Stamp the envelope onto a copy of ``record`` and hand it to
        every exporter. The caller's dict is never mutated. Also usable
        directly as a ``Callable[[dict], None]`` sink (data/loader.py's
        ``on_event``)."""
        if "event" not in record:
            raise ValueError(
                f"telemetry record needs an 'event' field: {record!r:.120}")
        rec = dict(record)
        with self._lock:
            if self._closed:
                raise ValueError("EventBus is closed")
            ticket = self._seq
            self._seq += 1
            stamp = self._stamp
            exporters = tuple(self._exporters)
        rec.setdefault("schema_version", SCHEMA_VERSION)
        rec["seq"] = ticket
        rec.setdefault("ts", round(self._clock(), 6))
        try:
            if stamp is not None:
                for k, v in stamp().items():
                    rec.setdefault(k, v)
            if self._validate:
                errors = validate_record(rec, strict=True)
                if errors:
                    raise ValueError(
                        "invalid telemetry record: " + "; ".join(errors))
        except BaseException:
            # the ticket is already issued: retire it (empty delivery) so
            # later publishers don't wait forever — the stream keeps the
            # seq gap, exactly like the pre-turnstile validate-then-raise
            self._deliver(ticket, None, ())
            raise
        self._deliver(ticket, rec, exporters)
        return rec

    def _deliver(self, ticket: int, rec: Optional[Dict[str, Any]],
                 exporters: Tuple[Exporter, ...]) -> None:
        """Pass the turnstile: wait until ``ticket`` is next, fan out with
        NO lock held (ticket exclusivity serializes exporter calls), then
        advance. ``rec=None`` retires a ticket without delivering."""
        with self._delivery:
            while self._delivered != ticket:
                self._delivery.wait()
        try:
            if rec is not None:
                for ex in exporters:
                    ex.emit(rec)
        finally:
            with self._delivery:
                self._delivered = ticket + 1
                self._delivery.notify_all()

    def _drain_to(self, target: int) -> None:
        """Block until every ticket below ``target`` has been delivered."""
        with self._delivery:
            while self._delivered < target:
                self._delivery.wait()

    def close(self) -> None:
        """Refuse new publishes, drain in-flight deliveries, close the
        exporters. Idempotent."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
            target = self._seq
            exporters = tuple(self._exporters)
        self._drain_to(target)
        for ex in exporters:
            ex.close()
