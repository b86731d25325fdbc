"""Run instrumentation of the port (port of
``gaussiank_sgd_tpu/telemetry/``): the event bus, its schema and
exporters, span tracing, the throughput/MFU tracker and the profiler
window. Everything but ``profiler`` is pure Python."""

from .bus import EventBus
from .events import SCHEMA_VERSION, validate_record, validate_stream
from .exporters import (Exporter, JSONLExporter, MemoryExporter,
                        PrometheusTextfileExporter)
from .tracing import TraceContext, build_chrome_trace

__all__ = [
    "EventBus",
    "Exporter",
    "JSONLExporter",
    "MemoryExporter",
    "PrometheusTextfileExporter",
    "SCHEMA_VERSION",
    "TraceContext",
    "build_chrome_trace",
    "validate_record",
    "validate_stream",
]
