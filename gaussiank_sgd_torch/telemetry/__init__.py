"""Run instrumentation of the port (port of
``gaussiank_sgd_tpu/telemetry/``): the event bus, its schema and
exporters, span tracing, the throughput/MFU tracker, run health, the
offline report, the bench history and the CLI (``python -m
gaussiank_sgd_torch.telemetry``), and the profiler window. Everything but
``profiler`` is pure Python and imports no torch."""

from .bus import EventBus
from .events import SCHEMA_VERSION, validate_record, validate_stream
from .exporters import (Exporter, JSONLExporter, MemoryExporter,
                        PrometheusTextfileExporter)
from .health import (HealthMonitor, HealthPolicy, HealthServer,
                     replay_health)
from .history import (HISTORY_SCHEMA, append_history, build_history_record,
                      load_history)
from .throughput import ThroughputSignals, ThroughputTracker
from .tracing import TraceContext, build_chrome_trace

__all__ = [
    "EventBus",
    "Exporter",
    "HISTORY_SCHEMA",
    "HealthMonitor",
    "HealthPolicy",
    "HealthServer",
    "JSONLExporter",
    "MemoryExporter",
    "PrometheusTextfileExporter",
    "SCHEMA_VERSION",
    "ThroughputSignals",
    "ThroughputTracker",
    "TraceContext",
    "append_history",
    "build_chrome_trace",
    "build_history_record",
    "load_history",
    "replay_health",
    "validate_record",
    "validate_stream",
]
