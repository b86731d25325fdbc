"""Run instrumentation of the port (a trimmed port of
``gaussiank_sgd_tpu/telemetry/``)."""
