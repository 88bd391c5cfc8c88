"""Observability: trace attribution (profiler phase scopes,
:mod:`phases`), the run-health accumulator (:mod:`telemetry`), the
schema-versioned metrics export (:mod:`export`) and distributed tracing
(:mod:`trace`, stdlib-only)."""
