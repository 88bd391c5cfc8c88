"""Observability: trace attribution (profiler phase scopes,
:mod:`phases`), the run-health accumulator (:mod:`telemetry`), the
schema-versioned metrics export (:mod:`export`), distributed tracing
(:mod:`trace`, stdlib-only) and the live metrics hub, jsonl tailers and
SLO engine (:mod:`live`, stdlib-only)."""
