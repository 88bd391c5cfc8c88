"""Host-side metrics export: the one schema-versioned jsonl event writer.

Counterpart of the JAX package's ``obs/export.py``, with its schema
version, event vocabulary and kind tables, so the files each package
writes validate under the other's :func:`validate_file`. Chunk-boundary
events from ``resilience.recovery.run_chunks`` (wall time, the chunk
carry's telemetry accumulator, a per-chunk log digest) and on-demand
:func:`rollout_metrics` summaries of a rollout's logs go through
:class:`MetricsWriter`.

Line format: one JSON object per line, append-only, fsync'd per event
(the durability contract of ``resilience.recovery.RunJournal``; a torn
final line from a crash mid-append is tolerated by readers). Every event
carries ``schema`` (:data:`SCHEMA_VERSION`), ``event`` (type tag) and
``ts`` (host unix time).

The port's logs are time-first, ``(T, S, ...)``: :func:`logs_summary`
reduces the sticky quarantine flag over axis 0, one flag a scenario.
"""

from __future__ import annotations

import json
import os
import time

import numpy as np
import torch

from tpu_aerial_transport_torch.obs import telemetry as telemetry_mod

# The JAX package's schema history, which the port reads and writes as it
# stands: v2 added ``backend_event`` (the backend guard), v3 ``aot_serve``,
# v4 ``serving_event``, v5 ``trace_event`` (``obs.trace`` span rows), v6
# ``fleet_event``, v7 the ``cache_hit`` serving kind, v8 ``session_event``
# and the ``autoscale`` fleet kind, v9 ``alert``. Files written at older
# versions remain valid (:data:`SUPPORTED_SCHEMAS`): each bump only adds
# vocabulary. The port emits the recovery tier's events and
# ``trace_event``; the serving, fleet, session and alert vocabularies
# are kept so its validator accepts every file the JAX package writes.
SCHEMA_VERSION = 9
SUPPORTED_SCHEMAS = frozenset({1, 2, 3, 4, 5, 6, 7, 8, 9})

# Event vocabulary -> required fields (beyond schema/event/ts). The
# validator rejects unknown event types and missing fields; extra fields
# are allowed (forward compatibility within a schema version).
EVENT_FIELDS: dict[str, tuple[str, ...]] = {
    "run_start": (),
    "chunk": ("chunk", "wall_s"),
    "retry": ("chunk", "attempt", "error"),
    "resume": ("start_chunk",),
    "preempted": ("chunk",),
    "done": ("chunks",),
    "bench_cell": ("cell", "value"),
    "rollout_summary": ("logs",),
    "backend_event": ("kind", "label"),
    "aot_serve": ("entry", "rung"),
    # Per-kind minimums live in the *_EVENT_KINDS tables below.
    "serving_event": ("kind",),
    # One finished span (obs.trace.Span.to_row()): t1_* present for
    # spans, absent for instants; parent_id/attrs optional; track is the
    # per-process timeline the stitcher groups by.
    "trace_event": ("name", "trace_id", "span_id", "track",
                    "t0_mono", "t0_wall"),
    "fleet_event": ("kind",),
    "session_event": ("kind",),
    "alert": ("kind",),
}

# The kinded events' vocabularies: kind -> minimum extra keys beyond the
# event-level required fields, enforced by :func:`validate_event`.
SERVING_EVENT_KINDS: dict[str, tuple[str, ...]] = {
    "submitted": ("request_id",),
    "rejected": ("request_id", "reason"),
    "admitted": ("request_id",),
    "cache_hit": ("request_id",),
    "completed": ("request_id",),
    "deadline_missed": ("request_id",),
    "batch_launch": ("batch_id",),
    "batch_boundary": ("batch_id",),
    "preempted": (),
    "resumed": (),
}
FLEET_EVENT_KINDS: dict[str, tuple[str, ...]] = {
    "heartbeat": ("replica",),
    "transition": ("replica",),
    "replica_error": ("replica",),
    "restart": ("replica",),
    "quarantine": ("replica",),
    "failover": ("request_id",),
    "tenant_rejected": ("tenant",),
    "duplicate_result": ("request_id",),
    "autoscale": ("hint",),
}
SESSION_EVENT_KINDS: dict[str, tuple[str, ...]] = {
    "opened": ("session_id", "lease"),
    "renewed": ("session_id", "gap_s"),
    "evicted": ("session_id", "lease"),
    "fenced": ("session_id",),
    "stale_step": ("session_id", "step_seq"),
    "step_submitted": ("session_id", "step_seq", "request_id"),
    "step_done": ("session_id", "step_seq", "rung"),
    "step_degraded": ("session_id", "step_seq", "rung", "missed"),
    "session_closed": ("session_id",),
    "sessions_resumed": ("live",),
    "rehomed": ("session_id", "to_replica"),
}
ALERT_EVENT_KINDS: dict[str, tuple[str, ...]] = {
    "fire": ("slo", "severity", "burn_rate", "window_s"),
    "resolve": ("slo", "fired_ts"),
}

# Which kind table governs each kinded event type (disjoint vocabularies:
# a fleet kind on a serving_event is drift, not forward compatibility).
EVENT_KIND_TABLES: dict[str, dict[str, tuple[str, ...]]] = {
    "serving_event": SERVING_EVENT_KINDS,
    "fleet_event": FLEET_EVENT_KINDS,
    "session_event": SESSION_EVENT_KINDS,
    "alert": ALERT_EVENT_KINDS,
}

# Events that did not exist before a given schema version: an event of
# this type stamped with an older schema is a violation.
EVENT_MIN_SCHEMA: dict[str, int] = {
    "backend_event": 2,
    "aot_serve": 3,
    "serving_event": 4,
    "trace_event": 5,
    "fleet_event": 6,
    "session_event": 8,
    "alert": 9,
}


def jsonl_append(path: str, obj: dict) -> None:
    """THE durable jsonl append (flush + fsync before returning): shared
    by :class:`MetricsWriter` and ``resilience.recovery.RunJournal`` so
    the durability contract lives in exactly one place."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "a", encoding="utf-8") as fh:
        fh.write(json.dumps(obj) + "\n")
        fh.flush()
        os.fsync(fh.fileno())


def jsonl_read(path: str) -> list[dict]:
    """All parseable lines; unparseable lines (the torn tail a crash
    mid-append leaves) are skipped — :func:`validate_file` surfaces torn
    INTERIOR lines as errors."""
    out = []
    with open(path, encoding="utf-8") as fh:
        for line in fh:
            try:
                out.append(json.loads(line))
            except ValueError:
                continue
    return out


class MetricsWriter:
    """Append-only jsonl metrics writer (one per run/sweep)."""

    def __init__(self, path: str, meta: dict | None = None):
        self.path = path
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        if meta is not None:
            self.emit("run_start", **meta)

    def emit(self, event: str, **fields) -> dict:
        if event not in EVENT_FIELDS:
            raise ValueError(
                f"unknown metrics event type {event!r} (known: "
                f"{sorted(EVENT_FIELDS)}); extend EVENT_FIELDS and bump "
                "SCHEMA_VERSION if readers must distinguish the new shape"
            )
        record = {"schema": SCHEMA_VERSION, "event": event,
                  "ts": time.time(), **fields}
        jsonl_append(self.path, record)
        return record


def read_events(path: str) -> list[dict]:
    """All parseable events (see :func:`jsonl_read`)."""
    return jsonl_read(path)


def validate_event(obj, lineno: int = 0) -> list[str]:
    """Schema errors for one decoded event (empty list = valid)."""
    where = f"line {lineno}: " if lineno else ""
    if not isinstance(obj, dict):
        return [f"{where}event is not a JSON object"]
    errs = []
    schema = obj.get("schema")
    if schema not in SUPPORTED_SCHEMAS:
        errs.append(
            f"{where}schema {schema!r} not in supported "
            f"{sorted(SUPPORTED_SCHEMAS)}"
        )
    event = obj.get("event")
    if event not in EVENT_FIELDS:
        errs.append(
            f"{where}unknown event type {event!r} "
            f"(known: {sorted(EVENT_FIELDS)})"
        )
    elif (schema in SUPPORTED_SCHEMAS
          and schema < EVENT_MIN_SCHEMA.get(event, 0)):
        errs.append(
            f"{where}event {event!r} requires schema >= "
            f"{EVENT_MIN_SCHEMA[event]}, got {schema}"
        )
    else:
        missing = [k for k in EVENT_FIELDS[event] if k not in obj]
        if missing:
            errs.append(f"{where}event {event!r} missing fields {missing}")
        kinds = EVENT_KIND_TABLES.get(event)
        kind = obj.get("kind")
        if kinds is not None and "kind" in obj:
            if kind not in kinds:
                errs.append(
                    f"{where}event {event!r} has unknown kind {kind!r} "
                    f"(known: {sorted(kinds)})"
                )
            else:
                kmissing = [k for k in kinds[kind] if k not in obj]
                if kmissing:
                    errs.append(
                        f"{where}event {event!r} kind {kind!r} missing "
                        f"keys {kmissing}"
                    )
    if not isinstance(obj.get("ts"), (int, float)):
        errs.append(f"{where}missing/non-numeric ts")
    return errs


def validate_file(path: str) -> list[str]:
    """Schema-validate a metrics jsonl. A torn FINAL line is tolerated
    (the state a crash mid-append leaves); torn interior lines and any
    schema violation are errors."""
    errs: list[str] = []
    with open(path, encoding="utf-8") as fh:
        lines = fh.readlines()
    for i, line in enumerate(lines, start=1):
        if not line.strip():
            continue
        try:
            obj = json.loads(line)
        except ValueError:
            if i == len(lines):
                continue  # torn tail from a crash — readers skip it.
            errs.append(f"line {i}: unparseable JSON")
            continue
        errs.extend(validate_event(obj, i))
    return errs


def telemetry_event(tel, cfg=None) -> dict | None:
    """JSON-ready telemetry block from a :class:`TelemetryState` (tensors
    on any device, or a host copy); None when ``tel`` is None."""
    if tel is None:
        return None
    return telemetry_mod.summary(tel, cfg)


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def logs_summary(logs, quantiles=(0.5, 0.9, 0.99)) -> dict:
    """Exact (non-streaming) digest of a rollout's ``RQPLogStep`` logs,
    ``(T, S, ...)`` (a chunk's logs alike): every leaf flattened, but for
    the quarantine flag, one a scenario (:func:`_final_quarantine`)."""
    rung = _host(logs.fallback_rung).reshape(-1)
    res = _host(logs.solve_res).reshape(-1).astype(np.float64)
    res = res[np.isfinite(res)]
    # The consensus-iteration digest; the centralized controller reports
    # -1 and is left out.
    it = _host(logs.iters).reshape(-1)
    it = it[it >= 0]
    out = {
        "steps": int(rung.size),
        "rung_hist": [
            int(v) for v in np.bincount(
                np.clip(rung, 0, telemetry_mod.N_RUNGS - 1),
                minlength=telemetry_mod.N_RUNGS,
            )
        ],
        "min_env_dist": float(np.min(_host(logs.min_env_dist))),
        "collision_steps": int(np.sum(_host(logs.collision))),
        "quarantined_final": int(np.sum(_final_quarantine(logs))),
        "residual": {
            "count": int(res.size),
            "min": float(res.min()) if res.size else None,
            "max": float(res.max()) if res.size else None,
            "mean": float(res.mean()) if res.size else None,
            **{
                "p%g" % (p * 100): (
                    float(np.percentile(res, p * 100)) if res.size else None
                )
                for p in quantiles
            },
        },
        "consensus_iters": {
            "count": int(it.size),
            "mean": float(it.mean()) if it.size else None,
            "p99": float(np.percentile(it, 99)) if it.size else None,
            "max": int(it.max()) if it.size else None,
        },
    }
    return out


def _final_quarantine(logs) -> np.ndarray:
    """Per-scenario final quarantine flags. The port's logs are
    ``(T, S, ...)``, so time is axis 0; the flag is sticky, so the max
    over time is the final value (the JAX package's logs put the scenario
    axis first and reduce over the axes after it instead)."""
    q = _host(logs.quarantined)
    if q.ndim <= 1:
        q = q.reshape(-1, 1)
    return q.reshape(q.shape[0], -1).max(axis=0)


def rollout_metrics(
    path: str,
    logs,
    tel=None,
    cfg=None,
    meta: dict | None = None,
) -> dict:
    """On-demand export: write a ``rollout_summary`` event for a finished
    rollout's logs (plus its telemetry accumulator when one was threaded)
    and return the emitted record."""
    writer = MetricsWriter(path)
    return writer.emit(
        "rollout_summary",
        logs=logs_summary(logs),
        telemetry=telemetry_event(tel, cfg),
        **({"meta": meta} if meta else {}),
    )
