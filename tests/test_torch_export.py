"""PyTorch port vs the JAX package: the metrics export (``obs.export``).

The port writes the JAX package's schema: every file its
``MetricsWriter`` writes (the recovery tier's events, a telemetry block,
a rollout summary) passes the JAX ``validate_file``, and the two
validators report the same errors on the same bad lines.
``logs_summary`` of the port's time-first ``(T, S, ...)`` logs equals the
JAX ``logs_summary`` of the same logs scenario-first ``(S, T, ...)``,
exactly (the same numpy reductions on the same values), the per-scenario
final quarantine count with one scenario quarantined included.
"""

import json
import types

import numpy as np
import pytest
from test_torch_recovery import HL_REL, RES_C, RES_T, _resilient_batch

from tpu_aerial_transport.obs import export as jexport
from tpu_aerial_transport_torch.obs import export, telemetry
from tpu_aerial_transport_torch.resilience import (
    make_chunked_resilient_rollout,
    recovery,
)


def _quarantined_logs():
    """The resilient batch's logs (scenario 1 quarantined from step 3)
    and the final carry, with telemetry."""
    tp, hl, ll, sched, acc, states, css = _resilient_batch()
    run = make_chunked_resilient_rollout(
        hl, ll.control, tp, n_hl_steps=RES_T, n_chunks=RES_C,
        hl_rel_freq=HL_REL, acc_des_fn=acc, faults=sched,
        telemetry=telemetry.TelemetryConfig())
    return run, states, css


def _scenario_first(logs):
    return types.SimpleNamespace(**{
        k: np.swapaxes(v.numpy(), 0, 1) for k, v in vars(logs).items()})


def test_logs_summary_matches_jax_on_scenario_first_logs():
    """The port's digest of ``(T, S, ...)`` logs is the JAX package's of
    the same ``(S, T, ...)`` logs; ``quarantined_final`` counts the one
    quarantined scenario once, where reading the port's time-first logs
    the JAX way would count its quarantined steps."""
    run, states, css = _quarantined_logs()
    _, _, logs = run(states, css)
    got = export.logs_summary(logs)
    ref = jexport.logs_summary(_scenario_first(logs))
    assert got == ref
    assert got["quarantined_final"] == 1
    assert got["steps"] == logs.xl.shape[0] * logs.xl.shape[1]
    assert sum(got["rung_hist"]) == got["steps"]
    # The trap: time-first logs read as scenario-first count steps.
    assert jexport.logs_summary(logs)["quarantined_final"] == int(
        logs.quarantined.any(dim=1).sum()) > 1
    # A chunk's logs alike.
    one = type(logs)(**{k: v[:2] for k, v in vars(logs).items()})
    assert export.logs_summary(one) == jexport.logs_summary(
        _scenario_first(one))


def test_port_metrics_files_validate_under_jax(tmp_path):
    """A chunked run's metrics (``run_start``, a ``chunk`` event a
    boundary with the telemetry summary and the logs digest,
    ``preempted``, ``resume``, ``done``) and a ``rollout_summary`` pass the
    JAX ``validate_file``; the chunk events' telemetry block is the port's
    ``telemetry.summary`` of the carry's accumulator."""
    run, states, css = _quarantined_logs()
    path = str(tmp_path / "run.metrics.jsonl")
    d = tmp_path / "run"
    interrupt = recovery.GracefulInterrupt()

    def preempting(carry, i0):
        out = run.chunk_jit(carry, i0)
        interrupt.triggered = "SIGTERM"
        return out

    plan = recovery.RunPlan(run_dir=str(d), n_hl_steps=RES_T,
                            n_chunks=RES_C)
    recovery.run_chunks(plan, preempting, run.init_carry(states, css),
                        interrupt=interrupt, metrics=path)
    res = recovery.resume_run(str(d), run.chunk_jit,
                              run.init_carry(states, css), metrics=path)
    _, _, logs = run(states, css)
    rec = export.rollout_metrics(path, logs, res.carry[4],
                                 meta={"scenarios": 3})
    assert jexport.validate_file(path) == []
    assert export.validate_file(path) == []
    events = export.read_events(path)
    assert [e["event"] for e in events] == (
        ["run_start", "chunk", "preempted", "resume"]
        + ["chunk"] * (RES_C - 1) + ["done", "rollout_summary"])
    last = [e for e in events if e["event"] == "chunk"][-1]
    assert last["telemetry"] == telemetry.summary(res.carry[4])
    assert last["telemetry"]["lanes"] == 3
    assert rec["logs"]["quarantined_final"] == 1
    assert export.telemetry_event(None) is None


def test_validators_agree_on_bad_lines(tmp_path):
    """The same errors from both validators: an unknown event, a missing
    field, an unknown kind, an event older than its schema, a torn
    interior line; a torn final line is tolerated by both."""
    good = {"schema": export.SCHEMA_VERSION, "event": "chunk", "chunk": 0,
            "wall_s": 0.1, "ts": 1.0}
    bad = [
        {"schema": 9, "event": "nope", "ts": 1.0},
        {"schema": 9, "event": "chunk", "ts": 1.0},
        {"schema": 9, "event": "serving_event", "kind": "zzz", "ts": 1.0},
        {"schema": 1, "event": "trace_event", "name": "x", "ts": 1.0},
        {"schema": 42, "event": "done", "chunks": 1},
    ]
    path = tmp_path / "m.jsonl"
    lines = [json.dumps(good)] + [json.dumps(b) for b in bad]
    path.write_text("\n".join(lines[:2]) + '\n{"torn\n'
                    + "\n".join(lines[2:]) + '\n{"torn tail')
    assert export.validate_file(str(path)) == jexport.validate_file(
        str(path))
    assert len(export.validate_file(str(path))) >= len(bad) + 1
    for b in bad:
        assert export.validate_event(b) == jexport.validate_event(b)
    assert export.EVENT_FIELDS == jexport.EVENT_FIELDS
    assert export.EVENT_KIND_TABLES == jexport.EVENT_KIND_TABLES
    assert (export.SCHEMA_VERSION, export.SUPPORTED_SCHEMAS) == (
        jexport.SCHEMA_VERSION, jexport.SUPPORTED_SCHEMAS)
    assert export.read_events(str(path)) == jexport.read_events(str(path))
    with pytest.raises(ValueError, match="unknown metrics event type"):
        export.MetricsWriter(str(tmp_path / "x.jsonl")).emit("nope")


def test_journal_and_metrics_share_the_durable_append(tmp_path):
    """``RunJournal`` appends through ``jsonl_append`` and reads through
    ``jsonl_read``: one line an event, the torn tail skipped."""
    j = recovery.RunJournal(str(tmp_path))
    j.append({"event": "run_start", "n_hl_steps": 2, "n_chunks": 1})
    with open(j.path, "a") as fh:
        fh.write('{"event": "chunk"')
    assert export.jsonl_read(j.path) == [
        {"event": "run_start", "n_hl_steps": 2, "n_chunks": 1}]
    assert jexport.jsonl_read(j.path) == export.jsonl_read(j.path)
