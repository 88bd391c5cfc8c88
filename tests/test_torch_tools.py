"""PyTorch port vs the JAX package: the operator's tools.

``trace_view``, ``run_health``, ``op_profile``, ``profile_dd64`` and
``probe_chip`` of the port against the JAX package's tools (loaded by file
path under names of their own), on the same port-written files: the same
stitched Chrome JSON, critical path and ``--validate`` codes; the same
run-health summary, rendered text, ``--json`` and ``--validate`` over
every row kind the port writes; the same phase rollup; the same keys and
differencing arithmetic. Everything runs in this process, on the CPU.
"""

import ast
import contextlib
import importlib.util
import io
import json
import os
import sys

import pytest
import torch
from test_torch_live import BASE, _stream
from test_torch_recovery import _central, _plan, _runner

from tpu_aerial_transport_torch.aot import loader
from tpu_aerial_transport_torch.harness import checkpoint
from tpu_aerial_transport_torch.obs import export, live, phases, trace
from tpu_aerial_transport_torch.ops import _build
from tpu_aerial_transport_torch.resilience import backend, recovery
from tpu_aerial_transport_torch.tools import (op_profile, probe_chip,
                                              profile_dd64, run_health,
                                              trace_view)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOOLS = os.path.join(REPO, "tools")


def _load(name: str):
    """A JAX tool loaded by path as ``_jax_<name>``."""
    key = "_jax_" + name
    if key not in sys.modules:
        spec = importlib.util.spec_from_file_location(
            key, os.path.join(TOOLS, name + ".py"))
        mod = importlib.util.module_from_spec(spec)
        sys.modules[key] = mod
        spec.loader.exec_module(mod)
    return sys.modules[key]


def _jax_main(mod, argv, monkeypatch):
    """A JAX tool's ``main()`` (it reads ``sys.argv``) as an exit code."""
    monkeypatch.setattr(sys, "argv", [mod.__name__] + list(argv))
    try:
        rc = mod.main()
    except SystemExit as e:
        return e.code
    return 0 if rc is None else rc


# ------------------------------ trace_view ------------------------------

def _spans(tracer, rid):
    """A request's serving spans and a chunk driver's spans."""
    req = tracer.begin(trace.REQUEST, request_id=rid)
    tracer.end(tracer.begin(trace.QUEUE_WAIT, parent=req))
    lanes = [[0, rid, req.trace_id]]
    with tracer.span(trace.BATCH_FORM, batch_id="b0"):
        with tracer.span(trace.CHUNK_DISPATCH, lanes=lanes):
            tracer.instant(trace.RETRY, chunk=0, attempt=1)
        with tracer.span(trace.HARVEST, lanes=lanes):
            pass
    tracer.end(req, status="completed")
    run = tracer.begin(trace.RUN, parent=None, n_chunks=1)
    tracer.end(tracer.begin(trace.CHUNK, parent=run, chunk=0))
    tracer.end(run, status="done")


@pytest.fixture(scope="module")
def trace_sources(tmp_path_factory):
    """One jsonl of spans, and a pods-style run directory: two process
    tracks and the shard manifest naming both."""
    root = tmp_path_factory.mktemp("traces")
    jsonl = str(root / "server.metrics.jsonl")
    _spans(trace.Tracer(export.MetricsWriter(jsonl), track="server"), "r")
    pods = root / "pods"
    checkpoint.save_shard_manifest(str(pods), prefix="carry", n_processes=2)
    for pid in range(2):
        track = f"p{pid}of2"
        _spans(trace.Tracer(export.MetricsWriter(
            str(pods / f"trace.{track}.metrics.jsonl")), track=track),
            f"r{pid}")
    return root, jsonl, str(pods)


def _run(fn, *args):
    """``(fn(*args), stdout)``."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = fn(*args)
    return rc, buf.getvalue()


def test_trace_view_equals_jax(trace_sources, monkeypatch, capsys):
    """The same rows through both viewers: equal Chrome JSON, equal
    critical path, and equal summaries."""
    jtv = _load("trace_view")
    root, jsonl, pods = trace_sources
    out = {}
    for name, mod in (("jax", jtv), ("port", trace_view)):
        path = str(root / f"{name}.trace.json")
        argv = [jsonl, pods, "--out", path, "--critical-path"]
        rc = (_jax_main(mod, argv, monkeypatch) if name == "jax"
              else trace_view.main(argv))
        summary = json.loads(capsys.readouterr().out)
        with open(path) as fh:
            out[name] = (rc, json.load(fh), summary)
    assert out["port"][0] == out["jax"][0] == 0
    assert out["port"][1] == out["jax"][1]
    jsum, psum = out["jax"][2], out["port"][2]
    assert {k: v for k, v in psum.items() if k != "out"} == \
        {k: v for k, v in jsum.items() if k != "out"}
    assert psum["tracks"] == ["p0of2", "p1of2", "server"]
    assert psum["critical_path"]["completed"] == 3
    assert out["port"][1]["traceEvents"]


def _broken(path, kind):
    """A Chrome trace with overlapping slices on one track, or a span whose
    parent is missing."""
    ev = [{"ph": "X", "name": "a", "pid": 1, "tid": 1, "ts": 0.0,
           "dur": 10.0, "args": {"span_id": "s1"}}]
    if kind == "overlap":
        ev.append({"ph": "X", "name": "b", "pid": 1, "tid": 1, "ts": 5.0,
                   "dur": 10.0, "args": {"span_id": "s2"}})
    else:
        ev.append({"ph": "X", "name": "b", "pid": 1, "tid": 2, "ts": 1.0,
                   "dur": 1.0, "args": {"span_id": "s2",
                                        "parent_id": "gone"}})
    with open(path, "w") as fh:
        json.dump({"traceEvents": ev}, fh)


@pytest.mark.parametrize("kind", ["good", "overlap", "missing_parent"])
def test_trace_view_validate_equals_jax(trace_sources, kind, monkeypatch,
                                        capsys):
    jtv = _load("trace_view")
    root, jsonl, pods = trace_sources
    path = str(root / f"{kind}.trace.json")
    if kind == "good":
        trace_view.main([jsonl, pods, "--out", path])
    else:
        _broken(path, kind)
    capsys.readouterr()
    j_rc = _jax_main(jtv, ["--validate", path], monkeypatch)
    j_out = capsys.readouterr()
    p_rc = trace_view.main(["--validate", path])
    p_out = capsys.readouterr()
    assert p_rc == j_rc == (0 if kind == "good" else 1)
    assert (p_out.out, p_out.err) == (j_out.out, j_out.err)


def test_trace_view_run_imports_neither_torch_nor_jax(trace_sources,
                                                      monkeypatch, tmp_path):
    """Loaded by path and run with torch, jax and the port's package made
    unimportable: the viewer needs none of them."""
    root, jsonl, pods = trace_sources
    for name in ("torch", "jax", "jaxlib", "tpu_aerial_transport_torch",
                 "tpu_aerial_transport"):
        monkeypatch.setitem(sys.modules, name, None)
    monkeypatch.delitem(sys.modules, "tat_torch_obs_trace", raising=False)
    spec = importlib.util.spec_from_file_location(
        "_trace_view_by_path", trace_view.__file__)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    out = str(tmp_path / "t.json")
    rc, _ = _run(mod.main, [jsonl, pods, "--out", out])
    assert rc == 0
    assert _run(mod.main, ["--validate", out])[0] == 0
    assert mod.trace_mod.__file__.endswith(os.path.join("obs", "trace.py"))
    with open(trace_view.__file__) as fh:
        tree = ast.parse(fh.read())
    imported = {a.name.split(".")[0] for n in ast.walk(tree)
                if isinstance(n, ast.Import) for a in n.names}
    imported |= {n.module.split(".")[0] for n in ast.walk(tree)
                 if isinstance(n, ast.ImportFrom) and n.module}
    assert not imported & {"torch", "jax", "numpy",
                           "tpu_aerial_transport_torch"}


# ------------------------------ run_health ------------------------------

@pytest.fixture(scope="module")
def health_file(tmp_path_factory):
    """One port-written metrics file holding every row kind the port
    writes: a chunked run retried, preempted and resumed with its spans
    (the recovery tier's emitters), the backend guard's events, AOT serve
    rows (the loader's emitter, one of them after an nvcc build), an SLO
    engine's alert trail, and serving, session, fleet and pods rows
    (``MetricsWriter.emit``), with traced requests for the critical
    path."""
    root = tmp_path_factory.mktemp("health")
    path = str(root / "run.metrics.jsonl")
    writer = export.MetricsWriter(path)
    tracer = trace.Tracer(writer, track="p0of1")
    p = _central()
    runner = _runner(p)
    interrupt = recovery.GracefulInterrupt()
    calls = []

    def flaky(carry, i0):
        calls.append(i0)
        if len(calls) == 1:
            raise RuntimeError("transient error")
        out = runner.chunk_jit(carry, i0)
        interrupt.triggered = "SIGTERM"
        return out

    run_dir = root / "run"
    recovery.run_chunks(_plan(run_dir), flaky,
                        runner.init_carry(p.states, p.css),
                        interrupt=interrupt, max_retries=1, metrics=writer,
                        tracer=tracer)
    recovery.resume_run(str(run_dir), runner.chunk_jit,
                        runner.init_carry(p.states, p.css), metrics=writer,
                        tracer=tracer)
    guard = backend.BackendGuard(metrics=writer)
    guard.emit("device_crash", "chunk 3", rung="on-chip",
               detail="CUDA error: an illegal memory access")
    guard.emit("circuit_open", "chunk 3", reason="3 failures")
    guard.emit("topology_mismatch", "pods",
               detail="visible 1 of 2 processes on cuda")
    x = torch.zeros(2)
    loader.serve_entry(None, "serving.batcher:serving_chunk", (x,),
                       jit_fallback=lambda t: t + 1, metrics=writer)
    real_builds = _build.nvcc_builds
    _build.nvcc_builds = lambda: 1
    try:
        loader.serve_entry(None, "serving.batcher:serving_chunk", (x,),
                           jit_fallback=lambda t: t + 1, metrics=writer)
    finally:
        _build.nvcc_builds = real_builds
    writer.emit("aot_serve", entry="control.cadmm:control",
                rung="bundle_exec", label="b", wall_s=0.01)
    engine = live.SLOEngine(tuple(live.DEFAULT_SLOS) + (live.SLOSpec(
        name="misses", metric="deadline_miss", objective=0.99,
        fast_window_s=60, slow_window_s=300),), metrics=writer,
        burn_rates=(14.4, 6.0))
    events = _stream(0)
    k = 0
    for minute in range(1, 16):
        end = BASE + 60 * minute
        while k < len(events) and events[k]["ts"] < end:
            engine.ingest(f"r{k % 2}", events[k])
            k += 1
        engine.evaluate(now=end)
    for i in range(3):
        rid = f"req{i}"
        writer.emit("serving_event", kind="submitted", request_id=rid,
                    family="cadmm4", tenant="pro")
        writer.emit("serving_event", kind="batch_launch", batch_id="b0",
                    family="cadmm4", bucket=8)
        writer.emit("serving_event", kind="batch_boundary", batch_id="b0",
                    chunk=i, family="cadmm4", occupancy=0.5, rung="on-chip")
        writer.emit("serving_event", kind="completed", request_id=rid,
                    family="cadmm4", tenant="pro",
                    slo={"latency_s": 0.1 * (i + 1),
                         "admit_to_complete_s": 0.05 * (i + 1)})
    writer.emit("serving_event", kind="rejected", request_id="req9",
                reason="queue_full", tenant="free")
    writer.emit("serving_event", kind="cache_hit", request_id="req8",
                tenant="pro")
    writer.emit("fleet_event", kind="heartbeat", replica=0, seq=1, pid=1)
    writer.emit("fleet_event", kind="transition", replica=1,
                from_state="up", to_state="down", reason="exited", seq=2)
    writer.emit("fleet_event", kind="restart", replica=1, attempt=1)
    writer.emit("fleet_event", kind="failover", request_id="req1",
                from_replica="1", to_replica="0", trace_id="t1",
                latency_s=0.5)
    writer.emit("fleet_event", kind="tenant_rejected", tenant="free",
                request_id="req7", reason="tenant_rate_limited")
    writer.emit("fleet_event", kind="autoscale", hint="scale_up",
                queue_depth=20, sessions=4)
    writer.emit("session_event", kind="opened", session_id="c0",
                lease="c0:l0", family="cadmm4", epoch=0, reconnect=False)
    writer.emit("session_event", kind="renewed", session_id="c0", gap_s=0.2)
    writer.emit("session_event", kind="step_done", session_id="c0",
                step_seq=1, rung="served", request_id="c0.s1",
                slo={"latency_s": 0.01})
    writer.emit("session_event", kind="step_degraded", session_id="c0",
                step_seq=2, rung="hold_last", missed="in_flight",
                request_id="c0.s2")
    writer.emit("session_event", kind="evicted", session_id="c0",
                lease="c0:l0", gap_s=31.0, step_seq=2)
    writer.emit("session_event", kind="fenced", session_id="c0", op="step",
                lease="c0:l0")
    writer.emit("bench_cell", cell="pods_2x2", value={
        "n_processes": 2, "n_devices": 4, "rung": "on-chip",
        "mesh": {"scenario": 2, "agent": 2}})
    _spans(tracer, "req-traced")
    bad = str(root / "bad.metrics.jsonl")
    with open(path) as src, open(bad, "w") as dst:
        dst.write(src.readline())
        dst.write(json.dumps({"schema": 9, "event": "chunk", "ts": 0.0})
                  + "\n")
    return path, bad


KINDS = ("chunk", "retry", "preempted", "resume", "backend_event",
         "aot_serve", "alert", "serving_event", "fleet_event",
         "session_event", "bench_cell", "trace_event", "run_start")


def _compiled_cold(events) -> int:
    return sum(1 for e in events if e.get("event") == "aot_serve"
               and e.get("rung") == "eager_cold")


def test_health_file_holds_every_row_kind(health_file):
    path, _ = health_file
    events = export.read_events(path)
    assert set(KINDS) <= {e["event"] for e in events}
    assert export.validate_file(path) == []
    assert _compiled_cold(events) == 1


def test_run_health_summarize_and_render_equal_jax(health_file, capsys):
    """Equal summaries and rendered text, every section present; the one
    difference is the port's meaning of a compile in process: the JAX
    tool counts its ``jit_*`` rungs, the port also ``eager_cold`` (the
    serving process ran ``nvcc``)."""
    jrh = _load("run_health")
    path, _ = health_file
    events = export.read_events(path)
    got, ref = run_health.summarize(events), jrh.summarize(events)
    cold = _compiled_cold(events)
    assert got["aot"]["compiled_in_process"] == \
        ref["aot"]["compiled_in_process"] + cold == 1
    ref["aot"]["compiled_in_process"] += cold
    assert got == ref
    for key in ("chunks", "interruptions", "backend", "aot", "alerts",
                "serving", "fleet", "sessions", "topology", "critical_path",
                "logs"):
        assert got.get(key), key
    assert {e["event"] for e in got["interruptions"]} == {
        "retry", "preempted", "resume"}
    run_health.render(got)
    p_text = capsys.readouterr().out
    jrh.render(ref)
    assert p_text == capsys.readouterr().out
    for head in ("## chunk wall-times", "## resume / retry / preemption",
                 "## backend health", "## AOT serve ladder",
                 "## slo alerts", "## serving SLO", "## serving fleet",
                 "## closed-loop sessions", "## critical path",
                 "## topology (pods tier"):
        assert head in p_text, head


def test_run_health_json_equals_jax(health_file, monkeypatch, capsys):
    jrh = _load("run_health")
    path, _ = health_file
    assert _jax_main(jrh, [path, "--json"], monkeypatch) == 0
    ref = json.loads(capsys.readouterr().out)
    assert run_health.main([path, "--json"]) == 0
    got = json.loads(capsys.readouterr().out)
    ref["aot"]["compiled_in_process"] += _compiled_cold(
        export.read_events(path))
    assert got == ref


@pytest.mark.parametrize("which", ["good", "bad"])
def test_run_health_validate_equals_jax(health_file, which, monkeypatch,
                                        capsys):
    jrh = _load("run_health")
    path = health_file[0 if which == "good" else 1]
    j_rc = _jax_main(jrh, ["--validate", path], monkeypatch)
    j_out = capsys.readouterr()
    p_rc = run_health.main(["--validate", path])
    p_out = capsys.readouterr()
    assert p_rc == j_rc == (0 if which == "good" else 1)
    assert (p_out.out, p_out.err) == (j_out.out, j_out.err)
    assert which == "good" or "schema violation" in p_out.err


def test_run_health_follow_equals_jax(tmp_path, monkeypatch, capsys):
    """One bounded ``--follow`` round over a directory of two replica
    journals (tests/test_live.py's)."""
    jrh = _load("run_health")
    base = 1.7e9
    w0 = export.MetricsWriter(str(tmp_path / "r0.metrics.jsonl"))
    w1 = export.MetricsWriter(str(tmp_path / "r1.metrics.jsonl"))
    for i in range(4):
        w0.emit("serving_event", kind="submitted", request_id=f"a{i}",
                tenant="pro", family="f", ts=base + i)
        w1.emit("serving_event", kind="completed", request_id=f"a{i}",
                tenant="pro", family="f", ts=base + i + 1,
                slo={"latency_s": 0.2})
    argv = [str(tmp_path), "--follow", "--window", "60", "--rounds", "1",
            "--json"]
    assert _jax_main(jrh, argv, monkeypatch) == 0
    ref = capsys.readouterr().out
    assert run_health.main(argv) == 0
    got = capsys.readouterr().out
    assert got == ref
    row = json.loads(got.strip().splitlines()[-1])
    assert row["tenants"]["pro"]["submitted"] == 4
    assert row["tenants"]["pro"]["latency"]["count"] == 4


# ------------------------------ op_profile ------------------------------

SCOPES = [None, "", "jit(step)/while/body", "tat.local_solve",
          "jit(step)/tat.local_solve/tat.fused_solve/dot",
          "tat.consensus/tat.consensus_exchange/all-reduce",
          "tat.local_solve/inner/tat.pad/x", "tat.dynamics/tat.env_query",
          "tat.a1_b/tatx.c", "tat./tat.qp_build"]


@pytest.mark.parametrize("scope", SCOPES)
def test_phase_of_equals_jax(scope):
    assert op_profile.phase_of(scope) == _load("op_profile").phase_of(scope)


AGG = {
    "mm.1": {"total_us": 900.0, "count": 24,
             "scope": "jit(step)/tat.local_solve/dot"},
    "tanh.2": {"total_us": 300.0, "count": 24,
               "scope": "tat.local_solve/tat.fused_solve/tanh"},
    "reduce.3": {"total_us": 250.0, "count": 24, "scope": "tat.consensus"},
    "copy.4": {"total_us": 50.0, "count": 3, "scope": None},
    "sub.5": {"total_us": 100.0, "count": 24,
              "scope": "tat.consensus/tat.consensus_exchange"},
    "add.6": {"total_us": 7.5, "count": 1, "scope": "while/body"},
}


def test_rollup_and_phase_table_equal_jax(capsys):
    jop = _load("op_profile")
    got = op_profile.rollup_phases(AGG)
    assert got == jop.rollup_phases(AGG, None)
    rows, total, attributed = got
    assert total == 1607.5 and attributed == 1550.0
    p_table = op_profile.print_phase_table(*got)
    p_lines = capsys.readouterr().out.splitlines()
    j_table = jop.print_phase_table(*got)
    j_lines = capsys.readouterr().out.splitlines()
    assert p_table == j_table
    # The rows equal; the header names the port's device ops, not XLA's.
    assert p_lines[1:] == j_lines[1:]
    assert op_profile.print_op_table(AGG, 4) == jop.print_op_table(AGG, 4)
    # A torch op's name carries "::": the port counts it, where the JAX
    # tool drops its XLA runtime's own helpers by that mark.
    agg = dict(AGG, **{"aten::mm @ tat.local_solve": {
        "total_us": 10.0, "count": 1, "scope": "tat.local_solve"}})
    assert op_profile.rollup_phases(agg)[1] == total + 10.0
    assert jop.rollup_phases(agg, None)[1] == total


@pytest.mark.parametrize("by_phase", [True, False])
def test_op_profile_json_equals_jax(tmp_path, monkeypatch, capsys, by_phase):
    """``--json`` of both tools over the same aggregate."""
    jop = _load("op_profile")
    monkeypatch.setattr(jop, "load_xplanes", lambda d: [])
    monkeypatch.setattr(jop, "op_aggregate", lambda spaces: AGG)
    monkeypatch.setattr(jop, "find_hlo_dump", lambda d: None)
    monkeypatch.setattr(op_profile, "load_traces", lambda p: [])
    monkeypatch.setattr(op_profile, "op_aggregate", lambda traces: AGG)
    flag = ["--by-phase"] if by_phase else ["--top", "3"]
    j_json, p_json = str(tmp_path / "j.json"), str(tmp_path / "p.json")
    assert _jax_main(jop, ["d", "--json", j_json] + flag, monkeypatch) == 0
    assert op_profile.main(["d", "--json", p_json] + flag) == 0
    capsys.readouterr()
    with open(j_json) as fh:
        ref = json.load(fh)
    with open(p_json) as fh:
        got = json.load(fh)
    assert got.pop("source") == "host"
    assert got == ref


def test_cpu_capture_attributes_the_bar(tmp_path):
    """A real CPU ``torch.profiler`` capture of a scoped loop (a matmul
    under ``tat.local_solve``, a mean under ``tat.consensus``, on a
    256 x 256 carry): at least 80% of the ``cpu_op`` self time lands in
    ``tat.*`` phases, both present (the JAX tool's bar,
    tests/test_op_profile.py:242)."""
    from torch.profiler import ProfilerActivity, profile

    def step(c):
        for _ in range(24):
            with phases.scope(phases.LOCAL_SOLVE):
                c = torch.tanh(c @ c)
            with phases.scope(phases.CONSENSUS):
                c = c - c.mean(dim=0, keepdim=True)
        return c

    x = torch.eye(256) * 0.5
    step(x)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(3):
            step(x)
    path = str(tmp_path / "cpu.json")
    prof.export_chrome_trace(path)
    traces = op_profile.load_traces(str(tmp_path))
    assert not op_profile.has_device_events(traces)
    agg = op_profile.op_aggregate(traces)
    rows, total, attributed = op_profile.rollup_phases(agg)
    assert total > 0
    assert attributed / total >= 0.80, {k: r["total_us"]
                                        for k, r in rows.items()}
    assert {"local_solve", "consensus"} <= set(rows)
    assert rows["local_solve"]["count"] >= 3 * 24


def _synthetic_trace():
    """A Chrome trace as ``export_chrome_trace`` writes it on the card:
    ``tat.*`` ranges on the host thread, the launches in them, the device
    events with their correlation ids; one of the port's kernels with no
    launch in the trace, one kernel a replayed graph ran, and one with
    no launch at all. Returns the trace and each device event's phase."""
    host = dict(pid=7, tid=7)
    ev = [
        {"ph": "X", "cat": "user_annotation", "name": "tat.local_solve",
         "ts": 0.0, "dur": 100.0, **host},
        {"ph": "X", "cat": "user_annotation", "name": "tat.fused_solve",
         "ts": 10.0, "dur": 20.0, **host},
        {"ph": "X", "cat": "user_annotation", "name": "tat.consensus",
         "ts": 100.0, "dur": 50.0, **host},
        {"ph": "X", "cat": "user_annotation", "name": "tat.dynamics",
         "ts": 150.0, "dur": 50.0, **host},
        {"ph": "X", "cat": "cpu_op", "name": "aten::mul", "ts": 4.0,
         "dur": 3.0, **host},
        {"ph": "X", "cat": "gpu_user_annotation", "name": "tat.consensus",
         "ts": 101.0, "dur": 40.0, "pid": 0, "tid": 7},
    ]
    launches = [("cudaLaunchKernel", 5.0, 1), ("cudaLaunchKernel", 15.0, 2),
                ("cudaLaunchKernel", 120.0, 3), ("cuLaunchKernel", 125.0, 4),
                ("cudaGraphLaunch", 160.0, 5), ("cudaMemcpyAsync", 210.0, 6)]
    for name, ts, corr in launches:
        ev.append({"ph": "X", "cat": ("cuda_driver" if name.startswith("cu")
                                      and not name.startswith("cuda")
                                      else "cuda_runtime"),
                   "name": name, "ts": ts, "dur": 1.0,
                   "args": {"correlation": corr}, **host})
    device = [
        ("kernel", "void mul_kernel<float>(float*)", 1, "local_solve"),
        ("kernel", "void gemm_kernel(float const*)", 2, "fused_solve"),
        ("kernel", "void reduce_kernel<128>(float*)", 3, "consensus"),
        ("kernel", "void abs_kernel(float*)", 4, "consensus"),
        ("kernel", "void integrate_kernel(float*)", 5, "dynamics"),
        ("kernel", "void polar_kernel(float*)", 5, "dynamics"),
        ("kernel", "void warp_solve_kernel<48>(float const*)", None,
         "fused_solve"),
        ("kernel", "void stray_kernel(float*)", 99, None),
        ("gpu_memcpy", "Memcpy DtoH (Device -> Pinned)", 6, None),
    ]
    want = {}
    for i, (cat, name, corr, phase) in enumerate(device):
        e = {"ph": "X", "cat": cat, "name": name, "ts": 300.0 + 10 * i,
             "dur": float(i + 1), "pid": 0, "tid": 7, "args": {}}
        if corr is not None:
            e["args"]["correlation"] = corr
        ev.append(e)
        want[name] = phase
    return {"traceEvents": ev}, want


def test_device_trace_attributes_every_kernel(tmp_path, capsys):
    """The only CPU check of the card's path: every device event's phase
    (the innermost range around its launch; the graph's kernels by their
    ``cudaGraphLaunch``; the port's kernel with no launch by its name)."""
    obj, want = _synthetic_trace()
    path = tmp_path / "gpu.json"
    path.write_text(json.dumps(obj))
    traces = op_profile.load_traces(str(path))
    agg = op_profile.op_aggregate(traces)
    got = {}
    for name in want:
        hits = [a for k, a in agg.items()
                if k == name or k.startswith(name + " @ ")]
        assert len(hits) == 1, (name, hits)
        got[name] = op_profile.phase_of(hits[0]["scope"])
    assert got == want
    assert len(agg) == len(want)
    assert agg["void gemm_kernel(float const*) @ "
               "tat.local_solve/tat.fused_solve"]["total_us"] == 2.0
    rows, total, attributed = op_profile.rollup_phases(agg)
    assert total == sum(range(1, 10))
    assert attributed == total - 8.0 - 9.0
    assert op_profile.own_launches(traces) == {"warp_solve_kernel": 1}
    assert op_profile.main([str(path), "--by-phase", "--json",
                            str(tmp_path / "p.json")]) == 0
    payload = json.loads((tmp_path / "p.json").read_text())
    assert payload["source"] == "device"
    assert payload["own_kernel_launches"] == {"warp_solve_kernel": 1}
    assert payload["host_ms_by_phase"]["local_solve"] > 0
    assert "| dynamics | 0.011 |" in capsys.readouterr().out


# ----------------------------- profile_dd64 -----------------------------

def _jax_dd64_tree():
    with open(os.path.join(TOOLS, "profile_dd64.py")) as fh:
        return ast.parse(fh.read())


def _jax_keys():
    """The keys the JAX tool's ``main`` writes, by AST."""
    main = next(n for n in _jax_dd64_tree().body
                if isinstance(n, ast.FunctionDef) and n.name == "main")
    keys = set()
    for node in ast.walk(main):
        if isinstance(node, ast.Subscript) and isinstance(
                node.value, ast.Name) and node.value.id == "res" \
                and isinstance(node.slice, ast.Constant):
            keys.add(node.slice.value)
        if isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict) \
                and any(isinstance(t, ast.Name) and t.id == "res"
                        for t in node.targets):
            keys |= {k.value for k in node.value.keys}
    return keys


# Variant -> ms a step, each a dyadic fraction, so the fake clock's
# differences are exact.
STEP_MS = {(7, 40, True, 0.0): 250.0, (7, 20, True, 0.0): 125.0,
           (15, 20, True, 0.0): 187.5, (20, 40, False, 0.0): 62.5,
           (20, 40, False, 2e-3): 31.25}


def _jax_split(ms: dict, n, batch, monkeypatch, capsys) -> dict:
    """The JAX tool's ``main`` run on these step times: its own statements
    (by AST, with ``jax``, ``build_step`` and ``timed`` stood in), no jax
    or bench imported."""
    main = next(n for n in _jax_dd64_tree().body
                if isinstance(n, ast.FunctionDef) and n.name == "main")
    code = compile(ast.Module(body=[main], type_ignores=[]), "jax_dd64",
                   "exec")

    class Dev:
        platform = "cpu"

    class Jax:
        @staticmethod
        def devices():
            return [Dev()]

    def build_step(n_, batch_, max_iter, inner_iters, fixed=True,
                   inner_tol=0.0):
        return (max_iter, inner_iters, fixed, inner_tol), None, None

    ns = {"argparse": __import__("argparse"), "json": json, "jax": Jax,
          "build_step": build_step,
          "timed": lambda key, *rest: ms[key]}
    exec(code, ns)
    monkeypatch.setattr(sys, "argv", ["profile_dd64", "--n", str(n),
                                      "--batch", str(batch)])
    ns["main"]()
    return json.loads(capsys.readouterr().out)


def test_profile_dd64_keys_equal_jax():
    got = profile_dd64.split(*(1.0 + i for i in range(5)), 64, 64, "cuda")
    assert set(got) == _jax_keys()


def test_profile_dd64_timed_is_exact_on_a_fake_clock():
    ticks = iter([0.0, 1.0, 2.0, 4.0, 4.0, 4.5])  # runs of 1, 2, 0.5 s.
    steps = []

    def step(c, s):
        steps.append(1)
        return c + 1, s, None

    ms = profile_dd64.timed(step, 0, None, lambda: next(ticks), reps=3,
                            n_steps=4)
    assert ms == 1.0 / 4 * 1e3  # the median run over its steps.
    assert len(steps) == 1 + 3 * 4  # the warm-up step, then the runs.


def test_profile_dd64_split_equals_jax(monkeypatch, capsys):
    """The port's ``profile`` on a fake clock and stand-in steps: the same
    output, keys and differencing arithmetic as the JAX tool's."""
    n_steps = 4
    seen = []

    def build_step(n, batch, max_iter, inner_iters, fixed=True,
                   inner_tol=0.0, device="cuda"):
        seen.append((n, batch, str(device)))
        variant[0] = (max_iter, inner_iters, fixed, inner_tol)
        return (lambda c, s: (c, s, None)), None, None

    variant = [None]
    state = {"t": 0.0, "open": False}

    def clock():
        # timed() reads the clock before and after each run of the variant
        # built last: the run takes its steps at that variant's time.
        if state["open"]:
            state["t"] += STEP_MS[variant[0]] * n_steps / 1e3
        state["open"] = not state["open"]
        return state["t"]

    monkeypatch.setattr(profile_dd64, "build_step", build_step)
    got = profile_dd64.profile(n=64, batch=64, reps=3, n_steps=n_steps,
                               device="cpu", clock=clock)
    assert seen == [(64, 64, "cpu")] * 5
    ref = _jax_split(STEP_MS, 64, 64, monkeypatch, capsys)
    assert got == ref
    assert got["ms_per_single_inner_iter"] == (250.0 - 125.0) / 20 / 8
    assert got["inner_tol_speedup"] == 2.0


def test_profile_dd64_refuses_keywords_with_no_port_meaning():
    assert profile_dd64.port_keywords(max_iter=7, inner_iters=40,
                                      force_fixed_iters=True,
                                      inner_tol=0.0) == {
        "max_iter": 7, "inner_iters": 40, "force_fixed_iters": True,
        "inner_tol": 0.0}
    with pytest.raises(ValueError, match="no port meaning"):
        profile_dd64.port_keywords(substep_unroll=2)
    with pytest.raises(ValueError, match="not a keyword"):
        profile_dd64.port_keywords(socp_fused="pallas")


def test_profile_dd64_default_device_is_the_card():
    """Without ``--device`` the tool targets the card: on a host with no
    CUDA device it raises instead of running on the CPU."""
    import inspect

    assert inspect.signature(profile_dd64.profile).parameters[
        "device"].default == "cuda"
    if torch.cuda.is_available():
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        profile_dd64.main(["--n", "4", "--batch", "2"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        profile_dd64.profile(n=4, batch=2)


# ------------------------------ probe_chip ------------------------------

@pytest.mark.parametrize("answer,rc", [
    ((True, "cuda"), 0), ((True, "cpu"), 1),
    ((False, "timeout after 60s (card unreachable/wedged)"), 1)])
def test_probe_chip_logs_one_record(tmp_path, monkeypatch, capsys, answer,
                                    rc):
    seen = []

    def fake(**kw):
        seen.append(kw)
        kw["notes"].append("bundle")
        return answer

    monkeypatch.setattr(probe_chip._backend_mod(), "probe_subprocess", fake)
    log = tmp_path / "logs" / "probe.log"
    for i in range(2):
        assert probe_chip.main(["--log", str(log), "--timeout", "5"]) == rc
    lines = log.read_text().splitlines()
    assert len(lines) == 2
    word = "ALIVE" if rc == 0 else "DOWN"
    assert all(f"  {word}  " in ln and ln.endswith("  bundle")
               for ln in lines)
    assert lines[0].split("  ")[0].endswith(" UTC")
    if answer == (True, "cpu"):
        assert "silent CPU fallback" in lines[0]
    assert seen[0]["timeout_s"] == 5 and seen[0]["device"] == "cuda"
    assert capsys.readouterr().out.splitlines() == lines


def test_probe_chip_default_log_is_under_the_build_directory():
    build = os.path.join(REPO, "build")
    assert os.path.dirname(probe_chip.LOG) == build
    with open(os.path.join(REPO, ".gitignore")) as fh:
        assert "build/" in fh.read().split()


# ------------------------------- ci_check -------------------------------

@pytest.mark.parametrize("which", ["good", "bad"])
def test_ci_check_chains_the_gates(health_file, trace_sources, tmp_path,
                                   which, capsys):
    """Lint Tiers A and C, ``run_health --validate`` and ``trace_view
    --validate`` over an artifacts directory, in this process: exit 1 when
    a metrics file breaks the schema; the card smokes named, not run."""
    from tpu_aerial_transport_torch.tools import ci_check

    art = tmp_path / "artifacts"
    art.mkdir()
    good, bad = health_file
    src = good if which == "good" else bad
    (art / "run.metrics.jsonl").write_text(open(src).read())
    root, jsonl, pods = trace_sources
    trace_view.main([jsonl, pods, "--out", str(art / "run.trace.json")])
    capsys.readouterr()
    rc = ci_check.main([trace_view.__file__, "--artifacts", str(art)])
    out = capsys.readouterr().out
    assert rc == (0 if which == "good" else 1)
    assert ("ci_check: OK" if rc == 0 else "ci_check: FAILED") in out
    for gate in ("lint Tier A", "lint --host", "run_health --validate",
                 "trace_view --validate", "chip_smoke.py phase 40"):
        assert gate in out, gate


@pytest.mark.parametrize("controller", ["cadmm", "dd"])
def test_force_fixed_iters_runs_every_consensus_iteration(controller):
    """``make_mpc_step(..., force_fixed_iters=True)``, the JAX bench's knob
    that ``profile_dd64``'s fixed variants set: every scenario runs
    ``max_iter + 1`` consensus iterations; without it the tolerance stops
    them earlier."""
    from tpu_aerial_transport_torch.harness import rollout

    iters = {}
    for fixed in (True, False):
        step, cs0, st0 = rollout.make_mpc_step(
            controller, 4, max_iter=3, inner_iters=5,
            force_fixed_iters=fixed, device="cpu")
        _, _, stats = step(rollout.stack_scenarios(cs0, 2),
                           rollout.scenario_batch(st0, 2))
        iters[fixed] = stats.iters.tolist()
    assert iters[True] == [4, 4]
    assert max(iters[False]) <= 4
    with pytest.raises(ValueError, match="no consensus loop"):
        rollout.make_controller("centralized", 3, force_fixed_iters=True,
                                device="cpu")
