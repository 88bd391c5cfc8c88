"""PyTorch port vs the JAX package: distributed tracing (``obs.trace``,
the port's own stdlib-only copy).

The same span sequence through both tracers, on the same injected clocks,
gives the same rows apart from the ids; ``stitch``, ``chrome_trace`` and
``critical_path`` give the same results on the same rows, and the port's
Chrome trace passes the JAX ``validate_chrome_trace``. The chunk driver's
spans (``run``/``chunk``/``snapshot``/``resume``, ``preempted`` and
``retry`` instants) land as ``trace_event`` rows the JAX ``validate_file``
accepts.
"""

import ast
import itertools
import sys

import pytest
from test_torch_recovery import _central, _plan, _runner

from tpu_aerial_transport.obs import export as jexport
from tpu_aerial_transport.obs import trace as jtrace
from tpu_aerial_transport_torch.obs import export, trace
from tpu_aerial_transport_torch.resilience import recovery

IDS = ("trace_id", "span_id", "parent_id")


def _clocks():
    mono = itertools.count(100.0, 0.25)
    wall = itertools.count(1.7e9, 0.25)
    return dict(clock_mono=lambda: next(mono), clock_wall=lambda: next(wall))


def _drive(mod):
    """A request's spans, a batch's lane map and the recovery spans,
    through ``mod``'s tracer."""
    tr = mod.Tracer(track="p0of1", **_clocks())
    req = tr.begin(mod.REQUEST, request_id="r1")
    q = tr.begin(mod.QUEUE_WAIT, parent=req)
    tr.end(q)
    lanes = [[0, "r1", req.trace_id]]
    with tr.span(mod.BATCH_FORM, batch_id="b0"):
        with tr.span(mod.CHUNK_DISPATCH, lanes=lanes):
            tr.instant(mod.RETRY, chunk=0, attempt=1)
        with tr.span(mod.HARVEST, lanes=lanes):
            with tr.span(mod.BOUNDARY_PUBLISH, lanes=lanes):
                pass
    tr.end(req, status="completed")
    run = tr.begin(mod.RUN, parent=None, n_chunks=2)
    c = tr.begin(mod.CHUNK, parent=run, chunk=0)
    s = tr.begin(mod.SNAPSHOT, parent=c, chunk=0)
    tr.end(s)
    tr.end(c)
    tr.instant("preempted", parent=run, chunk=1, signal="SIGTERM")
    tr.end(run, status="preempted")
    tr.end(run, late="attr")  # idempotent: the times stay.
    return tr.rows


def _relabel(rows):
    """Rows with every id replaced by its order of first appearance."""
    names = {}
    out = []
    for r in rows:
        r = dict(r)
        for k in IDS:
            if k in r:
                r[k] = names.setdefault(r[k], f"id{len(names)}")
        attrs = r.get("attrs", {})
        if "lanes" in attrs:
            attrs = dict(attrs, lanes=[
                [a, b, names.setdefault(t, f"id{len(names)}")]
                for a, b, t in attrs["lanes"]])
            r["attrs"] = attrs
        out.append(r)
    return out


def test_same_spans_same_rows():
    """Names, parents, tracks, attributes and (injected) times of every
    row equal; only the ids differ."""
    got, ref = _drive(trace), _drive(jtrace)
    assert [r["name"] for r in got] == [r["name"] for r in ref]
    assert _relabel(got) == _relabel(ref)
    assert trace.SEGMENTS == jtrace.SEGMENTS
    for name in ("REQUEST", "QUEUE_WAIT", "BATCH_FORM", "CHUNK_DISPATCH",
                 "HARVEST", "LANE_SURGERY", "BOUNDARY_PUBLISH",
                 "GUARD_DISPATCH", "GUARD_FALLBACK", "SESSION_STEP", "RUN",
                 "CHUNK", "SNAPSHOT", "RESUME", "RETRY"):
        assert getattr(trace, name) == getattr(jtrace, name)


def test_readers_agree_and_chrome_trace_validates_under_jax():
    """``stitch``, ``chrome_trace`` and ``critical_path`` of the port's
    rows equal the JAX package's on the same rows; the port's Chrome trace
    passes both validators."""
    rows = _drive(trace)
    assert trace.stitch(rows) == jtrace.stitch(rows)
    assert trace.trace_rows(rows) == jtrace.trace_rows(rows)
    obj = trace.chrome_trace(rows)
    assert obj == jtrace.chrome_trace(rows)
    assert jtrace.validate_chrome_trace(obj) == []
    assert trace.validate_chrome_trace(obj) == []
    cp = trace.critical_path(trace.stitch(rows))
    assert cp == jtrace.critical_path(jtrace.stitch(rows))
    assert cp["completed"] == 1
    segs = cp["requests"][0]["segments"]
    assert segs["device"] > 0 and segs["publish"] > 0
    broken = dict(obj, traceEvents=obj["traceEvents"] + [{
        "ph": "X", "name": "x", "pid": 1, "tid": 99, "ts": 0.0, "dur": -1.0,
        "args": {"span_id": "s", "parent_id": "missing"}}])
    assert trace.validate_chrome_trace(broken) == \
        jtrace.validate_chrome_trace(broken) != []


def test_chunk_driver_spans_validate_under_jax(tmp_path):
    """A preempted and resumed chunked run traced into its metrics file:
    the ``run``/``chunk``/``snapshot`` spans of each run, the
    ``preempted`` instant and the ``resume`` span parenting the resumed
    run; the file passes the JAX ``validate_file``, the stitched run
    directory's Chrome trace the JAX ``validate_chrome_trace``."""
    p = _central()
    runner = _runner(p)
    d = tmp_path / "run"
    metrics = export.MetricsWriter(str(d / "run.metrics.jsonl"))
    tracer = trace.Tracer(metrics, track="p0of1")
    interrupt = recovery.GracefulInterrupt()

    def preempting(carry, i0):
        out = runner.chunk_jit(carry, i0)
        interrupt.triggered = "SIGTERM"
        return out

    recovery.run_chunks(_plan(d), preempting,
                        runner.init_carry(p.states, p.css),
                        interrupt=interrupt, metrics=metrics, tracer=tracer)
    recovery.resume_run(str(d), runner.chunk_jit,
                        runner.init_carry(p.states, p.css), metrics=metrics,
                        tracer=tracer)
    assert jexport.validate_file(metrics.path) == []
    rows = trace.trace_rows(export.read_events(metrics.path))
    names = [r["name"] for r in rows]
    assert names.count(trace.RUN) == 2 and names.count(trace.RESUME) == 1
    assert names.count(trace.CHUNK) == names.count(trace.SNAPSHOT) == 3
    assert "preempted" in names
    by_id = {r["span_id"]: r for r in rows}
    resume = next(r for r in rows if r["name"] == trace.RESUME)
    resumed_run = [r for r in rows if r["name"] == trace.RUN][-1]
    assert resumed_run["parent_id"] == resume["span_id"]
    assert resumed_run["attrs"]["resumed_from"] == 1
    for r in rows:
        if r.get("parent_id"):
            assert r["parent_id"] in by_id
    stitched = trace.stitch_run_dir(str(d))
    assert stitched == jtrace.stitch_run_dir(str(d))
    assert jtrace.validate_chrome_trace(trace.chrome_trace(stitched)) == []
    out = trace.write_chrome_trace(str(tmp_path / "t.json"), stitched)
    assert jtrace.validate_trace_file(str(tmp_path / "t.json")) == []
    assert out == trace.chrome_trace(stitched)


def test_stitch_run_dir_refuses_a_partial_fleet(tmp_path):
    """With a shard manifest naming 2 processes and one track of rows,
    both packages refuse the stitch unless ``allow_partial``."""
    from tpu_aerial_transport_torch.harness import checkpoint

    checkpoint.save_shard_manifest(str(tmp_path), prefix="carry",
                                   n_processes=2)
    w = export.MetricsWriter(str(tmp_path / "p0.jsonl"))
    tr = trace.Tracer(w, track="p0of2")
    tr.end(tr.begin(trace.RUN))
    for mod in (trace, jtrace):
        with pytest.raises(ValueError, match="2 processes"):
            mod.stitch_run_dir(str(tmp_path))
    assert len(trace.stitch_run_dir(str(tmp_path), allow_partial=True)) == 1


def test_trace_module_imports_the_stdlib_only():
    """The module's own imports are the standard library's (importing the
    port's package pulls in torch; the span layer itself does not)."""
    with open(trace.__file__) as f:
        tree = ast.parse(f.read())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    names.discard("__future__")
    assert names and names <= set(sys.stdlib_module_names), names
