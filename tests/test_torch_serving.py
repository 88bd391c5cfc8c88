"""PyTorch port vs the JAX package: the serving tier
(``tpu_aerial_transport_torch/serving``, ``aot/loader.serve_entry``).

The same seeded numpy request stream goes through the JAX package's
``ScenarioServer`` (on the CPU) and the port's
``ScenarioServer(device="cpu")``, at the canonical families ``cadmm4``
and ``centralized4`` with buckets (2, 4), chunk length 2, under one fake
clock: statuses, rejection reasons, served step counts and the
``serving_event`` and journal rows (kinds, request ids, lanes, buckets,
lane maps) are equal exactly; final states agree within 1e-4, and the
forces in each family's final batch carry within 1e-3 N for the
centralized family and 1e-4 N for C-ADMM -- the bars of
``tests/test_torch_recovery.py`` (the two packages' float32 inverses and
products round apart by ~1e-6 relative; the centralized solve stops short
of convergence, where the float32 duals round apart).

Within the port, bitwise: a request's result served alone (its lane
padded with filler, bucket 2), inside a busy batch (bucket 4) and joined
late at a boundary; host against device lane surgery; sync against
pipelined dispatch; preempt and resume; a result-cache hit that skips the
dispatch; and a ``crash@N`` guarded run whose one degraded chunk is
tagged, journaled and counted (a server on the CPU). With the card as the
guard's primary rung, ``crash@N`` instead fails that chunk's requests with
a structured, journaled reason and runs nothing on the CPU.
"""

import json

import jax
import numpy as np
import pytest
import torch

from tpu_aerial_transport.serving import batcher as jbatcher
from tpu_aerial_transport.serving import cache as jcache
from tpu_aerial_transport.serving import server as jserver
from tpu_aerial_transport.serving.queue import ScenarioRequest as JRequest
from tpu_aerial_transport_torch.aot import loader
from tpu_aerial_transport_torch.obs import export
from tpu_aerial_transport_torch.resilience import backend
from tpu_aerial_transport_torch.resilience.recovery import RunJournal
from tpu_aerial_transport_torch.serving import batcher, cache, lanes
from tpu_aerial_transport_torch.serving import queue as queue_mod
from tpu_aerial_transport_torch.serving import server as server_mod
from tpu_aerial_transport_torch.serving.queue import ScenarioRequest
from tpu_aerial_transport_torch.tree import leaves

BUCKETS = (2, 4)
STATE_KEYS = ("xl", "vl", "Rl", "wl", "R", "w")
STATE_BAR = 1e-4
FORCE_BAR = {"cadmm4": 1e-4, "centralized4": 1e-3}
FAMILIES = ("cadmm4", "centralized4")


class FakeInterrupt:
    triggered = None


@pytest.fixture(scope="module")
def families():
    """One port family per canonical spec for the module (on the CPU)."""
    return {n: batcher.make_family(n, device="cpu") for n in FAMILIES}


@pytest.fixture(scope="module")
def jax_families():
    """One JAX family per spec, so each bucket's program compiles once."""
    return {n: jbatcher.make_family(n) for n in FAMILIES}


def _server(families, names=FAMILIES, **kw):
    kw.setdefault("buckets", BUCKETS)
    return server_mod.ScenarioServer(
        families=[families[n] for n in names], device="cpu", **kw)


def _drain(srv):
    while srv.pump():
        pass


def _same_bits(a, b):
    la, lb = leaves(a), leaves(b)
    assert len(la) == len(lb) and la
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and torch.equal(x, y)


def _stream(Request, n=12, seed=0):
    """The seeded stream: one request of each rejection reason but the
    queue's own, then alternating families, horizons on the chunk grid
    (2, 4, 6 steps), payload starts and velocities from
    ``default_rng(seed)``, and two deadlines."""
    rng = np.random.default_rng(seed)
    out = [Request(family="martian", horizon=2, request_id="bad_fam"),
           Request(family="cadmm4", horizon=3, request_id="bad_hz"),
           Request(family="cadmm4", horizon=2, deadline_s=0.0,
                   request_id="spent")]
    for i in range(n):
        x0 = rng.normal(0.0, 0.3, 3) + np.array([0.0, 0.0, 1.0])
        v0 = rng.normal(0.0, 0.1, 3)
        out.append(Request(
            family=FAMILIES[i % 2], horizon=2 * (1 + i % 3),
            x0=tuple(float(v) for v in x0), v0=tuple(float(v) for v in v0),
            deadline_s=(1.5 if i == 4 else 0.5 if i == 9 else None),
            request_id=f"r{i:03d}"))
    return out


def _serving_rows(path):
    drop = ("batch_id", "slo", "depth", "occupancy", "rung", "guard_rung")
    return [{k: v for k, v in e.items()
             if k not in drop + ("schema", "ts", "t_wall", "wall_s")}
            for e in export.read_events(path)
            if e["event"] == "serving_event"]


def _journal_rows(run_dir):
    rows = []
    for e in RunJournal(run_dir, server_mod.SERVING_JOURNAL).read():
        e = dict(e)
        e.pop("batch_id", None)
        rows.append(e)
    return rows


def test_server_matches_jax_server_on_seeded_stream(families, jax_families,
                                                    tmp_path):
    """The tentpole parity: one seeded stream through both servers in
    lockstep under one fake clock (queue capacity 12, so the 13th pending
    request is refused ``queue_full``; one deadline missed in the queue,
    one in flight)."""
    now = [0.0]
    clock = lambda: now[0]  # noqa: E731
    pdir, jdir = tmp_path / "port", tmp_path / "jax"
    port = _server(families, capacity=12, clock=clock, run_dir=str(pdir),
                   metrics=str(tmp_path / "port.jsonl"))
    ref = jserver.ScenarioServer(
        families=[jax_families[n] for n in FAMILIES], buckets=BUCKETS,
        capacity=12, clock=clock, run_dir=str(jdir),
        metrics=str(tmp_path / "jax.jsonl"))
    extra = [dict(family="cadmm4", horizon=2, request_id=f"x{i}")
             for i in range(3)]
    pt = [port.submit(r) for r in _stream(ScenarioRequest)]
    pt += [port.submit(ScenarioRequest(**kw)) for kw in extra]
    jt = [ref.submit(r) for r in _stream(JRequest)]
    jt += [ref.submit(JRequest(**kw)) for kw in extra]
    more_p = more_j = True
    while more_p or more_j:
        now[0] += 1.0
        more_p, more_j = port.pump(), ref.pump()
        assert more_p == more_j

    got = [(t.request.request_id, t.status, t.reason, t.steps_served,
            t.slo.missed) for t in pt]
    want = [(t.request.request_id, t.status, t.reason, t.steps_served,
             t.slo.missed) for t in jt]
    assert got == want
    statuses = {s for _, s, _, _, _ in got}
    assert statuses == {"completed", "rejected", "deadline_missed"}
    reasons = {r for _, _, r, _, _ in got if r}
    assert reasons == {"queue_full", "no_bucket_coverage",
                       "horizon_not_chunk_aligned",
                       "deadline_already_passed"}
    assert {m for *_, m in got if m} == {"in_queue", "in_flight"}
    assert _serving_rows(str(tmp_path / "port.jsonl")) == \
        _serving_rows(str(tmp_path / "jax.jsonl"))
    assert _journal_rows(str(pdir)) == _journal_rows(str(jdir))
    assert export.validate_file(str(tmp_path / "port.jsonl")) == []

    for p, j in zip(pt, jt):
        if p.result is None:
            assert j.result is None
            continue
        for k in STATE_KEYS:
            np.testing.assert_allclose(
                getattr(p.result, k).numpy(),
                np.asarray(getattr(j.result, k)), rtol=0, atol=STATE_BAR,
                err_msg=f"{p.request.request_id} {k}")
    for name in FAMILIES:
        pc = port._batches[name].carry_host
        jc = jax.tree.map(np.asarray, ref._batches[name].carry_host)
        for k in STATE_KEYS:
            np.testing.assert_allclose(getattr(pc[0], k).numpy(),
                                       getattr(jc[0], k), rtol=0,
                                       atol=STATE_BAR)
        f, jf = ((pc[1].f, jc[1].f) if name == "cadmm4"
                 else (pc[1].prev_f, jc[1].prev_f))
        np.testing.assert_allclose(f.numpy(), jf, rtol=0,
                                   atol=FORCE_BAR[name])
    stats, jstats = port.stats(), ref.stats()
    for k in ("requests", "completed", "rejected", "deadline_missed",
              "scenario_steps", "preempted", "surgery", "dispatch"):
        assert stats.get(k) == jstats.get(k), k
    assert stats["guard_fallbacks"] == 0


def _probe(rid="probe", family="cadmm4", horizon=4):
    return ScenarioRequest(family=family, horizon=horizon,
                           x0=(1.2, -0.4, 0.8), v0=(0.1, 0.0, -0.05),
                           request_id=rid)


def _others(family, n=3, horizon=6):
    return [ScenarioRequest(family=family, horizon=horizon,
                            x0=(0.3 * i, 0.1, 1.0), request_id=f"o{i}")
            for i in range(n)]


@pytest.mark.parametrize("family", FAMILIES)
def test_composition_independence(families, family):
    """A request's result is bitwise the same served alone (bucket 2, its
    lane padded with filler), inside a busy batch (bucket 4) and joined
    late at a boundary of a running batch."""
    alone = _server(families, (family,))
    t_alone = alone.submit(_probe("alone", family))
    _drain(alone)
    assert alone._batches[family].bucket == 2

    busy = _server(families, (family,))
    others = [busy.submit(r) for r in _others(family)]
    t_busy = busy.submit(_probe("busy", family))
    _drain(busy)
    assert t_busy.lane is not None and busy._batches[family].bucket == 4

    late_srv = _server(families, (family,))
    first = [late_srv.submit(r) for r in _others(family, 3)]
    first.append(late_srv.submit(_probe("short", family, horizon=2)))
    late_srv.pump()
    t_late = late_srv.submit(_probe("late", family))
    _drain(late_srv)
    assert t_late.batch_id == first[0].batch_id
    assert t_late.slo.t_admit > first[0].slo.t_launch

    for t in others + first + [t_alone, t_busy, t_late]:
        assert t.status == queue_mod.COMPLETED, t
    _same_bits(t_alone.result, t_busy.result)
    _same_bits(t_alone.result, t_late.result)


def _mixed(srv, family):
    tickets = [srv.submit(ScenarioRequest(
        family=family, horizon=(6 if i % 3 else 2), x0=(0.2 * i, 0.1, 1.0),
        request_id=f"m{i}")) for i in range(5)]
    srv.pump()
    tickets.append(srv.submit(_probe("m_late", family)))
    _drain(srv)
    assert all(t.status == queue_mod.COMPLETED for t in tickets)
    return {t.request.request_id: t.result for t in tickets}


@pytest.mark.parametrize("family", FAMILIES)
def test_surgery_and_dispatch_modes_bitwise(families, family, tmp_path):
    """Host against device lane surgery, sync against pipelined dispatch,
    over a mixed-horizon stream with late joins: every result bitwise
    equal (selects copy bits; the boundary plan is host arithmetic), and
    the device arms did serve their boundaries through ``lane_surgery``
    (its ``aot_serve`` rows)."""
    ref = _mixed(_server(families, (family,)), family)
    arms = {}
    for name, kw in (("device", dict(surgery="device")),
                     ("pipelined", dict(dispatch="pipelined"))):
        path = str(tmp_path / f"{name}.jsonl")
        arms[name] = (_server(families, (family,), metrics=path, **kw),
                      path)
    assert (arms["device"][0].surgery, arms["device"][0].dispatch) == (
        "device", "sync")
    assert (arms["pipelined"][0].surgery,
            arms["pipelined"][0].dispatch) == ("device", "pipelined")
    for srv, path in arms.values():
        got = _mixed(srv, family)
        assert set(got) == set(ref)
        for rid in ref:
            _same_bits(ref[rid], got[rid])
        entries = [e["entry"] for e in export.read_events(path)
                   if e["event"] == "aot_serve"]
        assert entries.count(families[family].surgery_entry) >= 2


def test_lane_surgery_is_the_host_splice_bitwise(families):
    """``lane_surgery`` on a boundary carry equals the host splice of the
    same joins and resets, leaf for leaf, and returns the pre-surgery
    state as the harvest."""
    fam = families["cadmm4"]
    srv = _server(families, ("cadmm4",))
    for r in _others("cadmm4", 4, horizon=4):
        srv.submit(r)
    srv.pump()
    batch = srv._batches["cadmm4"]
    carry = batch.carry_host
    joins = [(1, _probe("j1")), (3, _probe("j3"))]
    out, harvested = lanes.lane_surgery(
        carry, *lanes.make_surgery_args(fam.batched_template_host(4), joins,
                                        [2], 4))
    _same_bits(carry[0], harvested)
    ref = tuple(leaves(carry))
    ref = [t.clone() for t in ref]
    tmpl = fam.template_carry_host()
    for lane, req in joins:
        for dst, src in zip(ref, leaves(fam.lane_carry(tmpl, req))):
            dst[lane] = src
    for dst, src in zip(ref, leaves(tmpl)):
        dst[2] = src
    for x, y in zip(leaves(out), ref):
        assert torch.equal(x, y)


@pytest.mark.parametrize("mode", [dict(), dict(surgery="device"),
                                  dict(dispatch="pipelined")],
                         ids=["host", "device", "pipelined"])
def test_preempt_resume_bitwise(families, tmp_path, mode):
    """Preemption lands at a chunk boundary; the journal and snapshots
    restore the remainder in a new server, and the merged results are
    bitwise the uninterrupted run's (both families)."""
    def stream():
        return [ScenarioRequest(family=FAMILIES[i % 2], horizon=6,
                                x0=(0.3 * i, 0.1, 1.0), request_id=f"p{i}")
                for i in range(6)]

    ref_srv = _server(families)
    ref = {t.request.request_id: t for t in map(ref_srv.submit, stream())}
    _drain(ref_srv)

    run_dir = str(tmp_path / "run")
    fi = FakeInterrupt()
    srv1 = _server(families, run_dir=run_dir, interrupt=fi, **mode)
    t1 = [srv1.submit(r) for r in stream()]
    srv1.pump()
    fi.triggered = "SIGTERM"
    assert srv1.pump() is False and srv1.preempted
    done1 = {t.request.request_id: t.result for t in t1
             if t.status == queue_mod.COMPLETED}
    srv2 = server_mod.ScenarioServer.resume(
        run_dir, families=[families[n] for n in FAMILIES], buckets=BUCKETS,
        device="cpu", **mode)
    assert srv2.done_requests == set(done1)
    _drain(srv2)
    done2 = {rid: t.result for rid, t in srv2.tickets.items()
             if t.status == queue_mod.COMPLETED}
    merged = {**done1, **done2}
    assert set(merged) == set(ref)
    for rid, t in ref.items():
        _same_bits(t.result, merged[rid])


def test_resume_past_a_corrupt_snapshot_replays(families, tmp_path):
    """A bitrotted boundary snapshot does not kill the resume: the batch's
    requests replay from their specs, bitwise the uninterrupted run."""
    reqs = [ScenarioRequest(family="cadmm4", horizon=6,
                            x0=(0.3 * i, 0.1, 1.0), request_id=f"c{i}")
            for i in range(3)]
    ref_srv = _server(families, ("cadmm4",))
    ref = [ref_srv.submit(r) for r in reqs]
    _drain(ref_srv)
    run_dir = tmp_path / "run"
    fi = FakeInterrupt()
    srv1 = _server(families, ("cadmm4",), run_dir=str(run_dir),
                   interrupt=fi)
    for r in reqs:
        srv1.submit(r)
    srv1.pump()
    fi.triggered = "SIGTERM"
    srv1.pump()
    for path in run_dir.glob("*.ckpt"):
        raw = bytearray(path.read_bytes())
        raw[0] ^= 0xFF
        path.write_bytes(bytes(raw))
    srv2 = server_mod.ScenarioServer.resume(
        str(run_dir), families=[families["cadmm4"]], buckets=BUCKETS,
        device="cpu")
    _drain(srv2)
    events = [e["event"] for e in
              RunJournal(str(run_dir), server_mod.SERVING_JOURNAL).read()]
    assert "serving_snapshot_skipped" in events
    for t in ref:
        _same_bits(t.result, srv2.tickets[t.request.request_id].result)


def test_result_cache_hit_skips_dispatch(families, tmp_path):
    """A content-identical repeat (another request id) resolves at submit
    from the cache: no queue, no dispatch, bitwise the computed result,
    one ``cache_hit`` row; session steps never consult the cache."""
    path = str(tmp_path / "cache.jsonl")
    srv = _server(families, ("cadmm4",), cache=4, metrics=path)
    t1 = srv.submit(_probe("orig"))
    _drain(srv)
    dispatched = dict(srv.dispatch_rungs)
    t2 = srv.submit(_probe("replay"))
    assert t2.status == queue_mod.COMPLETED and not srv.has_work()
    assert srv.dispatch_rungs == dispatched
    assert t2.steps_served == t1.steps_served
    _same_bits(t1.result, t2.result)
    kinds = [e.get("kind") for e in export.read_events(path)]
    assert kinds.count("cache_hit") == 1
    assert srv.stats()["cache"]["hits"] == 1
    assert export.validate_file(path) == []
    step = srv.submit(ScenarioRequest(family="cadmm4", horizon=4,
                                      x0=(1.2, -0.4, 0.8),
                                      v0=(0.1, 0.0, -0.05),
                                      request_id="s.e0.s000001",
                                      session="s"))
    assert step.status == queue_mod.PENDING
    _drain(srv)


def test_result_cache_lru_and_keys_match_jax():
    """Content addresses are the JAX package's (the same sha256 for the
    same hash, horizon and payload; request ids ignored); the LRU bound
    evicts the least recently used entry; hits are deep copies."""
    r = ScenarioRequest(family="cadmm4", horizon=4, x0=(0.1, 0.2, 0.3),
                        request_id="a")
    same = ScenarioRequest(family="cadmm4", horizon=4, x0=(0.1, 0.2, 0.3),
                           request_id="b")
    other = ScenarioRequest(family="cadmm4", horizon=4,
                            x0=(0.1, 0.2, 0.30000001), request_id="c")
    for req in (r, other):
        jreq = JRequest(family=req.family, horizon=req.horizon, x0=req.x0,
                        v0=req.v0, request_id=req.request_id)
        assert cache.request_key("h", req) == jcache.request_key("h", jreq)
    assert cache.request_key("h", r) == cache.request_key("h", same)
    assert cache.request_key("h", r) != cache.request_key("h", other)
    assert cache.request_key("h", r) != cache.request_key("g", r)
    c = cache.ResultCache(max_entries=2)
    c.put("k1", (torch.ones(3),), 4)
    c.put("k2", (torch.zeros(3),), 4)
    assert c.get("k1") is not None
    c.put("k3", (torch.full((3,), 2.0),), 8)
    assert c.get("k2") is None
    hit = c.get("k1")
    assert hit[1] == 4
    hit[0][0][0] = 123.0
    assert c.get("k1")[0][0][0] == 1.0
    assert c.stats() == {"entries": 2, "max_entries": 2, "hits": 3,
                         "misses": 1, "hit_rate": 0.75}
    with pytest.raises(ValueError):
        cache.ResultCache(0)


def test_guard_crash_degrades_one_chunk_tagged_and_journaled(families,
                                                             tmp_path):
    """``crash@3`` on a server on the CPU: the third guarded chunk falls
    back to the CPU rung -- the family's program on the boundary's host
    copy -- with exactly one ``backend_event`` journaled and one fallback
    counted; every result bitwise the clean run's (the CPU rung reruns the
    same program on the same bits)."""
    def stream():
        return [ScenarioRequest(family=FAMILIES[i % 2], horizon=4,
                                x0=(0.2 * i, 0.1, 1.0), request_id=f"g{i}")
                for i in range(4)]

    clean = _server(families)
    ref = [clean.submit(r) for r in stream()]
    _drain(clean)
    run_dir = str(tmp_path / "run")
    guard = backend.BackendGuard(
        faults=backend.FaultInjector.from_env("crash@3"))
    srv = _server(families, run_dir=run_dir, guard=guard,
                  metrics=str(tmp_path / "g.jsonl"))
    got = [srv.submit(r) for r in stream()]
    _drain(srv)
    be = [e for e in RunJournal(run_dir, server_mod.SERVING_JOURNAL).read()
          if e["event"] == "backend_event"]
    assert [(e["kind"], e["label"]) for e in be] == [
        ("device_crash", "cadmm4:b%d:c1" % got[0].batch_id)]
    assert guard.fallbacks == 1 and srv.stats()["guard_fallbacks"] == 1
    bounds = [e for e in export.read_events(str(tmp_path / "g.jsonl"))
              if e.get("kind") == "batch_boundary"]
    assert len(bounds) == 4
    for t, r in zip(got, ref):
        assert t.status == queue_mod.COMPLETED
        _same_bits(r.result, t.result)


def test_card_failure_fails_the_chunks_requests(families, tmp_path):
    """With the card as the guard's primary rung, ``crash@3`` never runs
    the CPU rung: the third chunk's batch ends its requests ``failed``
    with reason ``device_crash`` (one ``backend_event``, a ``failed``
    ``serving_done`` row each), counted in the stats; every other request
    completes bitwise the clean run's, and so do the failed ones submitted
    again; a resume of the run directory replays none of them."""
    def stream():
        return [ScenarioRequest(family=FAMILIES[i % 2], horizon=4,
                                x0=(0.2 * i, 0.1, 1.0), request_id=f"f{i}")
                for i in range(6)]

    clean = _server(families)
    ref = {t.request.request_id: t for t in map(clean.submit, stream())}
    _drain(clean)
    run_dir = str(tmp_path / "run")
    guard = backend.BackendGuard(
        primary_rung=backend.RUNG_ONCHIP,
        faults=backend.FaultInjector.from_env("crash@3"))
    srv = _server(families, run_dir=run_dir, guard=guard,
                  metrics=str(tmp_path / "f.jsonl"))
    got = [srv.submit(r) for r in stream()]
    _drain(srv)
    failed = [t for t in got if t.status == queue_mod.FAILED]
    assert failed and {t.request.family for t in failed} == {"cadmm4"}
    assert all(t.reason == "device_crash" and t.result is None
               for t in failed)
    journal = RunJournal(run_dir, server_mod.SERVING_JOURNAL).read()
    be = [e for e in journal if e["event"] == "backend_event"]
    assert [(e["kind"], e["rung"]) for e in be] == [
        ("device_crash", backend.RUNG_ONCHIP)]
    assert {e["request_id"] for e in journal
            if e["event"] == "serving_done" and e["status"] == "failed"
            and e["reason"] == "device_crash"} == {
                t.request.request_id for t in failed}
    stats = srv.stats()
    assert (stats["failed"], stats["backend_failures"],
            stats["guard_fallbacks"]) == (len(failed), 1, 0)
    assert set(stats["dispatch_rungs"]) == {backend.RUNG_ONCHIP}
    assert export.validate_file(str(tmp_path / "f.jsonl")) == []
    for t in got:
        if t.status != queue_mod.FAILED:
            assert t.status == queue_mod.COMPLETED
            _same_bits(ref[t.request.request_id].result, t.result)
    again = [srv.submit(ScenarioRequest(
        family=t.request.family, horizon=t.request.horizon,
        x0=t.request.x0, v0=t.request.v0,
        request_id=t.request.request_id + ".retry")) for t in failed]
    _drain(srv)
    for t, old in zip(again, failed):
        assert t.status == queue_mod.COMPLETED
        _same_bits(ref[old.request.request_id].result, t.result)
    resumed = server_mod.ScenarioServer.resume(
        run_dir, families=[families[n] for n in FAMILIES], buckets=BUCKETS,
        device="cpu")
    assert not resumed.has_work()
    assert {t.request.request_id for t in failed} <= resumed.done_requests


def test_serve_entry_and_left_out_options(families, monkeypatch):
    """The serve ladder's eager rung (``eager_cached`` in a process that ran
    no ``nvcc``) with the JAX ladder's ``aot_serve`` fields; nothing to
    serve raises ``missing_entry``; an unreadable bundle directory raises
    ``unreadable`` at construction; ``require_bundle`` without a bundle
    covers no family, so every request is rejected at admission; a mesh
    with device surgery is a ValueError; the server's default device is
    the card, so without one it raises."""
    from tpu_aerial_transport_torch.aot.bundle import BundleError

    rows = []

    class Sink:
        def emit(self, event, **kw):
            rows.append((event, kw))

    out, rung = loader.serve_entry(None, "e", (2, 3),
                                   jit_fallback=lambda a, b: a * b,
                                   metrics=Sink(), label="lbl")
    assert (out, rung) == (6, loader.RUNG_EAGER_CACHED)
    assert rows[0][0] == "aot_serve"
    assert set(rows[0][1]) == {"entry", "rung", "label", "wall_s"}
    with pytest.raises(BundleError, match="no bundle and no fallback"):
        loader.serve_entry(None, "e", ())
    t = _server(families, require_bundle=True).submit(
        _others("cadmm4", 1)[0])
    assert (t.status, t.reason) == (queue_mod.REJECTED,
                                    queue_mod.REASON_NO_COVERAGE)
    with pytest.raises(BundleError) as err:
        _server(families, bundle="/some/bundle")
    assert err.value.kind == "unreadable"
    with pytest.raises(ValueError, match="surgery='device'"):
        _server(families, mesh=object(), surgery="device")
    with pytest.raises(ValueError):
        lanes.resolve_surgery("gpu")
    # The knobs' defaults, with no environment override.
    monkeypatch.setenv("TAT_SERVING_SURGERY", "device")
    monkeypatch.setenv("TAT_SERVING_DISPATCH", "pipelined")
    assert (lanes.resolve_surgery(None), lanes.resolve_surgery("auto"),
            lanes.resolve_dispatch(None), lanes.resolve_dispatch("auto")) \
        == ("host", "host", "sync", "sync")
    if torch.cuda.is_available():
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        server_mod.ScenarioServer()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        batcher.make_family("cadmm4")


def test_journal_lane_map_is_the_jax_servers(families, tmp_path):
    """The port's serving journal rows are JSON the JAX package's reader
    takes as its own: the JAX ``RunJournal`` reads the port's file, and
    each ``serving_batch`` lane map is ``[[lane, request_id,
    remaining], ...]``."""
    from tpu_aerial_transport.resilience.recovery import RunJournal as JJ

    run_dir = str(tmp_path / "run")
    srv = _server(families, ("cadmm4",), run_dir=run_dir)
    for r in _others("cadmm4", 3, horizon=4):
        srv.submit(r)
    _drain(srv)
    rows = JJ(run_dir, server_mod.SERVING_JOURNAL).read()
    assert rows == RunJournal(run_dir, server_mod.SERVING_JOURNAL).read()
    batches = [e for e in rows if e["event"] == "serving_batch"]
    assert batches[0]["lanes"] == [[0, "o0", 1], [1, "o1", 1],
                                   [2, "o2", 1]]
    assert json.loads(json.dumps(batches[-1]))["lanes"] == []
    assert {e["event"] for e in rows} == {"serving_request",
                                          "serving_batch", "serving_done"}


def _example(tmp_path, module, argv, name):
    """Run one serving example in a child process (its SIGTERM is its
    own); returns its summary line."""
    import os
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=repo)
    out = subprocess.run(
        [sys.executable, "-m", f"tpu_aerial_transport_torch.examples.{module}",
         *argv, "--results", str(tmp_path / f"{name}.json")],
        cwd=repo, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("module,argv,after", [
    ("serve_scenarios", ["--requests", "24", "--buckets", "4,8,16"], 1),
    ("serve_sessions", ["--clients", "6", "--steps", "3", "--buckets",
                        "4,8", "--lease-s", "600"], 3),
], ids=["scenarios", "sessions"])
def test_example_preempt_resume_digests(tmp_path, module, argv, after):
    """Each serving example, run with ``--run-dir``, stops on its own
    SIGTERM after a few pump rounds in one process and completes with
    ``--resume`` in another: every per-request (per-step) result digest
    is the uninterrupted run's."""
    argv = argv + ["--device", "cpu"]
    ref = _example(tmp_path, module, argv, "ref")
    run = ["--run-dir", str(tmp_path / "run")]
    pre = _example(tmp_path, module, argv + run + ["--sigterm-after",
                                                   str(after)], "pre")
    assert pre["preempted"]
    _example(tmp_path, module, argv + run + ["--resume"], "res")
    digests = {}
    for name in ("pre", "res"):
        for rid, row in json.loads((tmp_path / f"{name}.json").read_text()
                                   ).items():
            if "digest" in row:
                digests[rid] = row["digest"]
    want = {rid: row["digest"] for rid, row in json.loads(
        (tmp_path / "ref.json").read_text()).items() if "digest" in row}
    assert want and digests == want
    assert ref.get("preempted") is False
