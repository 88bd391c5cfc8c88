"""PyTorch port vs the JAX package: closed-loop session serving
(``tpu_aerial_transport_torch/serving/sessions.py``).

The same scripted client traffic drives the JAX package's ``SessionHost``
(over its ``ScenarioServer`` on the CPU) and the port's (over
``ScenarioServer(device="cpu")``) under one fake clock, at the canonical
``cadmm4`` family with buckets (2, 4) and chunk length 2: every grant,
answer, rejection reason, rung, deadline-miss class, the ``stats()``
counters (evictions, fence and stale rejections, accepted and degraded
steps) and the ``session_event`` kinds are equal exactly; served controls
agree within the states' 1e-4 bar of ``tests/test_torch_serving.py``.
Within the port, bitwise: a session's served control stream against the
offline rollout of the same post-delta state stream, across a preempt and
resume of the server and the session table; and a zombie's fenced step
leaves no row in the journal.
"""

import json
import os

import numpy as np
import pytest
import torch

from tpu_aerial_transport.serving import batcher as jbatcher
from tpu_aerial_transport.serving import server as jserver
from tpu_aerial_transport.serving import sessions as jsessions
from tpu_aerial_transport_torch.obs import export
from tpu_aerial_transport_torch.serving import batcher
from tpu_aerial_transport_torch.serving import queue as queue_mod
from tpu_aerial_transport_torch.serving import server as server_mod
from tpu_aerial_transport_torch.serving import sessions
from tpu_aerial_transport_torch.serving.queue import ScenarioRequest
from tpu_aerial_transport_torch.tree import leaves

BUCKETS = (2, 4)
STATE_KEYS = ("xl", "vl", "Rl", "wl", "R", "w")
STATE_BAR = 1e-4


class FakeInterrupt:
    triggered = None


@pytest.fixture(scope="module")
def fam():
    return batcher.make_family("cadmm4", device="cpu")


@pytest.fixture(scope="module")
def jfam():
    return jbatcher.make_family("cadmm4")


def _server(fam, **kw):
    kw.setdefault("buckets", BUCKETS)
    return server_mod.ScenarioServer(families=[fam], device="cpu", **kw)


def _drain(host):
    while host.pump():
        pass


def _same_bits(a, b):
    la, lb = leaves(a), leaves(b)
    assert len(la) == len(lb) and la
    for x, y in zip(la, lb):
        assert torch.equal(x, y)


class Sink:
    """A metrics sink that records rows and can move the fake clock when
    a given serving event lands (a one-chunk step launches and harvests
    inside one pump, so an in-flight miss needs the clock to move
    mid-pump)."""

    def __init__(self, now):
        self.rows, self.now, self.jump = [], now, None

    def emit(self, event, **kw):
        self.rows.append({"event": event, **kw})
        if self.jump is not None and kw.get("kind") == self.jump[0]:
            self.now[0] = self.jump[1]
            self.jump = None


def _script(mod, host, now, sink):
    """The scripted client traffic (one list of observable answers):
    lease lifecycle (renew, expiry, fence, reconnect), a duplicate open,
    stale and out-of-order steps, served steps of two sessions sharing
    batches, a deadline missed in the queue and one in flight (hold-last),
    a reconnect whose first step misses before it was ever served
    (no_control), and a close."""
    Q = mod["queue"]
    out = []

    def step(sid, lease, seq, dx=(0.01, 0.0, 0.0), **kw):
        t = host.step(sid, lease, seq, dx, (0.0, 0.001, 0.0), **kw)
        return t

    def rec(t):
        out.append((t.request_id, t.status, t.reason, t.rung, t.missed))

    a = host.open("alice", "cadmm4", (0.2, 0.1, 1.0))
    b = host.open("bob", "cadmm4", (0.5, 0.1, 1.0), (0.1, 0.0, 0.0))
    out += [a, b, host.open("x", "martian")]
    served = []
    for s in (1, 2):
        ts = [step("alice", a["lease"], s), step("bob", b["lease"], s)]
        _drain(host)
        for t in ts:
            rec(t)
            served.append(t.result)
    t = step("bob", b["lease"], 2)          # replay.
    rec(t)
    rec(step("bob", b["lease"], 5))         # skipped ahead.
    now[0] = 4.0
    out.append(host.heartbeat("bob", b["lease"]))
    now[0] = 8.0                            # alice silent past her TTL.
    out.append(host.sweep())
    out.append(host.heartbeat("bob", b["lease"]))
    out.append(host.heartbeat("alice", a["lease"]))
    rec(step("alice", a["lease"], 3, (7.7, 7.7, 7.7)))   # the zombie.
    # bob: a miss in the queue, then one in flight.
    t = step("bob", b["lease"], 3, deadline_s=0.5)
    now[0] = 9.0
    _drain(host)
    rec(t)
    out.append(t.result is not None)
    t = step("bob", b["lease"], 4, deadline_s=0.5)
    sink.jump = ("batch_launch", 10.0)
    _drain(host)
    rec(t)
    served.append(t.ticket.result)
    # alice reconnects: a fresh epoch whose first step misses in the
    # queue before any control was served (no_control).
    a2 = host.open("alice", "cadmm4", (0.3, 0.2, 1.0))
    out.append(a2)
    t = step("alice", a2["lease"], 1, deadline_s=0.5)
    now[0] = 11.0
    _drain(host)
    rec(t)
    out.append(t.result is None)
    dup = host.open("bob", "cadmm4", (0.5, 0.1, 1.0))
    out.append(dup)
    out.append(host.heartbeat("bob", b["lease"]))
    out.append(host.close("bob", dup["lease"]))
    out.append(host.close("bob", dup["lease"]))
    out.append(host.stats())
    kinds = [r["kind"] for r in sink.rows if r["event"] == "session_event"]
    assert Q.REASON_LEASE_FENCED in {o[2] for o in out
                                     if isinstance(o, tuple)}
    return out, kinds, served


def test_session_host_matches_jax_under_one_fake_clock(fam, jfam):
    """The scripted traffic through both session hosts: every answer,
    rung, miss class, counter and event kind equal; the served controls
    within the state bar."""
    from tpu_aerial_transport.serving import queue as jqueue

    results = {}
    for name in ("port", "jax"):
        now = [0.0]
        sink = Sink(now)
        if name == "port":
            srv = _server(fam, clock=lambda: now[0], metrics=sink)
            host = sessions.SessionHost(srv, lease_s=5.0)
            mod = {"queue": queue_mod}
        else:
            srv = jserver.ScenarioServer(families=[jfam], buckets=BUCKETS,
                                         clock=lambda: now[0], metrics=sink)
            host = jsessions.SessionHost(srv, lease_s=5.0)
            mod = {"queue": jqueue}
        results[name] = _script(mod, host, now, sink)
    out, kinds, served = results["port"]
    jout, jkinds, jserved = results["jax"]
    assert out == jout
    assert kinds == jkinds
    stats = out[-1]
    assert stats["steps_degraded"] == 3 and stats["evicted"] == 1
    assert stats["fenced_rejections"] == 4
    assert {o[3] for o in out if isinstance(o, tuple) and len(o) == 5} >= {
        sessions.RUNG_SERVED, sessions.RUNG_HOLD_LAST,
        sessions.RUNG_NO_CONTROL}
    for got, ref in zip(served, jserved):
        for k in STATE_KEYS:
            np.testing.assert_allclose(getattr(got, k).numpy(),
                                       np.asarray(getattr(ref, k)),
                                       rtol=0, atol=STATE_BAR)


def test_zombie_fence_leaves_no_journal_row(fam, tmp_path):
    """After eviction the zombie's step is refused before any server
    interaction: no ticket, no journaled ``serving_request``, no
    ``session_step``; a superseded incarnation's in-flight result never
    writes the new incarnation's hold-last state."""
    now = [0.0]
    run_dir = str(tmp_path / "run")
    srv = _server(fam, clock=lambda: now[0], run_dir=run_dir)
    host = sessions.SessionHost(srv, lease_s=5.0)
    alice = host.open("alice", "cadmm4", (0.2, 0.1, 1.0))["lease"]
    a1 = host.step("alice", alice, 1, (0.01, 0.0, 0.0))
    _drain(host)
    assert a1.rung == sessions.RUNG_SERVED
    now[0] = 8.0
    assert host.sweep() == ["alice"]
    zs = host.step("alice", alice, 2, (7.7, 7.7, 7.7))
    assert zs.reason == queue_mod.REASON_LEASE_FENCED
    assert zs.request_id not in srv.tickets and not srv.has_work()
    journal = [json.loads(line) for line in
               open(os.path.join(run_dir, server_mod.SERVING_JOURNAL))]
    assert not any(e.get("event") == "serving_request"
                   and e["request"]["request_id"] == zs.request_id
                   for e in journal)
    assert not any(e.get("event") == "session_step"
                   and e.get("step_seq") == 2 for e in journal)
    l1 = host.open("alice", "cadmm4", (0.3, 0.1, 1.0))["lease"]
    old = host.step("alice", l1, 1, (0.0, 0.0, 0.0))
    host.open("alice", "cadmm4", (0.6, 0.2, 1.0))  # supersedes l1.
    _drain(host)
    assert old.rung == sessions.RUNG_SERVED and old.result is not None
    assert host.sessions["alice"].last_result is None


def _offline(fam, x0, v0, deltas):
    """The offline rollout: the cumulative post-delta states served as
    one-shot requests on a fresh server."""
    srv = _server(fam)
    x, v = np.asarray(x0, np.float64), np.asarray(v0, np.float64)
    tickets = {}
    for s, (dx, dv) in enumerate(deltas, start=1):
        x = x + np.asarray(dx, np.float64)
        v = v + np.asarray(dv, np.float64)
        tickets[s] = srv.submit(ScenarioRequest(
            family="cadmm4", horizon=fam.chunk_len,
            x0=tuple(float(t) for t in x), v0=tuple(float(t) for t in v),
            request_id=f"off{s:03d}"))
    while srv.pump():
        pass
    return {s: t.result for s, t in tickets.items()}


def test_session_stream_bitwise_offline_across_resume(fam, tmp_path):
    """Two sessions sharing batches, a preemption with a step in flight,
    the server and the session table resumed in a new host: the table
    restores exactly (lease, epoch, watermark, float64 state), the
    reattached step serves, and each session's whole served control
    stream is bitwise the offline rollout of its state stream."""
    deltas = {
        "p": [((0.01, -0.005, 0.0), (0.001, 0.0, 0.0)) for _ in range(4)],
        "q": [((-0.02, 0.01, 0.0), (0.0, 0.0, 0.0)) for _ in range(4)],
    }
    x0 = {"p": (0.25, 0.1, 1.0), "q": (0.7, 0.2, 1.1)}
    v0 = {"p": (0.1, 0.0, 0.0), "q": (0.0, 0.1, 0.0)}
    run_dir = str(tmp_path / "run")
    fi = FakeInterrupt()
    srv1 = _server(fam, run_dir=run_dir, interrupt=fi)
    host1 = sessions.SessionHost(srv1, lease_s=1e9)
    leases = {sid: host1.open(sid, "cadmm4", x0[sid], v0[sid])["lease"]
              for sid in deltas}
    served = {sid: {} for sid in deltas}
    for s in (1, 2):
        ts = [host1.step(sid, leases[sid], s, *deltas[sid][s - 1])
              for sid in sorted(deltas)]
        _drain(host1)
        for t in ts:
            assert t.rung == sessions.RUNG_SERVED
            served[t.session_id][s] = t.result
    inflight = {sid: host1.step(sid, leases[sid], 3, *deltas[sid][2])
                for sid in sorted(deltas)}
    fi.triggered = "SIGTERM"
    host1.pump()
    assert srv1.preempted and not any(t.done for t in inflight.values())

    srv2 = server_mod.ScenarioServer.resume(
        run_dir, families=[fam], buckets=BUCKETS, device="cpu")
    host2 = sessions.SessionHost.resume(srv2, lease_s=1e9)
    for sid in deltas:
        sess = host2.sessions[sid]
        assert (sess.lease, sess.epoch, sess.step_seq) == (leases[sid], 0, 3)
        want = np.asarray(x0[sid], np.float64)
        for d in deltas[sid][:3]:
            want = want + np.asarray(d[0], np.float64)
        np.testing.assert_array_equal(sess.x, want)
        assert sess.status == sessions.LIVE
    reattached = {sid: host2._steps[t.request_id]
                  for sid, t in inflight.items()}
    _drain(host2)
    for sid, t in reattached.items():
        assert t.rung == sessions.RUNG_SERVED
        served[sid][3] = t.result
    ts = [host2.step(sid, leases[sid], 4, *deltas[sid][3])
          for sid in sorted(deltas)]
    _drain(host2)
    for t in ts:
        served[t.session_id][4] = t.result
    for sid in deltas:
        ref = _offline(fam, x0[sid], v0[sid], deltas[sid])
        for s in range(1, 5):
            _same_bits(served[sid][s], ref[s])
    assert host2.stats()["steps_degraded"] == 0


def test_failed_step_on_the_card_degrades_to_hold_last(fam, tmp_path):
    """With the card as the guard's primary rung, a step whose chunk fails
    (``crash@2``) resolves ``hold_last`` with the error's kind as its
    reason, counted in ``steps_degraded``; nothing runs on the CPU rung,
    and the next step serves the offline rollout's control (the session's
    state stream is not forked)."""
    from tpu_aerial_transport_torch.resilience import backend

    guard = backend.BackendGuard(
        primary_rung=backend.RUNG_ONCHIP,
        faults=backend.FaultInjector.from_env("crash@2"))
    srv = _server(fam, guard=guard, run_dir=str(tmp_path / "run"))
    host = sessions.SessionHost(srv, lease_s=1e9)
    x0, v0 = (0.4, 0.1, 1.0), (0.0, 0.05, 0.0)
    deltas = [((0.01 * s, 0.0, 0.0), (0.0, 0.0, 0.001)) for s in (1, 2, 3)]
    lease = host.open("s", "cadmm4", x0, v0)["lease"]
    steps = []
    for seq, d in enumerate(deltas, start=1):
        steps.append(host.step("s", lease, seq, *d))
        _drain(host)
    assert [t.rung for t in steps] == [sessions.RUNG_SERVED,
                                      sessions.RUNG_HOLD_LAST,
                                      sessions.RUNG_SERVED]
    assert steps[1].reason == "device_crash" and steps[1].missed is None
    assert host.stats()["steps_degraded"] == 1 and guard.fallbacks == 0
    ref = _offline(fam, x0, v0, deltas)
    _same_bits(steps[0].result, ref[1])
    _same_bits(steps[1].result, ref[1])
    _same_bits(steps[2].result, ref[3])


def test_admission_reject_consumes_nothing(fam, tmp_path):
    """A step refused at admission (queue full) rolls back: the watermark
    and the float64 state are unmoved, nothing is journaled, and the
    retried seq serves the offline rollout's control."""
    run_dir = str(tmp_path / "run")
    srv = _server(fam, capacity=2, run_dir=run_dir)
    host = sessions.SessionHost(srv, lease_s=1e9)
    lease = host.open("s", "cadmm4", (0.4, 0.1, 1.0))["lease"]
    for i in range(2):
        srv.submit(ScenarioRequest(family="cadmm4", horizon=2,
                                   x0=(0.1 * (i + 1), 0.0, 1.0),
                                   request_id=f"fill{i}"))
    t = host.step("s", lease, 1, (0.05, 0.0, 0.0))
    assert (t.status, t.reason) == (queue_mod.REJECTED,
                                    queue_mod.REASON_QUEUE_FULL)
    assert host.sessions["s"].step_seq == 0
    np.testing.assert_array_equal(host.sessions["s"].x,
                                  np.asarray((0.4, 0.1, 1.0), np.float64))
    rows = [json.loads(line) for line in
            open(os.path.join(run_dir, server_mod.SERVING_JOURNAL))]
    assert not any(e.get("event") == "session_step" for e in rows)
    _drain(host)
    retry = host.step("s", lease, 1, (0.05, 0.0, 0.0))
    _drain(host)
    assert retry.rung == sessions.RUNG_SERVED
    _same_bits(retry.result, _offline(
        fam, (0.4, 0.1, 1.0), (0.0, 0.0, 0.0),
        [((0.05, 0.0, 0.0), (0.0, 0.0, 0.0))])[1])


def test_session_steps_never_use_the_result_cache(fam, tmp_path):
    """A session step neither reads nor fills the result cache; a
    one-shot request of the same content still computes."""
    path = str(tmp_path / "m.jsonl")
    srv = _server(fam, cache=8, metrics=path)
    host = sessions.SessionHost(srv, lease_s=1e9)
    lease = host.open("s", "cadmm4", (0.4, 0.1, 1.0))["lease"]
    t = host.step("s", lease, 1, (0.0, 0.0, 0.0))
    _drain(host)
    assert t.rung == sessions.RUNG_SERVED and len(srv.cache) == 0
    one = srv.submit(ScenarioRequest(family="cadmm4", horizon=2,
                                     x0=(0.4, 0.1, 1.0), request_id="one"))
    assert one.status == queue_mod.PENDING
    _drain(host)
    _same_bits(one.result, t.result)
    assert "cache_hit" not in [e.get("kind")
                               for e in export.read_events(path)]


def test_step_rids_and_lease_resolver_match_jax(monkeypatch):
    """Step ids and their strict parse, and the lease TTL resolver (env
    force, config, default, refusals), are the JAX package's."""
    for args in (("c0", 3, 41), ("a.b", 0, 1)):
        rid = sessions._step_rid(*args)
        assert rid == jsessions._step_rid(*args)
        assert sessions.parse_step_rid(rid) == args
    for bad in ("req.solver1", "c0.s000001", "c0.e1.s1", "c0.e.s000001",
                "c0.e1.s0000010x", "warmup"):
        assert sessions.parse_step_rid(bad) is None
        assert jsessions.parse_step_rid(bad) is None
    monkeypatch.delenv("TAT_SESSION_LEASE_S", raising=False)
    for v in (None, 2.5, "7"):
        assert sessions.resolve_lease_s(v) == jsessions.resolve_lease_s(v)
    monkeypatch.setenv("TAT_SESSION_LEASE_S", "0.25")
    assert sessions.resolve_lease_s(60.0) == 0.25
    for bad in ("nope", "-1"):
        monkeypatch.setenv("TAT_SESSION_LEASE_S", bad)
        with pytest.raises(ValueError):
            sessions.resolve_lease_s(None)
        with pytest.raises(ValueError):
            jsessions.resolve_lease_s(None)
