"""PyTorch port vs the JAX package: the serving fleet
(``tpu_aerial_transport_torch/serving/fleet.py``, the harness
``tpu_aerial_transport_torch/tools/fleet_local.py``, the console
``tools/fleet_console.py`` and the ``serve_fleet`` example).

Every test but the last is host logic on fake clocks: it starts no
process, sends no signal and sleeps on no wall clock, so the whole file
costs the tier-1 run a few seconds. The port's classes are held to the
JAX package's own fleet tests (``tests/test_fleet.py``, each one ported
here), and the two packages are driven through the same scripted
sequences and compared exactly -- the supervisor's actions and
``fleet_event`` rows, a front's routing, failovers and retry segments
over a seeded stream, the hash ring, the seeded chaos plans, the request
stream and the result digest are integers, strings and hashes, so
"equal" means equal.

The JAX harness is loaded under its own module name
(``_jax_fleet_local``), never as a bare ``fleet_local`` from a directory
put on ``sys.path``; the port's harness is a package module.

The chaos e2e at the end is marked ``slow``, as the JAX package's is: it
runs the port's harness with ``--device cpu`` in a child process, whose
replicas it reaps in a ``finally``.
"""

from __future__ import annotations

import collections
import contextlib
import importlib.util
import json
import os
import signal
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

from tpu_aerial_transport.serving import fleet as jfleet
from tpu_aerial_transport.serving import queue as jqueue
from tpu_aerial_transport.obs import trace as jtrace
from tpu_aerial_transport_torch.examples import serve_fleet
from tpu_aerial_transport_torch.obs import export as export_mod
from tpu_aerial_transport_torch.obs import trace as trace_mod
from tpu_aerial_transport_torch.serving import fleet as fleet_mod
from tpu_aerial_transport_torch.serving import queue as queue_mod
from tpu_aerial_transport_torch.tools import fleet_console, fleet_local

pytestmark = pytest.mark.fleet

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load_by_path(name: str, rel: str):
    """A JAX-package tool loaded from its file under a module name of its
    own. The tool puts the repository root on ``sys.path`` when it loads;
    the path is restored as found."""
    saved = list(sys.path)
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(REPO, rel))
    mod = importlib.util.module_from_spec(spec)
    try:
        spec.loader.exec_module(mod)
    finally:
        sys.path[:] = saved
    return mod


@pytest.fixture(scope="module")
def jax_harness():
    return _load_by_path("_jax_fleet_local", "tools/fleet_local.py")


class FakeClock:
    def __init__(self, t=0.0):
        self.t = t

    def __call__(self):
        return self.t


def _supervisor(clock, ev, mod=fleet_mod, **kw):
    kw.setdefault("lease_s", 1.0)
    kw.setdefault("boot_grace_s", 10.0)
    return mod.ReplicaSupervisor(
        [0, 1], clock=clock, emit=lambda **f: ev.append(f), **kw
    )


# ---------------------------------------------------------------------
# Replica supervisor: the health machine.
# ---------------------------------------------------------------------

class TestSupervisor:
    def test_heartbeat_brings_starting_up(self):
        clock, ev = FakeClock(), []
        sup = _supervisor(clock, ev)
        assert sup.state(0) == fleet_mod.STARTING
        assert 0 in sup.routable()  # starting IS routable (inbox buffers).
        sup.heartbeat(0)
        assert sup.state(0) == fleet_mod.UP

    def test_missed_leases_suspect_then_down(self):
        clock, ev = FakeClock(), []
        sup = _supervisor(clock, ev)
        sup.heartbeat(0)
        sup.heartbeat(1)
        clock.t = 2.5  # >= 2 missed leases.
        assert sup.tick() == []
        assert sup.state(0) == fleet_mod.SUSPECT
        assert 0 in sup.routable()  # suspect stays routable.
        clock.t = 5.5  # >= 5 missed leases.
        actions = sup.tick()
        assert ("kill", 0) in actions and ("failover", 0) in actions
        assert sup.state(0) == fleet_mod.RESTARTING
        assert 0 not in sup.routable()
        # Both replicas went down in the same tick -- order-independent.
        assert sup.state(1) == fleet_mod.RESTARTING

    def test_restart_spawns_after_backoff_and_recovers(self):
        clock, ev = FakeClock(), []
        sup = _supervisor(clock, ev)
        sup.heartbeat(0)
        clock.t = 6.0
        sup.tick()
        assert sup.state(0) == fleet_mod.RESTARTING
        assert sup.tick() == []  # backoff not elapsed.
        clock.t = 6.0 + sup.backoff.initial_s + 0.01
        acts = [a for a in sup.tick() if a[1] == 0]
        assert ("spawn", 0) in acts
        sup.heartbeat(0)  # the respawn's first pulse.
        assert sup.state(0) == fleet_mod.UP

    def test_exit_notification_declares_down(self):
        clock, ev = FakeClock(), []
        sup = _supervisor(clock, ev)
        sup.heartbeat(0)
        actions = sup.notify_exit(0, returncode=-9)
        assert ("failover", 0) in actions
        assert sup.state(0) == fleet_mod.RESTARTING
        # A second notification for the same death is a no-op.
        assert sup.notify_exit(0, returncode=-9) == []

    def test_boot_deadline_declares_down(self):
        clock, ev = FakeClock(), []
        sup = _supervisor(clock, ev, boot_grace_s=10.0)
        clock.t = 9.0
        assert sup.tick() == []  # still within boot grace.
        clock.t = 10.5
        actions = sup.tick()
        assert ("failover", 0) in actions and ("failover", 1) in actions

    def test_quarantine_after_k_restart_cycles(self):
        clock, ev = FakeClock(), []
        sup = _supervisor(clock, ev, quarantine_after=2)
        for cycle in range(3):
            sup.heartbeat(0)
            assert sup.state(0) == fleet_mod.UP
            actions = sup.notify_exit(0, returncode=1)
            if cycle < 2:
                assert sup.state(0) == fleet_mod.RESTARTING
                clock.t += 100.0
                sup.tick()  # spawn.
            else:
                assert ("quarantine", 0) in actions
        assert sup.state(0) == fleet_mod.QUARANTINED
        assert 0 not in sup.routable()
        # A zombie heartbeat cannot resurrect a quarantined replica.
        sup.heartbeat(0)
        assert sup.state(0) == fleet_mod.QUARANTINED
        assert any(e["kind"] == "quarantine" for e in ev)

    def test_infra_error_kinds_strike_breaker_compile_error_never(self):
        clock, ev = FakeClock(), []
        sup = _supervisor(clock, ev, breaker_threshold=3)
        sup.heartbeat(0)
        sup.heartbeat(1)
        # compile_error is a program bug, not replica sickness: NO
        # number of them may get a healthy replica killed.
        for _ in range(10):
            assert sup.report_error(0, "compile_error", "bad build") == []
        assert sup.state(0) == fleet_mod.UP
        # Infra kinds strike; the third opens the breaker -> down.
        assert sup.report_error(1, "device_crash") == []
        assert sup.report_error(1, "oom") == []
        actions = sup.report_error(1, "wedge_timeout")
        assert ("failover", 1) in actions
        assert sup.state(1) == fleet_mod.RESTARTING

    def test_transitions_emit_seq_ordered_fleet_events(self):
        clock, ev = FakeClock(), []
        sup = _supervisor(clock, ev)
        sup.heartbeat(0)
        clock.t = 6.0
        sup.tick()
        trans = [e for e in ev if e["kind"] == "transition"]
        assert [t["seq"] for t in trans] == sorted(
            t["seq"] for t in trans
        )
        assert trans[0]["from_state"] == fleet_mod.STARTING
        assert trans[0]["to_state"] == fleet_mod.UP
        path = [(t["from_state"], t["to_state"]) for t in trans
                if t["replica"] == 0]
        assert path == [("starting", "up"), ("up", "down"),
                        ("down", "restarting")]
        restart = [e for e in ev if e["kind"] == "restart"]
        assert restart and restart[0]["attempt"] == 1


# ---------------------------------------------------------------------
# Consistent-hash ring.
# ---------------------------------------------------------------------

class TestHashRing:
    def test_deterministic_and_total(self):
        ring = fleet_mod.HashRing([0, 1, 2])
        keys = [f"fam{i}:{b}" for i in range(8) for b in (8, 16, 32)]
        a = [ring.route(k) for k in keys]
        b = [fleet_mod.HashRing([0, 1, 2]).route(k) for k in keys]
        assert a == b
        assert set(a) <= {0, 1, 2}

    def test_node_loss_moves_only_its_keys(self):
        """Removing a replica relocates only the keys it owned: every
        other replica's shape set is undisturbed."""
        ring = fleet_mod.HashRing([0, 1, 2, 3])
        keys = [f"fam{i}:{b}" for i in range(32) for b in (8, 16, 32)]
        full = {k: ring.route(k) for k in keys}
        without_2 = {k: ring.route(k, alive={0, 1, 3}) for k in keys}
        for k in keys:
            if full[k] != 2:
                assert without_2[k] == full[k]
            else:
                assert without_2[k] != 2

    def test_empty_alive_set_returns_none(self):
        ring = fleet_mod.HashRing([0, 1])
        assert ring.route("k", alive=set()) is None


# ---------------------------------------------------------------------
# Chaos plan.
# ---------------------------------------------------------------------

class TestFaultPlan:
    def test_parse_to_spec_roundtrip(self):
        spec = "sigkill@1.5:r0,wedge@2:r1=3,error@2.5:r0=oom"
        plan = fleet_mod.FleetFaultPlan.parse(spec)
        assert plan.to_spec() == spec
        assert fleet_mod.FleetFaultPlan.parse(plan.to_spec()) == plan

    def test_seeded_plans_are_deterministic(self):
        a = fleet_mod.FleetFaultPlan.seeded(7, 3)
        b = fleet_mod.FleetFaultPlan.seeded(7, 3)
        assert a == b and a.actions
        assert fleet_mod.FleetFaultPlan.seeded(8, 3) != a

    def test_due_windows_partition_the_schedule(self):
        plan = fleet_mod.FleetFaultPlan.parse(
            "sigkill@1:r0,wedge@2:r1=3,sigterm@3:r0"
        )
        fired = []
        for lo, hi in [(0, 1.5), (1.5, 2.5), (2.5, 10)]:
            fired += plan.due(lo, hi)
        assert fired == list(plan.actions)

    def test_bad_tokens_raise(self):
        for bad in ("explode@1:r0", "sigkill@x:r0", "sigkill@1:q0"):
            with pytest.raises(ValueError):
                fleet_mod.FleetFaultPlan.parse(bad)

    def test_from_env(self, monkeypatch):
        monkeypatch.setenv(fleet_mod.FLEET_FAULTS_ENV, "sigkill@1:r0")
        plan = fleet_mod.FleetFaultPlan.from_env()
        assert plan.actions[0].action == "sigkill"
        monkeypatch.delenv(fleet_mod.FLEET_FAULTS_ENV)
        assert fleet_mod.FleetFaultPlan.from_env().actions == ()


# ---------------------------------------------------------------------
# Per-tenant admission.
# ---------------------------------------------------------------------

def _req(i, tenant="default", family="f", horizon=4, mod=queue_mod):
    return mod.ScenarioRequest(
        family=family, horizon=horizon, request_id=f"t{i:03d}",
        tenant=tenant,
    )


def _queue(clock, tenants=None, capacity=64, emit=None):
    return queue_mod.AdmissionQueue(
        lambda fam: 2 if fam == "f" else None, capacity=capacity,
        clock=clock, tenants=tenants, emit=emit,
    )


class TestTenantAdmission:
    def test_token_bucket_rejects_structured_and_refills(self):
        clock = FakeClock()
        q = _queue(clock, tenants={
            "burst": queue_mod.TenantPolicy(rate_per_s=1.0, burst=2),
        })
        tickets = [q.submit(_req(i, "burst")) for i in range(3)]
        assert [t.status for t in tickets] == [
            queue_mod.PENDING, queue_mod.PENDING, queue_mod.REJECTED,
        ]
        assert tickets[2].reason == queue_mod.REASON_TENANT_RATE
        clock.t = 1.0  # one token refilled.
        assert q.submit(_req(3, "burst")).status == queue_mod.PENDING
        assert q.submit(_req(4, "burst")).status == queue_mod.REJECTED

    def test_rate_limit_never_masks_malformed_requests(self):
        """Admission order: a malformed request is rejected AS malformed
        and costs the tenant no tokens."""
        clock = FakeClock()
        q = _queue(clock, tenants={
            "burst": queue_mod.TenantPolicy(rate_per_s=0.0, burst=1),
        })
        bad = q.submit(queue_mod.ScenarioRequest(
            family="f", horizon=3, request_id="bad", tenant="burst",
        ))  # horizon off the chunk grid.
        assert bad.reason == queue_mod.REASON_BAD_HORIZON
        # The token survives for a well-formed request.
        assert q.submit(_req(0, "burst")).status == queue_mod.PENDING

    def test_default_tenant_is_unlimited_fifo(self):
        """No policy table: plain FIFO."""
        clock = FakeClock()
        q = _queue(clock)
        ids = [q.submit(_req(i)).request.request_id for i in range(10)]
        taken = [t.request.request_id for t in q.take("f", 10)]
        assert taken == ids

    def test_weighted_fair_dequeue_shares(self):
        clock = FakeClock()
        q = _queue(clock, tenants={
            "heavy": queue_mod.TenantPolicy(weight=3.0),
            "light": queue_mod.TenantPolicy(weight=1.0),
        })
        for i in range(8):
            q.submit(_req(i, "heavy"))
            q.submit(_req(100 + i, "light"))
        taken = q.take("f", 8)
        by_tenant = collections.Counter(t.request.tenant for t in taken)
        assert by_tenant["heavy"] == 6 and by_tenant["light"] == 2

    def test_priority_class_dequeues_strictly_first(self):
        clock = FakeClock()
        q = _queue(clock, tenants={
            "ops": queue_mod.TenantPolicy(priority=1, weight=0.1),
            "batch": queue_mod.TenantPolicy(priority=0, weight=100.0),
        })
        for i in range(3):
            q.submit(_req(i, "batch"))
        for i in range(3):
            q.submit(_req(10 + i, "ops"))
        taken = [t.request.tenant for t in q.take("f", 6)]
        # Priority beats any weight: all ops first.
        assert taken == ["ops"] * 3 + ["batch"] * 3

    def test_tenant_survives_json_roundtrip(self):
        r = _req(0, tenant="pro")
        assert queue_mod.ScenarioRequest.from_json(r.to_json()).tenant \
            == "pro"
        # Default tenant stays off the wire (journal compat).
        assert "tenant" not in _req(1).to_json()

    def test_concurrent_submitters_thread_safety(self, tmp_path):
        """N threads hammering submit: no ticket id collisions, no lost
        rejections, a schema-valid event stream."""
        path = str(tmp_path / "subm.metrics.jsonl")
        writer = export_mod.MetricsWriter(path)
        clock = FakeClock()
        capacity = 40
        q = _queue(
            clock, capacity=capacity,
            emit=lambda **f: writer.emit("serving_event", **f),
        )
        n_threads, per_thread = 8, 10
        tickets: list = [None] * (n_threads * per_thread)
        barrier = threading.Barrier(n_threads)

        def hammer(k):
            barrier.wait()
            for j in range(per_thread):
                # Default-id path: the process-global ticket counter is
                # what must not collide under contention.
                tickets[k * per_thread + j] = q.submit(
                    queue_mod.ScenarioRequest(family="f", horizon=4)
                )

        threads = [threading.Thread(target=hammer, args=(k,))
                   for k in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        ids = [t.request.request_id for t in tickets]
        assert len(set(ids)) == len(ids)  # no ticket id collisions.
        pending = [t for t in tickets if t.status == queue_mod.PENDING]
        rejected = [t for t in tickets if t.status == queue_mod.REJECTED]
        # No lost submissions: capacity admitted, the rest rejected
        # queue_full -- EXACTLY (the lock makes the depth check atomic).
        assert len(pending) == capacity
        assert len(rejected) == n_threads * per_thread - capacity
        assert all(t.reason == queue_mod.REASON_QUEUE_FULL
                   for t in rejected)
        assert q.depth() == capacity
        # Drain sees every admitted ticket exactly once.
        assert len(q.take("f", 1000)) == capacity
        # The event stream stayed schema-valid under contention and
        # recorded every outcome.
        assert export_mod.validate_file(path) == []
        kinds = collections.Counter(
            e["kind"] for e in export_mod.read_events(path))
        assert kinds["submitted"] == capacity
        assert kinds["rejected"] == len(rejected)


# ---------------------------------------------------------------------
# Fleet front: routing + failover + dedup.
# ---------------------------------------------------------------------

class Sink:
    def __init__(self):
        self.rows = []

    def emit(self, event, **kw):
        self.rows.append({"event": event, **kw})


def _front(clock, sent, tracer=None, sink=None, tenants=None,
           replica_ids=(0, 1), mod=fleet_mod, buckets=(4, 8),
           coverage=lambda fam: 2 if fam == "f" else None):
    sup = mod.ReplicaSupervisor(
        list(replica_ids), lease_s=1.0, boot_grace_s=100.0,
        clock=clock, emit=sink,
    )
    for r in replica_ids:
        sup.heartbeat(r)
    front = mod.FleetFront(
        list(replica_ids), coverage,
        send=lambda rid, op: sent.append((rid, op)),
        buckets=buckets, supervisor=sup, clock=clock,
        metrics=sink, tracer=tracer, tenants=tenants,
    )
    return front, sup


class TestFleetFront:
    def test_routing_is_sticky_per_family_bucket(self):
        clock, sent = FakeClock(), []
        front, _ = _front(clock, sent)
        for i in range(3):
            front.submit(_req(i))
        front.pump()
        owners = {op["request"]["request_id"]: rid for rid, op in sent}
        assert len(set(owners.values())) == 1  # one (family,bucket) key.
        # The same group shape routes to the same replica again.
        sent.clear()
        for i in range(10, 13):
            front.submit(_req(i))
        front.pump()
        again = {rid for rid, _ in sent}
        assert again == set(owners.values())

    def test_failover_redispatches_on_same_trace_id(self):
        clock, sent, sink = FakeClock(), [], Sink()
        tracer = trace_mod.Tracer(sink, track="front",
                                  clock_mono=lambda: clock.t)
        front, sup = _front(clock, sent, tracer=tracer, sink=sink)
        for i in range(4):
            front.submit(_req(i))
        front.pump()
        dead = sent[0][0]
        alive = 1 - dead
        trace_ids = {op["request"]["request_id"]: op["request"]["trace_id"]
                     for _, op in sent}
        sup.notify_exit(dead, returncode=-9)
        moved = front.failover(dead)
        assert sorted(moved) == [f"t{i:03d}" for i in range(4)]
        # Re-dispatch went to the healthy replica, SAME trace_id.
        redis = [(rid, op) for rid, op in sent if op["op"] == "submit"
                 and rid == alive]
        assert len(redis) == 4
        for rid, op in redis:
            assert op["request"]["trace_id"] == \
                trace_ids[op["request"]["request_id"]]
        # Best-effort cancels went to the dead replica's inbox.
        cancels = [op for rid, op in sent
                   if rid == dead and op["op"] == "cancel"]
        assert len(cancels) == 4
        fo = [r for r in sink.rows if r.get("kind") == "failover"]
        assert len(fo) == 4
        assert all(r["trace_id"] == trace_ids[r["request_id"]]
                   for r in fo)

    def test_first_result_wins_duplicate_dropped(self):
        clock, sent, sink = FakeClock(), [], Sink()
        front, _ = _front(clock, sent, sink=sink)
        t = front.submit(_req(0))
        front.pump()
        assert front.deliver_result({
            "request_id": "t000", "status": "completed", "digest": "aa",
            "replica": 1,
        })
        assert t.status == queue_mod.COMPLETED and t.result == "aa"
        # The restarted replica re-serves and re-reports: dropped.
        assert not front.deliver_result({
            "request_id": "t000", "status": "completed", "digest": "aa",
            "replica": 0,
        })
        assert t.result == "aa"
        assert front.duplicates and front.stats()[
            "duplicates_dropped"] == 1
        assert any(r.get("kind") == "duplicate_result" for r in sink.rows)

    def test_requests_hold_while_fleet_unroutable(self):
        clock, sent = FakeClock(), []
        front, sup = _front(clock, sent)
        for r in (0, 1):
            sup.notify_exit(r, returncode=1)
        front.submit(_req(0))
        assert front.pump() == 0 and sent == []  # held, not lost.
        sup.heartbeat(0)  # one replica recovers.
        assert front.pump() == 1
        assert sent[0][0] == 0

    def test_tenant_throttle_emits_fleet_event(self):
        clock, sent, sink = FakeClock(), [], Sink()
        front, _ = _front(clock, sent, sink=sink, tenants={
            "burst": queue_mod.TenantPolicy(rate_per_s=0.0, burst=1),
        })
        front.submit(_req(0, tenant="burst"))
        t = front.submit(_req(1, tenant="burst"))
        assert t.status == queue_mod.REJECTED  # structured, no raise.
        throttles = [r for r in sink.rows
                     if r.get("kind") == "tenant_rejected"]
        assert len(throttles) == 1
        assert throttles[0]["tenant"] == "burst"

    def test_failover_retry_segment_lands_on_original_trace(self):
        """After a failover, the request's critical path shows an
        explicit retry segment -- on the ORIGINAL trace_id -- covering
        the re-served window (the front's guard_fallback span stays open
        until completion)."""
        clock, sent = FakeClock(), []
        tracer = trace_mod.Tracer(None, track="front",
                                  clock_mono=lambda: clock.t)
        front, sup = _front(clock, sent, tracer=tracer)
        t = front.submit(_req(0))
        tid = t.request.trace_id
        front.pump()
        dead = sent[0][0]
        clock.t = 5.0
        sup.notify_exit(dead, returncode=-9)
        front.failover(dead)
        # The surviving replica re-serves: its own request/queue spans
        # on the SAME trace (what a real replica's tracer would emit).
        rep = trace_mod.Tracer(None, track="r_alive",
                               clock_mono=lambda: clock.t)
        clock.t = 6.0
        root = rep.begin(trace_mod.REQUEST, parent=None, trace_id=tid,
                         request_id="t000")
        qs = rep.begin(trace_mod.QUEUE_WAIT, parent=root)
        clock.t = 6.5
        rep.end(qs)
        clock.t = 10.0
        rep.end(root, status="completed")
        front.deliver_result({"request_id": "t000",
                              "status": "completed", "digest": "d",
                              "replica": "x"})
        cp = trace_mod.critical_path(tracer.rows + rep.rows)
        mine = [q for q in cp["requests"] if q["trace_id"] == tid]
        assert len(mine) == 1  # deduped: the re-served span won.
        segs = mine[0]["segments"]
        # Window [6.5, 10] is fully inside the open failover span
        # [5, 10] -> the whole re-serve is retry time.
        assert segs["retry"] == pytest.approx(3.5)
        assert segs["batch_wait"] == pytest.approx(0.0)


# ---------------------------------------------------------------------
# Harness pieces (no subprocesses).
# ---------------------------------------------------------------------

class TestHarnessPieces:
    def test_parse_tenants_spec(self):
        policies = fleet_local.parse_tenants(
            "free:rate=2,burst=4;pro:weight=4,priority=1"
        )
        assert policies["free"].rate_per_s == 2.0
        assert policies["free"].burst == 4
        assert policies["pro"].weight == 4.0
        assert policies["pro"].priority == 1
        with pytest.raises(SystemExit):
            fleet_local.parse_tenants("x:bogus=1")

    def test_make_fleet_stream_deterministic(self):
        a = fleet_local.make_fleet_stream(
            8, ["f"], {"f": 2}, ["p", "q"], seed=3
        )
        b = fleet_local.make_fleet_stream(
            8, ["f"], {"f": 2}, ["p", "q"], seed=3
        )
        assert [(r.request_id, r.tenant, r.horizon) for r in a] == \
            [(r.request_id, r.tenant, r.horizon) for r in b]
        assert {r.tenant for r in a} == {"p", "q"}

    def test_bucket_hint_matches_batcher_rule(self):
        from tpu_aerial_transport_torch.serving import batcher

        for pending in (1, 4, 8, 9, 40):
            assert fleet_mod.bucket_hint(pending, (4, 8)) == \
                batcher.bucket_for(pending, (4, 8))


# ---------------------------------------------------------------------
# The port against the JAX package, exactly.
# ---------------------------------------------------------------------

def _supervisor_script(case: str):
    """(constructor kwargs, steps): each step is (clock time, method,
    args); the same steps drive both packages' supervisors."""
    if case == "leases":
        return {}, [
            (0.0, "heartbeat", (0,)), (0.5, "heartbeat", (1,)),
            (2.6, "tick", ()), (3.0, "heartbeat", (0,)),
            (4.0, "tick", ()), (6.0, "tick", ()), (6.6, "tick", ()),
            (7.0, "heartbeat", (1,)), (8.0, "tick", ()),
            (13.5, "tick", ()), (14.2, "tick", ()),
        ]
    if case == "exits":
        return {"quarantine_after": 2}, [
            (0.0, "heartbeat", (0,)), (0.0, "heartbeat", (1,)),
            (1.0, "notify_exit", (0, -9)), (1.0, "notify_exit", (0, -9)),
            (1.2, "tick", ()), (1.6, "tick", ()),
            (2.0, "heartbeat", (0,)), (3.0, "notify_exit", (0, 1)),
            (3.5, "tick", ()), (4.1, "tick", ()),
            (4.5, "heartbeat", (0,)), (5.0, "notify_exit", (0, 1)),
            (5.0, "heartbeat", (0,)), (20.0, "tick", ()),
            (40.0, "tick", ()),
        ]
    return {"breaker_threshold": 2}, [
        (0.0, "heartbeat", (0,)), (0.0, "heartbeat", (1,)),
        (0.5, "report_error", (0, "compile_error", "bad build")),
        (0.6, "report_error", (1, "device_crash", "x" * 400)),
        (0.7, "report_error", (0, "oom", "")),
        (0.8, "report_error", (1, "wedge_timeout", "")),
        (0.9, "report_error", (0, "topology_mismatch", "")),
        (1.0, "tick", ()), (1.6, "tick", ()),
        (2.0, "heartbeat", (1,)), (2.5, "report_error", (1, "oom", "")),
        (3.0, "tick", ()),
    ]


def _run_supervisor(mod, case):
    kw, steps = _supervisor_script(case)
    clock, ev = FakeClock(), []
    sup = _supervisor(clock, ev, mod=mod, **kw)
    trail = []
    for t, method, args in steps:
        clock.t = t
        out = getattr(sup, method)(*args)
        trail.append((method, out,
                      {r: sup.state(r) for r in sup.replicas},
                      sup.routable()))
    return trail, ev


@pytest.mark.parametrize("case", ["leases", "exits", "breaker"])
def test_supervisor_matches_jax(case):
    """One scripted sequence of heartbeats, lease misses, exits and
    classified error kinds: the same actions, states, routable sets and
    ``fleet_event`` rows in both packages."""
    got_trail, got_ev = _run_supervisor(fleet_mod, case)
    ref_trail, ref_ev = _run_supervisor(jfleet, case)
    assert got_trail == ref_trail
    assert got_ev == ref_ev
    assert any(a for _, a, _, _ in got_trail)  # the script did act.


def _front_run(fmod, qmod, tmod, stream, case):
    """A seeded stream through a 3-replica front: admission, routing, a
    replica's death and failover, results delivered on a fake clock
    (with a duplicate). Returns what must match across packages, keyed
    by request id (trace ids are random per process)."""
    clock, sent, sink = FakeClock(), [], Sink()
    tracer = tmod.Tracer(sink, track="front", clock_mono=lambda: clock.t,
                         clock_wall=lambda: clock.t)
    tenants = {"pro": qmod.TenantPolicy(weight=4.0, priority=1),
               "free": qmod.TenantPolicy(rate_per_s=2.0, burst=3),
               "batch": qmod.TenantPolicy(weight=1.0)}
    front, sup = _front(clock, sent, tracer=tracer, sink=sink,
                        tenants=tenants, replica_ids=(0, 1, 2), mod=fmod,
                        buckets=(4, 8), coverage=lambda fam: 2)
    tickets = []
    for i, req in enumerate(stream):
        clock.t = 0.1 * i
        tickets.append(front.submit(req))
        if i % 5 == 4:
            front.pump()
    front.pump()
    owner = dict(front.inflight)
    dead = owner[sorted(owner)[0 if case == "first" else -1]]
    clock.t += 1.0
    sup.notify_exit(dead, returncode=-9)
    moved = front.failover(dead)
    clock.t += 0.5
    for n, rid in enumerate(sorted(front.inflight)):
        clock.t += 0.25
        front.deliver_result({"request_id": rid, "status": "completed",
                              "digest": f"d{n}",
                              "replica": front.inflight[rid]})
    front.deliver_result({"request_id": sorted(owner)[0],
                          "status": "completed", "digest": "late",
                          "replica": dead})
    cp = tmod.critical_path(tracer.rows)
    retry = {q["request_id"]: q["segments"]["retry"]
             for q in cp["requests"]}
    spans = {r["attrs"]["request_id"]: (r["t0_mono"], r["t1_mono"],
                                        r["attrs"]["from_replica"],
                                        r["attrs"]["to_replica"])
             for r in tracer.rows if r["name"] == tmod.GUARD_FALLBACK}

    def strip(op):
        op = dict(op)
        if "request" in op:
            op["request"] = {k: v for k, v in op["request"].items()
                             if k != "trace_id"}
        return op

    events = [{k: v for k, v in r.items() if k not in ("trace_id", "slo")}
              for r in sink.rows if r["event"] in ("fleet_event",
                                                   "serving_event")]
    return {
        "sent": [(rid, strip(op)) for rid, op in sent],
        "owner": owner, "dead": dead, "moved": moved,
        "status": [(t.request.request_id, t.status, t.reason, t.result)
                   for t in tickets],
        "retry": retry, "fallback_spans": spans,
        "events": events, "stats": front.stats(),
    }


@pytest.mark.parametrize("seed,case", [(0, "first"), (3, "last"),
                                       (11, "last")])
def test_front_dispatch_and_failover_match_jax(jax_harness, seed, case):
    """A seeded mixed-tenant stream through both packages' fronts: the
    replica each request is dispatched to, the failover targets, the
    cancels, the fleet and serving rows, the statuses and each failed-
    over request's retry segment (its ``guard_fallback`` span) are
    equal."""
    lens = {"cadmm4": 2, "centralized4": 2}
    tenants = ["batch", "free", "pro"]
    fams = ["cadmm4", "centralized4"]
    got = _front_run(fleet_mod, queue_mod, trace_mod,
                     fleet_local.make_fleet_stream(24, fams, lens, tenants,
                                                   seed), case)
    ref = _front_run(jfleet, jqueue, jtrace,
                     jax_harness.make_fleet_stream(24, fams, lens, tenants,
                                                   seed), case)
    assert got == ref
    assert got["moved"] and any(v > 0 for v in got["retry"].values())


@pytest.mark.parametrize("alive", [None, {0, 1, 3}, {1, 2}, {4}])
def test_hash_ring_routes_match_jax(alive):
    """``HashRing.route`` over 1,000 keys on five nodes, with nodes
    removed: every key lands on the same node in both packages."""
    keys = [f"fam{i % 7}:{8 << (i % 4)}:{i}" for i in range(1000)]
    ring, jring = fleet_mod.HashRing(range(5)), jfleet.HashRing(range(5))
    got = [ring.route(k, alive) for k in keys]
    assert got == [jring.route(k, alive) for k in keys]
    assert len(set(got)) == (5 if alive is None else len(alive))


@pytest.mark.parametrize("seed,n,kw", [
    (0, 2, {}), (7, 3, {}), (19, 4, {"n_faults": 6, "t_span": 12.0}),
    (5, 3, {"kinds": ("sigkill", "sigterm", "wedge", "error", "slow")}),
])
def test_seeded_fault_plans_match_jax(seed, n, kw):
    """``FleetFaultPlan.seeded`` draws the same storm as the JAX
    package's and prints the same spec, which each parses back."""
    got = fleet_mod.FleetFaultPlan.seeded(seed, n, **kw)
    ref = jfleet.FleetFaultPlan.seeded(seed, n, **kw)
    assert got.to_spec() == ref.to_spec()
    assert [dataclass_tuple(a) for a in got.actions] == \
        [dataclass_tuple(a) for a in ref.actions]
    assert jfleet.FleetFaultPlan.parse(got.to_spec()).to_spec() == \
        fleet_mod.FleetFaultPlan.parse(ref.to_spec()).to_spec()


def dataclass_tuple(action):
    return (action.t_s, action.replica, action.action, action.arg)


@pytest.mark.parametrize("seed,families", [
    (0, ["cadmm4", "centralized4"]), (5, ["cadmm4"])])
def test_fleet_stream_matches_jax(jax_harness, seed, families):
    """``make_fleet_stream`` gives the JAX harness's requests, field for
    field on the wire."""
    lens = {"cadmm4": 2, "centralized4": 2}
    tenants = ["batch", "free", "pro"]
    got = fleet_local.make_fleet_stream(48, families, lens, tenants, seed)
    ref = jax_harness.make_fleet_stream(48, families, lens, tenants, seed)
    assert [r.to_json() for r in got] == [r.to_json() for r in ref]


Result = collections.namedtuple("Result", ["xl", "R", "iters", "alive"])


def _numpy_leaves(seed: int):
    rng = np.random.default_rng(seed)
    return {"xl": rng.normal(size=(3,)).astype(np.float32),
            "R": rng.normal(size=(4, 3, 3)).astype(np.float32),
            "iters": rng.integers(0, 50, size=(5,)).astype(np.int32),
            "alive": rng.random(4) > 0.5}


@pytest.mark.parametrize("container", ["dict", "namedtuple"])
def test_result_digest_matches_jax(container):
    """The same numpy leaves, as torch tensors in the port and as arrays
    in the JAX package, digest to the same sha256, in a dict (keys
    sorted) and in a namedtuple (fields in order); a changed bit changes
    it."""
    a = _numpy_leaves(0)
    wrap = (dict if container == "dict" else lambda **kw: Result(**kw))
    ref = jfleet.result_digest(wrap(**a))
    got = fleet_mod.result_digest(
        wrap(**{k: torch.from_numpy(v) for k, v in a.items()}))
    assert got == ref
    a["R"][1, 2, 0] = np.nextafter(a["R"][1, 2, 0], np.float32(1))
    assert fleet_mod.result_digest(
        wrap(**{k: torch.from_numpy(v) for k, v in a.items()})) != ref


def test_console_frame_matches_jax(tmp_path, monkeypatch, capsys):
    """``fleet_console --once --json`` on the same metrics files renders
    the JAX console's frame."""
    path = str(tmp_path / "r0.metrics.jsonl")
    w = export_mod.MetricsWriter(path, meta={"replica": 0})
    for i in range(12):
        w.emit("serving_event", kind="submitted", request_id=f"q{i}",
               family="cadmm4", tenant="pro" if i % 3 else "free")
        w.emit("serving_event", kind="completed" if i % 4 else "rejected",
               request_id=f"q{i}", family="cadmm4",
               tenant="pro" if i % 3 else "free",
               reason="tenant_rate_limited",
               slo={"t_submit": 0.0, "t_admit": 0.01 * i,
                    "t_complete": 0.05 * i, "deadline_missed": False})
    assert fleet_console.main([str(tmp_path), "--once", "--json"]) in (0, 1)
    got = json.loads(capsys.readouterr().out)
    jconsole = _load_by_path("_jax_fleet_console", "tools/fleet_console.py")
    monkeypatch.setattr(sys, "argv", ["fleet_console", str(tmp_path),
                                      "--once", "--json"])
    jconsole.main()
    ref = json.loads(capsys.readouterr().out)
    assert got == ref
    assert got["windows"] and got["groups"]


def test_read_new_lines_holds_back_a_torn_tail(tmp_path):
    """The harness's channel reader returns only newline-terminated rows
    and resumes at the first byte it has not returned."""
    path = str(tmp_path / "outbox.jsonl")
    export_mod.jsonl_append(path, {"request_id": "a"})
    with open(path, "a") as fh:
        fh.write('{"request_id": "b"')
    rows, off = fleet_local._read_new_lines(path, 0)
    assert rows == [{"request_id": "a"}]
    with open(path, "a") as fh:
        fh.write("}\n")
    rows, off2 = fleet_local._read_new_lines(path, off)
    assert rows == [{"request_id": "b"}] and off2 == os.path.getsize(path)
    assert fleet_local._read_new_lines(str(tmp_path / "none"), 7) == ([], 7)


def test_harness_defaults_to_the_card(tmp_path):
    """The harness and the example serve on the card unless asked for
    the CPU; on a host with no card they raise before any replica
    starts, and never carry on on the CPU."""
    args = fleet_local.build_parser().parse_args(
        ["--out-dir", str(tmp_path / "fleet")])
    assert args.device == "cuda"
    if torch.cuda.is_available():
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        fleet_local.run_fleet(args)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve_fleet.main(["--out-dir", str(tmp_path / "demo"),
                          "--force-multi"])
    assert not os.path.exists(tmp_path / "fleet")  # no replica started.


def test_too_few_cores_is_a_skip_on_the_cpu_and_an_error_on_the_card(
        monkeypatch, capsys, tmp_path):
    """On a 1-core host a multi-replica run skips with a written reason
    only with ``--device cpu``; asked for the card it is an error, never
    a skip that exits 0."""
    monkeypatch.setattr(os, "cpu_count", lambda: 1)
    out = str(tmp_path / "x")
    assert fleet_local.main(["--replicas", "2", "--out-dir", out]) == 2
    assert "1-core host" in json.loads(capsys.readouterr().err)["error"]
    assert fleet_local.main(["--replicas", "2", "--device", "cpu",
                             "--out-dir", out]) == 0
    assert "1-core host" in json.loads(capsys.readouterr().out)["skipped"]
    assert serve_fleet.main(["--out-dir", out]) == 2
    assert serve_fleet.main(["--device", "cpu", "--out-dir", out]) == 0
    assert not os.path.exists(out)


# ---------------------------------------------------------------------
# Chaos acceptance e2e (subprocess; slow).
# ---------------------------------------------------------------------

@pytest.mark.slow
def test_chaos_storm_digests_match_fault_free_run(tmp_path):
    """Under a fault plan that SIGKILLs one replica mid-batch and wedges
    the other, the fleet exits 0, every request completes with a digest
    equal to the fault-free run's, nothing is lost or double-completed,
    every result comes from a replica on the requested device, and the
    killed replica's requests, re-served elsewhere, carry a failover
    retry segment on their original trace_id."""
    out_dirs = [str(tmp_path / "fault_free"), str(tmp_path / "storm")]

    def reap_replicas() -> None:
        """Kill any replica process a run under ``out_dirs`` left
        behind. A replica leads its own process group; it is signalled
        only while its pid still runs this harness's worker on that
        directory."""
        deadline = time.monotonic() + 10.0
        for out in out_dirs:
            for i in range(8):
                path = os.path.join(out, f"r{i}", "replica.metrics.jsonl")
                if not os.path.exists(path):
                    continue
                pids = {row["pid"] for row in export_mod.jsonl_read(path)
                        if row.get("event") == "run_start"}
                for pid in pids:
                    while True:
                        try:
                            with open(f"/proc/{pid}/cmdline", "rb") as fh:
                                cmd = fh.read().decode(errors="replace")
                        except OSError:
                            break  # gone.
                        if "fleet_local" not in cmd or out not in cmd:
                            break  # the pid now belongs to someone else.
                        if time.monotonic() > deadline:
                            with contextlib.suppress(OSError):
                                os.killpg(pid, signal.SIGKILL)
                            break
                        time.sleep(0.2)  # its orphan watchdog may end it.

    def run(out, chaos=""):
        cmd = [
            sys.executable, "-m", fleet_local.WORKER_MODULE,
            "--device", "cpu", "--replicas", "2", "--force-multi",
            "--requests", "8", "--buckets", "2,4",
            "--out-dir", str(tmp_path / out),
            "--results", str(tmp_path / f"{out}.json"),
            "--timeout", "300", "--seed", "5",
        ] + (["--chaos", chaos, "--lease", "1.0"] if chaos else [])
        proc = subprocess.run(
            cmd, capture_output=True, text=True, cwd=REPO, timeout=420,
        )
        assert proc.returncode == 0, proc.stdout + proc.stderr
        summary = json.loads(proc.stdout.strip().splitlines()[-1])
        with open(tmp_path / f"{out}.json") as fh:
            results = json.load(fh)
        return summary, results

    try:
        base_summary, base = run("fault_free")
        assert base_summary["ok"] and not base_summary["unresolved"]

        chaos_summary, chaos = run("storm",
                                   chaos="sigkill@0.1:r1,wedge@0.05:r0=2")
    finally:
        reap_replicas()
    assert chaos_summary["ok"], chaos_summary
    # No request lost or double-completed.
    assert not chaos_summary["unresolved"]
    assert chaos_summary["completed"] == 8

    # Bit-identical to the uninterrupted run: same ids, same digests,
    # every result from a replica on the CPU.
    assert set(base) == set(chaos)
    for rid in base:
        assert base[rid]["status"] == chaos[rid]["status"] == "completed"
        assert base[rid]["digest"] == chaos[rid]["digest"], rid
        assert chaos[rid]["device"] == "cpu"

    # The killed replica's requests re-served elsewhere show the
    # failover as an explicit retry segment on their ORIGINAL trace_id,
    # on the timeline of the replica whose result counted.
    events = export_mod.read_events(chaos_summary["metrics"])
    failed_over = {e["request_id"]: e["trace_id"] for e in events
                   if e.get("event") == "fleet_event"
                   and e.get("kind") == "failover"}
    rows = trace_mod.trace_rows(events)
    for rid, tid in failed_over.items():
        winner = chaos[rid]["replica"]
        if winner == 1:
            continue  # served by the killed replica before it died.
        cp = trace_mod.critical_path(trace_mod.stitch(
            [r for r in rows if r.get("track") in ("front", f"r{winner}")]))
        retry = [q["segments"]["retry"] for q in cp["requests"]
                 if q["trace_id"] == tid]
        assert retry and retry[0] > 0, (rid, retry)
    # The supervisor observed the kill and restarted the replica, whose
    # second process came up and exited cleanly.
    kinds = collections.Counter(e["kind"] for e in events
                                if e.get("event") == "fleet_event")
    assert kinds["transition"] >= 3
    assert kinds["restart"] >= 1
    procs = chaos_summary["processes"]["1"]
    assert len(procs) == 2 and procs[0]["rc"] == -signal.SIGKILL
    assert procs[1]["rc"] == 0 and procs[1]["boot_s"] is not None
