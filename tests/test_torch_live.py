"""PyTorch port vs the JAX package: the live metrics hub, the jsonl tailers,
the rolling windows and the SLO engine (``obs/live.py``, stdlib-only in
both packages), and the hub fed by the port's serving tier.

One seeded event stream under one fake clock (every event's ``ts`` a wall
epoch from a counter, every alert pass at a given ``now``) goes through
both packages' ``obs/live.py``: the histogram buckets, the hub's snapshot,
the window sums and rates and the alert fire/resolve sequences are equal
exactly -- the modules do the same integer and float arithmetic in the same
order. The tailers follow the port's ``obs/export.py`` jsonl through a torn
tail, a rotation and a resume from saved offsets. A real ``MetricsHub`` on
the port's ``AdmissionQueue``, ``ScenarioServer`` (with its guard and serve
ladder) and ``SessionHost`` on the CPU counts what their journal holds;
``hub=None`` allocates nothing per request.
"""

import gc
import json
import os
import random

import pytest

from tpu_aerial_transport.obs import export as jexport
from tpu_aerial_transport.obs import live as jlive
from tpu_aerial_transport_torch.obs import export
from tpu_aerial_transport_torch.obs import live
from tpu_aerial_transport_torch.resilience import backend
from tpu_aerial_transport_torch.serving import queue as queue_mod
from tpu_aerial_transport_torch.serving import server as server_mod
from tpu_aerial_transport_torch.serving import sessions as sessions_mod
from tpu_aerial_transport_torch.serving.queue import ScenarioRequest

BASE = 1_700_000_000.0  # the fake clock's wall-epoch origin.
TENANTS = ("pro", "free")
FAMILIES = ("cadmm4", "centralized4")
SEEDS = (0, 1, 2)


def _stream(seed: int, seconds: int = 900):
    """A seeded serving and session event stream over ``seconds`` of the
    fake clock: a calm first third (one event in 200 a miss, a rejection
    or a degraded step), a storm of them for the pro tenant in the second
    (half its events), calm again in the last, so alerts fire and resolve.
    Latencies log-normal, with zeros and a negative."""
    rng = random.Random(seed)
    out = []
    for sec in range(seconds):
        storm = seconds // 3 <= sec < 2 * seconds // 3
        for _ in range(rng.randint(0, 3)):
            ts = BASE + sec + rng.random()
            tenant = rng.choice(TENANTS)
            family = rng.choice(FAMILIES)
            rid = f"r{len(out)}"
            bad = rng.random() < (0.5 if storm and tenant == "pro"
                                  else 0.005)
            kind = rng.choice(
                ("deadline_missed", "rejected", "step_degraded") if bad
                else ("submitted", "completed", "completed", "cache_hit",
                      "batch_boundary", "step_done"))
            lat = rng.choice((0.0, -1.0, rng.lognormvariate(-3.0, 1.5)))
            ev = {"schema": 9, "ts": ts, "kind": kind, "request_id": rid,
                  "tenant": tenant, "family": family}
            if kind.startswith("step_"):
                ev.update(event="session_event", rung=rng.choice(
                    ("served", "hold_last")), slo={"latency_s": lat})
            else:
                ev.update(event="serving_event", depth=rng.randint(0, 9))
                if kind in ("completed", "deadline_missed"):
                    ev["slo"] = {"latency_s": lat}
                if kind == "rejected":
                    ev["reason"] = rng.choice(("queue_full", "rate_limited"))
                if kind == "batch_boundary":
                    ev["occupancy"] = rng.random()
            out.append(ev)
    return out


def _hubs_fed(seed):
    """Both packages' hubs fed the same stream, primitives and ingestors."""
    hubs = (jlive.MetricsHub(), live.MetricsHub())
    rng = random.Random(seed + 100)
    for ev in _stream(seed):
        x = rng.random()
        for hub in hubs:
            if ev["event"] == "session_event":
                hub.ingest_session(ev)
            else:
                hub.ingest_serving(ev)
            hub.ingest_backend({"kind": ev["kind"]})
            hub.ingest_aot({"rung": "eager", "wall_s": x})
            hub.inc("custom", key=ev["tenant"], n=x)
            hub.gauge("custom.gauge", x, key=ev["family"])
            hub.observe("custom.hist", x - 0.25)
    return hubs


@pytest.mark.parametrize("seed", SEEDS)
def test_histogram_buckets_match_jax(seed):
    """Every latency of the stream (zeros and a negative among them) in
    both packages' ``LogHistogram``: equal buckets, quantiles and
    threshold counts, merged halves equal to the whole."""
    lats = [ev["slo"]["latency_s"] for ev in _stream(seed) if "slo" in ev]
    hs = (jlive.LogHistogram(), live.LogHistogram())
    for v in lats:
        for h in hs:
            h.add(v)
    assert hs[0].to_dict() == hs[1].to_dict()
    for q in (0.5, 0.9, 0.99, 1.0):
        assert hs[0].quantile(q) == hs[1].quantile(q)
    for thr in (0.0, 0.01, 0.05, 1.0):
        assert hs[0].count_above(thr) == hs[1].count_above(thr)
    half = len(lats) // 2
    a, b = live.LogHistogram(), live.LogHistogram()
    for v in lats[:half]:
        a.add(v)
    for v in lats[half:]:
        b.add(v)
    merged = b.merge(a).to_dict()
    whole = hs[1].to_dict()
    assert {k: merged[k] for k in ("counts", "n", "zero")} == {
        k: whole[k] for k in ("counts", "n", "zero")}
    assert live.LogHistogram.from_dict(whole).to_dict() == whole


@pytest.mark.parametrize("seed", SEEDS)
def test_hub_snapshot_matches_jax(seed):
    """The hubs' snapshots (counters, gauges, histogram summaries and raw
    buckets) are equal after the same stream."""
    j, t = _hubs_fed(seed)
    snap = t.snapshot()
    assert snap == j.snapshot()
    assert snap["counters"]["serving.events{submitted}"] > 0
    assert snap["histograms"]["session.step_latency_s{served}"]["count"] > 0


@pytest.mark.parametrize("seed", SEEDS)
def test_rolling_windows_match_jax(seed):
    """Both packages' ``RollingWindows`` over the stream: equal groups,
    window sums (per tenant and all) and derived rates at several
    windows and fake-clock instants."""
    ws = (jlive.RollingWindows(horizon_s=600), live.RollingWindows(
        horizon_s=600))
    for i, ev in enumerate(_stream(seed)):
        for w in ws:
            w.ingest(f"r{i % 2}", ev)
    assert ws[0].groups() == ws[1].groups()
    assert ws[0].latest_ts == ws[1].latest_ts
    for now in (None, BASE + 450.5, BASE + 899.0):
        for win in (1, 10, 60, 300):
            for tenant in (None,) + TENANTS:
                cj, hj = ws[0].window(win, now=now, tenant=tenant)
                ct, ht = ws[1].window(win, now=now, tenant=tenant)
                assert cj == ct and hj.to_dict() == ht.to_dict()
            assert ws[0].rates(win, now=now) == ws[1].rates(win, now=now)


@pytest.mark.parametrize("seed", SEEDS)
def test_alert_sequences_match_jax(seed, tmp_path):
    """The stream fed second by second into both packages' ``SLOEngine``
    (the default SLOs and a parsed latency SLO on short windows), one
    alerting pass a fake-clock minute: the same fire/resolve transitions
    at every pass, the same burn rates and snapshots, and the same
    ``alert`` trail journaled through each package's ``MetricsWriter``
    (schema-valid); the storm fires and the calm resolves."""
    spec = "p90:step_latency:0.9:threshold_s=0.2:fast_window_s=60:" \
           "slow_window_s=300"
    engines = []
    for mod, exp, name in ((jlive, jexport, "j"), (live, export, "t")):
        specs = tuple(mod.DEFAULT_SLOS) + (
            mod.parse_slo_spec(spec),
            mod.SLOSpec(name="misses", metric="deadline_miss",
                        objective=0.99, fast_window_s=60,
                        slow_window_s=300))
        engines.append(mod.SLOEngine(
            specs, metrics=exp.MetricsWriter(str(tmp_path / f"{name}.jsonl")),
            burn_rates=(14.4, 6.0)))
    events = _stream(seed)
    passes = [[], []]
    k = 0
    for minute in range(1, 16):
        end = BASE + 60 * minute
        while k < len(events) and events[k]["ts"] < end:
            for e in engines:
                e.ingest(f"r{k % 2}", events[k])
            k += 1
        for i, e in enumerate(engines):
            passes[i].append(e.evaluate(now=end))
            assert e.burn_rates(now=end) == engines[0].burn_rates(now=end)
    assert passes[0] == passes[1]
    kinds = [a["kind"] for a in engines[1].alerts]
    assert "fire" in kinds and "resolve" in kinds
    assert engines[0].alerts == engines[1].alerts
    assert engines[0].snapshot() == engines[1].snapshot()
    assert engines[0].max_burn() == engines[1].max_burn()
    trail = []
    for name in ("j", "t"):
        path = str(tmp_path / f"{name}.jsonl")
        trail.append([{k: v for k, v in e.items() if k != "schema"}
                      for e in export.read_events(path)])
    assert trail[0] == trail[1] and len(trail[1]) == len(engines[1].alerts)
    assert export.validate_file(str(tmp_path / "t.jsonl")) == []


def test_knob_resolvers_and_spec_grammar_match_jax(monkeypatch):
    """The burn-rate and refresh resolvers and the SLO spec grammar: the
    same values and the same refusals in both packages."""
    for mod in (jlive, live):
        monkeypatch.delenv("TAT_SLO_BURN_RATES", raising=False)
        monkeypatch.delenv("TAT_CONSOLE_REFRESH_S", raising=False)
        assert mod.resolve_burn_rates() == (14.4, 6.0)
        assert mod.resolve_burn_rates((10, 3)) == (10.0, 3.0)
        assert mod.resolve_refresh_s() == 1.0
        monkeypatch.setenv("TAT_SLO_BURN_RATES", "20:5")
        monkeypatch.setenv("TAT_CONSOLE_REFRESH_S", "2.5")
        assert mod.resolve_burn_rates((10, 3)) == (20.0, 5.0)
        assert mod.resolve_refresh_s(4) == 2.5
        monkeypatch.setenv("TAT_SLO_BURN_RATES", "20")
        with pytest.raises(ValueError, match="FAST:SLOW"):
            mod.resolve_burn_rates()
        for bad in ("x:step_latency", "x:nope:0.9", "x:rejection:1.5",
                    "x:step_latency:0.9", "x:rejection:0.9:color=red"):
            with pytest.raises(ValueError):
                mod.parse_slo_spec(bad)
    spec = "p99:step_latency:0.99:threshold_s=0.5:tenant=pro:fast_burn=3"
    assert (live.parse_slo_spec(spec).__dict__
            == jlive.parse_slo_spec(spec).__dict__)


# ------------------------------------------------------ the tailers --

def test_tailer_holds_back_a_torn_tail(tmp_path):
    """A writer caught mid-line on the port's jsonl never yields a phantom
    event: the unterminated tail stays buffered until its newline lands;
    a torn interior line is skipped, as ``jsonl_read`` skips it."""
    path = str(tmp_path / "r0.metrics.jsonl")
    w = export.MetricsWriter(path)
    w.emit("serving_event", kind="submitted", request_id="a", ts=BASE)
    with open(path, "a") as fh:
        fh.write('{"event": "serving_event", "kind": "compl')
    t = live.JsonlTailer(path)
    assert [e["request_id"] for e in t.poll()] == ["a"]
    assert t.poll() == []
    with open(path, "a") as fh:
        fh.write('eted", "request_id": "b"}\n{"torn\n')
    w.emit("serving_event", kind="completed", request_id="c", ts=BASE + 1)
    assert [e["request_id"] for e in t.poll()] == ["b", "c"]
    assert [e["request_id"] for e in export.read_events(path)] == [
        "a", "b", "c"]


def test_tailer_rotation_reopens_from_the_top(tmp_path):
    """A new file at the path (a new inode) or a file shorter than the
    offset restarts the tailer from byte 0."""
    path = str(tmp_path / "r0.metrics.jsonl")
    w = export.MetricsWriter(path)
    for i in range(3):
        w.emit("serving_event", kind="submitted", request_id=f"o{i}",
               ts=BASE + i)
    t = live.JsonlTailer(path)
    assert len(t.poll()) == 3
    side = str(tmp_path / "side.jsonl")
    export.MetricsWriter(side).emit("serving_event", kind="submitted",
                                    request_id="fresh", ts=BASE + 5)
    os.replace(side, path)
    assert [e["request_id"] for e in t.poll()] == ["fresh"]
    with open(path, "w") as fh:
        fh.write(json.dumps({"event": "serving_event",
                             "request_id": "tiny"}) + "\n")
    assert [e["request_id"] for e in t.poll()] == ["tiny"]


def test_fleet_tailer_resumes_from_offsets(tmp_path):
    """A console stopped mid-stream and a new one resumed from its byte
    offsets: together they read the finished files once, as post-hoc
    ``read_events`` does, across two replicas (one booting late)."""
    paths = [str(tmp_path / f"r{i}.metrics.jsonl") for i in range(2)]
    ws = [export.MetricsWriter(p) for p in paths]
    for i in range(4):
        ws[0].emit("serving_event", kind="submitted", request_id=f"a{i}",
                   ts=BASE + i)
    first = live.FleetTailer([str(tmp_path)])
    got = first.poll()
    offsets = first.offsets()
    for i in range(3):
        ws[0].emit("serving_event", kind="completed", request_id=f"a{i}",
                   ts=BASE + 10 + i)
        ws[1].emit("session_event", kind="step_done", request_id=f"b{i}",
                   ts=BASE + 10 + i)
    resumed = live.FleetTailer([str(tmp_path)], offsets=offsets)
    got += resumed.poll()
    by = {r: [e for rr, e in got if rr == r] for r in ("r0", "r1")}
    assert by["r0"] == export.read_events(paths[0])
    assert by["r1"] == export.read_events(paths[1])
    assert resumed.poll() == []
    assert live.FleetTailer.replica_of(paths[1]) == "r1"


# --------------------------------------- the hub on the serving tier --

def _count(events, event, key="kind", where=None):
    out = {}
    for e in events:
        if e.get("event") == event and (where is None or where(e)):
            k = e.get(key)
            out[k] = out.get(k, 0) + 1
    return out


def test_hub_on_the_serving_tier_counts_the_journal(tmp_path):
    """A real ``MetricsHub`` on a CPU ``ScenarioServer`` (its queue, its
    guard under ``crash@2`` and its serve ladder) and a ``SessionHost``:
    the hub's counters equal a recount from the metrics journal -- every
    serving and session event kind, submissions by tenant, rejections by
    reason, guarded runs and ladder serves, backend events by kind -- and
    its latency histograms hold every completed request and served
    step."""
    path = str(tmp_path / "r0.metrics.jsonl")
    hub = live.MetricsHub()
    guard = backend.BackendGuard(
        faults=backend.FaultInjector.from_env("crash@2"))
    srv = server_mod.ScenarioServer(
        families=["cadmm4"], buckets=(2, 4), capacity=4, metrics=path,
        guard=guard, hub=hub, device="cpu")
    assert srv.queue.hub is hub and guard.hub is hub
    tickets = [srv.submit(ScenarioRequest(
        family="cadmm4", horizon=2 * (1 + i % 2), x0=(0.1 * i, 0.0, 1.0),
        tenant=TENANTS[i % 2], request_id=f"q{i}")) for i in range(6)]
    srv.run_until_drained()
    host = sessions_mod.SessionHost(srv, lease_s=600.0)
    leases = [host.open(f"s{i}", "cadmm4", (0.2 * i, 0.1, 1.0))["lease"]
              for i in range(2)]
    steps = [host.step(f"s{i}", lease, 1, (0.01, 0.0, 0.0), (0.0,) * 3)
             for i, lease in enumerate(leases)]
    while not all(s.done for s in steps):
        host.pump()
    for i, lease in enumerate(leases):
        host.close(f"s{i}", lease)
    assert [t.status for t in tickets].count(queue_mod.REJECTED) == 2
    events = export.read_events(path)
    c = hub.snapshot()["counters"]

    def hub_counts(name):
        pre = name + "{"
        return {k[len(pre):-1]: v for k, v in c.items()
                if k.startswith(pre)}

    serving = _count(events, "serving_event")
    assert hub_counts("serving.events") == serving
    # Four admitted requests and the two session steps (each served as an
    # internal request) complete.
    assert serving["completed"] == 6 and serving["rejected"] == 2
    assert hub_counts("queue.submitted") == _count(
        events, "serving_event", "tenant",
        lambda e: e["kind"] == "submitted")
    assert hub_counts("queue.rejected") == _count(
        events, "serving_event", "reason",
        lambda e: e["kind"] == "rejected")
    assert hub_counts("session.events") == _count(events, "session_event")
    serves = _count(events, "aot_serve", "rung")
    assert hub_counts("aot.serves") == serves
    # One ladder serve a guarded run: the injected crash fails its run
    # before the serve, whose CPU-rung rerun serves once.
    assert guard.fallbacks == 1
    assert c["guard.runs"] == sum(serves.values())
    assert hub_counts("backend.events") == _count(events, "backend_event")
    assert hub_counts("backend.events") == {"device_crash": 1}
    hists = hub.snapshot()["histograms"]
    assert sum(h["count"] for k, h in hists.items()
               if k.startswith("serving.latency_s")) == serving["completed"]
    assert hists["session.step_latency_s{served}"]["count"] == 2


def test_hub_none_allocates_nothing_per_request():
    """``hub=None``: the queue's submit, take and deadline paths allocate
    no ``obs.live`` object (counted on the gc heap), and the hub stays
    None."""
    q = queue_mod.AdmissionQueue(lambda fam: 4, capacity=8, hub=None)
    gc.collect()
    types = (live.MetricsHub, live.LogHistogram)
    before = sum(type(o) in types for o in gc.get_objects())
    for i in range(16):
        q.submit(ScenarioRequest(family="f", horizon=4,
                                 deadline_s=0.0 if i % 3 else None))
    q.take("f", 16)
    q.expire_deadlines()
    gc.collect()
    assert q.hub is None
    assert sum(type(o) in types for o in gc.get_objects()) == before


def test_queue_hub_counts_match_jax_queue():
    """The same submissions through both packages' ``AdmissionQueue``
    with a hub each: equal counters and gauges."""
    from tpu_aerial_transport.serving import queue as jqueue

    snaps = []
    for qmod, lmod in ((jqueue, jlive), (queue_mod, live)):
        hub = lmod.MetricsHub()
        q = qmod.AdmissionQueue(lambda fam: 4, capacity=3, hub=hub,
                                clock=lambda: 0.0)
        for i in range(5):
            q.submit(qmod.ScenarioRequest(
                family="f", horizon=4 if i != 2 else 3,
                tenant=TENANTS[i % 2], request_id=f"x{i}"))
        q.take("f", 2)
        snaps.append(hub.snapshot())
    assert snaps[0] == snaps[1]
    assert snaps[1]["counters"]["queue.dequeued{f}"] == 2
