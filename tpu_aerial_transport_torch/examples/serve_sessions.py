"""Closed-loop session demo and acceptance script on the card: an
interactive-session storm through the session tier
(``tpu_aerial_transport_torch/serving/sessions.py``).

The port's counterpart of ``examples/serve_sessions.py``. Seeded clients
each open a leased session and stream per-step state deltas; every
accepted step is served as one chunk-length internal request and resolves
with an honest rung. ``--silent-after N`` silences client c0 so its lease
expires and the sweep evicts it; ``--zombie`` has it retry its old lease
(structured ``lease_fenced`` rejections, never a lane write) and then
re-open; ``--offline-check`` replays every served step's post-delta state
as a one-shot request and compares digests (exit 5 on a mismatch);
``--run-dir D`` with SIGTERM (or ``--sigterm-after N``) then ``--resume``
restores the session table from the journal and completes the storm.

A live metrics hub (``obs.live.MetricsHub``) follows the whole storm and
its snapshot rides the summary (``hub``). With ``--metrics`` the SLO pass
replays the run's journal through ``obs.live.SLOEngine`` after the run,
journals every alert transition back into the same file, puts
``slo_firing`` and ``slo_alerts`` into the summary, and exits 6 when an
alert is still firing at the end (a nominal storm fires none).

It takes the JAX example's flags but ``--bundle``, ``--require-bundle`` and
``--expect-zero-compile`` (the AOT bundles are not ported yet), and
``--device`` (default ``cuda``; ``cpu`` runs the plain PyTorch path).

Usage:
  python3 -m tpu_aerial_transport_torch.examples.serve_sessions \
      --clients 4 --steps 3
  python3 -m tpu_aerial_transport_torch.examples.serve_sessions \
      --clients 4 --lease-s 0.5 --silent-after 1 --zombie \
      --expect-evicted 1 --expect-fenced 2
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

from tpu_aerial_transport_torch import resolve_device
from tpu_aerial_transport_torch.examples.serve_scenarios import (
    result_digest,
)


def client_plan(i: int, steps: int, seed: int):
    """Deterministic per-client state plan: x0/v0 plus one (dx, dv)
    delta per step. Same seed => same plan, so a resumed storm and the
    offline replay reconstruct the identical state stream."""
    rng = np.random.default_rng(seed + 1000 * i)
    x0 = (0.3 * i + 0.1, 0.1, 1.0)
    v0 = (0.1, 0.0, 0.0)
    deltas = []
    for _ in range(steps):
        deltas.append((
            tuple(float(v) for v in rng.normal(0, 0.05, 3)),
            tuple(float(v) for v in rng.normal(0, 0.01, 3)),
        ))
    return x0, v0, deltas


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--clients", type=int, default=4)
    ap.add_argument("--steps", type=int, default=3,
                    help="control steps per client")
    ap.add_argument("--family", default="cadmm4")
    ap.add_argument("--buckets", default="4,8")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--lease-s", type=float, default=None,
                    help="session lease TTL (default: resolver — "
                         "TAT_SESSION_LEASE_S else 30)")
    ap.add_argument("--deadline-s", type=float, default=None,
                    help="per-step deadline SLO (missed steps resolve "
                         "at the hold_last rung, never raise)")
    ap.add_argument("--silent-after", type=int, default=0,
                    help="client c0 goes silent after this step: its "
                         "lease expires and the sweep evicts it")
    ap.add_argument("--zombie", action="store_true",
                    help="the silenced client retries its OLD lease "
                         "(fenced rejections), then re-opens and "
                         "serves one step under the fresh lease")
    ap.add_argument("--offline-check", action="store_true",
                    help="replay served steps as one-shot requests and "
                         "compare digests; exit 5 on any mismatch")
    ap.add_argument("--expect-evicted", type=int, default=-1,
                    help="exit 4 unless exactly N sessions evicted")
    ap.add_argument("--expect-fenced", type=int, default=-1,
                    help="exit 4 unless exactly N fenced rejections")
    ap.add_argument("--run-dir", default="")
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--metrics", default="")
    ap.add_argument("--trace", default="",
                    help="write a Chrome/Perfetto trace (session-step "
                         "spans over the per-request spans)")
    ap.add_argument("--results", default="",
                    help="write per-step {request_id: {rung, digest}} "
                         "JSON")
    ap.add_argument("--sigterm-after", type=int, default=0,
                    help="test hook: raise SIGTERM in-process after N "
                         "pump rounds")
    ap.add_argument("--max-rounds", type=int, default=2000,
                    help="hang guard on the pump loop")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    from tpu_aerial_transport_torch.obs import live as live_mod
    from tpu_aerial_transport_torch.resilience.recovery import (
        GracefulInterrupt,
    )
    from tpu_aerial_transport_torch.serving import batcher
    from tpu_aerial_transport_torch.serving import queue as queue_mod
    from tpu_aerial_transport_torch.serving import server as server_mod
    from tpu_aerial_transport_torch.serving import sessions as sessions_mod

    t0 = time.perf_counter()
    buckets = tuple(int(b) for b in args.buckets.split(",") if b)
    chunk_len = batcher.CANONICAL_FAMILIES[args.family].chunk_len
    tracer = None
    if args.trace:
        from tpu_aerial_transport_torch.obs import export as export_mod
        from tpu_aerial_transport_torch.obs import trace as trace_lib

        sink = (export_mod.MetricsWriter(args.metrics)
                if args.metrics else None)
        tracer = trace_lib.Tracer(sink, track="server")
    # Live metrics hub: in-process counters, gauges and latency histograms
    # over the whole storm; the final snapshot rides the summary JSON.
    hub = live_mod.MetricsHub()
    kw = dict(
        families=[args.family], buckets=buckets,
        run_dir=args.run_dir or None,
        metrics=(tracer.sink if tracer is not None and tracer.sink
                 else args.metrics or None),
        tracer=tracer, hub=hub, device=device,
    )

    plans = {f"c{i}": client_plan(i, args.steps, args.seed)
             for i in range(args.clients)}
    rounds = [0]
    state = {"preempted": False}

    def pump_until(host, done):
        """Pump until ``done()`` (bounded); honors SIGTERM/preemption."""
        while not done():
            more = host.pump()
            rounds[0] += 1
            if args.sigterm_after and rounds[0] == args.sigterm_after:
                os.kill(os.getpid(), 15)  # GracefulInterrupt handles it.
            if host.server.preempted:
                state["preempted"] = True
                return False
            if rounds[0] >= args.max_rounds:
                raise SystemExit(
                    f"serve_sessions: stalled after {rounds[0]} rounds")
            if not more and not done():
                return False  # server idle but predicate unmet.
        return True

    digests = {}    # request_id -> digest of SERVED step results.
    results = {}    # request_id -> {status, rung, ...} for --results.
    zombie_log = {}

    def note(step):
        row = {"status": step.status}
        if step.rung:
            row["rung"] = step.rung
        if step.reason:
            row["reason"] = step.reason
        if step.missed:
            row["missed"] = step.missed
        if (step.rung == sessions_mod.RUNG_SERVED
                and step.result is not None):
            d = result_digest(step.result)
            row["digest"] = d
            digests[step.request_id] = d
        results[step.request_id] = row

    with GracefulInterrupt() as interrupt:
        if args.resume:
            server = server_mod.ScenarioServer.resume(
                args.run_dir, **{k: v for k, v in kw.items()
                                 if k != "run_dir"})
            server.interrupt = interrupt
            host = sessions_mod.SessionHost.resume(
                server, lease_s=args.lease_s,
                step_deadline_s=args.deadline_s)
            # Resolve whatever the crash left in flight, then continue
            # each live session from its restored watermark.
            reattached = list(host._steps.values())
            pump_until(host, lambda: not host.server.has_work()
                       and not host._steps)
            for t in reattached:
                if t.done:
                    note(t)
        else:
            server = server_mod.ScenarioServer(interrupt=interrupt, **kw)
            host = sessions_mod.SessionHost(
                server, lease_s=args.lease_s,
                step_deadline_s=args.deadline_s)
            # Warm the chunk (the kernels' load, the substeps' graph
            # capture) BEFORE any lease starts ticking.
            warm = server.submit(queue_mod.ScenarioRequest(
                family=args.family, horizon=chunk_len,
                x0=(0.05, 0.05, 1.0), request_id="warmup"))
            pump_until(host, lambda: warm.done)

        leases = {}
        for sid, (x0, v0, _deltas) in plans.items():
            sess = host.sessions.get(sid)
            if args.resume and sess is not None:
                if sess.status == sessions_mod.LIVE:
                    leases[sid] = sess.lease
                continue  # evicted/closed incarnations stay down.
            grant = host.open(sid, args.family, x0, v0,
                              deadline_s=args.deadline_s)
            if grant["ok"]:
                leases[sid] = grant["lease"]

        # The storm: one step per live client per round, heartbeats
        # between steps, c0 silent past --silent-after.
        for s in range(1, args.steps + 1):
            if state["preempted"]:
                break
            batch = []
            for sid in sorted(leases):
                if (args.silent_after and sid == "c0"
                        and s > args.silent_after):
                    continue
                sess = host.sessions.get(sid)
                if sess is None or sess.status != sessions_mod.LIVE:
                    continue
                if sess.step_seq >= s:
                    continue  # restored watermark already past here.
                dx, dv = plans[sid][2][s - 1]
                batch.append(host.step(sid, leases[sid], s, dx, dv))
            pump_until(host,
                       lambda: all(t.done for t in batch))
            for t in batch:
                if t.done:
                    note(t)
            for sid in sorted(leases):
                if (args.silent_after and sid == "c0"
                        and s > args.silent_after):
                    continue
                if sid in host.sessions and \
                        host.sessions[sid].status == sessions_mod.LIVE:
                    host.heartbeat(sid, leases[sid])

        # Eviction: let c0's lease TTL lapse while the HEALTHY clients
        # keep heartbeating (real wall time — the lease clock is the
        # server's monotonic clock), so the sweep evicts exactly the
        # silent one.
        evicted_ids = []
        if (args.silent_after and not state["preempted"]
                and "c0" in host.sessions
                and host.sessions["c0"].status == sessions_mod.LIVE):
            deadline = time.perf_counter() + 3 * host.lease_s + 1.0
            while (host.sessions["c0"].status == sessions_mod.LIVE
                   and time.perf_counter() < deadline):
                time.sleep(min(0.25, host.lease_s / 4))
                for sid in sorted(leases):
                    if sid == "c0":
                        continue
                    if host.sessions[sid].status == sessions_mod.LIVE:
                        host.heartbeat(sid, leases[sid])
                host.sweep()  # heartbeat() sweeps too; this is a floor.
            evicted_ids = [
                sid for sid, s in host.sessions.items()
                if s.status == sessions_mod.EVICTED
            ]

        if (args.zombie and not state["preempted"]
                and "c0" in host.sessions
                and host.sessions["c0"].status == sessions_mod.EVICTED):
            stale = host.sessions["c0"].lease
            hb = host.heartbeat("c0", stale)
            zs = host.step("c0", stale, 1, (0.0,) * 3, (0.0,) * 3)
            zombie_log = {
                "stale_lease": stale,
                "heartbeat": hb.get("reason"),
                "step": zs.reason,
            }
            note(zs)
            # Reconnect: fresh lease, reset watermark — and it serves.
            x0, v0, deltas = plans["c0"]
            grant = host.open("c0", args.family, x0, v0,
                              deadline_s=args.deadline_s)
            if grant["ok"]:
                leases["c0"] = grant["lease"]
                dx, dv = deltas[0]
                rz = host.step("c0", grant["lease"], 1, dx, dv)
                pump_until(host, lambda: rz.done)
                if rz.done:
                    note(rz)
                zombie_log["reconnect_lease"] = grant["lease"]
                zombie_log["reconnect_rung"] = rz.rung

        # Drain stragglers (degraded steps resolve here too), then
        # close the surviving sessions gracefully — no lease is left to
        # lapse into a spurious eviction during the offline replay.
        if not state["preempted"]:
            pump_until(host, lambda: not host.server.has_work()
                       and not host._steps)
            for sid in sorted(leases):
                sess = host.sessions.get(sid)
                if sess is not None and sess.status == sessions_mod.LIVE:
                    host.close(sid, sess.lease)

        # Lane-independence proof: the served stream equals the offline
        # rollout of the same state stream. Reuses the same server;
        # one-shot requests, distinct batch composition.
        offline = {"checked": 0, "mismatches": []}
        if args.offline_check and not state["preempted"]:
            # Group the SERVED step rids by (session, seq): every
            # incarnation replays the same plan from its x0 (open()
            # resets state), so each epoch's step s has the same
            # post-delta state — and each served rid gets checked.
            served_rids: dict[tuple[str, int], list[str]] = {}
            for rid in digests:
                parsed = sessions_mod.parse_step_rid(rid)
                if parsed is not None:
                    sid, _epoch, seq = parsed
                    served_rids.setdefault((sid, seq), []).append(rid)
            checks = {}
            for sid, (x0, v0, deltas) in plans.items():
                x = np.asarray(x0, dtype=np.float64)
                v = np.asarray(v0, dtype=np.float64)
                for s, (dx, dv) in enumerate(deltas, start=1):
                    x = x + np.asarray(dx, dtype=np.float64)
                    v = v + np.asarray(dv, dtype=np.float64)
                    for rid in served_rids.get((sid, s), ()):
                        checks[rid] = server.submit(
                            queue_mod.ScenarioRequest(
                                family=args.family, horizon=chunk_len,
                                x0=tuple(float(val) for val in x),
                                v0=tuple(float(val) for val in v),
                                request_id=f"off.{rid}"))
            pump_until(host,
                       lambda: all(t.done for t in checks.values()))
            for rid, t in checks.items():
                offline["checked"] += 1
                if (t.result is None
                        or result_digest(t.result) != digests[rid]):
                    offline["mismatches"].append(rid)

    # SLO pass: replay this run's journal through the burn-rate engine and
    # journal fire/resolve transitions back into the same metrics file (the
    # v9 ``alert`` events), so a post-hoc reader sees the alert trail. An
    # alert still firing at the end of the run exits 6.
    slo_summary = {}
    if args.metrics and os.path.exists(args.metrics):
        from tpu_aerial_transport_torch.obs import export as export_mod

        engine = live_mod.SLOEngine(
            metrics=export_mod.MetricsWriter(args.metrics))
        replica = live_mod.FleetTailer.replica_of(args.metrics)
        for event in export_mod.read_events(args.metrics):
            engine.ingest(replica, event)
        engine.evaluate()
        slo_summary = {
            "slo_firing": sorted(f"{n}/{t}" for n, t in engine.firing),
            "slo_alerts": len(engine.alerts),
        }

    if device.type == "cuda":
        torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    if args.results:
        with open(args.results, "w") as fh:
            json.dump(results, fh, indent=1, sort_keys=True)
    trace_summary = {}
    if tracer is not None and tracer.rows:
        trace_lib.write_chrome_trace(
            args.trace, trace_lib.stitch(tracer.rows))
        trace_summary = {"trace": args.trace,
                         "trace_spans": len(tracer.rows)}
    sstats = host.stats()
    summary = {
        "mode": "resume" if args.resume else "eager",
        "preempted": state["preempted"],
        "wall_s": round(wall_s, 3),
        "pump_rounds": rounds[0],
        "clients": args.clients,
        "steps_per_client": args.steps,
        "evicted_now": evicted_ids,
        **{f"session_{k}": v for k, v in sstats.items()},
        **({"zombie": zombie_log} if zombie_log else {}),
        **({"offline_check": offline} if args.offline_check else {}),
        **trace_summary,
        **slo_summary,
        "hub": hub.snapshot(),
        **({"card": torch.cuda.get_device_name(device)}
           if device.type == "cuda" else {}),
    }
    print(json.dumps(summary), flush=True)
    if args.expect_evicted >= 0 and \
            sstats["evicted"] != args.expect_evicted:
        print(f"serve_sessions: evicted {sstats['evicted']} != "
              f"expected {args.expect_evicted}", file=sys.stderr)
        return 4
    if args.expect_fenced >= 0 and \
            sstats["fenced_rejections"] != args.expect_fenced:
        print(f"serve_sessions: fenced {sstats['fenced_rejections']} != "
              f"expected {args.expect_fenced}", file=sys.stderr)
        return 4
    if args.offline_check and offline["mismatches"]:
        print(f"serve_sessions: served stream NOT bitwise equal to "
              f"offline rollout: {offline['mismatches']}",
              file=sys.stderr)
        return 5
    if (args.offline_check and not state["preempted"] and digests
            and offline["checked"] == 0):
        # A check that silently covered nothing is a failed check, not
        # a pass (e.g. the served rid shape drifted from the replay's).
        print("serve_sessions: offline check matched ZERO served steps",
              file=sys.stderr)
        return 5
    if slo_summary.get("slo_firing"):
        print(f"serve_sessions: SLO alerts still firing at end of run: "
              f"{slo_summary['slo_firing']}", file=sys.stderr)
        return 6
    return 0


if __name__ == "__main__":
    sys.exit(main())
