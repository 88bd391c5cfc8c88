#!/usr/bin/env python3
"""Run-health summary from a flight-recorder metrics jsonl.

The port's counterpart of the JAX package's ``tools/run_health.py``, on
the port's ``obs.export``, ``obs.live`` and ``obs.trace``. Both packages
write metrics schema 9 (``obs/export.py``), so it reads the files either
writes. Renders the schema-versioned event log
(``resilience.recovery.run_chunks(metrics=...)`` chunk boundaries and
their resume/retry/preemption events, ``parallel.pods`` per-process
files, the backend guard's ``backend_event`` rows, ``serving/`` request,
batch, session and fleet rows, the SLO engine's ``alert`` rows,
``aot.loader`` ``aot_serve`` rows, ``obs.trace`` ``trace_event`` rows, and
on-demand ``obs.export.rollout_metrics``) as operator-facing tables:
fallback-rung distribution, consensus-residual percentiles, safety-margin
minima, chunk wall-times, the serving SLOs, the critical path and the
backend's health -- "is this fleet healthy and where is the time going"
without re-running the workload.

Usage:
  python -m tpu_aerial_transport_torch.tools.run_health RUN.metrics.jsonl [--json]
  python -m tpu_aerial_transport_torch.tools.run_health --validate \\
      artifacts/*.metrics.jsonl
  python -m tpu_aerial_transport_torch.tools.run_health \\
      artifacts/fleet-torch-local/ --follow --window 60

``--validate`` only schema-checks the files (the ``tools/ci_check.py``
gate); exit 1 on any violation. ``--follow`` switches to the live
tailer (``obs.live``): paths may be directories scanned for
``*.metrics.jsonl``, and one rolling per-tenant rate table over the
trailing ``--window`` seconds redraws every refresh
(TAT_CONSOLE_REFRESH_S) -- ``fleet_console`` is the full multi-window +
SLO view; this is the single-window vitals line. The tool reads files
and computes nothing on a device.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from tpu_aerial_transport_torch.obs import export as export_mod
from tpu_aerial_transport_torch.obs import live as live_mod
from tpu_aerial_transport_torch.obs import trace as trace_lib

# AOT serve rungs that mean the serving process compiled: the JAX
# package's ``jit_*`` rungs, and the port's ``eager_cold`` (the process ran
# ``nvcc``; ``aot/loader.py``).
COMPILED_RUNGS = ("jit_", "eager_cold")

RUNG_LABELS = ("0 clean", "1 retry", "2 hold", "3 equilibrium")


def _percentile(xs: list[float], p: float) -> float:
    xs = sorted(xs)
    k = min(len(xs) - 1, max(0, round(p * (len(xs) - 1))))
    return xs[k]


def summarize(events: list[dict]) -> dict:
    """Aggregate a run's events into the summary dict the tables render."""
    chunks = [e for e in events if e.get("event") == "chunk"]
    out: dict = {
        "events": {},
        "run_start": next(
            (e for e in events if e.get("event") == "run_start"), None
        ),
    }
    for e in events:
        k = e.get("event", "?")
        out["events"][k] = out["events"].get(k, 0) + 1

    # The telemetry accumulator is cumulative: the LAST chunk's telemetry
    # block is the whole-run summary. rollout_summary events carry their
    # own exact digests.
    tel = next(
        (e["telemetry"] for e in reversed(chunks)
         if e.get("telemetry")), None,
    )
    if tel is None:
        tel = next(
            (e["telemetry"] for e in reversed(events)
             if e.get("event") == "rollout_summary" and e.get("telemetry")),
            None,
        )
    out["telemetry"] = tel

    # Exact per-chunk / rollout log digests, summed.
    digests = [e["logs"] for e in chunks if e.get("logs")] + [
        e["logs"] for e in events
        if e.get("event") == "rollout_summary" and e.get("logs")
    ]
    if digests:
        agg = {
            "steps": sum(d["steps"] for d in digests),
            "rung_hist": [
                sum(d["rung_hist"][i] for d in digests) for i in range(4)
            ],
            "min_env_dist": min(d["min_env_dist"] for d in digests),
            "collision_steps": sum(d["collision_steps"] for d in digests),
            "quarantined_final": digests[-1].get("quarantined_final", 0),
            "residual_max": max(
                (d["residual"]["max"] for d in digests
                 if d["residual"].get("max") is not None),
                default=None,
            ),
        }
        out["logs"] = agg

    if chunks:
        walls = [e["wall_s"] for e in chunks]
        out["chunks"] = {
            "count": len(chunks),
            "wall_s_total": sum(walls),
            "wall_s_mean": sum(walls) / len(walls),
            "wall_s_p50": _percentile(walls, 0.5),
            "wall_s_max": max(walls),
            "retries": sum(e.get("retries", 0) for e in chunks),
        }
    out["interruptions"] = [
        {k: e.get(k) for k in ("event", "chunk", "start_chunk", "signal",
                               "attempt", "error") if k in e}
        for e in events
        if e.get("event") in ("retry", "resume", "preempted")
    ]
    cells = [e for e in events if e.get("event") == "bench_cell"]
    if cells:
        out["bench_cells"] = {e["cell"]: e["value"] for e in cells}
        # Compile-cost column (plain v2 bench_cell fields, no schema
        # bump): first-call wall time — compile + warmup — per cell.
        compile_cost = {
            e["cell"]: e["value"]["compile_wall_s"]
            for e in cells
            if isinstance(e.get("value"), dict)
            and e["value"].get("compile_wall_s") is not None
        }
        if compile_cost:
            out["compile_cost"] = compile_cost

    # AOT serve ladder (schema v3): which rung every served entrypoint
    # call landed on — bundle_exec/bundle_export are precompiled,
    # jit_cached/jit_cold mean the process is still paying compiles.
    aserves = [e for e in events if e.get("event") == "aot_serve"]
    if aserves:
        rungs_by_entry: dict[str, dict[str, int]] = {}
        for e in aserves:
            per = rungs_by_entry.setdefault(e.get("entry", "?"), {})
            r = e.get("rung", "?")
            per[r] = per.get(r, 0) + 1
        out["aot"] = {
            "serves": len(aserves),
            "rungs_by_entry": rungs_by_entry,
            "compiled_in_process": sum(
                1 for e in aserves
                if str(e.get("rung", "")).startswith(COMPILED_RUNGS)
            ),
            "wall_s_total": sum(
                e.get("wall_s", 0.0) for e in aserves
                if isinstance(e.get("wall_s"), (int, float))
            ),
        }

    # Serving tier (schema v4): request/batch lifecycle from serving/.
    # DEDUP RULE (the topology-table rule below, request-side): metrics
    # files APPEND across --resume / re-measured runs, so the same
    # request_id can carry several terminal events and the same
    # (batch_id, chunk) several boundaries — aggregate per identity with
    # the LAST event winning, or re-runs skew every percentile row.
    sevents = [e for e in events if e.get("event") == "serving_event"]
    if sevents:
        kinds: dict[str, int] = {}
        for e in sevents:
            k = e.get("kind", "?")
            kinds[k] = kinds.get(k, 0) + 1
        # Terminal outcome per request: last completed/rejected/
        # deadline_missed event wins (a resume legitimately re-resolves
        # a restored request; only its final resolution counts).
        terminal: dict[str, dict] = {}
        for e in sevents:
            if e.get("kind") in ("completed", "rejected",
                                 "deadline_missed"):
                terminal[e.get("request_id", "?")] = e
        completed = [e for e in terminal.values()
                     if e.get("kind") == "completed"]
        lat = [e["slo"]["latency_s"] for e in completed
               if isinstance(e.get("slo"), dict)
               and "latency_s" in e["slo"]]
        a2c = [e["slo"]["admit_to_complete_s"] for e in completed
               if isinstance(e.get("slo"), dict)
               and "admit_to_complete_s" in e["slo"]]
        rejections: dict[str, int] = {}
        for e in terminal.values():
            if e.get("kind") == "rejected":
                r = e.get("reason", "?")
                rejections[r] = rejections.get(r, 0) + 1
        misses: dict[str, int] = {}
        for e in terminal.values():
            if e.get("kind") == "deadline_missed":
                m = e.get("missed", "?")
                misses[m] = misses.get(m, 0) + 1
        # One boundary per (batch_id, chunk), last wins.
        bound_by_id: dict[tuple, dict] = {}
        for e in sevents:
            if e.get("kind") == "batch_boundary":
                bound_by_id[(e.get("batch_id"), e.get("chunk"))] = e
        bounds = list(bound_by_id.values())
        occ = [e["occupancy"] for e in bounds
               if isinstance(e.get("occupancy"), (int, float))]
        batches: dict = {}
        for e in sevents:
            if e.get("kind") == "batch_launch":
                batches[e.get("batch_id")] = {
                    "family": e.get("family"), "bucket": e.get("bucket"),
                    "rungs": {},
                }
        for e in bounds:
            b = batches.setdefault(
                e.get("batch_id"), {"family": e.get("family"),
                                    "bucket": None, "rungs": {}},
            )
            r = e.get("rung", "?")
            b["rungs"][r] = b["rungs"].get(r, 0) + 1
        # Result-cache effectiveness (schema v7, serving/cache.py):
        # hit rate over all submit-side outcomes — a cache_hit resolves
        # at submit INSTEAD of a "submitted" event, so the denominator is
        # their sum, not a subset.
        cache_hits = kinds.get("cache_hit", 0)
        cache_lookups = cache_hits + kinds.get("submitted", 0)
        out["serving"] = {
            "kinds": kinds,
            "completed": len(completed),
            "rejections": rejections,
            "deadline_misses": misses,
            "latency_s": _latency_stats(lat),
            "admit_to_complete_s": _latency_stats(a2c),
            "mean_occupancy": (sum(occ) / len(occ)) if occ else None,
            "cache_hits": cache_hits,
            "cache_hit_rate": (cache_hits / cache_lookups
                               if cache_lookups else None),
            "batches": batches,
        }

    # Serving fleet (schema v6): replica lifecycle + failover +
    # per-tenant admission from serving/fleet.py. Same append-mode dedup
    # discipline as the serving section: transitions dedup per
    # (replica, seq) and failovers per request_id, LAST event wins (a
    # restarted storm re-appends; only the final record counts).
    fevents = [e for e in events if e.get("event") == "fleet_event"]
    if fevents:
        kinds = {}
        for e in fevents:
            k = e.get("kind", "?")
            kinds[k] = kinds.get(k, 0) + 1
        trans_by_id: dict[tuple, dict] = {}
        hb: dict[str, int] = {}
        restarts: dict[str, int] = {}
        quarantined: list = []
        fail_by_req: dict[str, dict] = {}
        throttled: dict[str, int] = {}
        for e in fevents:
            k = e.get("kind")
            rep = str(e.get("replica", "?"))
            if k == "transition":
                trans_by_id[(rep, e.get("seq"))] = e
            elif k == "heartbeat":
                hb[rep] = hb.get(rep, 0) + 1
            elif k == "restart":
                restarts[rep] = max(restarts.get(rep, 0),
                                    e.get("attempt", 0))
            elif k == "quarantine":
                quarantined.append(rep)
            elif k == "failover":
                fail_by_req[e.get("request_id", "?")] = e
            elif k == "tenant_rejected":
                t = str(e.get("tenant", "?"))
                throttled[t] = throttled.get(t, 0) + 1
        transitions = sorted(
            trans_by_id.values(),
            key=lambda e: (e.get("seq") is None, e.get("seq")),
        )
        fail_lat = [e["latency_s"] for e in fail_by_req.values()
                    if isinstance(e.get("latency_s"), (int, float))]
        # Per-tenant admission ledger from the serving_event stream
        # (tenant is an additive field): admits per submitted event,
        # terminal outcomes deduped per request_id (last wins).
        tenant_term: dict[str, dict] = {}
        tenants: dict[str, dict] = {}
        seen_submit: set = set()
        for e in sevents:
            t = e.get("tenant")
            if t is None:
                continue
            row = tenants.setdefault(str(t), {
                "submitted": 0, "completed": 0, "rejected": 0,
                "throttled": 0, "latency": [],
            })
            if e.get("kind") == "submitted":
                # Dedup per request_id: the front, the owning replica,
                # a failover re-dispatch and a resume each re-emit the
                # submit — one logical admission.
                rid = e.get("request_id")
                if rid not in seen_submit:
                    seen_submit.add(rid)
                    row["submitted"] += 1
            elif e.get("kind") in ("completed", "rejected",
                                   "deadline_missed"):
                tenant_term[e.get("request_id", "?")] = e
        for e in tenant_term.values():
            row = tenants.setdefault(str(e.get("tenant")), {
                "submitted": 0, "completed": 0, "rejected": 0,
                "throttled": 0, "latency": [],
            })
            if e.get("kind") == "completed":
                row["completed"] += 1
                if (isinstance(e.get("slo"), dict)
                        and "latency_s" in e["slo"]):
                    row["latency"].append(e["slo"]["latency_s"])
            elif e.get("kind") == "rejected":
                row["rejected"] += 1
        for t, n in throttled.items():
            tenants.setdefault(t, {
                "submitted": 0, "completed": 0, "rejected": 0,
                "throttled": 0, "latency": [],
            })["throttled"] = n
        out["fleet"] = {
            "kinds": kinds,
            "transitions": [
                {k: e.get(k) for k in ("seq", "replica", "from_state",
                                       "to_state", "reason")}
                for e in transitions
            ],
            "heartbeats": hb,
            "restarts": restarts,
            "quarantined": sorted(set(quarantined)),
            "failovers": len(fail_by_req),
            "failover_latency_s": _latency_stats(fail_lat),
            "duplicates_dropped": kinds.get("duplicate_result", 0),
            "tenants": {
                t: {
                    "submitted": r["submitted"],
                    "completed": r["completed"],
                    "rejected": r["rejected"],
                    "throttled": r["throttled"],
                    "latency_s": _latency_stats(r["latency"]),
                }
                for t, r in sorted(tenants.items())
            },
        }

    # Closed-loop sessions (schema v8): lease lifecycle + per-step SLO
    # from serving/sessions.py. Append-mode dedup discipline: lifecycle
    # state dedups per session_id (LAST opened/evicted/session_closed
    # wins — a resumed run re-appends "opened" for restored sessions)
    # and step terminals dedup per (session_id, step_seq) (last
    # step_done/step_degraded wins), while the raw kind counts stay
    # honest about every event observed.
    xevents = [e for e in events if e.get("event") == "session_event"]
    if xevents:
        kinds = {}
        for e in xevents:
            k = e.get("kind", "?")
            kinds[k] = kinds.get(k, 0) + 1
        life: dict[str, str] = {}
        steps: dict[tuple, dict] = {}
        gaps: list[float] = []
        for e in xevents:
            k = e.get("kind")
            sid = str(e.get("session_id", "?"))
            if k == "opened":
                life[sid] = "live"
            elif k == "evicted":
                life[sid] = "evicted"
            elif k == "session_closed":
                life[sid] = "closed"
            elif k in ("step_done", "step_degraded"):
                steps[(sid, e.get("step_seq"))] = e
            if k in ("renewed", "evicted") and isinstance(
                    e.get("gap_s"), (int, float)):
                gaps.append(e["gap_s"])
        lat: list[float] = []
        degraded = 0
        served = 0
        rejected_steps = 0
        for e in steps.values():
            rung = e.get("rung")
            if e.get("kind") == "step_degraded":
                degraded += 1
            elif rung == "rejected":
                rejected_steps += 1
            else:
                served += 1
            slo = e.get("slo")
            if isinstance(slo, dict) and isinstance(
                    slo.get("latency_s"), (int, float)):
                lat.append(slo["latency_s"])
        # Heartbeat-gap histogram: fixed edges in seconds. The gap is
        # renew-to-renew (or renew-to-eviction) silence — the tail
        # buckets are where lease tuning (TAT_SESSION_LEASE_S) lives.
        edges = (0.1, 0.5, 1.0, 5.0, 30.0)
        hist = {f"<{edges[0]}": 0}
        for lo, hi in zip(edges, edges[1:]):
            hist[f"{lo}-{hi}"] = 0
        hist[f">={edges[-1]}"] = 0
        for g in gaps:
            if g < edges[0]:
                hist[f"<{edges[0]}"] += 1
            elif g >= edges[-1]:
                hist[f">={edges[-1]}"] += 1
            else:
                for lo, hi in zip(edges, edges[1:]):
                    if lo <= g < hi:
                        hist[f"{lo}-{hi}"] += 1
                        break
        n_steps = len(steps)
        # Autoscale hint trail rides the fleet_event stream (additive
        # v8 kind): the LAST confirmed hint wins; the transition count
        # is a flap meter (hysteresis should keep it tiny).
        auto = [e for e in fevents if e.get("kind") == "autoscale"]
        out["sessions"] = {
            "kinds": kinds,
            "live": sum(1 for s in life.values() if s == "live"),
            "evicted": sum(1 for s in life.values() if s == "evicted"),
            "closed": sum(1 for s in life.values() if s == "closed"),
            "fence_rejections": kinds.get("fenced", 0),
            "stale_rejections": kinds.get("stale_step", 0),
            "steps": n_steps,
            "step_latency_s": _latency_stats(lat),
            "degraded_steps": degraded,
            "served_steps": served,
            "rejected_steps": rejected_steps,
            "degraded_rate": (degraded / n_steps) if n_steps else None,
            "heartbeat_gap_hist": hist,
            "rehomed": kinds.get("rehomed", 0),
            "autoscale": {
                "hint": auto[-1].get("hint") if auto else None,
                "transitions": len(auto),
            },
        }

    # Critical path (schema v5, obs.trace): decompose each traced
    # request's submit→complete interval into queue-wait / batch-wait /
    # device / harvest / retry segments — "why did p99 regress" as a
    # table instead of an archaeology session. Re-measured requests in
    # an append-mode file dedup per request_id (last request span wins,
    # inside critical_path).
    trows = trace_lib.trace_rows(events)
    if trows:
        cp = trace_lib.critical_path(trace_lib.stitch(trows))
        if cp["requests"]:
            out["critical_path"] = cp

    # Topology (pods tier): per-cell process/device counts + mesh shapes
    # (plain additive bench_cell value fields, _annotate_topology),
    # classified topology_mismatch events, and the pods cells' rungs —
    # the MULTICHIP_r0x trail as tables instead of raw JSON tails.
    # Dedup by cell, LAST event wins (the metrics file appends across
    # --resume / cell-filtered re-runs — same rule as bench_cells above;
    # counting per event would double-count re-measured cells).
    topo_by_cell: dict[str, dict] = {}
    for e in cells:
        v = e.get("value")
        if isinstance(v, dict) and ("n_devices" in v or "mesh" in v):
            topo_by_cell[e["cell"]] = {
                "cell": e["cell"],
                "n_processes": v.get("n_processes"),
                "n_devices": v.get("n_devices"),
                "mesh": v.get("mesh"),
                "rung": v.get("rung"),
                "skipped": v.get("skipped"),
            }
    topo_rows = list(topo_by_cell.values())
    mismatches = [
        {k: e.get(k) for k in ("label", "rung", "detail") if k in e}
        for e in events
        if e.get("event") == "backend_event"
        and e.get("kind") == "topology_mismatch"
    ]
    if topo_rows or mismatches:
        shapes: dict[str, int] = {}
        for r in topo_rows:
            key = f"{r['n_processes']}proc x {r['n_devices']}dev"
            shapes[key] = shapes.get(key, 0) + 1
        out["topology"] = {
            "shapes": shapes,
            "mismatch_events": mismatches,
            "pods_cells": [r for r in topo_rows
                           if r["cell"].startswith("pods")],
        }

    # Backend guard (schema v2): error/circuit events from
    # resilience.backend.BackendGuard, plus the rung each cell/chunk
    # ACTUALLY ran at (bench cells carry it in their value dict, chunk
    # events as a top-level field).
    bevents = [e for e in events if e.get("event") == "backend_event"]
    # (unit, impl, solve, rung) rows: impl is the consensus-exchange impl
    # the ring A/B cells (bench.py _sharded_ab_cell) carry in their value
    # dict — "impl(resolved)" when a pallas_ring cell downgraded off-TPU —
    # and solve is the inner-solve impl the fused A/B cells
    # (bench.py _fused_ab_cell) carry: the fused mode, rendered
    # "kernel(scan)" when the whole-solve kernel downgraded off-TPU, with
    # a "/bf16" (or "/bf16(f32)" after a parity-bar refusal) storage
    # suffix. Plain v4 bench_cell value fields; no schema change.
    rungs: list[tuple] = []
    for e in cells:
        v = e.get("value")
        if isinstance(v, dict) and "rung" in v:
            impl = v.get("impl", "")
            resolved = v.get("impl_resolved", impl)
            if resolved and resolved != impl:
                impl = f"{impl}({resolved})"
            solve = v.get("fused", "")
            fr = v.get("fused_resolved", solve)
            if fr and fr != solve:
                solve = f"{solve}({fr})"
            prec = v.get("precision")
            if prec and prec != "f32":
                pr = v.get("precision_resolved", prec)
                solve += f"/{prec}" if pr == prec else f"/{prec}({pr})"
            # Solver-effort columns (the effort A/B cells, bench.py
            # _effort_ab_cell; plain v4 value fields, no schema bump):
            # the knob ("fixed(adaptive)" when request != resolved) and
            # the measured consensus-iteration mean/p99 any
            # rollout-shaped cell may carry.
            effort = v.get("effort", "")
            er = v.get("effort_resolved", effort)
            if er and er != effort:
                effort = f"{effort}({er})"
            im, ip = v.get("iters_mean"), v.get("iters_p99")
            iters = "" if im is None else (
                f"{im:.1f}" + ("" if ip is None else f"/{ip:g}")
            )
            # Environment-query column (the env_{dense,bucketed}_T* A/B
            # cells, bench.py _env_query_cell; plain value fields):
            # impl("resolved" when they differ, the exchange-impl
            # convention) plus the bucketed arm's slab width — the grid
            # occupancy telemetry's headline number.
            envq = v.get("env_query", "")
            eqr = v.get("env_query_resolved", envq)
            if eqr and eqr != envq:
                envq = f"{envq}({eqr})"
            g = v.get("grid")
            if envq and isinstance(g, dict) and "k" in g:
                envq += f" K={g['k']}"
            rungs.append((e["cell"], impl, solve, v["rung"], effort,
                          iters, envq))
    for e in chunks:
        if "rung" in e:
            rungs.append((f"chunk {e['chunk']}", "", "", e["rung"], "",
                          "", ""))
    # SLO alert trail (schema v9, obs.live.SLOEngine): fire/resolve
    # transitions in journal order. An alert with no later resolve for
    # its (slo, tenant) key is UNRESOLVED — the examples' nonzero-exit
    # criterion and the headline render line.
    aevents = [e for e in events if e.get("event") == "alert"]
    if aevents:
        akinds: dict[str, int] = {}
        open_alerts: dict[tuple, dict] = {}
        for e in aevents:
            k = e.get("kind", "?")
            akinds[k] = akinds.get(k, 0) + 1
            key = (e.get("slo"), e.get("tenant"))
            if k == "fire":
                open_alerts[key] = e
            elif k == "resolve":
                open_alerts.pop(key, None)
        out["alerts"] = {
            "events": len(aevents),
            "fired": akinds.get("fire", 0),
            "resolved": akinds.get("resolve", 0),
            "unresolved": sorted(
                f"{s}/{t}" for s, t in open_alerts
            ),
            "trail": [
                {k: e.get(k)
                 for k in ("kind", "slo", "tenant", "severity",
                           "burn_rate", "window_s", "ts", "fired_ts")
                 if k in e}
                for e in aevents
            ],
        }

    if bevents or rungs:
        kinds: dict[str, int] = {}
        for e in bevents:
            k = e.get("kind", "?")
            kinds[k] = kinds.get(k, 0) + 1
        out["backend"] = {
            "events": len(bevents),
            "kinds": kinds,
            "timeouts": kinds.get("wedge_timeout", 0),
            "transitions": [
                {k: e.get(k) for k in ("kind", "label", "reason", "detail")
                 if k in e}
                for e in bevents if e.get("kind", "").startswith("circuit_")
            ],
            "errors": [
                {k: e.get(k) for k in ("kind", "label", "rung", "detail")
                 if k in e}
                for e in bevents
                if not e.get("kind", "").startswith("circuit_")
            ],
            "rungs": rungs,
        }
    return out


def render(summary: dict) -> None:
    ev = summary["events"]
    print("# run health")
    print("events: " + ", ".join(
        f"{k}={v}" for k, v in sorted(ev.items())
    ))

    tel = summary.get("telemetry")
    logs = summary.get("logs")
    rung_src = None
    if tel:
        rung_src = ("telemetry (cumulative, on-device)", tel["rung_hist"],
                    tel["steps"])
    elif logs:
        rung_src = ("log digests (exact)", logs["rung_hist"], logs["steps"])
    if rung_src:
        label, hist, steps = rung_src
        print(f"\n## fallback-rung distribution — {label}")
        print("| rung | steps | % |")
        print("|---|---|---|")
        for name, count in zip(RUNG_LABELS, hist):
            pct = 100.0 * count / steps if steps else 0.0
            print(f"| {name} | {count} | {pct:.1f} |")

    if tel:
        r = tel["residual"]
        # Percentile columns come from the event's own keys (the state
        # carries its quantile labels), so non-default configs render
        # their actual percentiles instead of empty p50/p90/p99 columns.
        pkeys = sorted(
            (k for k in r if k.startswith("p") and k != "pct"),
            key=lambda k: float(k[1:]),
        )
        cols = ["count", "min", *pkeys, "max", "mean"]
        print("\n## consensus residual (P² streaming percentiles)")
        print("| " + " | ".join(cols) + " |")
        print("|" + "---|" * len(cols))
        print("| " + " | ".join(
            [str(r["count"])] + [_fmt(r.get(k)) for k in cols[1:]]
        ) + " |")
        print("\n## safety margins")
        if "lanes" in tel:
            print(f"- fleet lanes (batched run, worst-lane percentiles): "
                  f"{tel['lanes']}")
        print(f"- min env/CBF margin: {_fmt(tel['min_env_dist'])} m")
        print(f"- worst-step ok_frac: {_fmt(tel['ok_frac_min'])}")
        print(f"- collision steps: {tel['collision_steps']}")
        print(f"- quarantined steps: {tel['quarantine_steps']}")
        if "agent_fail_steps" in tel:
            worst = max(range(len(tel["agent_fail_steps"])),
                        key=lambda i: tel["agent_fail_steps"][i])
            print(f"- per-agent solve failures: {tel['agent_fail_steps']} "
                  f"(worst: agent {worst})")
        eff = tel.get("effort")
        if eff and sum(eff.get("consensus_hist", [])):
            # Solver-effort histograms (adaptive-effort observability;
            # obs.telemetry ITER_BUCKETS log2 grid).
            print("\n## solver effort (iteration histograms)")
            print(f"- consensus iters/step: mean {_fmt(eff['iters_mean'])}"
                  f", p99 <= {_fmt(eff['iters_p99'])}")
            if "inner_iters_sum" in eff:
                print(f"- inner iters total: {eff['inner_iters_sum']} "
                      f"(per solve: mean "
                      f"{_fmt(eff.get('inner_per_solve_mean'))}, "
                      f"p99 <= "
                      f"{_fmt(eff.get('inner_per_solve_p99'))})")
            edges = [str(b) for b in eff["buckets"]] + [
                f">{eff['buckets'][-1]}"
            ]
            rows = [("consensus", eff["consensus_hist"])]
            if "inner_hist" in eff:
                rows.append(("inner/solve", eff["inner_hist"]))
            print("| histogram | " + " | ".join(
                f"<={e}" if not e.startswith(">") else e for e in edges
            ) + " |")
            print("|" + "---|" * (len(edges) + 1))
            for label, hist in rows:
                print(f"| {label} | " + " | ".join(
                    str(c) for c in hist
                ) + " |")
    elif logs:
        print("\n## safety margins (from log digests)")
        print(f"- min env/CBF margin: {_fmt(logs['min_env_dist'])} m")
        print(f"- collision steps: {logs['collision_steps']}")
        print(f"- quarantined lanes at end: {logs['quarantined_final']}")

    ch = summary.get("chunks")
    if ch:
        print("\n## chunk wall-times")
        print(f"- chunks: {ch['count']}, total {ch['wall_s_total']:.2f} s")
        print(f"- per-chunk mean/p50/max: {ch['wall_s_mean']:.3f} / "
              f"{ch['wall_s_p50']:.3f} / {ch['wall_s_max']:.3f} s")
        print(f"- host-level retries: {ch['retries']}")

    if summary.get("interruptions"):
        print("\n## resume / retry / preemption events")
        for e in summary["interruptions"]:
            print(f"- {json.dumps(e)}")

    if summary.get("bench_cells"):
        print("\n## bench cells")
        print("| cell | value |")
        print("|---|---|")
        for k, v in summary["bench_cells"].items():
            print(f"| {k} | {json.dumps(v)} |")

    if summary.get("compile_cost"):
        print("\n## compile cost (first-call wall time per cell)")
        print("| cell | compile_wall_s |")
        print("|---|---|")
        for k, v in summary["compile_cost"].items():
            print(f"| {k} | {v:.2f} |")
        print(f"| **total** | "
              f"{sum(summary['compile_cost'].values()):.2f} |")

    ao = summary.get("aot")
    if ao:
        print("\n## AOT serve ladder (aot.loader)")
        print(f"- serves: {ao['serves']} "
              f"(in-process compiles: {ao['compiled_in_process']}, "
              f"total wall {ao['wall_s_total']:.2f} s)")
        print("| entry | rung | serves |")
        print("|---|---|---|")
        for entry, per in ao["rungs_by_entry"].items():
            for rung, n in sorted(per.items()):
                print(f"| {entry} | {rung} | {n} |")

    sv = summary.get("serving")
    if sv:
        print("\n## serving SLO (serving/ tier)")
        print("events: " + ", ".join(
            f"{k}={v}" for k, v in sorted(sv["kinds"].items())
        ))
        for label, key in (("submit→complete", "latency_s"),
                           ("admit→complete", "admit_to_complete_s")):
            st = sv.get(key)
            if st:
                print(f"- {label} latency: p50 {_fmt(st['p50'])} s, "
                      f"p90 {_fmt(st['p90'])} s, p99 {_fmt(st['p99'])} s "
                      f"(mean {_fmt(st['mean'])}, n={st['count']})")
        if sv["rejections"]:
            print("- rejections: " + ", ".join(
                f"{k}={v}" for k, v in sorted(sv["rejections"].items())
            ))
        if sv["deadline_misses"]:
            print("- deadline misses: " + ", ".join(
                f"{k}={v}" for k, v in sorted(
                    sv["deadline_misses"].items())
            ))
        if sv["mean_occupancy"] is not None:
            print(f"- mean batch occupancy: "
                  f"{sv['mean_occupancy']:.3f}")
        if sv.get("cache_hits"):
            rate = sv.get("cache_hit_rate")
            print(f"- result-cache hits: {sv['cache_hits']}"
                  + (f" (hit rate {rate:.3f})" if rate is not None
                     else ""))
        if sv["batches"]:
            print("\n| batch | family | bucket | rungs |")
            print("|---|---|---|---|")
            for bid, b in sorted(sv["batches"].items(),
                                 key=lambda kv: str(kv[0])):
                rungs = ", ".join(
                    f"{r}×{n}" for r, n in sorted(b["rungs"].items())
                ) or "—"
                print(f"| {bid} | {b['family']} | "
                      f"{b['bucket'] if b['bucket'] is not None else '—'} "
                      f"| {rungs} |")

    fl = summary.get("fleet")
    if fl:
        print("\n## serving fleet (serving/fleet.py)")
        print("events: " + ", ".join(
            f"{k}={v}" for k, v in sorted(fl["kinds"].items())
        ))
        if fl["transitions"]:
            print("\n| seq | replica | transition | reason |")
            print("|---|---|---|---|")
            for t in fl["transitions"]:
                print(f"| {t.get('seq', '—')} | r{t['replica']} | "
                      f"{t['from_state']} → {t['to_state']} | "
                      f"{(t.get('reason') or '')[:60]} |")
        hb = ", ".join(f"r{r}={n}" for r, n in sorted(fl["heartbeats"].items()))
        print(f"- heartbeats: {hb or 'none'}")
        if fl["restarts"]:
            print("- restarts: " + ", ".join(
                f"r{r}×{n}" for r, n in sorted(fl["restarts"].items())
            ))
        if fl["quarantined"]:
            print(f"- quarantined replicas: "
                  f"{', '.join('r' + r for r in fl['quarantined'])}")
        st = fl.get("failover_latency_s")
        print(f"- failovers: {fl['failovers']} "
              + (f"(re-dispatch latency p50 {_fmt(st['p50'])} s, "
                 f"p99 {_fmt(st['p99'])} s, max {_fmt(st['max'])} s)"
                 if st else "")
              + (f", duplicates dropped: {fl['duplicates_dropped']}"
                 if fl["duplicates_dropped"] else ""))
        if fl["tenants"]:
            print("\n| tenant | submitted | completed | rejected | "
                  "throttled | p50 s | p99 s |")
            print("|---|---|---|---|---|---|---|")
            for t, r in fl["tenants"].items():
                lat = r["latency_s"]
                print(f"| {t} | {r['submitted']} | {r['completed']} | "
                      f"{r['rejected']} | {r['throttled']} | "
                      f"{_fmt(lat['p50']) if lat else '—'} | "
                      f"{_fmt(lat['p99']) if lat else '—'} |")

    sx = summary.get("sessions")
    if sx:
        print("\n## closed-loop sessions (serving/sessions.py)")
        print("events: " + ", ".join(
            f"{k}={v}" for k, v in sorted(sx["kinds"].items())
        ))
        print(f"- sessions: live={sx['live']}, evicted={sx['evicted']}, "
              f"closed={sx['closed']}"
              + (f", rehomed={sx['rehomed']}" if sx["rehomed"] else ""))
        print(f"- rejections: fenced={sx['fence_rejections']}, "
              f"stale_step={sx['stale_rejections']}")
        st = sx.get("step_latency_s")
        if st:
            print(f"- per-step latency: p50 {_fmt(st['p50'])} s, "
                  f"p99 {_fmt(st['p99'])} s (mean {_fmt(st['mean'])}, "
                  f"n={st['count']})")
        if sx["steps"]:
            rate = sx["degraded_rate"]
            print(f"- steps: {sx['steps']} "
                  f"(served {sx['served_steps']}, "
                  f"degraded {sx['degraded_steps']}, "
                  f"rejected {sx['rejected_steps']}"
                  + (f"; degraded-rung rate {rate:.3f}"
                     if rate is not None else "")
                  + ")")
        hist = sx["heartbeat_gap_hist"]
        if any(hist.values()):
            print("- heartbeat gaps (s): " + ", ".join(
                f"{b}={n}" for b, n in hist.items() if n
            ))
        au = sx["autoscale"]
        if au["hint"] is not None or au["transitions"]:
            print(f"- autoscale: hint={au['hint'] or '—'} "
                  f"({au['transitions']} confirmed transitions)")

    al = summary.get("alerts")
    if al:
        print("\n## slo alerts (obs.live burn-rate engine)")
        print(f"- fired: {al['fired']}, resolved: {al['resolved']}, "
              f"unresolved: {len(al['unresolved'])}"
              + (f" ({', '.join(al['unresolved'])})"
                 if al["unresolved"] else ""))
        for e in al["trail"]:
            if e["kind"] == "fire":
                print(f"  - FIRE {e.get('slo')}/{e.get('tenant')} "
                      f"severity={e.get('severity')} "
                      f"burn={_fmt(e.get('burn_rate'))} "
                      f"window={e.get('window_s')}s "
                      f"ts={_fmt(e.get('ts'))}")
            else:
                print(f"  - resolve {e.get('slo')}/{e.get('tenant')} "
                      f"ts={_fmt(e.get('ts'))} "
                      f"(fired ts={_fmt(e.get('fired_ts'))})")

    cp = summary.get("critical_path")
    if cp:
        print("\n## critical path (distributed tracing, obs.trace)")
        print(f"- traced requests: {len(cp['requests'])} "
              f"({cp['completed']} completed)")
        if cp["per_segment"]:
            print("\n| segment | p50 s | p99 s | mean s | total s |")
            print("|---|---|---|---|---|")
            for seg in trace_lib.SEGMENTS:
                st = cp["per_segment"].get(seg)
                if st is None:
                    continue
                print(f"| {seg} | {_fmt(st['p50'])} | {_fmt(st['p99'])} "
                      f"| {_fmt(st['mean'])} | {_fmt(st['total'])} |")
        w = cp.get("worst")
        if w:
            segs = ", ".join(
                f"{k}={_fmt(v)}" for k, v in w["segments"].items() if v
            )
            print(f"- worst request: {w['request_id']} "
                  f"(total {_fmt(w['total_s'])} s: {segs})")

    tp = summary.get("topology")
    if tp:
        print("\n## topology (pods tier / parallel.pods)")
        print("- cell topologies: " + ", ".join(
            f"{k} x{v}" for k, v in sorted(tp["shapes"].items())
        ))
        if tp["mismatch_events"]:
            print("- topology_mismatch events:")
            for m in tp["mismatch_events"]:
                print(f"  - {m.get('label')}: "
                      f"{(m.get('detail') or '')[:140]}")
        if tp["pods_cells"]:
            print("\n| pods cell | mesh | procs | devices | rung |")
            print("|---|---|---|---|---|")
            for r in tp["pods_cells"]:
                mesh = r["mesh"]
                mesh_s = ("x".join(str(v) for v in mesh.values())
                          if isinstance(mesh, dict) else "—")
                rung = r.get("rung") or (
                    f"skipped: {r['skipped']}" if r.get("skipped") else "—"
                )
                print(f"| {r['cell']} | {mesh_s} | "
                      f"{r['n_processes'] if r['n_processes'] is not None else '—'} | "
                      f"{r['n_devices'] if r['n_devices'] is not None else '—'} | "
                      f"{rung} |")

    be = summary.get("backend")
    if be:
        print("\n## backend health (resilience.backend guard)")
        kinds = ", ".join(f"{k}={v}" for k, v in sorted(be["kinds"].items())) \
            or "none"
        print(f"- guard events: {be['events']} ({kinds})")
        print(f"- watchdog timeouts: {be['timeouts']}")
        if be["transitions"]:
            print("- circuit transitions:")
            for t in be["transitions"]:
                print(f"  - {t.get('kind')} at {t.get('label')}: "
                      f"{t.get('reason', t.get('detail', ''))}")
        if be["errors"]:
            print("- classified backend errors:")
            for e in be["errors"]:
                print(f"  - [{e.get('kind')}] {e.get('label')} "
                      f"(ran at {e.get('rung', '?')}): "
                      f"{(e.get('detail') or '')[:120]}")
        if be["rungs"]:
            print("\n| unit | exchange impl | solve impl | effort | "
                  "iters mean/p99 | env query | rung |")
            print("|---|---|---|---|---|---|---|")
            for unit, impl, solve, rung, *rest in be["rungs"]:
                effort = rest[0] if rest else ""
                iters = rest[1] if len(rest) > 1 else ""
                envq = rest[2] if len(rest) > 2 else ""
                print(f"| {unit} | {impl or '—'} | {solve or '—'} | "
                      f"{effort or '—'} | {iters or '—'} | "
                      f"{envq or '—'} | {rung} |")


def _latency_stats(xs: list[float]) -> dict | None:
    if not xs:
        return None
    return {
        "count": len(xs),
        "mean": sum(xs) / len(xs),
        "p50": _percentile(xs, 0.5),
        "p90": _percentile(xs, 0.9),
        "p99": _percentile(xs, 0.99),
        "max": max(xs),
    }


def _fmt(v) -> str:
    if v is None:
        return "—"
    return f"{v:.4g}"


def follow(args) -> None:
    """Live vitals: tail the paths and redraw one rolling-window
    per-tenant table each refresh (the fleet_console's single-window
    little sibling; --rounds bounds the loop for tests)."""
    tailer = live_mod.FleetTailer(args.paths)
    windows = live_mod.RollingWindows(
        horizon_s=max(3600, int(args.window))
    )
    refresh = live_mod.resolve_refresh_s(args.refresh)
    rounds = 0
    while True:
        for replica, event in tailer.poll():
            windows.ingest(replica, event)
        rates = windows.rates(int(args.window))
        if args.json:
            print(json.dumps({"now": windows.latest_ts,
                              "window_s": int(args.window),
                              "tenants": rates}))
        else:
            print(f"-- trailing {int(args.window)}s @ "
                  f"ts={_fmt(windows.latest_ts)} --")
            if not rates:
                print("  (no traffic)")
            for tenant, row in sorted(rates.items()):
                lat = row["latency"]
                print(f"  {tenant}: submitted={row.get('submitted', 0)} "
                      f"completed={row.get('completed', 0)} "
                      f"rejected={row.get('rejected', 0)} "
                      f"missed={row.get('missed', 0)} "
                      f"steps={row.get('steps', 0)} "
                      f"p99={_fmt(lat['p99'])}s "
                      f"miss_rate={_fmt(row['miss_rate'])} "
                      f"rejection_rate={_fmt(row['rejection_rate'])}")
        rounds += 1
        if args.rounds is not None and rounds >= args.rounds:
            return
        time.sleep(refresh)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("paths", nargs="+", metavar="METRICS_JSONL")
    ap.add_argument("--json", action="store_true",
                    help="print the machine-readable summary instead of "
                         "tables")
    ap.add_argument("--validate", action="store_true",
                    help="schema-check only (ci gate); exit 1 on any "
                         "violation")
    ap.add_argument("--follow", action="store_true",
                    help="live mode: tail the paths (files or dirs of "
                         "*.metrics.jsonl) and redraw rolling rates")
    ap.add_argument("--window", type=int, default=60,
                    help="trailing window in seconds for --follow "
                         "(default 60)")
    ap.add_argument("--refresh", type=float, default=None,
                    help="--follow refresh period in seconds "
                         "(TAT_CONSOLE_REFRESH_S overrides; default 1)")
    ap.add_argument("--rounds", type=int, default=None,
                    help="stop --follow after N refreshes (tests)")
    args = ap.parse_args(argv)

    if args.follow:
        follow(args)
        return 0

    failed = False
    for path in args.paths:
        errs = export_mod.validate_file(path)
        if errs:
            failed = True
            print(f"{path}: {len(errs)} schema violation(s)",
                  file=sys.stderr)
            for e in errs[:20]:
                print(f"  {e}", file=sys.stderr)
        elif args.validate:
            print(f"{path}: OK")
    if args.validate or failed:
        return 1 if failed else 0

    for path in args.paths:
        if len(args.paths) > 1:
            print(f"\n===== {path} =====")
        summary = summarize(export_mod.read_events(path))
        if args.json:
            print(json.dumps(summary, indent=1))
        else:
            render(summary)
    return 0


if __name__ == "__main__":
    sys.exit(main())
