"""Serving-fleet demo: a seeded mixed-tenant request stream through N
replica ``ScenarioServer`` processes sharing the card, behind the
consistent-hash admission front (``tpu_aerial_transport_torch/serving/
fleet.py``), with an optional chaos storm layered on top.

The port's counterpart of ``examples/serve_fleet.py``: a thin, opinionated
wrapper over the port's harness (``tpu_aerial_transport_torch.tools.
fleet_local``), which owns the process discipline (own-session workers,
group kills, parent-pid watchdogs, fsync'd jsonl channels); the demo picks
a believable multi-tenant workload and narrates the outcome:

- three tenants with different admission contracts -- ``pro`` (high
  weight, priority), ``free`` (rate-limited token bucket), ``batch``
  (best-effort) -- so the weighted-fair dequeue and structured
  ``tenant_rate_limited`` rejections are visible in one run;
- ``--chaos`` arms a seeded :class:`FleetFaultPlan` (SIGKILL a replica
  mid-batch, wedge another) and the summary shows the supervisor's
  ``up -> down -> restarting -> up`` transitions, the failover count,
  and -- with ``--trace`` -- the explicit ``retry`` segment on each
  failed-over request's ORIGINAL trace_id in the stitched Perfetto trace;
- every completed request reports a result digest and the device it was
  served on, so a chaos run can be diffed bit for bit against a
  fault-free run of the same seed.

It takes the harness's flags; ``--device`` is ``cuda`` by default (every
replica on the card) and ``cpu`` runs the plain PyTorch path.

Usage:
  python -m tpu_aerial_transport_torch.examples.serve_fleet --replicas 2
  python -m tpu_aerial_transport_torch.examples.serve_fleet --replicas 3 \\
      --chaos --seed 7 --trace --out-dir artifacts/fleet-torch-demo
  python -m tpu_aerial_transport_torch.examples.serve_fleet --device cpu

Multi-replica runs need two cores or more: with ``--device cpu`` a 1-core
host skips with a written reason (``--force-multi`` overrides); on the
card it is an error.
"""

from __future__ import annotations

import json
import os
import sys

from tpu_aerial_transport_torch.obs import live as live_mod
from tpu_aerial_transport_torch.tools import fleet_local

DEMO_TENANTS = "pro:weight=4,priority=1;free:rate=2,burst=3;batch:weight=1"


def main(argv=None) -> int:
    parser = fleet_local.build_parser()
    parser.description = __doc__
    parser.set_defaults(
        requests=12,
        tenants=DEMO_TENANTS,
        out_dir="artifacts/fleet-torch-demo",
        poisson_rate=4.0,
        # The JAX demo's span for the seeded storm (whose clock starts
        # once every replica is ready).
        chaos_span=12.0,
    )
    # The demo accepts bare ``--chaos`` (arm a seeded storm) and bare
    # ``--trace`` (auto-pathed Perfetto output); the harness parser
    # takes explicit values for both, so backfill placeholders before
    # parsing. Explicit values (``--chaos sigkill@2:r0``) pass through.
    argv = list(sys.argv[1:] if argv is None else argv)
    for flag, placeholder in (("--chaos", "seeded"), ("--trace", "auto")):
        if flag in argv:
            i = argv.index(flag)
            if i + 1 == len(argv) or argv[i + 1].startswith("-"):
                argv.insert(i + 1, placeholder)
    args = parser.parse_args(argv)
    if args.chaos == "seeded":
        args.chaos = f"seeded:{args.seed}"
    if args.trace == "auto":
        args.trace = os.path.join(args.out_dir, "fleet.trace.json")

    why = fleet_local.too_few_cores(args)
    if why is not None:
        if args.device != "cpu":
            print(f"serve_fleet: {why}", file=sys.stderr)
            return 2
        print(json.dumps({"skipped": why}))
        return 0

    summary, rc = fleet_local.run_fleet(args)

    # Live-SLO pass (obs/live.py): replay every replica journal the run
    # left in --out-dir through a MetricsHub + burn-rate engine; the
    # final hub snapshot rides the summary and an alert still firing at
    # end-of-run turns a passing run into exit 6 (rc != 0 keeps its own
    # code -- don't mask a harness failure with the SLO verdict).
    hub = live_mod.MetricsHub()
    # The demo's ``free`` tenant is rate-limited BY CONTRACT -- its
    # token-bucket rejections are the admission design working, not an
    # SLO violation -- so the rejection SLO is scoped to ``pro`` (the
    # tenant that bought priority) while latency/miss stay fleet-wide.
    engine = live_mod.SLOEngine((
        live_mod.SLOSpec(name="step_p99", metric="step_latency",
                         objective=0.99, threshold_s=30.0),
        live_mod.SLOSpec(name="miss_rate", metric="deadline_miss",
                         objective=0.99),
        live_mod.SLOSpec(name="rejection", metric="rejection",
                         objective=0.95, tenant="pro"),
    ))
    tailer = live_mod.FleetTailer([args.out_dir])
    for replica, event in tailer.poll():
        engine.ingest(replica, event)
        etype = event.get("event")
        if etype == "serving_event":
            hub.ingest_serving(event)
        elif etype == "session_event":
            hub.ingest_session(event)
        elif etype == "backend_event":
            hub.ingest_backend(event)
        elif etype == "aot_serve":
            hub.ingest_aot(event)
    engine.evaluate()
    firing = sorted(f"{n}/{t}" for n, t in engine.firing)
    summary["slo"] = {"firing": firing, "alerts": len(engine.alerts)}
    summary["hub"] = hub.snapshot()

    # Narrate the interesting bits above the raw summary.
    notes = []
    tenants = summary.get("tenants", {})
    for name in sorted(tenants):
        t = tenants[name]
        notes.append(
            f"tenant {name}: {t['completed']}/{t['submitted']} completed"
            + (f", {t['rejected']} rejected" if t["rejected"] else "")
        )
    if summary.get("failovers"):
        notes.append(
            f"failovers: {summary['failovers']} request(s) re-dispatched "
            "off dead replicas (same trace_id; retry segment in trace)"
        )
    if summary.get("trace"):
        notes.append(f"perfetto trace: {summary['trace']['path']}")
    if firing:
        notes.append(f"SLO ALERTS FIRING at end of run: "
                     f"{', '.join(firing)}")
    summary["notes"] = notes
    print(json.dumps(summary, indent=1))
    if rc == 0 and firing:
        print(f"serve_fleet: unresolved firing alerts: {firing}",
              file=sys.stderr)
        return 6
    return rc


if __name__ == "__main__":
    raise SystemExit(main())
