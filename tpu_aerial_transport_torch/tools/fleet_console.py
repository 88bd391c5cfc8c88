"""Live fleet console: rolling windows + SLO burn rates + alert state.

The port's counterpart of the JAX package's ``tools/fleet_console.py``, on
the port's ``obs.live``. Tails every ``*.metrics.jsonl`` under the given
paths (files or directories, discovered live as replicas boot), merges
the streams into 1 s/10 s/60 s rolling windows per tenant, and evaluates
the declarative SLO engine each refresh -- per-tenant throughput, miss /
rejection / cache-hit rates, latency percentiles, multi-window burn rates
and the firing-alert set, all from the journaled wall-clock ``ts`` domain
(a replayed file renders exactly what the live run saw). It reads the
files of either package's fleet.

Usage:
  python -m tpu_aerial_transport_torch.tools.fleet_console \
      artifacts/fleet-torch-local/ [--refresh 1]
  python -m tpu_aerial_transport_torch.tools.fleet_console \
      RUN.metrics.jsonl --once --json
  python -m tpu_aerial_transport_torch.tools.fleet_console artifacts/ \
      --slo p99:step_latency:0.99:threshold_s=0.5

``--once`` drains everything currently on disk, renders one frame, and
exits: its numbers match a post-hoc recompute from ``jsonl_read``
exactly. Exit 1 when ``--once`` ends with alerts still firing, else 0.
"""

from __future__ import annotations

import argparse
import json
import time

from tpu_aerial_transport_torch.obs import live as live_mod


def build_engine(args) -> tuple:
    """(FleetTailer, SLOEngine) from parsed args."""
    specs = None
    if args.slo:
        specs = tuple(live_mod.parse_slo_spec(s) for s in args.slo)
    tailer = live_mod.FleetTailer(args.paths)
    engine = live_mod.SLOEngine(specs)
    return tailer, engine


def drain(tailer, engine) -> int:
    """Poll until the tailer reports nothing new; returns events read."""
    total = 0
    while True:
        n = engine.ingest_all(tailer.poll())
        total += n
        if n == 0:
            return total


def frame(engine, windows=None) -> dict:
    """One machine-readable console frame (the --json payload)."""
    windows = live_mod.CONSOLE_WINDOWS if windows is None else windows
    engine.evaluate()
    return {
        "now": engine.windows.latest_ts,
        "groups": [list(g) for g in engine.windows.groups()],
        "windows": {str(w): engine.windows.rates(w) for w in windows},
        "slo": engine.snapshot(),
    }


def _fmt(v) -> str:
    if v is None:
        return "—"
    if isinstance(v, float):
        return f"{v:.4g}"
    return str(v)


def render(fr: dict) -> None:
    now = fr["now"]
    print(f"fleet console @ ts={_fmt(now)}  "
          f"groups(tenant,family,replica)={len(fr['groups'])}")
    for w, by_tenant in fr["windows"].items():
        print(f"\n-- window {w}s --")
        if not by_tenant:
            print("  (no traffic)")
            continue
        head = (f"  {'tenant':<12} {'subm':>6} {'done':>6} {'rej':>5} "
                f"{'miss':>5} {'steps':>6} {'p50':>8} {'p99':>8} "
                f"{'miss%':>7} {'rej%':>7} {'hit%':>7}")
        print(head)
        for tenant, row in sorted(by_tenant.items()):
            lat = row["latency"]
            pct = (lambda r: "—" if r is None else f"{100 * r:.1f}")
            print(f"  {tenant:<12} {row.get('submitted', 0):>6} "
                  f"{row.get('completed', 0):>6} "
                  f"{row.get('rejected', 0):>5} "
                  f"{row.get('missed', 0):>5} "
                  f"{row.get('steps', 0):>6} "
                  f"{_fmt(lat['p50']):>8} {_fmt(lat['p99']):>8} "
                  f"{pct(row['miss_rate']):>7} "
                  f"{pct(row['rejection_rate']):>7} "
                  f"{pct(row['cache_hit_rate']):>7}")
    slo = fr["slo"]
    print("\n-- slo burn rates (fast/slow) --")
    if not slo["burn_rates"]:
        print("  (no traffic)")
    for key, burns in sorted(slo["burn_rates"].items()):
        print(f"  {key:<28} {_fmt(burns['fast']):>8} "
              f"{_fmt(burns['slow']):>8}")
    if slo["firing"]:
        print(f"\nALERTS FIRING: {', '.join(slo['firing'])}")
    else:
        print("\nalerts: none firing")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("paths", nargs="+", metavar="FILE_OR_DIR",
                    help="metrics jsonl files and/or directories to "
                         "scan for *.metrics.jsonl")
    ap.add_argument("--once", action="store_true",
                    help="drain current contents, render one frame, "
                         "exit (nonzero when alerts are firing)")
    ap.add_argument("--json", action="store_true",
                    help="machine-readable frames instead of tables")
    ap.add_argument("--refresh", type=float, default=None,
                    help="live refresh period in seconds "
                         "(TAT_CONSOLE_REFRESH_S overrides; default 1)")
    ap.add_argument("--slo", action="append", default=None,
                    metavar="NAME:METRIC:OBJECTIVE[:k=v...]",
                    help="SLO spec (repeatable; default: the standard "
                         "step_p99/miss_rate/rejection trio)")
    ap.add_argument("--rounds", type=int, default=None,
                    help="stop live mode after N refreshes (tests)")
    args = ap.parse_args(argv)

    tailer, engine = build_engine(args)
    if args.once:
        drain(tailer, engine)
        fr = frame(engine)
        if args.json:
            print(json.dumps(fr, indent=1))
        else:
            render(fr)
        return 1 if fr["slo"]["firing"] else 0

    refresh = live_mod.resolve_refresh_s(args.refresh)
    rounds = 0
    while True:
        engine.ingest_all(tailer.poll())
        fr = frame(engine)
        if args.json:
            print(json.dumps(fr))
        else:
            print("\033[2J\033[H", end="")  # clear screen, home cursor.
            render(fr)
        rounds += 1
        if args.rounds is not None and rounds >= args.rounds:
            return 1 if fr["slo"]["firing"] else 0
        time.sleep(refresh)


if __name__ == "__main__":
    raise SystemExit(main())
