#!/usr/bin/env python3
"""Op-level and phase-level attribution of a ``torch.profiler`` trace.

The port's counterpart of the JAX package's ``tools/op_profile.py``. Where
the JAX tool parses XLA xplane protos, this one reads what
``torch.profiler.profile(...).export_chrome_trace(path)`` writes: a file,
or a directory of ``*.json`` traces. It aggregates
device time per kernel and prints a markdown table of the top-k; with
``--by-phase`` it rolls that time up to the ``tat.<phase>`` ranges the
port opens around its hot regions (``obs/phases.py``, one
``record_function`` each) -- "what fraction of a control step is
consensus against solve" instead of kernel names.

Attribution. A device event (``kernel``, ``gpu_memcpy``, ``gpu_memset``)
carries the ``correlation`` id of the host call that launched it
(``cuda_runtime``/``cuda_driver``: ``cudaLaunchKernel``, a memcpy, or
``cudaGraphLaunch`` for every kernel a replayed CUDA graph runs). Its
scope is the path of ``user_annotation`` ranges that hold that launch on
its host thread, and its phase the innermost ``tat.*`` segment of the
path. A kernel of the port's own (:data:`OWN_KERNELS`) whose launch the
trace does not hold takes its phase from its name; any other device event
with no launch in the trace is ``(unattributed)``, as is one launched
outside every ``tat.*`` range. A capture with no device events (a CPU
capture) uses the CPU as the device, as the JAX tool uses ``/host:CPU``:
each ``cpu_op``'s self time (its duration less that of the ``cpu_op``s
nested in it on the same thread) is attributed by the ranges around it.

Usage:
  python -m tpu_aerial_transport_torch.tools.op_profile TRACE --top 30 \\
      [--json out.json]
  python -m tpu_aerial_transport_torch.tools.op_profile TRACE --by-phase

The tool reads files and computes nothing on a device. The JAX tool's
``--hlo`` (``load_hlo_map``, ``find_hlo_dump``) reads compiled HLO text,
which PyTorch does not produce: it has no counterpart here
(``analysis/entrypoints.py NO_COUNTERPART``).
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import re
import sys
from collections import defaultdict

PHASE_RE = re.compile(r"tat\.([A-Za-z0-9_]+)")
UNATTRIBUTED = "(unattributed)"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
# Every host event that takes the host's time: the ops, the ranges' own
# time between them, and the CUDA calls.
HOST_CATS = ("cpu_op", "user_annotation") + LAUNCH_CATS
# The port's kernels by their __global__ names (no name is a substring of
# another), and the phase their device time is attributed to when the
# trace holds no launch for them.
OWN_KERNELS = {"fused_solve_kernel": "fused_solve",
               "fused_solve_early_kernel": "fused_solve_early",
               "fused_solve_bf16_kernel": "fused_solve_bf16",
               "fused_solve_early_bf16_kernel": "fused_solve_early_bf16",
               "warp_solve_kernel": "fused_solve",
               "warp_solve_early_kernel": "fused_solve_early",
               "warp_solve_bf16_kernel": "fused_solve_bf16",
               "warp_solve_early_bf16_kernel": "fused_solve_early_bf16",
               "admm_chunk_kernel": "admm_chunk",
               "warp_chunk_kernel": "admm_chunk",
               "ring_sum_kernel": "ring_sum"}


def load_traces(path: str) -> list[dict]:
    """The Chrome traces at ``path``: one file, or every ``*.json`` under
    a directory."""
    paths = (sorted(glob.glob(os.path.join(path, "**", "*.json"),
                              recursive=True))
             if os.path.isdir(path) else [path])
    if not paths:
        raise FileNotFoundError(f"no *.json traces under {path}")
    traces = []
    for p in paths:
        with open(p, encoding="utf-8") as fh:
            traces.append(json.load(fh))
    return traces


def own_kernel(name: str) -> str | None:
    """The :data:`OWN_KERNELS` key ``name`` holds, or None."""
    for key in OWN_KERNELS:
        if key in name:
            return key
    return None


def _events(trace: dict) -> list[dict]:
    return [e for e in trace.get("traceEvents", ()) if e.get("ph") == "X"]


def _thread(e) -> tuple:
    return (e.get("pid"), e.get("tid"))


def _scopes_at(annotations: list[dict], events: list[dict]) -> list:
    """For each of ``events`` (all on one thread), the ``/``-joined names
    of the ``annotations`` whose interval holds its start, outermost
    first (None where none does)."""
    marks = sorted(
        [(a["ts"], 0, -a.get("dur", 0.0), i) for i, a in
         enumerate(annotations)]
        + [(e["ts"], 1, 0.0, i) for i, e in enumerate(events)])
    out: list = [None] * len(events)
    stack: list[dict] = []
    for ts, kind, _, i in marks:
        while stack and stack[-1]["ts"] + stack[-1].get("dur", 0.0) <= ts:
            stack.pop()
        if kind == 0:
            stack.append(annotations[i])
        elif stack:
            out[i] = "/".join(a["name"] for a in stack)
    return out


def _by_thread(events) -> dict:
    out: dict = defaultdict(list)
    for e in events:
        out[_thread(e)].append(e)
    return out


def _add(agg: dict, name: str, scope, us: float) -> None:
    a = agg[name if scope is None else f"{name} @ {scope}"]
    a["total_us"] += us
    a["count"] += 1
    a["scope"] = scope


def _new_agg() -> dict:
    return defaultdict(lambda: {"total_us": 0.0, "count": 0, "scope": None})


def device_aggregate(traces) -> dict[str, dict]:
    """``"<kernel> @ <scope>" -> {total_us, count, scope}`` over the device
    events, each scoped by the annotations around its launch (an own
    kernel with no launch in the trace by :data:`OWN_KERNELS`)."""
    agg = _new_agg()
    for trace in traces:
        events = _events(trace)
        device = [e for e in events if e.get("cat") in DEVICE_CATS]
        launches = {e["args"]["correlation"]: e for e in events
                    if e.get("cat") in LAUNCH_CATS
                    and "correlation" in e.get("args", {})}
        annotations = _by_thread(
            e for e in events if e.get("cat") == "user_annotation")
        held = _by_thread(launches.values())
        scope_of: dict = {}
        for key, evs in held.items():
            for e, s in zip(evs, _scopes_at(annotations.get(key, []), evs)):
                scope_of[e["args"]["correlation"]] = s
        for e in device:
            corr = e.get("args", {}).get("correlation")
            if corr in launches:
                scope = scope_of[corr]
            else:
                own = own_kernel(e["name"])
                scope = None if own is None else "tat." + OWN_KERNELS[own]
            _add(agg, e["name"], scope, float(e.get("dur", 0.0)))
    return dict(agg)


def host_aggregate(traces, cats=("cpu_op",)) -> dict[str, dict]:
    """``"<op> @ <scope>" -> {total_us, count, scope}`` over the host
    events of categories ``cats``, by self time (duration less that of the
    events of ``cats`` nested in it on the same thread). The default is the
    ``cpu_op``s; :data:`HOST_CATS` counts all the host's time, as
    ``torch.profiler``'s own self times do."""
    agg = _new_agg()
    for trace in traces:
        events = _events(trace)
        annotations = _by_thread(
            e for e in events if e.get("cat") == "user_annotation")
        for key, ops in _by_thread(
                e for e in events if e.get("cat") in cats).items():
            ops.sort(key=lambda e: (e["ts"], -e.get("dur", 0.0)))
            self_us = [float(e.get("dur", 0.0)) for e in ops]
            stack: list[int] = []
            for i, e in enumerate(ops):
                while stack and (ops[stack[-1]]["ts"]
                                 + ops[stack[-1]].get("dur", 0.0)
                                 <= e["ts"]):
                    stack.pop()
                if stack:
                    self_us[stack[-1]] -= float(e.get("dur", 0.0))
                stack.append(i)
            scopes = _scopes_at(annotations.get(key, []), ops)
            for e, us, scope in zip(ops, self_us, scopes):
                _add(agg, e["name"], scope, max(us, 0.0))
    return dict(agg)


def has_device_events(traces) -> bool:
    return any(e.get("cat") in DEVICE_CATS
               for t in traces for e in t.get("traceEvents", ()))


def op_aggregate(traces) -> dict[str, dict]:
    """name -> {total_us, count, scope}: the device events' time where the
    trace has any, else the host's ``cpu_op`` self time (a CPU capture:
    the CPU is the device)."""
    if has_device_events(traces):
        return device_aggregate(traces)
    return host_aggregate(traces)


def own_launches(traces) -> dict[str, int]:
    """Launches of each of the port's kernels in the traces, by name."""
    out: dict[str, int] = {}
    for trace in traces:
        for e in trace.get("traceEvents", ()):
            if e.get("cat") == "kernel":
                own = own_kernel(e["name"])
                if own is not None:
                    out[own] = out.get(own, 0) + 1
    return out


def phase_of(scope_path: str | None) -> str | None:
    """Innermost ``tat.*`` segment of a scope path (nested scopes: the
    finest-grained annotation wins)."""
    if not scope_path:
        return None
    hits = PHASE_RE.findall(scope_path)
    return hits[-1] if hits else None


def rollup_phases(agg: dict[str, dict]):
    """Roll op time up to phases.

    Returns ``(rows, op_total_us, attributed_us)`` where ``rows`` maps
    phase -> {total_us, count, ops (example op names)}. Every op counts
    in the base, attributed or not (the JAX tool drops its XLA runtime's
    own helper events from the base; a torch trace's ``cpu_op``s and
    kernels are all work).
    """
    rows: dict[str, dict] = defaultdict(
        lambda: {"total_us": 0.0, "count": 0, "ops": []}
    )
    op_total = 0.0
    attributed = 0.0
    for name, a in agg.items():
        op_total += a["total_us"]
        phase = phase_of(a["scope"])
        key = phase if phase is not None else UNATTRIBUTED
        row = rows[key]
        row["total_us"] += a["total_us"]
        row["count"] += a["count"]
        if len(row["ops"]) < 4:
            row["ops"].append(name)
        if phase is not None:
            attributed += a["total_us"]
    return dict(rows), op_total, attributed


def phase_us(agg: dict[str, dict]) -> dict[str, float]:
    """phase -> microseconds, from :func:`rollup_phases`."""
    return {k: r["total_us"] for k, r in rollup_phases(agg)[0].items()}


def print_phase_table(rows, op_total, attributed) -> list[dict]:
    print(f"# phase-level device self-time "
          f"({op_total / 1e3:.2f} ms of device ops; "
          f"{100.0 * attributed / op_total if op_total else 0.0:.1f}% "
          "attributed to tat.* phases)")
    print("| phase | total ms | % of op time | example ops |")
    print("|---|---|---|---|")
    table = []
    for phase, r in sorted(rows.items(), key=lambda kv: -kv[1]["total_us"]):
        pct = 100.0 * r["total_us"] / op_total if op_total else 0.0
        # A kernel's name is its C++ signature: the first 60 characters.
        ops = ", ".join(f"`{o if len(o) <= 60 else o[:57] + '...'}`"
                        for o in r["ops"][:3])
        print(f"| {phase} | {r['total_us'] / 1e3:.3f} | {pct:.1f} | {ops} |")
        table.append({"phase": phase, "total_ms": r["total_us"] / 1e3,
                      "pct_op_time": pct, "calls": r["count"]})
    return table


def print_op_table(agg, top: int) -> list[dict]:
    total = sum(v["total_us"] for v in agg.values())
    rows = sorted(agg.items(), key=lambda kv: -kv[1]["total_us"])[:top]
    print(f"# device op self-time, top {top} of {len(agg)} ops "
          f"({total / 1e3:.2f} ms total on-device)")
    print("| op | total ms | calls | % of device time |")
    print("|---|---|---|---|")
    table = []
    for name, v in rows:
        pct = 100.0 * v["total_us"] / total if total else 0.0
        short = name if len(name) <= 90 else name[:87] + "..."
        print(f"| `{short}` | {v['total_us'] / 1e3:.3f} | {v['count']} "
              f"| {pct:.1f} |")
        table.append({"op": name, "total_ms": v["total_us"] / 1e3,
                      "calls": v["count"], "pct_device_time": pct})
    return table


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("trace", help="a Chrome trace or a directory of them")
    ap.add_argument("--top", type=int, default=30)
    ap.add_argument("--json", default=None, metavar="PATH")
    ap.add_argument("--by-phase", action="store_true",
                    help="roll op time up to the tat.* phases "
                         "(obs/phases.py)")
    args = ap.parse_args(argv)

    traces = load_traces(args.trace)
    agg = op_aggregate(traces)
    if not agg:
        print("no device or host op events found in the trace",
              file=sys.stderr)
        return 1

    payload: dict = {"source": ("device" if has_device_events(traces)
                                else "host")}
    if args.by_phase:
        rows, op_total, attributed = rollup_phases(agg)
        payload["phases"] = print_phase_table(rows, op_total, attributed)
        payload["op_total_ms"] = op_total / 1e3
        payload["attributed_frac"] = (
            attributed / op_total if op_total else 0.0
        )
        if payload["source"] == "device":
            payload["host_ms_by_phase"] = {
                k: v / 1e3 for k, v in phase_us(
                    host_aggregate(traces, HOST_CATS)).items()}
            payload["own_kernel_launches"] = own_launches(traces)
    else:
        payload["top_ops"] = print_op_table(agg, args.top)
        payload["device_total_ms"] = (
            sum(v["total_us"] for v in agg.values()) / 1e3
        )

    if args.json:
        os.makedirs(os.path.dirname(args.json) or ".", exist_ok=True)
        with open(args.json, "w") as fh:
            json.dump(payload, fh, indent=1)
        print(f"written to {args.json}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
