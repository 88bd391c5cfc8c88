"""Reading a ``torch.profiler`` Chrome trace: the benchmark's frozen copy of
the port's ``tools/op_profile.py`` arithmetic (``device_aggregate``,
``host_aggregate``, ``rollup_phases`` and what they rest on), as it stood
when the benchmark was written, plus the device's busy intervals and its
idle gaps labelled by what the host was doing.

Attribution. A device event (``kernel``, ``gpu_memcpy``, ``gpu_memset``)
carries the ``correlation`` id of the host call that launched it
(``cudaLaunchKernel``, a memcpy, or ``cudaGraphLaunch`` for every kernel
of a replayed CUDA graph); its scope is the path of ``user_annotation``
ranges around that launch on its thread, and its phase the innermost
``tat.*`` segment of the path. An own kernel of the port whose launch the
trace lacks takes its phase from its name.
"""

from __future__ import annotations

import bisect
import json
import re
from collections import defaultdict

PHASE_RE = re.compile(r"tat\.([A-Za-z0-9_]+)")
UNATTRIBUTED = "(unattributed)"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
HOST_CATS = ("cpu_op", "user_annotation") + LAUNCH_CATS
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


def load(path: str) -> dict:
    with open(path, encoding="utf-8") as fh:
        return json.load(fh)


def own_kernel(name: str) -> str | None:
    for key in OWN_KERNELS:
        if key in name:
            return key
    return None


def events(trace: dict) -> list[dict]:
    return [e for e in trace.get("traceEvents", ()) if e.get("ph") == "X"]


def _thread(e) -> tuple:
    return (e.get("pid"), e.get("tid"))


def _scopes_at(annotations: list[dict], evs: list[dict]) -> list:
    marks = sorted(
        [(a["ts"], 0, -a.get("dur", 0.0), i) for i, a in
         enumerate(annotations)]
        + [(e["ts"], 1, 0.0, i) for i, e in enumerate(evs)])
    out: list = [None] * len(evs)
    stack: list[dict] = []
    for ts, kind, _, i in marks:
        while stack and stack[-1]["ts"] + stack[-1].get("dur", 0.0) <= ts:
            stack.pop()
        if kind == 0:
            stack.append(annotations[i])
        elif stack:
            out[i] = "/".join(a["name"] for a in stack)
    return out


def _by_thread(evs) -> dict:
    out: dict = defaultdict(list)
    for e in evs:
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
    """``"<kernel> @ <scope>" -> {total_us, count, scope}``."""
    agg = _new_agg()
    for trace in traces:
        evs = events(trace)
        device = [e for e in evs if e.get("cat") in DEVICE_CATS]
        launches = {e["args"]["correlation"]: e for e in evs
                    if e.get("cat") in LAUNCH_CATS
                    and "correlation" in e.get("args", {})}
        annotations = _by_thread(
            e for e in evs if e.get("cat") == "user_annotation")
        held = _by_thread(launches.values())
        scope_of: dict = {}
        for key, hevs in held.items():
            for e, s in zip(hevs, _scopes_at(annotations.get(key, []), hevs)):
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
    """``"<op> @ <scope>" -> {total_us, count, scope}`` by self time."""
    agg = _new_agg()
    for trace in traces:
        evs = events(trace)
        annotations = _by_thread(
            e for e in evs if e.get("cat") == "user_annotation")
        for key, ops in _by_thread(
                e for e in evs if e.get("cat") in cats).items():
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


def phase_of(scope_path: str | None) -> str | None:
    if not scope_path:
        return None
    hits = PHASE_RE.findall(scope_path)
    return hits[-1] if hits else None


def rollup_phases(agg: dict[str, dict]):
    """``(rows, op_total_us, attributed_us)``; ``rows`` maps phase ->
    {total_us, count, ops}."""
    rows: dict[str, dict] = defaultdict(
        lambda: {"total_us": 0.0, "count": 0, "ops": []})
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
    return {k: r["total_us"] for k, r in rollup_phases(agg)[0].items()}


# ------------------------------------------------ the benchmark's own

def span_of(trace: dict, name: str) -> tuple[float, float] | None:
    """``(start, end)`` us of the ``user_annotation`` ranges named ``name``
    together (the benchmark's ``bench.step`` ranges), or None."""
    marks = [e for e in events(trace)
             if e.get("cat") == "user_annotation" and e["name"] == name]
    if not marks:
        return None
    return (min(e["ts"] for e in marks),
            max(e["ts"] + e.get("dur", 0.0) for e in marks))


def device_intervals(trace: dict, lo: float, hi: float) -> list:
    """The union of the device events' intervals, clipped to ``[lo, hi]``,
    sorted and disjoint."""
    iv = sorted((max(float(e["ts"]), lo),
                 min(float(e["ts"]) + float(e.get("dur", 0.0)), hi))
                for e in events(trace) if e.get("cat") in DEVICE_CATS)
    out: list = []
    for a, b in iv:
        if b <= a:
            continue
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def idle_gaps(trace: dict, lo: float, hi: float, top: int = 10) -> list:
    """The ``top`` longest stretches of ``[lo, hi]`` with nothing on the
    device, each ``[label, us]``; the label is the innermost host event
    (op, range or CUDA call) running at the gap's middle."""
    busy = device_intervals(trace, lo, hi)
    gaps, t = [], lo
    for a, b in busy:
        if a > t:
            gaps.append((t, a))
        t = max(t, b)
    if hi > t:
        gaps.append((t, hi))
    gaps.sort(key=lambda g: g[0] - g[1])
    host = sorted(((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)),
                    e["name"]) for e in events(trace)
                   if e.get("cat") in HOST_CATS), key=lambda h: h[0])
    starts = [h[0] for h in host]
    out = []
    for a, b in gaps[:top]:
        mid = 0.5 * (a + b)
        best = None
        for h in host[:bisect.bisect_right(starts, mid)]:
            if h[1] >= mid and (best is None
                                or h[1] - h[0] < best[1] - best[0]):
                best = h
        out.append([best[2] if best else "(no host event)", b - a])
    return out
