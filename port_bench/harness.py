"""One run of one cell: set-up, a measured window, the check, the result.

Everything particular to a cell is found by name from ``BENCHMARK.json``:
the configuration ``configs/<config>.json`` names its family's driver
``drivers/<driver>.py``; the mix is ``traffic/<traffic>.json``, read by
the generator ``traffic/<traffic>.py`` where the mix brings one, by the
shared ``traffic/generator.py`` otherwise; each per-layer metric is
``metrics/<name>.py``, a ``read(view)`` that returns a number or None
(nothing to read).

The window runs MPC steps for ``--seconds`` on the host clock and ends in
a synchronise. ``scenario_steps_per_s`` is every scenario-step completed
over the window's seconds; ``step_ms_p95`` the 95th percentile of the
steps' times between consecutive CUDA events (the first from an event at
the window's start); ``setup_s`` the seconds from the process's start to
the window's. An end-to-end metric ``<name>.<cells>`` is ``<name>``
again, under a bound of its own for the cells it lists. With ``--trace 1``
a fixed run of steps inside the window is profiled, and the per-layer
metrics are read from that trace and the run's counters.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import statistics
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HERE = os.path.dirname(os.path.abspath(__file__))
# Top-level module names that may not be loaded when a run ends.
FORBIDDEN = ("jax", "jaxlib", "flax", "tpu_aerial_transport")
# Environment switches of the port that would change a configuration.
PROGRAM_SWITCHES = ("TAT_EFFORT", "TAT_ENV_QUERY", "TPU_AERIAL_PRECISION")
WARMUP_STEPS = 2
# A gap that is no number, or a flag that differs, reads this.
FAR = 1e9
TRACE_FROM, TRACE_STEPS = 2, 3
# Episodes whose starts are drawn in set-up (more are drawn as needed).
PREPARED_EPISODES = 8


def process_start() -> float:
    """The process's start on the ``CLOCK_BOOTTIME`` clock, in s."""
    with open("/proc/self/stat", encoding="ascii") as fh:
        fields = fh.read().rsplit(")", 1)[1].split()
    return int(fields[19]) / os.sysconf("SC_CLK_TCK")


def boottime() -> float:
    return time.clock_gettime(time.CLOCK_BOOTTIME)


def load_module(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_json(path: str) -> dict:
    with open(path, encoding="utf-8") as fh:
        return json.load(fh)


class Cell:
    """A cell of ``BENCHMARK.json`` with its configuration, mix, driver
    and per-layer metrics, all found by name under ``bench_dir``."""

    def __init__(self, name: str, root: str = ROOT, bench_dir: str = HERE):
        self.bench = load_json(os.path.join(root, "BENCHMARK.json"))
        cells = {w["name"]: w for w in self.bench["workloads"]}
        if name not in cells:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json")
        self.entry = cells[name]
        self.name = name
        self.config = load_json(os.path.join(
            bench_dir, "configs", self.entry["config"] + ".json"))
        from port_bench.traffic import generator
        mix = self.entry["traffic"]
        own = os.path.join(bench_dir, "traffic", mix + ".py")
        self.generator = (load_module(own, "port_bench_traffic_"
                                      + mix.replace("-", "_").replace(".", "_"))
                          if os.path.isfile(own) else generator)
        self.traffic = generator.load(mix, os.path.join(bench_dir, "traffic"))
        self.driver = load_module(
            os.path.join(bench_dir, "drivers", self.config["driver"] + ".py"),
            "port_bench_driver_" + self.config["driver"])
        self.end_to_end = [m for m in self.bench["end_to_end"]
                           if name in m.get("workloads", [name])]
        reported = {m["name"] for m in self.end_to_end}
        self.per_layer = [m for m in self.bench["per_layer"]
                          if name in m.get("workloads", [name])
                          and m["moves"] in reported]
        self.bench_dir = bench_dir

    def reader(self, metric: str):
        return load_module(os.path.join(self.bench_dir, "metrics",
                                        metric + ".py"),
                           "port_bench_metric_" + metric.replace("-", "_")
                           .replace(".", "_")).read


class Clock:
    """Step-end marks: CUDA events on the card, the host clock on the
    CPU (tests)."""

    def __init__(self, cuda: bool):
        self.cuda = cuda
        self.marks: list = []

    def mark(self):
        if self.cuda:
            import torch
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.marks.append(ev)
        else:
            self.marks.append(time.perf_counter())

    def step_ms(self) -> list[float]:
        m = self.marks
        if self.cuda:
            return [a.elapsed_time(b) for a, b in zip(m, m[1:])]
        return [(b - a) * 1e3 for a, b in zip(m, m[1:])]


class TraceView:
    """What a per-layer metric reads: the profiled steps' trace (None
    without one) and the run's record."""

    def __init__(self, trace, steps: int, record: dict):
        from port_bench import trace as tr
        self.tr = tr
        self.trace, self.steps, self.record = trace, steps, record
        self._cache: dict = {}

    def has_device(self) -> bool:
        return self.trace is not None and any(
            e.get("cat") in self.tr.DEVICE_CATS
            for e in self.tr.events(self.trace))

    def _get(self, key, fn):
        if key not in self._cache:
            self._cache[key] = fn()
        return self._cache[key]

    def device_agg(self):
        return self._get("dev", lambda: self.tr.device_aggregate([self.trace]))

    def host_agg(self):
        """Host self time by op and scope, the benchmark's own
        ``bench.step`` ranges left out (they hold the whole step)."""
        def make():
            own = {"traceEvents": [e for e in self.tr.events(self.trace)
                                   if e["name"] != "bench.step"]}
            return self.tr.host_aggregate([own], self.tr.HOST_CATS)
        return self._get("host", make)

    def device_phase_us(self) -> dict:
        return self._get("dph", lambda: self.tr.phase_us(self.device_agg()))

    def host_phase_us(self) -> dict:
        return self._get("hph", lambda: self.tr.phase_us(self.host_agg()))

    def span(self):
        """``(lo, hi)`` us of the profiled steps: from the first
        ``bench.step`` range to the later of the last one's end and the
        last device event's."""
        def make():
            s = self.tr.span_of(self.trace, "bench.step")
            if s is None:
                return None
            ends = [float(e["ts"]) + float(e.get("dur", 0.0))
                    for e in self.tr.events(self.trace)
                    if e.get("cat") in self.tr.DEVICE_CATS]
            return (s[0], max([s[1]] + ends))
        return self._get("span", make)

    def busy_us(self) -> float:
        lo, hi = self.span()
        return sum(b - a for a, b in self.tr.device_intervals(
            self.trace, lo, hi))


def quantile_95(values: list[float]) -> float:
    """The 95th percentile (``statistics.quantiles``, exclusive method)."""
    if len(values) < 2:
        return values[0]
    return statistics.quantiles(values, n=20)[18]


def run(workload: str, seed: int, seconds: float, trace: bool, *,
        device: str | None = None, root: str = ROOT, bench_dir: str = HERE,
        check_imports: bool = True, patch=None, out=sys.stdout,
        err=sys.stderr) -> int:
    """One run; prints the result line and returns the exit code.
    ``device`` other than None skips the look for a card (tests run the
    plain CPU path); ``patch(driver)`` may replace parts of the program
    after set-up (the tests' planted faults)."""
    t_proc = process_start()
    for k in PROGRAM_SWITCHES:
        os.environ.pop(k, None)
    os.environ["TAT_TORCH_BUILD_DIR"] = os.path.join(root, "build",
                                                     "kernels")
    cell = Cell(workload, root, bench_dir)
    import torch

    chips = int(cell.entry["chips"])
    if device is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
            print(f"port_bench: {workload} needs {chips} CUDA device(s); "
                  f"torch.cuda.is_available()={torch.cuda.is_available()}",
                  file=err)
            return 2
        device = "cuda"
    cuda = device == "cuda"
    drv = cell.driver.build(cell.config, cell.traffic, seed, device,
                            cell.generator)
    drv.prepare(PREPARED_EPISODES)
    drv.warm_up(WARMUP_STEPS)
    if patch is not None:
        patch(drv)
    prof = None
    if trace:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if cuda:
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)
    if cuda:
        torch.cuda.synchronize()
    clock = Clock(cuda)
    setup_s = boottime() - t_proc
    t0 = time.perf_counter()
    clock.mark()
    k = 0
    while True:
        if prof is not None and k == TRACE_FROM:
            drv.hold_inputs(TRACE_STEPS)
            prof.start()
        with torch.profiler.record_function("bench.step"):
            drv.step()
        clock.mark()
        k += 1
        if prof is not None and k == TRACE_FROM + TRACE_STEPS:
            prof.stop()
        if time.perf_counter() - t0 >= seconds and (
                prof is None or k >= TRACE_FROM + TRACE_STEPS):
            break
    if cuda:
        torch.cuda.synchronize()
    window_s = time.perf_counter() - t0
    step_ms = clock.step_ms()
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    record = drv.record()
    S = record["scenarios"]
    drv.free()
    if cuda:
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    gaps = drv.check()
    checks, n_bad = judge(gaps, cell.config["limits"])
    print(f"port_bench: {k} steps in {window_s:.3f} s; the check took "
          f"{time.perf_counter() - t_check:.3f} s", file=err)
    correct = n_bad == 0
    if trace:
        view = traced_view(prof, cell, root, record, drv)
        metrics = {}
        for m in cell.per_layer:
            v = cell.reader(m["name"])(view)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        values = {"scenario_steps_per_s": k * S / window_s,
                  "step_ms_p95": quantile_95(step_ms),
                  "setup_s": setup_s}
        metrics = {m["name"]: {"value": values[m["name"].split(".")[0]],
                               "unit": m["unit"]}
                   for m in cell.end_to_end}
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": chips, "memory_peak_bytes": int(peak)}
    result = {"correct": correct, "attempted": k * S, "failed": n_bad,
              "metrics": metrics, "device": dev}
    if trace:
        dev["busy_s"] = view.busy_us() / 1e6 if view.span() else 0.0
        dev["window_s"] = ((view.span()[1] - view.span()[0]) / 1e6
                           if view.span() else 0.0)
        result["breakdown"] = breakdown(view)
    result["checks"] = checks
    if check_imports:
        found = sorted({m.split(".")[0] for m in sys.modules}
                       & set(FORBIDDEN))
        if found:
            print(f"port_bench: the run loaded {found}", file=err)
            return 3
    for name, c in checks.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=err)
    print(json.dumps(result), file=out)
    out.flush()
    return 0


def judge(gaps: dict, limits: dict) -> tuple[dict, int]:
    """The numbers a configuration's ``limits`` name, each beside its
    limit, and how many are over it. Over the sampled scenario-steps:
    ``count_flip_share``, the share whose consensus counts or worst
    fractions of solves that met their tolerance (centralized: the solve's
    outcome) differ from the reference's; the force, carry and environment
    gaps where those agree, as the widest (``force_gap_N``, ``carry_gap``,
    ``env_gap_m``; an environment gap reads ``FAR`` where the collision
    flags differ, as does any gap that is not finite) or the 99th
    percentile (``*_q99*``), and the widest force and carry gaps where,
    besides, every solve met its tolerance (``force_gap_ok_N``,
    ``carry_gap_ok``); ``state_gap``, the widest gap of the state after
    the substeps."""
    import torch

    agree = gaps["same"].to(torch.bool)
    all_ok = agree & gaps["all_ok"].to(torch.bool)
    gaps = {k: torch.nan_to_num(v.to(torch.float64), nan=FAR, posinf=FAR)
            for k, v in gaps.items() if v.is_floating_point()}
    values = {"count_flip_share":
              1.0 - float(agree.to(torch.float64).mean())}

    def widest(t):
        return float(t.max()) if t.numel() else 0.0

    for key, wide, q99 in (
            ("force", "force_gap_N", "force_gap_q99_N"),
            ("carry", "carry_gap", "carry_gap_q99"),
            ("env", "env_gap_m", "env_gap_q99_m")):
        t = gaps[key][agree]
        values[wide] = widest(t)
        values[q99] = (float(torch.quantile(t, 0.99)) if t.numel()
                       else 0.0)
    values["force_gap_ok_N"] = widest(gaps["force"][all_ok])
    values["carry_gap_ok"] = widest(gaps["carry"][all_ok])
    values["state_gap"] = float(gaps["state"].max())
    checks = {k: {"value": values[k], "limit": limits[k]} for k in limits}
    n_bad = sum(not c["value"] <= c["limit"] for c in checks.values())
    return checks, n_bad


def traced_view(prof, cell, root, record, drv) -> TraceView:
    from port_bench import trace as tr
    out_dir = os.path.join(root, "build", "port_bench")
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"trace-{cell.name}.json")
    prof.export_chrome_trace(path)
    record["solve_work"] = drv.solve_work()
    return TraceView(tr.load(path), TRACE_STEPS, record)


def breakdown(view: TraceView) -> dict:
    """The device operations that took most time and the longest idle
    gaps, each ``[name, seconds]``, at most 10."""
    if not view.has_device() or view.span() is None:
        return {"device_ops": [], "idle_gaps": []}
    by_name: dict = {}
    for key, a in view.device_agg().items():
        name = key.split(" @ ")[0]
        by_name[name] = by_name.get(name, 0.0) + a["total_us"]
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    lo, hi = view.span()
    return {"device_ops": [[n[:120], us / 1e6] for n, us in ops],
            "idle_gaps": [[n[:120], us / 1e6] for n, us in
                          view.tr.idle_gaps(view.trace, lo, hi)]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Run one benchmark cell once.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = ap.parse_args(argv)
    return run(a.workload, a.seed, a.seconds, bool(a.trace))
