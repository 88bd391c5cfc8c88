"""The batch-size sweep that sizes a cell to the card: for each batch
``S``, the mean step time over ``--steps`` steps (CUDA events, after the
warm-up), the steps a window of ``--seconds`` would complete, the peak
device memory, and the device's idle share over ``TRACE_STEPS`` profiled
steps:

    python3 -m port_bench.sweep --workload <cell> --sizes 4096,8192 \
        [--steps 8] [--seconds 30]

A size that runs out of memory ends the sweep. One JSON line a size.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile

from port_bench import harness
from port_bench import trace as tr


def measure(cell, S: int, steps: int, seconds: float) -> dict:
    import torch

    config = dict(cell.config, scenarios=S)
    torch.cuda.reset_peak_memory_stats()
    drv = cell.driver.build(config, cell.traffic, 1, "cuda", cell.generator)
    drv.warm_up(harness.WARMUP_STEPS)
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(steps):
        drv.step()
    b.record()
    torch.cuda.synchronize()
    step_ms = a.elapsed_time(b) / steps
    prof = torch.profiler.profile(activities=[
        torch.profiler.ProfilerActivity.CPU,
        torch.profiler.ProfilerActivity.CUDA])
    with prof:
        for _ in range(harness.TRACE_STEPS):
            with torch.profiler.record_function("bench.step"):
                drv.step()
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "trace.json")
        prof.export_chrome_trace(path)
        view = harness.TraceView(tr.load(path), harness.TRACE_STEPS, {})
    lo, hi = view.span()
    out = {"S": S, "step_ms": step_ms,
           "window_steps": int(seconds * 1e3 / step_ms),
           "memory_peak_bytes": int(torch.cuda.max_memory_allocated()),
           "traced_ms_per_step": (hi - lo) / 1e3 / harness.TRACE_STEPS,
           "idle_pct": 100.0 * (1.0 - view.busy_us() / (hi - lo))}
    del drv, view, prof
    torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--sizes", required=True)
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--seconds", type=float, default=30.0)
    a = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("sweep: no CUDA device", file=sys.stderr)
        return 2
    cell = harness.Cell(a.workload)
    for S in (int(x) for x in a.sizes.split(",")):
        try:
            row = measure(cell, S, a.steps, a.seconds)
        except torch.cuda.OutOfMemoryError as e:
            print(json.dumps({"S": S, "oom": str(e)[:200]}), flush=True)
            break
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
