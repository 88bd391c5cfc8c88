"""The readings the check's limits are set from, on the chip at a cell's
own size: for each seed, the program's gaps against the float32 reference
(the lower readings), and for the first ``--control`` seeds the control's,
the reference computed with TF32 products, against the same (the upper
readings). One process reads every seed, so the set-up is paid once per
seed and not once per process:

    python3 -m port_bench.calibrate --workload <cell> --seeds 1,2,3 \
        --control 3 [--out build/calibrate-<cell>.json]

Each seed runs its sampled steps (the first ``SAMPLE_WITHIN`` steps at
most) and prints one JSON line of readings under the check's names.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

from port_bench import harness


def readings(gaps: dict) -> dict:
    """The check's numbers of one set of gaps, and the force gaps'
    quantiles (where the count agrees) to see the tail."""
    import torch

    limits = {k: float("inf") for k in (
        "count_flip_share", "force_gap_N", "force_gap_q99_N", "carry_gap",
        "carry_gap_q99", "force_gap_ok_N", "carry_gap_ok", "env_gap_m",
        "env_gap_q99_m", "state_gap")}
    checks, _ = harness.judge(gaps, limits)
    out = {k: c["value"] for k, c in checks.items()}
    same = gaps["same"].to(torch.bool)
    for key in ("force", "carry", "env", "state"):
        t = gaps[key][same].to(torch.float64)
        if t.numel():
            for q in (0.5, 0.99):
                out[f"{key}_q{q}"] = float(torch.quantile(t, q))
    out["n"] = int(gaps["same"].numel())
    at_cap = gaps["at_cap"].to(torch.bool)
    failing = ~gaps["all_ok"].to(torch.bool)
    for name, t in (("at_cap_share", at_cap), ("failing_share", failing),
                    ("cap_or_failing_share", at_cap | failing)):
        out[name] = float(t.to(torch.float64).mean())
    out["env_active_share"] = float(
        gaps["env_active"].to(torch.float64).mean())
    return out


def run_seed(cell, seed: int, device: str, control: bool) -> dict:
    drv = cell.driver.build(cell.config, cell.traffic, seed, device,
                            cell.generator)
    drv.warm_up(harness.WARMUP_STEPS)
    last = max(drv.sample_steps)
    t0 = time.perf_counter()
    while drv.k <= last:
        drv.step()
    if device == "cuda":
        import torch
        torch.cuda.synchronize()
    out = {"seed": seed, "steps": drv.k,
           "step_s": (time.perf_counter() - t0) / drv.k}
    drv.free()
    out["program"] = readings(drv.check())
    if control:
        out["control"] = readings(drv.check(tf32_control=True))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True,
                    help="comma-separated seeds")
    ap.add_argument("--control", type=int, default=3,
                    help="the control runs on the first this many seeds")
    ap.add_argument("--out", default=None)
    a = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 2
    cell = harness.Cell(a.workload)
    rows = []
    for i, s in enumerate(int(x) for x in a.seeds.split(",")):
        row = run_seed(cell, s, "cuda", i < a.control)
        rows.append(row)
        print(json.dumps(row), flush=True)
    if a.out:
        os.makedirs(os.path.dirname(a.out) or ".", exist_ok=True)
        with open(a.out, "w", encoding="utf-8") as fh:
            json.dump(rows, fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
