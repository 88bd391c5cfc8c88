#!/usr/bin/env python3
"""Smoke run of the PyTorch port (tpu_aerial_transport_torch) on one card.

    python3 chip_smoke.py

Phases, each fatal on failure (the script exits non-zero and prints no result):

1. build every CUDA kernel of the port from ``tpu_aerial_transport_torch/csrc``
   (one ``nvcc`` per source, all started together) into ``build/kernels``;
2. drive the port's main path -- the headline C-ADMM forest rollout, 256
   scenarios x 8 agents, ``max_iter=20``, ``inner_iters=20``, forest seed 0 --
   through ``harness.rollout.build``: one warm-up MPC step, then
   ``TIMED_STEPS`` timed steps with every launch counter set to 0 just before
   and read just after; the whole-solve kernel must have launched exactly
   once per consensus iteration run, and the states must stay finite;
3. hold each kernel against its plain PyTorch version on the card, on the
   inputs the main path gives it (captured from the warm-up step): the
   headline shapes with and without the cone shift, a ragged lane count, and
   the unpadded agent QPs; time kernel and plain version with CUDA events
   and compute the kernel's bound from this run's shapes;
4. profile one MPC step (``torch.profiler``) and attribute device and host
   time to the ``tat.*`` phases;
5. run the first MPC step of 8 scenarios on the CPU (plain path) and hold
   the card's lanes against it.

Output: timing lines carry the card's name and power limit; a ``kernels``
JSON line, the ``nvidia-smi`` name/power-limit line, and last
``{"ok": true, "device": {...}}``. The full report is written as JSON to
``build/chip_smoke.json``, or to the path in ``TAT_SMOKE_REPORT``.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
PKG = "tpu_aerial_transport_torch"

N_AGENTS, N_SCENARIOS, TIMED_STEPS = 8, 256, 10
# Published H100 SXM peaks (NVIDIA data sheet): HBM3 bandwidth and float32
# outside the tensor cores.
PEAK_BYTES_S = 3.35e12
PEAK_F32_FLOP_S = 67e12
# Kernel against its plain version: both float32 on the card; the matvec
# sums run in another order (sequential FMA in the kernel, cuBLAS in the
# plain version) and 20 iterations with 1e3-boosted equality penalties
# amplify that rounding. The bar is the JAX package's own for its compiled
# kernel form (atol 1e-4 after 30 iterations), scaled by the output's size.
KERNEL_ATOL = 1e-4
CPU_STATE_ATOL = 1e-4
CPU_FORCE_ATOL = 1e-2  # the consensus tolerance res_tol, in N.


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    raise SystemExit(1)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if out.returncode != 0 or not out.stdout.strip():
        fail(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    """Device milliseconds per call of ``fn``: ``reps`` calls captured in
    one CUDA graph, replayed and timed with CUDA events, so the host's
    launch overhead (which on a shared host can exceed a short kernel's
    run time) does not enter the number."""
    import torch

    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def phase_breakdown(prof) -> dict:
    """Device and host microseconds per innermost ``tat.*`` phase."""
    def dev(ev):
        v = getattr(ev, "self_device_time_total", None)
        return v if v is not None else getattr(ev, "self_cuda_time_total", 0)

    device, host = {}, {}

    def walk(ev, phase):
        if ev.name.startswith("tat."):
            phase = ev.name[4:]
        device[phase] = device.get(phase, 0.0) + float(dev(ev))
        host[phase] = host.get(phase, 0.0) + float(ev.self_cpu_time_total)
        for ch in ev.cpu_children:
            walk(ch, phase)

    kernels_us = own_us = 0.0
    for ev in prof.events():
        kind = str(ev.device_type)
        if ev.cpu_parent is None and kind.endswith("CPU"):
            walk(ev, "other")
        elif kind.endswith("CUDA") and not (
                getattr(ev, "is_user_annotation", False)
                or ev.name.startswith("tat.")):
            kernels_us += float(ev.device_time_total)
            if "fused_solve_kernel" in ev.name:
                own_us += float(ev.device_time_total)
    # The port's own kernels launch through their library's statically
    # linked runtime, which the trace does not tie to a host range: they
    # are named here, and only what remains is unattributed.
    device["fused_solve"] = device.get("fused_solve", 0.0) + own_us
    device["unattributed"] = max(kernels_us - sum(device.values()), 0.0)
    return {"device_us": device, "host_us": host, "kernels_us": kernels_us}


def main() -> int:
    if not os.path.isdir(os.path.join(HERE, PKG)):
        print(f"chip_smoke: the {PKG} package is not beside this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False: this smoke "
              "runs on an NVIDIA card only", file=sys.stderr)
        return 1

    from tpu_aerial_transport_torch.harness import rollout
    from tpu_aerial_transport_torch.ops import _build, admm_kernel

    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(f"device: {kind} | {card} | torch {torch.__version__} "
          f"cuda {torch.version.cuda} | host: {os.cpu_count()} cores, load "
          f"{os.getloadavg()[0]:.2f}", flush=True)
    report = {"card": card, "kind": kind}

    # 1. Build.
    t0 = time.perf_counter()
    built = _build.build()
    build_s = time.perf_counter() - t0
    print(f"build: {sorted(built)} in {build_s:.2f} s", flush=True)
    for name, (_, log) in built.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                print(f"  ptxas[{name}]: {line.strip()}")
    report["build_s"] = build_s

    # 2. The main path, with the warm-up step's kernel inputs captured.
    run, css0, states0 = rollout.build(
        n=N_AGENTS, n_scenarios=N_SCENARIOS, max_iter=20, inner_iters=20,
        device="cuda",
    )
    captured = []
    launch = admm_kernel.fused_solve_lanes

    def capture(*args, **kw):
        if not captured:
            captured.append(([None if a is None else a.clone() for a in args],
                             dict(kw)))
        return launch(*args, **kw)

    admm_kernel.fused_solve_lanes = capture
    try:
        css1, states1, iters1 = run(css0, states0, 1)
    finally:
        admm_kernel.fused_solve_lanes = launch
    torch.cuda.synchronize()
    first_step = (css1, states1, iters1)

    for k in admm_kernel.LAUNCHES:
        admm_kernel.LAUNCHES[k] = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    css, states, iters = run(css0, states0, TIMED_STEPS)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = dict(admm_kernel.LAUNCHES)
    consensus_iters = int(iters.max(dim=1).values.sum())
    if launches["fused_solve"] <= 0:
        fail("the main path never launched the fused_solve kernel")
    if launches["fused_solve"] != consensus_iters:
        fail(f"fused_solve launches {launches['fused_solve']} != consensus "
             f"iterations run {consensus_iters}")
    for f in ("R", "w", "xl", "vl", "Rl", "wl"):
        if not bool(torch.isfinite(getattr(states, f)).all()):
            fail(f"non-finite state field {f} after the timed steps")
    if not bool(torch.isfinite(css.f).all()):
        fail("non-finite consensus forces after the timed steps")
    rate = N_SCENARIOS * TIMED_STEPS / elapsed
    it = iters.to(torch.float32)
    print(f"main path: {N_SCENARIOS}x{N_AGENTS} C-ADMM forest, "
          f"{TIMED_STEPS} MPC steps in {elapsed:.4f} s = {rate:.2f} "
          f"scenario-MPC-steps/s | consensus iters/step mean "
          f"{float(it.mean()):.3f} max {int(iters.max())} | launches "
          f"{launches} = consensus iterations run {consensus_iters} | {card}",
          flush=True)
    report["main_path"] = {
        "scenario_mpc_steps_per_s": rate, "seconds": elapsed,
        "timed_steps": TIMED_STEPS, "iters_mean": float(it.mean()),
        "iters_max": int(iters.max()),
        "iters_per_step_max": iters.max(dim=1).values.tolist(),
        "launches": launches,
    }

    # 3. Kernel against its plain version on the main path's inputs.
    if not captured:
        fail("no fused_solve call captured in the warm-up step")
    args, kw = captured[0]
    nv, n_box, soc = kw["nv"], kw["n_box"], tuple(kw["soc_dims"])
    m = args[8].shape[-1]
    unpadded_args, unpadded_kw = None, None
    run_u, css_u, states_u = rollout.build(
        n=N_AGENTS, n_scenarios=125, max_iter=20, inner_iters=20,
        pad_operators=False, device="cuda",
    )
    captured.clear()
    admm_kernel.fused_solve_lanes = capture
    try:
        run_u(css_u, states_u, 1)
    finally:
        admm_kernel.fused_solve_lanes = launch
    unpadded_args, unpadded_kw = captured[0]

    def lanes(a, B):
        return [None if t is None else t[:B].contiguous() for t in a]

    cases = [
        ("headline", args, kw),
        ("headline_no_shift", args[:11] + [None], kw),
        ("ragged_B1000", lanes(args, 1000), kw),
        ("unpadded", unpadded_args, unpadded_kw),
    ]
    names = ("x", "y", "z", "prim_res", "dual_res")
    checks = {}
    for case, a, k in cases:
        got = launch(*a, **k)
        ref = admm_kernel.fused_solve_lanes_reference(*a, **k)
        torch.cuda.synchronize()
        errs, ok = {}, True
        for nm, g, r in zip(names, got, ref):
            err = float((g - r).abs().max())
            scale = max(1.0, float(r.abs().max()))
            errs[nm] = err
            ok = ok and err <= KERNEL_ATOL * scale and bool(
                torch.isfinite(g).all())
        B = a[0].shape[0]
        print(f"kernel check {case}: B={B} nv={k['nv']} m={a[8].shape[-1]} "
              f"n_box={k['n_box']} soc={tuple(k['soc_dims'])} "
              f"iters={k['iters']} shift={a[11] is not None} max|err| "
              + " ".join(f"{n}={e:.3e}" for n, e in errs.items())
              + f" (atol {KERNEL_ATOL} x max(1, |ref|)) "
              + ("ok" if ok else "FAIL"), flush=True)
        checks[case] = {"B": B, "max_abs_err": errs, "ok": ok}
        if not ok:
            fail(f"kernel disagrees with its plain version on {case}")
    report["kernel_checks"] = checks

    B = args[0].shape[0]
    iters_k = kw["iters"]
    bytes_ = B * admm_kernel.fused_solve_bytes_per_lane(nv, m, n_box)
    flops = B * admm_kernel.fused_solve_flops_per_lane(nv, m, iters_k, soc)
    t_bytes = bytes_ / PEAK_BYTES_S * 1e3
    t_ops = flops / PEAK_F32_FLOP_S * 1e3
    bound_ms = max(t_bytes, t_ops)
    bound_by = "bytes" if t_bytes >= t_ops else "operations"
    kernel_ms = cuda_ms(lambda: launch(*args, **kw), 100)
    plain_ms = cuda_ms(
        lambda: admm_kernel.fused_solve_lanes_reference(*args, **kw), 5)
    print(f"fused_solve timing (B={B}, d={nv + m}, iters={iters_k}): kernel "
          f"{kernel_ms:.4f} ms/launch, plain PyTorch {plain_ms:.4f} ms, bound "
          f"{bound_ms:.4f} ms by {bound_by} ({bytes_ / 1e6:.2f} MB / "
          f"{PEAK_BYTES_S / 1e12:.2f} TB/s = {t_bytes:.4f} ms; "
          f"{flops / 1e6:.1f} MFLOP / {PEAK_F32_FLOP_S / 1e12:.0f} TFLOP/s = "
          f"{t_ops:.4f} ms); no single PyTorch call computes this function "
          f"| {card}", flush=True)
    report["fused_solve"] = {
        "kernel_ms": kernel_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
        "bound_by": bound_by, "bytes": bytes_, "flops": flops,
    }

    # 4. Where one MPC step's time goes.
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run(css0, states0, 1)
        torch.cuda.synchronize()
        step_s = time.perf_counter() - t0
    phases = phase_breakdown(prof)
    kernel_rows = [e for e in prof.key_averages()
                   if "fused_solve_kernel" in e.key]
    dev_total = phases["kernels_us"] or sum(phases["device_us"].values())
    in_path_us = None
    if kernel_rows:
        r = kernel_rows[0]
        tot = getattr(r, "device_time_total", None)
        if tot is None:
            tot = getattr(r, "cuda_time_total", 0.0)
        in_path_us = float(tot) / max(int(r.count), 1)
    print(f"profile of one MPC step: wall {step_s * 1e3:.2f} ms (profiler "
          f"on), device busy {dev_total / 1e3:.2f} ms = "
          f"{100 * dev_total / 1e3 / (step_s * 1e3):.1f}% | {card}",
          flush=True)
    for ph in sorted(phases["device_us"],
                     key=lambda p: -phases["device_us"][p]):
        print(f"  tat.{ph}: device {phases['device_us'][ph] / 1e3:.3f} ms, "
              f"host {phases['host_us'].get(ph, 0.0) / 1e3:.3f} ms")
    print(f"  fused_solve_kernel in the main path: "
          + ("not found in the trace" if in_path_us is None
             else f"{in_path_us / 1e3:.4f} ms/launch"), flush=True)
    report["profile"] = {"wall_ms": step_s * 1e3, "phases": phases,
                         "fused_solve_kernel_us_per_launch": in_path_us}

    # 5. The card's first step against the CPU's plain path, 8 scenarios.
    n_cpu = 8
    step_cpu, cs0_cpu, _ = rollout.make_mpc_step(
        "cadmm", N_AGENTS, max_iter=20, inner_iters=20, pad_operators=True,
        device="cpu",
    )
    to_cpu = lambda t: t[:n_cpu].cpu()  # noqa: E731
    st_cpu = type(states0)(**{k: to_cpu(v) for k, v in
                              vars(states0).items()})
    css_cpu = rollout.stack_scenarios(cs0_cpu, n_cpu)
    css_c, st_c, stats_c = step_cpu(css_cpu, st_cpu)
    css_g, st_g, it_g = first_step
    it_cpu = stats_c.iters.numpy()
    it_card = it_g[0, :n_cpu].cpu().numpy()
    errs = {f: float((getattr(st_c, f) - to_cpu(getattr(st_g, f))).abs().max())
            for f in ("R", "w", "xl", "vl", "Rl", "wl")}
    f_err = float((css_c.f - to_cpu(css_g.f)).abs().max())
    same_iters = int((it_cpu == it_card).sum())
    ok = max(errs.values()) <= CPU_STATE_ATOL and f_err <= CPU_FORCE_ATOL
    print(f"card vs CPU, first MPC step of {n_cpu} scenarios: max|state err| "
          + " ".join(f"{k}={v:.2e}" for k, v in errs.items())
          + f" (atol {CPU_STATE_ATOL}), max|force err| {f_err:.2e} N (atol "
          f"{CPU_FORCE_ATOL}), consensus iterations equal in {same_iters}/"
          f"{n_cpu} (card {it_card.tolist()}, CPU {it_cpu.tolist()}) "
          + ("ok" if ok else "FAIL"), flush=True)
    report["card_vs_cpu"] = {"state_err": errs, "force_err": f_err,
                             "iters_card": it_card.tolist(),
                             "iters_cpu": it_cpu.tolist(), "ok": ok}
    if not ok:
        fail("the card's first step disagrees with the CPU plain path")

    kernels = [{
        "name": "fused_solve", "route": "cuda",
        "source": f"{PKG}/csrc/fused_solve.cu",
        "replaces": "tpu_aerial_transport/ops/admm_kernel.py:283",
        "launches": launches["fused_solve"],
        "max_abs_err": max(max(c["max_abs_err"].values())
                           for c in checks.values()),
        "ms": kernel_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
        "bound_by": bound_by, "library_ms": None,
    }]
    report["kernels"] = kernels
    path = os.environ.get("TAT_SMOKE_REPORT") or os.path.join(
        HERE, "build", "chip_smoke.json")
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        json.dump(report, f, indent=1, default=str)
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
