"""Main simulation entry point: an RQP team flying through the forest under
centralized, C-ADMM or dual-decomposition MPC, on the card.

The port's counterpart of ``examples/rqp_forest.py`` (the reference's
``example/rqp_example.py:main()``): n agents, dt = 1e-3 s, high-level
control at 100 Hz, the seeded forest and the terrain-following reference;
one scenario (a batch of 1 on the controllers' scenario axis), the ten
substeps of every step replayed from a CUDA graph on the card
(``harness.rollout.jit_rollout``). Every agent QP goes through the
whole-solve kernel's warp body (``cadmm``, ``dd``), the centralized QP
through its block body's early-exit form; the launches of each kernel
entry point are printed at the end.

Usage:
  python3 -m tpu_aerial_transport_torch.examples.rqp_forest \\
      --controller centralized -T 10
  python3 -m tpu_aerial_transport_torch.examples.rqp_forest \\
      --controller cadmm -n 8 -T 5 --out run.npz --plots

Preemption-safe runs (``harness.checkpoint``, ``resilience.recovery``):
split the rollout into checkpointed chunks, survive SIGTERM/SIGINT at any
boundary, and resume bit-exactly from the journal:

  python3 -m tpu_aerial_transport_torch.examples.rqp_forest \\
      --controller cadmm -T 10 --chunks 10 --ckpt-dir /tmp/run1
  # ... kill it mid-run, then:
  python3 -m tpu_aerial_transport_torch.examples.rqp_forest \\
      --resume /tmp/run1

Run-health telemetry (``obs.telemetry``, ``obs.export``): ``--telemetry``
threads the accumulator through the rollout's carry and ``--metrics``
writes the schema-versioned metrics jsonl.

It takes the JAX example's flags and ``--device`` (default ``cuda``;
``cpu`` runs the plain PyTorch path). ``--out`` writes the JAX example's npz
layout (``state_*`` keys, time-leading arrays), so either package's
``replay.py`` reads either package's log. ``--plots`` needs matplotlib and
refuses to start without it.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import time

import numpy as np
import torch

from tpu_aerial_transport_torch import resolve_device


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--controller", default="centralized",
                   choices=["centralized", "cadmm", "dd"])
    p.add_argument("-n", type=int, default=3, help="number of quadrotors")
    p.add_argument("-T", type=float, default=10.0, help="sim horizon [s]")
    p.add_argument("--dt", type=float, default=1e-3)
    p.add_argument("--hl-rel-freq", type=int, default=10)
    p.add_argument("--seed", type=int, default=0, help="forest seed")
    p.add_argument("--out", default=None, help="npz log path")
    p.add_argument("--plots", action="store_true", help="save figures")
    p.add_argument("--time-chunk", type=int, default=10, metavar="C",
                   help="MPC steps per timed rollout chunk for the "
                        "wall-clock statistics (0 disables the timing pass)")
    p.add_argument("--chunks", type=int, default=0, metavar="C",
                   help="run as C checkpointed chunks (snapshot + journal "
                        "at every boundary; needs --ckpt-dir; SIGTERM/SIGINT "
                        "stop gracefully)")
    p.add_argument("--ckpt-dir", default=None, metavar="DIR",
                   help="run directory for --chunks (journal.jsonl + "
                        "carry/logs snapshots)")
    p.add_argument("--resume", default=None, metavar="DIR",
                   help="resume a --chunks run from DIR's journal; the "
                        "run's settings (controller/n/T/seed/...) are "
                        "restored from the journal and the matching flags "
                        "are ignored")
    p.add_argument("--telemetry", action="store_true",
                   help="thread the run-health accumulator "
                        "(obs.telemetry) through the rollout carry")
    p.add_argument("--metrics", default=None, metavar="PATH",
                   help="metrics jsonl path (obs.export; default with "
                        "--chunks: <ckpt-dir>/run.metrics.jsonl)")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu")
    return p.parse_args(argv)


def require_matplotlib(flag: str) -> None:
    """Refuse a figure-drawing flag up front on a host without matplotlib,
    before any rollout runs."""
    if importlib.util.find_spec("matplotlib") is None:
        raise SystemExit(f"{flag} draws figures with matplotlib, which is "
                         "not installed on this host")


def drop_scenario_axis(logs):
    """``(T, 1, ...)`` rollout logs as the JAX example's ``(T, ...)``."""
    from tpu_aerial_transport_torch.tree import tree_map

    return tree_map(lambda t: t[:, 0], logs)


def kernel_launches(before: dict) -> dict:
    """The kernel entry points launched since ``before`` (a copy of
    ``ops.admm_kernel.KERNEL_LAUNCHES``), by name."""
    from tpu_aerial_transport_torch.ops import admm_kernel

    return {k: v - before.get(k, 0)
            for k, v in sorted(admm_kernel.KERNEL_LAUNCHES.items())
            if v != before.get(k, 0)}


def make_high_level(controller, params, col, forest, f_eq):
    """The JAX example's controller set-up (``:113-145``) on batched
    states: ``(hl(cs, states, acc), cs0, cfg, dist_eps)``; ``cs0`` is one
    scenario's (no scenario axis)."""
    from tpu_aerial_transport_torch.control import cadmm, centralized, dd
    from tpu_aerial_transport_torch.envs import forest as forest_mod

    dev = params.r.device
    if controller == "centralized":
        cfg = centralized.make_config(params, col.collision_radius,
                                      col.max_deceleration)
        cs0 = centralized.init_ctrl_state(params, cfg, f_eq)

        def hl(cs, s, acc):
            env_cbf = forest_mod.collision_cbf_rows(
                forest, s.xl, s.vl, col.collision_radius,
                col.max_deceleration, cfg.vision_radius, cfg.dist_eps,
                cfg.alpha_env_cbf, cfg.n_env_cbfs)
            return centralized.control(params, cfg, f_eq, cs, s, acc,
                                       env_cbf)

        return hl, cs0, cfg, cfg.dist_eps
    if controller == "cadmm":
        cfg = cadmm.make_config(params, col.collision_radius,
                                col.max_deceleration, device=dev)
        cs0 = cadmm.init_cadmm_state(params, cfg, f_eq)
        plan = cadmm.make_plan(params, cfg)

        def hl(cs, s, acc):
            return cadmm.control(params, cfg, f_eq, cs, s, acc, forest,
                                 plan=plan)

        return hl, cs0, cfg, cfg.dist_eps
    cfg = dd.make_config(params, col.collision_radius, col.max_deceleration,
                         device=dev)
    cs0 = dd.init_dd_state(params, cfg, f_eq)
    dd_plan = dd.make_dd_plan(params, cfg)

    def hl(cs, s, acc):
        return dd.control(params, cfg, f_eq, cs, s, acc, forest,
                          plan=dd_plan)

    return hl, cs0, cfg, cfg.base.dist_eps


def main(argv=None) -> int:
    args = parse_args(argv)
    from tpu_aerial_transport_torch.control import centralized, lowlevel
    from tpu_aerial_transport_torch.envs import forest as forest_mod
    from tpu_aerial_transport_torch.harness import rollout as ro
    from tpu_aerial_transport_torch.harness import setup
    from tpu_aerial_transport_torch.ops import admm_kernel
    from tpu_aerial_transport_torch.utils.stats import (
        compute_aggregate_statistics,
    )

    if args.resume:
        from tpu_aerial_transport_torch.resilience import recovery

        plan = recovery.read_plan(args.resume)
        meta = plan.meta
        print(f"resuming from {args.resume}: {meta} "
              f"({plan.n_chunks} chunks of {plan.chunk_len} MPC steps)")
        # Deterministic regeneration: everything the run depends on is
        # journaled.
        args.controller = meta["controller"]
        args.n = meta["n"]
        args.T = meta["T"]
        args.dt = meta["dt"]
        args.hl_rel_freq = meta["hl_rel_freq"]
        args.seed = plan.seed
        args.chunks = plan.n_chunks
        args.ckpt_dir = args.resume
        # The telemetry accumulator is part of the chunk carry: the resumed
        # chunk must match the journaled one structurally.
        args.telemetry = bool(meta.get("telemetry", False))
    if args.plots:
        require_matplotlib("--plots")
    dev = resolve_device(args.device)
    before = dict(admm_kernel.KERNEL_LAUNCHES)

    params, col, state0 = setup.rqp_setup(args.n, device=dev)
    forest = forest_mod.make_forest(seed=args.seed, device=dev)
    f_eq = centralized.equilibrium_forces(params)
    ll = lowlevel.make_lowlevel_controller("pd", params)
    acc_des_fn = ro.make_forest_acc_des(forest)
    state0 = state0.replace(xl=torch.tensor([0.0, 0.0, 1.5],
                                            dtype=torch.float32, device=dev))
    hl, cs0, cfg, dist_eps = make_high_level(args.controller, params, col,
                                             forest, f_eq)
    states0 = ro.stack_scenarios(state0, 1)  # one scenario, a batch of 1.
    css0 = ro.stack_scenarios(cs0, 1)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    n_hl_steps = int(args.T / (args.dt * args.hl_rel_freq))
    capture_note = (", the substeps' graph capture included"
                    if dev.type == "cuda" else "")
    tcfg = None
    if args.telemetry:
        from tpu_aerial_transport_torch.obs import telemetry as telemetry_mod

        tcfg = telemetry_mod.TelemetryConfig()
    # chunks >= 1 (not >= 2): one checkpointed chunk is a valid request
    # (snapshot at the end, resumable journal).
    checkpointed = args.chunks >= 1 or args.resume
    if checkpointed:
        from tpu_aerial_transport_torch.harness import checkpoint
        from tpu_aerial_transport_torch.resilience import recovery

        if not args.ckpt_dir:
            raise SystemExit("--chunks needs --ckpt-dir")
        if n_hl_steps % args.chunks:
            raise SystemExit(
                f"T gives {n_hl_steps} MPC steps, not divisible by "
                f"--chunks {args.chunks}")
        config_hash = checkpoint.config_fingerprint(
            controller=args.controller, n=args.n, seed=args.seed,
            dt=args.dt, hl_rel_freq=args.hl_rel_freq, cfg=cfg)
        metrics_path = args.metrics or os.path.join(args.ckpt_dir,
                                                    "run.metrics.jsonl")
        runner = ro.make_chunked_rollout(
            hl, ll.control, params, n_hl_steps=n_hl_steps,
            n_chunks=args.chunks, hl_rel_freq=args.hl_rel_freq, dt=args.dt,
            acc_des_fn=acc_des_fn, telemetry=tcfg)
        carry0 = runner.init_carry(states0, css0)
        print(f"running {args.controller}, n={args.n}, {n_hl_steps} MPC "
              f"steps in {args.chunks} checkpointed chunks -> "
              f"{args.ckpt_dir} on {dev.type} ...")
        t0 = time.perf_counter()
        with recovery.GracefulInterrupt() as interrupt:
            if args.resume:
                res = recovery.resume_run(
                    args.resume, runner.chunk_jit, carry0,
                    config_hash=config_hash, interrupt=interrupt,
                    metrics=metrics_path)
                print(f"resumed from chunk {res.resumed_from_chunk}")
            else:
                run_plan = recovery.RunPlan(
                    run_dir=args.ckpt_dir, n_hl_steps=n_hl_steps,
                    n_chunks=args.chunks, seed=args.seed,
                    config_hash=config_hash,
                    meta={"controller": args.controller, "n": args.n,
                          "T": args.T, "dt": args.dt,
                          "hl_rel_freq": args.hl_rel_freq,
                          "telemetry": bool(args.telemetry)})
                res = recovery.run_chunks(
                    run_plan, runner.chunk_jit, carry0, interrupt=interrupt,
                    metrics=metrics_path)
        sync()
        dt_wall = time.perf_counter() - t0
        if res.status == "preempted":
            raise SystemExit(
                f"preempted at chunk {res.chunks_done}/{args.chunks} after "
                f"{dt_wall:.1f} s -- state is snapshotted; continue with: "
                "python3 -m tpu_aerial_transport_torch.examples.rqp_forest "
                f"--resume {args.ckpt_dir}")
        final, logs = res.carry[0], res.logs
        print(f"done in {dt_wall:.1f} s ({n_hl_steps / dt_wall:.1f} MPC "
              f"steps/s{capture_note})")
    else:
        run = ro.jit_rollout(
            hl, ll.control, params, n_hl_steps=n_hl_steps,
            hl_rel_freq=args.hl_rel_freq, dt=args.dt, acc_des_fn=acc_des_fn,
            telemetry=tcfg)
        print(f"running {args.controller}, n={args.n}, {n_hl_steps} MPC "
              f"steps on {dev.type} ...")
        t0 = time.perf_counter()
        out = run(states0, css0)
        final, logs = out[0], out[2]
        tel = out[3] if tcfg is not None else None
        sync()
        dt_wall = time.perf_counter() - t0
        print(f"done in {dt_wall:.1f} s ({n_hl_steps / dt_wall:.1f} MPC "
              f"steps/s{capture_note})")
        if args.metrics or tel is not None:
            from tpu_aerial_transport_torch.obs import export as export_mod

            path = args.metrics or "artifacts/rollout.metrics.jsonl"
            os.makedirs(os.path.dirname(os.path.abspath(path)),
                        exist_ok=True)
            export_mod.rollout_metrics(
                path, logs, tel, tcfg,
                meta={"controller": args.controller, "n": args.n,
                      "T": args.T})
            print(f"metrics written to {path}")
    logs = drop_scenario_axis(logs)

    # Aggregate stats (reference _print_stats, rqp_example.py:62-80).
    iters = logs.iters.cpu()
    if bool((iters >= 0).any()):
        # Host statistics of the logs, in float64 as the reference.
        mn, mx, avg, std = (float(x) for x in compute_aggregate_statistics(
            iters[iters >= 0].to(torch.float64)))  # torchlint: disable=TL004
        print(f"Solver iterations: min: {mn:5.2f}, max: {mx:5.2f}, "
              f"avg: {avg:5.2f}, std: {std:5.2f}")

    # Per-MPC-step wall-clock statistics: the rollout reruns as chunks of
    # --time-chunk MPC steps through jit_rollout (the substeps from their
    # CUDA graph), each chunk ending in a synchronise; every sample is a
    # chunk's wall time over its step count.
    if args.time_chunk > 0:
        chunk = min(args.time_chunk, n_hl_steps)
        run_chunk = ro.jit_rollout(
            hl, ll.control, params, n_hl_steps=chunk,
            hl_rel_freq=args.hl_rel_freq, dt=args.dt, acc_des_fn=acc_des_fn)
        s, c, _ = run_chunk(states0, css0)  # the graph's capture.
        sync()
        s, c = states0, css0
        samples = []
        for _ in range(max(2, n_hl_steps // chunk)):
            t0 = time.perf_counter()
            s, c, _ = run_chunk(s, c)
            sync()
            samples.append((time.perf_counter() - t0) / chunk)
        # Host timings, in float64 as the reference.
        stats = compute_aggregate_statistics(torch.tensor(
            samples, dtype=torch.float64))  # torchlint: disable=TL004
        mn, mx, avg, std = (1e3 * float(x) for x in stats)
        print(f"Solve time per MPC step [ms] (chunks of {chunk}): "
              f"min: {mn:6.3f}, max: {mx:6.3f}, avg: {avg:6.3f}, "
              f"std: {std:6.3f}"
              + (" -- one scenario, so these times measure the host's "
                 "dispatch of a step's small kernels, not the card's "
                 "arithmetic" if dev.type == "cuda" else ""))
    print(f"final payload position: {final.xl[0].cpu().numpy()}")
    print(f"min env distance over run: "
          f"{float(logs.min_env_dist.min()):.3f} m (eps = {dist_eps})")
    print(f"collisions: {int(logs.collision.sum())}")
    print(f"kernel launches: {json.dumps(kernel_launches(before))}")

    log_dict = ro.logs_to_dict(logs, args.n, args.dt, args.hl_rel_freq,
                               forest)
    if args.out:
        parent = os.path.dirname(os.path.abspath(args.out))
        os.makedirs(parent, exist_ok=True)
        np.savez(args.out, **{
            k: v for k, v in log_dict.items() if not isinstance(v, dict)
        }, **{f"state_{k}": v for k, v in log_dict["state_seq"].items()})
        print(f"logs saved to {args.out}")
    if args.plots:
        from tpu_aerial_transport_torch.viz import plots

        plots.save_figures(log_dict, "", args.controller, params=params,
                           collision=col, dist_eps=dist_eps)
        print("figures saved (xy + min-dist at 600 dpi)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
