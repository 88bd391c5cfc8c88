"""Fault-injection demo on the card: a C-ADMM transport team loses an agent
mid-flight and degrades gracefully.

The port's counterpart of ``examples/fault_injection.py``. Three rollouts
of the same resilient harness (``resilience.rollout``, the substeps from a
CUDA graph on the card) -- nominal, one agent killed halfway (t = 1 s of
the default 2 s), and 30% consensus-message dropout held 5 steps -- each
summarised side by side (tracking error, fallback-ladder rung counts,
quarantine). The dropout schedule is keyed by the JAX example's
``PRNGKey(7)`` and drawn with the port's Threefry (``resilience.prng``), so
its masks are bitwise the JAX package's.

    python3 -m tpu_aerial_transport_torch.examples.fault_injection

Preemption-safe mode (``resilience.recovery``): the killed-agent scenario
as checkpointed chunks -- the whole resilient carry (the ladder's hold
force and the sticky quarantine flag among it) is snapshotted at every
boundary -- stopped by SIGTERM and resumed bit-exactly:

    python3 -m tpu_aerial_transport_torch.examples.fault_injection \\
        --ckpt-dir /tmp/fi1 --chunks 4
    python3 -m tpu_aerial_transport_torch.examples.fault_injection \\
        --resume /tmp/fi1

It takes the JAX example's flags, ``-n`` (agents, default 4) and
``--steps`` (high-level steps, default 200; the agent dies at half of
them), and ``--device`` (default ``cuda``; ``cpu`` runs the plain PyTorch
path). ``main`` returns each scenario's logs, ``(T, ...)`` leaves.
"""

from __future__ import annotations

import argparse

import numpy as np

from tpu_aerial_transport_torch import resolve_device
from tpu_aerial_transport_torch.examples.rqp_forest import drop_scenario_axis

N = 4
N_HL_STEPS = 200  # 2 s at 100 Hz.
DROPOUT_KEY = 7  # the JAX example's jax.random.PRNGKey(7).


def summarize(name, logs, mTg):
    """Print one scenario's summary from its ``(T, ...)`` logs."""
    rungs = np.bincount(logs.fallback_rung.cpu().numpy().reshape(-1),
                        minlength=4)
    fz_end = logs.f_des[-1, :, 2].cpu().numpy()
    print(f"\n== {name} ==")
    print(f"  max |x_err|      : {float(logs.x_err.max()):.3f} m")
    print(f"  final |x_err|    : {float(logs.x_err[-1]):.3f} m")
    print(f"  final fz per agent [N]: {np.round(fz_end, 2)}")
    print(f"  sum fz / mT g    : {fz_end.sum() / mTg:.3f}")
    print(f"  ladder rungs     : clean={rungs[0]} retry={rungs[1]} "
          f"hold={rungs[2]} equilibrium={rungs[3]}")
    print(f"  quarantined      : {bool(logs.quarantined[-1])}")


def build(n: int, device):
    """The example's set-up: ``(params, state0, cs0, hl, ll, cfg)``, C-ADMM
    with ``max_iter=15``, ``inner_iters=20``, no forest; ``state0`` and
    ``cs0`` carry a scenario axis of 1."""
    from tpu_aerial_transport_torch import resilience
    from tpu_aerial_transport_torch.control import cadmm, lowlevel
    from tpu_aerial_transport_torch.harness import rollout as ro
    from tpu_aerial_transport_torch.harness import setup

    params, col, state0 = setup.rqp_setup(n, device=device)
    cfg = cadmm.make_config(params, col.collision_radius,
                            col.max_deceleration, max_iter=15,
                            inner_iters=20, device=device)
    hl = resilience.make_cadmm_hl_step(params, cfg)
    ll = lowlevel.make_lowlevel_controller("pd", params)
    cs0 = cadmm.init_cadmm_state(params, cfg)
    return (params, ro.stack_scenarios(state0, 1),
            ro.stack_scenarios(cs0, 1), hl, ll, cfg)


def scenarios(n: int, steps: int, device) -> dict:
    """The three fault schedules: nominal, agent 0 killed at ``steps //
    2``, and 30% consensus dropout held 5 steps under the key
    ``PRNGKey(7)``."""
    from tpu_aerial_transport_torch.resilience import faults as faults_mod
    from tpu_aerial_transport_torch.resilience import prng

    return {
        "nominal": faults_mod.no_faults(n, device=device),
        f"agent 0 killed @ step {steps // 2}": faults_mod.make_schedule(
            n, t_fail={0: steps // 2}, device=device),
        "30% consensus dropout": faults_mod.make_schedule(
            n, drop_rate=0.3, drop_hold=5,
            key=prng.prng_key(DROPOUT_KEY, device), device=device),
    }


def run_checkpointed(ckpt_dir: str, n_chunks: int, resume: bool, n: int,
                     steps: int, device):
    """The killed-agent scenario as a chunk-checkpointed resilient rollout:
    ``resume`` restores the journaled run (its settings come from the
    journal) and continues to the identical final summary. Returns the
    run's logs, ``(T, ...)`` leaves."""
    from tpu_aerial_transport_torch.harness import checkpoint
    from tpu_aerial_transport_torch.harness import rollout as ro
    from tpu_aerial_transport_torch.models import rqp
    from tpu_aerial_transport_torch.resilience import faults as faults_mod
    from tpu_aerial_transport_torch.resilience import recovery
    from tpu_aerial_transport_torch.resilience.rollout import (
        make_chunked_resilient_rollout,
    )

    if resume:
        plan = recovery.read_plan(ckpt_dir)
        n_chunks, steps = plan.n_chunks, plan.n_hl_steps
        n, t_fail = plan.meta["n"], plan.meta["t_fail"]
        print(f"resuming from {ckpt_dir}: {plan.meta} "
              f"({n_chunks} chunks of {plan.chunk_len} MPC steps)")
    else:
        t_fail = steps // 2

    params, state0, cs0, hl, ll, cfg = build(n, device)
    sched = faults_mod.make_schedule(n, t_fail={0: t_fail}, device=device)
    # The hover reference pinned to the true initial state (the default
    # would re-anchor at each chunk's start); it is deterministic from the
    # set-up, hence identical on resume.
    acc_des_fn = ro.hover_acc_des(state0)
    config_hash = checkpoint.config_fingerprint(
        n=n, t_fail=t_fail, cfg=cfg, n_hl_steps=steps)
    runner = make_chunked_resilient_rollout(
        hl, ll.control, params, n_hl_steps=steps, n_chunks=n_chunks,
        acc_des_fn=acc_des_fn, faults=sched)
    carry0 = runner.init_carry(state0, cs0)
    with recovery.GracefulInterrupt() as interrupt:
        if resume:
            res = recovery.resume_run(ckpt_dir, runner.chunk_jit, carry0,
                                      config_hash=config_hash,
                                      interrupt=interrupt)
            print(f"resumed from chunk {res.resumed_from_chunk}")
        else:
            plan = recovery.RunPlan(
                run_dir=ckpt_dir, n_hl_steps=steps, n_chunks=n_chunks,
                seed=None, config_hash=config_hash,
                meta={"scenario": f"agent 0 killed @ step {t_fail}",
                      "n": n, "t_fail": t_fail})
            res = recovery.run_chunks(plan, runner.chunk_jit, carry0,
                                      interrupt=interrupt)
    if res.status == "preempted":
        raise SystemExit(
            f"preempted at chunk {res.chunks_done}/{n_chunks} -- resume "
            "with: python3 -m tpu_aerial_transport_torch.examples."
            f"fault_injection --resume {ckpt_dir}")
    logs = drop_scenario_axis(res.logs)
    mTg = float(params.mT) * rqp.GRAVITY
    summarize(f"agent 0 killed @ step {t_fail} (checkpointed)", logs, mTg)
    return logs


def main(argv=None) -> dict:
    p = argparse.ArgumentParser()
    p.add_argument("--chunks", type=int, default=4, metavar="C",
                   help="chunk count for --ckpt-dir mode")
    p.add_argument("--ckpt-dir", default=None, metavar="DIR",
                   help="run the killed-agent scenario as a checkpointed "
                        "chunked rollout under DIR")
    p.add_argument("--resume", default=None, metavar="DIR",
                   help="resume a --ckpt-dir run from its journal")
    p.add_argument("-n", type=int, default=N, help="number of quadrotors")
    p.add_argument("--steps", type=int, default=N_HL_STEPS,
                   help="high-level steps a rollout (the agent dies at "
                        "half of them)")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu")
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    if args.resume or args.ckpt_dir:
        logs = run_checkpointed(args.resume or args.ckpt_dir, args.chunks,
                                args.resume is not None, args.n, args.steps,
                                device)
        return {"checkpointed": logs}

    from tpu_aerial_transport_torch.models import rqp
    from tpu_aerial_transport_torch.resilience.rollout import (
        jit_resilient_rollout,
    )

    params, state0, cs0, hl, ll, _ = build(args.n, device)
    mTg = float(params.mT) * rqp.GRAVITY
    print(f"n={args.n} agents, payload weight mT*g = {mTg:.2f} N")
    out = {}
    for name, sched in scenarios(args.n, args.steps, device).items():
        run = jit_resilient_rollout(hl, ll.control, params,
                                    n_hl_steps=args.steps, faults=sched)
        _, _, logs = run(state0, cs0)
        out[name] = drop_scenario_axis(logs)
        summarize(name, out[name], mTg)
    return out


if __name__ == "__main__":
    main()
