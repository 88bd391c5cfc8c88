#!/usr/bin/env python3
"""Component-split profile of the batched DD MPC step at n = 64: where
does the step time go -- the per-iteration conic solves, the outer
iterations' quasi-Newton and consensus work, or the fixed per-step work
(QP build, KKT-operator build, environment query, low-level control and
physics substeps)?

The port's counterpart of the JAX package's ``tools/profile_dd64.py``,
with the same variants, output keys and differencing arithmetic. Each
variant is the full batched MPC step (``harness.rollout.make_mpc_step(
"dd", n, ...)`` over ``scenario_batch``) with one knob moved, timed over
``--steps`` steps after one warm-up step; differencing isolates the
component. It runs on the card unless ``--device cpu`` is given, and
then reports no device time: the CPU's split says how fast PyTorch's CPU
kernels are.

Usage:
  python -m tpu_aerial_transport_torch.tools.profile_dd64 [--n 64] \\
      [--batch 64] [--reps 3] [--steps 6] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time

# The JAX bench's ``make_mpc_step`` keywords this tool sets; the port's
# ``harness.rollout.make_controller`` takes each under the same name.
KEYWORDS = frozenset({"max_iter", "inner_iters", "force_fixed_iters",
                      "inner_tol"})
# JAX keywords with no meaning in the port, and why: passing one is an error.
NO_PORT_MEANING = {
    "substep_unroll": "the port's substeps run as one CUDA graph (or "
                      "eagerly); there is no scan to unroll",
}


def port_keywords(**jax_kw) -> dict:
    """The JAX bench keywords mapped onto the port controller's; a keyword
    with no port meaning raises, and so does an unknown one."""
    for key in jax_kw:
        if key in NO_PORT_MEANING:
            raise ValueError(f"{key}: no port meaning ({NO_PORT_MEANING[key]})")
        if key not in KEYWORDS:
            raise ValueError(f"{key}: not a keyword this tool maps")
    return dict(jax_kw)


def device_clock(device):
    """Seconds on the host's clock after the device has finished its work
    (a synchronise first on the card)."""
    import torch

    if torch.device(device).type == "cuda":
        def clock():
            torch.cuda.synchronize()
            return time.perf_counter()

        return clock
    return time.perf_counter


def timed(step, css, states, clock, reps=3, n_steps=6):
    """Milliseconds per MPC step: the median over ``reps`` runs of
    ``n_steps`` steps each, after one warm-up step (which captures the
    substeps' CUDA graph on the card). ``clock()`` returns seconds once the
    device is done."""
    css, states, _ = step(css, states)
    ts = []
    for _ in range(reps):
        t0 = clock()
        c, s = css, states
        for _ in range(n_steps):
            c, s, _ = step(c, s)
        ts.append(clock() - t0)
    return float(statistics.median(ts)) / n_steps * 1e3


def build_step(n, batch, max_iter, inner_iters, fixed=True, inner_tol=0.0,
               device="cuda"):
    """``(step, css, states)``: the batched DD step of the JAX tool's
    ``build_step`` on the port. ``fixed`` is the JAX ``force_fixed_iters``
    (every step runs ``max_iter + 1`` outer iterations); ``fixed=False``
    stops at the real tolerances, and ``inner_tol > 0`` runs the agent
    solves tolerance-chunked to that residual, capped at ``inner_iters``.
    The solver effort is the controller's default, as in the JAX tool."""
    from tpu_aerial_transport_torch.harness import rollout

    kw = port_keywords(max_iter=max_iter, inner_iters=inner_iters,
                       force_fixed_iters=fixed, inner_tol=inner_tol)
    step, cs0, state0 = rollout.make_mpc_step("dd", n, device=device, **kw)
    return (step, rollout.stack_scenarios(cs0, batch),
            rollout.scenario_batch(state0, batch))


def split(t_8x40, t_8x20, t_16x20, t_adaptive, t_inner_tol, n, batch,
          platform) -> dict:
    """The JAX tool's output from the five step times (ms a step)."""
    res = {"platform": platform, "n": n, "batch": batch}
    # (1) Fixed 8 outer x 40 inner against 8 x 20: the pure inner-ADMM
    #     cost.
    res["step_ms_8outer_40inner"] = t_8x40
    res["step_ms_8outer_20inner"] = t_8x20
    res["ms_per_inner_iter_x8outer"] = (t_8x40 - t_8x20) / 20
    # per single inner ADMM iteration across the whole batch (8 outer
    # iterations each run `inner` of them):
    res["ms_per_single_inner_iter"] = (t_8x40 - t_8x20) / 20 / 8
    # (2) Outer-iteration overhead beyond the solves: 16 outer against 8 at
    #     inner = 20, less the solve part from (1).
    res["step_ms_16outer_20inner"] = t_16x20
    per_outer = (t_16x20 - t_8x20) / 8
    res["ms_per_outer_iter_at_inner20"] = per_outer
    solve_per_outer = res["ms_per_single_inner_iter"] * 20
    res["ms_per_outer_qn_and_consensus"] = per_outer - solve_per_outer
    # (3) Fixed per-step work, extrapolated to zero outer iterations.
    res["ms_fixed_per_step"] = t_8x20 - 8 * per_outer
    # (4) Adaptive (real tolerances), the operating point.
    res["step_ms_adaptive"] = t_adaptive
    # (5) Adaptive with tolerance-chunked inner solves (inner_tol = 2e-3).
    res["step_ms_adaptive_inner_tol"] = t_inner_tol
    res["inner_tol_speedup"] = t_adaptive / t_inner_tol
    return res


def profile(n=64, batch=64, reps=3, n_steps=6, device="cuda",
            clock=None) -> dict:
    """Time the five variants and return :func:`split`'s dict."""
    from tpu_aerial_transport_torch import resolve_device

    dev = resolve_device(device)
    clock = clock or device_clock(dev)

    def t(**kw):
        return timed(*build_step(n, batch, device=dev, **kw), clock,
                     reps=reps, n_steps=n_steps)

    t_8x40 = t(max_iter=7, inner_iters=40)
    t_8x20 = t(max_iter=7, inner_iters=20)
    t_16x20 = t(max_iter=15, inner_iters=20)
    t_adaptive = t(max_iter=20, inner_iters=40, fixed=False)
    t_inner_tol = t(max_iter=20, inner_iters=40, fixed=False,
                    inner_tol=2e-3)
    return split(t_8x40, t_8x20, t_16x20, t_adaptive, t_inner_tol, n,
                 batch, dev.type)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n", type=int, default=64)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--steps", type=int, default=6,
                    help="MPC steps a timed run")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    res = profile(args.n, args.batch, args.reps, args.steps, args.device)
    print(json.dumps(res, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
