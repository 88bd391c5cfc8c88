"""DD against C-ADMM convergence rates on the card.

The port's counterpart of ``examples/convergence_rates.py`` (the
reference's ``test/control/test_rqpcontrollers.py:101-156``
``_plot_convergence_rate``): random desired accelerations, both
distributed solvers at tolerance 0 with a fixed iteration budget from a
cold start, and the consensus residual against the iteration with min/max
bands. The samples are one batch on the controllers' scenario axis, every
agent QP through the whole-solve kernel's warp body; they are drawn from
the JAX example's keys, ``split(PRNGKey(0), samples)``, with the port's
Threefry (``resilience.prng``): the keys are the JAX package's word for
word.

Usage:
  python3 -m tpu_aerial_transport_torch.examples.convergence_rates \\
      [--samples 100] [--iters 25]

``--effort fixed|adaptive|ab`` switches to the adaptive-solver-effort A/B:
the batch at the real stop tolerance (1e-2 N) with the controllers'
``effort`` pinned, printing the consensus-iteration histograms (and the
adaptive arm's inner-effort histogram); ``ab`` runs both arms.

It takes the JAX example's flags and ``--device`` (default ``cuda``;
``cpu`` runs the plain PyTorch path). The figure needs matplotlib; ``--out
''`` skips it.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from tpu_aerial_transport_torch import resolve_device
from tpu_aerial_transport_torch.examples.rqp_forest import require_matplotlib


def sample_keys(samples: int, device):
    """``jax.random.split(jax.random.PRNGKey(0), samples)``: ``(samples,
    2)`` Threefry key words."""
    from tpu_aerial_transport_torch.resilience import prng

    return prng.split(prng.prng_key(0, device), samples)


def sample_accelerations(samples: int, device) -> torch.Tensor:
    """The desired accelerations: ``0.5 * normal(key, (3,))`` for each
    sample's key, ``(samples, 3)``."""
    from tpu_aerial_transport_torch.resilience import prng

    return 0.5 * prng.normal(sample_keys(samples, device), (3,))


def _setup(n: int, samples: int, device):
    from tpu_aerial_transport_torch.control import centralized
    from tpu_aerial_transport_torch.harness import rollout as ro
    from tpu_aerial_transport_torch.harness import setup

    params, col, state0 = setup.rqp_setup(n, device=device)
    f_eq = centralized.equilibrium_forces(params)
    accs = sample_accelerations(samples, device)
    acc = (accs, torch.zeros(3, dtype=accs.dtype, device=device))
    return params, col, f_eq, ro.stack_scenarios(state0, samples), acc


def _batch(cs0, samples):
    from tpu_aerial_transport_torch.harness import rollout as ro

    return ro.stack_scenarios(cs0, samples)


def effort_ab(args, device) -> dict:
    """The ``--effort`` mode: per-sample iteration-count histograms at the
    real stop tolerance, fixed against adaptive. Returns the summary."""
    from tpu_aerial_transport_torch.control import cadmm, dd
    from tpu_aerial_transport_torch.obs import telemetry as telemetry_mod

    params, col, f_eq, states, acc = _setup(args.n, args.samples, device)
    edges = list(telemetry_mod.ITER_BUCKETS)
    labels = [f"<={e}" for e in edges] + [f">{edges[-1]}"]

    def hist_line(values):
        # The shared right-closed bucketing (v <= edge), the telemetry
        # accumulators' axis.
        h = telemetry_mod.iter_histogram(values)
        parts = [f"{lab}: {int(c)}" for lab, c in zip(labels, h) if c > 0]
        return ", ".join(parts) or "(empty)"

    modes = ("fixed", "adaptive") if args.effort == "ab" else (args.effort,)
    summary = {}
    for effort in modes:
        kw = dict(max_iter=args.iters, inner_iters=80, effort=effort,
                  device=device)
        acfg = cadmm.make_config(params, col.collision_radius,
                                 col.max_deceleration, **kw)
        dcfg = dd.make_config(params, col.collision_radius,
                              col.max_deceleration, **kw)
        runs = (
            ("C-ADMM", lambda: cadmm.control(
                params, acfg, f_eq,
                _batch(cadmm.init_cadmm_state(params, acfg), args.samples),
                states, acc)),
            ("DD", lambda: dd.control(
                params, dcfg, f_eq,
                _batch(dd.init_dd_state(params, dcfg), args.samples),
                states, acc)),
        )
        print(f"\n== effort={effort} ({args.samples} samples, "
              f"max_iter={args.iters}, res_tol 1e-2 N) ==")
        for label, run in runs:
            stats = run()[2]
            iters = stats.iters.cpu().numpy()
            res = stats.solve_res.cpu().numpy()
            inner = stats.inner_iters.cpu().numpy()
            row = {
                "iters_mean": float(iters.mean()),
                "iters_p99": float(np.percentile(iters, 99)),
                "res_max": float(res.max()),
            }
            print(f"{label}: consensus iters mean {row['iters_mean']:.1f} "
                  f"p99 {row['iters_p99']:.0f}, worst residual "
                  f"{row['res_max']:.2e} N")
            print(f"  consensus-iteration histogram: {hist_line(iters)}")
            if inner.size:
                # Per-solve effort (the telemetry accumulators' axis).
                per = inner / np.maximum(iters, 1) / args.n
                row["inner_per_solve_mean"] = float(per.mean())
                print(f"  inner iters/solve: mean {per.mean():.1f} "
                      f"p99 {np.percentile(per, 99):.0f}")
                print(f"  inner-effort histogram: {hist_line(per)}")
            summary[f"{label}_{effort}"] = row
    if args.json:
        with open(args.json, "w") as fh:
            json.dump({"n": args.n, "samples": args.samples,
                       "iters": args.iters, "mode": "effort_ab",
                       **summary}, fh, indent=1)
        print(f"\neffort summary saved to {args.json}")
    return summary


def main(argv=None) -> dict:
    """Run the comparison; returns the residual curves (``{"C-ADMM": (S,
    max_iter + 1), "DD": ...}``, numpy) or, with ``--effort``, the effort
    summary."""
    p = argparse.ArgumentParser()
    p.add_argument("--samples", type=int, default=100)
    p.add_argument("--iters", type=int, default=25)
    p.add_argument("-n", type=int, default=3)
    p.add_argument("--out", default="convergence_rates.png",
                   help="figure path ('' skips the figure)")
    p.add_argument("--json", default=None, metavar="PATH",
                   help="also write per-iteration median/min/max residuals "
                        "for both solvers as JSON")
    p.add_argument("--effort", choices=["fixed", "adaptive", "ab"],
                   default=None,
                   help="adaptive-solver-effort A/B: run at the real stop "
                        "tolerance and print iteration histograms instead "
                        "of the tolerance-0 residual curves")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu")
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    if args.effort:
        return effort_ab(args, device)
    if args.out:
        require_matplotlib("--out")

    from tpu_aerial_transport_torch.control import cadmm, dd

    params, col, f_eq, states, acc = _setup(args.n, args.samples, device)
    # Tolerance 0 and a fixed budget (the reference sets tol=0,
    # max_iter=25).
    acfg = cadmm.make_config(params, col.collision_radius,
                             col.max_deceleration, max_iter=args.iters,
                             inner_iters=80, res_tol=0.0, device=device)
    dcfg = dd.make_config(params, col.collision_radius,
                          col.max_deceleration, max_iter=args.iters,
                          inner_iters=80, prim_inf_tol=0.0, device=device)

    print(f"running {args.samples} samples x {args.iters} iterations on "
          f"{device.type} ...")
    cadmm_errs = cadmm.control(
        params, acfg, f_eq,
        _batch(cadmm.init_cadmm_state(params, acfg), args.samples), states,
        acc)[2].err_seq.cpu().numpy()
    dd_errs = dd.control(
        params, dcfg, f_eq,
        _batch(dd.init_dd_state(params, dcfg), args.samples), states,
        acc)[2].err_seq.cpu().numpy()

    summary = {}
    for label, errs in (("C-ADMM", cadmm_errs), ("DD", dd_errs)):
        final = errs[:, min(args.iters, errs.shape[1]) - 1]
        final = final[~np.isnan(final)]
        print(f"{label}: median residual after {args.iters} iters: "
              f"{np.median(final):.2e} N")
        with np.errstate(all="ignore"):
            summary[label] = {
                "median": np.nanmedian(errs, axis=0).tolist(),
                "min": np.nanmin(errs, axis=0).tolist(),
                "max": np.nanmax(errs, axis=0).tolist(),
            }

    if args.json:
        with open(args.json, "w") as fh:
            json.dump({
                "n": args.n, "samples": args.samples, "iters": args.iters,
                "unit": "N (inf-norm consensus / primal-infeasibility "
                        "residual per iteration, cold start, tol 0)",
                **summary,
            }, fh, indent=1)
        print(f"residual curves saved to {args.json}")

    if args.out:
        from tpu_aerial_transport_torch.viz import plots

        plots.plot_convergence_rates(
            {"C-ADMM": cadmm_errs, "DD": dd_errs}, args.out)
        print(f"figure saved to {args.out}")
    return {"C-ADMM": cadmm_errs, "DD": dd_errs}


if __name__ == "__main__":
    main()
