"""City-scale forest demo on the card: a world of more than 10^4 obstacles
through the bucketed environment-query tier, with the run-health
telemetry accumulator on the rollout.

The port's counterpart of ``examples/city_forest.py``. It builds the
jittered-grid city world (default 16384 trees, about 80 times the
reference's 200-tree mountain forest: a world the dense capsule sweep
cannot afford), attaches the spatial-hash grid (``envs.spatial.with_grid``;
a slab too narrow for the world's occupancy raises ``GridOverflowError``
and never truncates), and runs a C-ADMM rollout whose
``env_query="auto"`` resolves to the bucketed tier (the world has more
than ``spatial.DENSE_AUTO_MAX_TREES`` slots), the substeps replayed from a
CUDA graph on the card (``harness.rollout.jit_rollout``):

  python3 -m tpu_aerial_transport_torch.examples.city_forest \\
      --trees 16384 -T 0.5
  python3 -m tpu_aerial_transport_torch.examples.city_forest \\
      --trees 65536 -n 4 --metrics /tmp/city.metrics.jsonl

Printed at the end: the grid's occupancy record (cells, slab width K,
max/mean occupancy), the resolved query tier, the safety margins and
counts from the telemetry accumulator, and the wall rate. It takes the
JAX example's flags and ``--device`` (default ``cuda``; ``cpu`` runs the
plain PyTorch path).
"""

from __future__ import annotations

import argparse
import math
import time

import torch

from tpu_aerial_transport_torch import resolve_device


def main(argv=None) -> dict:
    """Run the demo; returns the telemetry summary, with the resolved
    query tier (``env_query``), the grid record (``grid``), the rollout's
    logs (``logs``, ``(T, 1, ...)`` leaves) and the wall seconds."""
    p = argparse.ArgumentParser()
    p.add_argument("--trees", type=int, default=16384,
                   help="tree count (a square number: jittered-grid world)")
    p.add_argument("--density", type=float, default=0.085,
                   help="trees/m^2 (must respect the 3.2 m min spacing)")
    p.add_argument("-n", type=int, default=4, help="number of quadrotors")
    p.add_argument("-T", type=float, default=0.5, help="sim horizon [s]")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--env-query", default="auto",
                   choices=["auto", "dense", "bucketed"],
                   help="query impl (auto resolves to bucketed at this "
                        "world size)")
    p.add_argument("--metrics", default=None, metavar="PATH",
                   help="write a rollout_summary metrics event (obs.export)")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu")
    args = p.parse_args(argv)
    dev = resolve_device(args.device)

    from tpu_aerial_transport_torch.control import cadmm, centralized
    from tpu_aerial_transport_torch.control import lowlevel
    from tpu_aerial_transport_torch.envs import forest as forest_mod
    from tpu_aerial_transport_torch.envs import spatial as spatial_mod
    from tpu_aerial_transport_torch.harness import rollout as ro
    from tpu_aerial_transport_torch.harness import setup
    from tpu_aerial_transport_torch.obs import telemetry as telemetry_mod

    n_side = math.isqrt(args.trees)
    if n_side * n_side != args.trees:
        raise SystemExit(f"--trees {args.trees} must be a square number")
    pitch = 1.0 / math.sqrt(args.density)
    world_size = (n_side + 0.5) * pitch

    params, col, state0 = setup.rqp_setup(args.n, device=dev)
    cfg = cadmm.make_config(params, col.collision_radius,
                            col.max_deceleration, env_query=args.env_query,
                            device=dev)

    t0 = time.perf_counter()
    forest = forest_mod.make_forest(
        seed=args.seed, max_trees=args.trees, world_size=world_size,
        density=args.density, device=dev)
    forest = spatial_mod.with_grid(forest,
                                   cfg.vision_radius + forest.bark_radius)
    stats = spatial_mod.grid_stats(forest.grid)
    print(f"world: {int(forest.num_trees)} trees over "
          f"{world_size:.0f} x {world_size:.0f} m "
          f"(built in {time.perf_counter() - t0:.2f} s)")
    print(f"grid: {stats['n_cells']} cells of {stats['cell_size_m']:.1f} m, "
          f"slab K={stats['k']}, occupancy max {stats['max_occupancy']} / "
          f"mean {stats['mean_occupancy']:.1f} -- the query gathers "
          f"{stats['k']} candidates instead of sweeping "
          f"{int(forest.num_trees)} trees")

    f_eq = centralized.equilibrium_forces(params)
    ll = lowlevel.make_lowlevel_controller("pd", params)
    plan = cadmm.make_plan(params, cfg)
    cs0 = cadmm.init_cadmm_state(params, cfg)
    acc_des_fn = ro.make_forest_acc_des(forest)
    # Spawn just above the canopy (tree tops sit at about BARK_HEIGHT): a
    # city-density world has no guaranteed free slot at the origin.
    f32 = dict(dtype=torch.float32, device=dev)
    state0 = state0.replace(
        xl=torch.tensor([0.0, 0.0, forest_mod.BARK_HEIGHT + 1.0], **f32),
        vl=torch.tensor([0.5, 0.0, 0.0], **f32))

    def hl(cs, s, acc):
        return cadmm.control(params, cfg, f_eq, cs, s, acc, forest,
                             plan=plan)

    n_hl_steps = max(int(args.T / (1e-3 * 10)), 1)
    tcfg = telemetry_mod.TelemetryConfig()
    run = ro.jit_rollout(hl, ll.control, params, n_hl_steps=n_hl_steps,
                         hl_rel_freq=10, dt=1e-3, acc_des_fn=acc_des_fn,
                         telemetry=tcfg)
    impl = spatial_mod.runtime_env_query(cfg.env_query, forest)
    print(f"running cadmm n={args.n}, {n_hl_steps} MPC steps, "
          f"env_query={cfg.env_query} -> {impl} on {dev.type} ...")
    t0 = time.perf_counter()
    final, _, logs, tel = run(ro.stack_scenarios(state0, 1),
                              ro.stack_scenarios(cs0, 1))
    if dev.type == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    summary = telemetry_mod.summary(tel, tcfg)
    print(f"done in {wall:.1f} s ({n_hl_steps / wall:.1f} MPC steps/s"
          + (", the substeps' graph capture included)"
             if dev.type == "cuda" else ")"))
    print(f"telemetry: min env dist {summary['min_env_dist']:.3f} m, "
          f"collision steps {summary['collision_steps']}, "
          f"consensus iters total {summary['iters_sum']}")

    if args.metrics:
        from tpu_aerial_transport_torch.obs import export as export_mod

        export_mod.rollout_metrics(
            args.metrics, logs, tel=tel, cfg=tcfg,
            meta={"example": "city_forest", "n_trees": int(forest.num_trees),
                  "world_size_m": world_size, "env_query": impl,
                  "grid": stats})
        print(f"metrics written to {args.metrics}")
    return {**summary, "env_query": impl, "grid": stats, "logs": logs,
            "wall_s": wall}


if __name__ == "__main__":
    main()
