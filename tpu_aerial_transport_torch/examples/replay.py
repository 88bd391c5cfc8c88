"""Replay a saved rollout log: frames, a ghost snapshot and the paper
figures.

The port's counterpart of ``examples/replay.py`` (the reference's
``example/rqp_plots.py:main()``, :496-527): it loads the npz that
``rqp_forest --out`` writes -- the port's or the JAX package's, which share
one layout -- rebuilds the forest from the logged tree positions
(``envs.forest.forest_from_tree_pos``), and renders:

- PNG replay frames with the smoothed follow camera
  (``viz.scene.render_frames``; ``--meshcat`` for the live three.js viewer,
  which needs meshcat),
- a multi-ghost snapshot scene (the reference's ``_snapshot``),
- the paper figures: the 600-dpi xy trajectory with key-frame overlays and
  the minimum-distance plot.

Usage:
  python3 -m tpu_aerial_transport_torch.examples.rqp_forest \\
      --controller cadmm -T 10 --out run.npz
  python3 -m tpu_aerial_transport_torch.examples.replay run.npz \\
      --controller cadmm --outdir replay_out

It takes the JAX example's flags and ``--device`` (default ``cuda``: where
the rebuilt parameters and forest live; the drawing is the host's). It
needs matplotlib and refuses to start without it.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from tpu_aerial_transport_torch import resolve_device
from tpu_aerial_transport_torch.examples.rqp_forest import require_matplotlib


def load_log(path: str) -> dict:
    """Inverse of the flattened npz layout ``rqp_forest --out`` writes."""
    raw = np.load(path, allow_pickle=False)
    logs = {k: raw[k] for k in raw.files if not k.startswith("state_")}
    logs["state_seq"] = {
        k[len("state_"):]: raw[k] for k in raw.files if k.startswith("state_")
    }
    for k in ("n", "dt", "T", "hl_rel_freq", "log_freq", "num_trees"):
        if k in logs:
            logs[k] = logs[k].item()
    return logs


def main(argv=None) -> dict:
    """Render the replay; returns the paths written (``frames``, ``ghosts``
    and ``outdir``)."""
    p = argparse.ArgumentParser()
    p.add_argument("log", help="npz log from rqp_forest --out")
    p.add_argument("--controller", default="cadmm",
                   choices=["centralized", "cadmm", "dd"])
    p.add_argument("--outdir", default="replay_out")
    p.add_argument("--stride", type=int, default=25, help="frame stride")
    p.add_argument("--force-arrows", action="store_true",
                   help="overlay per-agent commanded-force arrows "
                        "(reference _DRAW_FORCE_ARROWS; needs f_des_seq in "
                        "the log)")
    p.add_argument("--meshcat", action="store_true",
                   help="live meshcat replay instead of PNG frames")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu")
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    require_matplotlib("replay")

    from tpu_aerial_transport_torch.envs import forest as forest_mod
    from tpu_aerial_transport_torch.harness import setup
    from tpu_aerial_transport_torch.viz import plots, scene

    logs = load_log(args.log)
    n = int(logs["n"])
    params, col, _ = setup.rqp_setup(n, device=device)
    forest = None
    if "tree_pos" in logs:
        forest = forest_mod.forest_from_tree_pos(
            logs["tree_pos"], logs.get("num_trees", len(logs["tree_pos"])),
            device=device)

    os.makedirs(args.outdir, exist_ok=True)
    frames = []
    if args.meshcat:
        backend = scene.MeshcatBackend().open()
        backend.replay(logs, params, payload_vertices=col.payload_vertices,
                       forest=forest, force_arrows=args.force_arrows)
    else:
        frames = scene.render_frames(
            logs, params, col.payload_vertices,
            os.path.join(args.outdir, "frames"), forest=forest,
            stride=args.stride, force_arrows=args.force_arrows)
        print(f"{len(frames)} frames -> {args.outdir}/frames")

    T = logs["state_seq"]["xl"].shape[0]
    ghosts = os.path.join(args.outdir, "ghosts.png")
    scene.render_ghost_snapshot(
        logs, params, col.payload_vertices, ghosts,
        times=[int(f * (T - 1)) for f in (0.1, 0.4, 0.7, 0.95)],
        forest=forest)
    plots.save_figures(logs, args.outdir, args.controller, params=params,
                       collision=col)
    print(f"figures -> {args.outdir}")
    return {"frames": frames, "ghosts": ghosts, "outdir": args.outdir}


if __name__ == "__main__":
    main()
