"""Matplotlib figures from rollout logs: the port's copy of the JAX
package's ``viz/plots.py`` (the reference's ``example/rqp_plots.py``
paper-figure surface), on the log dict of ``harness.rollout.logs_to_dict``
or of ``examples.replay.load_log``.

Host-side only; never on a rollout's path. Every array is read with
:func:`host`, so a log or a parameter set whose tensors live on the card
plots as it does on the CPU. Figures:

- :func:`plot_tracking_errors` -- position/velocity error against time
  (rqp_example.py:167-181).
- :func:`plot_solver_stats` -- iterations and the minimum environment
  distance (log scale, with the ``dist_eps`` safety line) against time
  (rqp_example.py:183-200, rqp_plots.py:393-467).
- :func:`plot_xy_trajectory` -- the top-down trajectory through the forest
  with tree footprints and key-frame overlays (rqp_plots.py:173-390).
- :func:`plot_min_dist` -- the 600-dpi minimum-distance figure.
- :func:`plot_convergence_rates` -- DD against C-ADMM residual-vs-iteration
  curves with min/max bands (test_rqpcontrollers.py:101-156).

matplotlib is imported at the first figure, with the Agg backend selected
before ``pyplot``; a host without matplotlib raises ``ImportError`` there.
"""

from __future__ import annotations

import numpy as np


def host(x) -> np.ndarray:
    """``x`` as a numpy array on the host: a tensor (on any device) is
    detached and copied once; anything else goes through ``np.asarray``."""
    if hasattr(x, "detach"):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _mpl():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def plot_tracking_errors(logs: dict, path: str):
    plt = _mpl()
    fig, ax = plt.subplots(2, 1, figsize=(3.54, 3.54), dpi=200, sharex=True,
                           layout="constrained")
    T = logs["T"]
    x_err = host(logs["x_err_seq"])
    v_err = host(logs["v_err_seq"])
    t = np.linspace(0.0, T, len(x_err))
    ax[0].plot(t, x_err, "-b", lw=1)
    ax[0].set_ylabel(r"$\|x_l - x_{ref}\|$ [m]")
    ax[1].plot(t, v_err, "-b", lw=1)
    ax[1].set_ylabel(r"$\|v_l - v_{ref}\|$ [m/s]")
    ax[1].set_xlabel("t [s]")
    fig.savefig(path)
    plt.close(fig)


def plot_solver_stats(logs: dict, path: str, dist_eps: float = 0.1):
    plt = _mpl()
    fig, ax = plt.subplots(2, 1, figsize=(3.54, 3.54), dpi=200, sharex=True,
                           layout="constrained")
    T = logs["T"]
    iters = host(logs["iter_seq"])
    t = np.linspace(0.0, T, len(iters))
    ax[0].plot(t, iters, "-b", lw=1)
    ax[0].set_ylabel("solver iterations")
    d = host(logs["min_env_dist_seq"]) + 1e-6
    t = np.linspace(0.0, T, len(d))
    ax[1].plot(t, d, "-b", lw=1)
    ax[1].axhline(dist_eps, color="r", ls="--", lw=0.8,
                  label=r"$\epsilon_d$")
    ax[1].set_yscale("log")
    ax[1].set_ylabel("min env dist [m]")
    ax[1].set_xlabel("t [s]")
    ax[1].legend()
    fig.savefig(path)
    plt.close(fig)


# Paper-figure palette (reference rqp_plots.py:36-41).
_GRASS_COLOR = "#70AB94"
_BARK_COLOR = "#694B37"
_MESH_COLOR = "#FF22DD"
_QUADROTOR_COLOR = "#1590A0"
_PAYLOAD_COLOR = "#D70E36"
_VISIONCONE_COLOR = "#A8AEAC"
_SAVE_DPI = 600  # reference uses >= 600 for the paper PNGs (:32).

# Key-frame fractions per controller type (reference :245-250).
_KEY_FRAMES = {
    "centralized": (0.5,),
    "dual-decomposition": (0.16, 0.55),
    "consensus-admm": (0.19, 0.51, 0.72),
}


def _draw_capsule_outline(ax, c1, c2, radius, **kwargs):
    """2-D stadium outline of the braking capsule (reference ``_draw_capsule``,
    rqp_plots.py:150-170)."""
    height = float(np.linalg.norm(c2 - c1))
    if height < 1e-9:
        theta = np.linspace(0.0, 2 * np.pi, 100)
        ax.plot(radius * np.cos(theta) + c1[0],
                radius * np.sin(theta) + c1[1], **kwargs)
        return
    d = (c2 - c1) / height
    ang = np.arctan2(d[0], -d[1])  # angle of the left-hand orthogonal.
    theta1 = np.linspace(ang, ang + np.pi, 50)
    theta2 = np.linspace(ang + np.pi, ang + 2 * np.pi, 50)
    x = np.concatenate([
        np.stack([c1[0] + radius * np.cos(theta1),
                  c1[1] + radius * np.sin(theta1)], axis=1),
        np.stack([c2[0] + radius * np.cos(theta2),
                  c2[1] + radius * np.sin(theta2)], axis=1),
    ])
    x = np.concatenate([x, x[:1]])
    ax.plot(x[:, 0], x[:, 1], **kwargs)


def plot_xy_trajectory(
    logs: dict,
    path: str,
    bark_radius: float = 0.3,
    params=None,
    collision=None,
    controller_type: str = "consensus-admm",
    vision_radius: float | None = None,
    vision_cone_ang: float | None = None,
    mountain_center=(30.0, 0.0),
    mountain_radius: float = 25.0,
    key_frames=None,
    dpi: int = _SAVE_DPI,
):
    """Top-down paper figure (reference ``_plot_xy_trajectory``,
    rqp_plots.py:173-390): hill outline, tree footprints, dashed payload
    trajectory, and — at the controller-specific key frames — the payload
    polygon, per-quad footprints, the braking collision capsule, and the
    vision region (full disc for the centralized controller, per-agent wedges
    for the distributed ones).

    The overlays need system geometry: pass ``params`` (RQPParams: attachment
    points ``r``) and ``collision`` (RQPCollision: quad radius, collision
    radius, max deceleration). Without them, only trajectory + forest are
    drawn (the round-1 behavior).
    """
    plt = _mpl()
    from matplotlib import patches

    fig, ax = plt.subplots(figsize=(3.54, 2.0), dpi=200, layout="constrained")
    for side in ("top", "bottom", "left", "right"):
        ax.spines[side].set_visible(False)

    # Hill outline + forest (reference :206-232).
    theta = np.linspace(0.0, 2 * np.pi, 100)
    ax.plot(mountain_radius * np.cos(theta) + mountain_center[0],
            mountain_radius * np.sin(theta) + mountain_center[1],
            ls="--", lw=1, color=_GRASS_COLOR)
    if "tree_pos" in logs:
        for i, p in enumerate(host(logs["tree_pos"])):
            ax.add_patch(patches.Circle(
                (p[0], p[1]), bark_radius, fc=_BARK_COLOR, ec="black", lw=1.0,
                label="trees" if i == 0 else None,
            ))

    # Payload trajectory (reference :233-239).
    xl = host(logs["state_seq"]["xl"])
    ax.plot(xl[:, 0], xl[:, 1], ls="--", lw=1, color="black", label=r"$x_L$")

    # Key-frame overlays (reference :240-358).
    if params is not None and collision is not None:
        Rl = host(logs["state_seq"]["Rl"])
        vl = host(logs["state_seq"]["vl"])
        r = host(params.r)  # (n, 3) agent-leading layout.
        frames = key_frames if key_frames is not None else \
            _KEY_FRAMES.get(controller_type, (0.5,))
        n_steps = xl.shape[0]
        for k, frac in enumerate(frames):
            i = min(int(frac * n_steps), n_steps - 1)
            first = k == 0
            xq = xl[i][None, :] + np.einsum("ab,nb->na", Rl[i], r)  # (n, 3)
            ax.add_patch(patches.Polygon(
                xq[:, :2], closed=True, fc=_PAYLOAD_COLOR, ec="black", lw=0.5,
                label="payload" if first else None,
            ))
            for j in range(xq.shape[0]):
                ax.add_patch(patches.Circle(
                    xq[j, :2], collision.quadrotor_radius,
                    fc=_QUADROTOR_COLOR, ec="black", lw=0.5, alpha=0.75,
                    label="quadrotor" if first and j == 0 else None,
                ))
            # Braking collision capsule (reference :289-308).
            c1 = xl[i]
            c2 = xl[i] + 0.5 * np.linalg.norm(vl[i]) \
                / collision.max_deceleration * vl[i]
            _draw_capsule_outline(
                ax, c1[:2], c2[:2], collision.collision_radius,
                ls="--", lw=1, color=_MESH_COLOR,
                label="collision capsule" if first else None,
            )
            # Vision regions (reference :309-358).
            vr = vision_radius if vision_radius is not None \
                else collision.collision_radius + 5.0
            if controller_type == "centralized":
                ax.add_patch(patches.Circle(
                    c1[:2], vr, fc=_VISIONCONE_COLOR, ec="none", alpha=0.25,
                    label="vision region" if first else None,
                ))
            else:
                ang = vision_cone_ang if vision_cone_ang is not None \
                    else 100.0 * np.pi / 180.0
                for j in range(xq.shape[0]):
                    d = xq[j, :2] - xl[i, :2]
                    dir_ang = np.arctan2(d[1], d[0])
                    ax.add_patch(patches.Wedge(
                        xq[j, :2], vr,
                        (dir_ang - ang) * 180 / np.pi,
                        (dir_ang + ang) * 180 / np.pi,
                        fc=_VISIONCONE_COLOR, ec="none", alpha=0.25,
                        label="vision region" if first and j == 0 else None,
                    ))

    ax.legend(loc="upper right", fontsize=8, framealpha=1.0, ncol=2,
              fancybox=False, edgecolor="black", labelspacing=0.15)
    ax.tick_params(axis="both", which="both", bottom=False, top=False,
                   left=False, right=False, labelbottom=False, labelleft=False)
    ax.margins(0.05, 0.05)
    ax.axis("equal")
    fig.savefig(path, dpi=dpi)
    plt.close(fig)


CONTROLLER_TYPE = {
    "centralized": "centralized",
    "cadmm": "consensus-admm",
    "dd": "dual-decomposition",
}


def save_figures(logs: dict, out: str, controller: str, params=None,
                 collision=None, dist_eps: float = 0.1):
    """Render the full reference figure set from one rollout log: tracking
    errors, solver stats, the 600-dpi xy trajectory (with key-frame overlays
    when ``params``/``collision`` are given), and the 600-dpi min-dist plot.
    ``out`` is a directory or filename prefix; ``controller`` is the CLI name
    (centralized/cadmm/dd). Shared by the port's ``examples/rqp_forest.py``
    and ``examples/replay.py``."""
    import os

    prefix = os.path.join(out, "") if os.path.isdir(out) else out
    ctype = CONTROLLER_TYPE[controller]
    plot_tracking_errors(logs, f"{prefix}tracking_{controller}.png")
    plot_solver_stats(logs, f"{prefix}stats_{controller}.png", dist_eps)
    plot_xy_trajectory(
        logs, f"{prefix}xy_{controller}.png",
        params=params, collision=collision, controller_type=ctype,
    )
    plot_min_dist(logs, f"{prefix}min_dist_{controller}.png", dist_eps)


def plot_min_dist(logs: dict, path: str, dist_eps: float = 0.1,
                  t_final_frac: float = 0.85, dpi: int = _SAVE_DPI):
    """Min-obstacle-distance paper figure (reference ``_plot_min_dist``,
    rqp_plots.py:393-467): log-scale distance vs time with the ``eps_d``
    safety line, saved at >= 600 dpi."""
    plt = _mpl()
    fig, ax = plt.subplots(figsize=(3.54, 2.0), dpi=200, layout="constrained")
    ax.spines["top"].set_visible(False)
    ax.spines["right"].set_visible(False)
    T = logs["T"]
    d = host(logs["min_env_dist_seq"])
    t = np.linspace(0.0, T, len(d))
    ax.plot(t, d, "-b", lw=1,
            label=r"$\min_j\ \mathrm{dist}(CC(x_r(t)), \mathcal{O}_j)$")
    ax.plot(t, dist_eps * np.ones_like(t), "--k", lw=1, label=r"$\epsilon_d$")
    ax.legend(loc="upper right", fontsize=8, framealpha=0.5, fancybox=False,
              edgecolor="black", labelspacing=0.15)
    ax.set_yscale("log")
    ax.set_xlim([0.0, t_final_frac * T])
    ax.set_xlabel("time (s)", fontsize=8)
    ax.set_ylabel("minimum distance (m)", fontsize=8)
    ax.tick_params(axis="both", which="major", labelsize=8)
    ax.margins(0.05, 0.05)
    fig.savefig(path, dpi=dpi)
    plt.close(fig)


def plot_convergence_rates(err_seqs: dict[str, np.ndarray], path: str):
    """``err_seqs`` maps label -> (num_samples, num_iters) residual curves
    (NaN-padded); plots mean with min/max band per solver on a log scale."""
    plt = _mpl()
    fig, ax = plt.subplots(figsize=(3.54, 2.8), dpi=200, layout="constrained")
    colors = {"C-ADMM": "tab:blue", "DD": "tab:orange"}
    for label, errs in err_seqs.items():
        errs = host(errs)
        # nanmean/nanmin warn on all-NaN columns (tail iterations no sample
        # reached); reduce only columns with at least one finite entry.
        has_data = np.any(~np.isnan(errs), axis=0)
        mean = np.full(errs.shape[1], np.nan)
        lo = np.full(errs.shape[1], np.nan)
        hi = np.full(errs.shape[1], np.nan)
        mean[has_data] = np.nanmean(errs[:, has_data], axis=0)
        lo[has_data] = np.nanmin(errs[:, has_data], axis=0)
        hi[has_data] = np.nanmax(errs[:, has_data], axis=0)
        it = np.arange(1, errs.shape[1] + 1)
        valid = ~np.isnan(mean)
        c = colors.get(label)
        ax.plot(it[valid], mean[valid], lw=1.2, label=label, color=c)
        ax.fill_between(it[valid], lo[valid], hi[valid], alpha=0.2, color=c)
    ax.set_yscale("log")
    ax.set_xlabel("iteration")
    ax.set_ylabel("consensus residual [N]")
    ax.legend()
    fig.savefig(path)
    plt.close(fig)
