"""PyTorch port vs the JAX package: the host-side visualisation
(``viz/plots.py``, ``viz/scene.py``) and ``utils/geometry.py``.

The geometry and scene helpers are numpy (and scipy's ``ConvexHull``) in
both packages, so on the same numpy inputs their outputs are bitwise
equal: the procedural quadrotor mesh, the minimal rotation onto a
direction, the follow camera's smoothing, the convex-hull faces and the
half-space vertex enumeration. Every figure function renders a log dict of
the port's own rollout (``harness.rollout.logs_to_dict``; parameters and
forest as tensors) under the Agg backend to a non-empty PNG; the meshcat
viewer is optional and raises ``ImportError`` without meshcat.
"""

import os
import sys

import numpy as np
import pytest
import torch

from tpu_aerial_transport.utils import geometry as jgeometry
from tpu_aerial_transport.viz import scene as jscene
from tpu_aerial_transport_torch.envs import forest as forest_mod
from tpu_aerial_transport_torch.harness import rollout, setup
from tpu_aerial_transport_torch.tree import tree_map
from tpu_aerial_transport_torch.utils import geometry
from tpu_aerial_transport_torch.viz import plots, scene


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    assert np.array_equal(a, b)


@pytest.mark.parametrize("kw", [
    {}, dict(arm=0.2, rotor_radius=0.05, body=0.04, segments=12),
    dict(segments=3),
], ids=["default", "wide", "coarse"])
def test_quadrotor_mesh_matches_jax(kw):
    """The procedural quadrotor mesh, vertices and faces, bitwise."""
    v, f = scene.quadrotor_mesh(**kw)
    jv, jf = jscene.quadrotor_mesh(**kw)
    _same(v, jv)
    _same(f, jf)


def test_rotation_y_to_matches_jax():
    """The minimal rotation taking +y onto a unit direction, bitwise, on
    seeded directions, +y itself, -y (the pi flip) and one near -y."""
    rng = np.random.default_rng(0)
    dirs = list(rng.normal(size=(16, 3)))
    dirs += [np.array([0.0, 1.0, 0.0]), np.array([0.0, -1.0, 0.0]),
             np.array([1e-9, -1.0, 0.0])]
    for d in dirs:
        d = d / np.linalg.norm(d)
        rot = scene._rotation_y_to(d)
        _same(rot, jscene._rotation_y_to(d))
        np.testing.assert_allclose(rot @ np.array([0.0, 1.0, 0.0]), d,
                                   atol=1e-6)


@pytest.mark.parametrize("T", [3, 8, 60, 201])
def test_smooth_camera_track_matches_jax(T):
    """The follow camera's smoothing (scipy's savgol, windows cut to the
    trajectory), bitwise, on a seeded random walk of T samples."""
    xl = np.cumsum(np.random.default_rng(T).normal(size=(T, 3)), axis=0)
    _same(scene.smooth_camera_track(xl), jscene.smooth_camera_track(xl))
    _same(scene.smooth_camera_track(xl, window=11, polyorder=2),
          jscene.smooth_camera_track(xl, window=11, polyorder=2))


def test_faces_from_vertex_rep_matches_jax():
    """Convex-hull faces of the payload's vertices and of seeded point
    clouds, bitwise; a malformed array is refused."""
    _, col, _ = setup.rqp_setup(3, device="cpu")
    clouds = [col.payload_vertices, col.payload_mesh_vertices]
    clouds += [np.random.default_rng(s).normal(size=(20, 3))
               for s in range(3)]
    for pts in clouds:
        _same(geometry.faces_from_vertex_rep(pts),
              jgeometry.faces_from_vertex_rep(pts))
    with pytest.raises(ValueError):
        geometry.faces_from_vertex_rep(np.zeros((4, 2)))


def test_mesh_from_halfspace_rep_matches_jax():
    """Vertex enumeration of a box and an octahedron from their H-reps,
    vertices and faces bitwise; an empty polytope raises in both."""
    box_A = np.vstack([np.eye(3), -np.eye(3)])
    box_b = np.array([0.5, 0.3, 0.1, 0.5, 0.3, 0.1])
    signs = np.array([[sx, sy, sz] for sx in (-1, 1) for sy in (-1, 1)
                      for sz in (-1, 1)], float)
    for A, b in ((box_A, box_b), (signs, np.ones(8))):
        v, f = geometry.mesh_from_halfspace_rep(A, b)
        jv, jf = jgeometry.mesh_from_halfspace_rep(A, b)
        _same(v, jv)
        _same(f, jf)
    A = np.vstack([np.eye(3), -np.eye(3)])
    b = np.array([1.0, 1.0, 1.0, -2.0, 1.0, 1.0])
    for mod in (geometry, jgeometry):
        with pytest.raises(ValueError, match="empty"):
            mod.mesh_from_halfspace_rep(A, b)


@pytest.fixture(scope="module")
def run_log():
    """A 6-step C-ADMM rollout of the port at n = 3 on the CPU (the forest
    reference), as ``logs_to_dict`` gives it: ``(log dict, params,
    collision, forest)``, the parameters and forest as tensors."""
    ctl = rollout.make_controller("cadmm", 3, max_iter=3, inner_iters=10,
                                  device="cpu")
    run = rollout.jit_rollout(
        ctl.control, ctl.ll.control, ctl.params, n_hl_steps=6,
        acc_des_fn=rollout.make_forest_acc_des(ctl.forest))
    states = rollout.stack_scenarios(ctl.state0.replace(
        xl=torch.tensor([0.0, 0.0, 1.5])), 1)
    _, _, logs = run(states, rollout.stack_scenarios(ctl.cs0, 1))
    logs = tree_map(lambda t: t[:, 0], logs)
    return (rollout.logs_to_dict(logs, 3, 1e-3, 10, ctl.forest), ctl.params,
            ctl.col, ctl.forest)


def _png(path):
    assert os.path.getsize(path) > 1000
    with open(path, "rb") as fh:
        assert fh.read(8) == b"\x89PNG\r\n\x1a\n"


PLOTS = {
    "tracking_errors": lambda log, p, c, path: plots.plot_tracking_errors(
        log, path),
    "solver_stats": lambda log, p, c, path: plots.plot_solver_stats(
        log, path, dist_eps=0.1),
    "xy_trajectory_cadmm": lambda log, p, c, path: plots.plot_xy_trajectory(
        log, path, params=p, collision=c, dpi=60),
    "xy_trajectory_centralized": lambda log, p, c, path:
        plots.plot_xy_trajectory(log, path, params=p, collision=c,
                                 controller_type="centralized", dpi=60),
    "xy_trajectory_bare": lambda log, p, c, path: plots.plot_xy_trajectory(
        log, path, dpi=60),
    "min_dist": lambda log, p, c, path: plots.plot_min_dist(
        log, path, dpi=60),
    "convergence_rates": lambda log, p, c, path:
        plots.plot_convergence_rates(
            {"C-ADMM": np.abs(np.random.default_rng(0).normal(size=(4, 6))),
             "DD": np.where(np.arange(6) < 4, 1.0, np.nan)[None].repeat(
                 3, 0)}, path),
}


@pytest.mark.parametrize("name", sorted(PLOTS))
def test_plot_renders_a_port_log(run_log, name, tmp_path):
    """Each figure of ``viz.plots`` from the port's log dict (tensors for
    the parameters), under Agg, to a non-empty PNG."""
    log, params, col, _ = run_log
    path = str(tmp_path / f"{name}.png")
    PLOTS[name](log, params, col, path)
    _png(path)
    import matplotlib

    assert matplotlib.get_backend().lower() == "agg"


def test_scene_renders_frames_and_ghosts(run_log, tmp_path):
    """The replay frames (forest, force arrows) and the ghost snapshot
    from the port's log, the forest rebuilt from the logged trees as
    tensors; one snapshot with the full quadrotor mesh."""
    log, params, col, _ = run_log
    world = forest_mod.forest_from_tree_pos(log["tree_pos"][:12], 12,
                                            device="cpu")
    frames = scene.render_frames(log, params, col.payload_vertices,
                                 str(tmp_path / "frames"), forest=world,
                                 stride=4, force_arrows=True)
    assert len(frames) == 2
    for p in frames:
        _png(p)
    ghosts = str(tmp_path / "ghosts.png")
    scene.render_ghost_snapshot(log, params, col.payload_vertices, ghosts,
                                times=[0, 3, 5], forest=world)
    _png(ghosts)
    plt = scene._mpl()
    fig = plt.figure()
    ax = fig.add_subplot(projection="3d")
    state = type("S", (), {"xl": torch.zeros(3), "Rl": torch.eye(3),
                           "R": torch.eye(3).expand(3, 3, 3)})()
    scene.draw_snapshot(ax, params, col.payload_vertices, state,
                        quad_mesh=True, forces=torch.ones(3, 3))
    pm_params, pm_col, pm_state = setup.pmrl_setup(3, device="cpu")
    scene.draw_pmrl_snapshot(ax, pm_params, pm_col.payload_vertices,
                             pm_state)
    path = str(tmp_path / "snap.png")
    fig.savefig(path)
    plt.close(fig)
    _png(path)


def test_meshcat_is_optional_and_raises(monkeypatch):
    """The live viewer needs meshcat: without it the backend's
    constructor raises ``ImportError``, as the JAX package's does."""
    monkeypatch.setitem(sys.modules, "meshcat", None)
    with pytest.raises(ImportError):
        scene.MeshcatBackend()
    with pytest.raises(ImportError):
        jscene.MeshcatBackend()
