"""3-D scene rendering and trajectory replay: the port's copy of the JAX
package's ``viz/scene.py`` (reference ``RQPVisualizer`` and
``rqp_plots._visualization`` / ``_snapshot``,
system/rigid_quadrotor_payload.py:313-418 and example/rqp_plots.py:44-147).

The reference renders through meshcat (a websocket three.js viewer). The
default backend here is matplotlib 3-D snapshots -- the same scene content
(payload hull, quadrotor positions and attitudes, forest, ghost snapshots)
rendered to PNG frames on the host. :class:`MeshcatBackend` is the live
viewer's path with the same call surface, where meshcat is installed (its
constructor raises ``ImportError`` where it is not).

Host-side only. Parameters, states and forests may hold tensors on any
device: each is read once through ``viz.plots.host``.
"""

from __future__ import annotations

import os

import numpy as np

from tpu_aerial_transport_torch.viz.plots import host

QUAD_ARM = 0.15  # [m] drawn arm length for the quadrotor cross.
# Force-arrow overlay constants (reference system/rigid_payload.py:26-30).
FORCE_SCALING = 1.0  # [m/N] arrow length per Newton.
FORCE_MIN_LENGTH = 0.05  # [m] floor so near-zero forces stay visible.
FORCE_TAIL_RADIUS = 0.01  # [m] arrow shaft cylinder radius.
FORCE_HEAD_BASE_RADIUS = 0.03  # [m] arrow head cone base radius.
FORCE_HEAD_LENGTH = 0.1  # [m] arrow head cone height.
CONE_HEIGHT = 2.0  # [m] foliage cone on each bark (reference env_forest.py:24).
CONE_RADIUS = 1.0


def quadrotor_mesh(arm: float = 0.15, rotor_radius: float = 0.08,
                   body: float = 0.06, segments: int = 8):
    """Procedural quadrotor mesh ``(verts (V, 3), faces (F, 3))`` — the
    replacement for the reference's ``objs/quadrotor.obj`` asset
    (rigid_quadrotor_payload.py:17,308): a box body, four diagonal arms, and
    four rotor discs. Built from primitives rather than shipping a mesh file.
    """
    verts: list[np.ndarray] = []
    faces: list[list[int]] = []

    def add_box(center, half):
        i0 = len(verts)
        for dx in (-1, 1):
            for dy in (-1, 1):
                for dz in (-1, 1):
                    verts.append(center + half * np.array([dx, dy, dz]))
        quads = [(0, 1, 3, 2), (4, 6, 7, 5), (0, 4, 5, 1),
                 (2, 3, 7, 6), (0, 2, 6, 4), (1, 5, 7, 3)]
        for a, b, c, d in quads:
            faces.append([i0 + a, i0 + b, i0 + c])
            faces.append([i0 + a, i0 + c, i0 + d])

    def add_disc(center, radius, z):
        i0 = len(verts)
        verts.append(center + np.array([0.0, 0.0, z]))
        for k in range(segments):
            a = 2 * np.pi * k / segments
            verts.append(center + np.array(
                [radius * np.cos(a), radius * np.sin(a), z]
            ))
        for k in range(segments):
            faces.append([i0, i0 + 1 + k, i0 + 1 + (k + 1) % segments])

    add_box(np.zeros(3), np.array([body, body, body * 0.5]))
    for sx, sy in ((1, 1), (1, -1), (-1, 1), (-1, -1)):
        d = np.array([sx, sy, 0.0]) / np.sqrt(2.0)
        add_box(d * arm / 2, np.array([arm / 2 * abs(d[0]) + 0.01,
                                       arm / 2 * abs(d[1]) + 0.01, 0.008]))
        add_disc(d * arm, rotor_radius, 0.02)
    return np.asarray(verts), np.asarray(faces, np.int32)


def draw_forest_3d(ax, forest, ground: bool = True, max_trees: int | None = None):
    """Forest scene elements for the 3-D matplotlib backend (reference
    ``Forest.visualize_env``, env_forest.py:90-137): bark cylinders (drawn as
    thick lines), green foliage cones, the ground plane, and the spherical-cap
    mountain wireframe."""
    import numpy as _np

    num = int(forest.num_trees)
    if max_trees is not None:
        num = min(num, max_trees)
    pos = host(forest.tree_pos)[:num]
    h = forest.bark_height
    for p in pos:
        ax.plot([p[0], p[0]], [p[1], p[1]], [p[2] - h / 2, p[2] + h / 2],
                color="saddlebrown", lw=2, alpha=0.8)
        # Foliage cone: a small triangle fan.
        tip = np.array([p[0], p[1], p[2] + h / 2 + CONE_HEIGHT])
        ring = [
            np.array([p[0] + CONE_RADIUS * np.cos(a),
                      p[1] + CONE_RADIUS * np.sin(a), p[2] + h / 2])
            for a in np.linspace(0, 2 * np.pi, 9)
        ]
        from mpl_toolkits.mplot3d.art3d import Poly3DCollection

        tris = [[tip, ring[k], ring[k + 1]] for k in range(8)]
        ax.add_collection3d(
            Poly3DCollection(tris, facecolor="forestgreen", alpha=0.5)
        )
    if ground:
        # Spherical-cap mountain surface (coarse) + flat ground ring.
        from tpu_aerial_transport_torch.envs.forest import (
            MOUNTAIN_CENTER, MOUNTAIN_RADIUS,
        )

        th = _np.linspace(0, 2 * np.pi, 24)
        rr = _np.linspace(0, MOUNTAIN_RADIUS, 8)
        R, TH = _np.meshgrid(rr, th)
        X = MOUNTAIN_CENTER[0] + R * _np.cos(TH)
        Y = MOUNTAIN_CENTER[1] + R * _np.sin(TH)
        sr = float(forest.mountain_sphere_radius)
        cd = float(forest.mountain_center_depth)
        Z = _np.sqrt(_np.maximum(sr**2 - R**2, 0.0)) - cd
        Z = _np.maximum(Z, 0.0)
        ax.plot_wireframe(X, Y, Z, color="#70AB94", lw=0.4, alpha=0.5)


def _mpl():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def draw_snapshot(ax, params, payload_vertices, state, forest=None, alpha=1.0,
                  quad_mesh=False, forces=None,
                  force_scaling=FORCE_SCALING):
    """Draw one scene state into a 3-D matplotlib axis.

    ``state`` needs ``xl, Rl`` and optionally per-agent ``R``; agent positions
    are the attachment points ``xl + Rl r_i`` (rigid attachment, RQP model).
    ``alpha < 1`` renders a ghost (multi-snapshot scenes, rqp_plots.py:112-147).
    ``quad_mesh=True`` draws the full procedural quadrotor mesh instead of the
    cross-of-arms sketch. ``forces (n, 3)``: optional per-agent applied-force
    arrows from each agent (the reference's ``_DRAW_FORCE_ARROWS`` option,
    system/rigid_payload.py:25-30 / rigid_quadrotor_payload.py:25, default
    off there too); ``force_scaling`` is meters of arrow per Newton
    (reference ``_FORCE_SCALING``).
    """
    from mpl_toolkits.mplot3d.art3d import Poly3DCollection

    xl = host(state.xl)
    Rl = host(state.Rl)
    r = host(params.r)
    n = r.shape[0]

    # Payload hull (world frame).
    verts = host(payload_vertices) @ Rl.T + xl
    try:
        from scipy.spatial import ConvexHull

        hull = ConvexHull(verts)
        faces = [verts[s] for s in hull.simplices]
        ax.add_collection3d(
            Poly3DCollection(faces, alpha=0.3 * alpha, facecolor="tab:gray")
        )
    except (ImportError, ValueError, RuntimeError):  # Qhull: degenerate.
        ax.scatter(*verts.T, color="tab:gray", alpha=alpha, s=4)

    # Quadrotors: attachment points + body-frame arms (or the full procedural
    # mesh when ``quad_mesh=True`` — the reference's .obj-mesh path).
    quad_pos = xl + r @ Rl.T
    ax.scatter(*quad_pos.T, color="tab:blue", s=18 * alpha, alpha=alpha)
    if hasattr(state, "R") and state.R is not None:
        from mpl_toolkits.mplot3d.art3d import Poly3DCollection as _P3D

        R = host(state.R)
        if quad_mesh:
            mv, mf = quadrotor_mesh()
            for i in range(n):
                v = mv @ R[i].T + quad_pos[i]
                ax.add_collection3d(_P3D(
                    [v[f] for f in mf], facecolor="#1590A0",
                    alpha=0.6 * alpha, edgecolor="none",
                ))
        else:
            for i in range(n):
                for axis in (R[i, :, 0], R[i, :, 1]):
                    seg = np.stack([
                        quad_pos[i] - QUAD_ARM * axis,
                        quad_pos[i] + QUAD_ARM * axis,
                    ])
                    ax.plot(*seg.T, color="k", lw=0.8, alpha=alpha)

    if forces is not None:
        draw_force_arrows(ax, quad_pos, host(forces),
                          scaling=force_scaling, alpha=alpha)

    if forest is not None:
        draw_forest_3d(ax, forest)


def draw_force_arrows(ax, positions, forces, scaling=FORCE_SCALING,
                      alpha=1.0, color="tab:red"):
    """Per-agent applied-force arrows (reference ``_DRAW_FORCE_ARROWS``
    cylinder+cone pairs, system/rigid_payload.py:204-233, rendered here with
    matplotlib ``quiver``): one arrow per agent from its position along its
    applied force, length ``scaling`` m/N with the reference's
    ``_FORCE_MIN_LENGTH`` floor so near-zero forces stay visible."""
    positions = host(positions)
    forces = host(forces)
    norms = np.linalg.norm(forces, axis=-1)
    safe = np.where(norms > 1e-9, norms, 1.0)
    lengths = np.maximum(norms * scaling, FORCE_MIN_LENGTH)
    dirs = forces / safe[:, None]
    # Exactly-zero force: fall back to +z (the reference's default cylinder
    # orientation) so the min-length arrow is still drawn.
    z = np.zeros_like(dirs)
    z[:, 2] = 1.0
    dirs = np.where((norms > 1e-9)[:, None], dirs, z)
    vecs = dirs * lengths[:, None]
    ax.quiver(
        positions[:, 0], positions[:, 1], positions[:, 2],
        vecs[:, 0], vecs[:, 1], vecs[:, 2],
        color=color, alpha=alpha, lw=1.2, arrow_length_ratio=0.25,
    )


def draw_pmrl_snapshot(ax, params, payload_vertices, state, alpha=1.0):
    """PMRL scene: payload hull + rigid links (cylinders in the reference,
    ``PMRLVisualizer``, point_mass_rigid_link.py:257-397) + point-mass robots at
    ``xl + Rl r_i + L_i q_i``."""
    xl = host(state.xl)
    Rl = host(state.Rl)
    r = host(params.r)
    L = host(params.L)
    q = host(state.q)

    draw_snapshot(ax, params, payload_vertices,
                  type("S", (), {"xl": xl, "Rl": Rl, "R": None})(), alpha=alpha)
    attach = xl + r @ Rl.T
    robots = attach + q * L[:, None]
    ax.scatter(*robots.T, color="tab:red", s=20 * alpha, alpha=alpha)
    for i in range(r.shape[0]):
        seg = np.stack([attach[i], robots[i]])
        ax.plot(*seg.T, color="gray", lw=1.2, alpha=alpha)


def render_frames(
    logs: dict,
    params,
    payload_vertices,
    out_dir: str,
    forest=None,
    stride: int = 25,
    follow: bool = True,
    force_arrows: bool = False,
):
    """Replay a rollout log as PNG frames (the reference's meshcat replay
    with follow camera, rqp_plots.py:44-109; camera smoothing via
    :func:`smooth_camera_track` — the reference's savgol when scipy is
    present, windowed mean otherwise). ``force_arrows`` overlays the logged
    commanded forces per agent (the reference's ``_DRAW_FORCE_ARROWS``
    option; needs ``f_des_seq`` in the log — state-only log rates fall back
    to no arrows). Returns the frame paths."""
    plt = _mpl()
    os.makedirs(out_dir, exist_ok=True)
    xl_seq = host(logs["state_seq"]["xl"])
    Rl_seq = host(logs["state_seq"]["Rl"])
    R_seq = host(logs["state_seq"]["R"])
    f_seq = None
    if force_arrows and "f_des_seq" in logs:
        f_seq = host(logs["f_des_seq"])

    # Smoothed follow-camera track (reference savgol, rqp_plots.py:78).
    smooth = smooth_camera_track(xl_seq)

    class _S:
        pass

    paths = []
    for fi, t in enumerate(range(0, len(xl_seq), stride)):
        fig = plt.figure(figsize=(5, 4), dpi=120)
        ax = fig.add_subplot(projection="3d")
        s = _S()
        s.xl, s.Rl, s.R = xl_seq[t], Rl_seq[t], R_seq[t]
        draw_snapshot(ax, params, payload_vertices, s, forest,
                      forces=None if f_seq is None else f_seq[t])
        c = smooth[t] if follow else xl_seq[0]
        ax.set_xlim(c[0] - 4, c[0] + 4)
        ax.set_ylim(c[1] - 4, c[1] + 4)
        ax.set_zlim(max(0, c[2] - 3), c[2] + 3)
        ax.set_xlabel("x")
        ax.set_ylabel("y")
        path = os.path.join(out_dir, f"frame_{fi:04d}.png")
        fig.savefig(path)
        plt.close(fig)
        paths.append(path)
    return paths


def render_ghost_snapshot(
    logs: dict, params, payload_vertices, path: str, times: list[int],
    forest=None,
):
    """Multi-ghost single figure (reference ``_snapshot``, rqp_plots.py:112-147):
    overlay the system at several log indices with increasing opacity."""
    plt = _mpl()
    fig = plt.figure(figsize=(6, 4.5), dpi=150)
    ax = fig.add_subplot(projection="3d")
    xl_seq = host(logs["state_seq"]["xl"])
    Rl_seq = host(logs["state_seq"]["Rl"])
    R_seq = host(logs["state_seq"]["R"])

    class _S:
        pass

    for k, t in enumerate(times):
        s = _S()
        s.xl, s.Rl, s.R = xl_seq[t], Rl_seq[t], R_seq[t]
        alpha = 0.3 + 0.7 * (k + 1) / len(times)
        # Forest drawn once (first ghost) — re-drawing stacks translucent
        # foliage/mountain artists toward opaque and multiplies render time.
        draw_snapshot(ax, params, payload_vertices, s,
                      forest if k == 0 else None, alpha=alpha)
    ax.plot(*xl_seq[: max(times) + 1].T, color="tab:blue", lw=0.8, ls="--")
    lo = xl_seq[times].min(axis=0) - 3
    hi = xl_seq[times].max(axis=0) + 3
    ax.set_xlim(lo[0], hi[0])
    ax.set_ylim(lo[1], hi[1])
    ax.set_zlim(max(0, lo[2]), hi[2])
    fig.savefig(path)
    plt.close(fig)


_Z_UP = np.array([[1, 0, 0], [0, 0, -1], [0, 1, 0]], float).T  # y-up -> z-up.


def smooth_camera_track(xl_seq: np.ndarray, window: int = 51,
                        polyorder: int = 3) -> np.ndarray:
    """Smoothed follow-camera track over a payload trajectory — the
    reference's ``savgol_filter(xl, window, 3)`` (rqp_plots.py:78) when
    scipy is importable, else a centered windowed mean (same intent:
    low-pass the camera so it doesn't shake with the payload)."""
    xl_seq = host(xl_seq)
    window = min(window, len(xl_seq) - (len(xl_seq) + 1) % 2)  # <= T, T-odd.
    window -= 1 - window % 2  # force odd: savgol rejects even windows.
    if window < 5:
        return xl_seq.copy()
    try:
        from scipy.signal import savgol_filter

        return savgol_filter(xl_seq, window, min(polyorder, window - 1),
                             axis=0)
    except ImportError:
        k = window // 2
        pad = np.pad(xl_seq, ((k, k), (0, 0)), mode="edge")
        return np.stack([
            pad[i: i + 2 * k + 1].mean(axis=0) for i in range(len(xl_seq))
        ])


def _rotation_y_to(d: np.ndarray) -> np.ndarray:
    """Rotation taking the +y axis (meshcat's cylinder axis) onto unit ``d``
    by the minimal rotation (Rodrigues about y x d); antipodal -y falls back
    to a pi flip about x."""
    y = np.array([0.0, 1.0, 0.0])
    c = float(y @ d)
    if c < -1.0 + 1e-12:
        return np.diag([1.0, -1.0, -1.0])
    v = np.cross(y, d)
    vx = np.array([[0, -v[2], v[1]], [v[2], 0, -v[0]], [-v[1], v[0], 0]])
    return np.eye(3) + vx + vx @ vx / (1.0 + c)


class MeshcatBackend:
    """Live three.js viewer path, used only when meshcat is installed (the
    reference's default backend). Mirrors ``RQPVisualizer``'s scene graph
    (rigid_quadrotor_payload.py:313-418): payload hull mesh, per-quad
    quadrotor meshes (procedural, replacing objs/quadrotor.obj), and the full
    forest scene — bark cylinders, foliage cones, ground plane, mountain —
    from ``Forest.visualize_env`` (env_forest.py:90-137). ``replay`` drives
    the smoothed follow camera of ``rqp_plots._visualization`` (:44-109)."""

    def __init__(self):
        import meshcat  # noqa: F401 — optional dependency.

        self.vis = meshcat.Visualizer()
        self._objs: set[str] = set()

    def open(self):
        self.vis.open()
        return self

    def visualize_env(self, forest, ground_extent: float = 60.0):
        import meshcat.geometry as gm
        import meshcat.transformations as tf

        from tpu_aerial_transport_torch.envs.forest import MOUNTAIN_CENTER

        # Ground plane (reference :115-121: a thin box).
        self.vis["ground"].set_object(
            gm.Box([2 * ground_extent, 2 * ground_extent, 0.02])
        )
        self.vis["ground"].set_transform(
            tf.translation_matrix([0.0, 0.0, -0.011])
        )
        # Mountain spherical cap, approximated as in the reference (:123-137)
        # by a sphere sunk below ground level. Center depth matches the
        # physics model (forest.ground_height) so the rendered surface is the
        # surface the terrain-following reference trajectory flies over.
        sr = float(forest.mountain_sphere_radius)
        cd = float(forest.mountain_center_depth)
        self.vis["mountain"].set_object(gm.Sphere(sr))
        self.vis["mountain"].set_transform(tf.translation_matrix(
            [MOUNTAIN_CENTER[0], MOUNTAIN_CENTER[1], -cd]
        ))
        num = int(forest.num_trees)
        for i, p in enumerate(host(forest.tree_pos)[:num]):
            # Bark cylinder (:99-106).
            self.vis[f"bark_{i}"].set_object(
                gm.Cylinder(height=forest.bark_height, radius=forest.bark_radius)
            )
            T = tf.translation_matrix(p)
            T[:3, :3] = _Z_UP
            self.vis[f"bark_{i}"].set_transform(T)
            # Foliage cone on top (:107-114); meshcat Cylinder with zero top
            # radius is a cone, y-up like all meshcat cylinders.
            self.vis[f"cone_{i}"].set_object(gm.Cylinder(
                height=CONE_HEIGHT, radiusBottom=CONE_RADIUS, radiusTop=0.0
            ))
            Tc = tf.translation_matrix(
                p + np.array([0.0, 0.0, forest.bark_height / 2 + CONE_HEIGHT / 2])
            )
            Tc[:3, :3] = _Z_UP
            self.vis[f"cone_{i}"].set_transform(Tc)

    def _ensure_objects(self, params, payload_vertices, prefix: str):
        import meshcat.geometry as gm

        name = prefix + "payload"
        if name not in self._objs and payload_vertices is not None:
            try:
                from tpu_aerial_transport_torch.utils.geometry import (
                    faces_from_vertex_rep,
                )

                verts = host(payload_vertices)
                self.vis[name].set_object(gm.TriangularMeshGeometry(
                    verts, faces_from_vertex_rep(verts)
                ))
                self._objs.add(name)
            except (ValueError, RuntimeError):  # Qhull: a degenerate hull.
                pass
        missing = [
            i for i in range(host(params.r).shape[0])
            if prefix + f"quad_{i}" not in self._objs
        ]
        if missing:  # build the procedural mesh only when actually needed.
            mv, mf = quadrotor_mesh()
            for i in missing:
                qn = prefix + f"quad_{i}"
                self.vis[qn].set_object(gm.TriangularMeshGeometry(mv, mf))
                self._objs.add(qn)

    def update(self, params, state, prefix: str = "", payload_vertices=None,
               forces=None):
        import meshcat.transformations as tf

        self._ensure_objects(params, payload_vertices, prefix)
        xl = host(state.xl)
        Rl = host(state.Rl)
        T = tf.translation_matrix(xl)
        T[:3, :3] = Rl
        self.vis[prefix + "payload"].set_transform(T)
        r = host(params.r)
        R = host(state.R)
        for i in range(r.shape[0]):
            Ti = tf.translation_matrix(xl + Rl @ r[i])
            Ti[:3, :3] = R[i]
            self.vis[prefix + f"quad_{i}"].set_transform(Ti)
        if forces is not None:
            self._update_force_arrows(
                params, xl, Rl, host(forces), prefix
            )

    def _update_force_arrows(self, params, xl, Rl, forces, prefix: str = ""):
        """Solid cylinder+cone arrow per agent along its applied force
        (reference ``_DRAW_FORCE_ARROWS`` geometry, rigid_payload.py:204-233
        / :249-274): shaft length ``FORCE_SCALING`` m/N with the
        ``FORCE_MIN_LENGTH`` floor, fixed-size cone head at the tip, rooted
        at each attachment point. The shaft is re-created each frame (its
        height changes); the head is created once and re-posed."""
        import meshcat.geometry as gm
        import meshcat.transformations as tf

        r = host(params.r)
        for i in range(r.shape[0]):
            norm = float(np.linalg.norm(forces[i]))
            d = (forces[i] / norm if norm > 0
                 else np.array([0.0, 0.0, 1.0]))  # zero force: +z, as ref.
            length = max(norm * FORCE_SCALING, FORCE_MIN_LENGTH)
            root = xl + Rl @ r[i]
            rot = _rotation_y_to(d)
            tail = prefix + f"force_tail_{i}"
            head = prefix + f"force_head_{i}"
            # Both pieces are create-once/re-pose: the varying shaft length
            # rides in the transform as a y-axis (cylinder-axis) scale of a
            # unit-height cylinder — no per-frame geometry re-uploads on the
            # replay hot path.
            if tail not in self._objs:
                self.vis[tail].set_object(
                    gm.Cylinder(height=1.0, radius=FORCE_TAIL_RADIUS)
                )
                self._objs.add(tail)
            T = tf.translation_matrix(root + 0.5 * length * d)
            T[:3, :3] = rot @ np.diag([1.0, length, 1.0])
            self.vis[tail].set_transform(T)
            if head not in self._objs:
                self.vis[head].set_object(gm.Cylinder(
                    height=FORCE_HEAD_LENGTH,
                    radiusBottom=FORCE_HEAD_BASE_RADIUS, radiusTop=0.0,
                ))
                self._objs.add(head)
            Th = tf.translation_matrix(
                root + (length + 0.5 * FORCE_HEAD_LENGTH) * d
            )
            Th[:3, :3] = rot
            self.vis[head].set_transform(Th)

    def replay(self, logs: dict, params, payload_vertices=None, forest=None,
               speedup: float = 5.0, min_fps: float = 24.0,
               force_arrows: bool = False):
        """Replay a rollout log with the smoothed follow camera (reference
        ``_visualization``, rqp_plots.py:44-109: savgol-smoothed camera track,
        fast-forward, minimum frame pacing). ``force_arrows`` draws the solid
        cylinder+cone commanded-force arrows (needs ``f_des_seq`` in the
        log)."""
        import time as _time

        if forest is not None:
            self.visualize_env(forest)
        xl_seq = host(logs["state_seq"]["xl"])
        Rl_seq = host(logs["state_seq"]["Rl"])
        R_seq = host(logs["state_seq"]["R"])
        f_seq = (host(logs["f_des_seq"])
                 if force_arrows and "f_des_seq" in logs else None)
        dt_frame = logs["dt"] * logs["hl_rel_freq"] / speedup
        stride = max(1, int(round(1.0 / (min_fps * dt_frame))))
        smooth = smooth_camera_track(xl_seq)

        class _S:
            pass

        for t in range(0, len(xl_seq), stride):
            s = _S()
            s.xl, s.Rl, s.R = xl_seq[t], Rl_seq[t], R_seq[t]
            self.update(params, s, payload_vertices=payload_vertices,
                        forces=None if f_seq is None else f_seq[t])
            cam = smooth[t] + np.array([-3.0, -3.0, 1.5])
            try:
                self.vis.set_cam_pos(cam)
                self.vis.set_cam_target(smooth[t])
            except AttributeError:
                pass  # older meshcat versions lack camera helpers.
            _time.sleep(max(dt_frame * stride, 1.0 / min_fps))
