"""Procedural forest environment with closed-form collision distance queries.

Counterpart of ``tpu_aerial_transport/envs/forest.py``. Trees are z-aligned
cylinders on a spherical-cap mountain (or, for a city-scale world, on a
seeded jittered grid around it), generated host-side with a seeded numpy RNG
into a fixed ``(max_trees, 3)`` slot array (invalid slots parked at 1e6).
Queries are batched over leading axes: a capsule per scenario against every
tree (the dense sweep), or against the candidates of a spatial-hash grid
(``envs/spatial.py``, the bucketed tier, which runs the same per-tree math).

Per-tree values must not depend on how many trees a sweep holds or where a
tree sits in memory (the bucketed rows are bitwise the dense rows): the
norms and dot products over a tree's 2- or 3-vector are written as explicit
products and adds, since a reduction kernel may group the terms by the
row's alignment.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from tpu_aerial_transport_torch import resolve_device
from tpu_aerial_transport_torch.control.types import EnvCBF
from tpu_aerial_transport_torch.obs import phases

MOUNTAIN_CENTER = np.array([30.0, 0.0])
MOUNTAIN_RADIUS = 25.0
MOUNTAIN_HEIGHT = 7.5
BARK_HEIGHT = 4.0
BARK_RADIUS = 0.3
MIN_DIST_BETWEEN_TREES = 3.2
MAX_TREES = 200

_FAR = 1.0e6
# Grid bracket (_GRID_PTS evaluations) + _REFINE_ITERS golden-section steps
# along the capsule axis; both counts are the JAX package's.
_GRID_PTS = 33
_REFINE_ITERS = 12

# Braking-time floor [s] for rows of obstacles inside dist_eps.
NEAR_BRAKE_TIME = 0.2
_INV_PHI = 0.6180339887498949


@dataclass(frozen=True)
class Forest:
    """Fixed-shape forest. ``tree_pos[i]`` is tree i's cylinder center."""

    tree_pos: torch.Tensor  # (max_trees, 3).
    tree_valid: torch.Tensor  # (max_trees,) bool.
    num_trees: torch.Tensor  # () int32.
    mountain_sphere_radius: torch.Tensor  # ().
    mountain_center_depth: torch.Tensor  # ().
    bark_radius: float = BARK_RADIUS
    bark_height: float = BARK_HEIGHT
    # The spatial-hash grid of the bucketed query tier
    # (``envs.spatial.SpatialGrid``, attached by ``spatial.with_grid``);
    # None leaves the dense sweep the only tier.
    grid: object | None = None


def _mountain_geometry():
    ang = np.pi / 2.0 - np.arctan2(MOUNTAIN_RADIUS, MOUNTAIN_HEIGHT)
    sphere_radius = MOUNTAIN_RADIUS / np.sin(ang)
    return sphere_radius, sphere_radius * np.cos(ang)


def _ground_np(sphere_radius, center_depth, d2):
    return np.maximum(
        np.sqrt(np.maximum(sphere_radius**2 - d2, 0.0)) - center_depth, 0.0
    )


def _forest_from_pos3(pos3, num, device) -> Forest:
    dev = resolve_device(device)
    sphere_radius, center_depth = _mountain_geometry()
    max_trees = pos3.shape[0]
    f32 = dict(dtype=torch.float32, device=dev)
    return Forest(
        tree_pos=torch.as_tensor(pos3, **f32),
        tree_valid=torch.as_tensor(np.arange(max_trees) < num, device=dev),
        num_trees=torch.tensor(num, dtype=torch.int32, device=dev),
        mountain_sphere_radius=torch.tensor(sphere_radius, **f32),
        mountain_center_depth=torch.tensor(center_depth, **f32),
    )


def make_forest(seed: int = 0, max_trees: int = MAX_TREES,
                device="cuda", *, world_size: float | None = None,
                density: float | None = None) -> Forest:
    """Seeded forest, generated in float64 numpy with the JAX package's RNG
    calls and rounded to float32, so the tree positions match it exactly.

    Default: rejection sampling of up to ``max_trees`` trees at least 3.2 m
    apart inside the 25 m mountain disc, the first pinned at center +
    (0.5, 0.5); center z = (ground height + bark height) / 2.

    City-scale (``world_size`` in m): a jittered grid of ``density``
    trees/m^2 (default ``1 / MIN_DIST_BETWEEN_TREES^2``) over the
    ``world_size`` square centred on the mountain, the jitter bounded so
    every pair stays 3.2 m apart. Refused (ValueError): ``density`` without
    ``world_size``, a grid pitch below 3.2 m, and a world of more trees
    than ``max_trees``. A world above ``spatial.DENSE_AUTO_MAX_TREES``
    slots wants a grid (``envs.spatial.with_grid``)."""
    rng = np.random.default_rng(seed)
    if density is not None and world_size is None:
        raise ValueError("density= requires world_size=")
    if world_size is not None:
        if density is None:
            density = 1.0 / MIN_DIST_BETWEEN_TREES**2
        pitch = 1.0 / np.sqrt(density)
        if pitch < MIN_DIST_BETWEEN_TREES:
            raise ValueError(
                f"density={density} gives a grid pitch of {pitch:.2f} m, "
                f"below the {MIN_DIST_BETWEEN_TREES} m minimum tree "
                "spacing — reduce density to at most "
                f"{1.0 / MIN_DIST_BETWEEN_TREES**2:.4f} trees/m^2"
            )
        n_side = max(int(np.floor(world_size / pitch)), 1)
        num = n_side * n_side
        if num > max_trees:
            raise ValueError(
                f"world_size={world_size} at density={density} needs "
                f"{num} tree slots but max_trees={max_trees} — pass "
                f"max_trees>={num} (refusing to silently truncate the "
                "world to the first max_trees grid rows)"
            )
        jitter = max((pitch - MIN_DIST_BETWEEN_TREES) / 2.0, 0.0)
        base = (np.arange(n_side) + 0.5) * pitch - world_size / 2.0
        gx, gy = np.meshgrid(base, base, indexing="ij")
        tree_xy = np.stack([gx.ravel(), gy.ravel()], axis=1)
        tree_xy += rng.uniform(-jitter, jitter, size=tree_xy.shape)
        tree_xy += MOUNTAIN_CENTER
    else:
        tree_xy = [MOUNTAIN_CENTER + np.array([0.5, 0.5])]
        for _ in range(max_trees * 50):
            if len(tree_xy) >= max_trees:
                break
            pos = rng.random(2) - 0.5
            norm = np.linalg.norm(pos)
            if norm == 0:
                continue
            pos = pos / norm * rng.random() * MOUNTAIN_RADIUS + MOUNTAIN_CENTER
            if np.min(np.linalg.norm(np.array(tree_xy) - pos, axis=1)) \
                    < MIN_DIST_BETWEEN_TREES:
                continue
            tree_xy.append(pos)
        tree_xy = np.array(tree_xy)
    num = len(tree_xy)
    sphere_radius, center_depth = _mountain_geometry()
    pos3 = np.full((max_trees, 3), _FAR)
    pos3[:num, :2] = tree_xy
    d2 = np.sum((tree_xy - MOUNTAIN_CENTER) ** 2, axis=1)
    ground = _ground_np(sphere_radius, center_depth, d2)
    pos3[:num, 2] = (ground + BARK_HEIGHT) / 2.0
    return _forest_from_pos3(pos3, num, device)


def forest_from_tree_pos(tree_pos, num_trees, max_trees: int = MAX_TREES,
                         device="cuda") -> Forest:
    """Rebuild a Forest from logged tree centers (refuses to truncate)."""
    tree_pos = np.asarray(tree_pos)
    if tree_pos.shape[0] > max_trees:
        raise ValueError(
            f"{tree_pos.shape[0]} logged tree positions do not fit "
            f"max_trees={max_trees} slots"
        )
    pos3 = np.full((max_trees, 3), _FAR)
    pos3[: tree_pos.shape[0]] = tree_pos
    forest = _forest_from_pos3(pos3, tree_pos.shape[0], device)
    return dataclasses.replace(
        forest, num_trees=torch.tensor(
            int(num_trees), dtype=torch.int32, device=forest.tree_pos.device
        ),
    )


def ground_height(forest: Forest, xy: torch.Tensor) -> torch.Tensor:
    """Terrain height of the spherical-cap mountain at ``xy (..., 2)`` (0 on
    flat ground), for the terrain-following reference trajectory. The
    center enters as Python floats: no host-to-device copy a call."""
    dx = xy[..., 0] - float(MOUNTAIN_CENTER[0])
    dy = xy[..., 1] - float(MOUNTAIN_CENTER[1])
    r2 = forest.mountain_sphere_radius**2
    h = (torch.sqrt(torch.clamp(r2 - (dx * dx + dy * dy), min=0.0))
         - forest.mountain_center_depth)
    return torch.clamp(h, min=0.0)


def _dot(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Dot product over the short trailing axis as explicit products and
    adds, left to right (the module docstring says why)."""
    us, vs = u.unbind(-1), v.unbind(-1)
    acc = us[0] * vs[0]
    for a, b in zip(us[1:], vs[1:]):
        acc = acc + a * b
    return acc


def _norm(v: torch.Tensor, keepdim: bool = False) -> torch.Tensor:
    """Euclidean norm over the trailing axis, ``sqrt(v . v)`` (the JAX
    package's ``jnp.linalg.norm``)."""
    out = torch.sqrt(_dot(v, v))
    return out[..., None] if keepdim else out


def point_cylinder_distance(p, center, radius, half_height):
    """Distance from ``p (..., 3)`` to a z-aligned flat-capped cylinder
    (negative inside) and the closest point on its surface. Interior points
    project to the nearer face; on-axis points take a fixed radial
    direction."""
    dxy = p[..., :2] - center[..., :2]
    rho = _norm(dxy)
    dz = p[..., 2] - center[..., 2]
    d_rad = rho - radius
    d_ax = torch.abs(dz) - half_height
    dr_pos = torch.clamp(d_rad, min=0.0)
    da_pos = torch.clamp(d_ax, min=0.0)
    outside = torch.sqrt(dr_pos * dr_pos + da_pos * da_pos)
    inside = torch.maximum(d_rad, d_ax)
    is_inside = (d_rad <= 0.0) & (d_ax <= 0.0)
    dist = torch.where(is_inside, inside, outside)

    on_axis = rho <= 1e-12
    safe_rho = torch.where(on_axis, torch.ones_like(rho), rho)
    x_dir = torch.zeros_like(dxy)
    x_dir[..., 0] = 1.0
    u = torch.where(on_axis[..., None], x_dir, dxy / safe_rho[..., None])
    wall_closer = d_rad >= d_ax
    ext_xy = center[..., :2] + u * torch.clamp(rho, max=radius)[..., None]
    ext_z = center[..., 2] + torch.clamp(dz, -half_height, half_height)
    int_xy = torch.where(wall_closer[..., None], center[..., :2] + u * radius,
                         p[..., :2])
    half = torch.full_like(dz, half_height)
    cap_z = center[..., 2] + torch.where(dz >= 0.0, half, -half)
    int_z = torch.where(wall_closer, p[..., 2], cap_z)
    cp_xy = torch.where(is_inside[..., None], int_xy, ext_xy)
    cp_z = torch.where(is_inside, int_z, ext_z)
    closest = torch.cat([cp_xy, cp_z[..., None]], dim=-1)
    return dist, closest


def segment_cylinder_distance(a, b, center, radius, half_height):
    """Distance between segment ``[a, b]`` and a z-aligned cylinder
    (``a``, ``b``, ``center`` broadcast over leading axes): a
    ``_GRID_PTS``-point bracket of the convex map ``t -> dist(x(t))`` then
    ``_REFINE_ITERS`` golden-section steps. Returns ``(dist,
    point_on_segment, point_on_cylinder)``."""
    ab = b - a

    def dist_at(t, a_, ab_, c_):
        p = a_ + t[..., None] * ab_
        return point_cylinder_distance(p, c_, radius, half_height)[0]

    # Grid evaluation: (..., G), every tree and grid point in one op.
    ts = torch.arange(_GRID_PTS, dtype=a.dtype, device=a.device) / (
        _GRID_PTS - 1
    )
    grid_d = dist_at(ts, a[..., None, :], ab[..., None, :],
                     center[..., None, :])
    i_min = torch.argmin(grid_d, dim=-1)
    cell = 1.0 / (_GRID_PTS - 1)
    i_f = i_min.to(a.dtype)
    t_lo = torch.clamp(i_f * cell - cell, 0.0, 1.0)
    t_hi = torch.clamp(i_f * cell + cell, 0.0, 1.0)
    for _ in range(_REFINE_ITERS):
        m1 = t_hi - _INV_PHI * (t_hi - t_lo)
        m2 = t_lo + _INV_PHI * (t_hi - t_lo)
        f1, f2 = dist_at(m1, a, ab, center), dist_at(m2, a, ab, center)
        smaller1 = f1 < f2
        t_lo, t_hi = (torch.where(smaller1, t_lo, m1),
                      torch.where(smaller1, m2, t_hi))
    t = 0.5 * (t_lo + t_hi)
    p = a + t[..., None] * ab
    dist, closest = point_cylinder_distance(p, center, radius, half_height)
    return dist, p, closest


@dataclass(frozen=True)
class DistanceData:
    """Fixed-shape sweep result over every tree slot (``(..., N)``)."""

    dists: torch.Tensor  # (..., N) capsule-to-tree distance; +inf masked.
    pts_sys: torch.Tensor  # (..., N, 3) witness on the capsule surface.
    pts_env: torch.Tensor  # (..., N, 3) witness on the tree.
    normal_out: torch.Tensor  # (..., N, 3) outward unit normal.
    mask: torch.Tensor  # (..., N) valid & within vision radius.
    collision: torch.Tensor  # (...) any dist < 1e-4.
    min_dist: torch.Tensor  # (...) min over mask (vision_radius if none).


def capsule_distance_data(centers, valid, bark_radius, bark_height, cap_a,
                          cap_b, cap_radius, vision_radius,
                          vision_mask=None) -> DistanceData:
    """Sweep from the capsule ``[cap_a, cap_b] (..., 3)`` of radius
    ``cap_radius`` to the trees at ``centers (N, 3)``."""
    dist_axis, p_seg, p_cyl = segment_cylinder_distance(
        cap_a[..., None, :], cap_b[..., None, :], centers,
        bark_radius, bark_height / 2.0,
    )
    dists = dist_axis - cap_radius
    normal = p_cyl - p_seg
    nn = _norm(normal, keepdim=True)
    valid_n = nn[..., 0] > 1e-12
    normal = normal / torch.where(nn > 1e-12, nn, torch.ones_like(nn))
    pts_sys = p_seg + cap_radius * normal
    # Outward normal kept through penetration, with the radial (wall) or
    # signed vertical (cap) fallback where the witnesses coincide.
    radial = p_seg[..., :2] - centers[..., :2]
    rn = _norm(radial, keepdim=True)
    dz_seg = p_seg[..., 2] - centers[..., 2]
    on_wall = (torch.abs(dz_seg)[..., None] < bark_height / 2.0) & (rn > 1e-12)
    radial_dir = torch.cat(
        [radial / torch.where(rn > 1e-12, rn, torch.ones_like(rn)),
         torch.zeros_like(rn)], dim=-1,
    )
    ones = torch.ones_like(dz_seg)
    vertical_dir = torch.cat(
        [torch.zeros_like(radial),
         torch.where(dz_seg >= 0, ones, -ones)[..., None]], dim=-1,
    )
    ones_a = torch.ones_like(dist_axis)
    normal_out = torch.where(
        valid_n[..., None],
        torch.where(dist_axis >= 0, -ones_a, ones_a)[..., None] * normal,
        torch.where(on_wall, radial_dir, vertical_dir),
    )
    # Vision gating on the distance from the capsule midpoint to the center.
    cap_mid = 0.5 * (cap_a + cap_b)
    in_range = (_norm(centers - cap_mid[..., None, :])
                <= vision_radius + bark_radius)
    mask = valid & in_range
    if vision_mask is not None:
        mask = mask & vision_mask
    inf = torch.full_like(dists, float("inf"))
    dists = torch.where(mask, dists, inf)
    collision = torch.any(mask & (dists < 1e-4), dim=-1)
    min_dist = torch.amin(
        torch.where(mask, dists, torch.full_like(dists, vision_radius)), dim=-1
    )
    return DistanceData(
        dists=dists, pts_sys=pts_sys, pts_env=p_cyl, normal_out=normal_out,
        mask=mask, collision=collision, min_dist=min_dist,
    )


def capsule_forest_distance(forest: Forest, cap_a, cap_b, cap_radius,
                            vision_radius, vision_mask=None) -> DistanceData:
    """The dense O(max_trees) sweep of every tree slot."""
    with phases.scope(phases.ENV_QUERY):
        return capsule_distance_data(
            forest.tree_pos, forest.tree_valid, forest.bark_radius,
            forest.bark_height, cap_a, cap_b, cap_radius, vision_radius,
            vision_mask,
        )


def cone_mask_at(centers, camera_pos, direction, half_angle):
    """2-D vision-cone mask of the trees at ``centers (N, 3)`` seen from
    ``camera_pos (..., 2)`` along ``direction (..., 2)``; trees at zero
    range are kept. ``cos(half_angle)`` is taken in float32."""
    d = centers[..., :2] - camera_pos[..., None, :2]
    norm = _norm(d)
    safe = torch.where(norm > 0, norm, torch.ones_like(norm))
    cosang = _dot(d / safe[..., None], direction[..., None, :2])
    # A host tensor: the float32 rounding of the JAX package, no card read.
    cos_half = float(  # torchlint: disable=TL001
        torch.cos(torch.tensor(half_angle, dtype=torch.float32)))
    return (norm == 0.0) | (cosang >= cos_half)


def vision_cone_mask(forest: Forest, camera_pos, direction, half_angle):
    """Per-agent 2-D vision-cone mask ``(..., max_trees)`` of every tree
    slot (:func:`cone_mask_at` over the whole forest)."""
    return cone_mask_at(forest.tree_pos, camera_pos, direction, half_angle)


def braking_capsule(xl, vl, collision_radius, max_deceleration):
    """Braking capsule: axis from the payload along the velocity with the
    stopping distance ``||v||^2 / (2 a_max)`` as its length."""
    speed = _norm(vl)
    height = 0.5 * (speed * speed) / max_deceleration
    direction = vl / torch.where(speed > 0, speed, torch.ones_like(speed))[
        ..., None]
    cap_a = xl
    cap_b = xl + torch.where(speed > 0, height, torch.zeros_like(height))[
        ..., None] * direction
    return cap_a, cap_b, height, speed, direction


def collision_cbf_rows(forest: Forest | None, xl, vl, collision_radius,
                       max_deceleration, vision_radius, dist_eps,
                       alpha_env_cbf, n_rows: int, vision_mask=None,
                       env_query: str = "dense") -> EnvCBF:
    """Backup-CBF rows for the nearest ``n_rows`` trees. ``env_query``
    ("auto" | "dense" | "bucketed", ``spatial.runtime_env_query``) picks the
    sweep: every tree slot, or the forest grid's candidate slab of each
    capsule (rows bitwise equal to the dense sweep's)."""
    from tpu_aerial_transport_torch.envs import spatial

    dtype = xl.dtype
    if forest is None:
        batch = xl.shape[:-1]
        return EnvCBF(
            lhs=torch.zeros(batch + (n_rows, 3), dtype=dtype,
                            device=xl.device),
            rhs=torch.full(batch + (n_rows,),
                           -alpha_env_cbf * (vision_radius - dist_eps),
                           dtype=dtype, device=xl.device),
            collision=torch.zeros(batch, dtype=torch.bool, device=xl.device),
            min_dist=torch.full(batch, vision_radius, dtype=dtype,
                                device=xl.device),
        )
    mode = spatial.runtime_env_query(env_query, forest)
    cap_a, cap_b, cap_h, speed, cap_dir = braking_capsule(
        xl, vl, collision_radius, max_deceleration
    )
    if mode == "bucketed":
        data = spatial.bucketed_distance(
            forest, cap_a, cap_b, collision_radius, vision_radius,
            vision_mask=vision_mask, n_rows=n_rows,
        )[0]
    else:
        data = capsule_forest_distance(
            forest, cap_a, cap_b, collision_radius, vision_radius,
            vision_mask
        )
    return cbf_rows_from_distance(
        data, xl, vl, cap_h, speed, cap_dir, max_deceleration,
        vision_radius, dist_eps, alpha_env_cbf, n_rows,
    )


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x (..., N, 3)`` gathered at ``idx (..., k)`` along the tree axis
    (``x``'s leading axes broadcast against ``idx``'s)."""
    full = idx.shape[:-1] + x.shape[-2:]
    ix = idx[..., None].expand(idx.shape + x.shape[-1:])
    return torch.gather(x.expand(full), -2, ix)


def cbf_rows_from_distance(data: DistanceData, xl, vl, cap_h, speed, cap_dir,
                           max_deceleration, vision_radius, dist_eps,
                           alpha_env_cbf, n_rows: int,
                           extra_mask=None) -> EnvCBF:
    """Row construction from a precomputed sweep. ``extra_mask (..., N)`` may
    carry more leading axes than ``data`` (one mask per agent over one sweep
    per scenario); ``data``, ``xl``, ``vl``, ``cap_h``, ``speed`` and
    ``cap_dir`` broadcast against it.

    The nearest-``n_rows`` selection is a stable ascending sort of the
    masked distances: ties resolve toward the smaller tree index, as
    ``lax.top_k`` does in the JAX package."""
    dtype = xl.dtype
    inactive_rhs = -alpha_env_cbf * (vision_radius - dist_eps)
    mask = data.mask if extra_mask is None else (data.mask & extra_mask)
    dists = torch.where(mask, data.dists, float("inf"))
    collision = torch.any(mask & (dists < 1e-4), dim=-1)
    min_dist = torch.amin(
        torch.where(mask, dists, torch.full_like(dists, vision_radius)), dim=-1
    )

    order = torch.sort(dists, dim=-1, stable=True).indices
    idx = order[..., :n_rows]
    sel_mask = torch.gather(mask, -1, idx)
    d = torch.gather(dists, -1, idx)
    p1 = _take(data.pts_sys, idx)

    proj = _dot(p1 - xl[..., None, :], cap_dir[..., None, :])
    proj = torch.minimum(torch.clamp(proj, min=0.0), cap_h[..., None])
    brake = torch.sqrt(torch.clamp(
        2.0 * (cap_h[..., None] - proj) / max_deceleration, min=0.0
    ))
    min_time = torch.clamp(speed[..., None] / max_deceleration - brake,
                           min=0.0)
    normal = _take(data.normal_out, idx)
    n_valid = _dot(normal, normal) > 0.5

    # Near-contact hardening: inside dist_eps the braking time is floored
    # at NEAR_BRAKE_TIME, and near rows stay active at rest.
    near = d < dist_eps
    min_time = torch.where(near, torch.clamp(min_time, min=NEAR_BRAKE_TIME),
                           min_time)
    row_ok = (sel_mask & torch.isfinite(d) & n_valid
              & (near | (speed[..., None] > 0)))
    rhs_raw = (
        -alpha_env_cbf * (d - dist_eps)
        - _dot(normal, vl[..., None, :])
    )
    # Rows are divided by min_time (> 0): the same halfspace at unit scale.
    has_time = min_time > 1e-6
    lhs = torch.where((row_ok & has_time)[..., None], normal,
                      torch.zeros_like(normal))
    rhs = torch.where(
        row_ok,
        torch.where(has_time, rhs_raw / torch.clamp(min_time, min=1e-6),
                    rhs_raw),
        torch.full_like(rhs_raw, inactive_rhs),
    )
    return EnvCBF(
        lhs=lhs.to(dtype), rhs=rhs.to(dtype), collision=collision,
        min_dist=torch.clamp(min_dist, max=vision_radius).to(dtype),
    )
