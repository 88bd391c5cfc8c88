"""Spatial-hash bucketed environment queries: city-scale obstacle worlds.

Counterpart of ``tpu_aerial_transport/envs/spatial.py``. The dense query
(``envs/forest.py capsule_forest_distance``) sweeps every tree slot for every
capsule; this module buckets the world instead:

- **Build** (:func:`build_grid`, host numpy in float64): a uniform 2-D grid
  over the trees' XY (the trees are vertical cylinders, so 2-D hashing is
  exact) with cells of ``query_radius * (1 + CELL_MARGIN)``, so one cell's
  3x3 neighbourhood covers every tree within range of any query point in
  it. Each cell stores its neighbourhood's tree indices, ascending, padded
  to a slab width ``K``; a slab too narrow for the densest neighbourhood is
  a :class:`GridOverflowError`, never a truncation.
- **Query** (:func:`bucketed_distance`): the cell of each capsule midpoint,
  one gather of its slab a scenario, then the dense sweep's per-tree math
  (``forest.capsule_distance_data``) over the ``K`` candidates only. The
  per-tree values are computed by the same elementwise ops whatever the
  tree count, and the slabs ascend in tree index (the stable sort's tie
  order), so the CBF rows are bitwise equal to the dense sweep's.

Resolution: :func:`resolve_env_query` at config build (``TAT_ENV_QUERY``
forces a tier) and :func:`runtime_env_query` at query time ("auto" picks
by the world's slot count: dense at most ``DENSE_AUTO_MAX_TREES`` slots,
bucketed above; "bucketed" without a grid is a ValueError).

The grid's index slabs are int64 (torch's index type) holding the JAX
package's int32 values; ``origin`` and ``inv_cell`` are float32 tensors on
the forest's device, the static fields Python numbers.
"""

from __future__ import annotations

import dataclasses
import os
from dataclasses import dataclass

import numpy as np
import torch

from tpu_aerial_transport_torch.envs import forest as forest_mod
from tpu_aerial_transport_torch.obs import phases

ENV_QUERY_IMPLS = ("dense", "bucketed")
ENV_QUERY_MODES = ("auto",) + ENV_QUERY_IMPLS

# "auto" stays on the dense sweep up to the paper's world class.
DENSE_AUTO_MAX_TREES = 200

# Cell-size margin over the coverage radius: the build assigns trees to
# cells in float64, the queries find their cell from float32 states.
CELL_MARGIN = 1e-3

# Slab width: rounded up to SLAB_TILE, at least MIN_SLAB (so a top-10
# selection always has candidates).
SLAB_TILE = 8
MIN_SLAB = 16


class GridOverflowError(ValueError):
    """A slab width ``k`` below the densest neighbourhood's ``k_needed``
    candidates: rebuild with ``k >= k_needed`` or ``k=None``."""

    def __init__(self, k: int, k_needed: int):
        self.k = k
        self.k_needed = k_needed
        super().__init__(
            f"spatial grid slab width k={k} cannot hold the densest cell "
            f"neighborhood ({k_needed} candidate trees) — rebuild with "
            f"k>={k_needed} (or k=None to auto-size); refusing to "
            "silently truncate the candidate set, which would drop "
            "obstacles from the collision queries"
        )


@dataclass(frozen=True)
class SpatialGrid:
    """``cell_idx[c]`` holds flat cell c's 3x3-neighbourhood tree indices,
    ascending, padded to ``k`` with ``cell_valid`` false."""

    cell_idx: torch.Tensor  # (nx * ny, k) int64, ascending per cell.
    cell_valid: torch.Tensor  # (nx * ny, k) bool.
    origin: torch.Tensor  # (2,) the grid's lower corner in world XY.
    inv_cell: torch.Tensor  # () 1 / cell_size.
    nx: int = 1
    ny: int = 1
    k: int = MIN_SLAB
    # Every tree within this XY distance of a query point is in its slab.
    query_radius: float = 0.0
    cell_size: float = 1.0


def build_grid(forest: forest_mod.Forest, query_radius: float,
               k: int | None = None) -> SpatialGrid:
    """Host-side grid over ``forest``'s valid trees, in float64 numpy as the
    JAX package builds it (callers pass ``vision_radius + bark_radius``).
    ``k=None`` sizes the slab to the densest neighbourhood (rounded up to
    :data:`SLAB_TILE`, at least :data:`MIN_SLAB`); a smaller explicit
    ``k`` raises :class:`GridOverflowError`."""
    if query_radius <= 0:
        raise ValueError(f"query_radius={query_radius} must be positive")
    pos = forest.tree_pos.detach().cpu().numpy().astype(np.float64)
    valid = forest.tree_valid.detach().cpu().numpy().astype(bool)
    idxs = np.nonzero(valid)[0]
    cell = float(query_radius) * (1.0 + CELL_MARGIN)

    if idxs.size:
        xy = pos[idxs, :2]
        origin = xy.min(axis=0)
        nx = int(np.floor((xy[:, 0].max() - origin[0]) / cell)) + 1
        ny = int(np.floor((xy[:, 1].max() - origin[1]) / cell)) + 1
        ci = np.clip(np.floor((xy[:, 0] - origin[0]) / cell).astype(int),
                     0, nx - 1)
        cj = np.clip(np.floor((xy[:, 1] - origin[1]) / cell).astype(int),
                     0, ny - 1)
    else:
        origin = np.zeros(2)
        nx = ny = 1
        ci = cj = np.zeros(0, int)

    # Each tree registers in the 9 neighbourhoods that can query it; trees
    # in ascending index keep every slab ascending (the tie order of the
    # stable nearest-row selection).
    slabs: list[list[int]] = [[] for _ in range(nx * ny)]
    for t, i, j in zip(idxs.tolist(), ci.tolist(), cj.tolist()):
        for di in (-1, 0, 1):
            ii = i + di
            if not 0 <= ii < nx:
                continue
            for dj in (-1, 0, 1):
                jj = j + dj
                if 0 <= jj < ny:
                    slabs[ii * ny + jj].append(t)

    k_needed = max((len(s) for s in slabs), default=0)
    if k is None:
        k = max(-(-max(k_needed, 1) // SLAB_TILE) * SLAB_TILE, MIN_SLAB)
    elif k < k_needed:
        raise GridOverflowError(k=k, k_needed=k_needed)

    cell_idx = np.zeros((nx * ny, k), np.int32)
    cell_valid = np.zeros((nx * ny, k), bool)
    for c, s in enumerate(slabs):
        cell_idx[c, : len(s)] = s
        cell_valid[c, : len(s)] = True

    dev, dtype = forest.tree_pos.device, forest.tree_pos.dtype
    return SpatialGrid(
        cell_idx=torch.as_tensor(cell_idx.astype(np.int64), device=dev),
        cell_valid=torch.as_tensor(cell_valid, device=dev),
        origin=torch.as_tensor(origin, dtype=dtype, device=dev),
        inv_cell=torch.as_tensor(1.0 / cell, dtype=dtype, device=dev),
        nx=nx, ny=ny, k=int(k), query_radius=float(query_radius),
        cell_size=cell,
    )


def with_grid(forest: forest_mod.Forest, query_radius: float,
              k: int | None = None) -> forest_mod.Forest:
    """``forest`` with a freshly built grid attached (the bucketed tier's
    data; it rides the forest through the controllers and rollouts)."""
    return dataclasses.replace(forest,
                               grid=build_grid(forest, query_radius, k=k))


def grid_stats(grid: SpatialGrid) -> dict:
    """Host-side occupancy record of a built grid."""
    occ = grid.cell_valid.detach().cpu().numpy().sum(axis=1)
    return {
        "n_cells": int(occ.size),
        "k": int(grid.k),
        "cell_size_m": float(grid.cell_size),
        "query_radius_m": float(grid.query_radius),
        "max_occupancy": int(occ.max()) if occ.size else 0,
        "mean_occupancy": float(occ.mean()) if occ.size else 0.0,
        "occupied_cells": int((occ > 0).sum()),
    }


def resolve_env_query(env_query: str | None = "auto") -> str:
    """Config-build-time resolution: ``"auto"`` (or None) reads
    ``TAT_ENV_QUERY`` (``dense`` or ``bucketed`` force that tier; ``auto``
    or unset leaves ``"auto"`` for :func:`runtime_env_query`; anything else
    is a ValueError); explicit values pass through validated."""
    if env_query is None:
        env_query = "auto"
    if env_query == "auto":
        env = os.environ.get("TAT_ENV_QUERY", "").strip().lower()
        if env in ENV_QUERY_IMPLS:
            return env
        if env not in ("", "auto"):
            raise ValueError(
                f"TAT_ENV_QUERY={env!r}: expected one of "
                f"{ENV_QUERY_IMPLS} or 'auto'"
            )
        return "auto"
    if env_query not in ENV_QUERY_MODES:
        raise ValueError(
            f"env_query={env_query!r}: expected one of {ENV_QUERY_MODES}"
        )
    return env_query


def runtime_env_query(env_query: str, forest: forest_mod.Forest) -> str:
    """The tier a query with this mode runs against ``forest``, the one
    decision that dispatches and labels: "auto" is dense at most
    ``DENSE_AUTO_MAX_TREES`` slots and bucketed above; "bucketed" on a
    forest without a grid is a ValueError, never a dense fallback."""
    if env_query not in ENV_QUERY_MODES:
        raise ValueError(
            f"env_query={env_query!r}: expected one of {ENV_QUERY_MODES}"
        )
    if env_query == "auto":
        max_trees = forest.tree_pos.shape[0]
        env_query = "bucketed" if max_trees > DENSE_AUTO_MAX_TREES else "dense"
    if env_query == "bucketed" and forest.grid is None:
        raise ValueError(
            f"env_query resolved to 'bucketed' for a "
            f"{forest.tree_pos.shape[0]}-slot world but the forest "
            "carries no spatial grid — attach one with "
            "envs.spatial.with_grid(forest, vision_radius + bark_radius) "
            "at setup, or force env_query='dense'"
        )
    return env_query


def candidate_slab(forest: forest_mod.Forest, cap_mid: torch.Tensor):
    """``(idx (..., K) int64, valid (..., K) bool)``: the slab of the grid
    cell holding each ``cap_mid (..., 3)``'s XY, clipped into the grid
    (which only moves a query closer to every tree). The cell coordinate
    is clamped in float before the cast (a NaN takes cell 0)."""
    grid: SpatialGrid = forest.grid
    ij = torch.floor((cap_mid[..., :2] - grid.origin) * grid.inv_cell)
    ij = torch.nan_to_num(ij, nan=0.0)
    ci = torch.clamp(ij[..., 0], 0.0, float(grid.nx - 1)).to(torch.int64)
    cj = torch.clamp(ij[..., 1], 0.0, float(grid.ny - 1)).to(torch.int64)
    flat = ci * grid.ny + cj
    return grid.cell_idx[flat], grid.cell_valid[flat]


def bucketed_distance(forest: forest_mod.Forest, cap_a: torch.Tensor,
                      cap_b: torch.Tensor, cap_radius, vision_radius,
                      vision_mask=None, n_rows: int | None = None):
    """The slab of each capsule midpoint and the dense per-tree math over
    it: ``(DistanceData (..., K), centers (..., K, 3), idx (..., K))``.
    ``vision_mask`` is a dense ``(..., max_trees)`` mask, gathered at the
    slab. Refuses a grid that covers less than ``vision_radius +
    bark_radius`` or whose slab is narrower than ``n_rows``."""
    grid: SpatialGrid = forest.grid
    if grid is None:
        raise ValueError(
            "bucketed_distance needs forest.grid — attach one with "
            "envs.spatial.with_grid"
        )
    if isinstance(vision_radius, (int, float)):
        need = float(vision_radius) + float(forest.bark_radius)
        if grid.query_radius < need - 1e-9:
            raise ValueError(
                f"forest.grid covers query_radius="
                f"{grid.query_radius:.3f} m but this query needs "
                f"vision_radius + bark_radius = {need:.3f} m — rebuild "
                "the grid at the larger radius (spatial.with_grid); a "
                "short grid would silently drop in-range obstacles"
            )
    if n_rows is not None and grid.k < n_rows:
        raise ValueError(
            f"grid slab width k={grid.k} < n_rows={n_rows}: rebuild the "
            f"grid with k>={n_rows} so the selection always has enough "
            "candidates"
        )
    with phases.scope(phases.ENV_QUERY):
        cap_mid = 0.5 * (cap_a + cap_b)
        idx, slab_valid = candidate_slab(forest, cap_mid)
        centers = forest.tree_pos[idx]
        valid = slab_valid & forest.tree_valid[idx]
        vm = None
        if vision_mask is not None:
            vm = torch.gather(
                vision_mask.expand(idx.shape[:-1] + vision_mask.shape[-1:]),
                -1, idx)
        data = forest_mod.capsule_distance_data(
            centers, valid, forest.bark_radius, forest.bark_height,
            cap_a, cap_b, cap_radius, vision_radius, vm,
        )
    return data, centers, idx


def env_query_bucketed(forest: forest_mod.Forest, cap_a, cap_b, cap_radius,
                       vision_radius,
                       vision_mask=None) -> forest_mod.DistanceData:
    """The bucketed twin of ``forest.capsule_forest_distance``: the same
    ``DistanceData`` over the ``(..., K)`` slab."""
    return bucketed_distance(forest, cap_a, cap_b, cap_radius, vision_radius,
                             vision_mask=vision_mask)[0]


def env_query_dense(forest: forest_mod.Forest, cap_a, cap_b, cap_radius,
                    vision_radius,
                    vision_mask=None) -> forest_mod.DistanceData:
    """The dense sweep under its entry-point name."""
    return forest_mod.capsule_forest_distance(
        forest, cap_a, cap_b, cap_radius, vision_radius, vision_mask)
