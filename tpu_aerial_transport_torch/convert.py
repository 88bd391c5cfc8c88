"""Carry state across from the JAX package without importing it.

Every function takes plain numpy leaves -- a mapping of field name to array,
or any object with those attributes (e.g. the JAX package's pytrees after
``jax.tree.map(np.asarray, tree)``) -- and builds the port's counterpart on
``device``. Floating leaves become float32 (the JAX package runs with x64
off), index leaves int64, flags bool.
"""

from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch

from tpu_aerial_transport_torch import resolve_device
from tpu_aerial_transport_torch.control import cadmm, centralized, dd
from tpu_aerial_transport_torch.envs import forest as forest_mod
from tpu_aerial_transport_torch.envs import spatial as spatial_mod
from tpu_aerial_transport_torch.models import rqp
from tpu_aerial_transport_torch.ops import socp


def _get(src, name):
    return src[name] if isinstance(src, Mapping) else getattr(src, name)


def _tensor(a, dev) -> torch.Tensor:
    a = np.array(a)  # a writable copy.
    if a.dtype == np.bool_:
        return torch.as_tensor(a, device=dev)
    if np.issubdtype(a.dtype, np.integer):
        return torch.as_tensor(a.astype(np.int64), device=dev)
    return torch.as_tensor(a.astype(np.float32), device=dev)


def _fields(cls, src, dev, ints=()):
    out = {}
    for name in cls._fields if hasattr(cls, "_fields") else \
            cls.__dataclass_fields__:
        t = _tensor(_get(src, name), dev)
        out[name] = t.to(torch.int32) if name in ints else t
    return out


def rqp_params(src, device="cuda") -> rqp.RQPParams:
    return rqp.RQPParams(**_fields(rqp.RQPParams, src, resolve_device(device)))


def rqp_state(src, device="cuda") -> rqp.RQPState:
    return rqp.RQPState(**_fields(rqp.RQPState, src, resolve_device(device),
                                  ints=("step",)))


def socp_solution(src, device="cuda") -> socp.SOCPSolution:
    return socp.SOCPSolution(**_fields(socp.SOCPSolution, src,
                                       resolve_device(device)))


def cadmm_state(src, device="cuda") -> cadmm.CADMMState:
    """``f``, ``lam``, ``f_mean`` and the ``warm`` solution, in whichever
    layout the source has: ``(n, nv_p)``/``(n, m_p)`` warm starts of the
    Schur-reduced or of the full agent QP alike (the JAX package's ``held``
    snapshot belongs to the unported fault path). An agent-sharded step
    takes and returns the same global state."""
    dev = resolve_device(device)
    return cadmm.CADMMState(
        f=_tensor(_get(src, "f"), dev), lam=_tensor(_get(src, "lam"), dev),
        f_mean=_tensor(_get(src, "f_mean"), dev),
        warm=socp_solution(_get(src, "warm"), dev),
    )


def dd_state(src, device="cuda") -> dd.DDState:
    """``f``, ``F``, ``M``, ``lam_F``, ``lam_M`` and the ``warm`` solution
    (the JAX package's ``held_*`` snapshots belong to the unported fault
    path). An agent-sharded step takes and returns the same global state."""
    dev = resolve_device(device)
    return dd.DDState(
        **{k: _tensor(_get(src, k), dev)
           for k in ("f", "F", "M", "lam_F", "lam_M")},
        warm=socp_solution(_get(src, "warm"), dev),
    )


def ctrl_state(src, device="cuda") -> centralized.CtrlState:
    """The centralized controller's ``prev_f`` and ``warm`` solution."""
    dev = resolve_device(device)
    return centralized.CtrlState(
        prev_f=_tensor(_get(src, "prev_f"), dev),
        warm=socp_solution(_get(src, "warm"), dev),
    )


def spatial_grid(src, device="cuda") -> spatial_mod.SpatialGrid:
    """A spatial-hash grid: its index slabs (int64 holding the source's
    values), flags, ``origin`` and ``inv_cell``, and the static shape
    fields as Python numbers."""
    dev = resolve_device(device)
    return spatial_mod.SpatialGrid(
        cell_idx=_tensor(_get(src, "cell_idx"), dev),
        cell_valid=_tensor(_get(src, "cell_valid"), dev),
        origin=_tensor(_get(src, "origin"), dev),
        inv_cell=_tensor(_get(src, "inv_cell"), dev),
        nx=int(_get(src, "nx")), ny=int(_get(src, "ny")),
        k=int(_get(src, "k")), query_radius=float(_get(src, "query_radius")),
        cell_size=float(_get(src, "cell_size")),
    )


def forest(src, device="cuda") -> forest_mod.Forest:
    """A forest, with its spatial-hash grid where the source carries one."""
    dev = resolve_device(device)
    kw = {}
    for name in ("bark_radius", "bark_height"):
        if isinstance(src, Mapping) and name not in src:
            continue
        kw[name] = float(_get(src, name))
    grid = (src.get("grid") if isinstance(src, Mapping)
            else getattr(src, "grid", None))
    return forest_mod.Forest(
        tree_pos=_tensor(_get(src, "tree_pos"), dev),
        tree_valid=_tensor(_get(src, "tree_valid"), dev),
        num_trees=_tensor(_get(src, "num_trees"), dev).to(torch.int32),
        mountain_sphere_radius=_tensor(_get(src, "mountain_sphere_radius"),
                                       dev),
        mountain_center_depth=_tensor(_get(src, "mountain_center_depth"),
                                      dev),
        grid=None if grid is None else spatial_grid(grid, dev),
        **kw,
    )


def schur_plan(src, device="cuda") -> cadmm.SchurPlan:
    return cadmm.SchurPlan(**_fields(cadmm.SchurPlan, src,
                                     resolve_device(device)))
