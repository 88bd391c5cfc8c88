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
from tpu_aerial_transport_torch.control import (
    cadmm,
    centralized,
    dd,
    rp_cadmm,
)
from tpu_aerial_transport_torch.envs import forest as forest_mod
from tpu_aerial_transport_torch.envs import spatial as spatial_mod
from tpu_aerial_transport_torch.models import pmrl, rp, rqp
from tpu_aerial_transport_torch.obs import telemetry as telemetry_mod
from tpu_aerial_transport_torch.ops import socp
from tpu_aerial_transport_torch.resilience import faults as faults_mod


def _get(src, name):
    return src[name] if isinstance(src, Mapping) else getattr(src, name)


def _tensor(a, dev) -> torch.Tensor:
    a = np.array(a)  # a writable copy.
    if a.dtype == np.bool_:
        return torch.as_tensor(a, device=dev)
    if np.issubdtype(a.dtype, np.integer):
        return torch.as_tensor(a.astype(np.int64), device=dev)
    return torch.as_tensor(a.astype(np.float32), device=dev)


def _static(src, name, default):
    if isinstance(src, Mapping):
        return src.get(name, default)
    return getattr(src, name, default)


def _optional(src, name, dev):
    """A leaf the source may lack or hold as None (the fault path's
    ``held`` snapshots)."""
    v = _static(src, name, None)
    return None if v is None else _tensor(v, dev)


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


def rp_params(src, device="cuda") -> rp.RPParams:
    """The RP parameters, ``Jl_inv`` as the source holds it."""
    return rp.RPParams(**_fields(rp.RPParams, src, resolve_device(device)))


def rp_state(src, device="cuda") -> rp.RPState:
    return rp.RPState(**_fields(rp.RPState, src, resolve_device(device),
                                ints=("step",)))


def pmrl_params(src, device="cuda") -> pmrl.PMRLParams:
    """The PMRL parameters, ``Jl_inv`` and ``Jl_inv_factor`` as the source
    holds them."""
    return pmrl.PMRLParams(**_fields(pmrl.PMRLParams, src,
                                     resolve_device(device)))


def pmrl_state(src, device="cuda") -> pmrl.PMRLState:
    return pmrl.PMRLState(**_fields(pmrl.PMRLState, src,
                                    resolve_device(device), ints=("step",)))


def socp_solution(src, device="cuda") -> socp.SOCPSolution:
    return socp.SOCPSolution(**_fields(socp.SOCPSolution, src,
                                       resolve_device(device)))


def cadmm_state(src, device="cuda") -> cadmm.CADMMState:
    """``f``, ``lam``, ``f_mean``, the ``warm`` solution and the ``held``
    snapshot (None where the source has none), in whichever layout the
    source has: ``(n, nv_p)``/``(n, m_p)`` warm starts of the
    Schur-reduced or of the full agent QP alike. An agent-sharded step
    takes and returns the same global state."""
    dev = resolve_device(device)
    return cadmm.CADMMState(
        f=_tensor(_get(src, "f"), dev), lam=_tensor(_get(src, "lam"), dev),
        f_mean=_tensor(_get(src, "f_mean"), dev),
        warm=socp_solution(_get(src, "warm"), dev),
        held=_optional(src, "held", dev),
    )


def dd_state(src, device="cuda") -> dd.DDState:
    """``f``, ``F``, ``M``, ``lam_F``, ``lam_M``, the ``warm`` solution and
    the ``held_*`` snapshots (None where the source has none). An
    agent-sharded step takes and returns the same global state."""
    dev = resolve_device(device)
    return dd.DDState(
        **{k: _tensor(_get(src, k), dev)
           for k in ("f", "F", "M", "lam_F", "lam_M")},
        warm=socp_solution(_get(src, "warm"), dev),
        **{k: _optional(src, k, dev)
           for k in ("held_f", "held_lam_F", "held_lam_M")},
    )


def ctrl_state(src, device="cuda") -> centralized.CtrlState:
    """The centralized controller's ``prev_f`` and ``warm`` solution."""
    dev = resolve_device(device)
    return centralized.CtrlState(
        prev_f=_tensor(_get(src, "prev_f"), dev),
        warm=socp_solution(_get(src, "warm"), dev),
    )


def rp_ctrl_state(src, device="cuda") -> centralized.CtrlState:
    """The RP centralized controller's ``prev_f`` and ``warm`` solution
    (the RQP controller's state type)."""
    return ctrl_state(src, device)


def pmrl_ctrl_state(src, device="cuda") -> centralized.CtrlState:
    """The PMRL centralized controller's ``prev_f`` and ``warm`` solution
    (the RQP controller's state type)."""
    return ctrl_state(src, device)


def rp_cadmm_state(src, device="cuda") -> rp_cadmm.RPCADMMState:
    """The RP C-ADMM copies ``f``, duals ``lam`` and the ``warm``
    solutions, one scenario's or with a leading scenario axis."""
    dev = resolve_device(device)
    return rp_cadmm.RPCADMMState(
        f=_tensor(_get(src, "f"), dev), lam=_tensor(_get(src, "lam"), dev),
        warm=socp_solution(_get(src, "warm"), dev))


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


def fault_schedule(src, device="cuda") -> faults_mod.FaultSchedule:
    """A fault schedule, one for every scenario or stacked one per scenario
    (leading axis): the step and scale leaves, the key's two uint32 words
    (as ``jax.random.PRNGKey`` holds them) as int64, and the static
    ``active``/``noisy`` flags (True where the source has none)."""
    dev = resolve_device(device)
    leaves = {k: _tensor(_get(src, k), dev) for k in (
        "t_fail", "t_degrade", "thrust_scale", "drop_rate", "drop_hold",
        "noise_std", "key")}
    for k in ("t_fail", "t_degrade", "drop_hold"):
        leaves[k] = leaves[k].to(torch.int32)
    return faults_mod.FaultSchedule(
        **leaves, active=bool(_static(src, "active", True)),
        noisy=bool(_static(src, "noisy", True)))


def fault_step(src, device="cuda") -> faults_mod.FaultStep:
    """One step's evaluated health (``alive``, ``thrust_scale``,
    ``msg_ok``), in the source's layout."""
    return faults_mod.FaultStep(**_fields(faults_mod.FaultStep, src,
                                          resolve_device(device)))


def telemetry_state(src, device="cuda") -> telemetry_mod.TelemetryState:
    """A run-health accumulator (one run's, or batched with a leading
    scenario axis): the counts as int32, the rest float32, and the static
    ``quantiles``/``n_agents``."""
    dev = resolve_device(device)
    return telemetry_mod.TelemetryState(
        **{k: (_tensor(_get(src, k), dev).to(torch.int32)
               if k in telemetry_mod.INT_FIELDS
               else _tensor(_get(src, k), dev))
           for k in telemetry_mod.LEAF_FIELDS},
        quantiles=tuple(float(q) for q in _get(src, "quantiles")),
        n_agents=int(_get(src, "n_agents")),
    )


def gains(src, device="cuda") -> dict:
    """A dict of arrays or scalars (``harness.diff``'s gains, a system
    identification's ``theta``, a trajectory plan) as a dict of float32
    tensors of the same shapes (0-d for scalars) on ``device``."""
    dev = resolve_device(device)
    return {k: torch.as_tensor(np.array(v, np.float32), device=dev)
            for k, v in src.items()}
