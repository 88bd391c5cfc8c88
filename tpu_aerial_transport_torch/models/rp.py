"""Rigid-payload (RP) model on tensors.

Counterpart of ``tpu_aerial_transport/models/rp.py``: one rigid payload
carried by ``n >= 3`` point-force actuators attached at body-frame points
``r_i`` (no actuator dynamics):

    ml dvl = sum_i f_i - ml g e3,
    Jl dwl + wl x Jl wl = sum_i r_i x Rl^T f_i.

Parameters carry the agent axis first (``r: (n, 3)``); a state may carry any
leading batch axes (``Rl: (..., 3, 3)``, ``step: (...)``) and the forces
``f`` are ``(..., n, 3)``, so one code path serves a single system and a
Monte-Carlo batch of scenarios.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from tpu_aerial_transport_torch import resolve_device
from tpu_aerial_transport_torch.models.rqp import _f32, _mv
from tpu_aerial_transport_torch.ops import lie

GRAVITY = 9.80665  # [m/s^2].
PROJECTION_PERIOD = 20  # SO(3) re-projection every this many steps.


@dataclass(frozen=True)
class RPParams:
    """System parameters; agent axis leads."""

    ml: torch.Tensor  # () payload mass.
    Jl: torch.Tensor  # (3, 3) payload inertia.
    r: torch.Tensor  # (n, 3) actuator attachment points (body frame).
    Jl_inv: torch.Tensor  # (3, 3).

    @property
    def n(self) -> int:
        return self.r.shape[-2]


def rp_params(ml, Jl, r, device="cuda") -> RPParams:
    """Build :class:`RPParams` from inputs rounded to float32, the inverse
    taken in float32 (the JAX package's order)."""
    dev = resolve_device(device)
    ml, Jl, r = (_f32(v, dev) for v in (ml, Jl, r))
    assert Jl.shape == (3, 3) and r.dim() == 2 and r.shape[-1] == 3
    return RPParams(ml=ml, Jl=Jl, r=r, Jl_inv=torch.linalg.inv(Jl))


@dataclass(frozen=True)
class RPState:
    """System state; any leading batch axes."""

    xl: torch.Tensor  # (..., 3) payload position.
    vl: torch.Tensor  # (..., 3) payload velocity.
    Rl: torch.Tensor  # (..., 3, 3) payload rotation.
    wl: torch.Tensor  # (..., 3) body angular velocity.
    step: torch.Tensor  # (...) int32 projection counter.

    def replace(self, **kw) -> "RPState":
        return dataclasses.replace(self, **kw)


def rp_state(xl, vl, Rl, wl, device="cuda") -> RPState:
    """Build a single state, projecting the rotation with the SVD polar
    factor."""
    dev = resolve_device(device)
    return RPState(
        xl=_f32(xl, dev), vl=_f32(vl, dev),
        Rl=lie.polar_project_svd(_f32(Rl, dev)), wl=_f32(wl, dev),
        step=torch.zeros((), dtype=torch.int32, device=dev),
    )


def rp_identity_state(device="cuda") -> RPState:
    """Identity attitude, zero velocities at the origin."""
    dev = resolve_device(device)
    z3 = torch.zeros(3, dtype=torch.float32, device=dev)
    return RPState(xl=z3, vl=z3.clone(),
                   Rl=torch.eye(3, dtype=torch.float32, device=dev),
                   wl=z3.clone(),
                   step=torch.zeros((), dtype=torch.int32, device=dev))


def gravity_vector(like: torch.Tensor) -> torch.Tensor:
    """(0, 0, -g) from a fill and a pad: no host-to-device copy, which a
    CUDA-graph capture of the substeps would refuse."""
    return torch.nn.functional.pad(
        torch.full((1,), -GRAVITY, dtype=like.dtype, device=like.device),
        (2, 0))


def _net_moment(params: RPParams, state: RPState, f: torch.Tensor):
    """``sum_i r_i x Rl^T f_i`` ``(..., 3)``."""
    f_body = f @ state.Rl  # rows = Rl^T f_i.
    return torch.sum(lie.cross(params.r, f_body), dim=-2)


def forward_dynamics(params: RPParams, state: RPState, f: torch.Tensor):
    """World-frame actuator forces ``f (..., n, 3)`` -> ``(dvl, dwl)``."""
    dvl = torch.sum(f, dim=-2) / params.ml + gravity_vector(state.xl)
    Jlwl = _mv(params.Jl, state.wl)
    dwl = _mv(params.Jl_inv, _net_moment(params, state, f)
              - lie.cross(state.wl, Jlwl))
    return dvl, dwl


def integrate_state(state: RPState, acc, dt,
                    project_every: int = PROJECTION_PERIOD) -> RPState:
    """Semi-implicit trapezoidal manifold step with the Newton-Schulz
    re-projection selected every ``project_every`` steps."""
    dvl, dwl = acc
    xl = state.xl + state.vl * dt + dvl * (dt**2 / 2)
    vl = state.vl + dvl * dt
    Rl = state.Rl @ lie.expm_so3((state.wl + dwl * (dt / 2)) * dt)
    wl = state.wl + dwl * dt
    step = state.step + 1
    project = step >= project_every
    Rl = torch.where(project[..., None, None], lie.polar_project(Rl), Rl)
    step = torch.where(project, torch.zeros_like(step), step)
    return RPState(xl=xl, vl=vl, Rl=Rl, wl=wl, step=step)


def integrate(params: RPParams, state: RPState, f, dt,
              project_every: int = PROJECTION_PERIOD) -> RPState:
    """Forward dynamics + one integration step."""
    return integrate_state(state, forward_dynamics(params, state, f), dt,
                           project_every)


def inverse_dynamics_error(state: RPState, params: RPParams, f,
                           acc) -> torch.Tensor:
    """Newton-Euler residual norm ``(...)`` for forces ``f`` and ``acc =
    (dvl, dwl)`` (the test oracle of :func:`forward_dynamics`)."""
    dvl, dwl = acc
    lin_res = (params.ml * dvl - torch.sum(f, dim=-2)
               - params.ml * gravity_vector(state.xl))
    Jlwl = _mv(params.Jl, state.wl)
    ang_res = (_mv(params.Jl, dwl) + lie.cross(state.wl, Jlwl)
               - _net_moment(params, state, f))
    return torch.sqrt(torch.sum(lin_res**2, dim=-1)
                      + torch.sum(ang_res**2, dim=-1))


class RPCollision:
    """Host-side collision metadata: the payload's hull and collision-mesh
    vertices and a bounding collision radius."""

    def __init__(self, payload_vertices, payload_mesh_vertices):
        self.payload_vertices = np.asarray(payload_vertices, np.float64)
        self.payload_mesh_vertices = np.asarray(payload_mesh_vertices,
                                                np.float64)
        self.collision_radius = float(
            np.max(np.linalg.norm(self.payload_mesh_vertices, axis=1)) + 0.1
        )
