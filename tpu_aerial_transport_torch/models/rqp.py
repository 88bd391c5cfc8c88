"""Rigid-quadrotor-payload (RQP) model on tensors.

Counterpart of ``tpu_aerial_transport/models/rqp.py``. Parameters carry the
agent axis first (``r: (n, 3)``); a state may carry any leading batch axes in
front of that (``R: (..., n, 3, 3)``, ``xl: (..., 3)``, ``step: (...)``), so
one code path serves a single system and a Monte-Carlo batch of scenarios.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from tpu_aerial_transport_torch import resolve_device
from tpu_aerial_transport_torch.ops import lie

GRAVITY = 9.80665  # [m/s^2].

# SO(3) re-projection every PROJECTION_PERIOD integration steps.
PROJECTION_PERIOD = 20

QUADROTOR_RADIUS = 0.3  # [m].
MAX_DECELERATION = GRAVITY / 5.0  # [m/s^2].


@dataclass(frozen=True)
class RQPParams:
    """System parameters; agent axis leads."""

    m: torch.Tensor  # (n,) quadrotor masses.
    J: torch.Tensor  # (n, 3, 3) quadrotor inertias.
    ml: torch.Tensor  # () payload mass.
    Jl: torch.Tensor  # (3, 3) payload inertia.
    r: torch.Tensor  # (n, 3) attachment points (payload frame).
    mT: torch.Tensor  # () total mass.
    x_com: torch.Tensor  # (3,) CoM offset (payload frame).
    r_com: torch.Tensor  # (n, 3) attachments relative to the CoM.
    JT: torch.Tensor  # (3, 3) composite inertia about the CoM.
    JT_inv: torch.Tensor  # (3, 3).
    J_inv: torch.Tensor  # (n, 3, 3).

    @property
    def n(self) -> int:
        return self.r.shape[-2]


def _f32(x, device) -> torch.Tensor:
    """numpy/float64 input -> float32 tensor (JAX runs with x64 off)."""
    return torch.as_tensor(np.asarray(x), dtype=torch.float32, device=device)


def rqp_params(m, J, ml, Jl, r, device="cuda") -> RQPParams:
    """Build :class:`RQPParams` with derived quantities, computed in float32
    from inputs first rounded to float32 (the JAX package's order)."""
    dev = resolve_device(device)
    m, J, ml, Jl, r = (_f32(v, dev) for v in (m, J, ml, Jl, r))
    n = r.shape[0]
    assert m.shape == (n,) and J.shape == (n, 3, 3) and Jl.shape == (3, 3)
    mT = torch.sum(m) + ml
    x_com = torch.sum(r * m[:, None], dim=0) / mT
    r_com = r - x_com
    JT = (
        Jl
        - ml * lie.hat_square(x_com, x_com)
        - torch.sum(m[:, None, None] * lie.hat_square(r_com, r_com), dim=0)
    )
    return RQPParams(
        m=m, J=J, ml=ml, Jl=Jl, r=r, mT=mT, x_com=x_com, r_com=r_com, JT=JT,
        JT_inv=torch.linalg.inv(JT), J_inv=torch.linalg.inv(J),
    )


@dataclass(frozen=True)
class RQPState:
    """System state; ``(..., n)`` agent axis, any leading batch axes."""

    R: torch.Tensor  # (..., n, 3, 3) quadrotor rotations.
    w: torch.Tensor  # (..., n, 3) quadrotor body angular velocities.
    xl: torch.Tensor  # (..., 3) payload position.
    vl: torch.Tensor  # (..., 3) payload velocity.
    Rl: torch.Tensor  # (..., 3, 3) payload rotation.
    wl: torch.Tensor  # (..., 3) payload body angular velocity.
    step: torch.Tensor  # (...) int32 counter for periodic re-projection.

    @property
    def n(self) -> int:
        return self.w.shape[-2]

    def replace(self, **kw) -> "RQPState":
        return dataclasses.replace(self, **kw)


def rqp_state(R, w, xl, vl, Rl, wl, device="cuda") -> RQPState:
    """Build a single state, projecting rotations with the SVD polar factor."""
    dev = resolve_device(device)
    return RQPState(
        R=lie.polar_project_svd(_f32(R, dev)), w=_f32(w, dev),
        xl=_f32(xl, dev), vl=_f32(vl, dev),
        Rl=lie.polar_project_svd(_f32(Rl, dev)), wl=_f32(wl, dev),
        step=torch.zeros((), dtype=torch.int32, device=dev),
    )


def rqp_identity_state(n: int, device="cuda") -> RQPState:
    """Identity attitudes, zero velocities at the origin."""
    dev = resolve_device(device)
    f32 = dict(dtype=torch.float32, device=dev)
    return RQPState(
        R=torch.eye(3, **f32).expand(n, 3, 3).clone(),
        w=torch.zeros((n, 3), **f32),
        xl=torch.zeros(3, **f32), vl=torch.zeros(3, **f32),
        Rl=torch.eye(3, **f32), wl=torch.zeros(3, **f32),
        step=torch.zeros((), dtype=torch.int32, device=dev),
    )


def _mv(M: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Batched matrix-vector product ``M (..., r, c) @ v (..., c)``."""
    return (M @ v[..., None])[..., 0]


def forward_dynamics(params: RQPParams, state: RQPState, wrench):
    """Accelerations ``(dw (..., n, 3), dvl (..., 3), dwl (..., 3))`` from
    ``wrench = (f (..., n), M (..., n, 3))``."""
    f, M = wrench
    # (0, 0, -g) from a fill and a pad: no host-to-device copy, which a
    # CUDA-graph capture of the substeps would refuse.
    gravity = torch.nn.functional.pad(
        torch.full((1,), -GRAVITY, dtype=state.xl.dtype,
                   device=state.xl.device), (2, 0))
    Jw = _mv(params.J, state.w)
    dw = _mv(params.J_inv, M - lie.cross(state.w, Jw))

    quad_force = state.R[..., :, 2] * f[..., None]  # (..., n, 3) world frame.
    dv_com = torch.sum(quad_force, dim=-2) / params.mT + gravity

    force_body = quad_force @ state.Rl  # rows = Rl^T F_i.
    net_moment = torch.sum(lie.cross(params.r_com, force_body), dim=-2)
    JTwl = _mv(params.JT, state.wl)
    dwl = _mv(params.JT_inv, net_moment - lie.cross(state.wl, JTwl))

    corr = _mv(lie.hat_square(state.wl, state.wl) + lie.hat(dwl), params.x_com)
    dvl = dv_com - _mv(state.Rl, corr)
    return dw, dvl, dwl


def integrate_state(state: RQPState, acc, dt,
                    project_every: int = PROJECTION_PERIOD) -> RQPState:
    """Semi-implicit trapezoidal manifold step with the Newton-Schulz
    re-projection selected every ``project_every`` steps (computed for every
    lane, kept where the lane's counter says so)."""
    dw, dvl, dwl = acc
    R = state.R @ lie.expm_so3((state.w + dw * (dt / 2)) * dt)
    w = state.w + dw * dt
    xl = state.xl + state.vl * dt + dvl * (dt**2 / 2)
    vl = state.vl + dvl * dt
    Rl = state.Rl @ lie.expm_so3((state.wl + dwl * (dt / 2)) * dt)
    wl = state.wl + dwl * dt

    step = state.step + 1
    project = step >= project_every
    R = torch.where(project[..., None, None, None], lie.polar_project(R), R)
    Rl = torch.where(project[..., None, None], lie.polar_project(Rl), Rl)
    step = torch.where(project, torch.zeros_like(step), step)
    return RQPState(R=R, w=w, xl=xl, vl=vl, Rl=Rl, wl=wl, step=step)


def integrate(params: RQPParams, state: RQPState, wrench, dt,
              project_every: int = PROJECTION_PERIOD) -> RQPState:
    """Forward dynamics + one integration step."""
    return integrate_state(
        state, forward_dynamics(params, state, wrench), dt, project_every
    )


class RQPCollision:
    """Host-side collision metadata: bounding-sphere collision radius and the
    max braking deceleration the collision CBFs use."""

    def __init__(self, payload_vertices, payload_mesh_vertices):
        payload_vertices = np.asarray(payload_vertices, np.float64)
        payload_mesh_vertices = np.asarray(payload_mesh_vertices, np.float64)
        assert payload_vertices.shape[1] == 3
        self.payload_vertices = payload_vertices
        self.payload_mesh_vertices = payload_mesh_vertices
        self.quadrotor_radius = QUADROTOR_RADIUS
        self.collision_radius = float(
            np.max(np.linalg.norm(payload_mesh_vertices, axis=1))
            + QUADROTOR_RADIUS
            + 0.1
        )
        self.max_deceleration = MAX_DECELERATION
