"""Point-mass rigid-link (PMRL) model on tensors.

Counterpart of ``tpu_aerial_transport/models/pmrl.py``: ``n`` point-mass
robots attached to payload body points ``r_i`` through massless rigid links
of length ``L_i``, the link directions ``q_i`` on S^2 extra state. Robot
positions are ``x_i = xl + L_i q_i + Rl r_i``:

    m_i x_i'' = f_i - m_i g e3 - T_i q_i,
    ml dvl    = sum_i T_i q_i - ml g e3,
    Jl dwl + wl x Jl wl = sum_i r_i x (T_i Rl^T q_i),
    q_i . ddq_i = -||dq_i||^2,

with the link tensions ``T`` the solution of an n x n SPD system every
step. That solve is ``torch.linalg.solve_ex`` (LU, as the JAX package's
``jnp.linalg.solve``), batched over every leading axis, with its error
check left off: no host synchronisation, so the physics step can be
captured in a CUDA graph.

Parameters carry the agent axis first (``q, dq, f: (..., n, 3)``); a state
may carry any leading batch axes. S^2 projection every step, SO(3)
projection every 20.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from tpu_aerial_transport_torch import resolve_device
from tpu_aerial_transport_torch.models.rp import (  # noqa: F401
    GRAVITY,
    gravity_vector,
)
from tpu_aerial_transport_torch.models.rqp import _f32, _mv
from tpu_aerial_transport_torch.ops import lie

PROJECTION_PERIOD = 20


@dataclass(frozen=True)
class PMRLParams:
    """System parameters; agent axis leads."""

    m: torch.Tensor  # (n,) robot masses.
    ml: torch.Tensor  # () payload mass.
    Jl: torch.Tensor  # (3, 3) payload inertia.
    r: torch.Tensor  # (n, 3) link attachment points (payload body frame).
    L: torch.Tensor  # (n,) link lengths.
    Jl_inv: torch.Tensor  # (3, 3).
    Jl_inv_factor: torch.Tensor  # (3, 3) F with F^T F = Jl_inv.

    @property
    def n(self) -> int:
        return self.r.shape[-2]


def pmrl_params(m, ml, Jl, r, L, device="cuda") -> PMRLParams:
    """Build :class:`PMRLParams` from inputs rounded to float32; the
    inverse and its Cholesky factor taken in float32."""
    dev = resolve_device(device)
    m, ml, Jl, r, L = (_f32(v, dev) for v in (m, ml, Jl, r, L))
    n = r.shape[0]
    assert m.shape == (n,) and L.shape == (n,) and Jl.shape == (3, 3)
    Jl_inv = torch.linalg.inv(Jl)
    # The lower Cholesky factor C (A = C C^T); F = C^T has F^T F = Jl_inv.
    return PMRLParams(m=m, ml=ml, Jl=Jl, r=r, L=L, Jl_inv=Jl_inv,
                      Jl_inv_factor=torch.linalg.cholesky(Jl_inv).T)


@dataclass(frozen=True)
class PMRLState:
    """System state; ``(..., n)`` agent axis, any leading batch axes."""

    q: torch.Tensor  # (..., n, 3) unit link directions (world frame).
    dq: torch.Tensor  # (..., n, 3) tangent velocities, q_i . dq_i = 0.
    xl: torch.Tensor  # (..., 3) payload CoM position.
    vl: torch.Tensor  # (..., 3) payload CoM velocity.
    Rl: torch.Tensor  # (..., 3, 3) payload rotation.
    wl: torch.Tensor  # (..., 3) body angular velocity.
    step: torch.Tensor  # (...) int32 projection counter.

    @property
    def n(self) -> int:
        return self.q.shape[-2]

    def replace(self, **kw) -> "PMRLState":
        return dataclasses.replace(self, **kw)


def _project_q(q, dq):
    """Normalize q to S^2 and project dq onto the tangent space."""
    q = q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)
    dq = dq - q * torch.sum(q * dq, dim=-1, keepdim=True)
    return q, dq


def pmrl_state(q, dq, xl, vl, Rl, wl, device="cuda") -> PMRLState:
    """Build a single state: q on S^2, dq tangent, the rotation projected
    with the SVD polar factor."""
    dev = resolve_device(device)
    q, dq = _project_q(_f32(q, dev), _f32(dq, dev))
    return PMRLState(
        q=q, dq=dq, xl=_f32(xl, dev), vl=_f32(vl, dev),
        Rl=lie.polar_project_svd(_f32(Rl, dev)), wl=_f32(wl, dev),
        step=torch.zeros((), dtype=torch.int32, device=dev),
    )


def forward_dynamics(params: PMRLParams, state: PMRLState, f):
    """World-frame robot thrusts ``f (..., n, 3)`` -> ``((ddq, dvl, dwl),
    T)``. Eliminating the constraint forces gives the SPD system
    ``[diag(1/m) + (1/ml) q q^T + rcq Jl_inv rcq^T] T = rhs`` with
    ``rcq_i = r_i x Rl^T q_i``. The state's and the forces' leading axes
    broadcast against each other."""
    q, dq, Rl, wl = state.q, state.dq, state.Rl, state.wl
    m, L = params.m, params.L

    cor_acc = _mv(params.Jl_inv, lie.cross(wl, _mv(params.Jl, wl)))
    cor_mat = Rl @ (lie.hat_square(wl, wl) - lie.hat(cor_acc))  # (..., 3, 3)
    # Applied force net of the payload's rotational pseudo-forces
    # transmitted through each attachment.
    add_force = f - (params.r * m[:, None]) @ cor_mat.transpose(-1, -2)

    rhs = (torch.sum(add_force * q, dim=-1)
           + m * L * torch.sum(dq * dq, dim=-1)) / m  # (..., n)
    rcq = lie.cross(params.r, q @ Rl)  # rows r_i x (Rl^T q_i).
    temp = rcq @ params.Jl_inv_factor.T  # temp temp^T = rcq Jl_inv rcq^T.
    lhs = (torch.diag(1.0 / m) + (q @ q.transpose(-1, -2)) / params.ml
           + temp @ temp.transpose(-1, -2))  # (..., n, n) SPD.
    batch = torch.broadcast_shapes(lhs.shape[:-2], rhs.shape[:-1])
    T = torch.linalg.solve_ex(
        lhs.expand(batch + lhs.shape[-2:]),
        rhs.expand(batch + rhs.shape[-1:])[..., None])[0][..., 0]  # tensions.

    qT = _mv(q.transpose(-1, -2), T)  # sum_i T_i q_i.
    rcqT = _mv(params.Jl_inv, _mv(rcq.transpose(-1, -2), T))
    mL = (m * L)[:, None]
    ddq = (
        (add_force - q * T[..., None]) / mL
        - qT[..., None, :] / (params.ml * L)[:, None]
        - (params.r / L[:, None]) @ (Rl @ lie.hat(rcqT)).transpose(-1, -2)
    )
    dvl = qT / params.ml + gravity_vector(qT)
    dwl = rcqT - cor_acc
    return (ddq, dvl, dwl), T


def integrate_state(state: PMRLState, acc, dt,
                    project_every: int = PROJECTION_PERIOD) -> PMRLState:
    """Trapezoidal step; q re-projected to S^2 every step, Rl to SO(3)
    every ``project_every`` steps."""
    ddq, dvl, dwl = acc
    q = state.q + state.dq * dt + ddq * (dt**2 / 2)
    dq = state.dq + ddq * dt
    q, dq = _project_q(q, dq)
    xl = state.xl + state.vl * dt + dvl * (dt**2 / 2)
    vl = state.vl + dvl * dt
    Rl = state.Rl @ lie.expm_so3((state.wl + dwl * (dt / 2)) * dt)
    wl = state.wl + dwl * dt
    step = state.step + 1
    project = step >= project_every
    Rl = torch.where(project[..., None, None], lie.polar_project(Rl), Rl)
    step = torch.where(project, torch.zeros_like(step), step)
    return PMRLState(q=q, dq=dq, xl=xl, vl=vl, Rl=Rl, wl=wl, step=step)


def integrate(params: PMRLParams, state: PMRLState, f, dt,
              project_every: int = PROJECTION_PERIOD) -> PMRLState:
    """Forward dynamics + one integration step."""
    acc, _ = forward_dynamics(params, state, f)
    return integrate_state(state, acc, dt, project_every)


class PMRLCollision:
    """Host-side collision metadata: payload hull and collision-mesh
    vertices, and a bounding radius that covers the payload and the fully
    extended links (the robots are point masses). ``link_lengths`` is a
    host array."""

    def __init__(self, payload_vertices, payload_mesh_vertices,
                 link_lengths=None):
        payload_vertices = np.asarray(payload_vertices, np.float64)
        payload_mesh_vertices = np.asarray(payload_mesh_vertices, np.float64)
        assert payload_vertices.shape[1] == 3
        assert payload_mesh_vertices.shape[1] == 3
        self.payload_vertices = payload_vertices
        self.payload_mesh_vertices = payload_mesh_vertices
        mesh_radius = float(np.max(np.linalg.norm(payload_mesh_vertices,
                                                  axis=1)))
        max_link = (float(np.max(np.asarray(link_lengths)))
                    if link_lengths is not None else 0.0)
        self.collision_radius = mesh_radius + max_link + 0.1


def inverse_dynamics_error(state: PMRLState, params: PMRLParams, f, T,
                           acc) -> torch.Tensor:
    """Residual norm ``(...)`` of the four dynamics equations, the sphere
    constraint included (the test oracle of the tension solve)."""
    ddq, dvl, dwl = acc
    gravity = gravity_vector(dvl)
    q, Rl, wl = state.q, state.Rl, state.wl
    m, L = params.m[:, None], params.L[:, None]

    kin = (lie.hat_square(wl, wl) + lie.hat(dwl)) @ params.r.T  # (..., 3, n)
    dv_robot = (dvl[..., None, :] + ddq * L
                + (Rl @ kin).transpose(-1, -2))  # (..., n, 3)
    robot_res = dv_robot * m - f - gravity * m + q * T[..., None]
    load_lin_res = (params.ml * dvl - _mv(q.transpose(-1, -2), T)
                    - params.ml * gravity)
    rcq = lie.cross(params.r, q @ Rl)
    load_ang_res = (_mv(params.Jl, dwl) + lie.cross(wl, _mv(params.Jl, wl))
                    - _mv(rcq.transpose(-1, -2), T))
    sphere_res = (torch.sum(q * ddq, dim=-1)
                  + torch.sum(state.dq**2, dim=-1))
    return torch.sqrt(
        torch.sum(robot_res**2, dim=(-2, -1))
        + torch.sum(load_lin_res**2, dim=-1)
        + torch.sum(load_ang_res**2, dim=-1)
        + torch.sum(sphere_res**2, dim=-1)
    )
