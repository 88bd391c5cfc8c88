"""Centralized QP + CBF safety-filter controller for the PMRL model, batched
over Monte-Carlo scenarios.

Counterpart of ``tpu_aerial_transport/control/pmrl_centralized.py`` (the
JAX package's extension beyond the reference, which ships PMRL as dynamics
only):

- The PMRL accelerations are exactly affine in the robot thrusts (the
  tension solve is linear with a right-hand side affine in ``f``), so
  ``[dvl; dwl] = B f + c`` and the robot accelerations ``ddx = B_rob f +
  c_rob``. :func:`_affine_dynamics` evaluates the port's own
  ``models.pmrl.forward_dynamics`` on the batch ``[0, e_1, ..., e_3n]`` of
  every scenario in one call and takes ``B[:, j] = accs(e_j) - accs(0)``:
  no hand linearisation to drift from the model (the JAX package takes
  ``jax.jacfwd``; the two differ by float32 rounding).
- Decision variables ``[dvl | dwl | f_1..f_n]`` with the affine dynamics as
  (row-normalised) equality rows; tracking, robot-acceleration and
  regularisation costs; the payload tilt / |wl| / |vl| CBF rows of the RP
  controller; per-robot min-thrust, thrust-cone and norm-cap constraints.
- Equilibrium thrusts depend on the state: the tensions are the
  least-squares solution of the static wrench balance along the current
  links, ``jnp.linalg.lstsq``'s: an SVD with the singular values under
  ``eps max(6, n)`` times the largest dropped (at the setup state every
  link is vertical and the 6 x n balance has rank 3).

All ``S`` scenarios' QPs are one batched solve, tolerance-chunked
(``solver_check_every`` iterations a chunk, to ``solver_tol``, capped at
``solver_iters``): on the card one launch of the whole-solve kernel's
early-exit form a control step, its shared-memory body (d = 111 at n = 8).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from tpu_aerial_transport_torch.control.centralized import CtrlState, _cos32
from tpu_aerial_transport_torch.control.rp_centralized import (
    _e3,
    actuation_rows,
    cbf_rows,
    fallback_step,
    no_consensus_stats,
    qp_dims,
    tracking_cost,
)
from tpu_aerial_transport_torch.models import pmrl
from tpu_aerial_transport_torch.models.pmrl import (
    GRAVITY,
    PMRLParams,
    PMRLState,
)
from tpu_aerial_transport_torch.ops import lie, socp


@dataclass(frozen=True)
class PMRLCentralizedConfig:
    """Controller constants (the JAX package's ``PMRLCentralizedConfig``)."""

    min_fz: float
    sec_max_f_ang: float
    max_f: float
    cos_max_p_ang: float
    alpha1_p_cbf: float
    alpha2_p_cbf: float
    max_wl_sq: float
    alpha_wl_cbf: float
    max_vl_sq: float
    alpha_vl_cbf: float
    k_f: float
    k_feq: float
    k_dvl: float
    k_dwl: float
    # Robot-acceleration tracking weight: at (near-)vertical links the
    # payload has almost no lateral authority, so the robots' accelerations
    # are tracked to swing the links.
    k_rob: float = 1.0
    # Swing damping in the default robot-acceleration target
    # a_des,i = dvl_des - swing_damp L_i dq_i (the JAX package's calibrated
    # value).
    swing_damp: float = 3.5
    solver_iters: int = 150
    solver_tol: float = 5e-3
    solver_check_every: int = 25


def make_config(params: PMRLParams, solver_iters: int = 150
                ) -> PMRLCentralizedConfig:
    """The RP controller's constants scaled to the assembly's total mass
    ``ml + sum m_i``."""
    n = params.n
    mTg = float(params.ml + torch.sum(params.m)) * GRAVITY
    return PMRLCentralizedConfig(
        min_fz=mTg / (n * 10.0),
        sec_max_f_ang=float(1.0 / _cos32(math.pi / 6.0)),
        max_f=2.0 * mTg / n,
        cos_max_p_ang=float(_cos32(math.pi / 6.0)),
        alpha1_p_cbf=1.0,
        alpha2_p_cbf=1.0,
        max_wl_sq=float((math.pi / 6.0) ** 2),
        alpha_wl_cbf=1.0,
        max_vl_sq=1.0,
        alpha_vl_cbf=1.0,
        k_f=0.1,
        k_feq=0.1,
        k_dvl=1.0,
        k_dwl=1.0,
        k_rob=1.0,
        swing_damp=3.5,
        solver_iters=solver_iters,
    )


def lstsq_min_norm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``jnp.linalg.lstsq(a, b)[0]`` of a batch ``a (..., M, N)``, ``b
    (..., M)``: the minimum-norm least-squares solution from the SVD, with
    the singular values that are 0 or under ``eps max(M, N)`` times the
    largest dropped (JAX 0.9's ``_lstsq``). On the card the SVD
    synchronises the host."""
    u, s, vh = torch.linalg.svd(a, full_matrices=False)
    rcond = torch.finfo(a.dtype).eps * max(a.shape[-2:])
    keep = (s > 0) & (s >= rcond * s[..., 0:1])
    s_inv = torch.where(keep, 1.0 / torch.where(keep, s, torch.ones_like(s)),
                        torch.zeros_like(s))
    uTb = (u.transpose(-1, -2) @ b[..., None])[..., 0]
    return (vh.transpose(-1, -2) @ (s_inv * uTb)[..., None])[..., 0]


def equilibrium_forces(params: PMRLParams, state: PMRLState) -> torch.Tensor:
    """State-dependent static thrusts ``(..., n, 3)``: the least-squares
    tensions balancing the payload wrench along the current links, plus each
    robot's own weight."""
    q, Rl = state.q, state.Rl
    e3 = _e3(q)
    rcq = lie.cross(params.r, q @ Rl)  # rows r_i x (Rl^T q_i).
    A = torch.cat([q.transpose(-1, -2), rcq.transpose(-1, -2)], dim=-2)
    b = torch.nn.functional.pad((params.ml * GRAVITY)[None], (2, 3))
    T = lstsq_min_norm(A, b.expand(A.shape[:-2] + (6,)))  # (..., n)
    return params.m[:, None] * GRAVITY * e3 + T[..., None] * q


def init_ctrl_state(params: PMRLParams, cfg: PMRLCentralizedConfig,
                    state: PMRLState) -> CtrlState:
    """The initial state at ``state`` (any leading axes): the equilibrium
    thrusts and the warm start ``[0 | f_eq]`` with zero duals."""
    _, m, _ = qp_dims(params.n)
    f_eq = equilibrium_forces(params, state)
    batch = f_eq.shape[:-2]
    kw = dict(dtype=f_eq.dtype, device=f_eq.device)
    warm = socp.SOCPSolution(
        x=torch.cat([torch.zeros(batch + (6,), **kw),
                     f_eq.reshape(batch + (-1,))], dim=-1),
        y=torch.zeros(batch + (m,), **kw), z=torch.zeros(batch + (m,), **kw),
        prim_res=torch.zeros(batch, **kw), dual_res=torch.zeros(batch, **kw),
    )
    return CtrlState(prev_f=f_eq, warm=warm)


def _affine_dynamics(params: PMRLParams, state: PMRLState):
    """The exact affine maps through the tension solve, per scenario:
    payload accelerations ``[dvl; dwl] = B f + c`` (``B (S, 6, 3n)``) and
    robot accelerations ``ddx = B_rob f + c_rob`` (``B_rob (S, 3n, 3n)``),
    ``ddx_i = dvl + L_i ddq_i + Rl (hat^2(wl) + hat(dwl)) r_i``. One
    forward-dynamics call on ``[0, e_1, ..., e_3n]`` a scenario; column j
    is ``accs(e_j) - accs(0)``."""
    n = params.n
    S = state.xl.shape[0]
    kw = dict(dtype=state.xl.dtype, device=state.xl.device)
    basis = torch.cat([torch.zeros((1, 3 * n), **kw),
                       torch.eye(3 * n, **kw)]).reshape(1, 3 * n + 1, n, 3)
    one = pmrl.PMRLState(
        q=state.q[:, None], dq=state.dq[:, None], xl=state.xl[:, None],
        vl=state.vl[:, None], Rl=state.Rl[:, None], wl=state.wl[:, None],
        step=state.step[:, None])
    (ddq, dvl, dwl), _ = pmrl.forward_dynamics(
        params, one, basis.expand(S, 3 * n + 1, n, 3))
    Rl, wl = one.Rl, one.wl
    kin = (lie.hat_square(wl, wl) + lie.hat(dwl)) @ params.r.T  # (S, K, 3, n)
    ddx = (dvl[..., None, :] + ddq * params.L[:, None]
           + (Rl @ kin).transpose(-1, -2))  # (S, K, n, 3)
    acc = torch.cat([dvl, dwl], dim=-1)  # (S, K, 6)
    rob = ddx.reshape(S, 3 * n + 1, 3 * n)
    c, c_rob = acc[:, 0], rob[:, 0]
    B = (acc[:, 1:] - acc[:, :1]).transpose(-1, -2)
    B_rob = (rob[:, 1:] - rob[:, :1]).transpose(-1, -2)
    return B, c, B_rob, c_rob


def _build_qp(params: PMRLParams, cfg: PMRLCentralizedConfig, f_eq,
              state: PMRLState, acc_des, rob_acc_des):
    """``(P, q, A, lb, ub, shift)`` of every scenario, shapes ``(S, ...)``
    (the JAX package's ``_build_qp`` under ``vmap``); ``f_eq (S, n, 3)``,
    ``rob_acc_des (S, n, 3)``. Variables [dvl 0:3 | dwl 3:6 | f 6:6+3n];
    rows per :func:`qp_dims`."""
    n = params.n
    nv = 6 + 3 * n
    kw = dict(dtype=state.xl.dtype, device=state.xl.device)
    S = state.xl.shape[0]
    mT = params.ml + torch.sum(params.m)
    P, q = tracking_cost(cfg, n, S, f_eq, acc_des, mT, kw)

    n_box, _, soc_dims = qp_dims(n)
    A = torch.zeros((S, n_box, nv), **kw)
    lb = torch.zeros((S, n_box), **kw)
    ub = torch.zeros((S, n_box), **kw)

    B, c, B_rob, c_rob = _affine_dynamics(params, state)
    # Robot-acceleration tracking: quadratic in f only.
    resid0 = c_rob - rob_acc_des.reshape(S, 3 * n)
    B_rob_T = B_rob.transpose(-1, -2)
    P[:, 6:, 6:] += 2.0 * cfg.k_rob * (B_rob_T @ B_rob)
    q[:, 6:] += 2.0 * cfg.k_rob * (B_rob_T @ resid0[..., None])[..., 0]

    # The affine dynamics rows [dvl; dwl] - B f = c, each row normalised
    # (the dwl rows carry Jl_inv ~ O(50) entries against O(1) dvl rows).
    dyn = torch.cat([torch.eye(6, **kw).expand(S, 6, 6), -B], dim=-1)
    scale = 1.0 / torch.linalg.vector_norm(dyn, dim=-1)
    A[:, 0:6, :] = dyn * scale[..., None]
    lb[:, 0:6] = c * scale
    ub[:, 0:6] = c * scale

    soc, shift_soc = actuation_rows(cfg, n, S, A, lb, ub, kw)
    cbf_rows(cfg, state, A, lb, ub, 6 + n)
    A_full = torch.cat([A, soc], dim=1)
    shift = torch.cat([torch.zeros((n_box,), **kw), shift_soc]).expand(
        S, n_box + 8 * n)
    return P, q, A_full, lb, ub, shift


def control(params: PMRLParams, cfg: PMRLCentralizedConfig,
            ctrl_state: CtrlState, state: PMRLState, acc_des,
            rob_acc_des=None):
    """One control step for ``S`` scenarios at once: ``-> (f (S, n, 3),
    CtrlState, SolverStats)``; ``f`` feeds ``models.pmrl.integrate``
    directly (point-mass robots have no attitude stage). ``ctrl_state`` and
    ``state`` carry the leading scenario axis; ``acc_des`` is shared
    (``(3,)`` each) or per scenario (``(S, 3)``). ``rob_acc_des (S, n, 3)``
    defaults to ``dvl_des - swing_damp L_i dq_i``. A scenario whose solve
    misses ``solver_tol`` keeps its previous forces and warm start;
    ``ok_frac`` is 1 where the solve succeeded, else 0."""
    n = params.n
    if rob_acc_des is None:
        rob_acc_des = (acc_des[0][..., None, :]
                       - cfg.swing_damp * params.L[:, None] * state.dq)
    f_eq = equilibrium_forces(params, state)
    P, q, A, lb, ub, shift = _build_qp(params, cfg, f_eq, state, acc_des,
                                       rob_acc_des)
    n_box, _, soc_dims = qp_dims(n)
    sol = socp.solve_socp(
        P, q, A, lb, ub, n_box=n_box, soc_dims=soc_dims,
        iters=cfg.solver_iters, warm=ctrl_state.warm, shift=shift,
        check_every=cfg.solver_check_every, tol=cfg.solver_tol)
    f_out, new_state, ok = fallback_step(sol, ctrl_state, cfg.solver_tol, n)
    return f_out, new_state, no_consensus_stats(sol, ok.to(sol.x.dtype))
