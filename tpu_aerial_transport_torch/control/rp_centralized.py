"""Centralized QP + CBF safety-filter controller for the rigid-payload (RP)
model, batched over Monte-Carlo scenarios.

Counterpart of ``tpu_aerial_transport/control/rp_centralized.py``. The
problem:

  decision  x = [dvl (3) | dwl (3) | f_1..f_n (3 each)]
  cost      k_f ||sum f - ml g e3||^2 + k_feq ||f - f_eq||^2
            + k_dvl (||dvl||^2 - 2 dvl_des . dvl)
            + k_dwl (||dwl||^2 - 2 dwl_des . dwl)
  s.t.      payload dynamics equalities; f_z >= min_fz;
            ||f_i|| <= sec(30deg) f_iz (SOC); ||f_i|| <= max_f (SOC);
            payload-tilt (30 deg) / |wl| / |vl| CBF rows.

All ``S`` scenarios' QPs are one batched solve (``ops.socp.solve_socp``,
route ``"auto"``, a fixed ``solver_iters`` iterations) at d = (6 + 3n) +
(9 + n) + 8n: 51 at n = 3, 111 at n = 8. Up to n = 8 the whole-solve
kernel's shared-memory body holds it (one launch of its fixed form a control
step on the card); from n = 9 (more than 16 SOC blocks) the ``"scan"`` route
runs it in plain tensor ops (:func:`solve_route`). A scenario whose solve
fails keeps its previous forces and warm start.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from tpu_aerial_transport_torch.control.centralized import CtrlState, _cos32
from tpu_aerial_transport_torch.control.types import SolverStats
from tpu_aerial_transport_torch.models.rp import GRAVITY, RPParams, RPState
from tpu_aerial_transport_torch.ops import lie, socp


@dataclass(frozen=True)
class RPCentralizedConfig:
    """Controller constants (the JAX package's ``RPCentralizedConfig``)."""

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
    solver_iters: int = 150
    solver_tol: float = 5e-3


def make_config(params: RPParams, solver_iters: int = 150
                ) -> RPCentralizedConfig:
    """The JAX package's constants: min_fz = ml g / 10n, cone 30 deg,
    max_f = 2 ml g / n, payload tilt at most 30 deg, |wl| <= pi/6,
    |vl| <= 1; ``cos`` taken in float32 as there."""
    n = params.n
    mlg = float(params.ml) * GRAVITY
    return RPCentralizedConfig(
        min_fz=mlg / (n * 10.0),
        sec_max_f_ang=float(1.0 / _cos32(math.pi / 6.0)),
        max_f=2.0 * mlg / n,
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
        solver_iters=solver_iters,
    )


def _e3(like: torch.Tensor) -> torch.Tensor:
    """(0, 0, 1) from a fill and a pad: no host-to-device copy."""
    return torch.nn.functional.pad(
        torch.ones((1,), dtype=like.dtype, device=like.device), (2, 0))


def equilibrium_forces(params: RPParams) -> torch.Tensor:
    """Vertical static-wrench-balance forces ``(n, 3)``: the minimum-norm
    ``fz`` of ``[1; (r_i x e3)_xy] fz = [ml g; 0; 0]``, in closed form
    ``W^T (W W^T)^-1 rhs`` (``W`` has full row rank), not with
    ``torch.linalg.lstsq``, which on CUDA (``gels`` only) does not return
    the minimum-norm solution."""
    n = params.n
    r = params.r
    rxe = lie.cross(r, _e3(r))
    W = torch.cat([torch.ones((n, 1), dtype=r.dtype, device=r.device),
                   rxe[:, :2]], dim=1).T  # (3, n)
    rhs = torch.nn.functional.pad((params.ml * GRAVITY)[None], (0, 2))
    fz = W.T @ torch.linalg.solve(W @ W.T, rhs)
    return torch.cat([torch.zeros((n, 2), dtype=r.dtype, device=r.device),
                      fz[:, None]], dim=1)


def qp_dims(n: int):
    """``(n_box, m, soc_dims)``: box rows [dyn-trans 3 | dyn-rot 3 | fz n |
    tilt 1 | wl 1 | vl 1], then per agent a thrust-cone and a norm-cap
    SOC(4)."""
    n_box = 9 + n
    soc_dims = (4,) * (2 * n)
    return n_box, n_box + sum(soc_dims), soc_dims


def init_ctrl_state(params: RPParams, cfg: RPCentralizedConfig) -> CtrlState:
    """One scenario's initial state (no scenario axis): the equilibrium
    forces and the warm start ``[0 | f_eq]`` with zero duals."""
    _, m, _ = qp_dims(params.n)
    f_eq = equilibrium_forces(params)
    kw = dict(dtype=f_eq.dtype, device=f_eq.device)
    warm = socp.SOCPSolution(
        x=torch.cat([torch.zeros((6,), **kw), f_eq.reshape(-1)]),
        y=torch.zeros((m,), **kw), z=torch.zeros((m,), **kw),
        prim_res=torch.zeros((), **kw), dual_res=torch.zeros((), **kw),
    )
    return CtrlState(prev_f=f_eq, warm=warm)


def solve_route(n: int, cfg: RPCentralizedConfig) -> str:
    """The route the controller's solve runs at ``n`` agents
    (``ops.socp.runtime_fused_mode`` of ``"auto"`` at its shape)."""
    n_box, m, soc_dims = qp_dims(n)
    return socp.runtime_fused_mode("auto", 6 + 3 * n, m, n_box, soc_dims)


def _mv(M: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return (M @ v[..., None])[..., 0]


def cbf_rows(cfg, state, A, lb, ub, row: int):
    """The payload tilt / |wl| / |vl| CBF rows at ``row, row + 1, row + 2``
    of every scenario's box rows, written in place (variables [dvl 0:3 |
    dwl 3:6 | ...]); shared with the PMRL controller."""
    Rl, wl, vl = state.Rl, state.wl, state.vl
    e3 = _e3(Rl)
    R_w_hat = Rl @ lie.hat(wl)
    R_w_hat_sq = Rl @ lie.hat_square(wl, wl)
    A[:, row, 3:6] = -(Rl[:, 2, None, :] @ lie.hat(e3))[:, 0]
    lb[:, row] = (
        -R_w_hat_sq[:, 2, 2]
        - (cfg.alpha1_p_cbf + cfg.alpha2_p_cbf) * R_w_hat[:, 2, 2]
        - cfg.alpha1_p_cbf * cfg.alpha2_p_cbf
        * (Rl[:, 2, 2] - cfg.cos_max_p_ang)
    )
    A[:, row + 1, 3:6] = -2.0 * wl
    lb[:, row + 1] = -cfg.alpha_wl_cbf * (cfg.max_wl_sq
                                          - torch.sum(wl * wl, dim=-1))
    A[:, row + 2, 0:3] = -2.0 * vl
    lb[:, row + 2] = -cfg.alpha_vl_cbf * (cfg.max_vl_sq
                                          - torch.sum(vl * vl, dim=-1))
    ub[:, row:row + 3] = socp.INF


def actuation_rows(cfg, n: int, S: int, A, lb, ub, kw):
    """The per-agent min-thrust box rows (at 6 : 6 + n) written in place,
    and the SOC rows ``(S, 8n, 6 + 3n)`` with their shift ``(8n,)``: per
    agent ``[sec30 f_z; f]`` (cone) and ``[max_f; f]`` (cap, the constant
    through the shift); shared with the PMRL controller."""
    nv = 6 + 3 * n
    eye3 = torch.eye(3, **kw)
    for i in range(n):
        A[:, 6 + i, 6 + 3 * i + 2] = 1.0
    lb[:, 6:6 + n] = cfg.min_fz
    ub[:, 6:6 + n] = socp.INF
    soc = torch.zeros((8 * n, nv), **kw)
    shift_soc = torch.zeros((8 * n,), **kw)
    for i in range(n):
        base, fi = 8 * i, 6 + 3 * i
        soc[base, fi + 2] = cfg.sec_max_f_ang
        soc[base + 1:base + 4, fi:fi + 3] = eye3
        shift_soc[base + 4] = cfg.max_f
        soc[base + 5:base + 8, fi:fi + 3] = eye3
    return soc.expand(S, 8 * n, nv), shift_soc


def tracking_cost(cfg, n: int, S: int, f_eq, acc_des, m_total, kw):
    """``(P, q)`` of every scenario: the acceleration tracking and the
    force regularisation terms (``f_eq`` shared ``(n, 3)`` or per scenario
    ``(S, n, 3)``); shared with the PMRL controller."""
    nv = 6 + 3 * n
    eye3 = torch.eye(3, **kw)
    dvl_des, dwl_des = acc_des
    P = torch.zeros((S, nv, nv), **kw)
    q = torch.zeros((S, nv), **kw)
    P[:, 0:3, 0:3] += 2.0 * cfg.k_dvl * eye3
    q[:, 0:3] += -2.0 * cfg.k_dvl * dvl_des
    P[:, 3:6, 3:6] += 2.0 * cfg.k_dwl * eye3
    q[:, 3:6] += -2.0 * cfg.k_dwl * dwl_des
    Ssum = eye3.repeat(1, n)
    P[:, 6:, 6:] += (2.0 * cfg.k_f * (Ssum.T @ Ssum)
                     + 2.0 * cfg.k_feq * torch.eye(3 * n, **kw))
    q[:, 6:] += (-2.0 * cfg.k_f * (Ssum.T @ (m_total * GRAVITY * _e3(P)))
                 - 2.0 * cfg.k_feq * f_eq.reshape(f_eq.shape[:-2] + (-1,)))
    return P, q


def _build_qp(params: RPParams, cfg: RPCentralizedConfig, f_eq, state:
              RPState, acc_des):
    """``(P, q, A, lb, ub, shift, scales)`` of every scenario, shapes
    ``(S, ...)`` (the JAX package's ``_build_qp`` under ``vmap``), the rows
    equilibrated by ``socp.equilibrate_rows``; ``scales`` lets a caller
    that rewrites a bound stay in the equilibrated row scaling."""
    n = params.n
    nv = 6 + 3 * n
    kw = dict(dtype=state.xl.dtype, device=state.xl.device)
    S = state.xl.shape[0]
    Rl = state.Rl
    eye3 = torch.eye(3, **kw)
    P, q = tracking_cost(cfg, n, S, f_eq, acc_des, params.ml, kw)

    n_box, _, soc_dims = qp_dims(n)
    A = torch.zeros((S, n_box, nv), **kw)
    lb = torch.zeros((S, n_box), **kw)
    ub = torch.zeros((S, n_box), **kw)
    # ml dvl - sum f_i = -ml g e3.
    A[:, 0:3, 0:3] = params.ml * eye3
    A[:, 0:3, 6:] = -eye3.repeat(1, n)
    rhs = -params.ml * GRAVITY * _e3(Rl)
    lb[:, 0:3] = rhs
    ub[:, 0:3] = rhs
    # dwl - sum Jl_inv hat(r_i) Rl^T f_i = -Jl_inv (wl x Jl wl).
    G = (lie.hat(params.r)[None] @ Rl.transpose(-1, -2)[:, None]).permute(
        0, 2, 1, 3).reshape(S, 3, 3 * n)
    A[:, 3:6, 3:6] = eye3
    A[:, 3:6, 6:] = -params.Jl_inv @ G
    rot_rhs = _mv(-params.Jl_inv,
                  lie.cross(state.wl, _mv(params.Jl, state.wl)))
    lb[:, 3:6] = rot_rhs
    ub[:, 3:6] = rot_rhs
    soc, shift_soc = actuation_rows(cfg, n, S, A, lb, ub, kw)
    cbf_rows(cfg, state, A, lb, ub, 6 + n)

    A_full = torch.cat([A, soc], dim=1)
    shift = torch.cat([torch.zeros((n_box,), **kw), shift_soc]).expand(
        S, n_box + 8 * n)
    # Row equilibration: the rotation rows carry Jl_inv ~ O(50) against
    # O(ml) translation rows.
    A_full, lb, ub, shift, scales = socp.equilibrate_rows(
        A_full, lb, ub, shift, n_box, soc_dims)
    return P, q, A_full, lb, ub, shift, scales


def fallback_step(sol: socp.SOCPSolution, ctrl_state: CtrlState, tol: float,
                  n: int):
    """``(f_out, CtrlState, ok)``: each scenario's solved forces, or, where
    its solve missed ``tol`` or is not finite, its previous forces and warm
    start; shared with the PMRL controller."""
    S = sol.x.shape[0]
    f = sol.x[:, 6:].reshape(S, n, 3)
    ok = (sol.prim_res < tol) & torch.all(torch.isfinite(sol.x), dim=-1)
    f_out = torch.where(ok[:, None, None], f, ctrl_state.prev_f)
    warm = socp.SOCPSolution(
        x=torch.where(ok[:, None], sol.x, ctrl_state.warm.x),
        y=torch.where(ok[:, None], sol.y, ctrl_state.warm.y),
        z=torch.where(ok[:, None], sol.z, ctrl_state.warm.z),
        prim_res=sol.prim_res, dual_res=sol.dual_res,
    )
    return f_out, CtrlState(prev_f=f_out, warm=warm), ok


def no_consensus_stats(sol: socp.SOCPSolution, ok_frac) -> SolverStats:
    """A centralized step's stats: ``iters`` -1, no environment, empty
    sequences."""
    S = sol.x.shape[0]
    kw = dict(dtype=sol.x.dtype, device=sol.x.device)
    return SolverStats(
        iters=torch.full((S,), -1, dtype=torch.int32, device=sol.x.device),
        solve_res=sol.prim_res,
        collision=torch.zeros((S,), dtype=torch.bool, device=sol.x.device),
        min_env_dist=torch.full((S,), math.inf, **kw),
        err_seq=torch.zeros((S, 0), **kw),
        ok_frac=ok_frac,
        fallback_rung=torch.zeros((S,), dtype=torch.int32,
                                  device=sol.x.device),
        agent_solve_res=torch.zeros((S, 0), **kw),
        inner_iters=torch.zeros((S, 0), dtype=torch.int32,
                                device=sol.x.device),
    )


def control(params: RPParams, cfg: RPCentralizedConfig, f_eq: torch.Tensor,
            ctrl_state: CtrlState, state: RPState, acc_des):
    """One control step for ``S`` scenarios at once: ``-> (f (S, n, 3),
    CtrlState, SolverStats)``. ``ctrl_state`` and ``state`` carry the
    leading scenario axis; ``f_eq (n, 3)`` is shared; ``acc_des`` is shared
    (``(3,)`` each) or per scenario (``(S, 3)``). A scenario whose solve
    misses ``solver_tol`` keeps its previous forces and warm start;
    ``SolverStats.iters`` is -1 and ``ok_frac`` 1 (the JAX package's
    defaults)."""
    n = params.n
    P, q, A, lb, ub, shift, _ = _build_qp(params, cfg, f_eq, state, acc_des)
    n_box, _, soc_dims = qp_dims(n)
    sol = socp.solve_socp(P, q, A, lb, ub, n_box=n_box, soc_dims=soc_dims,
                          iters=cfg.solver_iters, warm=ctrl_state.warm,
                          shift=shift)
    f_out, new_state, _ = fallback_step(sol, ctrl_state, cfg.solver_tol, n)
    return f_out, new_state, no_consensus_stats(
        sol, torch.ones_like(sol.prim_res))
