"""Centralized controller for the RQP model: one conic QP per control step
with CBF safety rows, batched over Monte-Carlo scenarios.

Counterpart of ``tpu_aerial_transport/control/centralized.py``. The problem:

  decision  x = [dv_com (3) | dvl (3) | dwl (3) | f_1..f_n (3 each)]
  cost      k_f ||sum f - mT g e3||^2 + k_m ||sum hat(r_com_i) Rl^T f_i||^2
            + k_feq ||f - f_eq||^2 + k_dvl (||dvl||^2 - 2 dvl_des . dvl)
            + k_dwl (||dwl||^2 - 2 dwl_des . dwl)
  s.t.      linearized dynamics + CoM->payload kinematics equalities,
            f_z >= min_fz; ||f_i|| <= sec(30deg) f_iz (SOC);
            ||f_i|| <= max_f (SOC); payload-tilt / |wl| / |vl| CBF rows;
            up to n_env_cbfs collision CBF rows  lhs @ dvl >= rhs.

All ``S`` scenarios' QPs are one batched solve (``ops.socp.solve_socp``,
route ``"auto"``, as the JAX package's controller takes it): warm-started,
tolerance-chunked (``solver_check_every`` iterations a chunk, to
``solver_tol``, capped at ``solver_iters``), at d = 9 + 3n + 12 + n +
n_env_cbfs + 8n (67 at n = 3, 79 at n = 4, 223 at n = 16). The solver's
resolver decides the route from that shape (:func:`solve_route`): up to
n = 8 the whole-solve kernel holds it, one launch of its early-exit form per
MPC step on the card; from n = 9 (more than 16 SOC blocks) the ``"scan"``
route runs it in plain tensor ops.
A scenario whose solve fails keeps its previous forces and warm start.
``equilibrium_forces`` and ``smooth_block`` are shared with the distributed
controllers.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import NamedTuple

import torch

from tpu_aerial_transport_torch.control.types import (
    EnvCBF,
    SolverStats,
    inactive_env_cbf,
)
from tpu_aerial_transport_torch.models.rqp import GRAVITY, RQPParams, RQPState
from tpu_aerial_transport_torch.obs import phases
from tpu_aerial_transport_torch.ops import lie, socp


@dataclass(frozen=True)
class RQPCentralizedConfig:
    """Controller constants (the JAX package's ``RQPCentralizedConfig``)."""

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
    dist_eps: float
    vision_radius: float
    alpha_env_cbf: float
    max_deceleration: float
    k_f: float
    k_m: float
    k_feq: float
    k_dvl: float
    k_dwl: float
    k_smooth: float = 0.0
    dt: float = 1e-3
    n_env_cbfs: int = 10
    solver_iters: int = 150
    solver_tol: float = 5e-3
    # Residual checks every this many inner iterations (0 = always run the
    # full solver_iters budget).
    solver_check_every: int = 25
    max_f_ang: float = math.pi / 6


def _cos32(x: float) -> torch.Tensor:
    """``cos`` taken in float32, as ``jnp.cos`` takes it in the JAX package."""
    return torch.cos(torch.tensor(x, dtype=torch.float32))


def make_config(
    params: RQPParams,
    collision_radius: float,
    max_deceleration: float,
    n_env_cbfs: int = 10,
    solver_iters: int = 150,
    max_f_ang: float = math.pi / 6.0,
    k_smooth: float = 0.0,
    dt: float = 1e-3,
) -> RQPCentralizedConfig:
    """Controller config (the JAX package's defaults; RQP: payload tilt at
    most 15 deg). The constants the JAX package computes with ``jnp`` in
    float32 are computed in float32 here too."""
    n = params.n
    mTg = float(params.mT) * GRAVITY
    return RQPCentralizedConfig(
        min_fz=mTg / (n * 10.0),
        sec_max_f_ang=float(1.0 / _cos32(max_f_ang)),
        max_f=2.0 * mTg / n,
        cos_max_p_ang=float(_cos32(math.pi / 12.0)),
        alpha1_p_cbf=1.0,
        alpha2_p_cbf=1.0,
        max_wl_sq=float((math.pi / 6.0) ** 2),
        alpha_wl_cbf=1.0,
        max_vl_sq=1.0,
        alpha_vl_cbf=1.0,
        dist_eps=0.1,
        vision_radius=collision_radius + 5.0,
        alpha_env_cbf=2.0,
        max_deceleration=max_deceleration,
        k_f=0.1,
        k_m=0.1,
        k_feq=0.1,
        k_dvl=1.0,
        k_dwl=1.0,
        k_smooth=k_smooth,
        dt=dt,
        n_env_cbfs=n_env_cbfs,
        solver_iters=solver_iters,
        max_f_ang=max_f_ang,
    )


def smooth_block(cfg, R_i: torch.Tensor, w_i: torch.Tensor) -> torch.Tensor:
    """Hessian block ``2 k_smooth Rq_orth Rq_orth^T`` of the optional
    force-smoothing cost, ``Rq = R_i exp3(w_i dt)``; batched over leading
    axes of ``R_i (..., 3, 3)`` and ``w_i (..., 3)``."""
    Rq = R_i @ lie.expm_so3(w_i * cfg.dt)
    Rq_orth = Rq[..., :, :2]
    return 2.0 * cfg.k_smooth * (Rq_orth @ Rq_orth.transpose(-1, -2))


def equilibrium_forces(params: RQPParams, alive=None) -> torch.Tensor:
    """Static equilibrium forces ``f_eq (n, 3)``: vertical thrusts that are
    the minimum-norm solution of the 3 x n wrench balance
    ``[1; (r_com_i x e3)_xy] fz = [mT g; 0; 0]``.

    The minimum-norm solution is taken in closed form,
    ``fz = W^T (W W^T)^-1 rhs`` (``W W^T`` is a well-conditioned 3 x 3), not
    with ``torch.linalg.lstsq``, which on CUDA (``gels`` only) does not
    return it.
    ``alive`` (optional ``(..., n)`` mask, e.g. one row per scenario) zeroes
    dead agents' columns and takes the pseudo-inverse, so the survivors
    carry the load; the result is then ``(..., n, 3)``. The pseudo-inverse
    is ``jnp.linalg.pinv``'s: singular values at most ``10 max(3, n) eps``
    of the largest are dropped, which decides the rank with two or fewer
    survivors (and gives zero thrusts when every agent is dead)."""
    n = params.n
    dtype, dev = params.r.dtype, params.r.device
    # (0, 0, 1) from a fill and a pad: no host-to-device copy a call.
    e3 = torch.nn.functional.pad(
        torch.ones((1,), dtype=dtype, device=dev), (2, 0))
    rxe = lie.cross(params.r_com, e3)
    wrench = torch.cat(
        [torch.ones((n, 1), dtype=dtype, device=dev), rxe[:, :2]], dim=1
    ).T
    rhs = torch.stack([
        params.mT * GRAVITY, torch.zeros((), dtype=dtype, device=dev),
        torch.zeros((), dtype=dtype, device=dev),
    ])
    if alive is None:
        fz = wrench.T @ torch.linalg.solve(wrench @ wrench.T, rhs)
    else:
        w = torch.as_tensor(alive, device=dev).to(dtype)
        fz = w * (_pinv(wrench * w[..., None, :]) @ rhs)
    return torch.cat(
        [torch.zeros(fz.shape + (2,), dtype=dtype, device=dev),
         fz[..., None]], dim=-1
    )


def _pinv(a: torch.Tensor) -> torch.Tensor:
    """``jnp.linalg.pinv(a)`` of a batch ``(..., m, k)``: its SVD with the
    singular values at or below ``10 max(m, k) eps`` times the largest
    dropped. On the card the SVD synchronises the host."""
    u, s, vh = torch.linalg.svd(a, full_matrices=False)
    rtol = 10.0 * max(a.shape[-2:]) * torch.finfo(a.dtype).eps
    s = torch.where(s > rtol * s[..., 0:1], s, torch.full_like(s, math.inf))
    return vh.mT @ (u.mT / s[..., None])


def qp_dims(n: int, n_env_cbfs: int):
    """The QP row layout ``(n_box, m, soc_dims)``. Box rows: [dyn-trans 3 |
    dyn-rot 3 | kin 3 | fz_min n | tilt 1 | wl 1 | vl 1 | env k]; then per
    agent two SOC(4) blocks (thrust cone, norm cap)."""
    n_box = 12 + n + n_env_cbfs
    soc_dims = (4,) * (2 * n)
    return n_box, n_box + sum(soc_dims), soc_dims


class CtrlState(NamedTuple):
    """Controller state across control steps: the previous forces (the
    fallback of a failed solve) and the solver's warm start. Leaves may
    carry a leading scenario axis."""

    prev_f: torch.Tensor  # (..., n, 3)
    warm: socp.SOCPSolution


def init_ctrl_state(params: RQPParams, cfg: RQPCentralizedConfig,
                    f_eq: torch.Tensor | None = None) -> CtrlState:
    """One scenario's initial state (no scenario axis): the equilibrium
    forces, and the warm start ``[0 | f_eq]`` with zero duals."""
    n = params.n
    _, m, _ = qp_dims(n, cfg.n_env_cbfs)
    if f_eq is None:
        f_eq = equilibrium_forces(params)
    kw = dict(dtype=f_eq.dtype, device=f_eq.device)
    warm = socp.SOCPSolution(
        x=torch.cat([torch.zeros((9,), **kw), f_eq.reshape(-1)]),
        y=torch.zeros((m,), **kw),
        z=torch.zeros((m,), **kw),
        prim_res=torch.zeros((), **kw),
        dual_res=torch.zeros((), **kw),
    )
    return CtrlState(prev_f=f_eq.clone(), warm=warm)


def solve_route(n: int, cfg: RQPCentralizedConfig) -> str:
    """The route the controller's solve runs at ``n`` agents
    (``ops.socp.runtime_fused_mode`` of ``"auto"`` at its shape): the JAX
    bench's ``fused_resolved`` label."""
    n_box, m, soc_dims = qp_dims(n, cfg.n_env_cbfs)
    return socp.runtime_fused_mode(
        "auto", 9 + 3 * n, m, n_box, soc_dims,
        check_every=cfg.solver_check_every, tol=cfg.solver_tol)


def _mv(M: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return (M @ v[..., None])[..., 0]


def _build_qp(params: RQPParams, cfg: RQPCentralizedConfig,
              f_eq: torch.Tensor, state: RQPState, acc_des, env_cbf: EnvCBF):
    """``(P, q, A, lb, ub, shift)`` of every scenario, shapes ``(S, ...)``
    (the JAX package's ``_build_qp`` under ``vmap``). Variable layout [dv_com
    0:3 | dvl 3:6 | dwl 6:9 | f 9:9+3n] (agent-major); rows as
    :func:`qp_dims` lays them out."""
    n = params.n
    nv = 9 + 3 * n
    dtype, dev = state.xl.dtype, state.xl.device
    kw = dict(dtype=dtype, device=dev)
    S = state.xl.shape[0]
    eye3 = torch.eye(3, **kw)
    e3 = torch.zeros(3, **kw)
    e3[2] = 1.0
    dvl_des, dwl_des = acc_des
    Rl = state.Rl  # (S, 3, 3)

    # Cost.
    P = torch.zeros((S, nv, nv), **kw)
    q = torch.zeros((S, nv), **kw)
    P[:, 3:6, 3:6] += 2.0 * cfg.k_dvl * eye3
    q[:, 3:6] += -2.0 * cfg.k_dvl * dvl_des
    P[:, 6:9, 6:9] += 2.0 * cfg.k_dwl * eye3
    q[:, 6:9] += -2.0 * cfg.k_dwl * dwl_des
    # Force blocks: Ssum = [I .. I] (3, 3n); G = [hat(r_com_i) Rl^T]_i.
    Ssum = eye3.repeat(1, n)
    G = (lie.hat(params.r_com)[None] @ Rl.transpose(-1, -2)[:, None]).permute(
        0, 2, 1, 3).reshape(S, 3, 3 * n)
    Pff = (
        2.0 * cfg.k_f * (Ssum.T @ Ssum)
        + 2.0 * cfg.k_m * (G.transpose(-1, -2) @ G)
        + 2.0 * cfg.k_feq * torch.eye(3 * n, **kw)
    )
    P[:, 9:, 9:] += Pff
    q[:, 9:] += (
        -2.0 * cfg.k_f * (params.mT * GRAVITY * e3).repeat(n)
        - 2.0 * cfg.k_feq * f_eq.reshape(-1)
    )
    # Force smoothing (default k_smooth = 0), block-diagonal over agents.
    blocks = smooth_block(cfg, state.R, state.w)  # (S, n, 3, 3)
    smooth = torch.zeros((S, 3 * n, 3 * n), **kw)
    for i in range(n):
        smooth[:, 3 * i:3 * i + 3, 3 * i:3 * i + 3] = blocks[:, i]
    P[:, 9:, 9:] += smooth

    # Box constraint rows.
    n_box, _, soc_dims = qp_dims(n, cfg.n_env_cbfs)
    A = torch.zeros((S, n_box, nv), **kw)
    lb = torch.zeros((S, n_box), **kw)
    ub = torch.zeros((S, n_box), **kw)
    # Dynamics translation: mT dv_com - sum_i f_i = -mT g e3.
    A[:, 0:3, 0:3] = params.mT * eye3
    A[:, 0:3, 9:] = -Ssum
    rhs = -params.mT * GRAVITY * e3
    lb[:, 0:3] = rhs
    ub[:, 0:3] = rhs
    # Dynamics rotation: dwl - JT_inv G f = -JT_inv (wl x JT wl).
    A[:, 3:6, 6:9] = eye3
    A[:, 3:6, 9:] = -params.JT_inv @ G
    rot_rhs = _mv(-params.JT_inv,
                  lie.cross(state.wl, _mv(params.JT, state.wl)))
    lb[:, 3:6] = rot_rhs
    ub[:, 3:6] = rot_rhs
    # Kinematics: dvl - dv_com - Rl hat(x_com) dwl = -Rl hat^2(wl) x_com.
    R_w_hat = Rl @ lie.hat(state.wl)
    R_w_hat_sq = Rl @ lie.hat_square(state.wl, state.wl)
    A[:, 6:9, 0:3] = -eye3
    A[:, 6:9, 3:6] = eye3
    A[:, 6:9, 6:9] = -Rl @ lie.hat(params.x_com)
    kin_rhs = _mv(-R_w_hat_sq, params.x_com)
    lb[:, 6:9] = kin_rhs
    ub[:, 6:9] = kin_rhs
    # f_z lower bounds (rows 9:9+n).
    for i in range(n):
        A[:, 9 + i, 9 + 3 * i + 2] = 1.0
    lb[:, 9:9 + n] = cfg.min_fz
    ub[:, 9:9 + n] = socp.INF
    # Payload tilt second-order CBF (row 9+n).
    r_tilt = 9 + n
    A[:, r_tilt, 6:9] = -(Rl[:, 2, None, :] @ lie.hat(e3))[:, 0]
    lb[:, r_tilt] = (
        -R_w_hat_sq[:, 2, 2]
        - (cfg.alpha1_p_cbf + cfg.alpha2_p_cbf) * R_w_hat[:, 2, 2]
        - cfg.alpha1_p_cbf * cfg.alpha2_p_cbf
        * (Rl[:, 2, 2] - cfg.cos_max_p_ang)
    )
    ub[:, r_tilt] = socp.INF
    # |wl| and |vl| CBFs (rows 10+n, 11+n).
    wl, vl = state.wl, state.vl
    A[:, 10 + n, 6:9] = -2.0 * wl
    lb[:, 10 + n] = -cfg.alpha_wl_cbf * (cfg.max_wl_sq
                                         - torch.sum(wl * wl, dim=-1))
    ub[:, 10 + n] = socp.INF
    A[:, 11 + n, 3:6] = -2.0 * vl
    lb[:, 11 + n] = -cfg.alpha_vl_cbf * (cfg.max_vl_sq
                                         - torch.sum(vl * vl, dim=-1))
    ub[:, 11 + n] = socp.INF
    # Env collision CBF rows (12+n : 12+n+k): lhs @ dvl >= rhs.
    r_env = 12 + n
    A[:, r_env:r_env + cfg.n_env_cbfs, 3:6] = env_cbf.lhs
    lb[:, r_env:r_env + cfg.n_env_cbfs] = env_cbf.rhs
    ub[:, r_env:r_env + cfg.n_env_cbfs] = socp.INF

    # SOC rows: per agent [sec30 f_z; f] (cone) + [max_f; f] (cap).
    soc = torch.zeros((8 * n, nv), **kw)
    shift_soc = torch.zeros((8 * n,), **kw)
    for i in range(n):
        base, fi = 8 * i, 9 + 3 * i
        soc[base, fi + 2] = cfg.sec_max_f_ang
        soc[base + 1:base + 4, fi:fi + 3] = eye3
        # Norm cap: the top element is the constant max_f (via the shift).
        shift_soc[base + 4] = cfg.max_f
        soc[base + 5:base + 8, fi:fi + 3] = eye3
    A_full = torch.cat([A, soc.expand(S, 8 * n, nv)], dim=1)
    shift = torch.cat(
        [torch.zeros((n_box,), **kw), shift_soc]).expand(S, n_box + 8 * n)
    A_full, lb, ub, shift, _ = socp.equilibrate_rows(
        A_full, lb, ub, shift, n_box, soc_dims
    )
    return P, q, A_full, lb, ub, shift


def control(
    params: RQPParams,
    cfg: RQPCentralizedConfig,
    f_eq: torch.Tensor,
    ctrl_state: CtrlState,
    state: RQPState,
    acc_des,
    env_cbf: EnvCBF | None = None,
):
    """One control step for ``S`` scenarios at once: ``-> (f_des (S, n, 3),
    CtrlState, SolverStats)``. ``ctrl_state``, ``state`` and ``env_cbf``
    carry the leading scenario axis; ``f_eq`` is shared, ``acc_des``
    shared (``(3,)`` each) or per scenario (``(S, 3)``).
    The QP is solved warm-started from the previous step; a scenario whose
    solve misses ``solver_tol`` (or is not finite) keeps its previous
    forces and warm start. ``SolverStats.iters`` is -1 (no consensus)."""
    n = params.n
    dtype, dev = state.xl.dtype, state.xl.device
    S = state.xl.shape[0]
    if env_cbf is None:
        base = inactive_env_cbf(cfg.n_env_cbfs, cfg.vision_radius,
                                cfg.dist_eps, cfg.alpha_env_cbf,
                                device=dev, dtype=dtype)
        env_cbf = EnvCBF(*(t.expand((S,) + t.shape) for t in (
            base.lhs, base.rhs, base.collision, base.min_dist)))
    with phases.scope(phases.QP_BUILD):
        P, q, A, lb, ub, shift = _build_qp(params, cfg, f_eq, state,
                                           acc_des, env_cbf)
    n_box, _, soc_dims = qp_dims(n, cfg.n_env_cbfs)
    with phases.scope(phases.LOCAL_SOLVE):
        sol = socp.solve_socp(
            P, q, A, lb, ub, n_box=n_box, soc_dims=soc_dims,
            iters=cfg.solver_iters, warm=ctrl_state.warm, shift=shift,
            check_every=cfg.solver_check_every, tol=cfg.solver_tol,
        )
    f = sol.x[:, 9:].reshape(S, n, 3)
    ok = (sol.prim_res < cfg.solver_tol) & torch.all(
        torch.isfinite(sol.x), dim=-1)
    f_out = torch.where(ok[:, None, None], f, ctrl_state.prev_f)
    # On failure keep the previous warm start too: warm-starting from a NaN
    # or garbage iterate would poison every later solve.
    warm = socp.SOCPSolution(
        x=torch.where(ok[:, None], sol.x, ctrl_state.warm.x),
        y=torch.where(ok[:, None], sol.y, ctrl_state.warm.y),
        z=torch.where(ok[:, None], sol.z, ctrl_state.warm.z),
        prim_res=sol.prim_res,
        dual_res=sol.dual_res,
    )
    stats = SolverStats(
        iters=torch.full((S,), -1, dtype=torch.int32, device=dev),
        solve_res=sol.prim_res,
        collision=env_cbf.collision,
        min_env_dist=env_cbf.min_dist,
        err_seq=torch.zeros((S, 0), dtype=dtype, device=dev),
        ok_frac=ok.to(dtype),
        fallback_rung=torch.zeros((S,), dtype=torch.int32, device=dev),
        agent_solve_res=torch.zeros((S, 0), dtype=dtype, device=dev),
        inner_iters=torch.zeros((S, 0), dtype=torch.int32, device=dev),
    )
    return f_out, CtrlState(prev_f=f_out, warm=warm), stats
