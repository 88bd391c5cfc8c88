"""Dual-decomposition distributed controller for the RQP model, batched over
Monte-Carlo scenarios.

Counterpart of ``tpu_aerial_transport/control/dd.py`` on the single-program,
nominal path, with fixed or adaptive solver effort. Each agent's primal holds
its own force ``f_i`` plus the aggregate-of-others force ``F_i`` and moment
``M_i`` (an 18-variable QP whatever n is), with a linear price cost
assembled from every agent's duals. The duals ascend by a quasi-Newton step:
per-agent strong-convexity matrices and the consensus matrix are
state-independent in the payload frame, so their inverse is precomputed once
(:class:`DDPlan`), and each control step only applies the dynamic leader's
rank-9 Woodbury correction.

All ``S x n`` agent QPs of one dual-ascent iteration are one batched solve
(``ops.socp.solve_socp``), i.e. one kernel launch on the card (route
``"kernel"``, float32 or bf16 operator storage by ``socp_precision``; the
operators are rounded once per control step), or one chunk-kernel launch
per chunk (route ``"pallas"``, where bf16 is inert).
The batched loop keeps the JAX package's vmapped ``while_loop`` semantics as
``control.cadmm`` does: it runs while any scenario's continue predicate
holds, and a scenario whose predicate was false keeps its carry.

Adaptive effort is gate-only by default: the solves run tolerance-chunked to
:data:`ADAPTIVE_GATE_TOL` (which a warm-started solve essentially never
reaches) and each scenario's solves are gated by its own continue predicate.
The quasi-Newton ascent is biased by tolerance-missed primal optima, so a
looser inner tolerance is opt-in through ``inner_tol``.

Agent sharding (``shards=d``; ``parallel.mesh`` and ``harness.rollout``
build the step) follows ``control.cadmm``: the price sums, the violation
sums, the residual max and the solve-success count become a reduction over
each block of agents, then an exchange over the shard axis (JAX
``dd.py:517-554``); each shard's agents read their shard's copy of a sum.
The dual gradient is gathered (``consensus_gather``), and each shard takes
its own rows of the 6n quasi-Newton step from its gathered copy.

The environment query resolves in ``control.cadmm.agent_env_cbfs_for``
from ``cfg.base.env_query`` (dense, or the forest grid's bucketed tier).
:func:`jit_control_step` is C-ADMM's twin with the quasi-Newton plan built
once.

Fault-aware control (``health=``; JAX ``dd.py:556-575``, ``:704-810``,
``:853-865``): each agent's network-visible price and force contributions
are its held values while its message is dropped and zero while it is
dead; the dead agents' primal, duals and warm starts freeze and their
violations are zeroed; dead agents apply no force; the ``held_*``
snapshots are updated at the end of the step. The quasi-Newton
preconditioner keeps its all-healthy cores.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import NamedTuple

import torch

from tpu_aerial_transport_torch.control import cadmm
from tpu_aerial_transport_torch.control.centralized import (
    equilibrium_forces,
    smooth_block,
)
from tpu_aerial_transport_torch.control.types import EnvCBF, SolverStats
from tpu_aerial_transport_torch.envs import forest as forest_mod
from tpu_aerial_transport_torch.models.rqp import (
    GRAVITY,
    RQPParams,
    RQPState,
    rqp_identity_state,
)
from tpu_aerial_transport_torch.obs import phases
from tpu_aerial_transport_torch.ops import lie, socp

# Stop tolerance of DD's gate-only adaptive-effort default (JAX dd.py:53).
ADAPTIVE_GATE_TOL = 1e-6


@dataclass(frozen=True)
class RQPDDConfig:
    """DD constants: every primal constant shared with C-ADMM (``base``),
    the dual-ascent regularization ``beta``, the primal-infeasibility stop
    and the strong-convexity floor."""

    base: cadmm.RQPCADMMConfig
    beta: float = 0.0
    prim_inf_tol: float = 1e-2
    sc_eps: float = 1e-6


def make_config(
    params: RQPParams,
    collision_radius: float,
    max_deceleration: float,
    n_env_cbfs: int = 10,
    max_iter: int = 100,
    inner_iters: int = 60,
    prim_inf_tol: float = 1e-2,
    k_smooth: float = 0.0,
    dt: float = 1e-3,
    socp_fused: str = "auto",
    socp_precision: str = "auto",
    inner_tol: float = 0.0,
    inner_check_every: int = 10,
    solve_retry_iters: int = 4,
    pad_operators: bool | None = None,
    effort: str = "auto",
    env_query: str = "auto",
    consensus_impl: str = "auto",
    track_agent_stats: bool = False,
    device="cuda",
) -> RQPDDConfig:
    """DD config on ``device``; the knobs resolve as in
    ``control.cadmm.make_config``. For warm-started receding-horizon use
    the inner-iteration knee is ~40 (the JAX bench's default)."""
    base = cadmm.make_base_config(
        params, collision_radius, max_deceleration, n_env_cbfs=n_env_cbfs,
        max_iter=max_iter, inner_iters=inner_iters, k_smooth=k_smooth, dt=dt,
        socp_fused=socp_fused, socp_precision=socp_precision,
        inner_tol=inner_tol, inner_check_every=inner_check_every,
        solve_retry_iters=solve_retry_iters, pad_operators=pad_operators,
        effort=effort, env_query=env_query, consensus_impl=consensus_impl,
        track_agent_stats=track_agent_stats, device=device,
    )
    return RQPDDConfig(base=base, prim_inf_tol=prim_inf_tol)


class DDState(NamedTuple):
    """Solver state across control steps. Leaves may carry a leading
    scenario axis."""

    f: torch.Tensor  # (..., n, 3) own forces.
    F: torch.Tensor  # (..., n, 3) aggregate-of-others forces.
    M: torch.Tensor  # (..., n, 3) aggregate-of-others moments.
    lam_F: torch.Tensor  # (..., n, 3) duals of the force consensus rows.
    lam_M: torch.Tensor  # (..., n, 3) duals of the moment consensus rows.
    warm: socp.SOCPSolution  # (..., n, ...) per-agent warm starts.
    # The values last delivered to the peers (fault-aware control only;
    # None in nominal use; see ``cadmm.CADMMState.held``).
    held_f: torch.Tensor | None = None  # (..., n, 3).
    held_lam_F: torch.Tensor | None = None
    held_lam_M: torch.Tensor | None = None


def _qp_dims(cfg: RQPDDConfig):
    """``(nv, n_box, nv_p, n_box_p, m_p)`` of one agent's QP; the ``_p``
    values are the tile bucket (equal to the raw dims without padding).
    Cone layout [box | 2 x SOC(4)]."""
    nv, n_box = 18, 13 + cfg.base.n_env_cbfs
    if cfg.base.pad_operators:
        nv_p, n_box_p = socp.padded_dims(nv, n_box, (4, 4))
    else:
        nv_p, n_box_p = nv, n_box
    return nv, n_box, nv_p, n_box_p, n_box_p + 8


def _mv(M: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return (M @ v[..., None])[..., 0]


def _moments_of(JT_inv: torch.Tensor, G: torch.Tensor,
                f: torch.Tensor) -> torch.Tensor:
    """``-JT_inv G_i f_i`` per agent: the aggregate-of-others moment an
    agent's own force ``f_i`` implies."""
    return -_mv(JT_inv, _mv(G, f))


def init_dd_state(params: RQPParams, cfg: RQPDDConfig,
                  f_eq: torch.Tensor | None = None) -> DDState:
    """One scenario's initial state (no scenario axis): the equilibrium
    forces and the aggregates they imply, zero duals, warm starts
    ``[0 | f_eq_i | F_i | M_i]`` in the (possibly padded) solve layout."""
    n = params.n
    if f_eq is None:
        f_eq = equilibrium_forces(params)
    dtype, dev = f_eq.dtype, f_eq.device
    F0 = torch.sum(f_eq, dim=0)[None, :] - f_eq
    M0 = _moments_of(params.JT_inv, lie.hat(params.r_com), f_eq)
    nv, _, nv_p, _, m_p = _qp_dims(cfg)
    x0 = torch.cat([torch.zeros((n, 9), dtype=dtype, device=dev), f_eq, F0,
                    M0], dim=1)
    warm = socp.SOCPSolution(
        x=torch.nn.functional.pad(x0, (0, nv_p - nv)),
        y=torch.zeros((n, m_p), dtype=dtype, device=dev),
        z=torch.zeros((n, m_p), dtype=dtype, device=dev),
        prim_res=torch.zeros((n,), dtype=dtype, device=dev),
        dual_res=torch.zeros((n,), dtype=dtype, device=dev),
    )
    return DDState(
        f=f_eq.clone(), F=F0, M=M0,
        lam_F=torch.zeros((n, 3), dtype=dtype, device=dev),
        lam_M=torch.zeros((n, 3), dtype=dtype, device=dev),
        warm=warm,
    )


def _build_agent_qp(params: RQPParams, cfg: cadmm.RQPCADMMConfig,
                    f_eq: torch.Tensor, state: RQPState, acc_des,
                    env_cbf: EnvCBF, is_leader: torch.Tensor):
    """Every agent's DD primal QP ``(P, q, A, lb, ub, shift)``, shapes
    ``(S, n, ...)``, for scenario-batched ``state`` (the JAX package's
    ``_build_agent_qp`` under ``vmap`` over agents and scenarios).

    Variables [dv_com 0:3 | dvl 3:6 | dwl 6:9 | f_i 9:12 | F_i 12:15 |
    M_i 15:18]. Box rows [dyn-trans 3 | dyn-rot 3 | kin 3 | fz 1 | tilt 1 |
    wl 1 | vl 1 | env k]; SOC: thrust cone + norm cap. The price vector
    enters through q (the caller adds it)."""
    n, nv = params.n, 18
    dtype, dev = state.xl.dtype, state.xl.device
    kw = dict(dtype=dtype, device=dev)
    S = state.xl.shape[0]
    eye3 = torch.eye(3, **kw)
    e3 = torch.zeros(3, **kw)
    # Single elements by fill_ here and below: a Python scalar written into
    # one element is copied from the host, a synchronisation on the card.
    e3[2].fill_(1.0)
    # Shared (3,) or per scenario (S, 3), as C-ADMM takes it.
    dvl_des, dwl_des = (a.expand(S, 3)[:, None, :] for a in acc_des)
    Rl = state.Rl  # (S, 3, 3)
    Gi = lie.hat(params.r_com)[None] @ Rl.transpose(-1, -2)[:, None]

    P = torch.zeros((S, n, nv, nv), **kw)
    q = torch.zeros((S, n, nv), **kw)
    k_dvl = cfg.k_dvl * is_leader  # (n,)
    k_dwl = cfg.k_dwl * is_leader
    P[..., 3:6, 3:6] += (2.0 * k_dvl)[:, None, None] * eye3
    q[..., 3:6] += (-2.0 * k_dvl)[:, None] * dvl_des
    P[..., 6:9, 6:9] += (2.0 * k_dwl)[:, None, None] * eye3
    q[..., 6:9] += (-2.0 * k_dwl)[:, None] * dwl_des

    # (k_f/n) ||f_i + F_i - mT g e3||^2 on blocks [f, F].
    Sf = torch.zeros((3, nv), **kw)
    Sf[:, 9:12] = eye3
    Sf[:, 12:15] = eye3
    P = P + 2.0 * cfg.k_f * (Sf.T @ Sf)
    q = q + (-2.0 * cfg.k_f) * (Sf.T @ (params.mT * GRAVITY * e3))
    # (k_m/n) ||M_i + hat(r_com_i) Rl^T f_i||^2.
    Sm = torch.zeros((S, n, 3, nv), **kw)
    Sm[..., 9:12] = Gi
    Sm[..., 15:18] = eye3
    P = P + 2.0 * cfg.k_m * (Sm.transpose(-1, -2) @ Sm)
    # k_feq ||f_i - fi_eq||^2, then the own-force smoothing cost.
    P[..., 9:12, 9:12] += 2.0 * cfg.k_feq * eye3
    q[..., 9:12] += -2.0 * cfg.k_feq * f_eq
    P[..., 9:12, 9:12] += smooth_block(cfg, state.R, state.w)

    n_box = 13 + cfg.n_env_cbfs
    A = torch.zeros((S, n, n_box, nv), **kw)
    lb = torch.zeros((S, n, n_box), **kw)
    ub = torch.zeros((S, n, n_box), **kw)
    # Dynamics translation: mT dv_com - f_i - F_i = -mT g e3.
    A[..., 0:3, 0:3] = params.mT * eye3
    A[..., 0:3, 9:12] = -eye3
    A[..., 0:3, 12:15] = -eye3
    rhs = -params.mT * GRAVITY * e3
    lb[..., 0:3] = rhs
    ub[..., 0:3] = rhs
    # Dynamics rotation: dwl - JT_inv (Gi f_i + M_i) = -JT_inv (wl x JT wl).
    A[..., 3:6, 6:9] = eye3
    A[..., 3:6, 9:12] = -params.JT_inv @ Gi
    A[..., 3:6, 15:18] = -params.JT_inv
    rot_rhs = _mv(-params.JT_inv,
                  lie.cross(state.wl, _mv(params.JT, state.wl)))
    lb[..., 3:6] = rot_rhs[:, None]
    ub[..., 3:6] = rot_rhs[:, None]
    # Kinematics.
    R_w_hat = Rl @ lie.hat(state.wl)
    R_w_hat_sq = Rl @ lie.hat_square(state.wl, state.wl)
    A[..., 6:9, 0:3] = -eye3
    A[..., 6:9, 3:6] = eye3
    A[..., 6:9, 6:9] = (-Rl @ lie.hat(params.x_com))[:, None]
    kin_rhs = _mv(-R_w_hat_sq, params.x_com)
    lb[..., 6:9] = kin_rhs[:, None]
    ub[..., 6:9] = kin_rhs[:, None]
    # f_z >= min_fz.
    A[..., 9, 11] = 1.0
    lb[..., 9] = cfg.min_fz
    ub[..., 9] = socp.INF
    # Tilt / |wl| / |vl| CBFs.
    A[..., 10, 6:9] = (-(Rl[:, 2, None, :] @ lie.hat(e3))[:, 0])[:, None]
    tilt_rhs = (
        -R_w_hat_sq[:, 2, 2]
        - (cfg.alpha1_p_cbf + cfg.alpha2_p_cbf) * R_w_hat[:, 2, 2]
        - cfg.alpha1_p_cbf * cfg.alpha2_p_cbf
        * (Rl[:, 2, 2] - cfg.cos_max_p_ang)
    )
    lb[..., 10] = tilt_rhs[:, None]
    ub[..., 10] = socp.INF
    wl, vl = state.wl, state.vl
    A[..., 11, 6:9] = (-2.0 * wl)[:, None]
    lb[..., 11] = (-cfg.alpha_wl_cbf
                   * (cfg.max_wl_sq - torch.sum(wl * wl, dim=-1)))[:, None]
    ub[..., 11] = socp.INF
    A[..., 12, 3:6] = (-2.0 * vl)[:, None]
    lb[..., 12] = (-cfg.alpha_vl_cbf
                   * (cfg.max_vl_sq - torch.sum(vl * vl, dim=-1)))[:, None]
    ub[..., 12] = socp.INF
    A[..., 13:13 + cfg.n_env_cbfs, 3:6] = env_cbf.lhs
    lb[..., 13:13 + cfg.n_env_cbfs] = env_cbf.rhs
    ub[..., 13:13 + cfg.n_env_cbfs] = socp.INF

    # SOC rows on f_i.
    soc = torch.zeros((8, nv), **kw)
    shift_soc = torch.zeros((8,), **kw)
    soc[0, 11].fill_(cfg.sec_max_f_ang)
    soc[1:4, 9:12] = eye3
    shift_soc[4].fill_(cfg.max_f)
    soc[5:8, 9:12] = eye3
    A_full = torch.cat([A, soc.expand(S, n, 8, nv)], dim=-2)
    shift = torch.cat(
        [torch.zeros((n_box,), **kw), shift_soc]).expand(S, n, n_box + 8)
    A_full, lb, ub, shift, _ = socp.equilibrate_rows(
        A_full, lb, ub, shift, n_box, (4, 4))
    return P, q, A_full, lb, ub, shift


def strong_convexity_matrix(params: RQPParams, cfg: cadmm.RQPCADMMConfig,
                            state: RQPState, r_com_i: torch.Tensor,
                            R_i: torch.Tensor, w_i: torch.Tensor,
                            is_leader: torch.Tensor,
                            eps: float) -> torch.Tensor:
    """Per-agent curvature lower bound over ``(f_i, F_i, M_i)`` ``(..., 9,
    9)``, batched over the leading axes of ``r_com_i``/``R_i``/``w_i``/
    ``is_leader`` (one scenario's ``state``): the sum of ``2 k C^T C`` for
    each quadratic cost term, with the dynamics equalities substituted so
    dvl and dwl are affine in ``(f_i, F_i, M_i)``."""
    dtype, dev = state.xl.dtype, state.xl.device
    batch = r_com_i.shape[:-1]
    eye = torch.eye(3, dtype=dtype, device=dev).expand(batch + (3, 3))
    zero = torch.zeros(batch + (3, 3), dtype=dtype, device=dev)
    mat = eps * torch.eye(9, dtype=dtype, device=dev).expand(batch + (9, 9))

    def add(mat, Cf, CF, CM, k):
        C = torch.cat([Cf, CF, CM], dim=-1)  # (..., 3, 9)
        if isinstance(k, torch.Tensor):
            k = k[..., None, None]
        return mat + 2.0 * k * (C.transpose(-1, -2) @ C)

    mat = add(mat, eye, zero, zero, cfg.k_feq)
    mat[..., 0:3, 0:3] += smooth_block(cfg, R_i, w_i)
    mat = add(mat, eye, eye, zero, cfg.k_f)
    Gi = lie.hat(r_com_i) @ state.Rl.transpose(-1, -2)
    mat = add(mat, Gi, zero, eye, cfg.k_m)
    # k_dwl (leader only): dwl = JT_inv Gi f + JT_inv M + const.
    coeff_dwl_f = params.JT_inv @ Gi
    mat = add(mat, coeff_dwl_f, zero, params.JT_inv.expand(batch + (3, 3)),
              cfg.k_dwl * is_leader)
    # k_dvl (leader only): dvl = f/mT + F/mT + Rl hat(x_com) dwl + const.
    Rx = state.Rl @ lie.hat(params.x_com)
    mat = add(mat, eye / params.mT + Rx @ coeff_dwl_f, eye / params.mT,
              (Rx @ params.JT_inv).expand(batch + (3, 3)),
              cfg.k_dvl * is_leader)
    return mat


def _consensus_matrix(params: RQPParams, Rl: torch.Tensor) -> torch.Tensor:
    """Global consensus constraint matrix ``(6n, 9n)``: row block i reads
    ``[F_i - sum_{j!=i} f_j ; M_i - sum_{j!=i} r_j x Rl^T f_j]`` off the
    stacked per-agent primal ``(f_j, F_j, M_j)``. ``Rl = I`` gives the
    payload-frame matrix (see :class:`DDPlan`)."""
    n = params.n
    dtype, dev = Rl.dtype, Rl.device
    G = lie.hat(params.r_com) @ Rl.T  # (n, 3, 3)
    I3 = torch.eye(3, dtype=dtype, device=dev)
    eyen = torch.eye(n, dtype=dtype, device=dev)
    offd = 1.0 - eyen
    blocks = torch.zeros((n, 2, 3, n, 3, 3), dtype=dtype, device=dev)
    # F rows: +I on F_i (var block 1), -I on every other f_j (block 0).
    blocks[:, 0, :, :, 1, :] = torch.einsum("ij,ab->iajb", eyen, I3)
    blocks[:, 0, :, :, 0, :] = torch.einsum("ij,ab->iajb", -offd, I3)
    # M rows: +I on M_i (block 2), -G_j on every other f_j (block 0).
    blocks[:, 1, :, :, 2, :] = torch.einsum("ij,ab->iajb", eyen, I3)
    blocks[:, 1, :, :, 0, :] = torch.einsum("ij,jab->iajb", -offd, G)
    return blocks.reshape(6 * n, 9 * n)


class DDPlan(NamedTuple):
    """State-independent quasi-Newton cores of the DD dual ascent, in the
    payload frame (primal blocks ``(Rl^T f_i, Rl^T F_i, M_i)``), where the
    strong-convexity matrices and the consensus matrix do not depend on the
    state; the dynamic leader's curvature enters per step as a rank-9
    Woodbury correction. The optional ``k_smooth`` curvature is left out of
    the preconditioner (a curvature lower bound; leaving out a PSD term
    only makes the steps more conservative)."""

    qn_inv_base: torch.Tensor  # (6n, 6n) inverse of Ac Qinv_base Ac^T + bI.
    D: torch.Tensor  # (n, 9, 9) Qinv_leader - Qinv_base per would-be leader.
    Ac: torch.Tensor  # (6n, 9n) payload-frame consensus matrix.


def _sym_inv(M: torch.Tensor) -> torch.Tensor:
    Minv = torch.linalg.inv(M)
    return 0.5 * (Minv + Minv.transpose(-1, -2))


def make_dd_plan(params: RQPParams, cfg: RQPDDConfig) -> DDPlan:
    """Precompute the payload-frame quasi-Newton cores (see
    :class:`DDPlan`), float32 on the params' device."""
    n = params.n
    dtype, dev = params.r.dtype, params.r.device
    frame = rqp_identity_state(n, device=dev)
    base = dataclasses.replace(cfg.base, k_smooth=0.0)

    def q_at(leader: float) -> torch.Tensor:
        return strong_convexity_matrix(
            params, base, frame, params.r_com, frame.R, frame.w,
            torch.full((n,), leader, dtype=dtype, device=dev), cfg.sc_eps)

    Qinv_base = _sym_inv(q_at(0.0))
    Qinv_lead = _sym_inv(q_at(1.0))
    Ac = _consensus_matrix(params, torch.eye(3, dtype=dtype, device=dev))
    AQinv = torch.einsum("mnj,njk->mnk", Ac.reshape(6 * n, n, 9),
                         Qinv_base).reshape(6 * n, 9 * n)
    qn = AQinv @ Ac.T + cfg.beta * torch.eye(6 * n, dtype=dtype, device=dev)
    return DDPlan(qn_inv_base=_sym_inv(qn), D=Qinv_lead - Qinv_base, Ac=Ac)


def _leader_qn_inverse(plan: DDPlan, leader_idx: int, n: int) -> torch.Tensor:
    """``(B + A_l D A_l^T)^-1`` by Woodbury without ``D^-1``: ``P - P A_l
    (I + D A_l^T P A_l)^-1 D A_l^T P`` with ``P`` the base inverse; no
    leader (an index outside [0, n)) leaves it unchanged."""
    has_leader = 1.0 if 0 <= leader_idx < n else 0.0
    li = min(max(leader_idx, 0), n - 1)
    A_l = plan.Ac[:, 9 * li:9 * li + 9]
    Dl = plan.D[li] * has_leader
    Pb = plan.qn_inv_base
    PA = Pb @ A_l  # (6n, 9)
    K9 = torch.eye(9, dtype=Pb.dtype, device=Pb.device) + Dl @ (A_l.T @ PA)
    qn_inv = Pb - PA @ torch.linalg.solve(K9, Dl @ PA.T)
    return 0.5 * (qn_inv + qn_inv.T)


def control(
    params: RQPParams,
    cfg: RQPDDConfig,
    f_eq: torch.Tensor,
    dd_state: DDState,
    state: RQPState,
    acc_des,
    forest: forest_mod.Forest | None = None,
    shards: int = 1,
    plan: DDPlan | None = None,
    health=None,
):
    """One DD control step for ``S`` scenarios at once: ``-> (f (S, n, 3),
    DDState, SolverStats)``. ``dd_state`` and ``state`` carry the leading
    scenario axis; ``f_eq`` (n, 3), ``forest`` and ``plan`` are shared;
    ``acc_des`` is shared (``(3,)`` each) or per scenario (``(S, 3)``).
    Pass ``plan=make_dd_plan(...)`` to build the quasi-Newton cores once
    outside a rollout. ``shards=d`` shards the agents into d
    blocks (the module docstring; ``parallel.mesh.dd_control_sharded``).
    ``health``: a ``resilience.faults.FaultStep`` (masks ``(S, n)`` or
    ``(n,)``), the fault-aware step of the module docstring; ``f_eq`` may
    then be ``(S, n, 3)``."""
    n = params.n
    base = cfg.base
    dtype, dev = state.xl.dtype, state.xl.device
    S = dd_state.f.shape[0]
    blocks = cadmm._AgentBlocks(n, shards, base.consensus_impl)
    agent_ids = torch.arange(n, device=dev)

    if health is not None:
        # The fault masks (JAX dd.py:556-575).
        alive = health.alive.expand(S, n)
        msg_ok = health.msg_ok.expand(S, n)
        w_alive = alive.to(dtype)[..., None]  # (S, n, 1)
        # Dead agents anchor to zero force; their aggregates follow.
        f_eq = f_eq * w_alive
        # The peers' view of a dropped agent: its last delivered values.
        lamF_stale = (dd_state.held_lam_F if dd_state.held_lam_F is not None
                      else dd_state.lam_F)
        lamM_stale = (dd_state.held_lam_M if dd_state.held_lam_M is not None
                      else dd_state.lam_M)
        f_stale = (dd_state.held_f if dd_state.held_f is not None
                   else dd_state.f)

    with phases.scope(phases.CBF_ROWS):
        env_cbfs = cadmm.agent_env_cbfs_for(params, base, forest, state,
                                            params.r)
    leaders = (agent_ids == base.leader_idx).to(dtype)

    with phases.scope(phases.QP_BUILD):
        P, q0, A, lb, ub, shift = _build_agent_qp(
            params, base, f_eq, state, acc_des, env_cbfs, leaders)
        _, n_box_raw, _, n_box, m = _qp_dims(cfg)
        if base.pad_operators:
            P, q0, A, lb, ub, shift = socp.pad_qp(
                P, q0, A, lb, ub, shift, n_box=n_box_raw, soc_dims=(4, 4))
        rho_vec = socp.make_rho_vec(m, n_box, lb, ub, 0.4)
        op = socp.kkt_operator(P, A, rho_vec)
        # bf16 storage: rounded once per control step, not per solve.
        route = socp.runtime_fused_mode(base.socp_fused, A.shape[-1], m,
                                        n_box, (4, 4))
        op, A, P = socp.stored_operators(op, A, P, base.socp_precision,
                                         route)

    if plan is None:
        plan = make_dd_plan(params, cfg)
    qn_inv = _leader_qn_inverse(plan, base.leader_idx, n)

    Rl = state.Rl
    RlT = Rl.transpose(-1, -2)
    hat_r = lie.hat(params.r_com)  # (n, 3, 3)
    G = hat_r[None] @ RlT[:, None]  # (S, n, 3, 3): hat(r_i) Rl^T.
    Rl_hat = Rl[:, None] @ hat_r[None]  # (S, n, 3, 3): Rl hat(r_i).

    # Solver effort: gate-only by default under "adaptive" (the module
    # docstring; JAX dd.py:630-681).
    adaptive = base.effort == "adaptive"
    if adaptive:
        inner_tol = base.inner_tol if base.inner_tol > 0 else ADAPTIVE_GATE_TOL
    else:
        inner_tol = base.inner_tol
    check_every = base.inner_check_every if inner_tol > 0 else 0

    # Solver-failure fallbacks: equilibrium forces and the aggregates they
    # imply.
    fallback_F = torch.sum(f_eq, dim=-2, keepdim=True) - f_eq
    fallback_M = _moments_of(params.JT_inv, G, f_eq)  # (S, n, 3)

    retry_cap = base.solve_retry_iters or base.max_iter
    steps = torch.arange(base.max_iter + 1, device=dev)

    def continue_pred(it, err, ok_last, fail_count):
        return (((err >= cfg.prim_inf_tol)
                 | ((ok_last < 1.0) & (fail_count <= retry_cap)))
                & (it <= base.max_iter))

    def dd_iter(carry, active):
        """One dual-ascent iteration of every scenario; ``active`` is each
        scenario's continue predicate, the adaptive-effort gate."""
        (f, F, M, lam_F, lam_M, warm, it, err, err_buf, okf, _ok_last,
         fail_count) = carry[:12]
        # Price assembly: the sums of the other agents' duals.
        with phases.scope(phases.CONSENSUS):
            # Each agent reads its own shard's copy of the sums. Under
            # faults an agent's network-visible price is its held value
            # while dropped and zero while dead.
            if health is None:
                lamF_eff, lamM_eff = lam_F, lam_M
            else:
                lamF_eff = torch.where(msg_ok[..., None], lam_F,
                                       lamF_stale) * w_alive
                lamM_eff = torch.where(msg_ok[..., None], lam_M,
                                       lamM_stale) * w_alive
            sum_lF = blocks.per_agent(blocks.sum(lamF_eff))
            sum_lM = blocks.per_agent(blocks.sum(lamM_eff))
            c_f = -(sum_lF - lamF_eff) + _mv(Rl_hat, sum_lM - lamM_eff)
            q = q0.clone()
            q[..., 9:12] += c_f
            q[..., 12:15] += lam_F
            q[..., 15:18] += lam_M
        with phases.scope(phases.LOCAL_SOLVE):
            out = socp.solve_socp(
                P, q, A, lb, ub, n_box=n_box, soc_dims=(4, 4),
                iters=base.inner_iters, warm=warm, shift=shift, op=op,
                fused=base.socp_fused, precision=base.socp_precision,
                check_every=check_every, tol=inner_tol,
                active=active[:, None].expand(S, n) if adaptive else None,
                report_iters=adaptive,
            )
            sols, eff = out if adaptive else (out, None)
        x = sols.x
        ok = (sols.prim_res < base.solver_tol) & torch.all(
            torch.isfinite(x), dim=-1)
        okc = ok[..., None]
        f_new = torch.where(okc, x[..., 9:12], f_eq)
        F_new = torch.where(okc, x[..., 12:15], fallback_F)
        M_new = torch.where(okc, x[..., 15:18], fallback_M)
        if health is not None:
            # The dead freeze at their last pre-death primal and never
            # trigger retries; their warm starts freeze too.
            dead_keep = alive[..., None]
            f_new = torch.where(dead_keep, f_new, f)
            F_new = torch.where(dead_keep, F_new, F)
            M_new = torch.where(dead_keep, M_new, M)
            ok = ok | ~alive
        # Warm starts keep any finite iterate (tolerance-missed included).
        finite = socp.solution_is_finite(sols)
        if health is not None:
            finite = finite & alive
        warm_new = socp.SOCPSolution(*(
            torch.where(finite.reshape(finite.shape + (1,) * (a.dim() - 2)),
                        a, b)
            for a, b in zip(sols, warm)
        ))
        # Primal infeasibility: the consensus violations.
        with phases.scope(phases.CONSENSUS):
            # Under faults the sums read each agent's network-visible
            # force, and the dead's violations are zeroed.
            if health is None:
                f_c = f_new
            else:
                f_c = torch.where(msg_ok[..., None], f_new, f_stale) \
                    * w_alive
            moments = _mv(G, f_c)
            sum_f = blocks.per_agent(blocks.sum(f_c))
            sum_m = blocks.per_agent(blocks.sum(moments))
            err_F = F_new - (sum_f - f_c)
            err_M = M_new - (sum_m - moments)
            if health is not None:
                err_F = err_F * w_alive
                err_M = err_M * w_alive
            # Exact: the same on every shard.
            err_new = blocks.max(torch.maximum(torch.abs(err_F),
                                               torch.abs(err_M)))
        err_buf = torch.where(steps[None] == it[:, None], err_new[:, None],
                              err_buf)
        it = it + 1
        # Quasi-Newton dual ascent, gated like the reference loop: skipped
        # when converged or past the cap. The F-violations rotate into the
        # payload frame of the precomputed basis and the F-step back.
        with phases.scope(phases.DUAL_UPDATE):
            viol = torch.cat([err_F @ Rl, err_M], dim=-1)  # (S, n, 6)
            if blocks.sharded:
                # Each shard's gathered copy of the whole dual gradient
                # (exact, so the same on every shard) against its own rows
                # of the quasi-Newton inverse.
                grad = blocks.gather(viol).flatten(2)  # (d, S, 6n)
                rows = qn_inv.reshape(blocks.d, 6 * blocks.n_local, 6 * n)
                step = _mv(rows[:, None], grad).movedim(0, 1).reshape(
                    S, n, 6)
            else:
                step = _mv(qn_inv, viol.reshape(S, -1)).reshape(S, n, 6)
            do_dual = ((err_new >= cfg.prim_inf_tol)
                       & (it <= base.max_iter))[:, None, None]
            lam_F_new = torch.where(do_dual, lam_F + step[..., :3] @ RlT,
                                    lam_F)
            lam_M_new = torch.where(do_dual, lam_M + step[..., 3:], lam_M)
            if health is not None:
                # Frozen duals for dead agents.
                lam_F_new = torch.where(alive[..., None], lam_F_new, lam_F)
                lam_M_new = torch.where(alive[..., None], lam_M_new, lam_M)
        # A sum of 0/1 flags: exact, the same on every shard.
        ok_last = blocks.sum(ok.to(dtype))[:, 0] / n
        okf = torch.minimum(okf, ok_last)
        fail_count = torch.where(ok_last < 1.0, fail_count + 1,
                                 torch.zeros_like(fail_count))
        new = (f_new, F_new, M_new, lam_F_new, lam_M_new, warm_new, it,
               err_new, err_buf, okf, ok_last, fail_count)
        if adaptive:
            new = new + (carry[12] + blocks.count(eff),)
        return new

    carry = (
        dd_state.f, dd_state.F, dd_state.M, dd_state.lam_F, dd_state.lam_M,
        dd_state.warm,
        torch.zeros((S,), dtype=torch.int32, device=dev),
        torch.full((S,), math.inf, dtype=dtype, device=dev),
        torch.full((S, base.max_iter + 1), math.nan, dtype=dtype, device=dev),
        torch.ones((S,), dtype=dtype, device=dev),
        torch.ones((S,), dtype=dtype, device=dev),
        torch.zeros((S,), dtype=torch.int32, device=dev),
    )
    if adaptive:
        # The inner-iteration totals by shard.
        carry = carry + (torch.zeros((S, blocks.d), dtype=torch.int32,
                                     device=dev),)
    # The vmapped while_loop, written out (see control.cadmm).
    while True:
        active = continue_pred(carry[6], carry[7], carry[10], carry[11])
        # The loop's exit test: the one deliberate host read an iteration.
        if not bool(active.any()):  # torchlint: disable=TL001,TL005
            break
        new = dd_iter(carry, active)
        carry = tuple(cadmm._where(active, a, b) for a, b in zip(new, carry))
    (f, F, M, lam_F, lam_M, warm, iters, err, err_buf, ok_frac, _,
     _) = carry[:12]

    if health is not None:
        # The delivered-snapshot update (see control.cadmm).
        ok_m = msg_ok[..., None]
        held = (torch.where(ok_m, f, f_stale),
                torch.where(ok_m, lam_F, lamF_stale),
                torch.where(ok_m, lam_M, lamM_stale))
    else:
        held = (dd_state.held_f, dd_state.held_lam_F, dd_state.held_lam_M)
    new_state = DDState(f=f, F=F, M=M, lam_F=lam_F, lam_M=lam_M, warm=warm,
                        held_f=held[0], held_lam_F=held[1],
                        held_lam_M=held[2])
    if health is not None:
        f = f * w_alive  # dead agents actuate nothing.
    stats = SolverStats(
        iters=iters,
        solve_res=err,
        collision=blocks.max(env_cbfs.collision.to(torch.int32)) > 0,
        min_env_dist=blocks.min(env_cbfs.min_dist),
        err_seq=err_buf,
        ok_frac=ok_frac,
        fallback_rung=torch.zeros((S,), dtype=torch.int32, device=dev),
        agent_solve_res=torch.zeros((S, 0), dtype=dtype, device=dev),
        inner_iters=(blocks.total(carry[12]) if adaptive else
                     torch.zeros((S, 0), dtype=torch.int32, device=dev)),
    )
    if base.track_agent_stats:
        stats = stats.replace(agent_solve_res=blocks.agent_values(
            warm.prim_res))
    return f, new_state, stats


def jit_control_step(params: RQPParams, cfg: RQPDDConfig, f_eq: torch.Tensor,
                     forest: forest_mod.Forest | None = None,
                     plan: DDPlan | None = None, donate: bool = True):
    """``step(dd_state, state, acc_des) -> (f, dd_state, stats)``,
    :func:`control` with the plan built once; ``donate`` as in
    ``control.cadmm.jit_control_step``."""
    if plan is None:
        plan = make_dd_plan(params, cfg)

    def step(dd_state, state, acc_des):
        return control(params, cfg, f_eq, dd_state, state, acc_des, forest,
                       plan=plan)

    return cadmm.donated_step(step, donate)
