"""Consensus-ADMM distributed controller for the RQP model, batched over
Monte-Carlo scenarios.

Counterpart of ``tpu_aerial_transport/control/cadmm.py`` on the single-program,
nominal path, with fixed or adaptive solver effort. ``n`` agents each hold a
local copy of all forces; per consensus iteration every agent solves its
primal conic QP, the copies are averaged, and the duals ascend while the
residual is above ``res_tol``.

Two agent-QP formulations (``reduced_qp``; None picks by n):

- n >= 4: each agent's QP is Schur-reduced to 12 variables (``SchurPlan``):
  the other agents' force columns carry no constraints of their own and
  are eliminated in closed form, then rebuilt for the consensus step;
- n < 4 (or ``reduced_qp=False``): the full (9 + 3n)-variable QP, whose
  force columns are the agent's copy of every force (at n = 3 the
  elimination's coupling block is singular).

All ``S x n`` agent QPs of one consensus iteration are one batched solve
(``ops.socp.solve_socp``): on the card, one launch of the whole-solve
kernel (route ``"kernel"``, fixed-iteration or early-exit form, float32 or
bf16 operator storage by ``socp_precision``) or one launch of the chunk
kernel per chunk (route ``"pallas"``, where bf16 is inert).

The consensus penalty follows the schedule ``rho_k = min(rho0 tau_incr^k,
rho_max)`` (constant at the default ``tau_incr = 1``): the agent QPs, their
KKT operators and the Schur plan are built once per control step for every
rho the schedule visits, and each consensus iteration picks its own. With
``inner_iters_warm`` the first consensus iteration's solves run
``inner_iters`` iterations and the later ones ``inner_iters_warm``.

Solver effort (``effort``): ``"fixed"`` runs every agent solve for
``inner_iters`` iterations (or tolerance-chunked to ``inner_tol`` when that
is set). ``"adaptive"`` runs them tolerance-chunked (to ``inner_tol``, else
``solver_tol``) and gates each scenario's solves with that scenario's own
consensus continue predicate, so a converged scenario's solves pass their
warm starts through at 0 iterations while the loop drains the stragglers;
the iterations spent land on ``SolverStats.inner_iters``.

Batching: every state leaf carries a leading scenario axis ``S``. The
consensus loop keeps the JAX package's vmapped ``while_loop`` semantics
explicitly: it runs while any scenario's continue predicate holds, every
scenario's iteration is computed, and a scenario whose predicate was false
keeps its carry (``torch.where`` on every carry leaf). The ``any`` test is
one host synchronisation per consensus iteration.

Agent sharding (``shards=d``; ``parallel.mesh`` and ``harness.rollout``
build the step): the agents form d contiguous blocks of ``n / d``, the
shards of the JAX package's ``shard_map``, written out as an explicit axis
on one card. The per-agent work stays one batched program over all ``S x n``
lanes; only the cross-agent reductions change: each is a reduction over a
block, then an exchange over the shard axis through
``parallel.ring.consensus_exchange`` by ``cfg.consensus_impl``. Each shard
keeps its own copy of an exchanged sum inside the step (under
``"pallas_ring"`` the copies may differ in their last bits) and its agents
read that copy; the carried ``f_mean`` is shard 0's, as the JAX package's
replicated ``out_specs`` gives. With ``shards=1`` no exchange runs.

Environment query (``env_query``, ``envs/spatial.py``): one braking-capsule
sweep a scenario, over every tree slot ("dense") or over the forest grid's
candidate slab ("bucketed"; "auto" picks by the world's slot count), then
each agent's vision-cone mask and nearest rows; both tiers give the same
bits.

Runtime setters (:func:`set_leader`, :func:`unset_leader`,
:func:`set_tolerance`, :func:`set_max_iter`) return a new config, for
C-ADMM's and for DD's (through its ``base``). :func:`jit_control_step`
builds the plan once and returns the step a receding-horizon caller calls
period after period.

Fault-aware control (``health=``, a ``resilience.faults.FaultStep`` with
``(S, n)`` or shared ``(n,)`` masks; JAX ``cadmm.py:1094-1120``,
``:1339-1410``, ``:1466-1477``): dead agents' columns are zeroed in every
copy and their rows, duals and warm starts frozen; a dropped agent's peers
read its ``held`` copy (its last delivered one); the mean divides by the
alive count; the residual is taken over the fresh delivered copies only;
dead agents apply no force; ``held`` is updated at the end of the step.
``f_eq`` may then be per scenario, ``(S, n, 3)``. With
``track_agent_stats`` the stats carry every agent's exit-time QP residual.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Callable, NamedTuple

import numpy as np
import torch

from tpu_aerial_transport_torch import resolve_device
from tpu_aerial_transport_torch.control.centralized import smooth_block
from tpu_aerial_transport_torch.control.types import (
    EnvCBF,
    SolverStats,
    inactive_env_cbf,
)
from tpu_aerial_transport_torch.envs import forest as forest_mod
from tpu_aerial_transport_torch.envs import spatial as spatial_mod
from tpu_aerial_transport_torch.harness.bucketing import bucket_dim
from tpu_aerial_transport_torch.models.rqp import GRAVITY, RQPParams, RQPState
from tpu_aerial_transport_torch.obs import phases
from tpu_aerial_transport_torch.ops import lie, socp
from tpu_aerial_transport_torch.parallel import ring
from tpu_aerial_transport_torch.tree import leaves


@dataclass(frozen=True)
class RQPCADMMConfig:
    """Controller constants; ``k_f``/``k_m`` are already divided by n."""

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
    vision_cone_ang: float
    k_f: float
    k_m: float
    k_feq: float
    k_dvl: float
    k_dwl: float
    # Consensus penalty schedule rho_k = min(rho0 tau_incr^k, rho_max).
    rho0: float = 1.0
    tau_incr: float = 1.0
    rho_max: float = 2.0
    res_tol: float = 1e-2
    leader_idx: int = 0
    k_smooth: float = 0.0
    dt: float = 1e-3
    n_env_cbfs: int = 10
    max_iter: int = 100
    inner_iters: int = 60
    # Inner budget of consensus iterations >= 2 (0 = inner_iters).
    inner_iters_warm: int = 0
    # Agent-QP formulation: None = Schur-reduced for n >= 4, full below.
    reduced_qp: bool | None = None
    solver_tol: float = 5e-3
    # Consensus iterations may continue past agreement while an agent's
    # solve fails, for at most this many consecutive failing iterations.
    solve_retry_iters: int = 4
    # The route of the inner solves (ops/socp.py): "kernel" (the whole
    # solve in one kernel launch) or "pallas" (w2 and residuals in plain
    # ops, the iterations through the chunk kernel). On the CPU either
    # route runs its kernels' plain versions.
    socp_fused: str = "kernel"
    # Operator storage of route "kernel" ("f32" | "bf16"; ops/socp.py
    # resolve_precision), inert on route "pallas".
    socp_precision: str = "f32"
    # Tolerance-chunked inner solves: with inner_tol > 0 each agent QP runs
    # chunks of inner_check_every iterations until both residuals are at
    # most inner_tol, capped at inner_iters. 0 = fixed-iteration solves.
    inner_tol: float = 0.0
    inner_check_every: int = 10
    # Consensus-level solver effort, resolved ("fixed" | "adaptive"; see
    # ops/socp.py resolve_effort and the module docstring).
    effort: str = "fixed"
    # Pad every agent QP edge to a multiple of socp.SUBLANE_TILE (exact).
    pad_operators: bool = True
    env_query: str = "dense"
    # The cross-shard exchange of an agent-sharded step, resolved
    # (parallel/ring.py resolve_consensus); single-program steps never
    # exchange.
    consensus_impl: str = "allreduce"
    # SolverStats.agent_solve_res carries every agent's exit-time QP
    # residual (the run-health telemetry's per-agent view).
    track_agent_stats: bool = False


def _cos32(x: float) -> torch.Tensor:
    """``cos`` taken in float32, as ``jnp.cos`` takes it in the JAX package."""
    return torch.cos(torch.tensor(x, dtype=torch.float32))


def _rho_schedule(cfg: RQPCADMMConfig) -> list[float]:
    """The distinct penalties ``rho_k = min(rho0 tau_incr^k, rho_max)`` the
    consensus loop can visit before saturating (the JAX package's
    ``_rho_schedule``): one value at ``tau_incr = 1``."""
    if cfg.tau_incr < 1.0:
        raise ValueError(
            f"tau_incr={cfg.tau_incr} < 1: the schedule only ever increases "
            "rho toward rho_max; a decaying schedule is not supported"
        )
    rhos = [float(cfg.rho0)]
    if cfg.tau_incr > 1.0:
        while rhos[-1] < cfg.rho_max and len(rhos) <= cfg.max_iter:
            rhos.append(min(rhos[-1] * cfg.tau_incr, cfg.rho_max))
    return rhos


def _use_reduced(cfg: RQPCADMMConfig, n: int) -> bool:
    """The agent-QP formulation: Schur-reduced, or the full QP."""
    return cfg.reduced_qp if cfg.reduced_qp is not None else n >= 4


def make_config(
    params: RQPParams,
    collision_radius: float,
    max_deceleration: float,
    n_env_cbfs: int = 10,
    max_iter: int = 100,
    inner_iters: int = 60,
    res_tol: float = 1e-2,
    inner_iters_warm: int = 0,
    reduced_qp: bool | None = None,
    k_smooth: float = 0.0,
    dt: float = 1e-3,
    rho0: float = 1.0,
    tau_incr: float = 1.0,
    rho_max: float = 2.0,
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
) -> RQPCADMMConfig:
    """Controller config for the C-ADMM path on ``device``.

    ``pad_operators=None`` resolves to True on the card and False on the CPU
    (the JAX package's backend default); ``socp_fused="auto"`` resolves to
    the ``"kernel"`` route (``ops.socp.resolve_route``), ``effort="auto"``
    and ``socp_precision="auto"`` as ``ops.socp.resolve_effort`` and
    ``resolve_precision`` say, and ``consensus_impl="auto"`` as
    ``parallel.ring.resolve_consensus`` says. Constants the JAX package
    computes with ``jnp`` in float32 (``sec_max_f_ang``,
    ``cos_max_p_ang``) are computed in float32 here too. ``tau_incr < 1``
    is a ValueError."""
    base = make_base_config(
        params, collision_radius, max_deceleration, n_env_cbfs=n_env_cbfs,
        max_iter=max_iter, inner_iters=inner_iters, res_tol=res_tol,
        k_smooth=k_smooth, dt=dt, rho0=rho0, socp_fused=socp_fused,
        socp_precision=socp_precision, inner_tol=inner_tol,
        inner_check_every=inner_check_every,
        solve_retry_iters=solve_retry_iters, pad_operators=pad_operators,
        effort=effort, env_query=env_query, consensus_impl=consensus_impl,
        track_agent_stats=track_agent_stats, device=device,
    )
    cfg = dataclasses.replace(
        base, tau_incr=tau_incr, rho_max=rho_max,
        inner_iters_warm=inner_iters_warm, reduced_qp=reduced_qp,
    )
    _rho_schedule(cfg)  # tau_incr < 1 raises here, at config build.
    return cfg


def make_base_config(
    params: RQPParams,
    collision_radius: float,
    max_deceleration: float,
    *,
    n_env_cbfs: int = 10,
    max_iter: int = 100,
    inner_iters: int = 60,
    res_tol: float = 1e-2,
    k_smooth: float = 0.0,
    dt: float = 1e-3,
    rho0: float = 1.0,
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
) -> RQPCADMMConfig:
    """The constants C-ADMM and DD share (DD's ``base``), without C-ADMM's
    own formulation checks; see :func:`make_config` for the knobs."""
    dev = resolve_device(device)
    n = params.n
    if inner_check_every < 1:
        raise ValueError(f"inner_check_every={inner_check_every} < 1")
    mTg = float(params.mT) * GRAVITY
    return RQPCADMMConfig(
        min_fz=mTg / (n * 10.0),
        sec_max_f_ang=float(1.0 / _cos32(math.pi / 6.0)),
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
        alpha_env_cbf=1.5,
        max_deceleration=max_deceleration,
        vision_cone_ang=float(100.0 * math.pi / 180.0),
        k_f=0.1 / n,
        k_m=0.1 / n,
        k_feq=0.1,
        k_dvl=1.0,
        k_dwl=1.0,
        rho0=rho0,
        res_tol=res_tol,
        k_smooth=k_smooth,
        dt=dt,
        n_env_cbfs=n_env_cbfs,
        max_iter=max_iter,
        inner_iters=inner_iters,
        socp_fused=socp.resolve_route(socp_fused),
        socp_precision=socp.resolve_precision(socp_precision),
        inner_tol=inner_tol,
        inner_check_every=inner_check_every,
        effort=socp.resolve_effort(effort),
        solve_retry_iters=solve_retry_iters,
        pad_operators=(dev.type == "cuda") if pad_operators is None
        else bool(pad_operators),
        env_query=spatial_mod.resolve_env_query(env_query),
        consensus_impl=ring.resolve_consensus(consensus_impl, dev),
        track_agent_stats=track_agent_stats,
    )


def set_leader(cfg, leader_idx: int):
    """The config with agent ``leader_idx`` alone carrying the tracking
    cost; C-ADMM's config or DD's (through its ``base``)."""
    if hasattr(cfg, "base"):
        return dataclasses.replace(
            cfg, base=dataclasses.replace(cfg.base, leader_idx=leader_idx))
    return dataclasses.replace(cfg, leader_idx=leader_idx)


def unset_leader(cfg):
    """No agent carries the tracking cost: the team holds its formation."""
    return set_leader(cfg, -1)


def set_tolerance(cfg, res_tol: float):
    """The consensus tolerance; on DD's config also its primal
    infeasibility stop."""
    if hasattr(cfg, "base"):
        return dataclasses.replace(
            cfg, base=dataclasses.replace(cfg.base, res_tol=res_tol),
            prim_inf_tol=res_tol)
    return dataclasses.replace(cfg, res_tol=res_tol)


def set_max_iter(cfg, max_iter: int):
    """The consensus iteration cap (it sizes ``SolverStats.err_seq``)."""
    if hasattr(cfg, "base"):
        return dataclasses.replace(
            cfg, base=dataclasses.replace(cfg.base, max_iter=max_iter))
    return dataclasses.replace(cfg, max_iter=max_iter)


class CADMMState(NamedTuple):
    """Solver state carried across control steps: ``f[.., i, j]`` is agent
    i's copy of agent j's force. Leaves may carry a leading scenario axis."""

    f: torch.Tensor  # (..., n, n, 3).
    lam: torch.Tensor  # (..., n, n, 3) duals.
    f_mean: torch.Tensor  # (..., n, 3) consensus mean.
    warm: socp.SOCPSolution  # (..., n, ...) per-agent warm starts.
    # The copies last delivered to the peers (fault-aware control only;
    # None in nominal use): under message dropout the peers read a dropped
    # agent's copy from here, frozen until its next delivered step.
    held: torch.Tensor | None = None  # (..., n, n, 3).


def _qp_dims(cfg: RQPCADMMConfig, n: int):
    """``(nv, n_box, nv_p, n_box_p, m_p)`` of one agent's QP (reduced: 12
    variables; full: 9 + 3n); the ``_p`` values are the tile bucket (equal
    to the raw dims without padding). Cone layout [box | 2 x SOC(4)]."""
    if _use_reduced(cfg, n):
        nv, n_box = 12, 7 + cfg.n_env_cbfs
    else:
        nv, n_box = 9 + 3 * n, 13 + cfg.n_env_cbfs
    if cfg.pad_operators:
        nv_p, n_box_p = socp.padded_dims(nv, n_box, (4, 4))
    else:
        nv_p, n_box_p = nv, n_box
    return nv, n_box, nv_p, n_box_p, n_box_p + 8


def init_cadmm_state(params: RQPParams, cfg: RQPCADMMConfig,
                     f_eq: torch.Tensor | None = None) -> CADMMState:
    """One scenario's initial state (no scenario axis): every copy at the
    equilibrium forces, zero duals, warm starts ``[0 | f_eq_i]`` (reduced)
    or ``[0 | f_eq]`` (full QP) in the (possibly padded) solve layout."""
    from tpu_aerial_transport_torch.control.centralized import (
        equilibrium_forces,
    )

    n = params.n
    if f_eq is None:
        f_eq = equilibrium_forces(params)
    dtype, dev = f_eq.dtype, f_eq.device
    nv, _, nv_p, _, m_p = _qp_dims(cfg, n)
    if _use_reduced(cfg, n):
        x0 = torch.cat([torch.zeros((n, 9), dtype=dtype, device=dev), f_eq],
                       dim=1)
    else:
        x0 = torch.cat([torch.zeros((9,), dtype=dtype, device=dev),
                        f_eq.reshape(-1)]).repeat(n, 1)
    warm = socp.SOCPSolution(
        x=torch.nn.functional.pad(x0, (0, nv_p - nv)),
        y=torch.zeros((n, m_p), dtype=dtype, device=dev),
        z=torch.zeros((n, m_p), dtype=dtype, device=dev),
        prim_res=torch.zeros((n,), dtype=dtype, device=dev),
        dual_res=torch.zeros((n,), dtype=dtype, device=dev),
    )
    return CADMMState(
        f=f_eq.expand(n, n, 3).clone(),
        lam=torch.zeros((n, n, 3), dtype=dtype, device=dev),
        f_mean=f_eq.clone(),
        warm=warm,
    )


class SchurPlan(NamedTuple):
    """State-independent Schur-elimination cores of the reduced agent QP in
    the payload-frame force parametrization (see the JAX package's
    ``SchurPlan`` for the derivation). Leaf axes ``(n_rho, n, ...)``; the
    eliminated-block axis ``V = 3 (n - 1)`` may be tile-padded."""

    J: torch.Tensor  # (.., V, 6)
    N: torch.Tensor  # (.., V, V)
    Yinv: torch.Tensor  # (.., 6, 6)
    Eu: torch.Tensor  # (.., 6, 3)
    Mu: torch.Tensor  # (.., 3, V)
    NCt: torch.Tensor  # (.., V, 3)
    Nsum: torch.Tensor  # (.., V, 3)
    Jsum: torch.Tensor  # (.., 3, 6)
    Musum: torch.Tensor  # (.., 3, 3)
    CJ: torch.Tensor  # (.., 3, 6)
    YinvEu: torch.Tensor  # (.., 6, 3)
    UUcore: torch.Tensor  # (.., 3, 3)
    CUcore: torch.Tensor  # (.., 6, 3)
    perm: torch.Tensor  # (.., n) int64: [own agent, others...].
    inv_perm: torch.Tensor  # (.., n) int64.
    scale: torch.Tensor  # (.., 6) equality-row equilibration.


def make_plan(params: RQPParams, cfg: RQPCADMMConfig) -> SchurPlan | None:
    """The precomputed Schur plan for ``control(plan=...)`` when the reduced
    formulation is active for this (cfg, n), else None (the full QP needs
    no plan)."""
    if not _use_reduced(cfg, params.n):
        return None
    return make_schur_plan(params, cfg)


def _sym(M: torch.Tensor) -> torch.Tensor:
    return 0.5 * (M + M.transpose(-1, -2))


def make_schur_plan(params: RQPParams, cfg: RQPCADMMConfig) -> SchurPlan:
    """Elimination cores for every agent and every rho the schedule visits
    (the leading ``n_rho`` axis), float32, on the params' device."""
    n = params.n
    if n < 4:
        raise ValueError(
            f"the Schur-reduced formulation needs n >= 4 (n={n}): at n = 3 "
            "the coupling block E_v is singular; use the full QP "
            "(reduced_qp=False, the n < 4 default)")
    dtype, dev = params.r.dtype, params.r.device
    kw = dict(dtype=dtype, device=dev)
    V = 3 * (n - 1)
    eye3 = torch.eye(3, **kw)

    def one_agent(agent_id: int, rho: torch.Tensor):
        others = [j for j in range(n) if j != agent_id]
        perm = torch.tensor([agent_id] + others, dtype=torch.int64, device=dev)
        hat_perm = lie.hat(params.r_com[perm])
        hat_u, hat_v = hat_perm[0], hat_perm[1:]
        Sv = eye3.repeat(1, n - 1)  # (3, V)
        Gv = torch.cat(list(hat_v), dim=1)  # (3, V)
        Qvv = (
            2.0 * cfg.k_f * (Sv.T @ Sv) + 2.0 * cfg.k_m * (Gv.T @ Gv)
            + rho * torch.eye(V, **kw)
        )
        C = 2.0 * cfg.k_f * Sv + 2.0 * cfg.k_m * (hat_u.T @ Gv)
        Ev = torch.cat([-Sv, -params.JT_inv @ Gv], dim=0)
        Eu = torch.cat([-eye3, -params.JT_inv @ hat_u], dim=0)
        # Row equilibration; the norms are the same for every agent (the
        # rows hold hat(r_j) of every agent, in another column order).
        Ecc_proxy = torch.zeros((6, 9), **kw)
        Ecc_proxy[0:3, 0:3] = params.mT * eye3
        Ecc_proxy[3:6, 6:9] = eye3
        rows = torch.cat([Ecc_proxy, Eu, Ev], dim=1)
        scale = 1.0 / torch.sqrt(torch.sum(rows * rows, dim=1))
        Ev = Ev * scale[:, None]
        Eu = Eu * scale[:, None]

        L = _sym(torch.linalg.inv(Qvv))
        EvL = Ev @ L
        Y = EvL @ Ev.T
        Yinv = _sym(torch.linalg.inv(_sym(Y)))
        J = EvL.T @ Yinv
        N = _sym(L - J @ EvL)
        NCt = N @ C.T
        Nsum = torch.sum(N.reshape(V, n - 1, 3), dim=1)
        Jsum = torch.sum(J.reshape(n - 1, 3, 6), dim=0)
        Mu = C @ N + Eu.T @ J.T
        Musum = C @ Nsum + Eu.T @ Jsum.T
        CJ = C @ J
        YinvEu = Yinv @ Eu
        sym_term = C @ (J @ Eu)
        UUcore = (
            Eu.T @ YinvEu - C @ NCt - (sym_term + sym_term.T)
            + 2.0 * cfg.k_m * (hat_u.T @ hat_u)
        )
        CUcore = YinvEu - J.T @ C.T
        return SchurPlan(
            J=J, N=N, Yinv=Yinv, Eu=Eu, Mu=Mu, NCt=NCt, Nsum=Nsum,
            Jsum=Jsum, Musum=Musum, CJ=CJ, YinvEu=YinvEu, UUcore=UUcore,
            CUcore=CUcore, perm=perm, inv_perm=torch.argsort(perm),
            scale=scale,
        )

    per_rho = []
    for r in _rho_schedule(cfg):
        rho = torch.tensor(r, **kw)
        agents = [one_agent(a, rho) for a in range(n)]
        per_rho.append([torch.stack(f) for f in zip(*agents)])
    plan = SchurPlan(*(torch.stack(f) for f in zip(*per_rho)))
    if cfg.pad_operators:
        pv = bucket_dim(V, socp.SUBLANE_TILE) - V

        def padv(x, axes):
            pads = []
            for a in reversed(range(x.dim())):
                pads += [0, pv if a in axes else 0]
            return torch.nn.functional.pad(x, pads)

        plan = plan._replace(
            J=padv(plan.J, (2,)), N=padv(plan.N, (2, 3)),
            Mu=padv(plan.Mu, (3,)), NCt=padv(plan.NCt, (2,)),
            Nsum=padv(plan.Nsum, (2,)),
        )
    scale = plan.scale.cpu().numpy()
    assert np.allclose(scale, scale[:, :1], rtol=1e-4, atol=0.0), (
        "equality-row equilibration is no longer agent-invariant"
    )
    return plan


def _mv(M: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Broadcasting matrix-vector product ``M (..., r, c) v (..., c)``."""
    return (M @ v[..., None])[..., 0]


def _e3(dtype, dev) -> torch.Tensor:
    """``[0, 0, 1]`` built on the device (no host-to-device copy)."""
    e3 = torch.zeros(3, dtype=dtype, device=dev)
    e3[2] = 1.0
    return e3


def _schur_state_pieces(params: RQPParams, cfg: RQPCADMMConfig,
                        state: RQPState, scale: torch.Tensor):
    """Per-step, agent-shared pieces: the scaled payload-frame equality
    block on c ``(S, 6, 9)``, its rhs ``(S, 6)`` and ``q~_v0`` ``(S, 3)``."""
    dtype, dev = state.xl.dtype, state.xl.device
    e3 = _e3(dtype, dev)
    Rt = state.Rl.transpose(-1, -2)
    batch = Rt.shape[:-2]
    Ecc = torch.zeros(batch + (6, 9), dtype=dtype, device=dev)
    Ecc[..., 0:3, 0:3] = params.mT * Rt
    Ecc[..., 3:6, 6:9] = torch.eye(3, dtype=dtype, device=dev)
    Ecc = Ecc * scale[:, None]
    e0s = scale * torch.cat(
        [_mv(Rt, -params.mT * GRAVITY * e3),
         _mv(-params.JT_inv,
             lie.cross(state.wl, _mv(params.JT, state.wl)))], dim=-1,
    )
    xq = -2.0 * cfg.k_f * params.mT * GRAVITY * _mv(Rt, e3)
    return Ecc, e0s, xq


def _schur_step_qp(params: RQPParams, cfg: RQPCADMMConfig, pk: SchurPlan,
                   f_eq: torch.Tensor, state: RQPState, acc_des,
                   env_cbf: EnvCBF, is_leader: torch.Tensor, rho,
                   Ecc: torch.Tensor, e0s: torch.Tensor, xq: torch.Tensor):
    """Every agent's reduced 12-variable QP ``(P, q0, A, lb, ub, shift)``,
    shapes ``(S, n, ...)``, from the plan slice ``pk`` (leaves ``(n, ...)``)
    and the per-step pieces (leaves ``(S, ...)``)."""
    n = params.n
    dtype, dev = state.xl.dtype, state.xl.device
    kw = dict(dtype=dtype, device=dev)
    S = state.xl.shape[0]
    dvl_des, dwl_des = (a.expand(S, 3)[:, None, :] for a in acc_des)
    e3 = _e3(dtype, dev)
    eye3 = torch.eye(3, **kw)
    Rl = state.Rl[:, None]  # (S, 1, 3, 3)
    RlT = Rl.transpose(-1, -2)
    EccT = Ecc.transpose(-1, -2)[:, None]  # (S, 1, 9, 6)
    Ecc_a = Ecc[:, None]

    # Reduced Hessian.
    k_dvl = cfg.k_dvl * is_leader  # (n,)
    k_dwl = cfg.k_dwl * is_leader
    P_cc = torch.zeros((n, 9, 9), **kw)
    P_cc[:, 3:6, 3:6] = (2.0 * k_dvl)[:, None, None] * eye3
    P_cc[:, 6:9, 6:9] = (2.0 * k_dwl)[:, None, None] * eye3
    H_cc = P_cc + EccT @ pk.Yinv @ Ecc_a
    H_uu = (
        (2.0 * cfg.k_f + 2.0 * cfg.k_feq + rho) * eye3
        + Rl @ pk.UUcore @ RlT
        + smooth_block(cfg, state.R, state.w)
    )
    H_cu = EccT @ pk.CUcore @ RlT
    P_red = torch.cat([
        torch.cat([H_cc, H_cu], dim=-1),
        torch.cat([H_cu.transpose(-1, -2), H_uu], dim=-1),
    ], dim=-2)
    P_red = 0.5 * (P_red + P_red.transpose(-1, -2))

    # Static linear term.
    zeros3 = torch.zeros((S, n, 3), **kw)
    q_c0 = torch.cat([
        zeros3,
        (-2.0 * k_dvl)[:, None] * dvl_des,
        (-2.0 * k_dwl)[:, None] * dwl_des,
    ], dim=-1)
    q_u0 = (
        -2.0 * cfg.k_f * params.mT * GRAVITY * e3
        - 2.0 * cfg.k_feq * f_eq
    )
    xq_a, e0s_a = xq[:, None], e0s[:, None]
    q_red0 = torch.cat([
        q_c0 - _mv(EccT, _mv(pk.Jsum.transpose(-1, -2), xq_a)
                   + _mv(pk.Yinv, e0s_a)),
        q_u0 + _mv(Rl, _mv(-pk.Musum, xq_a) + _mv(pk.CJ, e0s_a)
                   - _mv(pk.YinvEu.transpose(-1, -2), e0s_a)),
    ], dim=-1)

    # Constraint rows on z = [c | u].
    n_box = 7 + cfg.n_env_cbfs
    A = torch.zeros((S, n, n_box, 12), **kw)
    lb = torch.zeros((S, n, n_box), **kw)
    ub = torch.zeros((S, n, n_box), **kw)
    Rls, wl, vl = state.Rl, state.wl, state.vl
    R_w_hat = Rls @ lie.hat(wl)
    R_w_hat_sq = Rls @ lie.hat_square(wl, wl)
    # CoM -> payload-point kinematics equality.
    A[..., 0:3, 0:3] = -eye3
    A[..., 0:3, 3:6] = eye3
    A[..., 0:3, 6:9] = (-Rls @ lie.hat(params.x_com))[:, None]
    kin_rhs = _mv(-R_w_hat_sq, params.x_com)
    lb[..., 0:3] = kin_rhs[:, None]
    ub[..., 0:3] = kin_rhs[:, None]
    # Own f_z lower bound.
    A[..., 3, 11] = 1.0
    lb[..., 3] = cfg.min_fz
    ub[..., 3] = socp.INF
    # Payload tilt second-order CBF.
    A[..., 4, 6:9] = (-(Rls[:, 2, None, :] @ lie.hat(e3))[:, 0])[:, None]
    tilt_rhs = (
        -R_w_hat_sq[:, 2, 2]
        - (cfg.alpha1_p_cbf + cfg.alpha2_p_cbf) * R_w_hat[:, 2, 2]
        - cfg.alpha1_p_cbf * cfg.alpha2_p_cbf
        * (Rls[:, 2, 2] - cfg.cos_max_p_ang)
    )
    lb[..., 4] = tilt_rhs[:, None]
    ub[..., 4] = socp.INF
    # Angular-velocity norm CBF.
    A[..., 5, 6:9] = (-2.0 * wl)[:, None]
    lb[..., 5] = (-cfg.alpha_wl_cbf
                  * (cfg.max_wl_sq - torch.sum(wl * wl, dim=-1)))[:, None]
    ub[..., 5] = socp.INF
    # Velocity norm CBF.
    A[..., 6, 3:6] = (-2.0 * vl)[:, None]
    lb[..., 6] = (-cfg.alpha_vl_cbf
                  * (cfg.max_vl_sq - torch.sum(vl * vl, dim=-1)))[:, None]
    ub[..., 6] = socp.INF
    # Environment collision CBFs.
    A[..., 7:7 + cfg.n_env_cbfs, 3:6] = env_cbf.lhs
    lb[..., 7:7 + cfg.n_env_cbfs] = env_cbf.rhs
    ub[..., 7:7 + cfg.n_env_cbfs] = socp.INF
    # SOC rows: own thrust cone + own norm cap.
    soc = torch.zeros((8, 12), **kw)
    shift_soc = torch.zeros((8,), **kw)
    soc[0, 11] = cfg.sec_max_f_ang
    soc[1:4, 9:12] = eye3
    shift_soc[4] = cfg.max_f
    soc[5:8, 9:12] = eye3

    A_full = torch.cat([A, soc.expand(S, n, 8, 12)], dim=-2)
    shift = torch.cat(
        [torch.zeros((n_box,), **kw), shift_soc]
    ).expand(S, n, n_box + 8)
    A_full, lb, ub, shift, _ = socp.equilibrate_rows(
        A_full, lb, ub, shift, n_box, (4, 4)
    )
    return P_red, q_red0, A_full, lb, ub, shift


def _build_agent_qp(params: RQPParams, cfg: RQPCADMMConfig,
                    f_eq: torch.Tensor, state: RQPState, acc_des,
                    env_cbf: EnvCBF, is_leader: torch.Tensor, rho):
    """Every agent's full (9 + 3n)-variable QP ``(P, q0, A, lb, ub,
    shift)``, shapes ``(S, n, ...)`` (the JAX package's ``_build_agent_qp``
    under ``vmap`` over agents and scenarios).

    Variables [dv_com 0:3 | dvl 3:6 | dwl 6:9 | f_1..f_n 9:9+3n], the
    agent's copy of every force. Box rows [dyn-trans 3 | dyn-rot 3 | kin 3 |
    own fz 1 | tilt 1 | wl 1 | vl 1 | env k]; SOC: own thrust cone + own
    norm cap. The consensus quadratic ``(rho/2)||f||^2`` is in P; the
    caller adds the iteration's ``lam - rho f_mean`` to q's force part."""
    n = params.n
    nv = 9 + 3 * n
    dtype, dev = state.xl.dtype, state.xl.device
    kw = dict(dtype=dtype, device=dev)
    S = state.xl.shape[0]
    dvl_des, dwl_des = (a.expand(S, 3)[:, None, :] for a in acc_des)
    e3 = _e3(dtype, dev)
    eye3 = torch.eye(3, **kw)
    Rl = state.Rl  # (S, 3, 3)
    onehot = torch.eye(n, **kw)  # row i: agent i.
    own = onehot.repeat_interleave(3, dim=1)  # (n, 3n) own force columns.
    fz_row = own * e3.repeat(n)  # (n, 3n) own f_z column.
    own_block = (onehot[:, None, :, None] * eye3[None, :, None, :]).reshape(
        n, 3, 3 * n)  # kron(onehot_i, I3).

    P = torch.zeros((S, n, nv, nv), **kw)
    q = torch.zeros((S, n, nv), **kw)
    k_dvl = cfg.k_dvl * is_leader  # (n,)
    k_dwl = cfg.k_dwl * is_leader
    P[..., 3:6, 3:6] += (2.0 * k_dvl)[:, None, None] * eye3
    q[..., 3:6] += (-2.0 * k_dvl)[:, None] * dvl_des
    P[..., 6:9, 6:9] += (2.0 * k_dwl)[:, None, None] * eye3
    q[..., 6:9] += (-2.0 * k_dwl)[:, None] * dwl_des

    Ssum = eye3.repeat(1, n)  # (3, 3n)
    # G = [hat(r_com_i) Rl^T]_i, (S, 3, 3n).
    G = (lie.hat(params.r_com)[None] @ Rl.transpose(-1, -2)[:, None]).permute(
        0, 2, 1, 3).reshape(S, 3, 3 * n)
    Pff = (
        (2.0 * cfg.k_f * (Ssum.T @ Ssum)
         + 2.0 * cfg.k_m * (G.transpose(-1, -2) @ G))[:, None]
        + 2.0 * cfg.k_feq * torch.diag_embed(own)
        + rho * torch.eye(3 * n, **kw)  # (rho/2)||f||^2.
    )
    # Own-column force-smoothing cost (default k_smooth = 0).
    blocks = smooth_block(cfg, state.R, state.w)  # (S, n, 3, 3)
    smooth = torch.zeros((S, n, 3 * n, 3 * n), **kw)
    for i in range(n):
        smooth[:, i, 3 * i:3 * i + 3, 3 * i:3 * i + 3] = blocks[:, i]
    P[..., 9:, 9:] += Pff + smooth
    q[..., 9:] += (
        -2.0 * cfg.k_f * (params.mT * GRAVITY * e3).repeat(n)
        - 2.0 * cfg.k_feq * own * f_eq.flatten(-2).unsqueeze(-2)
    )

    n_box = 13 + cfg.n_env_cbfs
    A = torch.zeros((S, n, n_box, nv), **kw)
    lb = torch.zeros((S, n, n_box), **kw)
    ub = torch.zeros((S, n, n_box), **kw)
    # Dynamics translation: mT dv_com - sum f = -mT g e3.
    A[..., 0:3, 0:3] = params.mT * eye3
    A[..., 0:3, 9:] = -Ssum
    rhs = -params.mT * GRAVITY * e3
    lb[..., 0:3] = rhs
    ub[..., 0:3] = rhs
    # Dynamics rotation: dwl - JT_inv G f = -JT_inv (wl x JT wl).
    A[..., 3:6, 6:9] = eye3
    A[..., 3:6, 9:] = (-params.JT_inv @ G)[:, None]
    rot_rhs = _mv(-params.JT_inv,
                  lie.cross(state.wl, _mv(params.JT, state.wl)))
    lb[..., 3:6] = rot_rhs[:, None]
    ub[..., 3:6] = rot_rhs[:, None]
    # CoM -> payload-point kinematics.
    R_w_hat = Rl @ lie.hat(state.wl)
    R_w_hat_sq = Rl @ lie.hat_square(state.wl, state.wl)
    A[..., 6:9, 0:3] = -eye3
    A[..., 6:9, 3:6] = eye3
    A[..., 6:9, 6:9] = (-Rl @ lie.hat(params.x_com))[:, None]
    kin_rhs = _mv(-R_w_hat_sq, params.x_com)
    lb[..., 6:9] = kin_rhs[:, None]
    ub[..., 6:9] = kin_rhs[:, None]
    # Own f_z lower bound.
    A[..., 9, 9:] = fz_row
    lb[..., 9] = cfg.min_fz
    ub[..., 9] = socp.INF
    # Payload tilt second-order CBF.
    A[..., 10, 6:9] = (-(Rl[:, 2, None, :] @ lie.hat(e3))[:, 0])[:, None]
    tilt_rhs = (
        -R_w_hat_sq[:, 2, 2]
        - (cfg.alpha1_p_cbf + cfg.alpha2_p_cbf) * R_w_hat[:, 2, 2]
        - cfg.alpha1_p_cbf * cfg.alpha2_p_cbf
        * (Rl[:, 2, 2] - cfg.cos_max_p_ang)
    )
    lb[..., 10] = tilt_rhs[:, None]
    ub[..., 10] = socp.INF
    # Angular-velocity and velocity norm CBFs.
    wl, vl = state.wl, state.vl
    A[..., 11, 6:9] = (-2.0 * wl)[:, None]
    lb[..., 11] = (-cfg.alpha_wl_cbf
                   * (cfg.max_wl_sq - torch.sum(wl * wl, dim=-1)))[:, None]
    ub[..., 11] = socp.INF
    A[..., 12, 3:6] = (-2.0 * vl)[:, None]
    lb[..., 12] = (-cfg.alpha_vl_cbf
                   * (cfg.max_vl_sq - torch.sum(vl * vl, dim=-1)))[:, None]
    ub[..., 12] = socp.INF
    # Environment collision CBFs.
    A[..., 13:13 + cfg.n_env_cbfs, 3:6] = env_cbf.lhs
    lb[..., 13:13 + cfg.n_env_cbfs] = env_cbf.rhs
    ub[..., 13:13 + cfg.n_env_cbfs] = socp.INF
    # SOC rows: own thrust cone [sec30 fz; f_own], own norm cap [max_f; f_own].
    soc = torch.zeros((n, 8, nv), **kw)
    shift_soc = torch.zeros((8,), **kw)
    soc[:, 0, 9:] = cfg.sec_max_f_ang * fz_row
    soc[:, 1:4, 9:] = own_block
    shift_soc[4] = cfg.max_f
    soc[:, 5:8, 9:] = own_block

    A_full = torch.cat([A, soc.expand(S, n, 8, nv)], dim=-2)
    shift = torch.cat(
        [torch.zeros((n_box,), **kw), shift_soc]).expand(S, n, n_box + 8)
    A_full, lb, ub, shift, _ = socp.equilibrate_rows(
        A_full, lb, ub, shift, n_box, (4, 4)
    )
    return P, q, A_full, lb, ub, shift


def agent_env_cbfs_for(params: RQPParams, cfg: RQPCADMMConfig,
                       forest: forest_mod.Forest | None, state: RQPState,
                       r_block: torch.Tensor) -> EnvCBF:
    """Vision-cone-masked collision CBF rows ``(S, n_block, k, ...)`` for the
    agents attached at ``r_block (n_block, 3)``: one braking-capsule sweep
    per scenario (dense or bucketed by ``cfg.env_query``), then each
    agent's camera cone mask and top-k rows."""
    n = r_block.shape[0]
    xl, vl, Rl = state.xl, state.vl, state.Rl
    S = xl.shape[0]
    if forest is None:
        base = inactive_env_cbf(
            cfg.n_env_cbfs, cfg.vision_radius, cfg.dist_eps,
            cfg.alpha_env_cbf, device=xl.device, dtype=xl.dtype,
        )
        return EnvCBF(*(t.expand((S, n) + t.shape).clone() for t in (
            base.lhs, base.rhs, base.collision, base.min_dist)))

    collision_radius = cfg.vision_radius - 5.0
    cap_a, cap_b, cap_h, speed, cap_dir = forest_mod.braking_capsule(
        xl, vl, collision_radius, cfg.max_deceleration
    )
    if spatial_mod.runtime_env_query(cfg.env_query, forest) == "bucketed":
        # One slab gather a scenario; the cone masks run over its (S, K)
        # candidates.
        data, centers, _ = spatial_mod.bucketed_distance(
            forest, cap_a, cap_b, collision_radius, cfg.vision_radius,
            n_rows=cfg.n_env_cbfs,
        )
        centers = centers[:, None]  # (S, 1, K, 3) against (S, n) cameras.
    else:
        data = forest_mod.capsule_forest_distance(
            forest, cap_a, cap_b, collision_radius, cfg.vision_radius
        )
        centers = forest.tree_pos

    camera = (xl[:, None] + _mv(Rl[:, None], r_block))[..., :2]  # (S, n, 2)
    d = camera - xl[:, None, :2]
    norm = torch.sqrt(torch.sum(d * d, dim=-1))
    direction = d / torch.where(norm > 0, norm, torch.ones_like(norm))[
        ..., None]
    mask = forest_mod.cone_mask_at(centers, camera, direction,
                                   cfg.vision_cone_ang)
    # Degenerate bearing (attachment above the payload center): flag a
    # collision and disable the rows.
    mask = mask & (norm > 0)[..., None]
    per_agent = forest_mod.DistanceData(
        dists=data.dists[:, None], pts_sys=data.pts_sys[:, None],
        pts_env=data.pts_env[:, None], normal_out=data.normal_out[:, None],
        mask=data.mask[:, None], collision=data.collision[:, None],
        min_dist=data.min_dist[:, None],
    )
    cbf = forest_mod.cbf_rows_from_distance(
        per_agent, xl[:, None], vl[:, None], cap_h[:, None], speed[:, None],
        cap_dir[:, None], cfg.max_deceleration, cfg.vision_radius,
        cfg.dist_eps, cfg.alpha_env_cbf, cfg.n_env_cbfs, extra_mask=mask,
    )
    return cbf.replace(collision=cbf.collision | (norm == 0))


def agent_env_cbfs(params: RQPParams, cfg: RQPCADMMConfig,
                   forest: forest_mod.Forest | None,
                   state: RQPState) -> EnvCBF:
    """Per-agent vision-cone CBF rows ``(S, n, k, ...)`` of all n agents."""
    return agent_env_cbfs_for(params, cfg, forest, state, params.r)


def check_shards(n: int, shards: int) -> None:
    """ValueError unless ``shards`` is a shard count that divides the ``n``
    agents."""
    if shards < 1 or n % shards:
        raise ValueError(
            f"shards={shards}: n = {n} agents do not divide into that many "
            "shards")


class _AgentBlocks:
    """The agents of one control step as ``d`` contiguous blocks of
    ``n_local``, one block a shard (d = 1 and no exchange for a
    single-program step), and the cross-agent reductions over them: a
    reduction over each block, then an exchange over the shard axis
    (JAX ``cadmm.py:1062-1086``). Per-agent tensors are ``(S, n, ...)``;
    per-shard copies are ``(S, d, ...)``."""

    def __init__(self, n: int, shards: int, impl: str):
        check_shards(n, shards)
        self.sharded = shards > 1
        self.d = shards
        self.n_local = n // self.d
        self.impl = impl

    def blocks(self, x: torch.Tensor) -> torch.Tensor:
        """``(S, n, ...) -> (S, d, n_local, ...)``."""
        return x.unflatten(1, (self.d, self.n_local))

    def exchange(self, x: torch.Tensor, op: str) -> torch.Tensor:
        """Per-shard values ``(S, d, ...)`` -> what each shard receives, in
        the same layout; the shard axis goes to the front for the
        exchange and back after it."""
        out = ring.consensus_exchange(
            x.movedim(1, 0).contiguous(), axis_size=self.d, op=op,
            impl=self.impl)
        return out.movedim(0, 1)

    def sum(self, x: torch.Tensor) -> torch.Tensor:
        """``(S, n, ...) -> (S, d, ...)``: each shard's copy of the sum
        over every agent."""
        if not self.sharded:
            return torch.sum(x, dim=1, keepdim=True)
        return self.exchange(torch.sum(self.blocks(x), dim=2), "sum")

    def per_agent(self, x: torch.Tensor) -> torch.Tensor:
        """Per-shard copies ``(S, d, ...)`` as each agent reads its shard's
        copy, broadcasting against ``(S, n, ...)``."""
        if self.d == 1:
            return x
        return torch.repeat_interleave(x, self.n_local, dim=1)

    def _extreme(self, x: torch.Tensor, op: str) -> torch.Tensor:
        fn = torch.amax if op == "max" else torch.amin
        if not self.sharded:
            return fn(x.flatten(1), dim=1)
        # Exact under every impl: every shard receives the same value.
        return self.exchange(fn(self.blocks(x).flatten(2), dim=2), op)[:, 0]

    def max(self, x: torch.Tensor) -> torch.Tensor:
        """``(S, n, ...) -> (S,)``: the largest entry over every agent."""
        return self._extreme(x, "max")

    def min(self, x: torch.Tensor) -> torch.Tensor:
        """``(S, n, ...) -> (S,)``: the smallest entry over every agent."""
        return self._extreme(x, "min")

    def count(self, eff: torch.Tensor) -> torch.Tensor:
        """Per-agent int32 counts ``(S, n)`` -> each shard's block total
        ``(S, d)``."""
        return torch.sum(self.blocks(eff), dim=2, dtype=torch.int32)

    def total(self, counts: torch.Tensor) -> torch.Tensor:
        """Block totals ``(S, d)`` -> the whole fleet's ``(S,)``, exchanged
        once as float32 (exact far past any realistic count; JAX
        ``cadmm.py:1488-1495``)."""
        if self.sharded:
            counts = self.exchange(counts.to(torch.float32), "sum").to(
                torch.int32)
        return counts[:, 0]

    def agent_values(self, x: torch.Tensor) -> torch.Tensor:
        """Per-agent values ``(S, n)`` as the whole fleet's table: under
        shards, shard 0's gathered copy (JAX ``cadmm.py:1497-1507``)."""
        return self.gather(x)[0] if self.sharded else x

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """Per-agent blocks ``(S, n, ...)`` -> ``(d, S, n, ...)``: each
        shard's gathered copy of every agent's block."""
        out = ring.consensus_gather(
            self.blocks(x).movedim(1, 0).contiguous(), axis_size=self.d,
            impl=self.impl)  # (d, d, S, n_local, ...): [receiver, source].
        return out.movedim(1, 2).flatten(2, 3)


def _where(pred: torch.Tensor, new, old):
    """Per-scenario select ``pred (S,)`` over a tensor or a NamedTuple."""
    if isinstance(new, tuple):
        return type(new)(*(_where(pred, a, b) for a, b in zip(new, old)))
    p = pred.reshape(pred.shape + (1,) * (new.dim() - pred.dim()))
    return torch.where(p, new, old)


def control(
    params: RQPParams,
    cfg: RQPCADMMConfig,
    f_eq: torch.Tensor,
    admm_state: CADMMState,
    state: RQPState,
    acc_des,
    forest: forest_mod.Forest | None = None,
    shards: int = 1,
    plan: SchurPlan | None = None,
    health=None,
):
    """One distributed control step for ``S`` scenarios at once:
    ``-> (f_app (S, n, 3), CADMMState, SolverStats)``. ``admm_state`` and
    ``state`` carry the leading scenario axis; ``f_eq``, ``forest`` and
    ``plan`` are shared; ``acc_des`` is shared (``(3,)`` each) or per
    scenario (``(S, 3)``). Pass ``plan=make_plan(...)`` to
    build the elimination cores once outside a rollout (None for the full
    QP). ``shards=d`` shards the agents into d blocks (see the module
    docstring; ``parallel.mesh.cadmm_control_sharded``); the state stays
    the global one. ``health``: a ``resilience.faults.FaultStep`` (masks
    ``(S, n)`` or ``(n,)``), the fault-aware consensus of the module
    docstring; ``f_eq`` may then be ``(S, n, 3)``. ``health=None`` runs the
    nominal program."""
    n = params.n
    dtype, dev = state.xl.dtype, state.xl.device
    S = admm_state.f.shape[0]
    blocks = _AgentBlocks(n, shards, cfg.consensus_impl)
    agent_ids = torch.arange(n, device=dev)

    if health is not None:
        # The fault masks (JAX cadmm.py:1094-1120).
        alive = health.alive.expand(S, n)
        msg_ok = health.msg_ok.expand(S, n)
        w_alive = alive.to(dtype)  # (S, n)
        contrib = alive & msg_ok  # copies entering mean/residual fresh.
        # Each shard's copy of the alive count, (S, d).
        n_alive = torch.clamp(blocks.sum(w_alive), min=1.0)
        # Dead agents anchor to zero force.
        f_eq = f_eq * w_alive[..., None]
        # The peers' view of a dropped agent: its last delivered copy, with
        # dead agents' columns zeroed.
        f_stale = (admm_state.held if admm_state.held is not None
                   else admm_state.f) * w_alive[:, None, :, None]
    # The equilibrium as every agent's copy: (n, 3) or (S, 1, n, 3).
    f_eq_copy = f_eq if f_eq.dim() == 2 else f_eq[:, None]

    with phases.scope(phases.CBF_ROWS):
        env_cbfs = agent_env_cbfs_for(params, cfg, forest, state, params.r)
    leaders = (agent_ids == cfg.leader_idx).to(dtype)

    use_reduced = _use_reduced(cfg, n)
    nv, n_box_raw, nv_p, n_box, m = _qp_dims(cfg, n)
    # The penalties the schedule visits, as 0-dim CPU tensors: float32
    # arithmetic like the JAX package's rho array, used as scalars on the
    # card (no host-to-device copy).
    rhos = [torch.tensor(r, dtype=dtype) for r in _rho_schedule(cfg)]
    n_rho = len(rhos)
    Rl = state.Rl
    Rl_a = Rl[:, None]  # (S, 1, 3, 3)
    V = 3 * (n - 1)

    def build_qp(k: int):
        """The agent QPs, their KKT operators (in the solve's operator
        storage) and the plan slice at the schedule's k-th rho."""
        if use_reduced:
            pk = SchurPlan(*(x[k] for x in plan))
            qp = _schur_step_qp(params, cfg, pk, f_eq, state, acc_des,
                                env_cbfs, leaders, rhos[k], Ecc, e0s, xq)
        else:
            pk = None
            qp = _build_agent_qp(params, cfg, f_eq, state, acc_des,
                                 env_cbfs, leaders, rhos[k])
        if cfg.pad_operators:
            qp = socp.pad_qp(*qp, n_box=n_box_raw, soc_dims=(4, 4))
        P, q0, A, lb, ub, shift = qp
        rho_vec = socp.make_rho_vec(m, n_box, lb, ub, 0.4)
        op = socp.kkt_operator(P, A, rho_vec)
        # bf16 storage: rounded once per control step, not per solve.
        route = socp.runtime_fused_mode(cfg.socp_fused, A.shape[-1], m,
                                        n_box, (4, 4))
        op, A, P = socp.stored_operators(op, A, P, cfg.socp_precision,
                                         route)
        return pk, (P, q0, A, lb, ub, shift), op

    with phases.scope(phases.QP_BUILD):
        if use_reduced:
            if plan is None:
                plan = make_schur_plan(params, cfg)
            Ecc, e0s, xq = _schur_state_pieces(params, cfg, state,
                                               plan.scale[0, 0])
        # One entry per rho of the schedule; iteration k reads entry
        # min(k, n_rho - 1) (JAX cadmm.py:1222-1252).
        stack = [build_qp(k) for k in range(n_rho)]

    # Solver effort. Adaptive: tolerance-chunked solves (to inner_tol, else
    # to the solve-success gate solver_tol, so "converged" means "would
    # pass solver_tol"), each scenario's solves gated by its own continue
    # predicate (JAX cadmm.py:1254-1303, :1320-1328).
    adaptive = cfg.effort == "adaptive"
    if adaptive:
        inner_tol = cfg.inner_tol if cfg.inner_tol > 0 else cfg.solver_tol
    else:
        inner_tol = cfg.inner_tol
    check_every = cfg.inner_check_every if inner_tol > 0 else 0
    # Two-phase budget: the first consensus iteration solves with
    # inner_iters, the later ones (warm-started from this step's previous
    # iterate) with inner_iters_warm (JAX cadmm.py:1305-1308, :1450-1462).
    warm_iters = cfg.inner_iters_warm or cfg.inner_iters

    def primal_solve(k, lam, f_mean, warm, active):
        """Solve every agent QP of every scenario in consensus iteration
        ``k``; rebuild the full copies. ``active`` (S,) gates each
        scenario's solves (adaptive effort) or is None. Returns ``(f_new,
        sols, eff)``, ``eff`` the (S, n) int32 effective inner iterations
        under adaptive effort, else None."""
        pk, (P, q0, A, lb, ub, shift), op = stack[min(k, n_rho - 1)]
        # Each agent reads its own shard's copy of the mean.
        delta = lam - rhos[min(k, n_rho - 1)] * blocks.per_agent(f_mean)
        if use_reduced:
            dperm = torch.gather(
                delta, 2, pk.perm[None, :, :, None].expand(S, n, n, 3)
            )
            d_u = dperm[:, :, 0, :]
            # Other columns in the payload frame (ft = Rl^T f), V-padded.
            d_v = (dperm[:, :, 1:, :] @ Rl_a).reshape(S, n, V)
            d_v = torch.nn.functional.pad(d_v, (0, pk.N.shape[-1] - V))
            jv = _mv(pk.J.transpose(-1, -2), d_v)  # (S, n, 6)
            q_delta = torch.cat([
                -(jv @ Ecc),
                d_u - _mv(Rl_a, _mv(pk.Mu, d_v)),
            ], dim=-1)
            q = torch.cat([q0[..., :nv] + q_delta, q0[..., nv:]], dim=-1)
        else:
            # Augmented linear term <lam_i, f> - rho <f_mean, f>.
            q = torch.cat([q0[..., :9],
                           q0[..., 9:nv] + delta.reshape(S, n, 3 * n),
                           q0[..., nv:]], dim=-1)
        gate = None if active is None else active[:, None].expand(S, n)
        out = socp.solve_socp(
            P, q, A, lb, ub, n_box=n_box, soc_dims=(4, 4),
            iters=cfg.inner_iters if k == 0 else warm_iters, warm=warm,
            shift=shift, op=op, fused=cfg.socp_fused,
            precision=cfg.socp_precision, check_every=check_every,
            tol=inner_tol, active=gate, report_iters=adaptive,
        )
        sols, eff = out if adaptive else (out, None)
        if not use_reduced:
            return sols.x[..., 9:nv].reshape(S, n, n, 3), sols, eff
        c, u = sols.x[..., :9], sols.x[..., 9:12]
        ut = _mv(Rl_a.transpose(-1, -2), u)
        d6 = (e0s[:, None] - _mv(Ecc[:, None], c) - _mv(pk.Eu, ut))
        vt = (
            _mv(-pk.Nsum, xq[:, None])
            - _mv(pk.N, d_v)
            - _mv(pk.NCt, ut)
            + _mv(pk.J, d6)
        )
        v = vt[..., :V].reshape(S, n, n - 1, 3) @ Rl_a.transpose(-1, -2)
        f_perm = torch.cat([u[:, :, None, :], v], dim=2)
        f_new = torch.gather(
            f_perm, 2, pk.inv_perm[None, :, :, None].expand(S, n, n, 3)
        )
        return f_new, sols, eff

    retry_cap = cfg.solve_retry_iters or cfg.max_iter
    steps = torch.arange(cfg.max_iter + 1, device=dev)

    def continue_pred(it, res, ok_last, fail_count):
        return (((res >= cfg.res_tol)
                 | ((ok_last < 1.0) & (fail_count <= retry_cap)))
                & (it <= cfg.max_iter))

    def consensus_iter(carry, active, k):
        """Consensus iteration ``k`` of every scenario; ``active`` is each
        scenario's continue predicate, the adaptive-effort gate. Every
        scenario that iterates is at iteration ``it = k`` (a scenario that
        stops keeps its carry), so ``k`` selects the schedule's rho."""
        (f, lam, f_mean, warm, it, res, err_buf, okf, _ok_last,
         fail_count) = carry[:10]
        with phases.scope(phases.LOCAL_SOLVE):
            f_new, sols, eff = primal_solve(k, lam, f_mean, warm,
                                            active if adaptive else None)
        # Failed agents fall back to the equilibrium forces.
        ok = (sols.prim_res < cfg.solver_tol)[..., None, None] & torch.all(
            torch.isfinite(f_new).flatten(-2), dim=-1
        )[..., None, None]
        f_new = torch.where(ok, f_new, f_eq_copy)
        if health is not None:
            # Dead agents: their columns zeroed in every copy, their own
            # rows frozen at the last pre-death copy.
            f_new = f_new * w_alive[:, None, :, None]
            f_new = torch.where(alive[..., None, None], f_new, f)
        # Warm starts keep any finite iterate (tolerance-missed included).
        ok_flat = ok[..., 0, 0]
        finite_flat = socp.solution_is_finite(sols)
        if health is not None:
            # The dead never trigger retries and keep frozen warm starts.
            ok_flat = ok_flat | ~alive
            finite_flat = finite_flat & alive
        sols = socp.SOCPSolution(*(
            torch.where(finite_flat.reshape(
                finite_flat.shape + (1,) * (a.dim() - 2)), a, b)
            for a, b in zip(sols, warm)
        ))
        with phases.scope(phases.CONSENSUS):
            # Each shard's copy of the mean (S, d, n, 3); the residual is
            # exact, so it is the same on every shard.
            if health is None:
                f_mean_new = blocks.sum(f_new) / n
                spread = f_new - blocks.per_agent(f_mean_new)
                res_new = blocks.max(torch.abs(spread))
            else:
                # Masked consensus: dropped agents contribute their held
                # copy, the dead nothing, the mean divides by the alive
                # count, and the residual reads the fresh delivered copies
                # only.
                f_eff = torch.where(msg_ok[..., None, None], f_new, f_stale)
                f_mean_new = (blocks.sum(f_eff * w_alive[..., None, None])
                              / n_alive[..., None, None])
                mean_a = blocks.per_agent(f_mean_new)
                res_new = blocks.max(torch.where(
                    contrib[..., None, None], torch.abs(f_eff - mean_a),
                    0.0))
                spread = f_new - mean_a
        err_buf = torch.where(steps[None] == it[:, None], res_new[:, None],
                              err_buf)
        it = it + 1
        # Dual update, gated like the reference loop: rho advances after the
        # solves, the update is skipped when converged or past the cap, and
        # it uses the advanced rho.
        with phases.scope(phases.DUAL_UPDATE):
            do_dual = (res_new >= cfg.res_tol) & (it <= cfg.max_iter)
            lam_new = torch.where(
                do_dual[:, None, None, None],
                lam + rhos[min(k + 1, n_rho - 1)] * spread, lam,
            )
            if health is not None:
                # Frozen duals for dead agents.
                lam_new = torch.where(alive[..., None, None], lam_new, lam)
        # A sum of 0/1 flags: exact, the same on every shard.
        ok_last = blocks.sum(ok_flat.to(dtype))[:, 0] / n
        okf = torch.minimum(okf, ok_last)
        fail_count = torch.where(ok_last < 1.0, fail_count + 1,
                                 torch.zeros_like(fail_count))
        out = (f_new, lam_new, f_mean_new, sols, it, res_new, err_buf, okf,
               ok_last, fail_count)
        if adaptive:
            # Effective inner iterations spent this consensus iteration,
            # by shard.
            out = out + (carry[10] + blocks.count(eff),)
        return out

    carry = (
        # Every shard starts from the carried (replicated) mean.
        admm_state.f, admm_state.lam,
        admm_state.f_mean[:, None].expand(S, blocks.d, n, 3),
        admm_state.warm,
        torch.zeros((S,), dtype=torch.int32, device=dev),
        torch.full((S,), math.inf, dtype=dtype, device=dev),
        torch.full((S, cfg.max_iter + 1), math.nan, dtype=dtype, device=dev),
        torch.ones((S,), dtype=dtype, device=dev),
        torch.ones((S,), dtype=dtype, device=dev),
        torch.zeros((S,), dtype=torch.int32, device=dev),
    )
    if adaptive:
        # The inner-iteration totals by shard, frozen with the carry.
        carry = carry + (torch.zeros((S, blocks.d), dtype=torch.int32,
                                     device=dev),)
    # The vmapped while_loop, written out: every scenario iterates while any
    # scenario's predicate holds; a scenario whose predicate is false keeps
    # its carry. One host synchronisation per consensus iteration.
    k = 0
    while True:
        active = continue_pred(carry[4], carry[5], carry[8], carry[9])
        if not bool(active.any()):
            break
        new = consensus_iter(carry, active, k)
        carry = tuple(_where(active, a, b) for a, b in zip(new, carry))
        k += 1
    f, lam, f_mean, warm, iters, res, err_buf, ok_frac, _, _ = carry[:10]

    f_app = f[:, agent_ids, agent_ids, :]
    if health is not None:
        f_app = f_app * w_alive[..., None]  # dead agents actuate nothing.
        # Delivered agents publish their final copies; dropped agents'
        # snapshots stay frozen for the peers.
        held = torch.where(msg_ok[..., None, None], f, f_stale)
    else:
        held = admm_state.held
    # The carried mean is shard 0's copy.
    new_state = CADMMState(f=f, lam=lam, f_mean=f_mean[:, 0], warm=warm,
                           held=held)
    stats = SolverStats(
        iters=iters,
        solve_res=res,
        collision=blocks.max(env_cbfs.collision.to(torch.int32)) > 0,
        min_env_dist=blocks.min(env_cbfs.min_dist),
        err_seq=err_buf,
        ok_frac=ok_frac,
        fallback_rung=torch.zeros((S,), dtype=torch.int32, device=dev),
        agent_solve_res=torch.zeros((S, 0), dtype=dtype, device=dev),
        inner_iters=(blocks.total(carry[10]) if adaptive else
                     torch.zeros((S, 0), dtype=torch.int32, device=dev)),
    )
    if cfg.track_agent_stats:
        stats = stats.replace(agent_solve_res=blocks.agent_values(
            warm.prim_res))
    return f_app, new_state, stats


def donated_step(control_fn: Callable, donate: bool) -> Callable:
    """``step(state, *args) -> (out, new_state, stats)`` of ``control_fn``;
    with ``donate`` every tensor of the new state is written into the
    storage of the state passed in (``copy_``), and that state is returned:
    the port's form of a donated carry. The state passed in must own its
    storage (no expanded views) and must be threaded forward; its old
    values are gone."""
    if not donate:
        return control_fn

    def step(state, *args):
        out, new_state, stats = control_fn(state, *args)
        olds, news = leaves(state), leaves(new_state)
        if len(olds) != len(news):
            raise ValueError(
                "donate=True: the step filled a state leaf that was None "
                "(seed it first, e.g. the resilient hl_step's "
                "prepare_ctrl_state)")
        for old, new in zip(olds, news):
            if old.shape != new.shape or old.dtype != new.dtype:
                raise ValueError(
                    f"donate=True: a state leaf {tuple(old.shape)} "
                    f"{old.dtype} cannot take the step's "
                    f"{tuple(new.shape)} {new.dtype}")
            old.copy_(new)
        return out, state, stats

    return step


def jit_control_step(params: RQPParams, cfg: RQPCADMMConfig,
                     f_eq: torch.Tensor,
                     forest: forest_mod.Forest | None = None,
                     plan: SchurPlan | None = None, donate: bool = True):
    """``step(admm_state, state, acc_des) -> (f_app, admm_state, stats)``,
    :func:`control` with the plan built once (the JAX package's
    ``jit_control_step``). With ``donate=True`` the returned state is the
    state passed in, its tensors overwritten with the new values (see
    :func:`donated_step`); with ``donate=False`` the input is untouched and
    the new state is fresh tensors."""
    if plan is None:
        plan = make_plan(params, cfg)

    def step(admm_state, state, acc_des):
        return control(params, cfg, f_eq, admm_state, state, acc_des, forest,
                       plan=plan)

    return donated_step(step, donate)
