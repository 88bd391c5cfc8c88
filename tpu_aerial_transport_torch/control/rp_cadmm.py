"""Consensus-ADMM distributed controller for the rigid-payload (RP) model,
batched over Monte-Carlo scenarios.

Counterpart of ``tpu_aerial_transport/control/rp_cadmm.py`` (the JAX
package's extension beyond the reference, whose RP controller is
centralized only). Each agent holds a full local copy ``f^(i) (n, 3)`` of
all forces plus private ``dvl, dwl``; agent i's QP is the centralized RP QP
(:mod:`control.rp_centralized`) with only its own actuation rows kept (the
other agents' min-thrust boxes relaxed to -inf and their SOC rows zeroed),
the tracking cost on the leader alone and the force regularisation summing
to the centralized objective. Consensus ADMM drives the copies together:
``f_mean = mean_i f^(i)``, ``lam_i += rho (f^(i) - f_mean)``, until
``max_i |f^(i) - f_mean|_inf < res_tol``.

All ``S x n`` agent QPs of one consensus iteration are one batched solve,
``inner_iters`` fixed iterations from one KKT operator a control step
(``solver_rho = 0.4`` feeds both): on the card one launch of the whole-solve
kernel's fixed form, its shared-memory body (d = 111 at n = 8).

Batching: every state leaf carries a leading scenario axis ``S``. The
consensus loop keeps the JAX package's vmapped ``while_loop`` semantics
as ``control.cadmm`` writes them out: it runs while any scenario's continue
predicate holds, every scenario's iteration is computed, and a scenario
whose predicate was false keeps its carry (``torch.where`` on every carry
leaf); each scenario carries its own iteration count, residual, success
fractions and failure count. One host synchronisation per consensus
iteration (the ``any`` test).

Agent sharding (``shards=d``; ``parallel.mesh.rp_cadmm_control_sharded``):
the agents form d contiguous blocks, the shards of the JAX package's
``shard_map``, and the cross-agent reductions (its ``psum``/``pmax``) are a
reduction over each block, then an exchange over the shard axis
(``control.cadmm._AgentBlocks``, impl ``"allreduce"``). The state stays the
global one.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import NamedTuple

import torch

from tpu_aerial_transport_torch.control import rp_centralized
from tpu_aerial_transport_torch.control.cadmm import _AgentBlocks, _where
from tpu_aerial_transport_torch.control.rp_centralized import (
    RPCentralizedConfig,
)
from tpu_aerial_transport_torch.control.types import SolverStats
from tpu_aerial_transport_torch.models.rp import RPParams, RPState
from tpu_aerial_transport_torch.ops import socp

# The ADMM penalty of the agent solves: one constant feeds both the KKT
# operator and the solver, so the two cannot diverge.
SOLVER_RHO = 0.4


@dataclass(frozen=True)
class RPCADMMConfig:
    """Controller constants; ``base.k_f`` is already divided by n."""

    base: RPCentralizedConfig
    rho: float = 1.0
    res_tol: float = 1e-2
    leader_idx: int = 0
    max_iter: int = 20
    inner_iters: int = 20
    # Bound on consecutive failing consensus iterations (retries); 0 = up
    # to max_iter.
    solve_retry_iters: int = 4
    # Carry the consensus duals across control steps (default off: in the
    # JAX package's closed-loop circle test carried duals drift and the
    # tracking error grows; warm primal starts are carried either way).
    carry_duals: bool = False


def make_config(params: RPParams, max_iter: int = 20, inner_iters: int = 20,
                res_tol: float = 1e-2, rho: float = 1.0, leader_idx: int = 0,
                carry_duals: bool = False, solve_retry_iters: int = 4
                ) -> RPCADMMConfig:
    """The centralized constants with the force-regularisation weight
    ``k_f`` divided by n, so the agent costs sum to the centralized
    objective; the agent solves run ``inner_iters`` iterations."""
    base = rp_centralized.make_config(params, solver_iters=inner_iters)
    base = dataclasses.replace(base, k_f=base.k_f / params.n)
    return RPCADMMConfig(
        base=base, rho=rho, res_tol=res_tol, leader_idx=leader_idx,
        max_iter=max_iter, inner_iters=inner_iters, carry_duals=carry_duals,
        solve_retry_iters=solve_retry_iters,
    )


class RPCADMMState(NamedTuple):
    """Per-agent copies, duals and warm starts across control steps; leaves
    may carry a leading scenario axis."""

    f: torch.Tensor  # (..., n, n, 3) agent i's copy of all forces.
    lam: torch.Tensor  # (..., n, n, 3) consensus duals.
    warm: socp.SOCPSolution  # (..., n, ...) warm starts.


def init_state(params: RPParams, cfg: RPCADMMConfig,
               f_eq: torch.Tensor) -> RPCADMMState:
    """One scenario's initial state (no scenario axis): every copy the
    equilibrium forces, zero duals and warm starts."""
    n = params.n
    nv = 6 + 3 * n
    _, m, _ = rp_centralized.qp_dims(n)
    kw = dict(dtype=f_eq.dtype, device=f_eq.device)
    warm = socp.SOCPSolution(
        x=torch.zeros((n, nv), **kw), y=torch.zeros((n, m), **kw),
        z=torch.zeros((n, m), **kw), prim_res=torch.zeros((n,), **kw),
        dual_res=torch.zeros((n,), **kw),
    )
    return RPCADMMState(f=f_eq.expand(n, n, 3).clone(),
                        lam=torch.zeros((n, n, 3), **kw), warm=warm)


def _agent_qp(params: RPParams, cfg: RPCADMMConfig, f_eq, state: RPState,
              acc_des):
    """Every agent's QP ``(P, q, A, lb, ub, shift)``, shapes ``(S, n,
    ...)``, from the centralized builder: the tracking cost kept on the
    leader only, the equilibrium anchor on the own force only, the other
    agents' min-thrust rows relaxed to -inf (the own row's bound in the
    builder's row scaling) and their SOC rows zeroed. Each agent's copy is
    its own storage (``repeat``), never a write into a shared view."""
    n = params.n
    base = cfg.base
    P, q, A, lb, ub, shift, scales = rp_centralized._build_qp(
        params, base, f_eq, state, acc_des)
    n_box = 9 + n
    dtype, dev = P.dtype, P.device
    onehot = torch.eye(n, dtype=dtype, device=dev)  # (n agents, n)
    track = (torch.arange(n, device=dev) == cfg.leader_idx).to(dtype)

    P = P[:, None].repeat(1, n, 1, 1)
    q = q[:, None].repeat(1, n, 1)
    A = A[:, None].repeat(1, n, 1, 1)
    lb = lb[:, None].repeat(1, n, 1)
    ub = ub[:, None].expand(-1, n, -1)
    shift = shift[:, None].expand(-1, n, -1)
    # Tracking cost only on the leader.
    P[..., 0:6, 0:6] *= track[:, None, None]
    q[..., 0:6] *= track[:, None]
    # The equilibrium anchor on the own force only.
    own3 = torch.repeat_interleave(onehot, 3, dim=-1)  # (n, 3n)
    damp = 2.0 * base.k_feq * (1.0 - own3)
    P[..., 6:, 6:] += -torch.diag_embed(damp)
    q[..., 6:] += 2.0 * base.k_feq * f_eq.reshape(-1) * (1.0 - own3)
    # The other agents' min-thrust rows relaxed; the own row keeps its
    # equilibrated bound.
    lb[..., 6:6 + n] = torch.where(
        onehot > 0, base.min_fz * scales[:, None, 6:6 + n],
        torch.full_like(onehot, -socp.INF))
    # The other agents' SOC blocks zeroed (2 blocks of 4 rows an agent).
    soc_mask = torch.repeat_interleave(onehot, 8, dim=-1)  # (n, 8n)
    A[..., n_box:, :] *= soc_mask[..., None]
    return P, q, A, lb, ub, shift


def control(params: RPParams, cfg: RPCADMMConfig, f_eq: torch.Tensor,
            cstate: RPCADMMState, state: RPState, acc_des, shards: int = 1):
    """One distributed control step for ``S`` scenarios at once: ``-> (f
    (S, n, 3), RPCADMMState, SolverStats)``, ``f`` each agent's own column
    of its copy (the force it applies). ``cstate`` and ``state`` carry the
    leading scenario axis; ``f_eq (n, 3)`` is shared; ``acc_des`` is shared
    (``(3,)`` each) or per scenario (``(S, 3)``). ``shards=d`` shards the
    agents into d blocks (see the module docstring)."""
    n = params.n
    base = cfg.base
    dtype, dev = state.xl.dtype, state.xl.device
    S = cstate.f.shape[0]
    n_box, m, soc_dims = rp_centralized.qp_dims(n)
    blocks = _AgentBlocks(n, shards, "allreduce")
    agent_ids = torch.arange(n, device=dev)

    P, q0, A, lb, ub, shift = _agent_qp(params, cfg, f_eq, state, acc_des)
    # The augmented Lagrangian rho/2 ||f - f_mean||^2 adds rho I to the
    # force block, folded into the KKT operator once a control step.
    rho = torch.tensor(cfg.rho, dtype=dtype)
    P_aug = P + torch.diag(torch.cat([
        torch.zeros((6,), dtype=dtype, device=dev),
        torch.full((3 * n,), cfg.rho, dtype=dtype, device=dev)]))
    rho_vec = socp.make_rho_vec(m, n_box, lb, ub, SOLVER_RHO)
    op = socp.kkt_operator(P_aug, A, rho_vec)
    fallback = f_eq.expand(n, n, 3)

    def consensus_iter(carry):
        f, lam, f_mean, warm, it, res, okf, _ok_last, fail_count = carry
        # Linear term <lam_i, f> - rho <f_mean, f> on the force block.
        delta = lam - rho * blocks.per_agent(f_mean)
        q = torch.cat([q0[..., :6], q0[..., 6:] + delta.reshape(S, n, 3 * n)],
                      dim=-1)
        sols = socp.solve_socp(
            P_aug, q, A, lb, ub, n_box=n_box, soc_dims=soc_dims,
            iters=cfg.inner_iters, rho=SOLVER_RHO, warm=warm, shift=shift,
            op=op)
        ok = (sols.prim_res < base.solver_tol) & torch.all(
            torch.isfinite(sols.x), dim=-1)  # (S, n)
        f_new = torch.where(ok[..., None, None],
                            sols.x[..., 6:].reshape(S, n, n, 3), fallback)
        # Warm starts keep any finite iterate (tolerance-missed included).
        finite = socp.solution_is_finite(sols)
        warm_new = socp.SOCPSolution(*(
            torch.where(finite.reshape(finite.shape + (1,) * (a.dim() - 2)),
                        a, b) for a, b in zip(sols, warm)))
        f_mean_new = blocks.sum(f_new) / n  # (S, d, n, 3)
        spread = f_new - blocks.per_agent(f_mean_new)
        res_new = blocks.max(torch.abs(spread))
        # No dual step once converged or past the cap: the carried state
        # sits at the converged point.
        do_dual = (res_new >= cfg.res_tol) & (it + 1 <= cfg.max_iter)
        lam_new = torch.where(do_dual[:, None, None, None],
                              lam + rho * spread, lam)
        ok_last = blocks.sum(ok.to(dtype))[:, 0] / n
        okf = torch.minimum(okf, ok_last)
        fail_count = torch.where(ok_last < 1.0, fail_count + 1,
                                 torch.zeros_like(fail_count))
        return (f_new, lam_new, f_mean_new, warm_new, it + 1, res_new, okf,
                ok_last, fail_count)

    retry_cap = cfg.solve_retry_iters or cfg.max_iter

    def continue_pred(it, res, ok_last, fail_count):
        # Solve failures keep the loop alive even at agreement, for at most
        # retry_cap consecutive failing iterations.
        return (((res >= cfg.res_tol)
                 | ((ok_last < 1.0) & (fail_count <= retry_cap)))
                & (it <= cfg.max_iter))

    lam0 = cstate.lam if cfg.carry_duals else torch.zeros_like(cstate.lam)
    carry = (
        cstate.f, lam0, blocks.sum(cstate.f) / n, cstate.warm,
        torch.zeros((S,), dtype=torch.int32, device=dev),
        torch.full((S,), math.inf, dtype=dtype, device=dev),
        torch.ones((S,), dtype=dtype, device=dev),
        torch.ones((S,), dtype=dtype, device=dev),
        torch.zeros((S,), dtype=torch.int32, device=dev),
    )
    # The vmapped while_loop, written out (see the module docstring).
    while True:
        active = continue_pred(carry[4], carry[5], carry[7], carry[8])
        # The loop's exit test: the one deliberate host read an iteration.
        if not bool(active.any()):  # torchlint: disable=TL001,TL005
            break
        new = consensus_iter(carry)
        carry = tuple(_where(active, a, b) for a, b in zip(new, carry))
    f, lam, _, warm, iters, res, ok_frac, _, _ = carry

    kw = dict(dtype=dtype, device=dev)
    stats = SolverStats(
        iters=iters, solve_res=res,
        collision=torch.zeros((S,), dtype=torch.bool, device=dev),
        min_env_dist=torch.full((S,), math.inf, **kw),
        err_seq=torch.zeros((S, 0), **kw), ok_frac=ok_frac,
        fallback_rung=torch.zeros((S,), dtype=torch.int32, device=dev),
        agent_solve_res=torch.zeros((S, 0), **kw),
        inner_iters=torch.zeros((S, 0), dtype=torch.int32, device=dev),
    )
    return (f[:, agent_ids, agent_ids, :],
            RPCADMMState(f=f, lam=lam, warm=warm), stats)
