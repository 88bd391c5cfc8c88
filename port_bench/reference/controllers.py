"""Plain PyTorch reference of the two high-level controllers the benchmark
runs: nominal consensus ADMM with Schur-reduced agent QPs, and the
centralized QP. A frozen copy of the port's plain paths (see
:mod:`port_bench.reference.rqp`), at fixed solver effort, in one program,
with the agent QPs padded to their tile bucket as the card runs them.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import NamedTuple

import torch

from port_bench.reference.rqp import (
    AGENT_SOC, GRAVITY, INF, MAX_DECELERATION, EnvRows, Forest, Numerics,
    Params, Solution, State, braking_capsule, capsule_distance, cbf_rows,
    collision_radius, equilibrate_rows, hat, hat_square, make_params, pad_qp,
    padded_dims, solution_is_finite, solve,
)


def _cos32(x: float) -> float:
    return float(torch.cos(torch.tensor(x, dtype=torch.float32)))


@dataclass(frozen=True)
class Limits:
    """The constants both controllers share, from the payload's mass."""

    min_fz: float
    sec_max_f_ang: float
    max_f: float
    cos_max_p_ang: float
    max_wl_sq: float
    dist_eps: float
    vision_radius: float
    max_deceleration: float


def limits(params: Params) -> Limits:
    n = params.n
    mTg = float(params.mT) * GRAVITY
    return Limits(min_fz=mTg / (n * 10.0),
                  sec_max_f_ang=1.0 / _cos32(math.pi / 6.0),
                  max_f=2.0 * mTg / n, cos_max_p_ang=_cos32(math.pi / 12.0),
                  max_wl_sq=(math.pi / 6.0) ** 2, dist_eps=0.1,
                  vision_radius=collision_radius() + 5.0,
                  max_deceleration=MAX_DECELERATION)


def equilibrium_forces(params: Params) -> torch.Tensor:
    """Minimum-norm vertical thrusts of the wrench balance, ``(n, 3)``."""
    n = params.n
    kw = dict(dtype=params.r.dtype, device=params.r.device)
    e3 = torch.tensor([0.0, 0.0, 1.0], **kw)
    rxe = torch.linalg.cross(params.r_com, e3.expand(n, 3), dim=-1)
    wrench = torch.cat([torch.ones((n, 1), **kw), rxe[:, :2]], dim=1).T
    rhs = torch.stack([params.mT * GRAVITY, torch.zeros((), **kw),
                       torch.zeros((), **kw)])
    fz = wrench.T @ torch.linalg.solve(wrench @ wrench.T, rhs)
    return torch.cat([torch.zeros((n, 2), **kw), fz[:, None]], dim=-1)


def _e3(like):
    e3 = torch.zeros(3, dtype=like.dtype, device=like.device)
    e3[2] = 1.0
    return e3


def _cbf_common_rows(nx, lim, state: State, A, lb, ub, row, dv_cols,
                     dw_cols):
    """Tilt, |wl| and |vl| CBF rows at rows ``row .. row + 2`` (broadcast
    over any agent axis between the scenario axis and the rows)."""
    Rl, wl, vl = state.Rl, state.wl, state.vl
    e3 = _e3(vl)
    extra = A.dim() - 3  # 1 with an agent axis.
    R_w_hat = nx.mm(Rl, hat(wl))
    R_w_hat_sq = nx.mm(Rl, hat_square(wl, wl))

    def b(x):
        return x.reshape(x.shape[:1] + (1,) * extra + x.shape[1:])

    A[..., row, dw_cols] = b(-nx.mm(Rl[:, 2, None, :], hat(e3))[:, 0])
    lb[..., row] = b(-R_w_hat_sq[:, 2, 2] - 2.0 * R_w_hat[:, 2, 2]
                     - (Rl[:, 2, 2] - lim.cos_max_p_ang))
    ub[..., row] = INF
    A[..., row + 1, dw_cols] = b(-2.0 * wl)
    lb[..., row + 1] = b(-(lim.max_wl_sq - torch.sum(wl * wl, dim=-1)))
    ub[..., row + 1] = INF
    A[..., row + 2, dv_cols] = b(-2.0 * vl)
    lb[..., row + 2] = b(-(1.0 - torch.sum(vl * vl, dim=-1)))
    ub[..., row + 2] = INF
    return R_w_hat_sq


# ------------------------------------------------------------ C-ADMM

class StepOut(NamedTuple):
    """What a reference step reports: the applied forces ``(S, n, 3)``,
    the carried state, the outcome (C-ADMM: the consensus iterations;
    centralized: 1 where the solve met its tolerance), the worst fraction
    of agent solves that met theirs over the iterations (centralized: the
    solve's), the minimum
    environment distance and the collision flag, and the centralized
    solve's ADMM iterations (None for C-ADMM)."""

    f: torch.Tensor
    css: tuple
    outcome: torch.Tensor
    ok_frac: torch.Tensor
    min_dist: torch.Tensor
    collision: torch.Tensor
    eff: torch.Tensor | None


@dataclass(frozen=True)
class CADMMConfig:
    max_iter: int
    inner_iters: int
    res_tol: float = 1e-2
    rho: float = 1.0
    solver_tol: float = 5e-3
    solve_retry_iters: int = 4
    n_env_cbfs: int = 10
    alpha_env_cbf: float = 1.5
    vision_cone_ang: float = 100.0 * math.pi / 180.0


class CADMMState(NamedTuple):
    f: torch.Tensor  # (S, n, n, 3): agent i's copy of agent j's force.
    lam: torch.Tensor  # (S, n, n, 3)
    f_mean: torch.Tensor  # (S, n, 3)
    warm: Solution  # (S, n, ...) in the padded layout.


class Plan(NamedTuple):
    J: torch.Tensor
    N: torch.Tensor
    Yinv: torch.Tensor
    Eu: torch.Tensor
    Mu: torch.Tensor
    NCt: torch.Tensor
    Nsum: torch.Tensor
    Jsum: torch.Tensor
    Musum: torch.Tensor
    CJ: torch.Tensor
    YinvEu: torch.Tensor
    UUcore: torch.Tensor
    CUcore: torch.Tensor
    perm: torch.Tensor
    inv_perm: torch.Tensor
    scale: torch.Tensor


def agent_qp_dims(cfg: CADMMConfig):
    """``(nv, n_box, nv_p, n_box_p, m_p)`` of a Schur-reduced agent QP."""
    nv, n_box = 12, 7 + cfg.n_env_cbfs
    nv_p, n_box_p = padded_dims(nv, n_box, AGENT_SOC)
    return nv, n_box, nv_p, n_box_p, n_box_p + sum(AGENT_SOC)


def _sym(M):
    return 0.5 * (M + M.transpose(-1, -2))


def schur_plan(nx: Numerics, params: Params, k_f: float, k_m: float,
               rho: float) -> Plan:
    """Elimination cores of every agent's reduced QP (payload-frame force
    parametrization), the eliminated axis padded to the tile."""
    n = params.n
    kw = dict(dtype=params.r.dtype, device=params.r.device)
    V = 3 * (n - 1)
    eye3 = torch.eye(3, **kw)
    rho_t = torch.tensor(rho, **kw)

    def one(agent):
        others = [j for j in range(n) if j != agent]
        perm = torch.tensor([agent] + others, dtype=torch.int64,
                            device=kw["device"])
        hat_perm = hat(params.r_com[perm])
        hat_u, hat_v = hat_perm[0], hat_perm[1:]
        Sv = eye3.repeat(1, n - 1)
        Gv = torch.cat(list(hat_v), dim=1)
        Qvv = (2.0 * k_f * nx.mm(Sv.T, Sv) + 2.0 * k_m * nx.mm(Gv.T, Gv)
               + rho_t * torch.eye(V, **kw))
        C = 2.0 * k_f * Sv + 2.0 * k_m * nx.mm(hat_u.T, Gv)
        Ev = torch.cat([-Sv, -nx.mm(params.JT_inv, Gv)], dim=0)
        Eu = torch.cat([-eye3, -nx.mm(params.JT_inv, hat_u)], dim=0)
        Ecc_proxy = torch.zeros((6, 9), **kw)
        Ecc_proxy[0:3, 0:3] = params.mT * eye3
        Ecc_proxy[3:6, 6:9] = eye3
        rows = torch.cat([Ecc_proxy, Eu, Ev], dim=1)
        scale = 1.0 / torch.sqrt(torch.sum(rows * rows, dim=1))
        Ev = Ev * scale[:, None]
        Eu = Eu * scale[:, None]
        L = _sym(torch.linalg.inv(Qvv))
        EvL = nx.mm(Ev, L)
        Yinv = _sym(torch.linalg.inv(_sym(nx.mm(EvL, Ev.T))))
        J = nx.mm(EvL.T, Yinv)
        N = _sym(L - nx.mm(J, EvL))
        NCt = nx.mm(N, C.T)
        Nsum = torch.sum(N.reshape(V, n - 1, 3), dim=1)
        Jsum = torch.sum(J.reshape(n - 1, 3, 6), dim=0)
        Mu = nx.mm(C, N) + nx.mm(Eu.T, J.T)
        Musum = nx.mm(C, Nsum) + nx.mm(Eu.T, Jsum.T)
        CJ = nx.mm(C, J)
        YinvEu = nx.mm(Yinv, Eu)
        sym_term = nx.mm(C, nx.mm(J, Eu))
        UUcore = (nx.mm(Eu.T, YinvEu) - nx.mm(C, NCt)
                  - (sym_term + sym_term.T)
                  + 2.0 * k_m * nx.mm(hat_u.T, hat_u))
        CUcore = YinvEu - nx.mm(J.T, C.T)
        return Plan(J, N, Yinv, Eu, Mu, NCt, Nsum, Jsum, Musum, CJ, YinvEu,
                    UUcore, CUcore, perm, torch.argsort(perm), scale)

    plan = Plan(*(torch.stack(f) for f in zip(*[one(a) for a in range(n)])))
    pv = -(-V // 8) * 8 - V

    def padv(x, axes):
        pads = []
        for a in reversed(range(x.dim())):
            pads += [0, pv if a in axes else 0]
        return torch.nn.functional.pad(x, pads)

    return plan._replace(J=padv(plan.J, (1,)), N=padv(plan.N, (1, 2)),
                         Mu=padv(plan.Mu, (2,)), NCt=padv(plan.NCt, (1,)),
                         Nsum=padv(plan.Nsum, (1,)))


class CADMM:
    """The reference C-ADMM step on ``n`` agents (fixed effort)."""

    def __init__(self, nx: Numerics, n: int, cfg: CADMMConfig, device):
        self.nx, self.cfg = nx, cfg
        self.params = make_params(n, device)
        self.lim = limits(self.params)
        self.k_f = self.k_m = 0.1 / n
        self.f_eq = equilibrium_forces(self.params)
        self.plan = schur_plan(nx, self.params, self.k_f, self.k_m, cfg.rho)

    def initial(self, S: int) -> CADMMState:
        """Every scenario's initial controller state."""
        p, n = self.params, self.params.n
        f_eq = self.f_eq
        kw = dict(dtype=f_eq.dtype, device=f_eq.device)
        nv, _, nv_p, _, m_p = agent_qp_dims(self.cfg)
        x0 = torch.nn.functional.pad(
            torch.cat([torch.zeros((n, 9), **kw), f_eq], dim=1),
            (0, nv_p - nv))
        warm = Solution(x=x0.expand(S, n, nv_p).clone(),
                        y=torch.zeros((S, n, m_p), **kw),
                        z=torch.zeros((S, n, m_p), **kw),
                        prim_res=torch.zeros((S, n), **kw),
                        dual_res=torch.zeros((S, n), **kw))
        del p
        return CADMMState(f=f_eq.expand(S, n, n, 3).clone(),
                          lam=torch.zeros((S, n, n, 3), **kw),
                          f_mean=f_eq.expand(S, n, 3).clone(), warm=warm)

    def env_rows(self, forest: Forest, state: State) -> EnvRows:
        """Each agent's vision-cone-masked rows over one sweep a scenario."""
        nx, cfg, lim = self.nx, self.cfg, self.lim
        xl, vl, Rl = state.xl, state.vl, state.Rl
        cr = lim.vision_radius - 5.0
        cap_a, cap_b, cap_h, speed, cap_dir = braking_capsule(
            nx, xl, vl, lim.max_deceleration)
        data = capsule_distance(nx, forest, cap_a, cap_b, cr,
                                lim.vision_radius)
        camera = (xl[:, None] + nx.mv(Rl[:, None], self.params.r))[..., :2]
        d = camera - xl[:, None, :2]
        norm = nx.norm(d)
        direction = d / torch.where(norm > 0, norm, torch.ones_like(norm))[
            ..., None]
        dc = forest.tree_pos[..., :2] - camera[..., None, :2]
        dn = nx.norm(dc)
        safe = torch.where(dn > 0, dn, torch.ones_like(dn))
        cosang = nx.dot(dc / safe[..., None], direction[..., None, :2])
        mask = (dn == 0.0) | (cosang >= _cos32(cfg.vision_cone_ang))
        mask = mask & (norm > 0)[..., None]
        per_agent = type(data)(*(t[:, None] for t in data))
        rows = cbf_rows(nx, per_agent, xl[:, None], vl[:, None],
                        cap_h[:, None], speed[:, None], cap_dir[:, None],
                        lim.max_deceleration, lim.vision_radius,
                        lim.dist_eps, cfg.alpha_env_cbf, cfg.n_env_cbfs,
                        extra_mask=mask)
        return rows._replace(collision=rows.collision | (norm == 0))

    def _state_pieces(self, state: State, scale):
        nx, p = self.nx, self.params
        dtype, dev = state.xl.dtype, state.xl.device
        e3 = _e3(state.xl)
        Rt = state.Rl.transpose(-1, -2)
        Ecc = torch.zeros(Rt.shape[:-2] + (6, 9), dtype=dtype, device=dev)
        Ecc[..., 0:3, 0:3] = p.mT * Rt
        Ecc[..., 3:6, 6:9] = torch.eye(3, dtype=dtype, device=dev)
        Ecc = Ecc * scale[:, None]
        e0s = scale * torch.cat(
            [nx.mv(Rt, -p.mT * GRAVITY * e3),
             nx.mv(-p.JT_inv, torch.linalg.cross(
                 state.wl, nx.mv(p.JT, state.wl), dim=-1))], dim=-1)
        xq = -2.0 * self.k_f * p.mT * GRAVITY * nx.mv(Rt, e3)
        return Ecc, e0s, xq

    def _qp(self, state: State, acc_des, env: EnvRows, Ecc, e0s, xq):
        """Every agent's reduced QP ``(P, q0, A, lb, ub, shift)``."""
        nx, p, cfg, lim, pk = self.nx, self.params, self.cfg, self.lim, \
            self.plan
        n = p.n
        kw = dict(dtype=state.xl.dtype, device=state.xl.device)
        S = state.xl.shape[0]
        dvl_des, dwl_des = (a.expand(S, 3)[:, None, :] for a in acc_des)
        e3 = _e3(state.xl)
        eye3 = torch.eye(3, **kw)
        Rl = state.Rl[:, None]
        RlT = Rl.transpose(-1, -2)
        EccT = Ecc.transpose(-1, -2)[:, None]
        leader = (torch.arange(n, device=kw["device"]) == 0).to(kw["dtype"])
        P_cc = torch.zeros((n, 9, 9), **kw)
        P_cc[:, 3:6, 3:6] = (2.0 * leader)[:, None, None] * eye3
        P_cc[:, 6:9, 6:9] = (2.0 * leader)[:, None, None] * eye3
        H_cc = P_cc + nx.mm(nx.mm(EccT, pk.Yinv), Ecc[:, None])
        H_uu = ((2.0 * self.k_f + 2.0 * 0.1 + cfg.rho) * eye3
                + nx.mm(nx.mm(Rl, pk.UUcore), RlT))
        H_cu = nx.mm(nx.mm(EccT, pk.CUcore), RlT)
        P = torch.cat([torch.cat([H_cc, H_cu], dim=-1),
                       torch.cat([H_cu.transpose(-1, -2), H_uu], dim=-1)],
                      dim=-2)
        P = 0.5 * (P + P.transpose(-1, -2))
        q_c0 = torch.cat([torch.zeros((S, n, 3), **kw),
                          (-2.0 * leader)[:, None] * dvl_des,
                          (-2.0 * leader)[:, None] * dwl_des], dim=-1)
        q_u0 = -2.0 * self.k_f * p.mT * GRAVITY * e3 - 2.0 * 0.1 * self.f_eq
        xq_a, e0s_a = xq[:, None], e0s[:, None]
        q0 = torch.cat([
            q_c0 - nx.mv(EccT, nx.mv(pk.Jsum.transpose(-1, -2), xq_a)
                         + nx.mv(pk.Yinv, e0s_a)),
            q_u0 + nx.mv(Rl, nx.mv(-pk.Musum, xq_a) + nx.mv(pk.CJ, e0s_a)
                         - nx.mv(pk.YinvEu.transpose(-1, -2), e0s_a)),
        ], dim=-1)
        n_box = 7 + cfg.n_env_cbfs
        A = torch.zeros((S, n, n_box, 12), **kw)
        lb = torch.zeros((S, n, n_box), **kw)
        ub = torch.zeros((S, n, n_box), **kw)
        Rls = state.Rl
        A[..., 0:3, 0:3] = -eye3
        A[..., 0:3, 3:6] = eye3
        A[..., 0:3, 6:9] = (-nx.mm(Rls, hat(p.x_com)))[:, None]
        R_w_hat_sq = _cbf_common_rows(nx, lim, state, A, lb, ub, 4,
                                      slice(3, 6), slice(6, 9))
        kin = nx.mv(-R_w_hat_sq, p.x_com)
        lb[..., 0:3] = kin[:, None]
        ub[..., 0:3] = kin[:, None]
        A[..., 3, 11] = 1.0
        lb[..., 3] = lim.min_fz
        ub[..., 3] = INF
        A[..., 7:7 + cfg.n_env_cbfs, 3:6] = env.lhs
        lb[..., 7:7 + cfg.n_env_cbfs] = env.rhs
        ub[..., 7:7 + cfg.n_env_cbfs] = INF
        soc = torch.zeros((8, 12), **kw)
        soc[0, 11] = lim.sec_max_f_ang
        soc[1:4, 9:12] = eye3
        soc[5:8, 9:12] = eye3
        shift_soc = torch.zeros((8,), **kw)
        shift_soc[4] = lim.max_f
        A = torch.cat([A, soc.expand(S, n, 8, 12)], dim=-2)
        shift = torch.cat([torch.zeros((n_box,), **kw), shift_soc]).expand(
            S, n, n_box + 8)
        A, lb, ub, shift = equilibrate_rows(A, lb, ub, shift, n_box,
                                            AGENT_SOC)
        return pad_qp(P, q0, A, lb, ub, shift, n_box, AGENT_SOC)

    def step(self, css: CADMMState, state: State, acc_des,
             forest: Forest) -> StepOut:
        """One control step of every scenario; a scenario iterates while
        its own continue predicate holds and keeps its carry after."""
        nx, p, cfg, pk = self.nx, self.params, self.cfg, self.plan
        n = p.n
        dtype, dev = state.xl.dtype, state.xl.device
        S = css.f.shape[0]
        V = 3 * (n - 1)
        env = self.env_rows(forest, state)
        Ecc, e0s, xq = self._state_pieces(state, pk.scale[0])
        P, q0, A, lb, ub, shift = self._qp(state, acc_des, env, Ecc, e0s, xq)
        nv, n_box_raw, nv_p, n_box, m = agent_qp_dims(cfg)
        Rl_a = state.Rl[:, None]
        f_eq = self.f_eq

        def primal(lam, f_mean, warm):
            delta = lam - cfg.rho * f_mean
            dperm = torch.gather(delta, 2, pk.perm[None, :, :, None].expand(
                S, n, n, 3))
            d_u = dperm[:, :, 0, :]
            d_v = nx.mm(dperm[:, :, 1:, :], Rl_a).reshape(S, n, V)
            d_v = torch.nn.functional.pad(d_v, (0, pk.N.shape[-1] - V))
            jv = nx.mv(pk.J.transpose(-1, -2), d_v)
            q_delta = torch.cat([-nx.mm(jv, Ecc),
                                 d_u - nx.mv(Rl_a, nx.mv(pk.Mu, d_v))],
                                dim=-1)
            q = torch.cat([q0[..., :nv] + q_delta, q0[..., nv:]], dim=-1)
            sols, _ = solve(nx, P, q, A, lb, ub, shift, warm, n_box=n_box,
                            soc_dims=AGENT_SOC, iters=cfg.inner_iters)
            c, u = sols.x[..., :9], sols.x[..., 9:12]
            ut = nx.mv(Rl_a.transpose(-1, -2), u)
            d6 = e0s[:, None] - nx.mv(Ecc[:, None], c) - nx.mv(pk.Eu, ut)
            vt = (nx.mv(-pk.Nsum, xq[:, None]) - nx.mv(pk.N, d_v)
                  - nx.mv(pk.NCt, ut) + nx.mv(pk.J, d6))
            v = nx.mm(vt[..., :V].reshape(S, n, n - 1, 3),
                      Rl_a.transpose(-1, -2))
            f_perm = torch.cat([u[:, :, None, :], v], dim=2)
            f_new = torch.gather(f_perm, 2, pk.inv_perm[None, :, :, None]
                                 .expand(S, n, n, 3))
            return f_new, sols

        def iterate(carry):
            f, lam, f_mean, warm, it, res, okf, _ok_last, fails = carry
            f_new, sols = primal(lam, f_mean, warm)
            ok = ((sols.prim_res < cfg.solver_tol)[..., None, None]
                  & torch.all(torch.isfinite(f_new).flatten(-2), dim=-1)[
                      ..., None, None])
            f_new = torch.where(ok, f_new, f_eq)
            finite = solution_is_finite(sols)
            sols = Solution(*(torch.where(
                finite.reshape(finite.shape + (1,) * (a.dim() - 2)), a, b)
                for a, b in zip(sols, warm)))
            f_mean_new = torch.sum(f_new, dim=1, keepdim=True) / n
            spread = f_new - f_mean_new
            res_new = torch.amax(torch.abs(spread).flatten(1), dim=1)
            it = it + 1
            do_dual = (res_new >= cfg.res_tol) & (it <= cfg.max_iter)
            lam_new = torch.where(do_dual[:, None, None, None],
                                  lam + cfg.rho * spread, lam)
            ok_last = torch.sum(ok[..., 0, 0].to(dtype), dim=1) / n
            okf = torch.minimum(okf, ok_last)
            fails = torch.where(ok_last < 1.0, fails + 1,
                                torch.zeros_like(fails))
            return (f_new, lam_new, f_mean_new, sols, it, res_new, okf,
                    ok_last, fails)

        carry = (css.f, css.lam, css.f_mean[:, None], css.warm,
                 torch.zeros((S,), dtype=torch.int32, device=dev),
                 torch.full((S,), math.inf, dtype=dtype, device=dev),
                 torch.ones((S,), dtype=dtype, device=dev),
                 torch.ones((S,), dtype=dtype, device=dev),
                 torch.zeros((S,), dtype=torch.int32, device=dev))
        retry = cfg.solve_retry_iters or cfg.max_iter
        while True:
            it, res, ok_last, fails = carry[4], carry[5], carry[7], carry[8]
            active = (((res >= cfg.res_tol)
                       | ((ok_last < 1.0) & (fails <= retry)))
                      & (it <= cfg.max_iter))
            if not bool(active.any()):
                break
            carry = _where(active, iterate(carry), carry)
        f, lam, f_mean, warm, iters, _, okf = carry[:7]
        ids = torch.arange(n, device=dev)
        new = CADMMState(f=f, lam=lam, f_mean=f_mean[:, 0], warm=warm)
        return StepOut(f=f[:, ids, ids, :], css=new, outcome=iters,
                       ok_frac=okf, min_dist=torch.amin(env.min_dist, dim=1),
                       collision=torch.any(env.collision, dim=1), eff=None)


def _where(pred, new, old):
    if isinstance(new, tuple):
        parts = [_where(pred, a, b) for a, b in zip(new, old)]
        return type(new)(*parts) if hasattr(new, "_fields") else tuple(parts)
    return torch.where(pred.reshape(pred.shape + (1,) * (new.dim() - 1)),
                       new, old)


# -------------------------------------------------------- centralized

@dataclass(frozen=True)
class CentralizedConfig:
    solver_iters: int
    solver_tol: float = 5e-3
    solver_check_every: int = 25
    n_env_cbfs: int = 10
    alpha_env_cbf: float = 2.0


class CentralizedState(NamedTuple):
    prev_f: torch.Tensor  # (S, n, 3)
    warm: Solution  # (S, ...)


def centralized_dims(n: int, n_env_cbfs: int):
    """``(nv, n_box, m, soc_dims)`` of the centralized QP."""
    n_box = 12 + n + n_env_cbfs
    soc = (4,) * (2 * n)
    return 9 + 3 * n, n_box, n_box + sum(soc), soc


class Centralized:
    """The reference centralized step on ``n`` agents."""

    def __init__(self, nx: Numerics, n: int, cfg: CentralizedConfig, device):
        self.nx, self.cfg = nx, cfg
        self.params = make_params(n, device)
        self.lim = limits(self.params)
        self.f_eq = equilibrium_forces(self.params)

    def initial(self, S: int) -> CentralizedState:
        n = self.params.n
        nv, _, m, _ = centralized_dims(n, self.cfg.n_env_cbfs)
        kw = dict(dtype=self.f_eq.dtype, device=self.f_eq.device)
        x0 = torch.cat([torch.zeros((9,), **kw), self.f_eq.reshape(-1)])
        warm = Solution(x=x0.expand(S, nv).clone(),
                        y=torch.zeros((S, m), **kw),
                        z=torch.zeros((S, m), **kw),
                        prim_res=torch.zeros((S,), **kw),
                        dual_res=torch.zeros((S,), **kw))
        return CentralizedState(prev_f=self.f_eq.expand(S, n, 3).clone(),
                                warm=warm)

    def env_rows(self, forest: Forest, state: State) -> EnvRows:
        nx, lim = self.nx, self.lim
        cap_a, cap_b, cap_h, speed, cap_dir = braking_capsule(
            nx, state.xl, state.vl, lim.max_deceleration)
        data = capsule_distance(nx, forest, cap_a, cap_b,
                                collision_radius(), lim.vision_radius)
        return cbf_rows(nx, data, state.xl, state.vl, cap_h, speed, cap_dir,
                        lim.max_deceleration, lim.vision_radius,
                        lim.dist_eps, self.cfg.alpha_env_cbf,
                        self.cfg.n_env_cbfs)

    def qp(self, state: State, acc_des, env: EnvRows):
        """``(P, q, A, lb, ub, shift)`` of every scenario."""
        nx, p, lim, cfg = self.nx, self.params, self.lim, self.cfg
        n = p.n
        nv, n_box, _, soc_dims = centralized_dims(n, cfg.n_env_cbfs)
        kw = dict(dtype=state.xl.dtype, device=state.xl.device)
        S = state.xl.shape[0]
        eye3 = torch.eye(3, **kw)
        e3 = _e3(state.xl)
        dvl_des, dwl_des = acc_des
        Rl = state.Rl
        k_f = k_m = k_feq = 0.1
        P = torch.zeros((S, nv, nv), **kw)
        q = torch.zeros((S, nv), **kw)
        P[:, 3:6, 3:6] += 2.0 * eye3
        q[:, 3:6] += -2.0 * dvl_des
        P[:, 6:9, 6:9] += 2.0 * eye3
        q[:, 6:9] += -2.0 * dwl_des
        Ssum = eye3.repeat(1, n)
        G = nx.mm(hat(p.r_com)[None], Rl.transpose(-1, -2)[:, None]).permute(
            0, 2, 1, 3).reshape(S, 3, 3 * n)
        P[:, 9:, 9:] += (2.0 * k_f * nx.mm(Ssum.T, Ssum)
                         + 2.0 * k_m * nx.mm(G.transpose(-1, -2), G)
                         + 2.0 * k_feq * torch.eye(3 * n, **kw))
        q[:, 9:] += (-2.0 * k_f * (p.mT * GRAVITY * e3).repeat(n)
                     - 2.0 * k_feq * self.f_eq.reshape(-1))
        A = torch.zeros((S, n_box, nv), **kw)
        lb = torch.zeros((S, n_box), **kw)
        ub = torch.zeros((S, n_box), **kw)
        A[:, 0:3, 0:3] = p.mT * eye3
        A[:, 0:3, 9:] = -Ssum
        lb[:, 0:3] = -p.mT * GRAVITY * e3
        ub[:, 0:3] = -p.mT * GRAVITY * e3
        A[:, 3:6, 6:9] = eye3
        A[:, 3:6, 9:] = -nx.mm(p.JT_inv, G)
        rot = nx.mv(-p.JT_inv, torch.linalg.cross(
            state.wl, nx.mv(p.JT, state.wl), dim=-1))
        lb[:, 3:6] = rot
        ub[:, 3:6] = rot
        A[:, 6:9, 0:3] = -eye3
        A[:, 6:9, 3:6] = eye3
        A[:, 6:9, 6:9] = -nx.mm(Rl, hat(p.x_com))
        for i in range(n):
            A[:, 9 + i, 9 + 3 * i + 2] = 1.0
        lb[:, 9:9 + n] = lim.min_fz
        ub[:, 9:9 + n] = INF
        R_w_hat_sq = _cbf_common_rows(nx, lim, state, A, lb, ub, 9 + n,
                                      slice(3, 6), slice(6, 9))
        kin = nx.mv(-R_w_hat_sq, p.x_com)
        lb[:, 6:9] = kin
        ub[:, 6:9] = kin
        r_env = 12 + n
        A[:, r_env:r_env + cfg.n_env_cbfs, 3:6] = env.lhs
        lb[:, r_env:r_env + cfg.n_env_cbfs] = env.rhs
        ub[:, r_env:r_env + cfg.n_env_cbfs] = INF
        soc = torch.zeros((8 * n, nv), **kw)
        shift_soc = torch.zeros((8 * n,), **kw)
        for i in range(n):
            base, fi = 8 * i, 9 + 3 * i
            soc[base, fi + 2] = lim.sec_max_f_ang
            soc[base + 1:base + 4, fi:fi + 3] = eye3
            shift_soc[base + 4] = lim.max_f
            soc[base + 5:base + 8, fi:fi + 3] = eye3
        A = torch.cat([A, soc.expand(S, 8 * n, nv)], dim=1)
        shift = torch.cat([torch.zeros((n_box,), **kw), shift_soc]).expand(
            S, n_box + 8 * n)
        A, lb, ub, shift = equilibrate_rows(A, lb, ub, shift, n_box,
                                            soc_dims)
        return P, q, A, lb, ub, shift

    def step(self, css: CentralizedState, state: State, acc_des,
             forest: Forest) -> StepOut:
        """One control step of every scenario; a scenario whose solve
        misses ``solver_tol`` keeps its previous forces and warm start."""
        cfg, n = self.cfg, self.params.n
        S = state.xl.shape[0]
        env = self.env_rows(forest, state)
        P, q, A, lb, ub, shift = self.qp(state, acc_des, env)
        _, n_box, _, soc_dims = centralized_dims(n, cfg.n_env_cbfs)
        sol, eff = solve(self.nx, P, q, A, lb, ub, shift, css.warm,
                         n_box=n_box, soc_dims=soc_dims,
                         iters=cfg.solver_iters,
                         check_every=cfg.solver_check_every,
                         tol=cfg.solver_tol)
        f = sol.x[:, 9:].reshape(S, n, 3)
        ok = (sol.prim_res < cfg.solver_tol) & torch.all(
            torch.isfinite(sol.x), dim=-1)
        f_out = torch.where(ok[:, None, None], f, css.prev_f)
        warm = Solution(
            x=torch.where(ok[:, None], sol.x, css.warm.x),
            y=torch.where(ok[:, None], sol.y, css.warm.y),
            z=torch.where(ok[:, None], sol.z, css.warm.z),
            prim_res=sol.prim_res, dual_res=sol.dual_res)
        return StepOut(f=f_out, css=CentralizedState(prev_f=f_out, warm=warm),
                       outcome=ok.to(torch.int32), ok_frac=ok.to(f.dtype),
                       min_dist=env.min_dist, collision=env.collision,
                       eff=eff)
