"""PyTorch port vs the JAX package: the dual-decomposition controller --
its quasi-Newton plan, the per-agent QP, one control step (fixed and
adaptive effort, both solve routes) and a short rollout.

Tolerances, and why:

- Plan: the consensus matrix holds 0, +-1 and the hat(r_com) entries,
  which agree to 1e-8 (each framework derives r_com in float32); the
  strong-convexity matrices agree to float32 rounding of their small
  products (rtol 1e-6); their inverses and the 6n x 6n quasi-Newton
  inverse (LU in both frameworks, entries up to ~20) to 1e-5 relative to
  their largest entry.
- Agent QP: the same float32 operations in the same order, except the
  products' and the row norms' summation order: 1e-5 (the environment
  rows' witness point is pinned only to ~sqrt(eps) of the capsule length,
  tests/test_torch_forest.py, which these scenarios stay clear of).
- Control step: consensus iteration counts and total inner iterations are
  discrete and must be equal. Forces and duals agree to 2e-3 N, a fifth of
  the 1e-2 N consensus tolerance. DD's agent KKT matrices carry nine
  equality rows with 1e3-boosted penalties, so their float32 inverses
  (torch and JAX factor differently) differ by ~1e-4 relative, and 40
  inner iterations and the quasi-Newton step (entries up to ~20) carry
  that into the forces. With both frameworks given the same inverses the
  step agrees to 3e-5 N (test_control_step_with_shared_inverses: the
  violations cancel sums of ~16 N of force, ~1e-6 N of rounding each,
  grown over 20 quasi-Newton steps), which pins the difference on the
  inverse and nothing else. The residual
  sequence also gets rtol 1e-5: its first entries are consensus
  violations of ~13 N.
- Rollout: states to 1e-4, the bar of tests/test_torch_rollout.py.
"""

import bench
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_cadmm import _scenarios, _t

from tpu_aerial_transport.control import cadmm as jcadmm
from tpu_aerial_transport.control import centralized as jcentral
from tpu_aerial_transport.control import dd as jdd
from tpu_aerial_transport.envs import forest as jforest
from tpu_aerial_transport.harness import setup as jsetup
from tpu_aerial_transport.ops import socp as jsocp
from tpu_aerial_transport_torch.control import cadmm, centralized, dd
from tpu_aerial_transport_torch.envs import forest
from tpu_aerial_transport_torch.harness import rollout, setup
from tpu_aerial_transport_torch.ops import socp

KEYS = ("xl", "vl", "Rl", "wl", "R", "w")
ACC = (np.array([0.3, 0.0, 0.0], np.float32), np.zeros(3, np.float32))


def _jax_side(n, kw=None):
    jp, jcol, js = jsetup.rqp_setup(n)
    cfg = jdd.make_config(jp, jcol.collision_radius, jcol.max_deceleration,
                          max_iter=20, inner_iters=40, socp_fused="scan",
                          pad_operators=True, **(kw or {}))
    return jp, cfg, js


def _port_side(n, kw=None, route="kernel"):
    tp, tcol, ts = setup.rqp_setup(n, device="cpu")
    cfg = dd.make_config(tp, tcol.collision_radius, tcol.max_deceleration,
                         max_iter=20, inner_iters=40, pad_operators=True,
                         socp_fused=route, device="cpu", **(kw or {}))
    return tp, cfg, ts


def _jax_states(js, sc):
    return jax.vmap(lambda *a: js.replace(**dict(zip(KEYS, a))))(
        *(jnp.asarray(sc[k], jnp.float32) for k in KEYS))


def _port_states(ts, sc):
    S = sc["xl"].shape[0]
    return rollout.stack_scenarios(ts, S).replace(
        **{k: _t(sc[k]) for k in KEYS})


@pytest.mark.parametrize("n", [4, 8])
def test_plan_matches(n):
    """make_dd_plan (the payload-frame quasi-Newton cores with the
    Woodbury leader blocks), the per-step leader-corrected inverse, and the
    strong-convexity matrices at a tilted payload."""
    jp, jcfg, _ = _jax_side(n)
    tp, cfg, _ = _port_side(n)
    jplan = jdd.make_dd_plan(jp, jcfg)
    plan = dd.make_dd_plan(tp, cfg)
    np.testing.assert_allclose(plan.Ac.numpy(), np.asarray(jplan.Ac),
                               rtol=0, atol=1e-8)
    for name in ("qn_inv_base", "D"):
        a, b = np.asarray(getattr(jplan, name)), getattr(plan, name).numpy()
        np.testing.assert_allclose(b, a, rtol=0,
                                   atol=1e-5 * np.abs(a).max())
    # The leader-corrected inverse the control step applies: the rank-9
    # Woodbury update must equal a direct inverse of the corrected matrix.
    qn = dd._leader_qn_inverse(plan, 0, n).double()
    base = torch.linalg.inv(plan.qn_inv_base.double())
    A_l = plan.Ac[:, :9].double()
    direct = torch.linalg.inv(base + A_l @ plan.D[0].double() @ A_l.T)
    np.testing.assert_allclose(qn.numpy(), direct.numpy(), rtol=0,
                               atol=1e-4 * float(direct.abs().max()))
    # No leader: the base inverse, unchanged.
    assert torch.equal(dd._leader_qn_inverse(plan, -1, n), plan.qn_inv_base)
    # Strong convexity at a state with a tilted payload and a leader.
    sc = _scenarios(n, 1)
    js1 = jax.tree.map(lambda a: a[0], _jax_states(_jax_side(n)[2], sc))
    st = _port_states(_port_side(n)[2], sc)
    ts1 = type(st)(**{k: v[0] for k, v in vars(st).items()})
    lead = np.arange(n) == 1
    ref = jax.vmap(lambda r, R, w, ld: jdd.strong_convexity_matrix(
        jp, jcfg.base, js1, r, R, w, ld, jcfg.sc_eps))(
        jp.r_com, js1.R, js1.w, jnp.asarray(lead, jnp.float32))
    out = dd.strong_convexity_matrix(
        tp, cfg.base, ts1, tp.r_com, ts1.R, ts1.w,
        torch.as_tensor(lead, dtype=torch.float32), cfg.sc_eps)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("n", [4, 8])
def test_agent_qp_matches(n):
    """Every agent's 18-variable QP of every scenario, with the
    vision-cone environment rows, and the initial state."""
    sc = _scenarios(n)
    jp, jcfg, js = _jax_side(n)
    tp, cfg, ts = _port_side(n)
    jf = jforest.make_forest(seed=0)
    f_eq = jcentral.equilibrium_forces(jp)
    leaders = (jnp.arange(n) == 0).astype(jnp.float32)

    def jbuild(s):
        env = jcadmm.agent_env_cbfs_for(jp, jcfg.base, jf, s, jp.r)
        return jax.vmap(lambda fi, r, R, w, ld, cbf: jdd._build_agent_qp(
            jp, jcfg.base, fi, r, R, w, s, tuple(map(jnp.asarray, ACC)), cbf,
            ld))(f_eq, jp.r_com, s.R, s.w, leaders, env)

    ref = jax.jit(jax.vmap(jbuild))(_jax_states(js, sc))
    st = _port_states(ts, sc)
    env = cadmm.agent_env_cbfs_for(tp, cfg.base,
                                   forest.make_forest(seed=0, device="cpu"),
                                   st, tp.r)
    out = dd._build_agent_qp(
        tp, cfg.base, centralized.equilibrium_forces(tp), st,
        tuple(map(_t, ACC)), env, (torch.arange(n) == 0).float())
    for name, a, b in zip(("P", "q", "A", "lb", "ub", "shift"), ref, out):
        assert b.shape == np.asarray(a).shape, name
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0,
                                   atol=1e-5, err_msg=name)
    init_ref = jdd.init_dd_state(jp, jcfg)
    init = dd.init_dd_state(tp, cfg)
    for name in ("f", "F", "M", "lam_F", "lam_M"):
        np.testing.assert_allclose(getattr(init, name).numpy(),
                                   np.asarray(getattr(init_ref, name)),
                                   rtol=0, atol=1e-5, err_msg=name)
    for a, b in zip(init_ref.warm, init.warm):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0,
                                   atol=1e-5)


def _step_pair(n, kw=None, route="kernel", S=3):
    sc = _scenarios(n, S)
    jp, jcfg, js = _jax_side(n, kw)
    f_eq = jcentral.equilibrium_forces(jp)
    cs0 = jdd.init_dd_state(jp, jcfg)
    plan = jdd.make_dd_plan(jp, jcfg)
    jf = jforest.make_forest(seed=0)
    acc = tuple(map(jnp.asarray, ACC))
    css = jax.vmap(lambda _: cs0)(jnp.arange(S))
    ref = jax.jit(jax.vmap(lambda cs, s: jdd.control(
        jp, jcfg, f_eq, cs, s, acc, jf, plan=plan)))(css, _jax_states(js, sc))

    tp, cfg, ts = _port_side(n, kw, route)
    tf_eq = centralized.equilibrium_forces(tp)
    tcss = rollout.stack_scenarios(dd.init_dd_state(tp, cfg, tf_eq), S)
    out = dd.control(tp, cfg, tf_eq, tcss, _port_states(ts, sc),
                     tuple(map(_t, ACC)),
                     forest.make_forest(seed=0, device="cpu"),
                     plan=dd.make_dd_plan(tp, cfg))
    return ref, out


def _assert_step(ref, out, atol):
    (jf_app, jcs, jst), (f_app, cs, st) = ref, out
    np.testing.assert_array_equal(st.iters.numpy(), np.asarray(jst.iters))
    assert int(st.iters.max()) > 1
    np.testing.assert_array_equal(st.inner_iters.numpy(),
                                  np.asarray(jst.inner_iters))
    np.testing.assert_array_equal(st.ok_frac.numpy(), np.asarray(jst.ok_frac))
    np.testing.assert_array_equal(st.collision.numpy(),
                                  np.asarray(jst.collision))
    for a, b in ((jf_app, f_app), (jcs.F, cs.F), (jcs.M, cs.M),
                 (jcs.lam_F, cs.lam_F), (jcs.lam_M, cs.lam_M),
                 (jst.solve_res, st.solve_res)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=atol,
                                   rtol=0)
    np.testing.assert_allclose(st.err_seq.numpy(), np.asarray(jst.err_seq),
                               atol=atol, rtol=1e-5, equal_nan=True)


@pytest.mark.parametrize("effort", ["fixed", "adaptive"])
@pytest.mark.parametrize("n", [4, 8])
def test_control_step_matches_vmapped_jax(n, effort):
    ref, out = _step_pair(n, dict(effort=effort))
    _assert_step(ref, out, 2e-3)
    inner = out[2].inner_iters
    if effort == "adaptive":
        # Gate-only: every active scenario's solves run the full budget.
        assert torch.equal(inner, n * 40 * out[2].iters)
    else:
        assert inner.shape == (3, 0)


def test_control_step_pallas_route():
    """The chunked route (socp_fused="pallas"), adaptive, at n = 8."""
    ref, out = _step_pair(8, dict(effort="adaptive"), route="pallas")
    _assert_step(ref, out, 2e-3)


def _f64_inverse_operator(P, A, rho_vec, sigma=1e-6):
    """The KKT operator with its inverse taken in float64 and rounded to
    float32, as numpy arrays (both frameworks then see the same one)."""
    P, A, rho_vec = (np.asarray(x, np.float64) for x in (P, A, rho_vec))
    nv = P.shape[-1]
    AT = np.swapaxes(A, -1, -2)
    M = P + sigma * np.eye(nv) + (AT * rho_vec[..., None, :]) @ A
    Minv = np.linalg.inv(M)
    Minv = 0.5 * (Minv + np.swapaxes(Minv, -1, -2))
    K = np.concatenate([sigma * Minv, Minv @ AT], axis=-1)
    K2 = np.concatenate([K, A @ K], axis=-2)
    f32 = lambda a: a.astype(np.float32)  # noqa: E731
    return f32(Minv), f32(Minv @ AT), f32(K2)


def test_control_step_with_shared_inverses(monkeypatch):
    """With both frameworks given the same (float64-derived) KKT inverses,
    the DD step agrees to 3e-5 N: the 2e-3 N bar above covers the float32
    inverse and nothing else."""

    def jax_op(P, A, rho_vec, sigma=1e-6):
        shapes = (P.shape, P.shape[:-2] + A.shape[-1:] + A.shape[-2:-1],
                  P.shape[:-2] + (P.shape[-1] + A.shape[-2],) * 2)
        Minv, MinvAT, K2 = jax.pure_callback(
            _f64_inverse_operator,
            tuple(jax.ShapeDtypeStruct(s, jnp.float32) for s in shapes),
            P, A, rho_vec, vmap_method="broadcast_all")
        return jsocp.KKTOp(
            Minv=Minv, MinvAT=MinvAT, K2=K2,
            sigma=jnp.broadcast_to(jnp.asarray(sigma, P.dtype),
                                   P.shape[:-2]))

    def port_op(P, A, rho_vec, sigma=1e-6):
        return socp.KKTOp(*map(torch.as_tensor, _f64_inverse_operator(
            P.numpy(), A.numpy(), rho_vec.numpy(), sigma)))

    monkeypatch.setattr(jsocp, "kkt_operator", jax_op)
    monkeypatch.setattr(socp, "kkt_operator", port_op)
    ref, out = _step_pair(8, dict(effort="adaptive"))
    _assert_step(ref, out, 3e-5)


def test_dd_rollout_matches_bench():
    """The DD workload as a whole: ``bench.make_mpc_step("dd", 8,
    effort="adaptive")`` vmapped over 4 seeded scenarios for 2 MPC steps
    against the port's ``rollout.make_mpc_step("dd", 8, ...)``: equal
    iteration counts per step, states to 1e-4."""
    S, steps = 4, 2
    jstep, jcs0, jstate0 = bench.make_mpc_step("dd", 8, effort="adaptive",
                                               socp_fused="scan")
    jstates = bench._scenario_batch(jstate0, S)
    jcss = jax.vmap(lambda _: jcs0)(jnp.arange(S))
    jrun = jax.jit(jax.vmap(jstep))
    mpc_step, cs0, state0 = rollout.make_mpc_step(
        "dd", 8, effort="adaptive", device="cpu")
    states = rollout.scenario_batch(state0, S)
    css = rollout.stack_scenarios(cs0, S)
    for _ in range(steps):
        jcss, jstates, jst = jrun(jcss, jstates)
        css, states, st = mpc_step(css, states)
        np.testing.assert_array_equal(st.iters.numpy(), np.asarray(jst.iters))
        np.testing.assert_array_equal(st.inner_iters.numpy(),
                                      np.asarray(jst.inner_iters))
    for f in KEYS:
        np.testing.assert_allclose(getattr(states, f).numpy(),
                                   np.asarray(getattr(jstates, f)),
                                   atol=1e-4, rtol=0, err_msg=f)
