"""PyTorch port vs the JAX package: one C-ADMM control step over a batch of
scenarios (the port's explicit scenario axis against ``jax.vmap`` of the JAX
controller) with the Schur-reduced QP, the full QP, the rho schedule and the
two-phase inner budget, and the equilibrium forces.

Tolerances, and why: the agent QPs are built from float32 operations that
both packages run in the same order, but the Schur plan's and the KKT
operators' inverses (``torch.linalg.inv`` vs JAX's LU) and every small
matrix product round differently in the last bits; the fixed-iteration ADMM
then carries those differences through 20 inner iterations per consensus
iteration, with the equality rows' 1e3-boosted penalties amplifying them.
Forces agree to 1e-4 N (on forces of ~3 N, and against the consensus
tolerance of 1e-2 N). Consensus iteration counts are discrete and must be
equal in every scenario. The full agent QP's bar is 1e-3 N (see
OPTION_CASES below for why).
"""

import bench
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_aerial_transport.control import cadmm as jcadmm
from tpu_aerial_transport.control import centralized as jcentral
from tpu_aerial_transport.envs import forest as jforest
from tpu_aerial_transport.harness import setup as jsetup
from tpu_aerial_transport.ops import lie as jlie
from tpu_aerial_transport_torch.control import cadmm, centralized
from tpu_aerial_transport_torch.envs import forest
from tpu_aerial_transport_torch.harness import rollout, setup


def _t(a):
    return torch.as_tensor(np.array(a, np.float32))


def _scenarios(n, S=3, seed=0):
    """S scenarios: one from the headline's start distribution, the others
    in the forest beside trees, moving toward them, with tilted, spinning
    payloads and quadrotors."""
    rng = np.random.default_rng(seed)
    xl = np.array([[5.5, 0.4, 2.2], [26.3, 2.1, 4.4], [36.0, -6.0, 4.6]])[:S]
    vl = np.array([[0.5, 0.0, 0.0], [0.9, -0.4, 0.0], [-0.6, 0.8, 0.1]])[:S]
    rot = lambda s, k: np.asarray(jlie.expm_so3(  # noqa: E731
        jnp.asarray(s * rng.normal(size=(k, 3)), jnp.float32)))
    return dict(
        xl=xl, vl=vl, Rl=np.stack([rot(0.05, 1)[0] for _ in range(S)]),
        wl=0.1 * rng.normal(size=(S, 3)),
        R=np.stack([rot(0.1, n) for _ in range(S)]),
        w=0.2 * rng.normal(size=(S, n, 3)),
    )


def _jax_step(n, pad, sc):
    jp, jcol, js = jsetup.rqp_setup(n)
    cfg = jcadmm.make_config(
        jp, jcol.collision_radius, jcol.max_deceleration, max_iter=20,
        inner_iters=20, socp_fused="scan", pad_operators=pad,
    )
    f_eq = jcentral.equilibrium_forces(jp)
    cs0 = jcadmm.init_cadmm_state(jp, cfg)
    plan = jcadmm.make_plan(jp, cfg)
    jf = jforest.make_forest(seed=0)
    acc = (jnp.array([0.3, 0.0, 0.0], jnp.float32), jnp.zeros(3, jnp.float32))
    S = sc["xl"].shape[0]
    css = jax.vmap(lambda _: cs0)(jnp.arange(S))
    states = jax.vmap(lambda *a: js.replace(**dict(zip(
        ("xl", "vl", "Rl", "wl", "R", "w"), a))))(
        *(jnp.asarray(sc[k], jnp.float32)
          for k in ("xl", "vl", "Rl", "wl", "R", "w")))
    # cfg and plan are closed over, as bench.py's headline step does.
    step = jax.jit(jax.vmap(lambda cs, s: jcadmm.control(
        jp, cfg, f_eq, cs, s, acc, jf, plan=plan)))
    return step(css, states)


def _torch_step(n, pad, sc):
    tp, tcol, ts = setup.rqp_setup(n, device="cpu")
    cfg = cadmm.make_config(
        tp, tcol.collision_radius, tcol.max_deceleration, max_iter=20,
        inner_iters=20, pad_operators=pad, device="cpu",
    )
    f_eq = centralized.equilibrium_forces(tp)
    S = sc["xl"].shape[0]
    css = rollout.stack_scenarios(cadmm.init_cadmm_state(tp, cfg, f_eq), S)
    states = rollout.stack_scenarios(ts, S).replace(
        **{k: _t(sc[k]) for k in ("xl", "vl", "Rl", "wl", "R", "w")})
    acc = (_t([0.3, 0.0, 0.0]), torch.zeros(3))
    return cadmm.control(tp, cfg, f_eq, css, states, acc,
                         forest.make_forest(seed=0, device="cpu"),
                         plan=cadmm.make_plan(tp, cfg))


@pytest.mark.parametrize("pad", [True, False], ids=["padded", "unpadded"])
@pytest.mark.parametrize("n", [4, 8, 16])
def test_control_step_matches_vmapped_jax(n, pad):
    # n = 16 on two scenarios, as few as keep the consensus loop iterating.
    S = 2 if n == 16 else 3
    sc = _scenarios(n, S)
    jf_app, jcs, jst = _jax_step(n, pad, sc)
    f_app, cs, st = _torch_step(n, pad, sc)

    np.testing.assert_array_equal(st.iters.numpy(), np.asarray(jst.iters))
    assert int(st.iters.max()) > 1  # the consensus loop really iterated.
    assert f_app.shape == (S, n, 3)
    np.testing.assert_allclose(f_app.numpy(), np.asarray(jf_app), atol=1e-4,
                               rtol=0)
    np.testing.assert_allclose(cs.f.numpy(), np.asarray(jcs.f), atol=1e-4,
                               rtol=0)
    np.testing.assert_allclose(cs.f_mean.numpy(), np.asarray(jcs.f_mean),
                               atol=1e-4, rtol=0)
    # Duals: rho (= 1) times force differences.
    np.testing.assert_allclose(cs.lam.numpy(), np.asarray(jcs.lam),
                               atol=1e-4, rtol=0)
    # SolverStats: the residual sequence (NaN past each scenario's last
    # iteration), the final residual, the solve-success fraction (exact:
    # a count of agents), collision flag and min env distance.
    np.testing.assert_allclose(st.err_seq.numpy(), np.asarray(jst.err_seq),
                               atol=1e-4, rtol=0, equal_nan=True)
    np.testing.assert_allclose(st.solve_res.numpy(), np.asarray(jst.solve_res),
                               atol=1e-4, rtol=0)
    np.testing.assert_array_equal(st.ok_frac.numpy(), np.asarray(jst.ok_frac))
    np.testing.assert_array_equal(st.collision.numpy(),
                                  np.asarray(jst.collision))
    np.testing.assert_allclose(st.min_env_dist.numpy(),
                               np.asarray(jst.min_env_dist), atol=1e-5,
                               rtol=0)
    # Warm starts carried to the next step: same layout, same iterates.
    for a, b in zip(jcs.warm, cs.warm):
        assert b.shape == np.asarray(a).shape
    np.testing.assert_allclose(cs.warm.x.numpy(), np.asarray(jcs.warm.x),
                               atol=1e-4, rtol=0)


def test_frozen_scenarios_keep_their_carry():
    """A scenario that converged keeps its state while the batch drains a
    slower one: each scenario of a batch equals its solo run."""
    n = 4
    sc = _scenarios(n)
    _, cs, st = _torch_step(n, False, sc)
    assert len(set(st.iters.tolist())) > 1  # the lanes finish apart.
    for i in range(3):
        one = {k: v[i:i + 1] for k, v in sc.items()}
        _, cs1, st1 = _torch_step(n, False, one)
        assert int(st1.iters[0]) == int(st.iters[i])
        np.testing.assert_allclose(cs1.f[0].numpy(), cs.f[i].numpy(),
                                   atol=1e-6, rtol=0)


@pytest.mark.parametrize("n", [4, 8])
def test_equilibrium_forces(n):
    """The closed-form minimum-norm solution against JAX's lstsq: the same
    vertical thrusts to float32 rounding (rtol 1e-6 of ~1.7 N)."""
    jp, _, _ = jsetup.rqp_setup(n)
    tp, _, _ = setup.rqp_setup(n, device="cpu")
    ref = np.asarray(jcentral.equilibrium_forces(jp))
    out = centralized.equilibrium_forces(tp).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-6, atol=1e-6)
    assert np.all(out[:, :2] == 0)
    # Alive mask: a dead agent carries nothing, the others share the load.
    alive = np.ones(n, bool)
    alive[1] = False
    ref_a = np.asarray(jcentral.equilibrium_forces(jp, jnp.asarray(alive)))
    out_a = centralized.equilibrium_forces(tp, torch.as_tensor(alive)).numpy()
    np.testing.assert_allclose(out_a, ref_a, rtol=1e-5, atol=1e-5)
    assert out_a[1, 2] == 0.0


def _options_pair(n, kw, pad=True, S=3):
    """One C-ADMM control step of S scenarios with the controller options
    ``kw``: vmapped JAX (scan path) and the port."""
    sc = _scenarios(n, S)
    keys = ("xl", "vl", "Rl", "wl", "R", "w")
    jp, jcol, js = jsetup.rqp_setup(n)
    jcfg = jcadmm.make_config(
        jp, jcol.collision_radius, jcol.max_deceleration, max_iter=20,
        inner_iters=20, socp_fused="scan", pad_operators=pad, **kw)
    f_eq = jcentral.equilibrium_forces(jp)
    cs0 = jcadmm.init_cadmm_state(jp, jcfg)
    plan = jcadmm.make_plan(jp, jcfg)
    acc = (jnp.array([0.3, 0.0, 0.0], jnp.float32), jnp.zeros(3, jnp.float32))
    css = jax.vmap(lambda _: cs0)(jnp.arange(S))
    states = jax.vmap(lambda *a: js.replace(**dict(zip(keys, a))))(
        *(jnp.asarray(sc[k], jnp.float32) for k in keys))
    ref = jax.jit(jax.vmap(lambda cs, s: jcadmm.control(
        jp, jcfg, f_eq, cs, s, acc, jforest.make_forest(seed=0),
        plan=plan)))(css, states)
    tp, tcol, ts = setup.rqp_setup(n, device="cpu")
    cfg = cadmm.make_config(
        tp, tcol.collision_radius, tcol.max_deceleration, max_iter=20,
        inner_iters=20, pad_operators=pad, device="cpu", **kw)
    tf_eq = centralized.equilibrium_forces(tp)
    tcss = rollout.stack_scenarios(cadmm.init_cadmm_state(tp, cfg, tf_eq), S)
    tst = rollout.stack_scenarios(ts, S).replace(
        **{k: _t(sc[k]) for k in keys})
    out = cadmm.control(tp, cfg, tf_eq, tcss, tst,
                        (_t([0.3, 0.0, 0.0]), torch.zeros(3)),
                        forest.make_forest(seed=0, device="cpu"),
                        plan=cadmm.make_plan(tp, cfg))
    return ref, out


# (n, options, pad, force bar in N). The full (9 + 3n)-variable agent QP
# carries nine equality rows with 1e3-boosted penalties (the reduced one
# three), so its float32 KKT inverse rounds differently in the two
# frameworks by ~1e-6 of K2, and 20 inner iterations in each of up to 21
# consensus iterations grow that to ~5e-4 N of force: the port alone moves
# by 9e-5 N at n = 3 when only its inverse is taken in float64. Its bar is
# 1e-3 N, a tenth of the consensus tolerance; the reduced QP keeps the
# 1e-4 N bar of the tests above.
OPTION_CASES = [
    (3, {}, True, 1e-3),
    (3, {}, False, 1e-3),
    (4, dict(reduced_qp=False), True, 1e-3),
    (8, dict(tau_incr=1.5), True, 1e-4),
    (3, dict(tau_incr=1.5), True, 1e-3),
    (8, dict(inner_iters_warm=10), True, 1e-4),
    (3, dict(inner_iters_warm=10, effort="adaptive"), True, 1e-3),
    (8, dict(tau_incr=1.5, effort="adaptive"), True, 1e-4),
]


@pytest.mark.parametrize(
    "n, kw, pad, bar", OPTION_CASES,
    ids=[f"n{c[0]}-{'-'.join(f'{k}={v}' for k, v in c[1].items()) or 'full'}"
         f"-{'padded' if c[2] else 'unpadded'}" for c in OPTION_CASES])
def test_control_options_match_vmapped_jax(n, kw, pad, bar):
    """The full agent QP (n = 3, and forced at n = 4), the increasing rho
    schedule (tau_incr = 1.5: rho 1, 1.5, 2) and the two-phase inner
    budget, alone and with adaptive effort: equal consensus iteration
    counts (and inner iterations), forces, duals and warm starts to the
    case's bar."""
    (jf_app, jcs, jst), (f_app, cs, st) = _options_pair(n, kw, pad)
    np.testing.assert_array_equal(st.iters.numpy(), np.asarray(jst.iters))
    assert int(st.iters.max()) > 2
    np.testing.assert_array_equal(st.inner_iters.numpy(),
                                  np.asarray(jst.inner_iters))
    for a, b in ((jf_app, f_app), (jcs.f, cs.f), (jcs.f_mean, cs.f_mean),
                 (jcs.lam, cs.lam), (jcs.warm.x, cs.warm.x)):
        assert b.shape == np.asarray(a).shape
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=bar, rtol=0)
    np.testing.assert_array_equal(st.ok_frac.numpy(), np.asarray(jst.ok_frac))
    np.testing.assert_allclose(st.err_seq.numpy(), np.asarray(jst.err_seq),
                               atol=bar, rtol=0, equal_nan=True)


@pytest.mark.parametrize("kw", [
    dict(), dict(tau_incr=1.5), dict(tau_incr=1.1, max_iter=3),
    dict(tau_incr=3.0, rho0=0.5, rho_max=10.0),
], ids=["constant", "tau1.5", "capped_by_max_iter", "tau3"])
def test_rho_schedule_and_plan_match_jax(kw):
    """The schedule's penalties, and the Schur plan built for every one of
    them (leading n_rho axis), equal the JAX package's (plan cores to 1e-5
    of their largest entry: inverses of (3(n-1))^2 blocks)."""
    n = 8
    jp, jcol, _ = jsetup.rqp_setup(n)
    tp, tcol, _ = setup.rqp_setup(n, device="cpu")
    jcfg = jcadmm.make_config(jp, jcol.collision_radius,
                              jcol.max_deceleration, pad_operators=True, **kw)
    cfg = cadmm.make_config(tp, tcol.collision_radius, tcol.max_deceleration,
                            pad_operators=True, device="cpu", **kw)
    rhos = cadmm._rho_schedule(cfg)
    assert rhos == jcadmm._rho_schedule(jcfg)
    jplan = jcadmm.make_plan(jp, jcfg)
    plan = cadmm.make_plan(tp, cfg)
    assert plan.J.shape[:2] == (len(rhos), n)
    for name, a, b in zip(plan._fields, jplan, plan):
        a = np.asarray(a)
        assert b.shape == a.shape, name
        np.testing.assert_allclose(b.numpy(), a, rtol=0,
                                   atol=1e-5 * max(1.0, np.abs(a).max()),
                                   err_msg=name)


def test_full_qp_state_matches_jax_and_converts():
    """n = 3 runs the full QP: no plan, warm starts in the full layout
    ((n, nv_p) and (n, m_p), no Schur reduction), equal to the JAX
    package's and carried across by ``convert.cadmm_state``."""
    from tpu_aerial_transport_torch import convert

    jp, jcol, _ = jsetup.rqp_setup(3)
    tp, tcol, _ = setup.rqp_setup(3, device="cpu")
    for pad in (True, False):
        jcfg = jcadmm.make_config(jp, jcol.collision_radius,
                                  jcol.max_deceleration, pad_operators=pad)
        cfg = cadmm.make_config(tp, tcol.collision_radius,
                                tcol.max_deceleration, pad_operators=pad,
                                device="cpu")
        assert cadmm.make_plan(tp, cfg) is None
        assert cadmm._qp_dims(cfg, 3) == jcadmm._qp_dims(jcfg, 3)
        own = cadmm.init_cadmm_state(tp, cfg)
        conv = convert.cadmm_state(
            jax.tree.map(np.asarray, jcadmm.init_cadmm_state(jp, jcfg)),
            device="cpu")
        nv_p, m_p = (24, 32) if pad else (18, 31)
        assert own.warm.x.shape == (3, nv_p) and own.warm.y.shape == (3, m_p)
        # Equal up to the equilibrium forces' own bar (rtol 1e-6, see
        # test_equilibrium_forces).
        for a, b in zip(conv.warm, own.warm):
            assert a.shape == b.shape
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6,
                                       atol=1e-6)


def test_full_qp_rollout_matches_bench():
    """C-ADMM at n = 3 as the JAX bench runs it on the CPU
    (``make_mpc_step("cadmm", 3)``: the full QP, unpadded), 2 MPC steps of
    4 seeded scenarios: equal consensus iteration counts per step, states
    to 1e-4 (the bar of tests/test_torch_rollout.py)."""
    S = 4
    jstep, jcs0, jst0 = bench.make_mpc_step("cadmm", 3)
    jstates = bench._scenario_batch(jst0, S)
    jcss = jax.vmap(lambda _: jcs0)(jnp.arange(S))
    jrun = jax.jit(jax.vmap(jstep))
    run, css, states = rollout.build(n=3, n_scenarios=S, device="cpu")
    for _ in range(2):
        jcss, jstates, jst = jrun(jcss, jstates)
        css, states, iters = run(css, states, 1)
        np.testing.assert_array_equal(iters[0].numpy(), np.asarray(jst.iters))
    for f in ("xl", "vl", "Rl", "wl", "R", "w"):
        np.testing.assert_allclose(getattr(states, f).numpy(),
                                   np.asarray(getattr(jstates, f)),
                                   atol=1e-4, rtol=0, err_msg=f)
