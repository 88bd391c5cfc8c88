"""PyTorch port vs the JAX package: the RP centralized controller
(``control/rp_centralized.py``), the RP consensus-ADMM controller
(``control/rp_cadmm.py``) and its agent-sharded step
(``parallel.mesh.rp_cadmm_control_sharded``). Mirrors
``tests/test_rp_cadmm.py`` and the RP closed-loop case of
``tests/test_dd_rp.py``; the JAX functions run as their own tests run them
(route "scan" on the CPU), the port on its CPU path (the kernels' plain
versions), both on the same numpy-seeded inputs and the same float32
parameters.

Tolerances, and why:

- Config: exact (the same float32 ``cos`` and Python arithmetic).
- ``equilibrium_forces``: 1e-5 N. JAX takes ``lstsq`` (an SVD), the port
  the closed form ``W^T (W W^T)^-1 rhs`` of the same minimum-norm solution
  (``W`` has full row rank); ~0.5 N entries in float32.
- QP data: 1e-5 absolute (the same float32 operations; row norms and the
  small products summed in another order).
- One control step over 3 scenarios: forces within 1e-3 N (centralized, 150
  fixed iterations) and 2e-3 N (C-ADMM). Both solves run in float32 from
  the same start; the 1e3-boosted equality rows amplify the rounding of
  A x into the duals, and the iterates carry it (the measured gaps are
  about a tenth of these bars). Consensus iteration counts equal, and
  ``ok_frac`` equal.
- Agreement with the centralized solution (5e-3 N), the actuation limits
  (1e-3) and the warm restart (at most 2 iterations): the JAX tests' own
  bars, on the port alone.
- The sharded step against the single program: forces 2e-4 N and
  iterations +-1, the JAX sharded test's bars (the consensus mean is summed
  in another order).
- The first 30 periods of each closed loop, at every period: iteration
  counts equal; the centralized loop's forces within 1e-4 N and states
  within 1e-5 (its 120-iteration solves converge, and the measured gaps
  stay under 3e-6 N and 4e-7); C-ADMM's forces within 1e-3 N and states
  within 1e-3. Its 40-iteration agent solves stop short of convergence,
  so their rounding leaves force gaps of up to ~7e-5 N a period, which
  the payload's rotation turns into angular-velocity gaps (Jl_inv ~ 50,
  lever arms 0.5 m) that grow over the periods: ~1e-4 rad/s by period 23
  (measured), bounded here with a 10x margin. The JAX tests' quality bars
  (tracking error after 300 periods, the tilt bound) need 500 and 800
  periods, beyond this file's time budget: here the port is held to the
  JAX trajectory over the first periods instead.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_aerial_transport.control import rp_cadmm as jrpa
from tpu_aerial_transport.control import rp_centralized as jrpc
from tpu_aerial_transport.harness import setup as jsetup
from tpu_aerial_transport.models import rp as jrp
from tpu_aerial_transport_torch import convert
from tpu_aerial_transport_torch.control import rp_cadmm, rp_centralized
from tpu_aerial_transport_torch.harness import rollout, setup
from tpu_aerial_transport_torch.models import rp
from tpu_aerial_transport_torch.parallel import mesh

ACC = ((0.3, 0.0, 0.1), (0.0, 0.0, 0.05))
# The closed loops' bars at every period (see the module docstring).
LOOP_FORCE_BAR = {"centralized": 1e-4, "cadmm": 1e-3}
LOOP_STATE_BAR = {"centralized": 1e-5, "cadmm": 1e-3}


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _t(a):
    return torch.as_tensor(np.asarray(a, np.float32))


def _pair(n=3):
    jp, _, js = jsetup.rp_setup(n)
    tp = convert.rp_params(_np(jp), device="cpu")
    return jp, js, tp


def _scenarios(S=3, seed=0):
    """Per-scenario payload velocities and angular velocities."""
    rng = np.random.default_rng(seed)
    return rng.normal(size=(S, 3)) * 0.15, rng.normal(size=(S, 3)) * 0.05


def _states(js, vl, wl):
    """The JAX states one by one and the port's stacked batch."""
    jstates = [js.replace(vl=jnp.asarray(v, jnp.float32),
                          wl=jnp.asarray(w, jnp.float32))
               for v, w in zip(vl, wl)]
    tstates = rollout.stack_scenarios(
        convert.rp_state(_np(js), device="cpu"), len(vl)).replace(
        vl=_t(vl), wl=_t(wl))
    return jstates, tstates


def _jacc():
    return tuple(jnp.asarray(a, jnp.float32) for a in ACC)


def _tacc():
    return tuple(_t(a) for a in ACC)


@pytest.mark.parametrize("n", [3, 8])
def test_configs_match_jax(n):
    jp, _, tp = _pair(n)
    for ref, got in ((jrpc.make_config(jp), rp_centralized.make_config(tp)),
                     (jrpa.make_config(jp, max_iter=7, carry_duals=True),
                      rp_cadmm.make_config(tp, max_iter=7,
                                           carry_duals=True))):
        for f in dataclasses.fields(got):
            a, b = getattr(got, f.name), getattr(ref, f.name)
            if dataclasses.is_dataclass(a):
                for g in dataclasses.fields(a):
                    assert getattr(a, g.name) == getattr(b, g.name), g.name
            else:
                assert a == b, f.name


@pytest.mark.parametrize("n", [3, 4, 8])
def test_equilibrium_forces_match_jax_lstsq(n):
    jp, _, tp = _pair(n)
    f = rp_centralized.equilibrium_forces(tp)
    np.testing.assert_allclose(f.numpy(),
                               np.asarray(jrpc.equilibrium_forces(jp)),
                               atol=1e-5, rtol=0)
    assert float(f[:, :2].abs().max()) == 0.0


@pytest.mark.parametrize("n", [3, 8])
def test_build_qp_and_agent_qps_match_jax(n):
    """The centralized QP of 3 scenarios, and every agent's C-ADMM QP
    (``jax.vmap`` of the JAX ``_agent_qp`` over the agents), scales
    included."""
    jp, js, tp = _pair(n)
    vl, wl = _scenarios()
    jstates, tstates = _states(js, vl, wl)
    f_eq = rp_centralized.equilibrium_forces(tp)
    jf_eq = jrpc.equilibrium_forces(jp)
    cfg, jcfg = rp_centralized.make_config(tp), jrpc.make_config(jp)
    out = rp_centralized._build_qp(tp, cfg, f_eq, tstates, _tacc())
    dcfg, jdcfg = rp_cadmm.make_config(tp), jrpa.make_config(jp)
    agents = rp_cadmm._agent_qp(tp, dcfg, f_eq, tstates, _tacc())
    onehots = jnp.eye(n)
    leaders = (jnp.arange(n) == 0).astype(jnp.float32)
    build = jax.jit(lambda st: jrpc._build_qp(jp, jcfg, jf_eq, st, _jacc()))
    agent_qps = jax.jit(lambda st: jax.vmap(lambda oh, ld: jrpa._agent_qp(
        jp, jdcfg, jf_eq, st, _jacc(), oh, ld))(onehots, leaders))
    for s, jst in enumerate(jstates):
        ref = build(jst)
        for name, a, b in zip(("P", "q", "A", "lb", "ub", "shift", "scales"),
                              out, ref):
            np.testing.assert_allclose(a[s].numpy(), np.asarray(b),
                                       atol=1e-5, rtol=0, err_msg=name)
        ref_a = agent_qps(jst)
        for name, a, b in zip(("P", "q", "A", "lb", "ub", "shift"), agents,
                              ref_a):
            np.testing.assert_allclose(a[s].numpy(), np.asarray(b),
                                       atol=1e-5, rtol=0, err_msg=name)


def test_centralized_step_matches_jax():
    """One centralized step over 3 scenarios against the JAX controller
    per scenario: forces, residuals, fallback and stats."""
    jp, js, tp = _pair(3)
    vl, wl = _scenarios()
    jstates, tstates = _states(js, vl, wl)
    cfg, jcfg = rp_centralized.make_config(tp), jrpc.make_config(jp)
    jf_eq, f_eq = jrpc.equilibrium_forces(jp), \
        rp_centralized.equilibrium_forces(tp)
    jcs = jrpc.init_ctrl_state(jp, jcfg)
    cs = rollout.stack_scenarios(rp_centralized.init_ctrl_state(tp, cfg), 3)
    f, cs1, stats = rp_centralized.control(tp, cfg, f_eq, cs, tstates,
                                           _tacc())
    jstep = jax.jit(lambda c, s: jrpc.control(jp, jcfg, jf_eq, c, s,
                                              _jacc()))
    for s, jst in enumerate(jstates):
        jf, jcs1, jstats = jstep(jcs, jst)
        np.testing.assert_allclose(f[s].numpy(), np.asarray(jf), atol=1e-3,
                                   rtol=0)
        assert (float(stats.solve_res[s]) < cfg.solver_tol) == (
            float(jstats.solve_res) < jcfg.solver_tol)
        assert int(stats.iters[s]) == int(jstats.iters) == -1
        assert float(stats.ok_frac[s]) == float(jstats.ok_frac) == 1.0
    assert stats.err_seq.shape == (3, 0)
    assert torch.equal(cs1.prev_f, f)


@pytest.mark.parametrize("carry_duals", [False, True])
def test_cadmm_step_matches_jax_vmap(carry_duals):
    """One C-ADMM step over 3 scenarios against ``jax.vmap`` of the JAX
    controller, from a state whose duals are not zero (so carrying them
    matters): forces, copies, duals, iteration counts and ok_frac."""
    jp, js, tp = _pair(3)
    vl, wl = _scenarios()
    jstates, tstates = _states(js, vl, wl)
    jcfg = jrpa.make_config(jp, max_iter=30, inner_iters=30, res_tol=1e-3,
                            carry_duals=carry_duals)
    cfg = rp_cadmm.make_config(tp, max_iter=30, inner_iters=30, res_tol=1e-3,
                               carry_duals=carry_duals)
    jf_eq = jrpc.equilibrium_forces(jp)
    f_eq = rp_centralized.equilibrium_forces(tp)
    lam = 0.02 * np.random.default_rng(5).normal(size=(3, 3, 3, 3))
    jcs = jax.vmap(lambda lm: jrpa.init_state(jp, jcfg, jf_eq).replace(
        lam=lm))(jnp.asarray(lam, jnp.float32))
    cs = convert.rp_cadmm_state(_np(jcs), device="cpu")
    jst = jax.tree.map(lambda *x: jnp.stack(x), *jstates)
    jf, jcs1, jstats = jax.jit(jax.vmap(
        lambda c, s: jrpa.control(jp, jcfg, jf_eq, c, s, _jacc())))(jcs, jst)
    f, cs1, stats = rp_cadmm.control(tp, cfg, f_eq, cs, tstates, _tacc())
    assert stats.iters.tolist() == np.asarray(jstats.iters).tolist()
    np.testing.assert_array_equal(stats.ok_frac.numpy(),
                                  np.asarray(jstats.ok_frac))
    np.testing.assert_allclose(f.numpy(), np.asarray(jf), atol=2e-3, rtol=0)
    np.testing.assert_allclose(cs1.f.numpy(), np.asarray(jcs1.f), atol=2e-3,
                               rtol=0)
    np.testing.assert_allclose(cs1.lam.numpy(), np.asarray(jcs1.lam),
                               atol=2e-3, rtol=0)
    if not carry_duals:
        # The duals reset each step: the carried-in ones do not matter.
        cs0 = cs._replace(lam=torch.zeros_like(cs.lam))
        f0 = rp_cadmm.control(tp, cfg, f_eq, cs0, tstates, _tacc())[0]
        assert torch.equal(f0, f)


def test_agrees_with_centralized_and_warm_restart():
    """The JAX test's contract on the port: the consensus solution within
    5e-3 N of the centralized one with no fallbacks, and with carried
    duals a repeat at the same state closes in at most 2 iterations."""
    jp, js, tp = _pair(3)
    _, tstates = _states(js, np.array([[0.2, 0.1, 0.0]]),
                         np.array([[0.05, 0.0, 0.0]]))
    f_eq = rp_centralized.equilibrium_forces(tp)
    ccfg = rp_centralized.make_config(tp)
    f_c, _, _ = rp_centralized.control(
        tp, ccfg, f_eq, rollout.stack_scenarios(
            rp_centralized.init_ctrl_state(tp, ccfg), 1), tstates, _tacc())
    dcfg = rp_cadmm.make_config(tp, max_iter=60, inner_iters=40,
                                res_tol=1e-3, carry_duals=True)
    ds0 = rollout.stack_scenarios(rp_cadmm.init_state(tp, dcfg, f_eq), 1)
    f_d, ds, st = rp_cadmm.control(tp, dcfg, f_eq, ds0, tstates, _tacc())
    assert float(st.solve_res[0]) < dcfg.res_tol
    assert float(st.ok_frac[0]) == 1.0
    assert float((f_d - f_c).abs().max()) < 5e-3
    _, _, st2 = rp_cadmm.control(tp, dcfg, f_eq, ds, tstates, _tacc())
    assert int(st2.iters[0]) <= 2


def test_respects_actuation_limits():
    """Every agent's own force meets its min-thrust, cone and norm-cap
    rows, the ones its local QP keeps (the JAX test's 1e-3)."""
    jp, js, tp = _pair(3)
    vl, wl = _scenarios()
    _, tstates = _states(js, vl, wl)
    f_eq = rp_centralized.equilibrium_forces(tp)
    cfg = rp_cadmm.make_config(tp, max_iter=60, inner_iters=40, res_tol=1e-3)
    f, _, _ = rp_cadmm.control(
        tp, cfg, f_eq, rollout.stack_scenarios(
            rp_cadmm.init_state(tp, cfg, f_eq), 3), tstates, _tacc())
    base, tol = cfg.base, 1e-3
    norms = torch.linalg.vector_norm(f, dim=-1)
    assert bool((f[..., 2] >= base.min_fz - tol).all())
    assert bool((norms <= base.sec_max_f_ang * f[..., 2] + tol).all())
    assert bool((norms <= base.max_f + tol).all())


def test_batched_matches_solo():
    """Scenarios batched together give each scenario's solo result (the
    batch runs until its slowest scenario stops; a stopped scenario keeps
    its carry)."""
    jp, js, tp = _pair(3)
    vl, wl = _scenarios(seed=2)
    _, tstates = _states(js, vl, wl)
    f_eq = rp_centralized.equilibrium_forces(tp)
    cfg = rp_cadmm.make_config(tp, max_iter=30, inner_iters=30, res_tol=1e-3)
    cs = rollout.stack_scenarios(rp_cadmm.init_state(tp, cfg, f_eq), 3)
    f_b, _, st_b = rp_cadmm.control(tp, cfg, f_eq, cs, tstates, _tacc())
    for s in range(3):
        one = type(tstates)(**{k.name: getattr(tstates, k.name)[s:s + 1]
                               for k in dataclasses.fields(tstates)})
        f_s, _, st_s = rp_cadmm.control(
            tp, cfg, f_eq, rollout.stack_scenarios(
                rp_cadmm.init_state(tp, cfg, f_eq), 1), one, _tacc())
        np.testing.assert_allclose(f_b[s].numpy(), f_s[0].numpy(), atol=2e-4)
        assert int(st_b.iters[s]) == int(st_s.iters[0])


@pytest.mark.parametrize("n,d", [(3, 3), (6, 3)])
def test_sharded_matches_single_program(n, d):
    """``rp_cadmm_control_sharded`` over d shards against the single
    program (the JAX sharded test's bars), for 3 scenarios; the shard
    count must divide n."""
    _, js, tp = _pair(n)
    vl, wl = _scenarios()
    _, tstates = _states(js, vl, wl)
    f_eq = rp_centralized.equilibrium_forces(tp)
    cfg = rp_cadmm.make_config(tp, max_iter=30, inner_iters=30, res_tol=1e-3)
    cs = rollout.stack_scenarios(rp_cadmm.init_state(tp, cfg, f_eq), 3)
    f_ref, _, st_ref = rp_cadmm.control(tp, cfg, f_eq, cs, tstates, _tacc())
    step = mesh.rp_cadmm_control_sharded(tp, cfg, f_eq,
                                         mesh.make_mesh({"agent": d}))
    f_sh, cs_sh, st_sh = step(cs, tstates, _tacc())
    np.testing.assert_allclose(f_sh.numpy(), f_ref.numpy(), atol=2e-4)
    assert int((st_sh.iters - st_ref.iters).abs().max()) <= 1
    assert cs_sh.f.shape == cs.f.shape
    with pytest.raises(ValueError, match="divide"):
        mesh.rp_cadmm_control_sharded(tp, cfg, f_eq,
                                      mesh.make_mesh({"agent": n + 1}))


def _circle(t):
    r, w = 0.5, 0.4
    x = np.array([r * np.cos(w * t) - r, r * np.sin(w * t), 0.1 * t])
    v = np.array([-r * w * np.sin(w * t), r * w * np.cos(w * t), 0.1])
    a = np.array([-r * w**2 * np.cos(w * t), -r * w**2 * np.sin(w * t), 0.0])
    return x, v, a


@pytest.mark.parametrize("controller", ["centralized", "cadmm"])
def test_closed_loop_first_periods_match_jax(controller):
    """The first 30 periods of the JAX closed-loop circle tests (RP
    centralized: ``tests/test_dd_rp.py:83-130``, solver_iters 120; RP
    C-ADMM: ``tests/test_rp_cadmm.py:135-200``, max_iter 20, inner 40,
    res_tol 5e-3): the PD reference, one control step, ten 1 ms
    ``integrate`` steps; the port against JAX at every period."""
    jp, js, tp = _pair(3)
    jf_eq = jrpc.equilibrium_forces(jp)
    f_eq = rp_centralized.equilibrium_forces(tp)
    if controller == "centralized":
        jcfg = jrpc.make_config(jp, solver_iters=120)
        cfg = rp_centralized.make_config(tp, solver_iters=120)
        jcs = jrpc.init_ctrl_state(jp, jcfg)
        cs = rollout.stack_scenarios(rp_centralized.init_ctrl_state(tp, cfg),
                                     1)
        jctl = lambda c, s, a: jrpc.control(jp, jcfg, jf_eq, c, s, a)  # noqa
        ctl = lambda c, s, a: rp_centralized.control(  # noqa: E731
            tp, cfg, f_eq, c, s, a)
    else:
        jcfg = jrpa.make_config(jp, max_iter=20, inner_iters=40, res_tol=5e-3)
        cfg = rp_cadmm.make_config(tp, max_iter=20, inner_iters=40,
                                   res_tol=5e-3)
        jcs = jrpa.init_state(jp, jcfg, jf_eq)
        cs = rollout.stack_scenarios(rp_cadmm.init_state(tp, cfg, f_eq), 1)
        jctl = lambda c, s, a: jrpa.control(jp, jcfg, jf_eq, c, s, a)  # noqa
        ctl = lambda c, s, a: rp_cadmm.control(  # noqa: E731
            tp, cfg, f_eq, c, s, a)

    def jperiod(carry, acc):
        state, c = carry
        f, c, stats = jctl(c, state, (acc, jnp.zeros(3)))
        state = jax.lax.fori_loop(
            0, 10, lambda _, s: jrp.integrate(jp, s, f, 1e-3), state)
        return (state, c), (f, stats.iters)

    jperiod = jax.jit(jperiod)
    st = rollout.stack_scenarios(convert.rp_state(_np(js), device="cpu"), 1)
    jst = js
    for i in range(30):
        x_ref, v_ref, a_ref = _circle(i * 1e-3 * 10)
        jdvl = (a_ref - 1.5 * (np.asarray(jst.vl) - v_ref)
                - 2.0 * (np.asarray(jst.xl) - x_ref))
        (jst, jcs), (jf, jit) = jperiod((jst, jcs),
                                        jnp.asarray(jdvl, jnp.float32))
        dvl = (_t(a_ref) - 1.5 * (st.vl - _t(v_ref))
               - 2.0 * (st.xl - _t(x_ref)))
        f, cs, stats = ctl(cs, st, (dvl, torch.zeros_like(dvl)))
        for _ in range(10):
            st = rp.integrate(tp, st, f, 1e-3)
        assert int(stats.iters[0]) == int(jit), i
        np.testing.assert_allclose(f[0].numpy(), np.asarray(jf),
                                   atol=LOOP_FORCE_BAR[controller], rtol=0,
                                   err_msg=f"period {i}")
        for k in ("xl", "vl", "Rl", "wl"):
            np.testing.assert_allclose(
                getattr(st, k)[0].numpy(), np.asarray(getattr(jst, k)),
                atol=LOOP_STATE_BAR[controller], rtol=0,
                err_msg=f"{k} at period {i}")
    assert bool(torch.isfinite(st.xl).all())


def test_state_converters_round_trip():
    """JAX controller states -> port -> the same numpy arrays, for the
    centralized controller and C-ADMM, single and scenario-batched."""
    jp, _, tp = _pair(4)
    jcs = jrpc.init_ctrl_state(jp, jrpc.make_config(jp))
    jds = jrpa.init_state(jp, jrpa.make_config(jp),
                          jrpc.equilibrium_forces(jp))
    jds = jds.replace(lam=jnp.ones_like(jds.lam) * 0.5)
    jds_b = jax.tree.map(lambda x: jnp.stack([x, 2 * x]), jds)
    for conv, ref in ((convert.rp_ctrl_state, jcs),
                      (convert.rp_cadmm_state, jds),
                      (convert.rp_cadmm_state, jds_b)):
        got = conv(_np(ref), device="cpu")
        for a, b in zip(jax.tree.leaves(_np(ref)),
                        [t for t in (got.f, got.lam, *got.warm)]
                        if hasattr(got, "lam") else
                        [got.prev_f, *got.warm]):
            np.testing.assert_array_equal(b.numpy(), a)
    # The port's own initial states have the JAX shapes.
    cs = rp_cadmm.init_state(tp, rp_cadmm.make_config(tp),
                             rp_centralized.equilibrium_forces(tp))
    assert cs.f.shape == jds.f.shape and cs.warm.y.shape == jds.warm.y.shape

