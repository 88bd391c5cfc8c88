"""PyTorch port vs the JAX package: the centralized controller and the entry
step (``tpu_aerial_transport_torch.entry.entry`` against
``__graft_entry__.entry``), and the centralized bench rollout.

Tolerances, and why:

- Config: exact (the same float32 ``cos`` and Python arithmetic).
- QP data: 1e-5 absolute (entries up to ~1e2 in the rotational dynamics
  rows before equilibration): the same float32 operations, summed in
  another order in the small products and the row norms.
- One entry step: states to 1e-5, forces to 1e-4 N. The solve is warm
  started, runs 120 iterations in both packages and converges to its
  float32 limit cycle (primal residual ~1e-6), whose duals carry the
  rounding of the nine equality rows' 1e3-boosted penalties.
- Rollouts: the stop decision of a converged solve is decided by float32
  rounding. At the converged point the dual residual swings by ~+-3e-4
  from chunk to chunk around its float64 value (measured on the entry's
  second step: 4.87e-3 in float64, 4.56e-3 and 5.10e-3 in float32, tol
  5e-3), so the two packages stop at different chunks on some steps and
  their solutions differ by that limit cycle's amplitude, ~1e-4 N of force.
  The 50-step entry rollout holds states to 2e-4 (positions ~10 m: a few
  tens of float32 ulps after 500 physics substeps); the 5-step n = 4
  bench rollout holds states to 1e-4 and forces to 1e-3 N.
"""

import dataclasses

import __graft_entry__
import bench
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_cadmm import _scenarios, _t

from tpu_aerial_transport.control import centralized as jcentral
from tpu_aerial_transport.envs import forest as jforest
from tpu_aerial_transport.harness import setup as jsetup
from tpu_aerial_transport.ops import socp as jsocp
from tpu_aerial_transport_torch import convert, entry
from tpu_aerial_transport_torch.control import centralized
from tpu_aerial_transport_torch.control.types import EnvCBF
from tpu_aerial_transport_torch.envs import forest
from tpu_aerial_transport_torch.harness import rollout, setup
from tpu_aerial_transport_torch.ops import admm_kernel

KEYS = ("xl", "vl", "Rl", "wl", "R", "w")


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.mark.parametrize("n", [3, 4])
def test_config_matches_jax(n):
    jp, jcol, _ = jsetup.rqp_setup(n)
    tp, tcol, _ = setup.rqp_setup(n, device="cpu")
    ref = jcentral.make_config(jp, jcol.collision_radius,
                               jcol.max_deceleration, solver_iters=120)
    cfg = centralized.make_config(tp, tcol.collision_radius,
                                  tcol.max_deceleration, solver_iters=120)
    for f in dataclasses.fields(cfg):
        assert getattr(cfg, f.name) == getattr(ref, f.name), f.name
    assert centralized.qp_dims(n, 10) == jcentral.qp_dims(n, 10)


@pytest.mark.parametrize("n", [3, 4])
def test_build_qp_matches_jax(n):
    """The QP of 3 seeded scenarios (the JAX ``_build_qp`` per scenario),
    given the same environment rows."""
    sc = _scenarios(n)
    jp, jcol, js = jsetup.rqp_setup(n)
    cfg_j = jcentral.make_config(jp, jcol.collision_radius,
                                 jcol.max_deceleration)
    jf = jforest.make_forest(seed=0)
    acc = (jnp.array([0.3, 0.0, 0.0], jnp.float32), jnp.zeros(3, jnp.float32))
    tp, tcol, ts = setup.rqp_setup(n, device="cpu")
    cfg = centralized.make_config(tp, tcol.collision_radius,
                                  tcol.max_deceleration)
    states = rollout.stack_scenarios(ts, 3).replace(
        **{k: _t(sc[k]) for k in KEYS})
    refs, envs = [], []
    for s in range(3):
        st = js.replace(**{k: jnp.asarray(sc[k][s], jnp.float32)
                           for k in KEYS})
        env = jforest.collision_cbf_rows(
            jf, st.xl, st.vl, jcol.collision_radius, jcol.max_deceleration,
            cfg_j.vision_radius, cfg_j.dist_eps, cfg_j.alpha_env_cbf,
            cfg_j.n_env_cbfs)
        envs.append(_np(env))
        refs.append(_np(jcentral._build_qp(
            jp, cfg_j, jcentral.equilibrium_forces(jp), st, acc, env)))
    env_t = EnvCBF(*(_t(np.stack([getattr(e, f) for e in envs])) for f in
                     ("lhs", "rhs", "collision", "min_dist")))
    assert bool((env_t.rhs > -1.0).any())  # a tree row is active.
    out = centralized._build_qp(tp, cfg, centralized.equilibrium_forces(tp),
                                states, (_t([0.3, 0.0, 0.0]), torch.zeros(3)),
                                env_t)
    for i, name in enumerate(("P", "q", "A", "lb", "ub", "shift")):
        ref = np.stack([r[i] for r in refs])
        assert out[i].shape == ref.shape, name
        np.testing.assert_allclose(out[i].numpy(), ref, atol=1e-5, rtol=0,
                                   err_msg=name)


def _entry_pair():
    jstep, (jcs, js, jacc) = __graft_entry__.entry()
    step, (cs, st, acc) = entry.entry(device="cpu")
    return (jax.jit(jstep), jcs, js, jacc), (step, cs, st, acc)


def _state_err(st, js):
    return max(float(np.abs(getattr(st, f).numpy()[0]
                             - np.asarray(getattr(js, f))).max())
               for f in KEYS)


def test_entry_initial_state_matches_jax():
    """The entry's example arguments: the start state, the controller state
    (carried across through ``convert.ctrl_state``) and ``acc_des``."""
    (_, jcs, js, jacc), (_, cs, st, acc) = _entry_pair()
    assert _state_err(st, js) == 0.0
    conv = convert.ctrl_state(_np(jcs), device="cpu")
    assert cs.prev_f.shape == (1, 3, 3) and cs.warm.y.shape == (1, 49)
    for a, b in zip(jax.tree.leaves(conv), jax.tree.leaves(cs)):
        np.testing.assert_allclose(a.numpy(), b[0].numpy(), rtol=1e-6,
                                   atol=1e-6)
    for a, b in zip(acc, jacc):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_entry_step_matches_jax():
    """One entry step (CBF rows, centralized control, the low-level law,
    ten 1 ms steps): states to 1e-5, forces to 1e-4 N."""
    (jstep, jcs, js, jacc), (step, cs, st, acc) = _entry_pair()
    jcs, js, jst = jstep(jcs, js, jacc)
    cs, st, stats = step(cs, st, acc)
    assert _state_err(st, js) < 1e-5
    np.testing.assert_allclose(cs.prev_f.numpy()[0], np.asarray(jcs.prev_f),
                               atol=1e-4, rtol=0)
    assert stats.iters.tolist() == [-1] and int(jst.iters) == -1
    assert float(stats.ok_frac[0]) == float(jst.ok_frac) == 1.0
    np.testing.assert_allclose(stats.min_env_dist.numpy()[0],
                               np.asarray(jst.min_env_dist), atol=1e-5)
    assert bool(stats.collision[0]) == bool(jst.collision)


def test_entry_rollout_matches_jax():
    """50 entry steps: states to 2e-4 at every step (see the module
    docstring for the limit-cycle stop decisions)."""
    (jstep, jcs, js, jacc), (step, cs, st, acc) = _entry_pair()
    worst = 0.0
    for _ in range(50):
        jcs, js, _ = jstep(jcs, js, jacc)
        cs, st, _ = step(cs, st, acc)
        worst = max(worst, _state_err(st, js))
    assert worst < 2e-4
    start = setup.rqp_setup(3, device="cpu")[2].xl
    assert float(st.xl[0, 0]) > float(start[0])  # it moved along +x.


def test_bench_rollout_matches_jax():
    """``rollout.build(controller="centralized", n=4)`` against the JAX
    bench's ``make_mpc_step("centralized", 4)`` vmapped over 4 seeded
    scenarios, 5 steps: states to 1e-4, forces to 1e-3 N, every solve
    successful in both."""
    S = 4
    jstep, jcs0, jst0 = bench.make_mpc_step("centralized", 4)
    jstates = bench._scenario_batch(jst0, S)
    jcss = jax.vmap(lambda _: jcs0)(jnp.arange(S))
    jrun = jax.jit(jax.vmap(jstep))
    run, css, states = rollout.build(n=4, n_scenarios=S, device="cpu",
                                     controller="centralized")
    for _ in range(5):
        jcss, jstates, jst = jrun(jcss, jstates)
        css, states, iters = run(css, states, 1)
        assert iters.tolist() == [[-1] * S]
    for f in KEYS:
        np.testing.assert_allclose(getattr(states, f).numpy(),
                                   np.asarray(getattr(jstates, f)),
                                   atol=1e-4, rtol=0, err_msg=f)
    np.testing.assert_allclose(css.prev_f.numpy(), np.asarray(jcss.prev_f),
                               atol=1e-3, rtol=0)
    assert np.all(np.asarray(jst.ok_frac) == 1.0)


def test_centralized_n16_step_matches_jax():
    """One step of ``rollout.build(controller="centralized", n=16)``
    against the JAX bench's ``make_mpc_step("centralized", 16)`` vmapped
    over 2 seeded scenarios. At d = 223 and 32 SOC blocks no kernel holds
    the QP: both packages resolve it to route "scan" (the JAX package on
    the CPU by its backend, the port by shape). States to 1e-4, forces to
    1e-3 N (the bench rollout's bars)."""
    S, n = 2, 16
    n_box, m, soc = centralized.qp_dims(n, 10)
    assert jsocp.runtime_fused_mode("auto", 9 + 3 * n, m, n_box) == "scan"
    params, col, _ = setup.rqp_setup(n, device="cpu")
    cfg = centralized.make_config(params, col.collision_radius,
                                  col.max_deceleration)
    assert centralized.solve_route(n, cfg) == "scan"
    jstep, jcs0, jst0 = bench.make_mpc_step("centralized", n)
    jstates = bench._scenario_batch(jst0, S)
    jcss = jax.vmap(lambda _: jcs0)(jnp.arange(S))
    jcss, jstates, jst = jax.jit(jax.vmap(jstep))(jcss, jstates)
    run, css, states = rollout.build(n=n, n_scenarios=S, device="cpu",
                                     controller="centralized")
    before = dict(admm_kernel.LAUNCHES)
    css, states, iters = run(css, states, 1)
    assert admm_kernel.LAUNCHES == before
    assert iters.tolist() == [[-1] * S]
    for f in KEYS:
        np.testing.assert_allclose(getattr(states, f).numpy(),
                                   np.asarray(getattr(jstates, f)),
                                   atol=1e-4, rtol=0, err_msg=f)
    np.testing.assert_allclose(css.prev_f.numpy(), np.asarray(jcss.prev_f),
                               atol=1e-3, rtol=0)


def test_failed_solve_keeps_previous_forces_and_warm_start():
    """A scenario whose solve is not finite keeps its previous forces and
    warm start; the others are unaffected by it."""
    step, cs0, st0 = rollout.make_mpc_step("centralized", 3, device="cpu")
    css = rollout.stack_scenarios(cs0, 3)
    states = rollout.stack_scenarios(st0, 3)
    _, _, good = step(css, states)
    bad_x = css.warm.x.clone()
    bad_x[1, 0] = float("nan")
    bad = css._replace(warm=css.warm._replace(x=bad_x))
    prev = css.prev_f.clone()
    prev[1] += 0.25
    bad = bad._replace(prev_f=prev)
    out, _, stats = step(bad, states)
    assert stats.ok_frac.tolist() == [1.0, 0.0, 1.0]
    assert torch.equal(out.prev_f[1], prev[1])
    assert torch.isnan(out.warm.x[1, 0])  # kept, not replaced.
    assert torch.equal(out.warm.x[1, 1:], bad_x[1, 1:])
    for s in (0, 2):
        assert torch.isfinite(out.prev_f[s]).all()
    _, _, stats_ok = step(css, states)
    assert stats_ok.ok_frac.tolist() == good.ok_frac.tolist()


def test_oversized_centralized_solve_is_refused_by_the_kernel():
    """The whole-solve kernel takes at most 16 SOC blocks: centralized
    n = 8 (16 blocks, d = 127) fits, n = 16 (32 blocks, d = 223) is a
    ValueError of the wrapper on the card, never a quiet plain run."""
    def dims(n):
        n_box, m, soc = centralized.qp_dims(n, 10)
        nv = 9 + 3 * n
        return nv, m, n_box, soc, admm_kernel.fused_solve_smem_bytes(nv, m)

    nv, m, n_box, soc, smem = dims(8)
    admm_kernel._check_layout("fused_solve", nv, m, n_box, soc, 120, smem)
    assert nv + m == 127
    nv, m, n_box, soc, smem = dims(16)
    with pytest.raises(ValueError, match="SOC blocks"):
        admm_kernel._check_layout("fused_solve", nv, m, n_box, soc, 120, smem)


def test_inactive_env_rows_default():
    """Without environment rows the controller uses the inactive rows, as
    the JAX package does: the same forces as with an empty forest."""
    n = 3
    tp, tcol, ts = setup.rqp_setup(n, device="cpu")
    cfg = centralized.make_config(tp, tcol.collision_radius,
                                  tcol.max_deceleration)
    f_eq = centralized.equilibrium_forces(tp)
    cs = rollout.stack_scenarios(centralized.init_ctrl_state(tp, cfg, f_eq), 2)
    st = rollout.stack_scenarios(ts, 2)
    acc = (_t([0.3, 0.0, 0.0]), torch.zeros(3))
    f_none, _, stats = centralized.control(tp, cfg, f_eq, cs, st, acc)
    rows = forest.collision_cbf_rows(
        None, st.xl, st.vl, tcol.collision_radius, tcol.max_deceleration,
        cfg.vision_radius, cfg.dist_eps, cfg.alpha_env_cbf, cfg.n_env_cbfs)
    f_rows, _, _ = centralized.control(tp, cfg, f_eq, cs, st, acc, rows)
    assert torch.equal(f_none, f_rows)
    jp, jcol, js = jsetup.rqp_setup(n)
    jcfg = jcentral.make_config(jp, jcol.collision_radius,
                                jcol.max_deceleration)
    jf, _, jstats = jcentral.control(
        jp, jcfg, jcentral.equilibrium_forces(jp),
        jcentral.init_ctrl_state(jp, jcfg), js,
        (jnp.array([0.3, 0.0, 0.0]), jnp.zeros(3)))
    np.testing.assert_allclose(f_none.numpy()[0], np.asarray(jf), atol=1e-4,
                               rtol=0)
    assert stats.collision.tolist() == [False, False]
    assert not bool(jstats.collision)
