"""The slice as a whole: the port's rollouts against the JAX package's.

The headline rollout (C-ADMM, n = 8, ``max_iter=20``, ``inner_iters=20``,
forest seed 0, ``acc_des=(0.3, 0, 0)``) over 4 seeded scenarios for 3 MPC
steps, against the same rollout built from the JAX modules by ``bench.py
build()``; and the logged rollout (``jit_rollout`` with the forest
reference) against ``jax.vmap`` of the JAX ``rollout``.

Tolerance, and why: per-step consensus iteration counts are discrete and
must be equal. The states agree to 1e-4: the control forces agree to ~1e-6 N
(rounding of the inverses and products, see tests/test_torch_cadmm.py), and
the 30 physics substeps integrate that at dt = 1 ms, adding the float32
rounding of the 3x3 rotation products; positions are O(10) m, so 1e-4 is
~10 ulps of them.
"""

from typing import NamedTuple

import bench
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_aerial_transport.control import cadmm as jcadmm
from tpu_aerial_transport.control import centralized as jcentralized
from tpu_aerial_transport.control import lowlevel as jlowlevel
from tpu_aerial_transport.envs import forest as jforest
from tpu_aerial_transport.harness import rollout as jrollout
from tpu_aerial_transport.harness import setup as jsetup
from tpu_aerial_transport_torch.envs import forest
from tpu_aerial_transport_torch.harness import rollout, setup


def test_headline_rollout_matches_bench_build():
    S, steps = 4, 3
    jrun, jcss, jstates = bench.build("cadmm", n=8, n_scenarios=S)
    jcss, jstates, jiters = jrun(jcss, jstates, n_steps=steps)

    run, css, states = rollout.build(n=8, n_scenarios=S, device="cpu")
    np.testing.assert_array_equal(
        states.xl.numpy(),
        np.asarray(bench._scenario_batch(
            bench.make_mpc_step("cadmm", 8)[2], S).xl),
    )
    css, states, iters = run(css, states, steps)

    np.testing.assert_array_equal(iters.numpy(), np.asarray(jiters))
    assert iters.shape == (steps, S) and int(iters.max()) > 1
    for f in ("xl", "vl", "Rl", "wl", "R", "w"):
        np.testing.assert_allclose(getattr(states, f).numpy(),
                                   np.asarray(getattr(jstates, f)), atol=1e-4,
                                   rtol=0, err_msg=f)
    np.testing.assert_array_equal(states.step.numpy(),
                                  np.asarray(jstates.step))
    np.testing.assert_allclose(css.f_mean.numpy(), np.asarray(jcss.f_mean),
                               atol=1e-4, rtol=0)
    assert torch.isfinite(states.xl).all()


def _xy(B, seed):
    """Seeded horizontal positions over flat ground and the mountain
    (centered at x = 30 m, radius 25 m)."""
    rng = np.random.default_rng(seed)
    return np.stack([rng.uniform(-5.0, 65.0, B), rng.uniform(-30.0, 30.0, B)],
                    axis=-1).astype(np.float32)


class _Payload(NamedTuple):
    """The two state leaves the JAX reference reads, as a JAX pytree."""
    xl: jax.Array
    vl: jax.Array


def test_ground_height_and_forest_reference_match():
    """``ground_height`` and ``make_forest_acc_des`` against the JAX
    package's (vmapped) on seeded states, some on the mountain: the same
    float32 operations in the same order, so within 1e-6 m (m/s^2)."""
    B = 32
    xy = _xy(B, seed=4)
    jf = jforest.make_forest(seed=0)
    tf = forest.make_forest(seed=0, device="cpu")
    ref_h = np.asarray(jforest.ground_height(jf, jnp.asarray(xy)))
    got_h = forest.ground_height(tf, torch.as_tensor(xy)).numpy()
    np.testing.assert_allclose(got_h, ref_h, rtol=0, atol=1e-6)
    assert (ref_h > 0).sum() > 4 and (ref_h == 0).sum() > 4
    rng = np.random.default_rng(5)
    xl = np.concatenate([xy, rng.uniform(0.0, 8.0, (B, 1))], -1).astype(
        np.float32)
    vl = rng.normal(size=(B, 3)).astype(np.float32)
    ref = jax.jit(jax.vmap(jrollout.make_forest_acc_des(jf),
                           in_axes=(0, None)))(_Payload(xl, vl), 0.0)
    _, _, st0 = setup.rqp_setup(4, device="cpu")
    states = rollout.stack_scenarios(st0, B).replace(
        xl=torch.as_tensor(xl), vl=torch.as_tensor(vl))
    (dvl, dwl), x_ref, v_ref = rollout.make_forest_acc_des(tf)(states, 0.0)
    (jdvl, jdwl), jx_ref, jv_ref = ref
    for a, b in ((jdvl, dvl), (jdwl, dwl), (jx_ref, x_ref)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0,
                                   atol=1e-6)
    np.testing.assert_array_equal(v_ref.numpy(), np.asarray(jv_ref)[0])
    assert float(torch.sqrt((dvl * dvl).sum(-1)).max()) <= 1.0 + 1e-6


def _logged_pair(n=4, S=2, steps=3):
    """The logged C-ADMM rollout with the forest reference, on 2 seeded
    scenarios (one on the mountain's slope), from the JAX package (its
    ``rollout`` vmapped over scenarios and jitted) and from the port's
    ``jit_rollout`` on the CPU."""
    xl = np.array([[5.0, 0.5, 2.0], [14.0, -1.0, 2.5]], np.float32)[:S]
    kw = dict(max_iter=20, inner_iters=20)
    params, col, st0 = jsetup.rqp_setup(n)
    jf = jforest.make_forest(seed=0)
    cfg = jcadmm.make_config(params, col.collision_radius,
                             col.max_deceleration, **kw)
    f_eq = jcentralized.equilibrium_forces(params)
    ll = jlowlevel.make_lowlevel_controller("pd", params)

    def hl_step(cs, s, a):
        return jcadmm.control(params, cfg, f_eq, cs, s, a, jf)

    def one(s, c):
        return jrollout.rollout(hl_step, ll.control, params, s, c, steps,
                                acc_des_fn=jrollout.make_forest_acc_des(jf))

    cs0 = jcadmm.init_cadmm_state(params, cfg)
    jstates = jax.vmap(lambda x: st0.replace(
        xl=x, vl=jnp.array([0.5, 0.0, 0.0], jnp.float32)))(xl)
    jcss = jax.vmap(lambda _: cs0)(jnp.arange(S))
    ref = jax.jit(jax.vmap(one))(jstates, jcss)

    ctl = rollout.make_controller("cadmm", n, device="cpu", **kw)
    run = rollout.jit_rollout(ctl.control, ctl.ll.control, ctl.params,
                              n_hl_steps=steps,
                              acc_des_fn=rollout.make_forest_acc_des(
                                  ctl.forest))
    states = rollout.scenario_batch(ctl.state0, S).replace(
        xl=torch.as_tensor(xl))
    got = run(states, rollout.stack_scenarios(ctl.cs0, S))
    return ref, got, run, ctl


def test_logged_rollout_matches_jax_vmap():
    """Every ``RQPLogStep`` leaf of the port's logged rollout (C-ADMM at
    n = 4, 2 scenarios, 3 high-level steps; time first, then scenario)
    against ``jax.vmap`` of the JAX ``rollout`` (scenario first): the
    iteration counts, collision flags and the zero resilience fields
    equal; every other leaf within 1e-4, this file's bar (see the top):
    the forces, the final consensus residual and the distances too, which
    agree to ~1e-5 (the two packages' float32 inverses and products round
    apart by ~1e-6 relative, and the consensus iterations carry that). On
    the CPU the substeps run as plain calls: no graph is captured or
    replayed."""
    ref, got, run, ctl = _logged_pair()
    (jstate, jcs, jlogs), (state, cs, logs) = ref, got
    exact = ("iters", "collision", "fallback_rung", "quarantined")
    for f in vars(logs):
        a = np.swapaxes(np.asarray(getattr(jlogs, f)), 0, 1)
        b = getattr(logs, f).numpy()
        assert b.shape == a.shape, f
        if f in exact:
            np.testing.assert_array_equal(b, a, err_msg=f)
        else:
            np.testing.assert_allclose(b, a, rtol=0, atol=1e-4, err_msg=f)
    assert int(logs.iters.max()) > 1
    for f in ("xl", "vl", "R", "w", "Rl", "wl"):
        np.testing.assert_allclose(getattr(state, f).numpy(),
                                   np.asarray(getattr(jstate, f)), rtol=0,
                                   atol=1e-4)
    np.testing.assert_allclose(cs.f_mean.numpy(), np.asarray(jcs.f_mean),
                               rtol=0, atol=1e-4)
    graph = run.substeps.graph
    assert graph.captures == 0 and graph.replays == 0

    d = rollout.logs_to_dict(logs, 4, 1e-3, 10, ctl.forest)
    jd = jrollout.logs_to_dict(
        jax.tree.map(lambda x: jnp.swapaxes(x, 0, 1), jlogs), 4, 1e-3, 10,
        jforest.make_forest(seed=0))

    def shapes(t):
        return ({k: shapes(v) for k, v in t.items()} if isinstance(t, dict)
                else np.shape(t))

    assert shapes(d) == shapes(jd)
    assert d["T"] == jd["T"] == 0.03 and d["num_trees"] == jd["num_trees"]
    np.testing.assert_array_equal(d["tree_pos"], jd["tree_pos"])


@pytest.mark.parametrize("controller", rollout.CONTROLLERS)
def test_per_scenario_reference_equals_shared(controller):
    """Every controller takes ``acc_des`` per scenario (``(S, 3)``, what
    the logged rollout's forest reference gives) as well as shared
    (``(3,)``): equal rows give exactly the shared result."""
    kw = {} if controller == "centralized" else dict(max_iter=4,
                                                     inner_iters=10)
    ctl = rollout.make_controller(controller, 4, device="cpu", **kw)
    S = 2
    states = rollout.scenario_batch(ctl.state0, S)
    css = rollout.stack_scenarios(ctl.cs0, S)
    shared = (torch.tensor([0.3, 0.0, 0.1]), torch.tensor([0.0, 0.0, 0.05]))
    per = tuple(a.expand(S, 3).clone() for a in shared)
    f_a, _, st_a = ctl.control(css, states, shared)
    f_b, _, st_b = ctl.control(css, states, per)
    assert torch.equal(f_a, f_b) and torch.equal(st_a.iters, st_b.iters)
