"""PyTorch port vs the JAX package: one C-ADMM and one DD control step in a
city-scale world (1024 trees on a jittered grid, with its spatial-hash
grid), where ``env_query="auto"`` resolves to the bucketed tier; and the
agent-sharded C-ADMM step in that world against the single program.

Tolerances, and why: those of the mountain-world steps. C-ADMM: forces,
copies, means and duals to 1e-4 N and equal iteration counts
(``tests/test_torch_cadmm.py``). DD: equal iteration counts, forces and duals
to 2e-3 N (``tests/test_torch_dd.py``: its 1e3-boosted equality rows make
the two frameworks' float32 inverses differ by ~1e-4 relative). The
sharded step against the single program: equal iteration counts and
1e-4 N, the bar of ``tests/test_torch_parallel.py`` (a sum over blocks,
then over the shards, rounds in another order than one sum). The
scenarios fly at 4.6 to 5.4 m, just above the 4 m canopy, as the JAX
package's city example spawns, so the trees' tops fill the nearest rows.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_cadmm import _scenarios, _t
from test_torch_dd import _assert_step

from tpu_aerial_transport.control import cadmm as jcadmm
from tpu_aerial_transport.control import centralized as jcentral
from tpu_aerial_transport.control import dd as jdd
from tpu_aerial_transport.envs import forest as jforest
from tpu_aerial_transport.envs import spatial as jspatial
from tpu_aerial_transport.harness import setup as jsetup
from tpu_aerial_transport_torch import convert
from tpu_aerial_transport_torch.control import cadmm, centralized, dd
from tpu_aerial_transport_torch.envs import spatial
from tpu_aerial_transport_torch.harness import rollout, setup
from tpu_aerial_transport_torch.parallel import mesh

N_TREES = 1024
DENSITY = 0.085
KEYS = ("xl", "vl", "Rl", "wl", "R", "w")
MODS = {"cadmm": (jcadmm, cadmm), "dd": (jdd, dd)}
CFG = {"cadmm": dict(max_iter=20, inner_iters=20),
       "dd": dict(max_iter=20, inner_iters=40)}


def _city_scenarios(n):
    sc = _scenarios(n)
    sc["xl"] = np.array([[0.4, 0.3, 5.0], [12.6, -7.3, 4.6],
                         [-9.2, 14.1, 5.4]])
    sc["vl"] = np.array([[0.5, 0.0, 0.0], [0.9, -0.4, -0.1],
                         [-0.6, 0.8, 0.0]])
    return sc


def _jax_world(vision_radius):
    n_side = math.isqrt(N_TREES)
    f = jforest.make_forest(seed=0, max_trees=N_TREES, density=DENSITY,
                            world_size=(n_side + 0.5) / math.sqrt(DENSITY))
    return jspatial.with_grid(f, vision_radius + jforest.BARK_RADIUS)


def _jax_step(ctrl, n, sc):
    jmod = MODS[ctrl][0]
    jp, jcol, js = jsetup.rqp_setup(n)
    cfg = jmod.make_config(jp, jcol.collision_radius, jcol.max_deceleration,
                           socp_fused="scan", pad_operators=True,
                           env_query="auto", **CFG[ctrl])
    base = cfg if ctrl == "cadmm" else cfg.base
    jf = _jax_world(base.vision_radius)
    f_eq = jcentral.equilibrium_forces(jp)
    if ctrl == "cadmm":
        cs0, plan = jcadmm.init_cadmm_state(jp, cfg), jcadmm.make_plan(jp, cfg)
    else:
        cs0, plan = jdd.init_dd_state(jp, cfg), jdd.make_dd_plan(jp, cfg)
    acc = (jnp.array([0.3, 0.0, 0.0], jnp.float32), jnp.zeros(3, jnp.float32))
    S = sc["xl"].shape[0]
    # One jit over the whole vmapped step, the inputs as few leaves.
    step = jax.jit(jax.vmap(lambda s: jmod.control(
        jp, cfg, f_eq, cs0, js.replace(**dict(zip(KEYS, s))), acc, jf,
        plan=plan)))
    out = step(tuple(jnp.asarray(sc[k], jnp.float32) for k in KEYS))
    assert jspatial.runtime_env_query(base.env_query, jf) == "bucketed"
    assert out[0].shape == (S, n, 3)
    return out, jax.tree.map(np.asarray, jf)


def _port(ctrl, n, jforest_np, **kw):
    mod = MODS[ctrl][1]
    tp, tcol, ts = setup.rqp_setup(n, device="cpu")
    cfg = mod.make_config(tp, tcol.collision_radius, tcol.max_deceleration,
                          pad_operators=True, env_query="auto", device="cpu",
                          **CFG[ctrl], **kw)
    f_eq = centralized.equilibrium_forces(tp)
    init = (cadmm.init_cadmm_state(tp, cfg, f_eq) if ctrl == "cadmm"
            else dd.init_dd_state(tp, cfg, f_eq))
    return tp, cfg, f_eq, init, ts, convert.forest(jforest_np, device="cpu")


def _port_inputs(init, ts, sc):
    S = sc["xl"].shape[0]
    return (rollout.stack_scenarios(init, S),
            rollout.stack_scenarios(ts, S).replace(
                **{k: _t(sc[k]) for k in KEYS}))


ACC = (torch.tensor([0.3, 0.0, 0.0]), torch.zeros(3))


@pytest.mark.parametrize("ctrl", ["cadmm", "dd"])
def test_city_step_matches_vmapped_jax(ctrl):
    """One control step at n = 4 over 3 scenarios in the 1024-tree city
    world, ``env_query="auto"`` (bucketed on both sides)."""
    n = 4
    sc = _city_scenarios(n)
    ref, jf_np = _jax_step(ctrl, n, sc)
    tp, cfg, f_eq, init, ts, tf = _port(ctrl, n, jf_np)
    base = cfg if ctrl == "cadmm" else cfg.base
    assert tf.grid is not None and tf.grid.nx == jf_np.grid.nx
    assert spatial.runtime_env_query(base.env_query, tf) == "bucketed"
    css, states = _port_inputs(init, ts, sc)
    mod = MODS[ctrl][1]
    plan = (cadmm.make_plan(tp, cfg) if ctrl == "cadmm"
            else dd.make_dd_plan(tp, cfg))
    out = mod.control(tp, cfg, f_eq, css, states, ACC, tf, plan=plan)
    (jf_app, jcs, jst), (f_app, cs, st) = ref, out
    # The trees really enter the rows: the nearest tree is within vision.
    assert float(st.min_env_dist.max()) < base.vision_radius
    if ctrl == "dd":
        _assert_step(ref, out, 2e-3)
        return
    np.testing.assert_array_equal(st.iters.numpy(), np.asarray(jst.iters))
    assert int(st.iters.max()) > 1
    for a, b in ((jf_app, f_app), (jcs.f, cs.f), (jcs.f_mean, cs.f_mean),
                 (jcs.lam, cs.lam), (jst.solve_res, st.solve_res)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-4,
                                   rtol=0)
    np.testing.assert_array_equal(st.collision.numpy(),
                                  np.asarray(jst.collision))
    np.testing.assert_allclose(st.min_env_dist.numpy(),
                               np.asarray(jst.min_env_dist), atol=1e-5,
                               rtol=0)


def test_city_sharded_step_equals_single_program():
    """``cadmm.control(shards=2)`` and ``mesh.cadmm_control_sharded`` in the
    city world: the grid rides the forest into the sharded step, which
    gives the single program's step (all-reduce exchange)."""
    n = 4
    sc = _city_scenarios(n)
    jf = jax.tree.map(np.asarray, _jax_world(
        setup.rqp_setup(n, device="cpu")[1].collision_radius + 5.0))
    tp, cfg, f_eq, init, ts, tf = _port("cadmm", n, jf,
                                        consensus_impl="allreduce")
    css, states = _port_inputs(init, ts, sc)
    plan = cadmm.make_plan(tp, cfg)
    single = cadmm.control(tp, cfg, f_eq, css, states, ACC, tf, plan=plan)
    sharded = cadmm.control(tp, cfg, f_eq, css, states, ACC, tf, shards=2,
                            plan=plan)
    step = mesh.cadmm_control_sharded(tp, cfg, f_eq, mesh.make_mesh(
        {"agent": 2}), forest=tf)
    via_mesh = step(css, states, ACC)
    assert int(single[2].iters.max()) > 1
    assert float(single[2].min_env_dist.max()) < cfg.vision_radius
    for out in (sharded, via_mesh):
        assert torch.equal(out[2].iters, single[2].iters)
        for a, b in ((single[0], out[0]), (single[1].f, out[1].f),
                     (single[1].lam, out[1].lam)):
            np.testing.assert_allclose(b.numpy(), a.numpy(), atol=1e-4,
                                       rtol=0)
