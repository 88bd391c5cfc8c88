"""PyTorch port vs the JAX package: one C-ADMM control step over a batch of
scenarios (the port's explicit scenario axis against ``jax.vmap`` of the JAX
controller), and the equilibrium forces.

Tolerances, and why: the agent QPs are built from float32 operations that
both packages run in the same order, but the Schur plan's and the KKT
operators' inverses (``torch.linalg.inv`` vs JAX's LU) and every small
matrix product round differently in the last bits; the fixed-iteration ADMM
then carries those differences through 20 inner iterations per consensus
iteration, with the equality rows' 1e3-boosted penalties amplifying them.
Forces agree to 1e-4 N (on forces of ~3 N, and against the consensus
tolerance of 1e-2 N). Consensus iteration counts are discrete and must be
equal in every scenario.
"""

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
@pytest.mark.parametrize("n", [4, 8])
def test_control_step_matches_vmapped_jax(n, pad):
    sc = _scenarios(n)
    jf_app, jcs, jst = _jax_step(n, pad, sc)
    f_app, cs, st = _torch_step(n, pad, sc)

    np.testing.assert_array_equal(st.iters.numpy(), np.asarray(jst.iters))
    assert int(st.iters.max()) > 1  # the consensus loop really iterated.
    assert f_app.shape == (3, n, 3)
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
