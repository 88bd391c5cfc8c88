"""PyTorch port vs the JAX package: the PMRL centralized controller
(``control/pmrl_centralized.py``). Mirrors ``tests/test_pmrl_centralized.py``;
the JAX functions run as their own tests run them (route "scan" on the
CPU), the port on its CPU path (the kernels' plain versions), both on the
same numpy-seeded inputs and float32 parameters (``Jl_inv_factor``
included, carried across with ``convert.pmrl_params``).

Tolerances, and why:

- Config: exact.
- ``_affine_dynamics``: ``B``, ``c``, ``B_rob``, ``c_rob`` within 1e-4
  absolute of JAX's ``jacfwd``. The port takes ``accs(e_j) - accs(0)`` of
  the same affine map: exact in real arithmetic, float32 rounding of
  accelerations up to ~30 here (measured gaps under 3e-6). The port's own
  map reproduces its forward dynamics at random thrusts within 1e-3, the
  JAX test's bar.
- ``equilibrium_forces``: 1e-5 N at the rank-3 hover state (every link
  vertical) and at swung, full-rank states: both packages take the SVD
  least-squares solution with the same cutoff, ``eps max(6, n)``.
- One control step and the first 30 setpoint steps: forces within 5e-3 N
  and states within 1e-4. The solves are tolerance-chunked (25 iterations
  a chunk, tol 5e-3) and a lane's stop is decided where its dual residual
  sits at tol within float32 rounding: one package may stop a chunk before
  the other, and the two solutions then differ by what those iterations
  still move, within the solver tolerance 5e-3. The JAX test's quality
  bars (distance to the setpoint after 800 steps) need the full length,
  beyond this file's time budget: the port is held to the JAX trajectory
  over the first steps instead, and to finite forces at n in {3, 5}.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_aerial_transport.control import pmrl_centralized as jctrl
from tpu_aerial_transport.harness import setup as jsetup
from tpu_aerial_transport.models import pmrl as jpmrl
from tpu_aerial_transport_torch import convert
from tpu_aerial_transport_torch.control import pmrl_centralized as ctrl
from tpu_aerial_transport_torch.harness import rollout, setup
from tpu_aerial_transport_torch.models import pmrl
from tpu_aerial_transport_torch.ops import lie

TARGET = (0.4, -0.2, 0.3)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _t(a):
    return torch.as_tensor(np.asarray(a, np.float32))


def _pair(n):
    jp, _, js = jsetup.pmrl_setup(n)
    tp = convert.pmrl_params(_np(jp), device="cpu")
    return jp, js, tp


def _swung(js, n, seed):
    """The hover state with every link tilted and moving (the JAX test's
    perturbation, drawn from numpy)."""
    rng = np.random.default_rng(seed)
    q = np.asarray(js.q) + 0.1 * rng.normal(size=(n, 3))
    dq = 0.2 * rng.normal(size=(n, 3))
    return jpmrl.pmrl_state(q, dq, js.xl, js.vl, js.Rl,
                            np.array([0.1, -0.05, 0.2]))


def _port_state(js, S=1):
    return rollout.stack_scenarios(convert.pmrl_state(_np(js), device="cpu"),
                                   S)


@pytest.mark.parametrize("n", [3, 8])
def test_config_and_qp_dims_match_jax(n):
    jp, _, tp = _pair(n)
    ref, got = jctrl.make_config(jp), ctrl.make_config(tp)
    for f in dataclasses.fields(got):
        assert getattr(got, f.name) == getattr(ref, f.name), f.name
    assert ctrl.qp_dims(n) == jctrl.qp_dims(n)


@pytest.mark.parametrize("n", [4, 8])
def test_affine_dynamics_match_jacfwd(n):
    """``B, c, B_rob, c_rob`` of 2 swung scenarios against JAX's jacfwd,
    and the port's own map exact against its forward dynamics."""
    jp, js, tp = _pair(n)
    jstates = [_swung(js, n, s) for s in range(2)]
    st = rollout.stack_scenarios(convert.pmrl_state(_np(jstates[0]),
                                                    device="cpu"), 2)
    st = st.replace(**{f: torch.stack([_t(getattr(j, f)) for j in jstates])
                       for f in ("q", "dq", "wl")})
    out = ctrl._affine_dynamics(tp, st)
    for s, jst in enumerate(jstates):
        ref = jax.jit(lambda x: jctrl._affine_dynamics(jp, x))(jst)
        for name, a, b in zip(("B", "c", "B_rob", "c_rob"), out, ref):
            np.testing.assert_allclose(a[s].numpy(), np.asarray(b),
                                       atol=1e-4, rtol=0, err_msg=name)
    B, c, B_rob, c_rob = out
    for seed in range(3):
        f = _t(2.0 * np.random.default_rng(10 + seed).normal(size=(2, n, 3)))
        (ddq, dvl, dwl), _ = pmrl.forward_dynamics(tp, st, f)
        pred = (B @ f.reshape(2, -1, 1))[..., 0] + c
        assert float((pred - torch.cat([dvl, dwl], -1)).abs().max()) < 1e-3
        kin = (lie.hat_square(st.wl, st.wl) + lie.hat(dwl)) @ tp.r.T
        ddx = (dvl[:, None] + ddq * tp.L[:, None]
               + (st.Rl @ kin).transpose(-1, -2))
        pred_r = ((B_rob @ f.reshape(2, -1, 1))[..., 0] + c_rob)
        assert float((pred_r - ddx.reshape(2, -1)).abs().max()) < 1e-3


@pytest.mark.parametrize("n", [3, 5, 8])
def test_equilibrium_forces_match_jax_lstsq(n):
    """At the hover state the 6 x n balance has rank 3 (every link
    vertical): the port's SVD solution with lstsq's cutoff is JAX's; at a
    swung state (full rank) too. The hover thrusts hold the payload still
    with taut links."""
    jp, js, tp = _pair(n)
    for jst in (js, _swung(js, n, 1)):
        got = ctrl.equilibrium_forces(tp, _port_state(jst))[0]
        np.testing.assert_allclose(got.numpy(),
                                   np.asarray(jctrl.equilibrium_forces(jp,
                                                                       jst)),
                                   atol=1e-5, rtol=0)
    q = _port_state(js).q[0]
    A = torch.cat([q.T, torch.linalg.cross(tp.r, q @ torch.eye(3)).T])
    assert int(torch.linalg.matrix_rank(A)) == 3
    st = _port_state(js)
    (_, dvl, dwl), T = pmrl.forward_dynamics(
        tp, st, ctrl.equilibrium_forces(tp, st))
    assert float(dvl.abs().max()) < 1e-4 and float(dwl.abs().max()) < 1e-4
    assert bool((T > 0).all())


def _pd(vl, xl, target):
    """The JAX setpoint test's clamped PD reference acceleration."""
    dvl = -3.0 * vl - 1.5 * (xl - target)
    nrm = torch.linalg.vector_norm(dvl, dim=-1, keepdim=True)
    return dvl * torch.clamp(1.0 / torch.clamp(nrm, min=1e-9), max=1.0)


def test_control_step_matches_jax():
    """One control step (early-exit solve) at 2 swung states against the
    JAX controller per state; the default robot-acceleration target."""
    n = 4
    jp, js, tp = _pair(n)
    jcfg, cfg = jctrl.make_config(jp), ctrl.make_config(tp)
    jstates = [_swung(js, n, s) for s in (3, 4)]
    st = rollout.stack_scenarios(convert.pmrl_state(_np(jstates[0]),
                                                    device="cpu"), 2)
    st = st.replace(**{f: torch.stack([_t(getattr(j, f)) for j in jstates])
                       for f in ("q", "dq", "wl")})
    acc = (_t([0.2, -0.1, 0.05]), torch.zeros(3))
    hover = convert.pmrl_state(_np(js), device="cpu")
    cs = rollout.stack_scenarios(ctrl.init_ctrl_state(tp, cfg, hover), 2)
    f, cs1, stats = ctrl.control(tp, cfg, cs, st, acc)
    jcs = jctrl.init_ctrl_state(jp, jcfg, js)
    jstep = jax.jit(lambda c, s: jctrl.control(
        jp, jcfg, c, s, (jnp.asarray([0.2, -0.1, 0.05], jnp.float32),
                         jnp.zeros(3))))
    for s, jst in enumerate(jstates):
        jf, _, jstats = jstep(jcs, jst)
        np.testing.assert_allclose(f[s].numpy(), np.asarray(jf), atol=5e-3,
                                   rtol=0)
        assert float(stats.ok_frac[s]) == float(jstats.ok_frac)
        assert int(stats.iters[s]) == int(jstats.iters) == -1


def test_setpoint_first_steps_match_jax():
    """The first 30 steps of the JAX setpoint test (n = 3, dt 1e-2,
    solver_iters 250): the port against JAX at every step, every solve
    healthy."""
    n = 3
    jp, js, tp = _pair(n)
    jcfg = jctrl.make_config(jp, solver_iters=250)
    cfg = ctrl.make_config(tp, solver_iters=250)
    jcs = jctrl.init_ctrl_state(jp, jcfg, js)
    hover = convert.pmrl_state(_np(js), device="cpu")
    cs = rollout.stack_scenarios(ctrl.init_ctrl_state(tp, cfg, hover), 1)
    target = jnp.asarray(TARGET, jnp.float32)

    def jbody(carry):
        c, s = carry
        dvl = -3.0 * s.vl - 1.5 * (s.xl - target)
        nrm = jnp.linalg.norm(dvl)
        dvl = dvl * jnp.minimum(1.0, 1.0 / jnp.maximum(nrm, 1e-9))
        f, c, stats = jctrl.control(jp, jcfg, c, s, (dvl, jnp.zeros(3)))
        return (c, jpmrl.integrate(jp, s, f, 1e-2)), (f, stats.ok_frac)

    jbody = jax.jit(jbody)
    st = _port_state(js)
    jst = js
    for i in range(30):
        (jcs, jst), (jf, jok) = jbody((jcs, jst))
        dvl = _pd(st.vl, st.xl, _t(TARGET))
        f, cs, stats = ctrl.control(tp, cfg, cs, st, (dvl,
                                                      torch.zeros_like(dvl)))
        st = pmrl.integrate(tp, st, f, 1e-2)
        assert float(stats.ok_frac[0]) == float(jok) == 1.0, i
        np.testing.assert_allclose(f[0].numpy(), np.asarray(jf), atol=5e-3,
                                   rtol=0, err_msg=f"step {i}")
        for k in ("q", "dq", "xl", "vl", "Rl", "wl"):
            np.testing.assert_allclose(
                getattr(st, k)[0].numpy(), np.asarray(getattr(jst, k)),
                atol=1e-4, rtol=0, err_msg=f"{k} at step {i}")


@pytest.mark.parametrize("n", [3, 5])
def test_runs_finite_any_n(n):
    """Five zero-reference steps at n in {3, 5}: finite forces (the JAX
    test's contract), for 2 scenarios at once."""
    params, _, state0 = setup.pmrl_setup(n, device="cpu")
    cfg = ctrl.make_config(params)
    cs = rollout.stack_scenarios(ctrl.init_ctrl_state(params, cfg, state0),
                                 2)
    st = rollout.stack_scenarios(state0, 2)
    for _ in range(5):
        f, cs, _ = ctrl.control(params, cfg, cs, st,
                                (torch.zeros(3), torch.zeros(3)))
        st = pmrl.integrate(params, st, f, 1e-2)
        assert bool(torch.isfinite(f).all())


def test_ctrl_state_converter_round_trip():
    """JAX controller state -> port -> the same numpy arrays."""
    jp, js, _ = _pair(4)
    jcs = jctrl.init_ctrl_state(jp, jctrl.make_config(jp), js)
    got = convert.pmrl_ctrl_state(_np(jcs), device="cpu")
    for a, b in zip(jax.tree.leaves(_np(jcs)), [got.prev_f, *got.warm]):
        np.testing.assert_array_equal(b.numpy(), a)
