"""PyTorch port vs the JAX package: SO(3) math, RQP dynamics and the PD
low-level controller, on the same seeded numpy inputs.

Tolerances: float32 on both sides, but the two frameworks order the sums of
their small matrix products differently, so single operations agree to a
few ulps (atol 1e-6 on O(1) values) and a long integration accumulates that
rounding (see the 1000-step test)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_aerial_transport.control import lowlevel as jlowlevel
from tpu_aerial_transport.harness import setup as jsetup
from tpu_aerial_transport.models import rqp as jrqp
from tpu_aerial_transport.ops import lie as jlie
from tpu_aerial_transport_torch.control import lowlevel
from tpu_aerial_transport_torch.harness import setup
from tpu_aerial_transport_torch.models import rqp
from tpu_aerial_transport_torch.ops import lie

RNG = np.random.default_rng(7)


def _t(a):
    return torch.as_tensor(np.array(a, np.float32))


def _close(a, b, atol, rtol=0.0):
    np.testing.assert_allclose(np.asarray(b.detach().numpy()),
                               np.asarray(a), atol=atol, rtol=rtol)


def _rotations(k, scale=1.0, seed=0):
    w = np.random.default_rng(seed).normal(size=(k, 3)) * scale
    return np.asarray(jlie.expm_so3(jnp.asarray(w, jnp.float32)))


V = RNG.normal(size=(64, 3)).astype(np.float32)
U = RNG.normal(size=(64, 3)).astype(np.float32)


@pytest.mark.parametrize("name", ["hat", "expm_so3", "vee_hat"])
def test_lie_unary(name):
    if name == "vee_hat":
        ref = jlie.vee(jlie.hat(jnp.asarray(V)))
        out = lie.vee(lie.hat(_t(V)))
    else:
        ref = getattr(jlie, name)(jnp.asarray(V))
        out = getattr(lie, name)(_t(V))
    _close(ref, out, atol=1e-6)


def test_expm_small_angles_take_the_taylor_branch():
    w = np.array([[0.0, 0.0, 0.0], [1e-9, 0.0, 0.0], [1e-7, 1e-8, 0.0],
                  [2e-6, -1e-6, 3e-6]], np.float32)
    _close(jlie.expm_so3(jnp.asarray(w)), lie.expm_so3(_t(w)), atol=1e-7)


def test_hat_square_and_cross():
    _close(jlie.hat_square(jnp.asarray(U), jnp.asarray(V)),
           lie.hat_square(_t(U), _t(V)), atol=1e-6)
    _close(jnp.cross(jnp.asarray(U), jnp.asarray(V)), lie.cross(_t(U), _t(V)),
           atol=1e-6)


def test_log_so3_and_polar_project():
    R = _rotations(64, scale=0.8)
    _close(jlie.log_so3(jnp.asarray(R)), lie.log_so3(_t(R)), atol=2e-6)
    # Drifted rotations (what the integrator re-projects): 8 Newton-Schulz
    # iterations on both sides.
    noisy = R + 1e-3 * RNG.normal(size=R.shape).astype(np.float32)
    _close(jlie.polar_project(jnp.asarray(noisy)),
           lie.polar_project(_t(noisy)), atol=1e-6)


def test_rotation_constructions():
    a = V / np.linalg.norm(V, axis=1, keepdims=True)
    b = U / np.linalg.norm(U, axis=1, keepdims=True)
    a[0] = -b[0]  # the antipodal fallback.
    _close(jlie.rotation_a_to_b(jnp.asarray(a), jnp.asarray(b)),
           lie.rotation_a_to_b(_t(a), _t(b)), atol=2e-5)
    q = np.abs(b) * np.array([1.0, 1.0, 1.0]) + np.array([0.0, 0.0, 0.5])
    q = (q / np.linalg.norm(q, axis=1, keepdims=True)).astype(np.float32)
    _close(jlie.rotation_from_z(jnp.asarray(q)), lie.rotation_from_z(_t(q)),
           atol=1e-6)


def _random_state(n, seed):
    rng = np.random.default_rng(seed)
    return dict(
        R=_rotations(n, 0.2, seed), w=0.3 * rng.normal(size=(n, 3)),
        xl=rng.normal(size=3), vl=0.5 * rng.normal(size=3),
        Rl=_rotations(1, 0.1, seed + 1)[0], wl=0.2 * rng.normal(size=3),
    )


def _jstate(d):
    return jrqp.RQPState(**{k: jnp.asarray(v, jnp.float32) for k, v in
                            d.items()}, step=jnp.zeros((), jnp.int32))


def _tstate(d):
    return rqp.RQPState(**{k: _t(v) for k, v in d.items()},
                        step=torch.zeros((), dtype=torch.int32))


@pytest.mark.parametrize("n", [4, 8])
def test_params_and_forward_dynamics(n):
    jp, _, _ = jsetup.rqp_setup(n)
    tp, _, _ = setup.rqp_setup(n, device="cpu")
    for f in ("m", "J", "ml", "Jl", "r", "mT", "x_com", "r_com", "JT"):
        _close(getattr(jp, f), getattr(tp, f), atol=1e-7)
    # Inverses: LU rounding differs between frameworks (JT_inv ~ 1e2).
    _close(jp.JT_inv, tp.JT_inv, atol=1e-6, rtol=1e-5)
    d = _random_state(n, 3)
    f = (2.0 + RNG.normal(size=n)).astype(np.float32)
    M = (0.01 * RNG.normal(size=(n, 3))).astype(np.float32)
    ref = jrqp.forward_dynamics(jp, _jstate(d),
                                (jnp.asarray(f), jnp.asarray(M)))
    out = rqp.forward_dynamics(tp, _tstate(d), (_t(f), _t(M)))
    for a, b in zip(ref, out):
        _close(a, b, atol=2e-5, rtol=1e-5)


def test_integrate_1000_steps_matches():
    """A 1000-step (1 s) closed trajectory under a fixed, slightly uneven
    wrench from a tilted spinning state, with the SO(3) re-projection every
    20 steps. The trajectories agree to 1e-4 (absolute, on positions of a
    few metres and rates of ~1 rad/s): per-step float32 rounding of ~1e-7,
    re-ordered sums in the 3x3 products, over 1000 steps."""
    n = 4
    jp, _, _ = jsetup.rqp_setup(n)
    tp, _, _ = setup.rqp_setup(n, device="cpu")
    d = _random_state(n, 11)
    f = (np.full(n, float(jp.mT) * jrqp.GRAVITY / n)
         * (1.0 + 0.02 * np.arange(n))).astype(np.float32)
    M = (1e-3 * np.random.default_rng(5).normal(size=(n, 3))).astype(
        np.float32)
    js, ts = _jstate(d), _tstate(d)
    jw = (jnp.asarray(f), jnp.asarray(M))
    tw = (_t(f), _t(M))

    def body(s, _):
        return jrqp.integrate(jp, s, jw, 1e-3), None

    js = jax.jit(lambda s: jax.lax.scan(body, s, None, length=1000)[0])(js)
    for _ in range(1000):
        ts = rqp.integrate(tp, ts, tw, 1e-3)
    assert int(js.step) == int(ts.step) == 1000 % rqp.PROJECTION_PERIOD
    for fld in ("R", "w", "xl", "vl", "Rl", "wl"):
        _close(getattr(js, fld), getattr(ts, fld), atol=1e-4)
    # Orthogonality kept by the periodic re-projection.
    R = ts.R.numpy()
    assert np.abs(np.swapaxes(R, -1, -2) @ R - np.eye(3)).max() < 1e-5


def test_integrate_projection_select_is_per_lane():
    """Each scenario's own step counter decides its re-projection."""
    tp, _, s0 = setup.rqp_setup(4, device="cpu")
    st = s0.replace(
        R=s0.R.expand(2, 4, 3, 3) * 1.001, w=s0.w.expand(2, 4, 3),
        xl=s0.xl.expand(2, 3), vl=s0.vl.expand(2, 3),
        Rl=s0.Rl.expand(2, 3, 3), wl=s0.wl.expand(2, 3),
        step=torch.tensor([18, 0], dtype=torch.int32),
    )
    out = rqp.integrate_state(st, (torch.zeros(2, 4, 3), torch.zeros(2, 3),
                                   torch.zeros(2, 3)), 1e-3)
    assert out.step.tolist() == [19, 1]
    out = rqp.integrate_state(out, (torch.zeros(2, 4, 3), torch.zeros(2, 3),
                                    torch.zeros(2, 3)), 1e-3)
    assert out.step.tolist() == [0, 2]
    assert abs(float(out.R[0, 0, 0, 0]) - 1.0) < 1e-6  # projected.
    assert abs(float(out.R[1, 0, 0, 0]) - 1.001) < 1e-6  # not yet.


@pytest.mark.parametrize("zero_agent", [False, True])
def test_pd_lowlevel_control_matches(zero_agent):
    """PD law + thrust projection, including the zero-f_des NaN guard and
    the actuator thrust_scale."""
    n = 8
    jp, _, _ = jsetup.rqp_setup(n)
    tp, _, _ = setup.rqp_setup(n, device="cpu")
    d = _random_state(n, 21)
    f_des = (np.array([0.0, 0.0, 3.0]) + 0.5 * RNG.normal(size=(n, 3))
             ).astype(np.float32)
    scale = np.ones(n, np.float32)
    if zero_agent:
        f_des[2] = 0.0
        scale[2] = 0.0
    jll = jlowlevel.make_lowlevel_controller("pd", jp)
    tll = lowlevel.make_lowlevel_controller("pd", tp)
    ref = jll.control(_jstate(d), jnp.asarray(f_des), jnp.asarray(scale))
    out = tll.control(_tstate(d), _t(f_des), _t(scale))
    for a, b in zip(ref, out):
        assert np.all(np.isfinite(b.numpy()))
        _close(a, b, atol=1e-6)
