"""PyTorch port vs the JAX package: the sliding-mode SO(3) law, the low-level
controller on it, ten 1 kHz substeps under it, ``inverse_dynamics_error``,
and ``random_cone_vector`` by its distribution.

Tolerances, and why:

- The SM law, the low-level control and ten substeps: atol 1e-5. Both
  frameworks run float32, but they order the small 3x3 products' sums
  differently and take ``|y|^0.5`` and ``(|e_R| + eps)^-0.5`` through
  different pow paths (a few ulps each); the law's ``1 / sqrt(|e_R| +
  1e-6)`` term amplifies them where an error component is near zero.
- ``inverse_dynamics_error``: the residual of the same float32 terms, to
  1e-5 absolute against the JAX package's; on a consistent
  ``forward_dynamics`` triple it is rounding, below 1e-4 (the JAX package's
  own bar in ``tests/test_rqp_model.py``).
- ``random_cone_vector`` draws from a ``torch.Generator``, so its bits
  cannot be the JAX PRNG's: unit norm to 1e-5, angle within theta + 1e-5
  (``tests/test_lie.py``'s bars), the same bits from the same seed, and a
  Kolmogorov-Smirnov distance below 1.63 / sqrt(N) (the 1% critical value)
  for ``tan^2(angle) / tan^2(theta)`` and ``phi / 2 pi`` against the
  uniform law.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_lie_rqp import _close, _jstate, _random_state, _t, _tstate

from tpu_aerial_transport.control import lowlevel as jlowlevel
from tpu_aerial_transport.control import so3_tracking as jso3
from tpu_aerial_transport.harness import setup as jsetup
from tpu_aerial_transport.models import rqp as jrqp
from tpu_aerial_transport.ops import lie as jlie
from tpu_aerial_transport_torch.control import lowlevel, so3_tracking
from tpu_aerial_transport_torch.harness import rollout, setup
from tpu_aerial_transport_torch.models import rqp
from tpu_aerial_transport_torch.ops import lie
from tpu_aerial_transport_torch.tree import tree_map

RNG = np.random.default_rng(11)


def _rot(k, scale, seed):
    w = np.random.default_rng(seed).normal(size=(k, 3)) * scale
    return np.array(jlie.expm_so3(jnp.asarray(w, jnp.float32)))


def test_sm_params_and_eps():
    assert so3_tracking.So3SMParams() == so3_tracking.So3SMParams(
        **{k: getattr(jso3.So3SMParams(), k)
           for k in ("r", "k_R", "l_R", "k_s", "l_s")})
    assert so3_tracking._EPS == jso3._EPS


def test_sm_law_matches_jax():
    """The law on 64 random attitudes, rates and references (``wd`` and
    ``dwd`` nonzero, so the feed-forward is in the check), and with one
    exactly zero attitude error (the ``sign(0)`` and ``eps`` branch)."""
    B = 64
    R = _rot(B, 0.6, 1)
    Rd = _rot(B, 0.6, 2)
    Rd[0] = R[0]
    w = (0.5 * RNG.normal(size=(B, 3))).astype(np.float32)
    wd = (0.3 * RNG.normal(size=(B, 3))).astype(np.float32)
    dwd = (0.2 * RNG.normal(size=(B, 3))).astype(np.float32)
    J = np.asarray(jsetup.rqp_setup(4)[0].J)[np.arange(B) % 4]
    p = jso3.So3SMParams()
    ref = jax.jit(lambda *a: jso3.so3_sm_tracking_control(*a, p))(
        *(jnp.asarray(x) for x in (R, Rd, w, wd, dwd, J)))
    out = so3_tracking.so3_sm_tracking_control(
        *(_t(x) for x in (R, Rd, w, wd, dwd, J)), so3_tracking.So3SMParams())
    assert torch.isfinite(out).all()
    _close(ref, out, atol=1e-5)


@pytest.mark.parametrize("zero_agent", [False, True])
def test_sm_lowlevel_control_matches(zero_agent):
    """``make_lowlevel_controller("sm")`` builds the JAX gains and
    ``lowlevel_control`` dispatches on the gains' type, with the zero-f_des
    guard and the thrust scale."""
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
    jll = jlowlevel.make_lowlevel_controller("sm", jp)
    tll = lowlevel.make_lowlevel_controller("sm", tp)
    assert isinstance(tll.so3_params, so3_tracking.So3SMParams)
    assert vars(tll.so3_params) == {k: getattr(jll.so3_params, k)
                                    for k in vars(tll.so3_params)}
    ref = jll.control(_jstate(d), jnp.asarray(f_des), jnp.asarray(scale))
    out = tll.control(_tstate(d), _t(f_des), _t(scale))
    for a, b in zip(ref, out):
        assert np.all(np.isfinite(b.numpy()))
        _close(a, b, atol=1e-5)
    pd = lowlevel.lowlevel_control(tp.J, so3_tracking.So3PDParams(),
                                   _tstate(d), _t(f_des))
    assert not torch.allclose(pd[1], out[1])  # the law really differs.
    with pytest.raises(ValueError, match="'pd' or 'sm'"):
        lowlevel.make_lowlevel_controller("lqr", tp)


def test_sm_substeps_match_jax():
    """Ten 1 kHz substeps of SM low-level control and physics over 4
    scenarios (``rollout.make_substeps``, eager on the CPU) against a
    ``jax.vmap`` of the JAX package's loop."""
    n, S = 4, 4
    jp, _, _ = jsetup.rqp_setup(n)
    tp, _, _ = setup.rqp_setup(n, device="cpu")
    ds = [_random_state(n, 40 + s) for s in range(S)]
    stacked = {k: np.stack([d[k] for d in ds]).astype(np.float32)
               for k in ds[0]}
    f_des = (np.array([0.0, 0.0, float(jp.mT) * jrqp.GRAVITY / n])
             + 0.3 * RNG.normal(size=(S, n, 3))).astype(np.float32)
    jll = jlowlevel.make_lowlevel_controller("sm", jp)

    def jax_sub(s, f):
        for _ in range(10):
            s = jrqp.integrate(jp, s, jll.control(s, f), 1e-3)
        return s

    js = jax.vmap(lambda *a: jrqp.RQPState(
        **dict(zip(("R", "w", "xl", "vl", "Rl", "wl"), a)),
        step=jnp.zeros((), jnp.int32)))(
        *(jnp.asarray(stacked[k]) for k in ("R", "w", "xl", "vl", "Rl",
                                             "wl")))
    ref = jax.jit(jax.vmap(jax_sub))(js, jnp.asarray(f_des))
    ts = rqp.RQPState(**{k: _t(v) for k, v in stacked.items()},
                      step=torch.zeros((S,), dtype=torch.int32))
    tll = lowlevel.make_lowlevel_controller("sm", tp)
    out = rollout.make_substeps(tp, tll.control, cuda_graph=False)(
        ts, _t(f_des))
    for fld in ("R", "w", "xl", "vl", "Rl", "wl"):
        _close(getattr(ref, fld), getattr(out, fld), atol=1e-5)
    assert out.step.tolist() == [10] * S


@pytest.mark.parametrize("n", [4, 8])
def test_inverse_dynamics_error(n):
    """Against the JAX package's on a random triple (a scenario axis in
    front), and near zero on a consistent ``forward_dynamics`` triple."""
    jp, _, _ = jsetup.rqp_setup(n)
    tp, _, _ = setup.rqp_setup(n, device="cpu")
    S = 3
    ds = [_random_state(n, 60 + s) for s in range(S)]
    f = (2.0 + RNG.random((S, n))).astype(np.float32)
    M = (0.1 * RNG.normal(size=(S, n, 3))).astype(np.float32)
    acc = tuple((0.5 * RNG.normal(size=shape)).astype(np.float32)
                for shape in ((S, n, 3), (S, 3), (S, 3)))
    ref = [float(jrqp.inverse_dynamics_error(
        _jstate(ds[s]), jp, (jnp.asarray(f[s]), jnp.asarray(M[s])),
        tuple(jnp.asarray(a[s]) for a in acc))) for s in range(S)]
    states = tree_map(lambda *ts: torch.stack(ts),
                      *[_tstate(d) for d in ds])
    out = rqp.inverse_dynamics_error(states, tp, (_t(f), _t(M)),
                                     tuple(_t(a) for a in acc))
    assert out.shape == (S,)
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-5, rtol=1e-6)
    assert min(ref) > 1.0  # an inconsistent triple has a real residual.
    fwd = rqp.forward_dynamics(tp, states, (_t(f), _t(M)))
    err = rqp.inverse_dynamics_error(states, tp, (_t(f), _t(M)), fwd)
    assert float(err.max()) < 1e-4
    one = rqp.inverse_dynamics_error(_tstate(ds[0]), tp, (_t(f[0]),
                                     _t(M[0])), tuple(a[0] for a in fwd))
    assert one.shape == () and float(one) < 1e-4


def _ks_uniform(x: np.ndarray) -> float:
    """Kolmogorov-Smirnov distance of samples ``x`` in [0, 1] from the
    uniform law."""
    x = np.sort(x)
    n = x.size
    return float(max((np.arange(1, n + 1) / n - x).max(),
                     (x - np.arange(n) / n).max()))


@pytest.mark.parametrize("theta", [0.05, 0.4, 1.2])
def test_random_cone_vector_distribution(theta):
    N = 20000
    g = torch.Generator().manual_seed(5)
    v = lie.random_cone_vector(g, theta, (N,), device="cpu")
    assert v.shape == (N, 3) and v.dtype == torch.float32
    vn = v.numpy().astype(np.float64)
    assert np.abs(np.linalg.norm(vn, axis=-1) - 1.0).max() < 1e-5
    angles = np.arccos(np.clip(vn[:, 2], -1.0, 1.0))
    assert angles.max() <= theta + 1e-5
    tan2 = (vn[:, 0] ** 2 + vn[:, 1] ** 2) / vn[:, 2] ** 2
    u1 = tan2 / math.tan(theta) ** 2
    phi = np.mod(np.arctan2(vn[:, 1], vn[:, 0]), 2 * np.pi) / (2 * np.pi)
    bar = 1.63 / math.sqrt(N)
    assert _ks_uniform(np.clip(u1, 0.0, 1.0)) < bar
    assert _ks_uniform(phi) < bar
    # The same seed gives the same bits; another seed other bits.
    again = lie.random_cone_vector(torch.Generator().manual_seed(5), theta,
                                   (N,), device="cpu")
    assert torch.equal(v, again)
    other = lie.random_cone_vector(torch.Generator().manual_seed(6), theta,
                                   (N,), device="cpu")
    assert not torch.equal(v, other)


def test_random_cone_vector_shapes_and_refusal():
    g = torch.Generator().manual_seed(0)
    assert lie.random_cone_vector(g, 0.3, device="cpu").shape == (3,)
    assert lie.random_cone_vector(g, 0.3, (2, 5), device="cpu").shape \
        == (2, 5, 3)
    for theta in (0.0, -0.1, math.pi / 2, 2.0):
        with pytest.raises(ValueError, match="theta"):
            jlie.random_cone_vector(jax.random.PRNGKey(0), theta)
        with pytest.raises(ValueError, match="theta"):
            lie.random_cone_vector(g, theta, device="cpu")
