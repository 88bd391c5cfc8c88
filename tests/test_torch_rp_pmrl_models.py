"""PyTorch port vs the JAX package: the RP and PMRL system models
(``models/rp.py``, ``models/pmrl.py``), their set-up factories and state
converters. Mirrors ``tests/test_rp_pmrl_models.py``.

The inputs are drawn from numpy seeds; both packages get the same float32
parameters (the port's carried across with ``convert.*_params``, so
``Jl_inv`` and ``Jl_inv_factor`` are the JAX package's, not a second float32
inverse).

Tolerances, and why:

- Set-up, parameters and collision metadata: exact (the same float32
  roundings of the same constants; the inverse and its Cholesky factor are
  float32 LAPACK on both sides).
- RP accelerations: 1e-5 relative + 1e-5 absolute (the same float32
  products summed in another order; accelerations up to ~50 rad/s^2).
- PMRL accelerations and tensions: 1e-4 relative + 1e-4 absolute. The
  tensions come out of an n x n LU solve whose pivoting and sums differ
  between the two packages' LAPACK calls; its condition number (up to
  ~1e2 at random link directions) scales the float32 rounding.
- 100 integration steps at 1 ms: states within 1e-4 (RP) and 2e-4 (PMRL):
  per-step rounding of the products above, carried through the
  trapezoidal updates and the Newton-Schulz projection every 20 steps.
- The inverse-dynamics oracles: the port's own residual under 1e-4 (RP)
  and 5e-4 (PMRL), the JAX tests' bars; the port's oracle against the JAX
  oracle on the same inputs within 1e-4.
- Manifold invariants after 1000 steps: |q| = 1 within 1e-5, q . dq
  within 1e-4, Rl^T Rl = I within 1e-4 (the JAX tests' bars).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_aerial_transport.harness import setup as jsetup
from tpu_aerial_transport.models import pmrl as jpmrl
from tpu_aerial_transport.models import rp as jrp
from tpu_aerial_transport_torch import convert
from tpu_aerial_transport_torch.harness import setup
from tpu_aerial_transport_torch.models import pmrl, rp


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _t(a):
    return torch.as_tensor(np.asarray(a, np.float32))


def _expm(w):
    """Rotation from a rotation vector, in float64 (Rodrigues)."""
    th = np.linalg.norm(w)
    K = np.array([[0, -w[2], w[1]], [w[2], 0, -w[0]], [-w[1], w[0], 0]])
    if th < 1e-12:
        return np.eye(3)
    K = K / th
    return np.eye(3) + np.sin(th) * K + (1 - np.cos(th)) * K @ K


def _rp_pair(n):
    """The JAX test's RP parameters (an n-gon of radius 0.4) in both
    packages."""
    ang = 2 * np.pi * np.arange(n) / n
    r = np.stack([np.cos(ang), np.sin(ang), np.zeros(n)], -1) * 0.4
    Jl = np.diag([2.1e-2, 1.87e-2, 3.97e-2])
    jp = jrp.rp_params(0.225, Jl, r)
    return jp, convert.rp_params(_np(jp), device="cpu")


def _rp_state_arrays(seed):
    rng = np.random.default_rng(seed)
    return dict(xl=rng.normal(size=3), vl=rng.normal(size=3),
                Rl=_expm(rng.normal(size=3) * 0.5), wl=rng.normal(size=3))


def _pmrl_pair(n):
    ang = 2 * np.pi * np.arange(n) / n
    r = np.stack([np.cos(ang), np.sin(ang), np.zeros(n)], -1) * 0.4
    Jl = np.diag([2.1e-2, 1.87e-2, 3.97e-2])
    jp = jpmrl.pmrl_params(np.full(n, 0.5), 0.225, Jl, r, np.ones(n))
    return jp, convert.pmrl_params(_np(jp), device="cpu")


def _pmrl_state_arrays(seed, n):
    """Links tilted at most ~35 degrees from +z, tangent velocities, a
    random payload state."""
    rng = np.random.default_rng(seed)
    q = np.tile([0.0, 0.0, 1.0], (n, 1)) + 0.4 * rng.normal(size=(n, 3))
    return dict(q=q, dq=0.3 * rng.normal(size=(n, 3)), xl=rng.normal(size=3),
                vl=rng.normal(size=3), Rl=_expm(rng.normal(size=3) * 0.3),
                wl=rng.normal(size=3))


def _close(a, b, rtol, atol, msg=""):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=rtol,
                               atol=atol, err_msg=msg)


@pytest.mark.parametrize("n", [3, 5])
def test_rp_forward_dynamics_and_integration_match_jax(n):
    """Forward dynamics at 5 seeded states and forces, then 100 integration
    steps under fixed forces: accelerations and states against JAX."""
    jp, tp = _rp_pair(n)
    for seed in range(5):
        arr = _rp_state_arrays(seed)
        js = jrp.rp_state(**arr)
        ts = rp.rp_state(**arr, device="cpu")
        _close(ts.Rl, js.Rl, 0, 1e-6)
        f = np.random.default_rng(100 + seed).normal(size=(n, 3))
        jacc = jrp.forward_dynamics(jp, js, jnp.asarray(f, jnp.float32))
        tacc = rp.forward_dynamics(tp, ts, _t(f))
        for a, b in zip(tacc, jacc):
            _close(a, b, 1e-5, 1e-5)
    jstep = jax.jit(lambda s, f: jrp.integrate(jp, s, f, 1e-3))
    f = jnp.asarray(np.random.default_rng(7).normal(size=(n, 3)),
                    jnp.float32)
    js, ts = jrp.rp_state(**arr), rp.rp_state(**arr, device="cpu")
    for _ in range(100):
        js, ts = jstep(js, f), rp.integrate(tp, ts, _t(f), 1e-3)
    for k in ("xl", "vl", "Rl", "wl"):
        _close(getattr(ts, k), getattr(js, k), 0, 1e-4, k)
    assert int(ts.step) == int(js.step) == 100 % rp.PROJECTION_PERIOD


@pytest.mark.parametrize("n", [3, 6])
def test_pmrl_forward_dynamics_tensions_and_integration_match_jax(n):
    """Forward dynamics (accelerations and link tensions) at 5 seeded
    states and thrusts, then 100 integration steps: against JAX."""
    jp, tp = _pmrl_pair(n)
    for seed in range(5):
        arr = _pmrl_state_arrays(seed, n)
        js = jpmrl.pmrl_state(**arr)
        ts = pmrl.pmrl_state(**arr, device="cpu")
        _close(ts.q, js.q, 0, 1e-7)
        _close(ts.dq, js.dq, 0, 1e-6)
        f = 2.0 * np.random.default_rng(200 + seed).normal(size=(n, 3))
        (jddq, jdvl, jdwl), jT = jpmrl.forward_dynamics(
            jp, js, jnp.asarray(f, jnp.float32))
        (ddq, dvl, dwl), T = pmrl.forward_dynamics(tp, ts, _t(f))
        for name, a, b in (("ddq", ddq, jddq), ("dvl", dvl, jdvl),
                           ("dwl", dwl, jdwl), ("T", T, jT)):
            _close(a, b, 1e-4, 1e-4, name)
    jstep = jax.jit(lambda s, f: jpmrl.integrate(jp, s, f, 1e-3))
    f = jnp.asarray(2.0 * np.asarray(js.q), jnp.float32)
    ts = pmrl.pmrl_state(**arr, device="cpu")
    for _ in range(100):
        js, ts = jstep(js, f), pmrl.integrate(tp, ts, _t(f), 1e-3)
    for k in ("q", "dq", "xl", "vl", "Rl", "wl"):
        _close(getattr(ts, k), getattr(js, k), 0, 2e-4, k)


def test_batched_dynamics_match_one_scenario_at_a_time():
    """A state with a leading scenario axis gives each scenario's own
    accelerations (the batched LU solve included)."""
    tp_rp, tp_pm = _rp_pair(4)[1], _pmrl_pair(4)[1]
    rs = [rp.rp_state(**_rp_state_arrays(s), device="cpu") for s in range(3)]
    ps = [pmrl.pmrl_state(**_pmrl_state_arrays(s, 4), device="cpu")
          for s in range(3)]
    rng = np.random.default_rng(3)
    f = _t(rng.normal(size=(3, 4, 3)))
    stack = lambda sts: type(sts[0])(**{  # noqa: E731
        k.name: torch.stack([getattr(s, k.name) for s in sts])
        for k in dataclasses.fields(sts[0])})
    out_rp = rp.forward_dynamics(tp_rp, stack(rs), f)
    out_pm = pmrl.forward_dynamics(tp_pm, stack(ps), f)
    for s in range(3):
        for a, b in zip(out_rp, rp.forward_dynamics(tp_rp, rs[s], f[s])):
            _close(a[s], b, 1e-6, 1e-6)
        (ddq, dvl, dwl), T = pmrl.forward_dynamics(tp_pm, ps[s], f[s])
        for a, b in zip((*out_pm[0], out_pm[1]), (ddq, dvl, dwl, T)):
            _close(a[s], b, 1e-5, 1e-5)


@pytest.mark.parametrize("n", [3, 5])
def test_rp_inverse_dynamics_oracle(n):
    """The port's residual of its own accelerations under the JAX test's
    1e-4, and the port's oracle equal to the JAX oracle on the same
    inputs."""
    jp, tp = _rp_pair(n)
    for seed in range(5):
        arr = _rp_state_arrays(seed)
        ts, js = rp.rp_state(**arr, device="cpu"), jrp.rp_state(**arr)
        f = np.random.default_rng(300 + seed).normal(size=(n, 3))
        acc = rp.forward_dynamics(tp, ts, _t(f))
        assert float(rp.inverse_dynamics_error(ts, tp, _t(f), acc)) < 1e-4
        wrong = (acc[0] + 0.1, acc[1])
        ref = jrp.inverse_dynamics_error(
            js, jp, jnp.asarray(f, jnp.float32),
            tuple(jnp.asarray(a.numpy()) for a in wrong))
        _close(rp.inverse_dynamics_error(ts, tp, _t(f), wrong), ref, 0, 1e-4)


@pytest.mark.parametrize("n", [3, 6])
def test_pmrl_inverse_dynamics_oracle(n):
    """The four-equation residual (sphere constraint included) of the
    port's own accelerations and tensions under the JAX test's 5e-4, and
    the port's oracle equal to the JAX oracle on the same inputs."""
    jp, tp = _pmrl_pair(n)
    for seed in range(5):
        arr = _pmrl_state_arrays(seed + 10, n)
        ts, js = pmrl.pmrl_state(**arr, device="cpu"), jpmrl.pmrl_state(**arr)
        f = _t(2.0 * np.random.default_rng(400 + seed).normal(size=(n, 3)))
        acc, T = pmrl.forward_dynamics(tp, ts, f)
        assert float(pmrl.inverse_dynamics_error(ts, tp, f, T, acc)) < 5e-4
        wrong = (acc[0] + 0.05, acc[1], acc[2])
        ref = jpmrl.inverse_dynamics_error(
            js, jp, jnp.asarray(f.numpy()), jnp.asarray(T.numpy()),
            tuple(jnp.asarray(a.numpy()) for a in wrong))
        _close(pmrl.inverse_dynamics_error(ts, tp, f, T, wrong), ref, 1e-5,
               1e-4)


def test_manifold_invariants():
    """S^2 and SO(3) after 1000 steps of each model (the JAX tests'
    bars), and the projections of a fresh state."""
    arr = _pmrl_state_arrays(2, 3)
    ts = pmrl.pmrl_state(**arr, device="cpu")
    assert float((torch.linalg.vector_norm(ts.q, dim=-1) - 1).abs().max()) \
        < 1e-6
    assert float(torch.sum(ts.q * ts.dq, dim=-1).abs().max()) < 1e-6
    tp = _pmrl_pair(3)[1]
    f = ts.q * 2.0
    for _ in range(1000):
        ts = pmrl.integrate(tp, ts, f, 1e-3)
    eye = torch.eye(3)
    assert float((torch.linalg.vector_norm(ts.q, dim=-1) - 1).abs().max()) \
        < 1e-5
    assert float(torch.sum(ts.q * ts.dq, dim=-1).abs().max()) < 1e-4
    assert float((ts.Rl.T @ ts.Rl - eye).abs().max()) < 1e-4
    assert bool(torch.isfinite(ts.xl).all())
    rs = rp.rp_state(**_rp_state_arrays(3), device="cpu")
    rpp = _rp_pair(3)[1]
    for _ in range(1000):
        rs = rp.integrate(rpp, rs, torch.zeros(3, 3), 1e-3)
    assert float((rs.Rl.T @ rs.Rl - eye).abs().max()) < 1e-4


def test_rp_hover_equilibrium():
    """Equal vertical forces summing to ml g with symmetric attachments
    give zero accelerations."""
    tp = _rp_pair(3)[1]
    f = torch.zeros(3, 3)
    f[:, 2] = float(tp.ml) * rp.GRAVITY / 3
    dvl, dwl = rp.forward_dynamics(tp, rp.rp_identity_state(device="cpu"), f)
    assert float(dvl.abs().max()) < 1e-5 and float(dwl.abs().max()) < 1e-5


@pytest.mark.parametrize("n", [3, 4, 8])
def test_setups_and_collision_metadata_match_jax(n):
    """``rp_setup``/``pmrl_setup``: parameters, the initial state and the
    collision metadata exactly the JAX package's."""
    for jfn, tfn in ((jsetup.rp_setup, setup.rp_setup),
                     (jsetup.pmrl_setup, setup.pmrl_setup)):
        jp, jcol, js = jfn(n)
        tp, tcol, ts = tfn(n, device="cpu")
        for f in dataclasses.fields(tp):
            np.testing.assert_allclose(getattr(tp, f.name).numpy(),
                                       np.asarray(getattr(jp, f.name)),
                                       rtol=1e-6, atol=1e-7, err_msg=f.name)
        for f in dataclasses.fields(ts):
            np.testing.assert_array_equal(getattr(ts, f.name).numpy(),
                                          np.asarray(getattr(js, f.name)))
        assert tcol.collision_radius == jcol.collision_radius
        np.testing.assert_array_equal(tcol.payload_vertices,
                                      jcol.payload_vertices)
        np.testing.assert_array_equal(tcol.payload_mesh_vertices,
                                      jcol.payload_mesh_vertices)
    assert isinstance(tcol, pmrl.PMRLCollision)
    mesh_r = np.max(np.linalg.norm(tcol.payload_mesh_vertices, axis=1))
    assert tcol.collision_radius >= mesh_r + float(tp.L.max())


@pytest.mark.parametrize("kind", ["rp", "pmrl"])
def test_state_and_param_converters_round_trip(kind):
    """JAX pytree -> port -> the same numpy arrays, leaf by leaf, with the
    projection counter an int32."""
    if kind == "rp":
        jp, _, js = jsetup.rp_setup(4)
        js = js.replace(wl=jnp.array([0.1, -0.2, 0.3]),
                        step=jnp.asarray(7, jnp.int32))
        tp = convert.rp_params(_np(jp), device="cpu")
        ts = convert.rp_state(_np(js), device="cpu")
    else:
        jp, _, js = jsetup.pmrl_setup(4)
        js = js.replace(dq=jnp.ones((4, 3)) * 0.1,
                        step=jnp.asarray(7, jnp.int32))
        tp = convert.pmrl_params(_np(jp), device="cpu")
        ts = convert.pmrl_state(_np(js), device="cpu")
    for port, ref in ((tp, jp), (ts, js)):
        for f in dataclasses.fields(port):
            np.testing.assert_array_equal(getattr(port, f.name).numpy(),
                                          np.asarray(getattr(ref, f.name)))
    assert ts.step.dtype == torch.int32 and tp.n == jp.n == 4

