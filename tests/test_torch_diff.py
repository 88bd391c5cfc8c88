"""PyTorch port vs the JAX package: the differentiable-simulation harness
(``harness/diff.py``) and the repair of ``models/rqp.py rqp_params`` it
needs, on the same inputs (the JAX package's n = 3 set-up carried across
by ``convert``; numpy-seeded tilts, commands and plans).

Tolerances, and why:

- ``rqp_params``'s gradient in ``ml`` against ``jax.grad``: rtol 1e-4
  (float32 inverses through different LAPACK paths).
- ``substep_rollout``: every state leaf within 1e-6 absolute (ten float32
  substeps; the 3x3 products' sums ordered differently).
- ``payload_pd_forces``, ``plan_share_forces``: within 1e-7 (the same
  three float32 operations; on O(1)..O(10) N forces that is an ulp).
- ``make_rollout_loss`` against ``jax.value_and_grad``: value rtol 1e-5,
  gradients rtol 1e-4, atol 1e-8 (a probe measured about 2e-7 relative).
  The same bars for the sysid and trajopt losses.
- remat against no remat, and the finite-difference check: the bars of
  ``tests/test_diff.py`` (rtol 1e-6 and 1e-4; rtol 0.05, atol 1e-5).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_aerial_transport.control import centralized as jcentralized
from tpu_aerial_transport.harness import diff as jdiff
from tpu_aerial_transport.harness import setup as jsetup
from tpu_aerial_transport.models import rqp as jrqp
from tpu_aerial_transport.ops import lie as jlie
from tpu_aerial_transport_torch import convert
from tpu_aerial_transport_torch.harness import diff
from tpu_aerial_transport_torch.models import rqp

GAINS = {"k_R": np.float32(0.25), "k_Omega": np.float32(0.075)}
VALUE_RTOL, GRAD_RTOL, GRAD_ATOL = 1e-5, 1e-4, 1e-8


def _problem(n=3, tilt=0.3, seed=0):
    """The JAX set-up with tilted attitudes (numpy seed), and the port's
    copy of it: ``(jax (params, f_eq, state0), port (...))``."""
    jp, _, js0 = jsetup.rqp_setup(n)
    jf = jcentralized.equilibrium_forces(jp)
    axes = tilt * np.random.default_rng(seed).normal(size=(n, 3))
    js0 = js0.replace(
        R=jax.vmap(jlie.expm_so3)(jnp.asarray(axes, jnp.float32)) @ js0.R)
    host = lambda tree: jax.tree.map(np.asarray, tree)  # noqa: E731
    port = (convert.rqp_params(host(jp), device="cpu"),
            torch.as_tensor(np.array(jf)),
            convert.rqp_state(host(js0), device="cpu"))
    return (jp, jf, js0), port


def _close(ref, out, rtol=0.0, atol=0.0):
    np.testing.assert_allclose(np.asarray(out.detach().cpu().numpy()),
                               np.asarray(ref), rtol=rtol, atol=atol)


def _jgains(g=GAINS):
    return {k: jnp.asarray(v) for k, v in g.items()}


def _grads_close(jg, tg):
    assert set(jg) == set(tg)
    for k in jg:
        _close(jg[k], tg[k], rtol=GRAD_RTOL, atol=GRAD_ATOL)


def test_rqp_params_numpy_inputs_unchanged():
    """numpy inputs: the inverses are bitwise ``torch.linalg.inv``'s (what
    ``rqp_params`` returned before ``inv_ex``), and nothing requires
    grad."""
    p = rqp.rqp_params(np.full(4, 0.5), np.tile(np.diag([2.3e-3, 2.3e-3,
                                                         4e-3]), (4, 1, 1)),
                       0.225, np.diag([2.1, 1.87, 3.97]) * 1e-2,
                       np.random.default_rng(3).normal(size=(4, 3)),
                       device="cpu")
    assert torch.equal(p.JT_inv, torch.linalg.inv(p.JT))
    assert torch.equal(p.J_inv, torch.linalg.inv(p.J))
    assert not any(t.requires_grad for t in vars(p).values())


def test_rqp_params_differentiates_in_ml():
    """d(sum of JT_inv, x_com and mT)/d ml against ``jax.grad`` of the JAX
    ``rqp_params``; a tensor input stays in the autograd graph."""
    jp, _, _ = jsetup.rqp_setup(3)
    host = {k: np.array(getattr(jp, k)) for k in ("m", "J", "Jl", "r")}

    def jfn(ml):
        p = jrqp.rqp_params(host["m"], host["J"], ml, host["Jl"], host["r"])
        return jnp.sum(p.JT_inv) + jnp.sum(p.x_com) + p.mT

    for ml in (0.225, 0.4):
        ref = jax.grad(jfn)(jnp.float32(ml))
        t = torch.tensor(ml, dtype=torch.float32, requires_grad=True)
        p = rqp.rqp_params(*(torch.as_tensor(host[k]) for k in ("m", "J")), t,
                           torch.as_tensor(host["Jl"]),
                           torch.as_tensor(host["r"]), device="cpu")
        out = torch.sum(p.JT_inv) + torch.sum(p.x_com) + p.mT
        (g,) = torch.autograd.grad(out, t)
        _close(ref, g, rtol=1e-4)
        _close(jfn(jnp.float32(ml)), out, rtol=1e-5)


def test_substep_rollout_matches_jax():
    (jp, jf, js0), (tp, tf, ts0) = _problem()
    f_des = (np.asarray(jf) + np.random.default_rng(1).normal(
        size=(3, 3)) * 0.5).astype(np.float32)
    ref = jax.jit(lambda s, f: jdiff.substep_rollout(
        jp, _jgains(), s, f))(js0, jnp.asarray(f_des))
    out = diff.substep_rollout(tp, convert.gains(GAINS, "cpu"), ts0,
                               torch.as_tensor(f_des))
    for k in ("R", "w", "xl", "vl", "Rl", "wl"):
        _close(getattr(ref, k), getattr(out, k), atol=1e-6)
    assert int(out.step) == int(ref.step) == 10


def test_force_laws_match_jax():
    (jp, jf, js0), (tp, tf, ts0) = _problem()
    rng = np.random.default_rng(2)
    xl_ref = rng.normal(size=3).astype(np.float32)
    vl = rng.normal(size=3).astype(np.float32)
    js1, ts1 = js0.replace(vl=jnp.asarray(vl)), ts0.replace(
        vl=torch.as_tensor(vl))
    _close(jdiff.payload_pd_forces(jp, jf, js1, jnp.asarray(xl_ref)),
           diff.payload_pd_forces(tp, tf, ts1, torch.as_tensor(xl_ref)),
           atol=1e-7)
    acc = rng.normal(size=3).astype(np.float32)
    _close(jdiff.plan_share_forces(jp, jf, jnp.asarray(acc)),
           diff.plan_share_forces(tp, tf, torch.as_tensor(acc)), atol=1e-7)


@pytest.mark.parametrize("k_att", [0.0, 1.0])
def test_rollout_loss_value_and_grad_match_jax(k_att):
    """10 MPC steps from tilted attitudes, ``remat=True``."""
    (jp, jf, js0), (tp, tf, ts0) = _problem()
    dxl = np.array([0.4, 0.0, 0.3], np.float32)
    jl = jdiff.make_rollout_loss(jp, jf, js0.xl + dxl, n_steps=10,
                                 k_att=k_att)
    tl = diff.make_rollout_loss(tp, tf, ts0.xl + torch.as_tensor(dxl),
                                n_steps=10, k_att=k_att)
    v, g = jax.jit(jax.value_and_grad(jl))(_jgains(), js0)
    tv, tg = diff.value_and_grad(tl, convert.gains(GAINS, "cpu"), ts0)
    _close(v, tv, rtol=VALUE_RTOL)
    _grads_close(g, tg)
    assert any(abs(float(x)) > 0 for x in tg.values())


def test_remat_matches_no_remat():
    """Checkpointing recomputes the same ops: value and gradients within
    ``tests/test_diff.py``'s bars (on one CPU they are bitwise)."""
    _, (tp, tf, ts0) = _problem()
    xl_ref = ts0.xl + torch.tensor([0.4, 0.0, 0.3])
    gains = convert.gains(GAINS, "cpu")
    out = [diff.value_and_grad(
        diff.make_rollout_loss(tp, tf, xl_ref, n_steps=8, remat=r, k_att=1.0),
        gains, ts0) for r in (True, False)]
    (v1, g1), (v2, g2) = out
    _close(v2, v1, rtol=1e-6)
    for k in g1:
        _close(g2[k], g1[k], rtol=1e-4, atol=1e-8)


def test_gradient_matches_finite_difference():
    """``tests/test_diff.py``'s check: central differences (eps 1e-3) of
    the port's loss against its autograd gradient, 10 steps, untilted."""
    _, (tp, tf, ts0) = _problem(tilt=0.0)
    loss = diff.make_rollout_loss(tp, tf, ts0.xl + torch.tensor(
        [0.4, 0.0, 0.3]), n_steps=10)
    gains = convert.gains(GAINS, "cpu")
    _, grad = diff.value_and_grad(loss, gains, ts0)
    eps = 1e-3
    with torch.no_grad():
        for k in gains:
            gp, gm = dict(gains), dict(gains)
            gp[k] = gains[k] + eps
            gm[k] = gains[k] - eps
            fd = (float(loss(gp, ts0)) - float(loss(gm, ts0))) / (2 * eps)
            np.testing.assert_allclose(float(grad[k]), fd, rtol=0.05,
                                       atol=1e-5)


def _recording(n_steps, seed=4):
    """numpy-seeded command sequence around the equilibrium forces."""
    (jp, jf, js0), port = _problem(tilt=0.1)
    f_seq = (np.asarray(jf)[None] + 0.3 * np.random.default_rng(seed).normal(
        size=(n_steps, 3, 3))).astype(np.float32)
    return (jp, jf, js0), port, f_seq


def test_simulate_commands_matches_jax():
    (jp, _, js0), (tp, _, ts0), f_seq = _recording(6)
    xl, vl = jax.jit(lambda s, f: jdiff.simulate_commands(
        jp, _jgains(), f, s))(js0, jnp.asarray(f_seq))
    for remat in (True, False):
        txl, tvl = diff.simulate_commands(
            tp, convert.gains(GAINS, "cpu"), torch.as_tensor(f_seq), ts0,
            remat=remat)
        assert txl.shape == (6, 3) and tvl.shape == (6, 3)
        _close(xl, txl, atol=1e-6)
        _close(vl, tvl, atol=1e-6)


def test_sysid_loss_and_grad_match_jax():
    """The sysid loss and its gradient in ``log_ml`` (6 recorded steps,
    observations from the JAX replay at the true mass), at a mass 30%
    heavy and 20% light."""
    (jp, _, js0), (tp, _, ts0), f_seq = _recording(6)
    xl, vl = jax.jit(lambda s, f: jdiff.simulate_commands(
        jp, _jgains(), f, s))(js0, jnp.asarray(f_seq))
    jl = jdiff.make_sysid_loss(jp.m, jp.J, jp.Jl, jp.r, _jgains(),
                               jnp.asarray(f_seq), xl, vl)
    tl = diff.make_sysid_loss(tp.m, tp.J, tp.Jl, tp.r,
                              convert.gains(GAINS, "cpu"),
                              torch.as_tensor(f_seq),
                              torch.as_tensor(np.array(xl)),
                              torch.as_tensor(np.array(vl)))
    for scale in (1.3, 0.8):
        theta = {"log_ml": np.float32(np.log(0.225 * scale))}
        v, g = jax.jit(jax.value_and_grad(jl))(_jgains(theta), js0)
        tv, tg = diff.value_and_grad(tl, convert.gains(theta, "cpu"), ts0)
        _close(v, tv, rtol=VALUE_RTOL)
        _grads_close(g, tg)
        assert float(tv) > 0 and abs(float(tg["log_ml"])) > 0


def test_trajopt_loss_and_grad_match_jax():
    """An 8-step numpy-seeded plan with the obstacle cylinder close enough
    that the hinge is active, value and gradient in every plan entry."""
    (jp, jf, js0), (tp, tf, ts0) = _problem(tilt=0.0)
    goal = np.asarray(js0.xl) + np.array([0.8, 0.0, 0.0], np.float32)
    obs = np.asarray(js0.xl)[:2] + np.array([0.05, 0.0], np.float32)
    plan = {"acc": (0.5 * np.random.default_rng(5).normal(
        size=(8, 3))).astype(np.float32)}
    kw = dict(n_steps=8, obstacle_radius=0.25, w_effort=1e-4)
    jl = jdiff.make_trajopt_loss(jp, jf, jnp.asarray(goal),
                                 obstacle_xy=jnp.asarray(obs), **kw)
    tl = diff.make_trajopt_loss(tp, tf, torch.as_tensor(goal),
                                obstacle_xy=torch.as_tensor(obs), **kw)
    v, g = jax.jit(jax.value_and_grad(jl))(_jgains(plan), js0)
    tv, tg = diff.value_and_grad(tl, convert.gains(plan, "cpu"), ts0)
    _close(v, tv, rtol=VALUE_RTOL)
    _grads_close(g, tg)
    # The hinge is active: the loss is above its obstacle-free value.
    free = diff.make_trajopt_loss(tp, tf, torch.as_tensor(goal), **kw)
    with torch.no_grad():
        assert float(tv) > float(free(convert.gains(plan, "cpu"), ts0))
    with pytest.raises(ValueError, match="plan horizon 7 != n_steps 8"):
        tl({"acc": torch.zeros(7, 3)}, ts0)


def test_gains_on_another_device_raise():
    """A gain tensor off the state's device is a ValueError, not a quiet
    host copy at each use."""
    _, (tp, tf, ts0) = _problem()
    gains = {"k_R": torch.zeros((), device="meta"),
             "k_Omega": torch.tensor(0.075)}
    with pytest.raises(ValueError, match="state's device"):
        diff.substep_rollout(tp, gains, ts0, tf)


def test_convert_gains():
    """``convert.gains``: numpy and JAX scalars and arrays -> float32
    tensors of the same shapes and values."""
    out = convert.gains({"a": np.float64(0.1), "b": jnp.arange(6.0).reshape(
        2, 3), "c": 2}, device="cpu")
    assert out["a"].shape == () and out["a"].dtype == torch.float32
    assert float(out["a"]) == float(np.float32(0.1))
    assert out["b"].shape == (2, 3) and out["b"][1, 2] == 5.0
    assert out["c"].dtype == torch.float32
