"""PyTorch port vs the JAX package: ``harness/diff.py tune_gains`` (SGD
with the ``min_gain`` projection, Adam against ``optax.adam``, the
best-iterate selection), a system-identification descent, and the port's
``examples/grad_tuning.py``.

Tolerances, and why:

- Descent histories and best iterates against the JAX package's: rtol
  1e-4 (each value and gradient carries the loss's float32 rounding, about
  2e-7 relative; three iterations move the iterate by it). Adam is written
  out in optax's order (moments, bias corrections, ``m / (sqrt(v) +
  eps)``), which holds optax's updates to an ulp where
  ``torch.optim.Adam``'s order is 1e-2 relative away at the first step.
- The quadratic toy loss of the best-iterate test: the same bar.
- The system-identification descent: the recovered mass within 2% of the
  truth (``tests/test_diff.py``'s bar).
- The example's tilt axes against ``jax.random.normal``: 1e-6.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_diff import GAINS, _jgains, _problem

from tpu_aerial_transport.harness import diff as jdiff
from tpu_aerial_transport_torch import convert
from tpu_aerial_transport_torch.examples import grad_tuning
from tpu_aerial_transport_torch.harness import diff

RTOL = 1e-4
DETUNED = {"k_R": np.float32(0.02), "k_Omega": np.float32(0.2)}


def _same_descent(ref, out):
    (jbest, jhist), (tbest, thist) = ref, out
    assert thist.shape == (len(jhist),)
    np.testing.assert_allclose(thist.numpy(), np.asarray(jhist), rtol=RTOL)
    assert set(jbest) == set(tbest)
    for k in jbest:
        np.testing.assert_allclose(tbest[k].numpy(), np.asarray(jbest[k]),
                                   rtol=RTOL, atol=1e-7)


def _rollout_losses(n_steps=6):
    (jp, jf, js0), (tp, tf, ts0) = _problem()
    dxl = np.array([0.4, 0.0, 0.3], np.float32)
    jl = jdiff.make_rollout_loss(jp, jf, js0.xl + dxl, n_steps=n_steps,
                                 k_att=1.0)
    tl = diff.make_rollout_loss(tp, tf, ts0.xl + torch.as_tensor(dxl),
                                n_steps=n_steps, k_att=1.0)
    return (jl, js0), (tl, ts0)


@pytest.mark.parametrize("min_gain", [1e-4, 0.1])
def test_sgd_matches_jax(min_gain):
    """3 projected-SGD iterations from the detuned gains (through
    ``Descent``, the body of ``tune_gains``); at ``min_gain`` 0.1 the
    projection lifts k_R from 0.02 at the first step."""
    (jl, js0), (tl, ts0) = _rollout_losses()
    ref = jdiff.tune_gains(jl, _jgains(DETUNED), js0, lr=0.05, iters=3,
                           min_gain=min_gain)
    d = diff.Descent(tl, convert.gains(DETUNED, "cpu"), ts0, lr=0.05,
                     min_gain=min_gain)
    _same_descent(ref, d.run(3))
    # The buffers hold the last (discarded) update: projected too.
    assert all(float(g.detach()) >= min_gain for g in d.gains.values())


def test_adam_matches_optax():
    """3 Adam iterations on a 6-step trajectory-optimisation plan (every
    plan entry a parameter, no floor) against ``optax.adam`` in the JAX
    package's ``tune_gains``."""
    (jp, jf, js0), (tp, tf, ts0) = _problem(tilt=0.0)
    goal = np.asarray(js0.xl) + np.array([0.8, 0.0, 0.0], np.float32)
    obs = np.asarray(js0.xl)[:2] + np.array([0.4, 0.0], np.float32)
    kw = dict(n_steps=6, obstacle_radius=0.25, w_effort=1e-4)
    jl = jdiff.make_trajopt_loss(jp, jf, jnp.asarray(goal),
                                 obstacle_xy=jnp.asarray(obs), **kw)
    tl = diff.make_trajopt_loss(tp, tf, torch.as_tensor(goal),
                                obstacle_xy=torch.as_tensor(obs), **kw)
    plan0 = {"acc": (0.2 * np.random.default_rng(6).normal(
        size=(6, 3))).astype(np.float32)}
    ref = jdiff.tune_gains(jl, _jgains(plan0), js0, lr=0.5, iters=3,
                           min_gain=None, optimizer="adam")
    out = diff.tune_gains(tl, convert.gains(plan0, "cpu"), ts0, lr=0.5,
                          iters=3, min_gain=None, optimizer="adam")
    _same_descent(ref, out)
    assert float(out[1][-1]) < float(out[1][0])


@pytest.mark.parametrize("lr,best_at", [(0.11, "start"), (0.04, "final")])
def test_best_iterate_selection(lr, best_at):
    """A quadratic ``10 (x - 1)^2``: SGD at lr 0.11 overshoots and grows
    (each step multiplies the error by -1.2), so the best iterate is the
    start; at 0.04 it contracts (x 0.2), so it is the final iterate, which
    only the comparison after the loop can pick. Both against the JAX
    package's ``tune_gains``."""
    _, (_, _, ts0) = _problem()
    jstate = _problem()[0][2]

    def jloss(g, s):
        return 10.0 * (g["x"] - 1.0) ** 2 + 0.0 * jnp.sum(s.xl)

    def tloss(g, s):
        return 10.0 * (g["x"] - 1.0) ** 2 + 0.0 * torch.sum(s.xl)

    x0 = {"x": np.float32(0.0)}
    ref = jdiff.tune_gains(jloss, _jgains(x0), jstate, lr=lr, iters=4,
                           min_gain=None)
    out = diff.tune_gains(tloss, convert.gains(x0, "cpu"), ts0, lr=lr,
                          iters=4, min_gain=None)
    _same_descent(ref, out)
    best, hist = out
    if best_at == "start":
        assert float(best["x"]) == 0.0 and bool(torch.all(hist[1:] > hist[0]))
    else:
        assert float(hist[-1]) == float(hist.min()) and float(best["x"]) > 0.99


def test_unknown_optimizer_raises():
    _, (tl, ts0) = _rollout_losses(1)
    with pytest.raises(ValueError, match="lbfgs"):
        diff.tune_gains(tl, convert.gains(GAINS, "cpu"), ts0,
                        optimizer="lbfgs")
    with pytest.raises(ValueError, match="lbfgs"):
        diff.Descent(tl, convert.gains(GAINS, "cpu"), ts0, optimizer="lbfgs")
    with pytest.raises(ValueError, match="not on the card"):
        diff.Descent(tl, convert.gains(GAINS, "cpu"), ts0).capture()


def test_eager_run_is_repeatable():
    """``Descent.run`` starts from the same buffers each time: two runs
    (and ``graph=False``, which on the CPU is the same call) are bitwise
    equal."""
    _, (tl, ts0) = _rollout_losses(2)
    d = diff.Descent(tl, convert.gains(DETUNED, "cpu"), ts0, lr=0.05)
    before = dict(diff.GRAPH_COUNTS)
    a, b = d.run(2), d.run(2)
    c = diff.tune_gains(tl, convert.gains(DETUNED, "cpu"), ts0, lr=0.05,
                        iters=2, graph=False)
    for x in (b, c):
        assert torch.equal(a[1], x[1])
        assert all(torch.equal(a[0][k], x[0][k]) for k in a[0])
    assert diff.GRAPH_COUNTS == before and d.graph is None


def test_sysid_recovers_payload_mass():
    """``tests/test_diff.py``'s identification on the port alone, at a depth
    that runs here in seconds: record 8 closed-loop steps at the true mass,
    start 40% heavy, lr from the curvature measured in this run (0.1 /
    c, a contraction of about 0.8 an iteration), 16 iterations."""
    from tpu_aerial_transport_torch.control import centralized
    from tpu_aerial_transport_torch.harness import setup

    params, _, state0 = setup.rqp_setup(3, device="cpu")
    f_eq = centralized.equilibrium_forces(params)
    xl_ref = state0.xl + torch.tensor([0.5, 0.2, 0.3])
    gains = convert.gains(GAINS, "cpu")
    s, rec = state0, []
    with torch.no_grad():
        for _ in range(8):
            f = diff.payload_pd_forces(params, f_eq, s, xl_ref)
            s = diff.substep_rollout(params, gains, s, f)
            rec.append((f, s.xl, s.vl))
    f_seq, xl_obs, vl_obs = (torch.stack(x) for x in zip(*rec))
    loss = diff.make_sysid_loss(params.m, params.J, params.Jl, params.r,
                                gains, f_seq, xl_obs, vl_obs)
    true_ml = float(params.ml)
    theta0 = {"log_ml": torch.tensor(math.log(true_ml * 1.4))}
    with torch.no_grad():
        at_truth = float(loss({"log_ml": torch.log(params.ml)}, state0))
        at_start = float(loss(theta0, state0))
    assert at_truth < 1e-8 and at_start > 100 * max(at_truth, 1e-12)
    lr = 0.1 / (at_start / math.log(1.4) ** 2)
    theta, hist = diff.tune_gains(loss, theta0, state0, lr=lr, iters=16,
                                  min_gain=None)
    assert bool(torch.isfinite(hist).all()) and hist[-1] < hist[0]
    est = float(torch.exp(theta["log_ml"]))
    assert abs(est - true_ml) / true_ml < 0.02, (est, true_ml)


def test_grad_tuning_example(capsys):
    """The port's example at a small depth on the CPU: its tilt axes are
    ``0.3 jax.random.normal(PRNGKey(0), (n, 3))``, it prints the JAX
    example's lines, and the descent does not end above its start."""
    ref = np.asarray(0.3 * jax.random.normal(jax.random.PRNGKey(0), (3, 3)))
    np.testing.assert_allclose(grad_tuning.tilt_axes(3, "cpu").numpy(), ref,
                               atol=1e-6)
    out = grad_tuning.main(["--device", "cpu", "--steps", "4", "--iters",
                            "2"])
    text = capsys.readouterr().out
    for line in ("loss @ detuned", "loss @ reference", "tuned gains (best "
                 "iterate)", "loss history:", "loss @ tuned gains"):
        assert line in text
    assert len(out["hist"]) == 3 and out["tuned"] <= out["hist"][0]
    assert all(v > 0 for v in out["gains"].values())
