"""Congestion bucketing in the port (``harness/bucketing.py``) against the
JAX package's.

Tolerances, and why:

- ``pick_bucket`` and the congestion metric are integer results: equal.
  The metric counts trees within a radius of float32 distances that both
  packages compute as ``sqrt(dx^2 + dy^2)``; the seeded positions keep
  every distance well away from the radius.
- A bucketed step against the port's own unbucketed step: exactly equal,
  the JAX package's contract (tests/test_bucketing.py): the same solves
  on the same data, grouped and scattered back. On the CPU every op the
  step runs computes each scenario on its own, so the grouping cannot
  change a bit.
- The port's ``build(buckets=2)`` against ``bench.build(buckets=2)``:
  iteration counts equal, states within 1e-4 (the bar of
  tests/test_torch_rollout.py for the same workload unbucketed, and why).
"""

from typing import NamedTuple

import bench
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_aerial_transport.envs import forest as jforest
from tpu_aerial_transport.harness import bucketing as jbucketing
from tpu_aerial_transport_torch.envs import forest
from tpu_aerial_transport_torch.harness import bucketing, rollout, setup
from tpu_aerial_transport_torch.tree import leaves


@pytest.mark.parametrize("size, buckets, expected", [
    (8, (8, 16, 32), 8),  # an exact fit is chosen.
    (16, (8, 16, 32), 16),
    (5, (8, 16, 32), 8),  # the smallest admitting bucket.
    (9, (32, 16, 8), 16),  # order-free.
    (0, (8, 16), 8),
    (33, (8, 16, 32), None),  # no bucket admits it.
    (7, (8, 8, 16), 8),  # duplicate values resolve to that value.
    (-1, (8,), ValueError),
    (4, (), ValueError),
], ids=["exact_8", "exact_16", "smallest", "order_free", "zero", "none",
        "tie", "negative", "empty"])
def test_pick_bucket(size, buckets, expected):
    """``tests/test_bucketing.py``'s ``pick_bucket`` cases, each against
    the JAX package's answer too."""
    if expected is ValueError:
        for fn in (bucketing.pick_bucket, jbucketing.pick_bucket):
            with pytest.raises(ValueError):
                fn(size, buckets)
        return
    assert bucketing.pick_bucket(size, buckets) == expected
    assert jbucketing.pick_bucket(size, buckets) == expected


def _seeded_xl(B, seed):
    """Payload positions over the forest and the mountain (x in [0, 60] m,
    y in [-15, 15] m), where the tree counts within the radius vary."""
    rng = np.random.default_rng(seed)
    xl = np.stack([rng.uniform(0.0, 60.0, B), rng.uniform(-15.0, 15.0, B),
                   np.full(B, 2.0)], axis=-1)
    return xl.astype(np.float32)


class _Payload(NamedTuple):
    """The one state leaf the JAX metric reads, as a JAX pytree."""
    xl: jax.Array


def test_congestion_metric_matches_jax():
    """The metric on 64 seeded scenarios at the JAX bench's radius
    (collision radius + 5 m): equal counts, and some ties and some spread
    among them, so the stable sort matters."""
    xl = _seeded_xl(64, seed=3)
    _, col, state0 = setup.rqp_setup(4, device="cpu")
    radius = col.collision_radius + rollout.BUCKET_METRIC_MARGIN
    ref = np.asarray(jax.jit(jax.vmap(jbucketing.env_congestion_metric(
        jforest.make_forest(seed=0), radius)))(_Payload(jnp.asarray(xl))))
    states = rollout.stack_scenarios(state0, 64).replace(
        xl=torch.as_tensor(xl))
    got = bucketing.env_congestion_metric(
        forest.make_forest(seed=0, device="cpu"), radius)(states)
    assert got.tolist() == ref.tolist()
    assert len(set(ref.tolist())) > 2 and len(set(ref.tolist())) < 64
    order = torch.argsort(got, stable=True)
    assert order.tolist() == np.asarray(jnp.argsort(ref)).tolist()


def _spread_batch(state0, B):
    """``B`` scenarios at varying distances from the forest (the JAX
    contract test's batch: ``N(0, 3^2) + (5, 0, 2)`` from
    ``default_rng(1)``), so the buckets see different congestion."""
    xs = (np.random.default_rng(1).normal(size=(B, 3)) * 3.0
          + np.array([5.0, 0.0, 2.0]))
    return rollout.scenario_batch(state0, B).replace(
        xl=torch.as_tensor(xs, dtype=torch.float32))


@pytest.mark.parametrize("n_buckets", [2, 4])
def test_bucketed_step_equals_unbucketed(n_buckets):
    """C-ADMM at n = 4 over 8 scenarios, two MPC steps: the bucketed step
    gives exactly the unbucketed step's states, controller state and
    statistics per scenario, and its iteration counts do differ between
    scenarios (or the grouping would be untested)."""
    S = 8
    kw = dict(max_iter=6, inner_iters=10, device="cpu")
    step, cs0, st0 = rollout.make_mpc_step("cadmm", 4, **kw)
    bstep, _, _ = rollout.make_mpc_step("cadmm", 4, buckets=n_buckets, **kw)
    states = _spread_batch(st0, S)
    css = rollout.stack_scenarios(cs0, S)
    ref, got = (css, states), (css, states)
    for _ in range(2):
        ref_out = step(*ref)
        got_out = bstep(*got)
        for a, b in zip(leaves(ref_out), leaves(got_out)):
            # Bitwise, NaN padding of the residual sequence included.
            torch.testing.assert_close(b, a, rtol=0, atol=0, equal_nan=True)
        ref, got = ref_out[:2], got_out[:2]
    assert len(set(ref_out[2].iters.tolist())) > 1


def test_bucketed_step_refuses_a_ragged_batch():
    """``B % n_buckets != 0`` raises the JAX package's error message."""
    step, cs0, st0 = rollout.make_mpc_step("cadmm", 4, buckets=4,
                                           device="cpu")
    with pytest.raises(ValueError) as got:
        step(rollout.stack_scenarios(cs0, 6), rollout.stack_scenarios(st0, 6))
    jstep = jbucketing.bucketed_step(lambda c, s: (c, s, None),
                                     lambda s: jnp.sum(s.xl), n_buckets=4)
    jstates = _Payload(jnp.zeros((6, 3), jnp.float32))
    with pytest.raises(ValueError) as ref:
        jstep(jstates, jstates)
    assert str(got.value) == str(ref.value)


def test_bucketed_build_matches_bench_build():
    """``rollout.build(buckets=2)`` against ``bench.build(buckets=2)``: C-ADMM
    at n = 8, 4 scenarios, 2 MPC steps."""
    S, steps = 4, 2
    jrun, jcss, jstates = bench.build("cadmm", n=8, n_scenarios=S, buckets=2)
    jcss, jstates, jiters = jrun(jcss, jstates, n_steps=steps)
    run, css, states = rollout.build(n=8, n_scenarios=S, device="cpu",
                                     buckets=2)
    css, states, iters = run(css, states, steps)
    np.testing.assert_array_equal(iters.numpy(), np.asarray(jiters))
    for f in ("xl", "vl", "Rl", "wl", "R", "w"):
        np.testing.assert_allclose(getattr(states, f).numpy(),
                                   np.asarray(getattr(jstates, f)), atol=1e-4,
                                   rtol=0, err_msg=f)
