"""PyTorch port vs the JAX package: the resilient rollout
(``resilience.rollout``) with its fallback ladder and NaN quarantine, over
a batch of per-scenario fault schedules, against
``jax.jit(jax.vmap(resilient_rollout))`` over the same stacked schedules;
the quarantine helpers (``tests/test_quarantine.py``'s counterparts); the
nominal branch bitwise the harness rollout; and a run resumed from its
carry bitwise the uninterrupted one.

Set-up: n = 4, ``max_iter=6``, C-ADMM with ``inner_iters=15`` over 10 HL
steps, DD with 40 over 4; no forest, the hover reference. Each JAX batch
compiles once.

Tolerances, and why: fallback rungs, quarantine flags and consensus
iteration counts are discrete and must be equal. States and applied forces
agree to 1e-4 (the bar of ``tests/test_torch_rollout.py``: forces agree to
~1e-6 N a step, integrated over the substeps; the noisy scenario's sensor
noise agrees to 2e-6, ``tests/test_torch_faults.py``); DD's forces to its
2e-3 N step bar (``tests/test_torch_dd.py``). With an agent lost, n = 4 DD
runs into its iteration cap every step in both packages, and an
unconverged final iterate carries the frameworks' ~1e-4-relative KKT
inverse differences (``tests/test_torch_dd.py``) from step to step: after
4 steps forces differ by < 1e-3 N and states by < 1e-5, after 8 the forces
by ~7e-3 N, so DD's run is 4 steps long.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_aerial_transport.control import cadmm as jcadmm
from tpu_aerial_transport.control import dd as jdd
from tpu_aerial_transport.control import lowlevel as jlowlevel
from tpu_aerial_transport.harness import setup as jsetup
from tpu_aerial_transport.resilience import faults as jfaults
from tpu_aerial_transport.resilience import rollout as jres
from tpu_aerial_transport_torch import convert
from tpu_aerial_transport_torch.control import cadmm, dd, lowlevel
from tpu_aerial_transport_torch.envs import forest
from tpu_aerial_transport_torch.harness import bucketing, rollout, setup
from tpu_aerial_transport_torch.resilience import (
    faults,
    make_cadmm_hl_step,
    make_dd_hl_step,
    prng,
    resilient_rollout,
)
from tpu_aerial_transport_torch.resilience import rollout as tres
from tpu_aerial_transport_torch.resilience.quarantine import (
    tree_all_finite,
    tree_where,
)
from tpu_aerial_transport_torch.tree import leaves
from tpu_aerial_transport_torch.utils import stats as stats_mod

N = 4
STEPS = {"cadmm": 10, "dd": 4}
CFG = {"cadmm": dict(max_iter=6, inner_iters=15),
       "dd": dict(max_iter=6, inner_iters=40)}
STATE_KEYS = ("xl", "vl", "Rl", "wl", "R", "w")
# The scenarios of the C-ADMM batch, one schedule each (the JAX package
# stacks schedules whose static fields agree, so every one is noisy).
SCENARIOS = {
    "agent_loss": dict(t_fail={0: 3}),
    "dropout": dict(drop_rate=0.3, drop_hold=2),
    "degradation_noise": dict(t_degrade={2: 2}, thrust_scale=0.6,
                              noise_std=0.01),
    "blackout": dict(drop_rate=1.0),
}


def _bits_equal(a, b):
    """Bit for bit, NaNs included."""
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return torch.equal(a, b)


def _scheds(specs, seed0=0):
    """Matching JAX and port schedules (noisy, so they stack), stacked."""
    js, ts = [], []
    for i, spec in enumerate(specs):
        js.append(jfaults.make_schedule(
            N, key=jax.random.PRNGKey(seed0 + i), **spec).replace(noisy=True))
        ts.append(convert.fault_schedule(
            jax.tree.map(np.asarray, js[-1]), device="cpu"))
    return (jax.tree.map(lambda *xs: jnp.stack(xs), *js),
            faults.stack_schedules(ts))


def _jax_run(ctrl, jsched, n_steps):
    jp, jcol, js = jsetup.rqp_setup(N)
    mod = jcadmm if ctrl == "cadmm" else jdd
    cfg = mod.make_config(jp, jcol.collision_radius, jcol.max_deceleration,
                          socp_fused="scan", pad_operators=True, **CFG[ctrl])
    if ctrl == "cadmm":
        hl, cs0 = jres.make_cadmm_hl_step(jp, cfg), jcadmm.init_cadmm_state(
            jp, cfg)
    else:
        hl, cs0 = jres.make_dd_hl_step(jp, cfg), jdd.init_dd_state(jp, cfg)
    ll = jlowlevel.make_lowlevel_controller("pd", jp)
    return jax.jit(jax.vmap(lambda f: jres.resilient_rollout(
        hl, ll.control, jp, js, cs0, n_hl_steps=n_steps, faults=f)))(jsched)


def _port_bits(ctrl):
    tp, tcol, ts = setup.rqp_setup(N, device="cpu")
    mod = cadmm if ctrl == "cadmm" else dd
    cfg = mod.make_config(tp, tcol.collision_radius, tcol.max_deceleration,
                          pad_operators=True, device="cpu", **CFG[ctrl])
    if ctrl == "cadmm":
        hl, cs0 = make_cadmm_hl_step(tp, cfg), cadmm.init_cadmm_state(tp,
                                                                      cfg)
    else:
        hl, cs0 = make_dd_hl_step(tp, cfg), dd.init_dd_state(tp, cfg)
    ll = lowlevel.make_lowlevel_controller("pd", tp)
    return tp, ts, cs0, hl, ll


def _port_run(ctrl, tsched, S, n_steps, **kw):
    tp, ts, cs0, hl, ll = _port_bits(ctrl)
    return resilient_rollout(
        hl, ll.control, tp, rollout.stack_scenarios(ts, S),
        rollout.stack_scenarios(cs0, S), n_steps, faults=tsched, **kw)


@functools.lru_cache(maxsize=None)
def _cadmm_batch():
    jsched, tsched = _scheds(list(SCENARIOS.values()))
    ref = _jax_run("cadmm", jsched, STEPS["cadmm"])
    out = _port_run("cadmm", tsched, len(SCENARIOS), STEPS["cadmm"])
    return ref, out


def _assert_lane(ref, out, s, state_bar, force_bar):
    """Scenario ``s`` of the port's ``(T, S, ...)`` logs against lane ``s``
    of the JAX package's ``(S, T, ...)`` logs."""
    (_, _, jlogs), (_, _, logs) = ref, out
    for k in ("fallback_rung", "quarantined", "iters", "collision"):
        np.testing.assert_array_equal(
            getattr(logs, k)[:, s].numpy(), np.asarray(getattr(jlogs, k))[s],
            err_msg=k)
    for k in STATE_KEYS:
        np.testing.assert_allclose(
            getattr(logs, k)[:, s].numpy(), np.asarray(getattr(jlogs, k))[s],
            atol=state_bar, rtol=0, err_msg=k)
    np.testing.assert_allclose(logs.f_des[:, s].numpy(),
                               np.asarray(jlogs.f_des)[s], atol=force_bar,
                               rtol=0)


@pytest.mark.parametrize("case", list(SCENARIOS))
def test_resilient_cadmm_matches_vmapped_jax(case):
    """One scenario of the batched C-ADMM run against its lane of the
    vmapped JAX run: rungs, flags and iteration counts equal, states and
    forces within 1e-4."""
    ref, out = _cadmm_batch()
    s = list(SCENARIOS).index(case)
    _assert_lane(ref, out, s, 1e-4, 1e-4)
    logs = out[2]
    rung = logs.fallback_rung[:, s]
    if case == "agent_loss":
        assert torch.all(logs.f_des[3:, s, 0] == 0.0)
        assert torch.all(logs.f_des[3:, s, 1:, 2] > 0.0)
    elif case == "blackout":
        # No alive agent delivers: every step is a degraded one.
        assert torch.all(rung == tres.RUNG_RETRY)
    assert torch.all(rung <= tres.RUNG_RETRY)
    assert not logs.quarantined.any()
    assert torch.isfinite(logs.xl).all()


def test_resilient_dd_agent_loss_matches_vmapped_jax():
    """DD with agent 0 lost at step 1 in one scenario and agent 3 at step
    0 in the other, against the vmapped JAX run (states 1e-4, forces DD's
    2e-3 N)."""
    jsched, tsched = _scheds([dict(t_fail={0: 1}), dict(t_fail={3: 0})], 5)
    ref = _jax_run("dd", jsched, STEPS["dd"])
    out = _port_run("dd", tsched, 2, STEPS["dd"])
    for s in range(2):
        _assert_lane(ref, out, s, 1e-4, 2e-3)
    assert torch.all(out[2].f_des[1:, 0, 0] == 0.0)
    assert torch.all(out[2].f_des[:, 1, 3] == 0.0)


@functools.lru_cache(maxsize=None)
def _nan_lane_runs():
    """The port counterpart of ``tests/test_quarantine.py:81-112``: a
    3-scenario batch whose scenario 1's actuator gain is +inf from step 5,
    and the same batch with scenario 1 benign."""
    tp, _, ts, = setup.rqp_setup(N, device="cpu")
    benign = [faults.make_schedule(N, key=prng.prng_key(k),
                                   device="cpu") for k in range(3)]
    killer = faults.make_schedule(N, t_degrade={0: 5},
                                  thrust_scale=float("inf"),
                                  key=prng.prng_key(1), device="cpu")
    bad = _port_run("cadmm", faults.stack_schedules(
        [benign[0], killer, benign[2]]), 3, 12)
    good = _port_run("cadmm", faults.stack_schedules(benign), 3, 12)
    return bad, good


def test_nan_lane_is_quarantined_and_others_bitwise():
    """Scenario 1 freezes with its sticky flag raised; scenarios 0 and 2
    are bitwise the benign batch's in every logged leaf."""
    (_, _, bad), (_, _, good) = _nan_lane_runs()
    q = bad.quarantined[:, 1]
    assert q.any() and not bad.quarantined[:, [0, 2]].any()
    q_from = int(torch.nonzero(q)[0])
    assert torch.all(q[q_from:])
    frozen = bad.xl[q_from:, 1]
    assert torch.equal(frozen, frozen[:1].expand_as(frozen))
    for name in ("xl", "vl", "Rl", "wl", "R", "w", "f_des", "x_err", "v_err",
                 "iters", "solve_res", "fallback_rung"):
        assert torch.equal(getattr(bad, name)[:, [0, 2]],
                           getattr(good, name)[:, [0, 2]]), name
    # Masked aggregates over the final tracking error exclude the lane.
    valid = ~bad.quarantined[-1]
    agg = stats_mod.compute_aggregate_statistics(bad.x_err[-1], 0, valid)
    assert all(bool(torch.isfinite(v)) for v in agg)


def test_quarantine_helpers():
    """``tree_all_finite`` per scenario (integer leaves ignored) and
    ``tree_where`` per scenario."""
    good = (torch.ones(2, 3), torch.zeros(2, dtype=torch.int32))
    bad = (torch.tensor([[1.0, float("nan"), 0.0], [1.0, 2.0, 3.0]]),
           torch.ones(2, dtype=torch.int32))
    assert tree_all_finite(good).tolist() == [True, True]
    assert tree_all_finite(bad).tolist() == [False, True]
    sel = tree_where(torch.tensor([False, True]), bad, good)
    assert tree_all_finite(sel).tolist() == [True, True]
    assert sel[1].tolist() == [0, 1]


def test_masked_aggregate_statistics():
    """``compute_aggregate_statistics(valid=)`` (the JAX test's values)
    and the unmasked path, against the JAX package's function."""
    from tpu_aerial_transport.utils import stats as jstats

    a = np.array([[1.0, 2.0], [np.nan, np.inf], [3.0, 4.0]], np.float32)
    valid = np.array([True, False, True])
    for v in (valid, np.zeros(3, bool), None):
        ref = jstats.compute_aggregate_statistics(
            jnp.asarray(a), 0, None if v is None else jnp.asarray(v))
        out = stats_mod.compute_aggregate_statistics(
            torch.as_tensor(a), 0, None if v is None else torch.as_tensor(v))
        for r, o in zip(ref, out):
            np.testing.assert_allclose(o.numpy(), np.asarray(r), rtol=1e-6,
                                       equal_nan=True)
    mn, mx, avg, std = stats_mod.compute_aggregate_statistics(
        torch.as_tensor(a), 0, torch.as_tensor(valid))
    assert mn.tolist() == [1.0, 2.0] and mx.tolist() == [3.0, 4.0]
    assert avg.tolist() == [2.0, 3.0] and std.tolist() == [1.0, 1.0]


def test_quarantine_guarded_metric():
    """A scenario with a non-finite state leaf maps to -1; the others keep
    the congestion metric."""
    world = forest.make_forest(seed=0, device="cpu")
    _, _, state = setup.rqp_setup(3, device="cpu")
    states = rollout.stack_scenarios(state, 2)
    states = states.replace(xl=torch.tensor([[5.0, 0.0, 1.5],
                                             [float("nan"), 0.0, 1.5]]))
    plain = bucketing.env_congestion_metric(world, vision_radius=8.0)
    metric = bucketing.quarantine_guarded_metric(plain)
    m = metric(states)
    assert int(m[0]) == int(plain(states)[0]) >= 0
    assert int(m[1]) == -1


def test_nominal_branch_is_the_harness_rollout_bitwise():
    """``faults=None`` and ``faults=no_faults(n)`` give every state leaf and
    force bitwise equal to each other and to ``harness.rollout.rollout``
    with the same step; rungs 0, nothing quarantined."""
    S, T = 2, 4
    tp, ts, cs0, hl, ll = _port_bits("cadmm")
    states = rollout.scenario_batch(ts, S)
    css = rollout.stack_scenarios(cs0, S)
    base = rollout.rollout(lambda c, s, a: hl(c, s, a), ll.control, tp,
                           states, css, T)
    runs = [resilient_rollout(hl, ll.control, tp, states, css, T, faults=f)
            for f in (None, faults.no_faults(N, device="cpu"))]
    for _, _, logs in runs:
        for k in STATE_KEYS + ("f_des", "iters", "solve_res"):
            assert torch.equal(getattr(logs, k), getattr(base[2], k)), k
        assert not logs.fallback_rung.any() and not logs.quarantined.any()
    assert runs[0][1].held is None


def test_resume_from_the_carry_is_the_uninterrupted_run_bitwise():
    """A run split at step 3 (``return_carry=True``, then ``carry0=`` with
    ``step_offset=3``) gives the uninterrupted run's logs bit for bit:
    the fault draws and the sensor noise read the global step, and the
    carry holds the hold force, the sticky flag and the accumulator."""
    from tpu_aerial_transport_torch.obs import telemetry

    tp, ts, cs0, hl, ll = _port_bits("cadmm")
    S, T, cut = 2, 6, 3
    sched = faults.stack_schedules([
        faults.make_schedule(N, drop_rate=0.5, noise_std=0.01,
                             key=prng.prng_key(3), device="cpu"),
        faults.make_schedule(N, t_fail={1: 2}, t_degrade={0: 4},
                             thrust_scale=float("inf"),
                             key=prng.prng_key(4), device="cpu")])
    states = rollout.stack_scenarios(ts, S)
    css = rollout.stack_scenarios(cs0, S)
    acc = rollout.hover_acc_des(states)
    tcfg = telemetry.TelemetryConfig()
    whole = resilient_rollout(hl, ll.control, tp, states, css, T,
                              acc_des_fn=acc, faults=sched, telemetry=tcfg,
                              return_carry=True)
    first = resilient_rollout(hl, ll.control, tp, states, css, cut,
                              acc_des_fn=acc, faults=sched, telemetry=tcfg,
                              return_carry=True)
    second = resilient_rollout(hl, ll.control, tp, None, None, T - cut,
                               acc_des_fn=acc, faults=sched, telemetry=tcfg,
                               carry0=first[0], step_offset=cut,
                               return_carry=True)
    joined = type(whole[1])(**{
        k: torch.cat([getattr(first[1], k), getattr(second[1], k)])
        for k in vars(whole[1])})
    for k in vars(whole[1]):
        assert _bits_equal(getattr(whole[1], k), getattr(joined, k)), k
    whole_carry, second_carry = leaves(whole[0]), leaves(second[0])
    assert len(whole_carry) == len(second_carry)
    for a, b in zip(whole_carry, second_carry):
        assert _bits_equal(a, b)
    assert whole[1].quarantined[:, 1].any()
    with pytest.raises(ValueError, match="acc_des_fn"):
        resilient_rollout(hl, ll.control, tp, None, None, 1, faults=sched,
                          carry0=first[0])
