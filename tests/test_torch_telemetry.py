"""PyTorch port vs the JAX package: the run-health telemetry
(``obs.telemetry``) -- the in-loop fold over a seeded stream of solver
stats, the P² percentile estimator against ``np.percentile``
(``tests/test_telemetry.py:77-110``), the accumulators of the harness
rollout and of the resilient rollout, and the host readers.

Tolerances, and why: counts and histograms are integers and must be equal.
The float leaves (running min/max, the P² markers, the residual sum)
repeat the JAX package's float32 operations in its order and agree within
1e-6 relative; over a rollout they read residuals that themselves agree to
the controllers' bars (C-ADMM 1e-4 N, ``tests/test_torch_cadmm.py``), so
there the floats are held to 1e-4 absolute. ``summary`` of one accumulator is a
function of its leaves: the dicts must be equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from tpu_aerial_transport.control import cadmm as jcadmm
from tpu_aerial_transport.control import centralized as jcentral
from tpu_aerial_transport.control import lowlevel as jlowlevel
from tpu_aerial_transport.control.types import SolverStats as JStats
from tpu_aerial_transport.harness import rollout as jrollout
from tpu_aerial_transport.harness import setup as jsetup
from tpu_aerial_transport.obs import telemetry as jtel
from tpu_aerial_transport.resilience import faults as jfaults
from tpu_aerial_transport.resilience import rollout as jres
from tpu_aerial_transport_torch import convert
from tpu_aerial_transport_torch.control import cadmm, centralized, lowlevel
from tpu_aerial_transport_torch.control.types import SolverStats
from tpu_aerial_transport_torch.harness import rollout, setup
from tpu_aerial_transport_torch.obs import telemetry as tel_mod
from tpu_aerial_transport_torch.resilience import (
    make_cadmm_hl_step,
    resilient_rollout,
)

N = 4
INT = tel_mod.INT_FIELDS


def _stream(S, T, n, seed=0):
    """A seeded ``(T, S)`` stream of per-step solver stats: lognormal
    residuals with a few non-finite ones, iteration counts across the
    buckets (one negative: no consensus loop), rungs, flags, margins, and
    per-agent residuals and inner iterations."""
    rng = np.random.default_rng(seed)
    res = rng.lognormal(-4.0, 1.5, (T, S)).astype(np.float32)
    res[rng.random((T, S)) < 0.05] = np.inf
    res[rng.random((T, S)) < 0.03] = np.nan
    iters = rng.integers(0, 3000, (T, S)).astype(np.int32)
    iters[0, 0] = -1
    agent = rng.lognormal(-6.0, 2.0, (T, S, n)).astype(np.float32)
    agent[rng.random((T, S, n)) < 0.02] = np.nan
    return dict(
        iters=iters, solve_res=res,
        collision=rng.random((T, S)) < 0.2,
        min_env_dist=rng.uniform(0.1, 9.0, (T, S)).astype(np.float32),
        ok_frac=rng.choice([1.0, 0.75, 0.5], (T, S)).astype(np.float32),
        fallback_rung=rng.integers(0, 4, (T, S)).astype(np.int32),
        agent_solve_res=agent,
        inner_iters=rng.integers(0, 20000, (T, S)).astype(np.int32),
        quarantined=rng.random((T, S)) < 0.1,
    )


def _jax_fold(cfg, stream, n, inner):
    """The JAX package's update over the stream, one lane per scenario."""
    S = stream["iters"].shape[1]

    def one_lane(lane):
        def step(tel, x):
            st = JStats(
                iters=x["iters"], solve_res=x["solve_res"],
                collision=x["collision"], min_env_dist=x["min_env_dist"],
                err_seq=jnp.zeros((1,)), ok_frac=x["ok_frac"],
                fallback_rung=x["fallback_rung"],
                agent_solve_res=x["agent_solve_res"],
                **({"inner_iters": x["inner_iters"]} if inner else {}))
            return jtel.update(cfg, tel, st, x["quarantined"]), None

        return lax.scan(step, jtel.init_telemetry(cfg, n), lane)[0]

    lanes = {k: jnp.swapaxes(jnp.asarray(v), 0, 1) for k, v in stream.items()}
    return jax.jit(jax.vmap(one_lane))(lanes) if S else None


def _port_fold(cfg, stream, n, inner):
    S = stream["iters"].shape[1]
    tel = tel_mod.init_telemetry(cfg, n, device="cpu", batch=(S,))
    for t in range(stream["iters"].shape[0]):
        x = {k: torch.as_tensor(v[t]) for k, v in stream.items()}
        st = SolverStats(
            iters=x["iters"], solve_res=x["solve_res"],
            collision=x["collision"], min_env_dist=x["min_env_dist"],
            err_seq=torch.zeros((S, 1)), ok_frac=x["ok_frac"],
            fallback_rung=x["fallback_rung"],
            agent_solve_res=x["agent_solve_res"],
            **({"inner_iters": x["inner_iters"]} if inner else {}))
        tel = tel_mod.update(cfg, tel, st, x["quarantined"])
    return tel


def _assert_tel(out, ref, rtol=0.0, atol=0.0):
    for k in tel_mod.LEAF_FIELDS:
        a, b = getattr(out, k).numpy(), np.asarray(getattr(ref, k))
        if k in INT:
            np.testing.assert_array_equal(a, b, err_msg=k)
        else:
            np.testing.assert_allclose(a, b, rtol=rtol, atol=atol, err_msg=k)
    assert out.quantiles == tuple(ref.quantiles)
    assert out.n_agents == ref.n_agents


@pytest.mark.parametrize("case", ["default", "quantiles", "agents_inner"])
def test_update_over_a_seeded_stream_matches_jax(case):
    """The fold over 60 steps of 3 scenarios equals the JAX package's
    vmapped scan: counts exactly, floats within 1e-6 relative; non-finite
    residuals stay out of the residual stream, as in the JAX package."""
    kw = {"default": {}, "quantiles": dict(quantiles=(0.25, 0.75, 0.95)),
          "agents_inner": dict(track_agents=True)}[case]
    inner = case == "agents_inner"
    stream = _stream(3, 60, N, seed=len(case))
    ref = _jax_fold(jtel.TelemetryConfig(**kw), stream, N, inner)
    out = _port_fold(tel_mod.TelemetryConfig(**kw), stream, N, inner)
    _assert_tel(out, ref, rtol=1e-6)
    finite = np.isfinite(stream["solve_res"])
    np.testing.assert_array_equal(out.res_count.numpy(), finite.sum(0))
    assert torch.isfinite(out.p2_q).all()
    if inner:
        assert int(out.inner_hist.sum()) == 3 * 60
        assert out.agent_fail_steps.shape == (3, N)


def test_p2_percentiles_track_np_percentile():
    """The vectorized P² estimator tracks the exact percentiles of a skewed
    4000-sample stream to 8%, the JAX test's bound, in every scenario of
    a batch of two streams."""
    cfg = tel_mod.TelemetryConfig()
    xs = np.random.default_rng(0).lognormal(-3.0, 1.0, (4000, 2)).astype(
        np.float32)
    tel = tel_mod.init_telemetry(cfg, device="cpu", batch=(2,))
    q, npos, count = tel.p2_q, tel.p2_n, tel.res_count
    for x in torch.as_tensor(xs):
        q, npos = tel_mod._p2_update(cfg, q, npos, count, x)
        count = count + 1
    for s in range(2):
        lane = tel.replace(p2_q=q[s], p2_n=npos[s], res_count=count[s])
        est = tel_mod.residual_percentiles(lane)
        for p in cfg.quantiles:
            ref = float(np.percentile(xs[:, s], p * 100))
            key = "p%g" % (p * 100)
            assert abs(est[key] - ref) / ref < 0.08, (key, est[key], ref)


def test_p2_small_sample_is_exact():
    """Below 5 observations the bootstrap markers are the sample."""
    cfg = tel_mod.TelemetryConfig(quantiles=(0.5,))
    tel = tel_mod.init_telemetry(cfg, device="cpu")
    for x in (3.0, 1.0, 2.0):
        q, npos = tel_mod._p2_update(cfg, tel.p2_q, tel.p2_n, tel.res_count,
                                     torch.tensor(x))
        tel = tel.replace(p2_q=q, p2_n=npos, res_count=tel.res_count + 1)
    assert tel_mod.residual_percentiles(tel)["p50"] == pytest.approx(2.0)


def test_track_agents_mismatch_raises():
    """``track_agents`` on with stats that carry no per-agent residuals is
    the JAX package's ValueError."""
    cfg = tel_mod.TelemetryConfig(track_agents=True)
    tel = tel_mod.init_telemetry(cfg, N, device="cpu", batch=(2,))
    stream = _stream(2, 1, N)
    st = SolverStats(**{k: torch.as_tensor(stream[k][0]) for k in (
        "iters", "solve_res", "collision", "min_env_dist", "ok_frac")},
        err_seq=torch.zeros((2, 1)))
    with pytest.raises(ValueError, match="track_agent_stats"):
        tel_mod.update(cfg, tel, st)


@pytest.mark.parametrize("batched", [False, True], ids=["one", "batched"])
def test_summary_matches_jax(batched):
    """``summary`` of the JAX package's own accumulator, carried across by
    ``convert.telemetry_state``, equals the JAX package's dict; the batched
    form rolls up across scenarios the same way."""
    stream = _stream(3, 40, N, seed=5)
    cfg = jtel.TelemetryConfig(track_agents=True)
    ref = _jax_fold(cfg, stream, N, True)
    if not batched:
        ref = jax.tree.map(lambda x: x[1], ref)
    tel = convert.telemetry_state(jax.tree.map(np.asarray, ref),
                                  device="cpu")
    assert tel_mod.summary(tel) == jtel.summary(ref)
    assert tel_mod.find_state((None, [tel])) is tel


def _rollout_bits():
    jp, jcol, js = jsetup.rqp_setup(N)
    jcfg = jcadmm.make_config(jp, jcol.collision_radius,
                              jcol.max_deceleration, max_iter=6,
                              inner_iters=15, socp_fused="scan",
                              pad_operators=True, track_agent_stats=True)
    tp, tcol, ts = setup.rqp_setup(N, device="cpu")
    tcfg = cadmm.make_config(tp, tcol.collision_radius,
                             tcol.max_deceleration, max_iter=6,
                             inner_iters=15, pad_operators=True,
                             track_agent_stats=True, device="cpu")
    return (jp, jcfg, js), (tp, tcfg, ts)


def test_rollout_accumulator_matches_jax():
    """``rollout(telemetry=)`` of C-ADMM (``track_agent_stats``) over 6
    steps of 2 scenarios against ``jax.vmap`` of the JAX rollout's: the
    counts equal, the floats within 1e-4 (absolute); the accumulator agrees with a
    recount from the logs."""
    (jp, jcfg, js), (tp, tcfg, ts) = _rollout_bits()
    S, T = 2, 6
    jtcfg = jtel.TelemetryConfig(track_agents=True)
    jf_eq, jplan = jcentral.equilibrium_forces(jp), jcadmm.make_plan(jp, jcfg)
    jll = jlowlevel.make_lowlevel_controller("pd", jp)
    x0 = jnp.asarray([[0.0, 0.0, 1.0], [0.5, -0.3, 1.2]], jnp.float32)
    ref = jax.jit(jax.vmap(lambda x: jrollout.rollout(
        lambda c, s, a: jcadmm.control(jp, jcfg, jf_eq, c, s, a,
                                       plan=jplan),
        jll.control, jp, js.replace(xl=x), jcadmm.init_cadmm_state(jp, jcfg),
        T, telemetry=jtcfg)))(x0)
    f_eq, plan = centralized.equilibrium_forces(tp), cadmm.make_plan(tp,
                                                                     tcfg)
    ll = lowlevel.make_lowlevel_controller("pd", tp)
    states = rollout.stack_scenarios(ts, S).replace(
        xl=torch.as_tensor(np.array(x0)))
    out = rollout.rollout(
        lambda c, s, a: cadmm.control(tp, tcfg, f_eq, c, s, a, plan=plan),
        ll.control, tp, states,
        rollout.stack_scenarios(cadmm.init_cadmm_state(tp, tcfg), S), T,
        telemetry=tel_mod.TelemetryConfig(track_agents=True))
    assert len(out) == 4
    tel, logs = out[3], out[2]
    _assert_tel(tel, ref[3], atol=1e-4)
    np.testing.assert_array_equal(tel.iters_sum.numpy(),
                                  logs.iters.sum(0).numpy())
    np.testing.assert_array_equal(tel.rung_hist[:, 0].numpy(), [T, T])
    np.testing.assert_array_equal(tel.res_max.numpy(),
                                  logs.solve_res.amax(0).numpy())


def test_resilient_rollout_accumulator_matches_jax():
    """The resilient rollout's accumulator (rungs after the ladder, the
    quarantine flag, per-agent solve health) for an agent loss and a
    dropout schedule, against the vmapped JAX run's."""
    (jp, jcfg, js), (tp, tcfg, ts) = _rollout_bits()
    T = 6
    jscheds = [jfaults.make_schedule(N, t_fail={1: 2},
                                     key=jax.random.PRNGKey(3)),
               jfaults.make_schedule(N, drop_rate=0.5, drop_hold=2,
                                     key=jax.random.PRNGKey(4))]
    jsched = jax.tree.map(lambda *xs: jnp.stack(xs), *jscheds)
    jtcfg = jtel.TelemetryConfig(track_agents=True)
    jhl = jres.make_cadmm_hl_step(jp, jcfg)
    jll = jlowlevel.make_lowlevel_controller("pd", jp)
    ref = jax.jit(jax.vmap(lambda f: jres.resilient_rollout(
        jhl, jll.control, jp, js, jcadmm.init_cadmm_state(jp, jcfg), T,
        faults=f, telemetry=jtcfg)))(jsched)
    tsched = convert.fault_schedule(jax.tree.map(np.asarray, jsched),
                                    device="cpu")
    hl = make_cadmm_hl_step(tp, tcfg)
    ll = lowlevel.make_lowlevel_controller("pd", tp)
    out = resilient_rollout(
        hl, ll.control, tp, rollout.stack_scenarios(ts, 2),
        rollout.stack_scenarios(cadmm.init_cadmm_state(tp, tcfg), 2), T,
        faults=tsched, telemetry=tel_mod.TelemetryConfig(track_agents=True))
    assert len(out) == 4
    _assert_tel(out[3], ref[3], atol=1e-4)
    np.testing.assert_array_equal(
        out[3].rung_hist.numpy(),
        [np.bincount(out[2].fallback_rung[:, s].numpy(), minlength=4)
         for s in range(2)])
    assert tel_mod.summary(out[3])["lanes"] == 2
