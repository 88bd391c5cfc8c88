"""PyTorch port vs the JAX package: fault schedules and the fault-aware
C-ADMM and DD steps (``resilience.faults``, ``control.cadmm`` and
``control.dd`` with ``health=``), the counterparts of
``tests/test_resilience_faults.py``.

Tolerances, and why: the schedule's masks are integer and boolean
functions of the Threefry bits, which the port reproduces word for word,
so ``alive``, ``msg_ok`` and ``thrust_scale`` must be bitwise equal. The
sensor noise goes through ``erf^-1`` (the port's copy of the float32
expansion JAX lowers to; ``log1p`` and ``sqrt`` may round one ulp apart),
so it agrees within 2e-6 (an ulp of the ~4-sigma draws is 5e-7). The
masked equilibrium forces agree within 1e-4 N (SVD pseudo-inverses from
two libraries; forces of up to 35 N). The fault-aware control steps hold
the bars of ``tests/test_torch_cadmm.py`` (C-ADMM, 1e-4 N) and
``tests/test_torch_dd.py`` (DD, 2e-3 N); iteration counts are discrete
and must be equal.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_cadmm import _scenarios, _t

from tpu_aerial_transport.control import cadmm as jcadmm
from tpu_aerial_transport.control import centralized as jcentral
from tpu_aerial_transport.control import dd as jdd
from tpu_aerial_transport.control import lowlevel as jlowlevel
from tpu_aerial_transport.envs import forest as jforest
from tpu_aerial_transport.harness import setup as jsetup
from tpu_aerial_transport.resilience import faults as jfaults
from tpu_aerial_transport_torch import convert
from tpu_aerial_transport_torch.control import cadmm, centralized, dd
from tpu_aerial_transport_torch.control import lowlevel
from tpu_aerial_transport_torch.envs import forest
from tpu_aerial_transport_torch.harness import rollout, setup
from tpu_aerial_transport_torch.resilience import faults, prng

KEYS = ("xl", "vl", "Rl", "wl", "R", "w")
ACC = (np.array([0.3, 0.0, 0.0], np.float32), np.zeros(3, np.float32))
BARS = {"cadmm": 1e-4, "dd": 2e-3}
INNER = {"cadmm": 20, "dd": 40}


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _jstack(items):
    return jax.tree.map(lambda *xs: jnp.stack(xs), *items)


def _schedule_specs(n):
    """Per-scenario schedule keywords: loss + degradation + dropout with a
    three-step hold, a heavier dropout, and noise on a second key."""
    return [
        dict(t_fail={1: 10}, t_degrade={2: 5}, thrust_scale=0.6,
             drop_rate=0.5, drop_hold=3, seed=0),
        dict(t_fail={0: 4, 3: 12}, drop_rate=0.3, drop_hold=2, seed=7),
        dict(t_degrade={n - 1: 0}, thrust_scale=np.linspace(0.2, 0.8, n),
             drop_rate=0.9, drop_hold=0, noise_std=0.05, seed=2 ** 31 + 3),
    ]


def _pair(n, spec):
    spec = dict(spec)
    seed = spec.pop("seed")
    jsched = jfaults.make_schedule(n, key=jax.random.PRNGKey(seed), **spec)
    tsched = faults.make_schedule(n, key=prng.prng_key(seed), device="cpu",
                                  **spec)
    return jsched, tsched


@pytest.mark.parametrize("batched", [False, True], ids=["shared", "stacked"])
def test_schedule_steps_match_jax_bitwise(batched):
    """Every ``fault_step`` leaf bitwise the JAX package's over 20 steps,
    dropout draws and the ``drop_hold`` blocks included; the stacked
    schedule gives the rows of the JAX package's vmapped evaluation."""
    n = 4
    pairs = [_pair(n, s) for s in _schedule_specs(n)]
    if batched:
        jsched = _jstack([j for j, _ in pairs[:2]])
        tsched = faults.stack_schedules([t for _, t in pairs[:2]])
        jstep = jax.jit(jax.vmap(jfaults.fault_step, in_axes=(0, None)))
    else:
        jsched, tsched = pairs[0]
        jstep = jax.jit(jfaults.fault_step)
    # The converter hands the port the JAX schedule itself.
    csched = convert.fault_schedule(_np(jsched), device="cpu")
    for t in range(20):
        ref = _np(jstep(jsched, t))
        for sched in (tsched, csched):
            out = faults.fault_step(sched, t)
            for name in ("alive", "thrust_scale", "msg_ok"):
                np.testing.assert_array_equal(
                    getattr(out, name).numpy(), getattr(ref, name),
                    err_msg=f"{name} at step {t}")
    # Dropout really happened, and held within its blocks.
    drops = np.stack([~faults.fault_step(tsched, t).msg_ok.numpy()
                      for t in range(9)])
    assert drops.any()
    if not batched:
        assert (drops[0:3] == drops[0]).all() and (drops[3:6] == drops[3]).all()


def test_make_schedule_leaves_match_jax():
    """``make_schedule``'s dict and array specs, scalar and array scales,
    and the ``drop_hold`` clamp give the JAX package's leaves."""
    n = 4
    for spec in _schedule_specs(n):
        jsched, tsched = _pair(n, spec)
        for name in ("t_fail", "t_degrade", "thrust_scale", "drop_rate",
                     "drop_hold", "noise_std", "key"):
            np.testing.assert_array_equal(
                getattr(tsched, name).numpy(),
                np.asarray(getattr(jsched, name)).astype(
                    getattr(tsched, name).numpy().dtype), err_msg=name)
        assert tsched.noisy == jsched.noisy and tsched.active
    assert not faults.no_faults(n, device="cpu").active


def test_sensor_noise_matches_jax():
    """``apply_sensor_noise`` within 2e-6 of the JAX package's, for one
    shared schedule over a batch and for per-scenario schedules."""
    n, S = 4, 3
    _, _, js = jsetup.rqp_setup(n)
    tp, _, ts = setup.rqp_setup(n, device="cpu")
    sc = _scenarios(n, S)
    jstates = jax.vmap(lambda *a: js.replace(**dict(zip(KEYS, a))))(
        *(jnp.asarray(sc[k], jnp.float32) for k in KEYS))
    tstates = rollout.stack_scenarios(ts, S).replace(
        **{k: _t(sc[k]) for k in KEYS})
    pairs = [_pair(n, dict(s, noise_std=0.05 * (i + 1)))
             for i, s in enumerate(_schedule_specs(n))]
    cases = [
        (pairs[0][0], pairs[0][1], (None, None, 0)),
        (_jstack([j for j, _ in pairs]),
         faults.stack_schedules([t for _, t in pairs]), (0, None, 0)),
    ]
    for jsched, tsched, axes in cases:
        for t in (0, 5, 17):
            ref = jax.vmap(jfaults.apply_sensor_noise, in_axes=axes)(
                jsched, t, jstates)
            out = faults.apply_sensor_noise(tsched, t, tstates)
            for k in ("xl", "vl", "w"):
                np.testing.assert_allclose(
                    getattr(out, k).numpy(), np.asarray(getattr(ref, k)),
                    atol=2e-6, rtol=0, err_msg=f"{k} at step {t}")
                assert not torch.equal(getattr(out, k), getattr(tstates, k))
            assert torch.equal(out.R, tstates.R)


@pytest.mark.parametrize("n", [3, 4, 8])
def test_equilibrium_forces_masks_match_jax(n):
    """The alive mask with 1, 2 and n - 1 survivors, all dead, and the
    same masks batched ``(S, n)``, against the JAX package's (the rank
    cutoff of ``jnp.linalg.pinv`` decides the deficient cases)."""
    jp, _, _ = jsetup.rqp_setup(n)
    tp, _, _ = setup.rqp_setup(n, device="cpu")
    rng = np.random.default_rng(n)
    masks = []
    for k in (1, 2, n - 1, 0):
        m = np.zeros(n, bool)
        m[rng.permutation(n)[:k]] = True
        masks.append(m)
    M = np.stack(masks)
    ref = np.asarray(jax.vmap(
        lambda a: jcentral.equilibrium_forces(jp, a))(jnp.asarray(M)))
    out = centralized.equilibrium_forces(tp, torch.as_tensor(M)).numpy()
    assert out.shape == (len(masks), n, 3)
    np.testing.assert_allclose(out, ref, atol=1e-4, rtol=0)
    for i, m in enumerate(masks):
        one = centralized.equilibrium_forces(tp, torch.as_tensor(m)).numpy()
        np.testing.assert_allclose(one, ref[i], atol=1e-4, rtol=0)
        assert np.all(one[~m] == 0.0)
    assert np.all(out[-1] == 0.0)  # all dead: zero thrusts.


def test_lowlevel_thrust_scale_matches_jax():
    """The low-level law with a thrust scale (0 = dead: zero wrench)
    against the JAX package's, within 1e-6 N (N m)."""
    n = 3
    jp, _, js = jsetup.rqp_setup(n)
    tp, _, ts = setup.rqp_setup(n, device="cpu")
    f_des = np.array([[0.3, -0.2, 5.0], [0.0, 0.4, 4.0], [0.1, 0.1, 6.0]],
                     np.float32)
    scale = np.array([0.0, 0.5, 1.0], np.float32)
    jf, jM = jlowlevel.make_lowlevel_controller("pd", jp).control(
        js, jnp.asarray(f_des), jnp.asarray(scale))
    tstates = rollout.stack_scenarios(ts, 1)
    f, M = lowlevel.make_lowlevel_controller("pd", tp).control(
        tstates, _t(f_des)[None], _t(scale)[None])
    np.testing.assert_allclose(f[0].numpy(), np.asarray(jf), atol=1e-6)
    np.testing.assert_allclose(M[0].numpy(), np.asarray(jM), atol=1e-6)
    assert float(f[0, 0]) == 0.0 and float(M[0, 0].abs().max()) == 0.0


def _health_cases(n, S):
    """Per-scenario JAX health masks: ``dead`` (a different agent lost in
    each scenario, one with a dropout too) and ``dropout`` (a FaultStep of
    stacked dropout schedules)."""
    alive = np.ones((S, n), bool)
    alive[0, 0] = alive[1, n - 1] = False
    msg_ok = alive.copy()
    msg_ok[2, 1] = False
    dead = jfaults.FaultStep(alive=jnp.asarray(alive),
                             thrust_scale=jnp.asarray(alive, jnp.float32),
                             msg_ok=jnp.asarray(msg_ok))
    scheds = _jstack([jfaults.make_schedule(
        n, drop_rate=0.4, key=jax.random.PRNGKey(10 + s)) for s in range(S)])
    drop = jax.vmap(jfaults.fault_step, in_axes=(0, None))(scheds, 3)
    assert not bool(jnp.all(drop.msg_ok))
    return {"dead": dead, "dropout": drop}


@functools.lru_cache(maxsize=None)
def _jax_health_step(ctrl, n):
    """The jitted ``jax.vmap`` of the JAX package's fault-aware step (one
    compile per state structure) and its initial controller state."""
    jmod = jcadmm if ctrl == "cadmm" else jdd
    jp, jcol, _ = jsetup.rqp_setup(n)
    jcfg = jmod.make_config(jp, jcol.collision_radius, jcol.max_deceleration,
                            max_iter=20, inner_iters=INNER[ctrl],
                            socp_fused="scan", pad_operators=True)
    if ctrl == "cadmm":
        jcs0, jplan = jcadmm.init_cadmm_state(jp, jcfg), jcadmm.make_plan(
            jp, jcfg)
    else:
        jcs0, jplan = jdd.init_dd_state(jp, jcfg), jdd.make_dd_plan(jp, jcfg)
    jf = jforest.make_forest(seed=0)
    acc = tuple(map(jnp.asarray, ACC))
    step = jax.jit(jax.vmap(lambda cs, s, h: jmod.control(
        jp, jcfg, jcentral.equilibrium_forces(jp, h.alive), cs, s, acc, jf,
        plan=jplan, health=h)))
    return step, jcs0


def _health_pair(ctrl, n, health, S=3, jax_cs=None, torch_cs=None):
    """One fault-aware step of S scenarios: ``jax.vmap`` of the JAX
    controller against the port, with the health-masked equilibrium."""
    sc = _scenarios(n, S)
    tmod = cadmm if ctrl == "cadmm" else dd
    jstep, jcs0 = _jax_health_step(ctrl, n)
    _, _, js = jsetup.rqp_setup(n)
    jcss = jax_cs if jax_cs is not None else jax.vmap(lambda _: jcs0)(
        jnp.arange(S))
    jstates = jax.vmap(lambda *a: js.replace(**dict(zip(KEYS, a))))(
        *(jnp.asarray(sc[k], jnp.float32) for k in KEYS))
    ref = jstep(jcss, jstates, health)

    tp, tcol, ts = setup.rqp_setup(n, device="cpu")
    tcfg = tmod.make_config(tp, tcol.collision_radius, tcol.max_deceleration,
                            max_iter=20, inner_iters=INNER[ctrl],
                            pad_operators=True, device="cpu")
    if ctrl == "cadmm":
        tcs0, tplan = cadmm.init_cadmm_state(tp, tcfg), cadmm.make_plan(
            tp, tcfg)
    else:
        tcs0, tplan = dd.init_dd_state(tp, tcfg), dd.make_dd_plan(tp, tcfg)
    th = convert.fault_step(_np(health), device="cpu")
    tcss = torch_cs if torch_cs is not None else rollout.stack_scenarios(
        tcs0, S)
    tstates = rollout.stack_scenarios(ts, S).replace(
        **{k: _t(sc[k]) for k in KEYS})
    out = tmod.control(tp, tcfg, centralized.equilibrium_forces(
        tp, th.alive), tcss, tstates, tuple(map(_t, ACC)),
        forest.make_forest(seed=0, device="cpu"), plan=tplan, health=th)
    return ref, out


def _assert_health_step(ctrl, ref, out):
    (jf_app, jcs, jst), (f_app, cs, st) = ref, out
    bar = BARS[ctrl]
    np.testing.assert_array_equal(st.iters.numpy(), np.asarray(jst.iters))
    np.testing.assert_array_equal(st.ok_frac.numpy(), np.asarray(jst.ok_frac))
    np.testing.assert_allclose(f_app.numpy(), np.asarray(jf_app), atol=bar,
                               rtol=0)
    np.testing.assert_allclose(st.solve_res.numpy(),
                               np.asarray(jst.solve_res), atol=bar, rtol=0)
    if ctrl == "cadmm":
        pairs = [("f", "f"), ("lam", "lam"), ("f_mean", "f_mean"),
                 ("held", "held")]
    else:
        pairs = [(k, k) for k in ("f", "F", "M", "lam_F", "lam_M", "held_f",
                                  "held_lam_F", "held_lam_M")]
    for a, b in pairs:
        np.testing.assert_allclose(getattr(cs, b).numpy(),
                                   np.asarray(getattr(jcs, a)), atol=bar,
                                   rtol=0, err_msg=a)


@pytest.mark.parametrize("case", ["dead", "dropout"])
@pytest.mark.parametrize("ctrl", ["cadmm", "dd"])
def test_health_step_matches_vmapped_jax(ctrl, case):
    """One fault-aware control step with per-scenario masks taken from the
    JAX package against ``jax.vmap`` of its step; dead agents apply
    exactly zero force and the survivors carry the payload."""
    n, S = 4, 3
    health = _health_cases(n, S)[case]
    ref, out = _health_pair(ctrl, n, health, S)
    _assert_health_step(ctrl, ref, out)
    f_app = out[0]
    alive = np.asarray(health.alive)
    assert np.all(f_app.numpy()[~alive] == 0.0)
    tp, _, _ = setup.rqp_setup(n, device="cpu")
    mTg = float(tp.mT) * 9.81
    tot = f_app[..., 2].sum(dim=1).numpy()
    assert np.all((tot > 0.7 * mTg) & (tot < 1.3 * mTg))


def test_held_carried_across_a_dropout_window():
    """The peers' view of a dropped agent is its last delivered copy,
    frozen across a two-step dropout window while the agent iterates on;
    the port's ``held`` against the JAX package's after every step."""
    n, S = 4, 3
    alive = jnp.ones((S, n), bool)
    ok_all = jfaults.FaultStep(alive=alive, thrust_scale=jnp.ones((S, n)),
                               msg_ok=alive)
    drop0 = ok_all.replace(msg_ok=alive.at[:, 0].set(False))
    ref_a, out_a = _health_pair("cadmm", n, ok_all, S)
    _assert_health_step("cadmm", ref_a, out_a)
    assert torch.equal(out_a[1].held, out_a[1].f)
    snapshot = out_a[1].held[:, 0].clone()
    jcs, tcs = ref_a[1], out_a[1]
    for _ in range(2):
        ref, out = _health_pair("cadmm", n, drop0, S, jax_cs=jcs,
                                torch_cs=tcs)
        _assert_health_step("cadmm", ref, out)
        jcs, tcs = ref[1], out[1]
        assert torch.equal(tcs.held[:, 0], snapshot)
        assert torch.equal(tcs.held[:, 1:], tcs.f[:, 1:])
    assert float((tcs.f[:, 0] - snapshot).abs().max()) > 1e-6


@pytest.mark.parametrize("ctrl", ["cadmm", "dd"])
def test_sharded_health_matches_single_program(ctrl):
    """``shards=2`` with per-scenario health masks (and
    ``track_agent_stats``) against the port's single program, within the
    controller's bar; the alive count and the residual go through the
    exchange."""
    n, S = 4, 3
    health = convert.fault_step(_np(_health_cases(n, S)["dead"]),
                                device="cpu")
    sc = _scenarios(n, S)
    tmod = cadmm if ctrl == "cadmm" else dd
    tp, tcol, ts = setup.rqp_setup(n, device="cpu")
    outs = []
    for shards, impl in ((1, "auto"), (2, "pallas_ring")):
        cfg = tmod.make_config(tp, tcol.collision_radius,
                               tcol.max_deceleration, max_iter=20,
                               inner_iters=20 if ctrl == "cadmm" else 40,
                               consensus_impl=impl, track_agent_stats=True,
                               device="cpu")
        cs0 = (cadmm.init_cadmm_state(tp, cfg) if ctrl == "cadmm"
               else dd.init_dd_state(tp, cfg))
        states = rollout.stack_scenarios(ts, S).replace(
            **{k: _t(sc[k]) for k in KEYS})
        outs.append(tmod.control(
            tp, cfg, centralized.equilibrium_forces(tp, health.alive),
            rollout.stack_scenarios(cs0, S), states, tuple(map(_t, ACC)),
            forest.make_forest(seed=0, device="cpu"), shards=shards,
            health=health))
    (f1, cs1, st1), (f2, cs2, st2) = outs
    bar = BARS[ctrl]
    np.testing.assert_array_equal(st2.iters.numpy(), st1.iters.numpy())
    np.testing.assert_allclose(f2.numpy(), f1.numpy(), atol=bar, rtol=0)
    np.testing.assert_allclose(st2.solve_res.numpy(), st1.solve_res.numpy(),
                               atol=bar, rtol=0)
    assert st1.agent_solve_res.shape == (S, n)
    np.testing.assert_allclose(st2.agent_solve_res.numpy(),
                               st1.agent_solve_res.numpy(), atol=bar,
                               rtol=0)
    assert np.all(f2.numpy()[~health.alive.numpy()] == 0.0)
