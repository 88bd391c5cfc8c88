"""PyTorch port vs the JAX package: the chunked rollouts
(``harness.rollout.make_chunked_rollout``,
``resilience.rollout.make_chunked_resilient_rollout``) and crash recovery
(``resilience.recovery``), the counterparts of ``tests/test_recovery.py``
at its sizes: the centralized controller at n = 3 (``solver_iters=10``,
hover reference), 6 high-level steps in 3 chunks at ``hl_rel_freq=2``;
C-ADMM at n = 4 over 2 scenarios in the seed-0 forest; the resilient
C-ADMM batch of ``tests/test_torch_resilience.py``.

Tolerances, and why: a chunked run is bitwise the port's unchunked run,
and a resumed run bitwise the uninterrupted one (the same operations on
the same bits; resume restores every carry leaf at its dtype). Against
the JAX package's chunked rollouts under ``jax.vmap``: iteration counts,
rungs and flags equal; states within 1e-4; C-ADMM's forces within the
1e-4 N of ``tests/test_torch_rollout.py`` and
``tests/test_torch_resilience.py`` (the two packages' float32 inverses and
products round apart by ~1e-6 relative, and the substeps integrate that),
the centralized controller's within the 1e-3 N of its rollouts in
``tests/test_torch_centralized.py`` (its 10-iteration solve stops short
of convergence, where the packages' float32 duals round apart; measured
2.5e-4 N).
"""

import functools
import os
import signal
from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_resilience import SCENARIOS, _bits_equal, _port_bits, _scheds

from tpu_aerial_transport.control import cadmm as jcadmm
from tpu_aerial_transport.control import centralized as jcentral
from tpu_aerial_transport.control import lowlevel as jlowlevel
from tpu_aerial_transport.envs import forest as jforest
from tpu_aerial_transport.harness import rollout as jrollout
from tpu_aerial_transport.harness import setup as jsetup
from tpu_aerial_transport.resilience import recovery as jrecovery
from tpu_aerial_transport.resilience import rollout as jres
from tpu_aerial_transport_torch.control import centralized, lowlevel
from tpu_aerial_transport_torch.harness import checkpoint, rollout, setup
from tpu_aerial_transport_torch.obs import telemetry
from tpu_aerial_transport_torch.resilience import (
    faults,
    make_chunked_resilient_rollout,
    prng,
    recovery,
)
from tpu_aerial_transport_torch.resilience import rollout as tres
from tpu_aerial_transport_torch.tree import leaves

N_HL, CHUNKS, HL_REL = 6, 3, 2
STATE_KEYS = ("xl", "vl", "Rl", "wl", "R", "w")
# The centralized batch: two scenarios offset from the hover point.
OFFSETS = np.array([[0.0, 0.0, 0.0], [0.3, -0.2, 0.1]], np.float32)
# The C-ADMM batch: the positions of tests/test_torch_rollout.py, one on
# the mountain's slope.
CADMM_XL = np.array([[5.0, 0.5, 2.0], [14.0, -1.0, 2.5]], np.float32)
CADMM_KW = dict(max_iter=6, inner_iters=15)
FORCE_BAR = {"centralized": 1e-3, "cadmm": 1e-4}
# The resilient batch: 8 steps in 4 chunks, scenario 1's actuator gain +inf
# from step 3 (quarantined in chunk 1), preempted at the step-6 boundary.
RES_T, RES_C, KILL, RES_CUT = 8, 4, 3, 3


class Problem(NamedTuple):
    params: object
    cfg: object
    ll: object
    hl: Callable
    acc_des_fn: Callable
    states: object
    css: object


def _central():
    params, col, st0 = setup.rqp_setup(3, device="cpu")
    cfg = centralized.make_config(params, col.collision_radius,
                                  col.max_deceleration, solver_iters=10)
    f_eq = centralized.equilibrium_forces(params)
    ll = lowlevel.make_lowlevel_controller("pd", params)
    cs0 = centralized.init_ctrl_state(params, cfg, f_eq)
    x0 = st0.xl

    def acc_des_fn(state, t):
        del t
        dvl = -1.0 * state.vl - 1.0 * (state.xl - x0)
        return (dvl, torch.zeros_like(dvl)), x0, torch.zeros(3)

    def hl(cs, s, a):
        return centralized.control(params, cfg, f_eq, cs, s, a)

    S = len(OFFSETS)
    states = rollout.stack_scenarios(st0, S).replace(
        xl=x0 + torch.as_tensor(OFFSETS))
    return Problem(params, cfg, ll, hl, acc_des_fn, states,
                   rollout.stack_scenarios(cs0, S))


def _cadmm():
    ctl = rollout.make_controller("cadmm", 4, device="cpu", **CADMM_KW)
    states = rollout.scenario_batch(ctl.state0, len(CADMM_XL)).replace(
        xl=torch.as_tensor(CADMM_XL))
    return Problem(ctl.params, ctl.cfg, ctl.ll, ctl.control,
                   rollout.make_forest_acc_des(ctl.forest), states,
                   rollout.stack_scenarios(ctl.cs0, len(CADMM_XL)))


PROBLEMS = {"centralized": _central, "cadmm": _cadmm}


def _runner(p, n_hl_steps=N_HL, n_chunks=CHUNKS, **kw):
    return rollout.make_chunked_rollout(
        p.hl, p.ll.control, p.params, n_hl_steps=n_hl_steps,
        n_chunks=n_chunks, hl_rel_freq=HL_REL, acc_des_fn=p.acc_des_fn, **kw)


def _reference(p, **kw):
    return rollout.jit_rollout(p.hl, p.ll.control, p.params,
                               n_hl_steps=N_HL, hl_rel_freq=HL_REL,
                               acc_des_fn=p.acc_des_fn, **kw)(p.states,
                                                              p.css)


def _assert_bitwise(a, b, what=""):
    la, lb = leaves(a), leaves(b)
    assert len(la) == len(lb), what
    for i, (x, y) in enumerate(zip(la, lb)):
        assert x.dtype == y.dtype and _bits_equal(x, y), f"{what}: leaf {i}"


@pytest.mark.parametrize("kind", list(PROBLEMS))
def test_chunked_rollout_is_the_unchunked_bitwise(kind):
    """Chunked == ``jit_rollout`` bit for bit (final state, controller
    state, every log leaf), the boundaries surfaced in order, one chunk
    function behind ``chunk_jit`` and ``chunk_fn``; with telemetry the
    accumulator rides the carry and ends bitwise the unchunked one."""
    p = PROBLEMS[kind]()
    ref = _reference(p)
    runner = _runner(p)
    seen = []
    out = runner(p.states, p.css,
                 on_boundary=lambda c, carry, logs: seen.append(
                     (c, int(logs.xl.shape[0]))))
    assert seen == [(c, N_HL // CHUNKS) for c in range(CHUNKS)]
    assert runner.chunk_jit is runner.chunk_fn
    assert (runner.n_chunks, runner.chunk_len) == (CHUNKS, N_HL // CHUNKS)
    _assert_bitwise(ref, out, "chunked vs unchunked")
    # On the CPU the substeps run as plain calls: no graph.
    g = runner.substeps.graph
    assert (g.captures, g.replays) == (0, 0)
    tcfg = telemetry.TelemetryConfig()
    ref_t = _reference(p, telemetry=tcfg)
    tels = []
    runner_t = _runner(p, telemetry=tcfg)
    out_t = runner_t(p.states, p.css,
                     on_boundary=lambda c, carry, logs: tels.append(carry[2]))
    _assert_bitwise(ref_t[:3], out_t, "chunked with telemetry")
    _assert_bitwise(ref_t[3], tels[-1], "telemetry accumulator")


def _jax_problem(kind):
    """The JAX package's chunked rollout of ``kind``, vmapped over the
    same scenarios, and its logs (scenario first)."""
    if kind == "centralized":
        params, col, st0 = jsetup.rqp_setup(3)
        cfg = jcentral.make_config(params, col.collision_radius,
                                   col.max_deceleration, solver_iters=10)
        f_eq = jcentral.equilibrium_forces(params)
        cs0 = jcentral.init_ctrl_state(params, cfg)
        x0 = st0.xl

        def acc_des_fn(state, t):
            del t
            dvl = -1.0 * state.vl - 1.0 * (state.xl - x0)
            return (dvl, jnp.zeros(3, state.xl.dtype)), x0, jnp.zeros(3)

        def hl(cs, s, a):
            return jcentral.control(params, cfg, f_eq, cs, s, a)

        xl = np.asarray(x0) + OFFSETS
        vl = None
    else:
        params, col, st0 = jsetup.rqp_setup(4)
        jf = jforest.make_forest(seed=0)
        cfg = jcadmm.make_config(params, col.collision_radius,
                                 col.max_deceleration, **CADMM_KW)
        f_eq = jcentral.equilibrium_forces(params)
        cs0 = jcadmm.init_cadmm_state(params, cfg)
        acc_des_fn = jrollout.make_forest_acc_des(jf)

        def hl(cs, s, a):
            return jcadmm.control(params, cfg, f_eq, cs, s, a, jf)

        xl, vl = CADMM_XL, jnp.array([0.5, 0.0, 0.0], jnp.float32)
    ll = jlowlevel.make_lowlevel_controller("pd", params)
    run = jrollout.make_chunked_rollout(
        hl, ll.control, params, n_hl_steps=N_HL, n_chunks=CHUNKS,
        hl_rel_freq=HL_REL, acc_des_fn=acc_des_fn)
    S = len(xl)
    states = jax.vmap(lambda x: st0.replace(
        xl=x, vl=st0.vl if vl is None else vl))(jnp.asarray(xl))
    css = jax.vmap(lambda _: cs0)(jnp.arange(S))
    return jax.tree.map(np.asarray, jax.vmap(run)(states, css))


@pytest.mark.parametrize("kind", list(PROBLEMS))
def test_chunked_rollout_matches_jax_chunked_rollout(kind):
    """The port's chunked rollout against the JAX package's
    ``make_chunked_rollout`` under ``jax.vmap``: iteration counts, rungs
    and flags equal, states within 1e-4, forces within FORCE_BAR."""
    jstate, jcs, jlogs = _jax_problem(kind)
    p = PROBLEMS[kind]()
    state, cs, logs = _runner(p)(p.states, p.css)
    for k in ("iters", "collision", "fallback_rung", "quarantined"):
        np.testing.assert_array_equal(getattr(logs, k).numpy(),
                                      np.swapaxes(getattr(jlogs, k), 0, 1),
                                      err_msg=k)
    for k in STATE_KEYS + ("x_err", "v_err"):
        np.testing.assert_allclose(getattr(logs, k).numpy(),
                                   np.swapaxes(getattr(jlogs, k), 0, 1),
                                   rtol=0, atol=1e-4, err_msg=k)
    np.testing.assert_allclose(logs.f_des.numpy(),
                               np.swapaxes(jlogs.f_des, 0, 1), rtol=0,
                               atol=FORCE_BAR[kind])
    for k in STATE_KEYS:
        np.testing.assert_allclose(getattr(state, k).numpy(),
                                   getattr(jstate, k), rtol=0, atol=1e-4,
                                   err_msg=k)
    if kind == "cadmm":
        assert int(logs.iters.max()) > 1
        np.testing.assert_allclose(cs.f_mean.numpy(), jcs.f_mean, rtol=0,
                                   atol=1e-4)


def test_validate_chunking_errors_match_jax():
    """The same refusals, with the JAX package's messages."""
    for n_hl, n_c, fn in ((7, 3, lambda s, t: None), (6, 3, None)):
        with pytest.raises(ValueError) as ref:
            jrollout.validate_chunking(n_hl, n_c, fn)
        with pytest.raises(ValueError) as got:
            rollout.validate_chunking(n_hl, n_c, fn)
        assert str(got.value) == str(ref.value)
    p = _central()
    with pytest.raises(ValueError, match="divisible"):
        _runner(p, n_hl_steps=7)
    with pytest.raises(ValueError, match="acc_des_fn"):
        rollout.make_chunked_rollout(p.hl, p.ll.control, p.params,
                                     n_hl_steps=6, n_chunks=3,
                                     acc_des_fn=None)
    assert rollout.validate_chunking(6, 3, p.acc_des_fn) == 2
    assert rollout.chunk_index_offset(2, 5) == 10


def _plan(d, **kw):
    return recovery.RunPlan(run_dir=str(d), n_hl_steps=N_HL,
                            n_chunks=CHUNKS, **kw)


@pytest.mark.parametrize("kind,kill_after", [
    ("centralized", 1), ("centralized", 2), ("cadmm_telemetry", 1)])
def test_kill_at_chunk_boundary_then_resume_bit_identical(tmp_path, kind,
                                                          kill_after):
    """A run stopped at a chunk boundary resumes, from the run directory
    and a regenerated initial carry alone, to the uninterrupted run's
    final carry and logs bit for bit (the run-health accumulator too)."""
    tel = telemetry.TelemetryConfig() if kind == "cadmm_telemetry" else None
    p = PROBLEMS[kind.split("_")[0]]()
    ref = _reference(p, telemetry=tel)
    runner = _runner(p, telemetry=tel)
    ch = checkpoint.config_fingerprint(cfg=p.cfg, n=p.params.n)
    interrupt = recovery.GracefulInterrupt()
    calls = {"n": 0}

    def killing_chunk(carry, i0):
        out = runner.chunk_jit(carry, i0)
        calls["n"] += 1
        if calls["n"] == kill_after:
            interrupt.triggered = "SIGTERM"  # "the process is killed here".
        return out

    res = recovery.run_chunks(_plan(tmp_path, seed=0, config_hash=ch),
                              killing_chunk,
                              runner.init_carry(p.states, p.css),
                              interrupt=interrupt)
    assert res.status == "preempted" and res.chunks_done == kill_after
    events = [e["event"] for e in recovery.RunJournal(str(tmp_path)).read()]
    assert events == ["run_start"] + ["chunk"] * kill_after + ["preempted"]
    # "A new process": the run dir and a deterministic regeneration.
    fresh = PROBLEMS[kind.split("_")[0]]()
    runner2 = _runner(fresh, telemetry=tel)
    res2 = recovery.resume_run(str(tmp_path), runner2.chunk_jit,
                               runner2.init_carry(fresh.states, fresh.css),
                               config_hash=ch)
    assert res2.status == "done" and res2.resumed_from_chunk == kill_after
    _assert_bitwise(ref[:2], res2.carry[:2], "resumed carry")
    _assert_bitwise(ref[2], res2.logs, "resumed logs")
    if tel is not None:
        _assert_bitwise(ref[3], res2.carry[2], "resumed accumulator")


def test_resume_falls_back_past_corrupt_snapshot(tmp_path):
    """A corrupted newest carry snapshot is skipped (``corrupt`` in the
    journal's resume event) and the run resumes a boundary earlier, still
    bitwise the uninterrupted run."""
    p = _central()
    ref = _reference(p)
    runner = _runner(p)
    ch = checkpoint.config_fingerprint(cfg=p.cfg)
    res = recovery.run_chunks(_plan(tmp_path, config_hash=ch),
                              runner.chunk_jit,
                              runner.init_carry(p.states, p.css))
    assert res.status == "done"
    newest = checkpoint.snapshot_path(str(tmp_path), CHUNKS - 1,
                                      recovery.CARRY_PREFIX)
    raw = dict(np.load(newest, allow_pickle=False))
    raw["leaf_000000"] = raw["leaf_000000"] + 1  # stale manifest digests.
    with open(newest, "wb") as fh:
        np.savez(fh, **raw)
    res2 = recovery.resume_run(str(tmp_path), runner.chunk_jit,
                               runner.init_carry(p.states, p.css),
                               config_hash=ch)
    assert res2.status == "done" and res2.resumed_from_chunk == CHUNKS - 1
    _assert_bitwise(ref, (*res2.carry, res2.logs), "past a corrupt snapshot")
    resume = [e for e in recovery.RunJournal(str(tmp_path)).read()
              if e.get("event") == "resume"][-1]
    assert resume["skipped"] and "[corrupt]" in resume["skipped"][0]


def test_resume_refuses_config_mismatch(tmp_path):
    p = _central()
    runner = _runner(p)
    recovery.run_chunks(_plan(tmp_path, config_hash="cfg-A"),
                        runner.chunk_jit, runner.init_carry(p.states, p.css))
    with pytest.raises(checkpoint.SnapshotError) as ei:
        recovery.resume_run(str(tmp_path), runner.chunk_jit,
                            runner.init_carry(p.states, p.css),
                            config_hash="cfg-B")
    assert ei.value.kind == "config_mismatch"


def test_sigterm_graceful_interrupt_real_signal(tmp_path):
    """A real SIGTERM during chunk 0 stops the run at the next boundary
    with the snapshot flushed and the signal journaled; a resume finishes
    it bitwise."""
    p = _central()
    ref = _reference(p)
    runner = _runner(p)
    calls = {"n": 0}

    def chunk_sending_sigterm(carry, i0):
        out = runner.chunk_jit(carry, i0)
        calls["n"] += 1
        if calls["n"] == 1:
            os.kill(os.getpid(), signal.SIGTERM)
        return out

    with recovery.GracefulInterrupt() as interrupt:
        res = recovery.run_chunks(_plan(tmp_path), chunk_sending_sigterm,
                                  runner.init_carry(p.states, p.css),
                                  interrupt=interrupt)
    assert res.status == "preempted" and interrupt.triggered == "SIGTERM"
    assert [e for e in recovery.RunJournal(str(tmp_path)).read()
            if e.get("event") == "preempted"][0]["signal"] == "SIGTERM"
    checkpoint.load_latest_valid(str(tmp_path),
                                 runner.init_carry(p.states, p.css),
                                 prefix=recovery.CARRY_PREFIX)
    res2 = recovery.resume_run(str(tmp_path), runner.chunk_jit,
                               runner.init_carry(p.states, p.css))
    _assert_bitwise(ref, (*res2.carry, res2.logs), "after a real SIGTERM")


def test_host_level_retry_requeues_after_device_error(tmp_path):
    """A chunk that raises is requeued from the last boundary's host copy,
    on the carry's own device; the run is bitwise the uninterrupted one
    and the retry journaled; once the retries are spent the error
    propagates."""
    p = _central()
    ref = _reference(p)
    runner = _runner(p)
    calls = {"n": 0}
    devices = []

    def dying_chunk(carry, i0):
        calls["n"] += 1
        devices.append({t.device.type for t in leaves(carry)})
        if calls["n"] == 2:
            raise RuntimeError("simulated device error")
        return runner.chunk_jit(carry, i0)

    res = recovery.run_chunks(_plan(tmp_path), dying_chunk,
                              runner.init_carry(p.states, p.css),
                              max_retries=1)
    assert res.status == "done" and res.retries == 1
    assert devices == [{"cpu"}] * 4
    _assert_bitwise(ref, (*res.carry, res.logs), "after a retry")
    assert [e for e in recovery.RunJournal(str(tmp_path)).read()
            if e.get("event") == "retry"]

    def always_dying(carry, i0):
        raise RuntimeError("dead device")

    with pytest.raises(RuntimeError, match="dead device"):
        recovery.run_chunks(_plan(tmp_path / "b"), always_dying,
                            runner.init_carry(p.states, p.css),
                            max_retries=2)


def test_snapshot_io_failure_retry_does_not_double_apply(tmp_path,
                                                         monkeypatch):
    """A failed log-snapshot write after chunk 1 computed retries from the
    last published boundary, not from chunk 1's own output."""
    p = _central()
    ref = _reference(p)
    runner = _runner(p)
    real_save = checkpoint.save_snapshot
    fails = {"n": 0}

    def flaky_save(directory, step, state, **kw):
        if (kw.get("prefix") == recovery.LOGS_PREFIX and step == 1
                and fails["n"] == 0):
            fails["n"] += 1
            raise OSError("simulated disk hiccup")
        return real_save(directory, step, state, **kw)

    monkeypatch.setattr(checkpoint, "save_snapshot", flaky_save)
    res = recovery.run_chunks(_plan(tmp_path), runner.chunk_jit,
                              runner.init_carry(p.states, p.css),
                              max_retries=1)
    assert res.status == "done" and res.retries == 1
    _assert_bitwise(ref, (*res.carry, res.logs), "after a snapshot retry")


def test_host_copy_is_a_real_copy():
    """On the CPU ``.cpu()`` is the tensor itself; the host copy is not,
    so an in-place write to the source leaves the backup as it was."""
    src = (torch.arange(4.0), torch.ones(2, dtype=torch.bool))
    back = recovery.host_copy(src)
    src[0].add_(1.0)
    src[1].logical_not_()
    assert back[0].tolist() == [0.0, 1.0, 2.0, 3.0] and back[1].all()
    assert back[0].data_ptr() != src[0].data_ptr()


def test_journal_tolerates_torn_tail(tmp_path):
    j = recovery.RunJournal(str(tmp_path))
    j.append({"event": "run_start", "n_hl_steps": 4, "n_chunks": 2})
    j.append({"event": "chunk", "chunk": 0})
    with open(j.path, "a") as fh:
        fh.write('{"event": "chunk", "chu')  # power cut mid-append.
    assert [e["event"] for e in j.read()] == ["run_start", "chunk"]
    assert j.completed_chunks() == {0}
    assert recovery.read_plan(str(tmp_path)).n_chunks == 2
    # The JAX package's reader sees the same journal the same way.
    assert jrecovery.RunJournal(str(tmp_path)).completed_chunks() == {0}


def _resilient_batch():
    """The port's resilient C-ADMM batch (``tests/test_torch_resilience.py``
    set-up, n = 4) over 3 scenarios, scenario 1's actuator gain +inf from
    step KILL; the hover reference at the common start."""
    tp, ts, cs0, hl, ll = _port_bits("cadmm")
    scheds = [faults.make_schedule(4, key=prng.prng_key(k, device="cpu"),
                                   device="cpu") for k in range(3)]
    scheds[1] = faults.make_schedule(
        4, t_degrade={0: KILL}, thrust_scale=float("inf"),
        key=prng.prng_key(1, device="cpu"), device="cpu")
    x0 = ts.xl

    def acc_des_fn(state, t):
        del t
        dvl = -1.0 * state.vl - 1.0 * (state.xl - x0)
        return (dvl, torch.zeros_like(dvl)), x0, torch.zeros(3)

    return (tp, hl, ll, faults.stack_schedules(scheds), acc_des_fn,
            rollout.stack_scenarios(ts, 3), rollout.stack_scenarios(cs0, 3))


def test_resilient_batch_resume_with_quarantined_lane(tmp_path):
    """The chunked resilient batch is bitwise ``jit_resilient_rollout``;
    preempted at the step-6 boundary (scenario 1 quarantined at step 3,
    its sticky flag in the carry) and resumed from the run directory, it
    gives the uninterrupted chunked run's carry and logs bit for bit."""
    tp, hl, ll, sched, acc, states, css = _resilient_batch()
    ref = tres.jit_resilient_rollout(hl, ll.control, tp, n_hl_steps=RES_T,
                                     hl_rel_freq=HL_REL, acc_des_fn=acc,
                                     faults=sched)(states, css)
    run = make_chunked_resilient_rollout(
        hl, ll.control, tp, n_hl_steps=RES_T, n_chunks=RES_C,
        hl_rel_freq=HL_REL, acc_des_fn=acc, faults=sched)
    carries = []
    whole = run(states, css,
                on_boundary=lambda c, carry, logs: carries.append(carry))
    _assert_bitwise(ref, whole, "chunked resilient vs unchunked")
    q = whole[2].quarantined
    assert q[KILL:, 1].all() and not q[:KILL, 1].any()
    assert not q[:, [0, 2]].any()
    # The flag rides the carry: raised at every boundary from step 4 on.
    assert [bool(c[3][1]) for c in carries] == [False, True, True, True]

    plan = recovery.RunPlan(run_dir=str(tmp_path), n_hl_steps=RES_T,
                            n_chunks=RES_C)
    interrupt = recovery.GracefulInterrupt()
    calls = {"n": 0}

    def preempting(carry, i0):
        out = run.chunk_jit(carry, i0)
        calls["n"] += 1
        if calls["n"] == RES_CUT:
            interrupt.triggered = "SIGTERM"
        return out

    res = recovery.run_chunks(plan, preempting, run.init_carry(states, css),
                              interrupt=interrupt)
    assert res.status == "preempted" and res.chunks_done == RES_CUT
    snap, _, _ = checkpoint.load_latest_valid(
        str(tmp_path), run.init_carry(states, css),
        prefix=recovery.CARRY_PREFIX)
    assert snap[3].tolist() == [False, True, False]
    res2 = recovery.resume_run(str(tmp_path), run.chunk_jit,
                               run.init_carry(states, css))
    assert res2.resumed_from_chunk == RES_CUT
    _assert_bitwise(carries[-1], res2.carry, "resumed resilient carry")
    _assert_bitwise(whole[2], res2.logs, "resumed resilient logs")


@functools.lru_cache(maxsize=None)
def _resilient_pair():
    """The resilient C-ADMM batch of ``tests/test_torch_resilience.py``
    (one schedule a scenario) chunked, from the JAX package under
    ``jax.vmap`` and from the port."""
    jsched, tsched = _scheds(list(SCENARIOS.values()))
    jp, jcol, js = jsetup.rqp_setup(4)
    cfg = jcadmm.make_config(jp, jcol.collision_radius,
                             jcol.max_deceleration, socp_fused="scan",
                             pad_operators=True, max_iter=6, inner_iters=15)
    jhl, jcs0 = jres.make_cadmm_hl_step(jp, cfg), jcadmm.init_cadmm_state(
        jp, cfg)
    jll = jlowlevel.make_lowlevel_controller("pd", jp)
    jx0 = js.xl

    def jacc(state, t):
        del t
        dvl = -1.0 * state.vl - 1.0 * (state.xl - jx0)
        return (dvl, jnp.zeros(3, state.xl.dtype)), jx0, jnp.zeros(3)

    def one(f):
        return jres.make_chunked_resilient_rollout(
            jhl, jll.control, jp, n_hl_steps=RES_T, n_chunks=RES_C,
            hl_rel_freq=HL_REL, acc_des_fn=jacc, faults=f)(js, jcs0)

    ref = jax.tree.map(np.asarray, jax.vmap(one)(jsched))
    tp, ts, cs0, hl, ll = _port_bits("cadmm")
    S = len(SCENARIOS)
    x0 = ts.xl

    def acc(state, t):
        del t
        dvl = -1.0 * state.vl - 1.0 * (state.xl - x0)
        return (dvl, torch.zeros_like(dvl)), x0, torch.zeros(3)

    out = make_chunked_resilient_rollout(
        hl, ll.control, tp, n_hl_steps=RES_T, n_chunks=RES_C,
        hl_rel_freq=HL_REL, acc_des_fn=acc, faults=tsched)(
        rollout.stack_scenarios(ts, S), rollout.stack_scenarios(cs0, S))
    return ref, out


def test_chunked_resilient_matches_jax():
    """The port's chunked resilient rollout against the JAX package's
    ``make_chunked_resilient_rollout`` under ``jax.vmap``, one fault
    schedule a scenario: rungs, flags and iteration counts equal, states
    and forces within 1e-4."""
    (_, _, jlogs), (_, _, logs) = _resilient_pair()
    for k in ("fallback_rung", "quarantined", "iters", "collision"):
        np.testing.assert_array_equal(getattr(logs, k).numpy(),
                                      np.swapaxes(getattr(jlogs, k), 0, 1),
                                      err_msg=k)
    for k in STATE_KEYS + ("f_des",):
        np.testing.assert_allclose(getattr(logs, k).numpy(),
                                   np.swapaxes(getattr(jlogs, k), 0, 1),
                                   rtol=0, atol=1e-4, err_msg=k)
    # The blackout scenario runs degraded at every step, in both.
    assert (logs.fallback_rung[:, list(SCENARIOS).index("blackout")]
            == tres.RUNG_RETRY).all()


def test_guard_is_not_ported(tmp_path):
    """What of the JAX guard is not ported -- its CPU rung for work on the
    card -- stays out: under a guard whose primary is the card an injected
    crash raises the classified ``BackendError`` and runs nothing on the
    CPU. The rest is ported: ``guard=`` runs on both entry points (a clean
    run never degrades: every chunk on the guard's primary rung, no
    ``backend_event``), and the result is bitwise an unguarded run's;
    tests/test_torch_backend.py holds the failures against the JAX
    package's."""
    from tpu_aerial_transport_torch.resilience import backend

    p = _central()
    runner = _runner(p)
    guard = backend.BackendGuard(faults=backend.FaultInjector())
    res = recovery.run_chunks(_plan(tmp_path), runner.chunk_jit,
                              runner.init_carry(p.states, p.css),
                              guard=guard)
    assert guard.fallbacks == 0 and guard.events == []
    _assert_bitwise(_reference(p)[:2], res.carry[:2], "guarded run")
    chunks = [e for e in recovery.RunJournal(str(tmp_path)).read()
              if e["event"] == "chunk"]
    assert [e["rung"] for e in chunks] == [guard.primary_rung] * CHUNKS
    res2 = recovery.resume_run(str(tmp_path), runner.chunk_jit,
                               runner.init_carry(p.states, p.css),
                               guard=guard)
    assert res2.status == "done" and res2.resumed_from_chunk == CHUNKS
    assert guard.fallbacks == 0
    card = backend.BackendGuard(
        primary_rung=backend.RUNG_ONCHIP,
        faults=backend.FaultInjector.from_env("crash@1"))
    with pytest.raises(backend.BackendError, match="device_crash"):
        recovery.run_chunks(_plan(tmp_path / "card"), runner.chunk_jit,
                            runner.init_carry(p.states, p.css), guard=card)
    assert card.fallbacks == 0 and not card.last_fell_back


def test_port_journal_reads_under_jax_read_plan(tmp_path):
    """The port's run directory is read by the JAX package's
    ``read_plan`` and journal into the same plan and chunk set."""
    p = _central()
    runner = _runner(p)
    plan = _plan(tmp_path, seed=7, config_hash="abc", keep_last=2,
                 meta={"scenarios": 2})
    recovery.run_chunks(plan, runner.chunk_jit,
                        runner.init_carry(p.states, p.css))
    ref = jrecovery.read_plan(str(tmp_path))
    got = recovery.read_plan(str(tmp_path))
    for f in ("run_dir", "n_hl_steps", "n_chunks", "seed", "config_hash",
              "keep_last", "logs_time_axis", "meta", "carry_prefix",
              "logs_prefix", "chunk_len"):
        assert getattr(got, f) == getattr(ref, f), f
    assert (jrecovery.RunJournal(str(tmp_path)).completed_chunks()
            == recovery.RunJournal(str(tmp_path)).completed_chunks()
            == set(range(CHUNKS)))
    # keep_last=2 pruned the carry snapshots; every log snapshot stays.
    assert [s for s, _ in checkpoint.list_snapshots(
        str(tmp_path), recovery.CARRY_PREFIX)] == [1, 2]
    assert len(checkpoint.list_snapshots(str(tmp_path),
                                         recovery.LOGS_PREFIX)) == CHUNKS
