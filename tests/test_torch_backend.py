"""PyTorch port vs the JAX package: the backend guard
(``resilience/backend.py``) and the guarded chunk driver
(``resilience.recovery.run_chunks(guard=)`` / ``resume_run(guard=)``).

The port's guard keeps the JAX guard's state machines, events and
``TAT_BACKEND_FAULTS`` grammar, with an error taxonomy of its own: the
texts PyTorch, the CUDA runtime and the kernels' build raise. Held here:
``classify`` on a table of such texts; the breaker's transitions, the
backoff's delays and the guard's event rows against the JAX classes on
the same event sequence, clock and seed (exactly); the fault grammar's
parse and its strict refusal (the same values, the same message); a
``crash@N`` guarded run that degrades one chunk, tagged and journaled, on
the CPU; on the card (a guard whose primary rung is ``on-chip``) the
failure raised as a structured ``BackendError`` with its row journaled,
the fallback never called -- the JAX guard with no fallback -- and the
chunk driver stopped, to resume bitwise; the probe's child process on the
host. The guarded chunk driver runs the
centralized problem of ``tests/test_torch_recovery.py`` (n = 3, 6 steps in
3 chunks) on one scenario against the JAX package's guarded
``run_chunks``/``resume_run`` under the same injected crash: journal
events (chunks, rungs, backend_event kinds) equal, final states within
1e-4 and forces within 1e-3 N (the bars of
``tests/test_torch_recovery.py``: the centralized 10-iteration solve stops
short of convergence, where the packages' float32 duals round apart).
"""

import random
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_aerial_transport.control import centralized as jcentral
from tpu_aerial_transport.control import lowlevel as jlowlevel
from tpu_aerial_transport.harness import rollout as jrollout
from tpu_aerial_transport.harness import setup as jsetup
from tpu_aerial_transport.resilience import backend as jb
from tpu_aerial_transport.resilience import recovery as jrecovery
from tpu_aerial_transport_torch.control import centralized, lowlevel
from tpu_aerial_transport_torch.harness import rollout, setup
from tpu_aerial_transport_torch.obs import export
from tpu_aerial_transport_torch.resilience import backend as b
from tpu_aerial_transport_torch.resilience import recovery
from tpu_aerial_transport_torch.tree import leaves

N_HL, CHUNKS, HL_REL = 6, 3, 2
STATE_KEYS = ("xl", "vl", "Rl", "wl", "R", "w")
STATE_BAR, FORCE_BAR = 1e-4, 1e-3

# Texts PyTorch, the CUDA runtime and the extension build raise, as
# classify sees them ("<TypeName>: <message>"), with their kind.
CUDA_TEXTS = [
    ("OutOfMemoryError: CUDA out of memory. Tried to allocate 2.00 GiB. "
     "GPU 0 has a total capacity of 79.10 GiB of which 1.20 GiB is free.",
     "oom"),
    ("RuntimeError: CUDA error: out of memory", "oom"),
    ("RuntimeError: No CUDA GPUs are available", "init_unavailable"),
    ("RuntimeError: CUDA driver initialization failed, you might not have "
     "a CUDA gpu.", "init_unavailable"),
    ("RuntimeError: CUDA error: initialization error\nCUDA kernel errors "
     "might be asynchronously reported", "init_unavailable"),
    ("RuntimeError: cudaErrorNoDevice: no CUDA-capable device is detected",
     "init_unavailable"),
    ("AcceleratorError: CUDA error: an illegal memory access was "
     "encountered", "device_crash"),
    ("RuntimeError: CUDA error: misaligned address", "device_crash"),
    ("RuntimeError: CUDA error: unspecified launch failure",
     "device_crash"),
    ("RuntimeError: CUDA error: device-side assert triggered",
     "device_crash"),
    ("RuntimeError: CUDA error: uncorrectable ECC error encountered",
     "device_crash"),
    ("RuntimeError: CUDA error: the launch timed out and was terminated",
     "wedge_timeout"),
    ("BackendError: [wedge_timeout] chunk3 exceeded the 600s deadline "
     "(runtime wedged; worker thread abandoned)", "wedge_timeout"),
    ("RuntimeError: Error building extension 'fused_solve'",
     "compile_error"),
    ("RuntimeError: nvcc fatal : Unsupported gpu architecture "
     "'compute_90a'", "compile_error"),
    ("RuntimeError: ptxas error   : Entry function uses too much shared "
     "data", "compile_error"),
    ("RuntimeError: topology_mismatch: visible 1 of 4 devices",
     "topology_mismatch"),
    ("ValueError: operands could not be broadcast together", "unknown"),
    ("RuntimeError: device='cuda' requested but torch.cuda.is_available() "
     "is False; pass device='cpu' to run the plain PyTorch path on the "
     "host", "unknown"),
    ("RuntimeError: mat1 and mat2 shapes cannot be multiplied", "unknown"),
]


@pytest.mark.parametrize("text,kind", CUDA_TEXTS,
                         ids=[f"{k}-{i}" for i, (_, k) in
                              enumerate(CUDA_TEXTS)])
def test_classify_cuda_texts(text, kind):
    """Each text classifies to its kind; the first match wins, an
    unmatched text is ``unknown`` (a code bug the guard re-raises) -- and
    "no card found" (``resolve_device``'s refusal) is such a bug, never a
    reason to degrade."""
    assert b.classify(text) == kind


def test_classify_exceptions_by_type_and_text():
    """A real ``torch.OutOfMemoryError`` classifies by its type name; an
    unmatched ``AcceleratorError`` is a device crash (the runtime itself
    raised); a BackendError keeps its kind; every kind is the JAX
    package's vocabulary."""
    assert b.ERROR_KINDS == jb.ERROR_KINDS
    assert b.BREAKER_KINDS == jb.BREAKER_KINDS
    assert b.classify(torch.OutOfMemoryError("Tried to allocate")) == "oom"

    class AcceleratorError(RuntimeError):
        pass

    assert b.classify(AcceleratorError("CUDA error: an unusual one")) \
        == "device_crash"
    assert b.classify(RuntimeError("CUDA error: an unusual one")) \
        == "unknown"
    assert b.classify(b.BackendError("oom", "x")) == "oom"
    with pytest.raises(ValueError):
        b.BackendError("not_a_kind", "x")


def test_backoff_delays_match_jax():
    """The same delays on the same attempts and seed, jitter on and off."""
    for kw in (dict(initial_s=10.0, factor=2.0, max_s=35.0, jitter=0.0),
               dict(initial_s=10.0, factor=2.0, max_s=600.0, jitter=0.2),
               dict()):
        p, jp = b.BackoffPolicy(**kw), jb.BackoffPolicy(**kw)
        r, jr = random.Random(0), random.Random(0)
        assert [p.delay(k, r) for k in range(8)] == \
            [jp.delay(k, jr) for k in range(8)]


# One event sequence for both breakers: (clock, op).
BREAKER_EVENTS = [
    (0.0, "fail:wedge_timeout"), (0.5, "fail:device_crash"),
    (1.0, "success"), (1.5, "fail:oom"), (2.0, "fail:oom"),
    (2.5, "fail:device_crash"), (3.0, "allow"), (20.0, "allow"),
    (20.5, "fail:wedge_timeout"), (40.0, "allow"), (80.0, "allow"),
    (80.1, "success"), (81.0, "fail:oom"), (81.5, "allow"),
]


def _drive_breaker(mod):
    now = [0.0]
    cb = mod.CircuitBreaker(
        failure_threshold=3,
        policy=mod.BackoffPolicy(initial_s=10.0, jitter=0.1),
        clock=lambda: now[0], rng=random.Random(7))
    seen = []
    for t, op in BREAKER_EVENTS:
        now[0] = t
        if op == "allow":
            r = cb.allow()
        elif op == "success":
            r = cb.record_success()
        else:
            r = cb.record_failure(op.split(":")[1])
        seen.append((r, cb.state, cb.consecutive_failures, cb.open_count,
                     cb.cooldown_s, cb.seconds_until_half_open()))
    return seen, cb.transitions


def test_breaker_transitions_match_jax():
    """closed -> open -> half-open -> open (longer) -> half-open ->
    closed on the same events, clock and seed: every state, count,
    cooldown and transition row equal to the JAX breaker's."""
    got, got_t = _drive_breaker(b)
    ref, ref_t = _drive_breaker(jb)
    assert got == ref
    assert got_t == ref_t
    assert [t["to"] for t in got_t] == [b.OPEN, b.HALF_OPEN, b.OPEN,
                                        b.HALF_OPEN, b.CLOSED]
    with pytest.raises(ValueError):
        b.CircuitBreaker(failure_threshold=0)


@pytest.mark.parametrize("spec", [
    "", "init_unavailable", "wedge=0.25", "crash@3", "crash@chunk2",
    "init_unavailable, crash@7 ,wedge=1"])
def test_fault_grammar_matches_jax(spec):
    """The same directives parse to the same fields."""
    got, ref = b.FaultInjector.from_env(spec), jb.FaultInjector.from_env(spec)
    for f in ("init_unavailable", "wedge_s", "crash_at", "crash_label"):
        assert getattr(got, f) == getattr(ref, f), f
    assert got.active == ref.active


@pytest.mark.parametrize("spec", ["crash", "wedge", "boom@3",
                                  "crash@3,explode"])
def test_fault_grammar_refuses_unknown_directive(spec):
    """A typo must not silently disable injection: both refuse, with the
    same message."""
    with pytest.raises(ValueError) as got:
        b.FaultInjector.from_env(spec)
    with pytest.raises(ValueError) as ref:
        jb.FaultInjector.from_env(spec)
    assert str(got.value) == str(ref.value)


def test_fault_injector_crash_and_wedge():
    """``crash@N`` raises a CUDA-runtime text at the N-th call only,
    classified ``device_crash``; ``crash@LABEL`` on matching labels;
    ``wedge=S`` sleeps then raises a structured wedge."""
    inj = b.FaultInjector.from_env("crash@2")
    inj.maybe_fault("c0")
    with pytest.raises(RuntimeError) as e:
        inj.maybe_fault("c1")
    assert b.classify(e.value) == "device_crash"
    inj.maybe_fault("c2")
    lab = b.FaultInjector.from_env("crash@b3")
    lab.maybe_fault("cadmm4:b2:c0")
    with pytest.raises(RuntimeError):
        lab.maybe_fault("cadmm4:b3:c0")
    with pytest.raises(b.BackendError) as w:
        b.FaultInjector(wedge_s=0.01).maybe_fault("x")
    assert w.value.kind == "wedge_timeout"


def test_deadline_watchdog():
    """A value passes, an error is forwarded, a wedge becomes a
    structured ``wedge_timeout`` within the deadline."""
    assert b.call_with_deadline(lambda: 3, 1.0) == 3
    assert b.call_with_deadline(lambda: 4, None) == 4
    with pytest.raises(KeyError):
        b.call_with_deadline(lambda: {}["x"], 1.0)
    t0 = time.monotonic()
    with pytest.raises(b.BackendError) as e:
        b.call_with_deadline(lambda: time.sleep(5.0), 0.1, label="wedged")
    assert e.value.kind == "wedge_timeout" and b.classify(e.value) \
        == "wedge_timeout"
    assert time.monotonic() - t0 < 3.0


def _guard_run(mod, primary, fallback=True):
    """One scripted guard session on a fake clock: success, a crash that
    falls back, a program bug that degrades without tripping the breaker,
    two more crashes that open the circuit, a routed call, a half-open
    probe that closes it; an unknown error re-raises. ``primary`` is the
    guard's primary rung; ``fallback=False`` passes no fallback. A call
    that raises a ``BackendError`` records ``("raised", kind)``; every
    fallback call is counted."""
    now = [0.0]
    called = []

    def fb():
        called.append(1)
        return -1

    g = mod.BackendGuard(
        deadline_s=5.0, primary_rung=primary,
        faults=mod.FaultInjector(),
        breaker=mod.CircuitBreaker(
            failure_threshold=2,
            policy=mod.BackoffPolicy(initial_s=10.0, jitter=0.0),
            clock=lambda: now[0]))
    crash = {b: "CUDA error: unspecified launch failure",
             jb: "INTERNAL: device crashed"}[mod]
    bug = {b: "nvcc fatal : bad flag",
           jb: "Mosaic lowering failed"}[mod]

    def raising(text):
        def fn():
            raise RuntimeError(text)
        return fn

    def run(label, fn):
        try:
            return g.run(label, fn, fallback_fn=fb if fallback else None)
        except mod.BackendError as e:
            return ("raised", e.kind)

    out = [run("c0", lambda: 1)]
    out.append(run("c1", raising(crash)))
    out.append(run("c2", raising(bug)))
    out.append(run("c3", raising(crash)))
    now[0] = 1.0
    out.append(run("c4", lambda: 1))
    now[0] = 11.0
    out.append(run("c5", lambda: 1))
    with pytest.raises(ValueError):
        run("c6", lambda: (_ for _ in ()).throw(ValueError("bug")))
    events = [(e["kind"], e["label"], e.get("rung"), e.get("circuit"))
              for e in g.events]
    return out, events, g.breaker.state, len(called)


def test_guard_session_matches_jax():
    """A CPU-primary session through both guards: the same values and
    rungs, the same ``backend_event`` rows (kind, label, rung, circuit
    state), the same final breaker state and the same fallback calls."""
    got = _guard_run(b, b.RUNG_CPU)
    ref = _guard_run(jb, jb.RUNG_CPU)
    assert got == ref
    values = [v for v, _ in got[0]]
    assert values == [1, -1, -1, -1, -1, 1]
    assert {r for _, r in got[0]} == {b.RUNG_CPU}
    assert got[3] == 4


def test_guard_on_the_card_never_runs_the_cpu_rung():
    """The same session with the card as the primary rung and a fallback
    given: the port's guard never calls it -- each classified failure and
    the open circuit raise a ``BackendError`` of their kind -- and its
    rows, values and breaker state are the JAX guard's with no fallback."""
    got = _guard_run(b, b.RUNG_ONCHIP)
    ref = _guard_run(jb, jb.RUNG_ONCHIP, fallback=False)
    assert got == ref
    assert got[0] == [(1, b.RUNG_ONCHIP), ("raised", "device_crash"),
                      ("raised", "compile_error"),
                      ("raised", "device_crash"),
                      ("raised", "wedge_timeout"), (1, b.RUNG_ONCHIP)]
    assert got[3] == 0
    assert [k for k, *_ in got[1]] == [
        "device_crash", "compile_error", "device_crash", "circuit_open",
        "circuit_half_open", "circuit_closed"]


def test_guard_counts_and_tags_every_fallback(tmp_path):
    """Every CPU-rung use of a CPU-primary guard is counted
    (``fallbacks``), flagged (``last_fell_back``) and written as a
    schema-valid ``backend_event`` row; on the card the same injected
    crash writes the same row and raises, with no fallback counted; a
    guard with no fallback raises a structured BackendError."""
    for primary in (b.RUNG_CPU, b.RUNG_ONCHIP):
        path = str(tmp_path / f"{primary}.metrics.jsonl")
        g = b.BackendGuard(deadline_s=5.0, primary_rung=primary,
                           faults=b.FaultInjector.from_env("crash@2"),
                           metrics=export.MetricsWriter(path))
        assert g.run("a", lambda: 1, fallback_fn=lambda: 0) == (1, primary)
        assert not g.last_fell_back and g.fallbacks == 0
        if primary == b.RUNG_CPU:
            assert g.run("b", lambda: 1, fallback_fn=lambda: 0) == (
                0, b.RUNG_CPU)
            assert g.last_fell_back and g.fallbacks == 1
        else:
            with pytest.raises(b.BackendError) as e:
                g.run("b", lambda: 1, fallback_fn=lambda: 0)
            assert e.value.kind == "device_crash"
            assert not g.last_fell_back and g.fallbacks == 0
        assert export.validate_file(path) == []
        rows = [e for e in export.read_events(path)
                if e["event"] == "backend_event"]
        assert [(e["kind"], e["label"], e["rung"]) for e in rows] == [
            ("device_crash", "b", primary)]
    with pytest.raises(b.BackendError) as e:
        b.BackendGuard(deadline_s=5.0, faults=b.FaultInjector(
            crash_at=1)).run("c", lambda: 1)
    assert e.value.kind == "device_crash"


def test_guard_primary_rung_and_run_on_cpu():
    """With no card the lazily resolved primary rung is ``cpu-tagged``
    (a CPU run has no higher rung to fall from); ``run_on_cpu`` makes
    the host PyTorch's default device inside the thunk only."""
    g = b.BackendGuard(deadline_s=5.0, faults=b.FaultInjector())
    assert g.run("x", lambda: 2)[1] == (
        b.RUNG_ONCHIP if torch.cuda.is_available() else b.RUNG_CPU)
    assert b.run_on_cpu(lambda: torch.zeros(2).device.type)() == "cpu"


def test_probe_subprocess_on_the_host(monkeypatch):
    """The probe's child runs the matmul and the bf16 round trip on the
    host and reports its topology; an expectation above it fails with a
    ``topology_mismatch``-classified detail; the injected
    ``init_unavailable`` fails fast as an initialisation failure; a
    ``bundle_dir`` that does not exist falls back to the plain probe in
    the child, reported as a ``bundle_fallback:unreadable`` note."""
    monkeypatch.delenv(b.FAULTS_ENV, raising=False)
    info = {}
    ok, detail = b.probe_subprocess(timeout_s=120, device="cpu", info=info)
    assert ok and detail == "cpu", detail
    assert info == {"platform": "cpu", "n_devices": 1, "n_processes": 1}
    ok, detail = b.probe_subprocess(timeout_s=120, device="cpu",
                                    expect_devices=4)
    assert not ok and b.classify(detail) == "topology_mismatch"
    ok, detail = b.probe_subprocess(
        env={b.FAULTS_ENV: "init_unavailable"}, device="cpu")
    assert not ok and b.classify(detail) == "init_unavailable"
    notes = []
    ok, detail = b.probe_subprocess(timeout_s=120, device="cpu",
                                    bundle_dir="/nonexistent", notes=notes)
    assert ok and detail == "cpu", detail
    assert len(notes) == 1 and notes[0].startswith(
        "bundle_fallback:unreadable:"), notes
    with pytest.raises(ValueError, match="not an integer"):
        b.probe_subprocess(env={b.EXPECTED_DEVICES_ENV: "four"},
                           device="cpu")
    assert b.default_deadline_s({}) == b.DEFAULT_DEADLINE_S
    assert b.default_deadline_s({b.DEADLINE_ENV: "2.5"}) == 2.5


# ----------------------------------------------------------------------
# The guarded chunk driver against the JAX package's.
# ----------------------------------------------------------------------

def _port_chunks():
    params, col, st0 = setup.rqp_setup(3, device="cpu")
    cfg = centralized.make_config(params, col.collision_radius,
                                  col.max_deceleration, solver_iters=10)
    f_eq = centralized.equilibrium_forces(params)
    ll = lowlevel.make_lowlevel_controller("pd", params)
    x0 = st0.xl

    def acc_des_fn(state, t):
        del t
        dvl = -1.0 * state.vl - 1.0 * (state.xl - x0)
        return (dvl, torch.zeros_like(dvl)), x0, torch.zeros(3)

    def hl(cs, s, a):
        return centralized.control(params, cfg, f_eq, cs, s, a)

    run = rollout.make_chunked_rollout(
        hl, ll.control, params, n_hl_steps=N_HL, n_chunks=CHUNKS,
        hl_rel_freq=HL_REL, acc_des_fn=acc_des_fn)
    carry = run.init_carry(
        rollout.stack_scenarios(st0, 1),
        rollout.stack_scenarios(centralized.init_ctrl_state(params, cfg,
                                                            f_eq), 1))
    return run, carry


def _jax_chunks():
    params, col, st0 = jsetup.rqp_setup(3)
    cfg = jcentral.make_config(params, col.collision_radius,
                               col.max_deceleration, solver_iters=10)
    f_eq = jcentral.equilibrium_forces(params)
    ll = jlowlevel.make_lowlevel_controller("pd", params)
    x0 = st0.xl

    def acc_des_fn(state, t):
        del t
        dvl = -1.0 * state.vl - 1.0 * (state.xl - x0)
        return (dvl, jnp.zeros(3, state.xl.dtype)), x0, jnp.zeros(3)

    def hl(cs, s, a):
        return jcentral.control(params, cfg, f_eq, cs, s, a)

    run = jrollout.make_chunked_rollout(
        hl, ll.control, params, n_hl_steps=N_HL, n_chunks=CHUNKS,
        hl_rel_freq=HL_REL, acc_des_fn=acc_des_fn)
    return run, run.init_carry(st0, jcentral.init_ctrl_state(params, cfg))


def _journal_rows(run_dir):
    return [(e["event"], e.get("chunk"), e.get("rung"), e.get("kind"))
            for e in recovery.RunJournal(run_dir).read()
            if e["event"] != "resume"]


def _close(port_carry, jax_carry):
    state, cs = port_carry
    jstate, jcs = jax.tree.map(np.asarray, jax_carry)
    for k in STATE_KEYS:
        np.testing.assert_allclose(getattr(state, k)[0].numpy(),
                                   getattr(jstate, k), rtol=0,
                                   atol=STATE_BAR, err_msg=k)
    np.testing.assert_allclose(cs.prev_f[0].numpy(), jcs.prev_f, rtol=0,
                               atol=FORCE_BAR)


def test_run_chunks_guard_degrades_like_jax(tmp_path):
    """``crash@2`` in a CPU-primary run: chunk 1's primary raises a
    classified crash, the chunk reruns on the CPU rung from chunk 0's
    boundary host copy, and
    the run stays there (one-way) -- the same journal rows (chunk events
    with their rungs, one ``device_crash`` backend_event) as the JAX
    package's guarded run, and the same result within the bars; the
    degraded run equals an unguarded one bitwise (the CPU rung reruns the
    same program on the same bits)."""
    run, carry = _port_chunks()
    plan = recovery.RunPlan(run_dir=str(tmp_path / "port"),
                            n_hl_steps=N_HL, n_chunks=CHUNKS)
    guard = b.BackendGuard(faults=b.FaultInjector.from_env("crash@2"))
    res = recovery.run_chunks(plan, run.chunk_jit, carry, guard=guard)
    jrun, jcarry = _jax_chunks()
    jplan = jrecovery.RunPlan(run_dir=str(tmp_path / "jax"),
                              n_hl_steps=N_HL, n_chunks=CHUNKS)
    jguard = jb.BackendGuard(faults=jb.FaultInjector.from_env("crash@2"))
    jres = jrecovery.run_chunks(jplan, jrun.chunk_jit, jcarry, guard=jguard)
    assert (res.status, res.chunks_done) == (jres.status, jres.chunks_done)
    rows = _journal_rows(plan.run_dir)
    assert rows == _journal_rows(jplan.run_dir)
    assert rows == [("run_start", None, None, None),
                    ("chunk", 0, b.RUNG_CPU, None),
                    ("backend_event", None, b.RUNG_CPU, "device_crash"),
                    ("chunk", 1, b.RUNG_CPU, None),
                    ("chunk", 2, b.RUNG_CPU, None),
                    ("done", None, None, None)]
    assert guard.fallbacks == 1 and jguard.last_fell_back
    _close(res.carry, jres.carry)
    plain = recovery.run_chunks(
        recovery.RunPlan(run_dir=str(tmp_path / "plain"), n_hl_steps=N_HL,
                         n_chunks=CHUNKS), run.chunk_jit, carry)
    for x, y in zip(leaves(res.carry), leaves(plain.carry)):
        assert torch.equal(x, y)


def test_resume_run_guard_like_jax(tmp_path):
    """A run preempted after chunk 1, resumed under a guard whose first
    call crashes: the resume's chunk degrades to the CPU rung, tagged and
    journaled, in both packages; the journals' rows agree and the final
    carries agree within the bars."""
    results = {}
    for name, mod, rec, build in (("port", b, recovery, _port_chunks),
                                  ("jax", jb, jrecovery, _jax_chunks)):
        run, carry = build()
        d = str(tmp_path / name)
        interrupt = rec.GracefulInterrupt()
        calls = {"n": 0}

        def killing(c, i0, run=run, calls=calls, interrupt=interrupt):
            out = run.chunk_jit(c, i0)
            calls["n"] += 1
            if calls["n"] == 2:
                interrupt.triggered = "SIGTERM"
            return out

        plan = rec.RunPlan(run_dir=d, n_hl_steps=N_HL, n_chunks=CHUNKS)
        res = rec.run_chunks(plan, killing, carry, interrupt=interrupt)
        assert res.status == "preempted" and res.chunks_done == 2
        run2, carry2 = build()
        guard = mod.BackendGuard(faults=mod.FaultInjector.from_env(
            "crash@1"))
        results[name] = (rec.resume_run(d, run2.chunk_jit, carry2,
                                        guard=guard), guard)
    res, guard = results["port"]
    jres, jguard = results["jax"]
    assert res.status == jres.status == "done"
    assert res.resumed_from_chunk == jres.resumed_from_chunk == 2
    rows = _journal_rows(str(tmp_path / "port"))
    assert rows == _journal_rows(str(tmp_path / "jax"))
    assert ("backend_event", None, "unresolved", "device_crash") in rows
    assert rows[-2:] == [("chunk", 2, b.RUNG_CPU, None),
                         ("done", None, None, None)]
    assert guard.fallbacks == 1 and jguard.last_fell_back
    _close(res.carry, jres.carry)


def test_run_chunks_on_the_card_stops_and_resumes(tmp_path):
    """A guard whose primary is the card never reruns a chunk on the CPU:
    under ``crash@2`` the run journals chunk 0 and the ``device_crash``
    row, then stops with the ``BackendError``; ``resume_run`` continues
    from chunk 0's boundary, bitwise an unguarded run. Only a carry on the
    CPU, with no ``place``, may take the CPU rung."""
    run, carry = _port_chunks()
    plan = recovery.RunPlan(run_dir=str(tmp_path / "card"), n_hl_steps=N_HL,
                            n_chunks=CHUNKS)
    guard = b.BackendGuard(primary_rung=b.RUNG_ONCHIP,
                           faults=b.FaultInjector.from_env("crash@2"))
    with pytest.raises(b.BackendError) as e:
        recovery.run_chunks(plan, run.chunk_jit, carry, guard=guard)
    assert e.value.kind == "device_crash" and guard.fallbacks == 0
    assert _journal_rows(plan.run_dir) == [
        ("run_start", None, None, None),
        ("chunk", 0, b.RUNG_ONCHIP, None),
        ("backend_event", None, b.RUNG_ONCHIP, "device_crash")]
    run2, carry2 = _port_chunks()
    res = recovery.resume_run(
        plan.run_dir, run2.chunk_jit, carry2,
        guard=b.BackendGuard(primary_rung=b.RUNG_ONCHIP,
                             faults=b.FaultInjector()))
    assert (res.status, res.resumed_from_chunk) == ("done", 1)
    plain = recovery.run_chunks(
        recovery.RunPlan(run_dir=str(tmp_path / "plain"), n_hl_steps=N_HL,
                         n_chunks=CHUNKS), run.chunk_jit, carry)
    for x, y in zip(leaves(res.carry), leaves(plain.carry)):
        assert torch.equal(x, y)

    assert recovery._cpu_rung_ok(guard, carry, None)
    assert not recovery._cpu_rung_ok(guard, carry, lambda c: c)
    assert not recovery._cpu_rung_ok(None, carry, None)
    # A leaf off the host (the meta device stands in for the card).
    off_host = (carry[0].replace(xl=torch.empty(1, 3, device="meta")),) \
        + tuple(carry[1:])
    assert not recovery._cpu_rung_ok(guard, off_host, None)
