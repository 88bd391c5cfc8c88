"""Crash recovery for chunked rollouts: the chunk-completion journal,
resumable runs and preemption-graceful shutdown.

Counterpart of the JAX package's ``resilience/recovery.py``, with its
journal format and events. ``harness.rollout.make_chunked_rollout`` and
``resilience.rollout.make_chunked_resilient_rollout`` surface the carry at
every chunk boundary through one chunk function ``chunk(carry, i0) ->
(carry, logs)``; this module is the host-side driver around it:

- :class:`RunJournal` -- an append-only, fsync'd jsonl record of the run
  and of each chunk's completion that tolerates a torn final line (the
  journal a killed run is resumed from);
- :func:`run_chunks` -- the chunk function driven boundary to boundary,
  an atomic carry snapshot and a per-chunk log snapshot
  (``harness.checkpoint``) published after every chunk, with an optional
  host-level retry that restores the last boundary's carry;
- :func:`resume_run` -- the newest carry snapshot that passes every check
  (digests, structure fingerprint, config hash) with a valid log prefix,
  what was skipped journaled with its reason, and the run continued to
  its end: kill-at-any-chunk followed by ``resume_run`` reproduces the
  uninterrupted run bit for bit, sticky quarantine flags included (they
  live in the resilient carry);
- :class:`GracefulInterrupt` -- SIGTERM/SIGINT as a context manager: the
  first signal asks for a stop at the next chunk boundary (where
  :func:`run_chunks` flushes a final snapshot and journals ``preempted``),
  a second raises ``KeyboardInterrupt`` at once.

Determinism: the initial carry must be regenerable from the journal's
seed and meta (the set-up factories and ``envs.forest.make_forest(seed)``
are deterministic), so a run directory and the code that started it are
enough to resume; no live process state is needed.

With a backend guard (``guard=``, ``resilience.backend.BackendGuard``)
each chunk runs under the guard's deadline, and a classified failure
(wedge, initialisation, crash, OOM) journals a ``backend_event``. On the
card the run then stops with the guard's ``BackendError``, to be resumed
from its last published boundary (:func:`resume_run`, in a new process
after a sticky CUDA error): nothing moves to the CPU. A CPU-primary run
reruns the chunk on the guard's CPU rung from the last boundary's host
copy, never from the failed carry, and stays there (one-way), as the JAX
package's does. A host-level retry (``max_retries``) stays on the card.
"""

from __future__ import annotations

import dataclasses
import os
import signal
import time

from tpu_aerial_transport_torch.harness import checkpoint
from tpu_aerial_transport_torch.harness.rollout import (
    chunk_index_offset,
    concat_chunk_logs,
)
from tpu_aerial_transport_torch.obs import export as export_mod
from tpu_aerial_transport_torch.obs import telemetry as telemetry_mod
from tpu_aerial_transport_torch.obs import trace as trace_mod
from tpu_aerial_transport_torch.resilience import backend as backend_mod
from tpu_aerial_transport_torch.tree import leaves, tree_map

JOURNAL_SCHEMA = 1
CARRY_PREFIX = "carry"
LOGS_PREFIX = "logs"


def host_copy(tree):
    """The host backup of a tree of tensors (the retry and snapshot
    anchor): every leaf copied to the CPU with ``copy=True``. Without it a
    CPU tensor's ``.cpu()`` is the tensor itself, so a later in-place write
    (``jit_control_step(donate=True)``) would change the "backup". Also a
    device synchronisation: the copy waits for the leaves, so a device
    error surfaces at the caller."""
    return tree_map(lambda t: t.detach().to("cpu", copy=True), tree)


@dataclasses.dataclass(frozen=True)
class RunPlan:
    """Static description of a chunked run, journaled at its start and
    re-read by :func:`resume_run`, so a resume needs only the run directory
    (and the deterministic set-up that ``meta``/``seed`` describe)."""

    run_dir: str
    n_hl_steps: int
    n_chunks: int
    seed: int | None = None
    config_hash: str | None = None
    keep_last: int = 3
    # The axis the per-chunk logs concatenate on: 0, the port's time axis.
    logs_time_axis: int = 0
    meta: dict = dataclasses.field(default_factory=dict)
    # Snapshot-family and journal names; a multi-process run gives each
    # process its own (checkpoint.shard_prefix) inside one run_dir.
    carry_prefix: str = CARRY_PREFIX
    logs_prefix: str = LOGS_PREFIX
    journal_filename: str | None = None

    @property
    def chunk_len(self) -> int:
        return self.n_hl_steps // self.n_chunks


@dataclasses.dataclass
class RunResult:
    """Outcome of :func:`run_chunks` / :func:`resume_run`. ``logs`` is the
    concatenated logs of every completed chunk (None when none completed);
    ``status`` is ``"done"`` or ``"preempted"``; ``resumed_from_chunk`` is
    the chunk a resume started at (None for an uninterrupted run);
    ``retries`` counts host-level requeues."""

    carry: object
    logs: object
    status: str
    chunks_done: int
    resumed_from_chunk: int | None = None
    retries: int = 0


class Preempted(RuntimeError):
    """For drivers that prefer an exception to a ``"preempted"`` result."""


class RunJournal:
    """Append-only jsonl journal. Every append is flushed and fsync'd
    before it returns -- a chunk is complete only once its journal line is
    durable -- and :meth:`read` skips a torn final line (what a power cut
    mid-append leaves), so the run resumes from the last durable chunk."""

    FILENAME = "journal.jsonl"

    def __init__(self, run_dir: str, filename: str | None = None):
        self.run_dir = run_dir
        self.path = os.path.join(run_dir, filename or self.FILENAME)

    def exists(self) -> bool:
        return os.path.exists(self.path)

    def append(self, event: dict) -> None:
        os.makedirs(self.run_dir, exist_ok=True)
        # One copy of the durable-append contract, shared with the
        # metrics writer.
        export_mod.jsonl_append(self.path, event)

    def read(self) -> list[dict]:
        if not self.exists():
            return []
        return export_mod.jsonl_read(self.path)

    def completed_chunks(self) -> set[int]:
        return {e["chunk"] for e in self.read() if e.get("event") == "chunk"}


class GracefulInterrupt:
    """Context manager turning SIGTERM/SIGINT into a chunk-boundary stop.

    First signal: record it and let the chunk in flight finish --
    :func:`run_chunks` sees :attr:`triggered` at the next boundary, flushes
    a final snapshot, journals ``preempted`` and returns. Second signal:
    ``KeyboardInterrupt`` at once."""

    def __init__(self, signals=(signal.SIGTERM, signal.SIGINT)):
        self._signals = signals
        self._old: dict = {}
        self.triggered: str | None = None

    def _handle(self, signum, frame):
        del frame
        if self.triggered is not None:
            raise KeyboardInterrupt(f"second signal {signum}")
        self.triggered = signal.Signals(signum).name

    def __enter__(self) -> "GracefulInterrupt":
        for s in self._signals:
            self._old[s] = signal.signal(s, self._handle)
        return self

    def __exit__(self, *exc):
        for s, old in self._old.items():
            signal.signal(s, old)
        return False


def read_plan(run_dir: str, journal_filename: str | None = None) -> RunPlan:
    """The :class:`RunPlan` of a run directory, from its journal's
    ``run_start`` event (``journal_filename`` picks a per-process
    journal)."""
    journal = RunJournal(run_dir, filename=journal_filename)
    for e in journal.read():
        if e.get("event") == "run_start":
            return RunPlan(
                run_dir=run_dir,
                n_hl_steps=e["n_hl_steps"],
                n_chunks=e["n_chunks"],
                seed=e.get("seed"),
                config_hash=e.get("config_hash"),
                keep_last=e.get("keep_last", 3),
                logs_time_axis=e.get("logs_time_axis", 0),
                meta=e.get("meta", {}),
                carry_prefix=e.get("carry_prefix", CARRY_PREFIX),
                logs_prefix=e.get("logs_prefix", LOGS_PREFIX),
                journal_filename=journal_filename,
            )
    raise checkpoint.SnapshotError(
        "unreadable", journal.path,
        "no run_start event in journal (not a recovery run directory?)",
    )


def _cpu_rung_ok(guard, carry, place) -> bool:
    """Whether the guard's CPU rung may rerun a chunk: only in a
    CPU-primary run (every carry leaf on the CPU, no ``place`` function),
    whose own program then reruns from the boundary's host copy. A carry
    on the card is never moved to the CPU (the guard refuses it too)."""
    return (guard is not None and place is None
            and all(t.device.type == "cpu" for t in leaves(carry)))


def run_chunks(
    plan: RunPlan,
    chunk_jit,
    carry,
    *,
    start_chunk: int = 0,
    prior_logs=(),
    interrupt: GracefulInterrupt | None = None,
    place=None,
    max_retries: int = 0,
    resumed_from_chunk: int | None = None,
    metrics: export_mod.MetricsWriter | str | None = None,
    guard=None,
    to_host=None,
    tracer: trace_mod.Tracer | None = None,
    trace_parent=None,
) -> RunResult:
    """Drive ``chunk_jit(carry, i0) -> (carry, logs)`` from ``start_chunk``
    to ``plan.n_chunks``, snapshotting the carry and the chunk's logs at
    every boundary and journaling each completion.

    ``to_host`` (optional) replaces :func:`host_copy` for both the
    boundary carry and the chunk logs (which are then returned as its
    output); it must return a tree of CPU tensors. ``place`` (optional)
    maps a carry onto devices: applied to the initial carry and after
    every restore.

    ``max_retries`` > 0 turns on the host-level retry: a chunk that raises
    is requeued on the carry restored from the last boundary's host copy,
    onto the device the carry was on -- nothing moves to the CPU. A sticky
    CUDA error (an illegal address) poisons the process's CUDA context,
    so the retry fails again and the error is re-raised once the retries
    are spent: such a run is resumed by a new process (:func:`resume_run`),
    from the last published boundary.

    ``guard`` (optional; a ``resilience.backend.BackendGuard``): each
    chunk runs under the guard's deadline watchdog, and a classified
    failure (wedge, initialisation, crash, OOM) journals a
    ``backend_event``. On the card the guard then raises its
    ``BackendError``, which reaches the host-level retry (on the card) and
    then the caller: the run is resumed from its last published boundary
    by :func:`resume_run`. A CPU-primary run (its carry on the CPU, no
    ``place``) instead reruns the chunk on the guard's CPU rung from the
    last boundary's host copy and CONTINUES there (one-way, as in the JAX
    package). Every chunk event records the ``rung`` it ran at.

    ``metrics`` (optional; an ``obs.export.MetricsWriter`` or a jsonl
    path): one ``chunk`` event per boundary with the chunk's wall time, a
    digest of its logs and, when the carry threads an
    ``obs.telemetry.TelemetryState``, the cumulative run-health summary;
    and ``run_start``/``retry``/``preempted``/``done`` events.

    ``tracer`` (optional; an ``obs.trace.Tracer``): a ``run`` root span,
    one ``chunk`` span per chunk with a ``snapshot`` child around the
    boundary publish, ``retry`` and ``preempted`` instants.
    ``trace_parent`` lets :func:`resume_run` parent the run under its
    ``resume`` span.

    Carry snapshots are pruned to ``plan.keep_last``; the per-chunk log
    snapshots are kept for every chunk (the whole trajectory must be
    reconstructable)."""
    cpu_rung = _cpu_rung_ok(guard, carry, place)
    journal = RunJournal(plan.run_dir, filename=plan.journal_filename)
    os.makedirs(plan.run_dir, exist_ok=True)
    _host = to_host if to_host is not None else host_copy
    if isinstance(metrics, str):
        metrics = export_mod.MetricsWriter(metrics)
    if metrics is not None and start_chunk == 0:
        metrics.emit(
            "run_start", run_dir=plan.run_dir,
            n_hl_steps=plan.n_hl_steps, n_chunks=plan.n_chunks,
            seed=plan.seed, config_hash=plan.config_hash, meta=plan.meta,
        )
    if start_chunk == 0 and not any(
        e.get("event") == "run_start" for e in journal.read()
    ):
        journal.append({
            "event": "run_start", "schema": JOURNAL_SCHEMA,
            "n_hl_steps": plan.n_hl_steps, "n_chunks": plan.n_chunks,
            "chunk_len": plan.chunk_len, "seed": plan.seed,
            "config_hash": plan.config_hash, "keep_last": plan.keep_last,
            "logs_time_axis": plan.logs_time_axis, "meta": plan.meta,
            "carry_prefix": plan.carry_prefix,
            "logs_prefix": plan.logs_prefix,
        })
    logs_chunks = list(prior_logs)
    # The host copy is the retry anchor: an in-place write or a failed
    # chunk may leave the device tensors unusable, the host copy survives.
    carry_host = _host(carry)
    carry = place(carry) if place is not None else carry
    retries_total = 0
    attempt = 0
    c = start_chunk
    if guard is not None:
        # The guard's backend_event rows land in this run's journal and
        # metrics unless the caller wired its own sinks.
        if guard.journal is None:
            guard.journal = journal
        if guard.metrics is None:
            guard.metrics = metrics
        if guard.tracer is None:
            guard.tracer = tracer
    run_span = None
    if tracer is not None:
        run_span = tracer.begin(
            trace_mod.RUN, parent=trace_parent, run_dir=plan.run_dir,
            start_chunk=start_chunk, n_chunks=plan.n_chunks,
            **({"resumed_from": resumed_from_chunk}
               if resumed_from_chunk is not None else {}),
        )
    rung: str | None = None
    # One-way, CPU-primary runs only: a guard fallback pins the run to the
    # CPU rung.
    degraded = False

    def _logs_out():
        if not logs_chunks:
            return None
        return concat_chunk_logs(logs_chunks, plan.logs_time_axis)

    while c < plan.n_chunks:
        if interrupt is not None and interrupt.triggered:
            if c > 0:
                # Flush a final snapshot of the boundary carry: normally a
                # rewrite of the one published after chunk c - 1 (atomic,
                # idempotent), it makes the preempted state durable even
                # if that publish predates this process.
                checkpoint.save_snapshot(
                    plan.run_dir, c - 1, carry_host,
                    prefix=plan.carry_prefix, config_hash=plan.config_hash,
                    keep_last=plan.keep_last, meta={"chunk": c - 1},
                )
            journal.append({
                "event": "preempted", "chunk": c,
                "signal": interrupt.triggered,
            })
            if metrics is not None:
                metrics.emit(
                    "preempted", chunk=c, signal=interrupt.triggered
                )
            if tracer is not None:
                tracer.instant("preempted", parent=run_span, chunk=c,
                               signal=interrupt.triggered)
                tracer.end(run_span, status="preempted", chunks_done=c)
            return RunResult(
                carry=carry, logs=_logs_out(),
                status="preempted", chunks_done=c,
                resumed_from_chunk=resumed_from_chunk,
                retries=retries_total,
            )
        cspan = sspan = None
        if tracer is not None:
            cspan = tracer.begin(trace_mod.CHUNK, parent=run_span, chunk=c)
        try:
            t0 = time.perf_counter()
            offset = chunk_index_offset(c, plan.chunk_len)

            def _exec(program, chunk_carry):
                out_carry, out_logs = program(chunk_carry, offset)
                # The copy synchronises (a device error surfaces inside
                # this try -- under the guard, inside the watchdogged
                # primary call) and backs the carry up. It stays a local
                # until the boundary is published: advancing carry_host
                # here would make a snapshot write failure retry chunk c
                # from chunk c's own output, applying its dynamics twice.
                out_host = _host(out_carry)
                if to_host is not None:
                    out_logs = to_host(out_logs)
                return out_carry, out_logs, out_host

            if guard is None:
                new_carry, logs, new_carry_host = _exec(chunk_jit, carry)
            elif degraded:
                # Pinned to the CPU rung: run there directly, without the
                # primary's deadline.
                new_carry, logs, new_carry_host = _exec(chunk_jit, carry)
                rung = backend_mod.RUNG_CPU
            else:
                # The CPU rung restarts from the last BOUNDARY's host copy
                # (a clone: the anchor stays untouched), never from the
                # failed carry.
                fallback = None if not cpu_rung else \
                    backend_mod.run_on_cpu(lambda: _exec(
                        chunk_jit,
                        tree_map(lambda t: t.clone(), carry_host)))
                (new_carry, logs, new_carry_host), rung = guard.run(
                    f"chunk{c}", lambda: _exec(chunk_jit, carry),
                    fallback_fn=fallback, trace_parent=cspan,
                )
                degraded = guard.last_fell_back
            wall_s = time.perf_counter() - t0
            if tracer is not None:
                sspan = tracer.begin(trace_mod.SNAPSHOT, parent=cspan,
                                     chunk=c)
            checkpoint.save_snapshot(
                plan.run_dir, c, new_carry_host, prefix=plan.carry_prefix,
                config_hash=plan.config_hash, keep_last=plan.keep_last,
                meta={"chunk": c},
            )
            checkpoint.save_snapshot(
                plan.run_dir, c, logs, prefix=plan.logs_prefix,
                config_hash=plan.config_hash, keep_last=0,
                meta={"chunk": c},
            )
            if tracer is not None:
                tracer.end(sspan)
        except checkpoint.SnapshotError:
            if tracer is not None:
                if sspan is not None:
                    tracer.end(sspan, error="snapshot")
                tracer.end(cspan, error="snapshot")
                tracer.end(run_span, status="error")
            raise  # a disk-integrity problem; retrying the chunk won't help.
        except Exception as e:  # noqa: BLE001 -- device errors have no
            # common base class (RuntimeError, torch.AcceleratorError, an
            # OSError from a snapshot write...).
            if tracer is not None:
                if sspan is not None and not sspan.ended:
                    tracer.end(sspan, error=f"{type(e).__name__}"[:80])
                tracer.end(cspan, error=f"{type(e).__name__}: {e}"[:160])
            if attempt >= max_retries:
                if tracer is not None:
                    tracer.end(run_span, status="error")
                raise
            attempt += 1
            retries_total += 1
            journal.append({
                "event": "retry", "chunk": c, "attempt": attempt,
                "error": f"{type(e).__name__}: {e}"[:300],
            })
            if metrics is not None:
                metrics.emit(
                    "retry", chunk=c, attempt=attempt,
                    error=f"{type(e).__name__}: {e}"[:300],
                )
            if tracer is not None:
                tracer.instant(trace_mod.RETRY, parent=run_span, chunk=c,
                               attempt=attempt)
            # Back onto the device each leaf was on, as a copy: the host
            # anchor stays untouched for a further retry.
            carry = tree_map(lambda h, t: h.to(t.device, copy=True),
                             carry_host, carry)
            carry = place(carry) if place is not None else carry
            continue
        except BaseException:
            # KeyboardInterrupt/SystemExit mid-chunk: end the open spans
            # (end() is idempotent) and re-raise.
            if tracer is not None:
                if sspan is not None and not sspan.ended:
                    tracer.end(sspan, error="interrupted")
                tracer.end(cspan, error="interrupted")
                tracer.end(run_span, status="interrupted")
            raise
        if tracer is not None:
            tracer.end(cspan, **({"rung": rung} if rung is not None
                                 else {}))
        journal.append({
            "event": "chunk", "chunk": c,
            "step_end": (c + 1) * plan.chunk_len,
            "carry_snapshot": os.path.basename(
                checkpoint.snapshot_path(plan.run_dir, c, plan.carry_prefix)
            ),
            "retries": attempt,
            # The rung this chunk ran at (guarded runs only).
            **({"rung": rung} if rung is not None else {}),
        })
        if metrics is not None:
            # The telemetry accumulator (if the carry threads one) is
            # cumulative over the run: the last chunk event holds the
            # whole run's summary; the logs digest covers this chunk only.
            tel = telemetry_mod.find_state(new_carry_host)
            metrics.emit(
                "chunk", chunk=c, wall_s=wall_s, retries=attempt,
                step_end=(c + 1) * plan.chunk_len,
                telemetry=export_mod.telemetry_event(tel),
                logs=_logs_digest(logs),
                **({"rung": rung} if rung is not None else {}),
            )
        logs_chunks.append(logs)
        carry = new_carry
        carry_host = new_carry_host  # boundary published: advance the anchor.
        c += 1
        attempt = 0
    journal.append({"event": "done", "chunks": plan.n_chunks})
    if metrics is not None:
        metrics.emit("done", chunks=plan.n_chunks)
    if tracer is not None:
        tracer.end(run_span, status="done", chunks=plan.n_chunks)
    return RunResult(
        carry=carry, logs=_logs_out(),
        status="done", chunks_done=plan.n_chunks,
        resumed_from_chunk=resumed_from_chunk,
        retries=retries_total,
    )


def _logs_digest(logs) -> dict | None:
    """Per-chunk log digest for the metrics export; None when the chunk's
    logs are not rollout logs (:func:`run_chunks` takes any chunk
    function)."""
    if not all(
        hasattr(logs, k)
        for k in ("fallback_rung", "solve_res", "min_env_dist",
                  "collision", "quarantined")
    ):
        return None
    return export_mod.logs_summary(logs)


def resume_run(
    run_dir: str,
    chunk_jit,
    initial_carry,
    *,
    config_hash: str | None = None,
    interrupt: GracefulInterrupt | None = None,
    place=None,
    max_retries: int = 0,
    metrics: export_mod.MetricsWriter | str | None = None,
    guard=None,
    journal_filename: str | None = None,
    to_host=None,
    max_start_chunk: int | None = None,
    tracer: trace_mod.Tracer | None = None,
    logs_spec=None,
) -> RunResult:
    """Resume a journaled run from its newest fully valid boundary.

    ``initial_carry`` is the chunk-0 carry regenerated deterministically
    from the journaled seed and meta (``run.init_carry(...)`` on a freshly
    built set-up); it is the template every carry snapshot is verified
    against and restored onto (its devices), and the restart point when
    no snapshot survives. ``logs_spec`` is the template of one chunk's
    logs, a tree (of tensors or ``TensorSpec`` leaves) or a function of
    ``initial_carry`` returning one; by default ``chunk_jit.logs_spec``
    (the chunked-rollout factories set it): the port has no shape-only
    evaluation of a chunk, and running one would cost a chunk.

    A resume point ``c`` is taken only when the carry snapshot of chunk
    ``c`` and the log snapshots of chunks ``0..c`` all pass their integrity
    and config checks; otherwise the walk falls back a boundary, and every
    rejected snapshot is journaled with its error in the ``resume`` event.
    ``config_hash`` (when given) must match the journaled one.
    ``max_start_chunk`` caps the resume point (every process of a
    multi-process run restarts from the same boundary);
    ``journal_filename``/``to_host``/``guard`` as in :func:`run_chunks`
    (a guarded resume starts again on the primary rung).

    Returns the result an uninterrupted run would have given, bit for
    bit: restored chunks contribute their stored logs, the remaining ones
    recompute from the restored carry."""
    plan = read_plan(run_dir, journal_filename=journal_filename)
    journal = RunJournal(run_dir, filename=journal_filename)
    if (config_hash is not None and plan.config_hash is not None
            and config_hash != plan.config_hash):
        raise checkpoint.SnapshotError(
            "config_mismatch", journal.path,
            f"journal config {plan.config_hash} != current {config_hash}: "
            "the run was started under a different configuration",
        )
    check_hash = config_hash if config_hash is not None else plan.config_hash
    if logs_spec is None:
        logs_spec = getattr(chunk_jit, "logs_spec", None)
        if logs_spec is None:
            raise ValueError(
                "resume_run needs the template of a chunk's logs: pass "
                "logs_spec= or a chunk with a .logs_spec (the chunked "
                "rollouts' run.chunk_jit has one)")
    logs_template = (logs_spec(initial_carry) if callable(logs_spec)
                     else logs_spec)

    # The resume boundary as a span: the walk over candidate snapshots is
    # recovery time, and the resumed run's spans parent under it.
    rspan = None
    if tracer is not None:
        rspan = tracer.begin(trace_mod.RESUME, parent=None, run_dir=run_dir)
    try:
        skipped: list[str] = []
        start_chunk = 0
        carry = initial_carry
        prior_logs: list = []
        for step, path in reversed(
            checkpoint.list_snapshots(run_dir, plan.carry_prefix)
        ):
            if max_start_chunk is not None and step + 1 > max_start_chunk:
                skipped.append(
                    f"[beyond_cap] {path}: boundary {step + 1} > agreed "
                    f"start cap {max_start_chunk} (peer processes lost it)"
                )
                continue
            try:
                cand, _ = checkpoint.load_snapshot(
                    path, initial_carry, config_hash=check_hash
                )
                cand_logs = []
                for lc in range(step + 1):
                    lpath = checkpoint.snapshot_path(
                        run_dir, lc, plan.logs_prefix
                    )
                    lg, _ = checkpoint.load_snapshot(
                        lpath, logs_template, config_hash=check_hash
                    )
                    cand_logs.append(lg)
            except checkpoint.SnapshotError as e:
                skipped.append(str(e))
                continue
            start_chunk = step + 1
            carry = cand
            prior_logs = cand_logs
            break
        journal.append({
            "event": "resume", "start_chunk": start_chunk,
            "skipped": skipped[:8],
        })
        if isinstance(metrics, str):
            metrics = export_mod.MetricsWriter(metrics)
        if metrics is not None:
            metrics.emit(
                "resume", start_chunk=start_chunk, skipped=skipped[:8]
            )
    except BaseException:
        # A failed walk (or Ctrl-C during it) must not leak the open span.
        if tracer is not None:
            tracer.end(rspan, error="interrupted")
        raise
    if tracer is not None:
        tracer.end(rspan, start_chunk=start_chunk, skipped=len(skipped))
    return run_chunks(
        plan, chunk_jit, carry, start_chunk=start_chunk,
        prior_logs=prior_logs, interrupt=interrupt, place=place,
        max_retries=max_retries, resumed_from_chunk=start_chunk,
        metrics=metrics, guard=guard, to_host=to_host, tracer=tracer,
        trace_parent=rspan,
    )
