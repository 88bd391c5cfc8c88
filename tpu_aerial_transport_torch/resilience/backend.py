"""Backend guard: error taxonomy, circuit breaker, deadline watchdogs and
structured failure for every interaction with the card.

The port's own copy of the JAX package's ``resilience/backend.py`` (the
port imports nothing of the JAX package, not even its stdlib-only
modules), with the same names, state machines, event rows and
``TAT_BACKEND_FAULTS`` grammar, and an error taxonomy of its own: the
texts that PyTorch, the CUDA runtime and the kernels' build raise.

- :func:`classify` / :class:`BackendError` -- the taxonomy
  (``init_unavailable`` / ``wedge_timeout`` / ``compile_error`` / ``oom``
  / ``device_crash`` / ``unknown``, and the guard's own
  ``topology_mismatch`` and ``bundle_stale``). The first pattern that
  matches wins; an unmatched ordinary exception is ``unknown``, a CODE bug
  that the guard re-raises instead of degrading around it.
- :class:`BackoffPolicy` -- exponential backoff with jitter.
- :class:`CircuitBreaker` -- closed -> open -> half-open: K consecutive
  classified failures open the circuit for a cooldown (work is refused
  without paying the deadline again); after the cooldown one half-open
  probe closes it or re-opens it with a longer cooldown.
- :func:`call_with_deadline` -- a thread deadline around one dispatch: a
  wedged card becomes ``BackendError("wedge_timeout")``. The thread
  cannot cancel a launch: the work already on the card runs on.
- :func:`probe_subprocess` -- cold CUDA initialisation and a first real
  dispatch (a matmul and a dtype round trip) in a watchdogged child
  process, with the visible device count checked against the expected
  topology (``torch.cuda.device_count()`` in the child).
- :class:`FaultInjector` -- the ``TAT_BACKEND_FAULTS`` hook that makes a
  wedge, an initialisation failure or a mid-run crash testable on any
  host, without provoking a real (sticky) CUDA error.
- :class:`BackendGuard` -- run work on the primary rung under a deadline,
  classify failures, trip the breaker and journal a ``backend_event``.
  Work on the card is never moved to the CPU: a classified failure of the
  card's work raises a :class:`BackendError` (the serving tier fails that
  chunk's requests with it; the chunk driver stops, to be resumed from
  its journal by a new process). Only a CPU-primary run re-runs a failed
  unit on the CPU rung, tagged ``cpu-tagged`` and journaled, as the JAX
  guard does on a host with no accelerator; nothing runs on the CPU
  because no card was found (``resolve_device`` raises, which classifies
  as ``unknown``).

A sticky CUDA error (an illegal address, a device-side assert) poisons the
process's CUDA context: every later CUDA call fails too, so the open
breaker turns the rest of the work away fast, and a new process is what
brings the card back.

Module contract: stdlib-only at module scope (torch is imported inside
the functions that need it), so tools can load the guard on hosts where
initialising CUDA is the hazard being watched.
"""

from __future__ import annotations

import dataclasses
import os
import random
import re
import signal
import subprocess
import sys
import threading
import time
import types

# ----------------------------------------------------------------------
# Error taxonomy.
# ----------------------------------------------------------------------

ERROR_KINDS = (
    "init_unavailable",   # the CUDA driver/runtime could not start.
    "topology_mismatch",  # the card answered, but fewer devices are
                          # visible than the expected topology.
    "wedge_timeout",      # accepted work, never answered.
    "compile_error",      # the kernels' build (nvcc/ptxas) failed.
    "dtype_lowering",     # kept for the JAX package's vocabulary: PyTorch
                          # has no lowering step, and a dtype an op lacks
                          # is a program bug (``unknown``).
    "oom",                # device memory exhausted.
    "device_crash",       # the runtime died mid-execution.
    "bundle_stale",       # an AOT bundle's fingerprint drifted (the AOT
                          # bundles are not ported yet; the kind stays so
                          # the two packages' rows share one vocabulary).
    "unknown",            # unclassified: a CODE bug, not infrastructure.
)

# Ordered: first match wins, in the JAX package's kind order. The guard's
# own structured reports (bundle_stale, topology_mismatch) lead, so the
# looser runtime patterns below cannot swallow them. init_unavailable
# precedes device_crash: "CUDA error: initialization error" is a failed
# start, not a crash.
_CLASSIFIERS: tuple[tuple[str, re.Pattern], ...] = (
    ("bundle_stale", re.compile(
        r"(?i)bundle[_ ]stale|stale bundle|bundle.*fingerprint")),
    ("topology_mismatch", re.compile(
        r"(?i)topology[_ ]mismatch|"
        r"visible \d+ of \d+ devices|\d+ of \d+ devices visible")),
    ("init_unavailable", re.compile(
        r"(?i)no CUDA GPUs are available|"
        r"CUDA driver initialization failed|cudaErrorNoDevice|"
        r"CUDA error: initialization error|"
        r"cudaErrorInitializationError")),
    ("wedge_timeout", re.compile(
        r"(?i)the launch timed out|cudaErrorLaunchTimeout|"
        r"exceeded the [\d.e+-]+s deadline|runtime wedged|"
        r"fault-injected wedge")),
    ("oom", re.compile(
        r"OutOfMemoryError|(?i:CUDA out of memory|"
        r"CUDA error: out of memory|cudaErrorMemoryAllocation)")),
    ("compile_error", re.compile(
        r"Error building extension|\bnvcc\b|\bptxas\b")),
    ("device_crash", re.compile(
        r"(?i)illegal memory access|misaligned address|"
        r"unspecified launch failure|device-side assert|"
        r"uncorrectable ECC|illegal instruction|cudaErrorIllegalAddress|"
        r"cudaErrorLaunchFailure")),
)


class BackendError(RuntimeError):
    """A classified backend failure. ``kind`` is one of
    :data:`ERROR_KINDS`; ``detail`` keeps the original message (truncated
    by emitters, not here)."""

    def __init__(self, kind: str, detail: str, backend: str = "unknown"):
        if kind not in ERROR_KINDS:
            raise ValueError(f"unknown BackendError kind {kind!r}")
        super().__init__(f"[{kind}] {detail}")
        self.kind = kind
        self.detail = detail
        self.backend = backend


def classify(exc_or_text) -> str:
    """Classify an exception (or message text) into an error kind.

    A :class:`BackendError` keeps its own kind. Anything else is matched,
    as ``"<TypeName>: <message>"``, against the ordered pattern table
    (``torch.OutOfMemoryError`` by its type name); an unmatched
    ``torch.AcceleratorError`` still counts as ``device_crash`` (the CUDA
    runtime itself raised -- a device problem whatever the text says),
    while an unmatched ordinary exception is ``unknown``: a CODE bug the
    guard must re-raise, not degrade around.
    """
    if isinstance(exc_or_text, BackendError):
        return exc_or_text.kind
    text = (str(exc_or_text) if not isinstance(exc_or_text, str)
            else exc_or_text)
    if not isinstance(exc_or_text, str):
        text = f"{type(exc_or_text).__name__}: {text}"
    for kind, pat in _CLASSIFIERS:
        if pat.search(text):
            return kind
    if not isinstance(exc_or_text, str) and \
            type(exc_or_text).__name__ == "AcceleratorError":
        return "device_crash"
    return "unknown"


# ----------------------------------------------------------------------
# Backoff policy.
# ----------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class BackoffPolicy:
    """Exponential backoff with jitter: attempt k (0-based) waits
    ``min(initial * factor**k, max) * (1 + jitter * U[-1, 1])``. Jitter
    decorrelates retriers sharing one card; pass a seeded ``rng`` for
    deterministic tests."""

    initial_s: float = 30.0
    factor: float = 2.0
    max_s: float = 600.0
    jitter: float = 0.1

    def delay(self, attempt: int, rng: random.Random | None = None) -> float:
        base = min(self.initial_s * self.factor ** max(attempt, 0),
                   self.max_s)
        if not self.jitter:
            return base
        u = (rng or random).uniform(-1.0, 1.0)
        return max(0.0, base * (1.0 + self.jitter * u))


# ----------------------------------------------------------------------
# Circuit breaker.
# ----------------------------------------------------------------------

CLOSED, OPEN, HALF_OPEN = "closed", "open", "half_open"


class CircuitBreaker:
    """Per-backend circuit breaker.

    closed --(K consecutive classified failures)--> open: primary work is
    refused (``allow()`` False) for a cooldown from the backoff policy.
    open --(cooldown elapsed)--> half_open: ONE probe call is allowed.
    half_open --success--> closed (failure count reset);
    half_open --failure--> open again with the NEXT (longer) cooldown.

    ``transitions`` records every state change (clock ts, from, to,
    reason); the guard journals them as ``backend_event`` rows.
    """

    def __init__(self, failure_threshold: int = 3,
                 policy: BackoffPolicy | None = None,
                 clock=time.monotonic,
                 rng: random.Random | None = None):
        if failure_threshold < 1:
            raise ValueError("failure_threshold must be >= 1")
        self.failure_threshold = failure_threshold
        self.policy = policy or BackoffPolicy()
        self._clock = clock
        self._rng = rng or random.Random()
        self.state = CLOSED
        self.consecutive_failures = 0
        self.open_count = 0          # how many times the circuit opened.
        self.opened_at: float | None = None
        self.cooldown_s: float = 0.0
        self.transitions: list[dict] = []

    def _transition(self, to: str, reason: str) -> None:
        if to == self.state:
            return
        self.transitions.append({
            "ts": self._clock(), "from": self.state, "to": to,
            "reason": reason,
        })
        self.state = to

    def allow(self) -> bool:
        """May primary work run now? OPEN + cooldown elapsed flips to
        HALF_OPEN (the caller's next run() is the probe)."""
        if self.state == OPEN:
            if self._clock() - self.opened_at >= self.cooldown_s:
                self._transition(HALF_OPEN, "cooldown elapsed")
                return True
            return False
        return True

    def seconds_until_half_open(self) -> float:
        if self.state != OPEN:
            return 0.0
        return max(0.0, self.cooldown_s - (self._clock() - self.opened_at))

    def record_success(self) -> None:
        self.consecutive_failures = 0
        if self.state in (HALF_OPEN, OPEN):
            self._transition(CLOSED, "probe succeeded")

    def record_failure(self, kind: str) -> None:
        self.consecutive_failures += 1
        if self.state == HALF_OPEN:
            self._open(f"half-open probe failed ({kind})")
        elif (self.state == CLOSED
              and self.consecutive_failures >= self.failure_threshold):
            self._open(
                f"{self.consecutive_failures} consecutive failures "
                f"(last: {kind})"
            )

    def _open(self, reason: str) -> None:
        self.cooldown_s = self.policy.delay(self.open_count, self._rng)
        self.open_count += 1
        self.opened_at = self._clock()
        self._transition(OPEN, reason)


# ----------------------------------------------------------------------
# Deadline watchdog (in-process dispatch).
# ----------------------------------------------------------------------

def call_with_deadline(fn, timeout_s: float | None, label: str = ""):
    """Run ``fn()`` under a thread deadline: a wedged card becomes a
    structured ``BackendError("wedge_timeout")`` after ``timeout_s``
    instead of a hung process. ``fn`` must wait for its device work
    (``torch.cuda.synchronize`` or a host copy), or a wedge inside the
    runtime would escape the watchdog.

    The worker thread cannot be killed and cannot cancel a launch: on
    timeout it is abandoned as a daemon, the work already on the card runs
    on, and the CALLER must not touch the card again except through the
    circuit breaker. ``timeout_s`` None/<=0 disables the watchdog (a plain
    call).
    """
    if not timeout_s or timeout_s <= 0:
        return fn()
    result: list = []
    error: list = []

    def worker():
        try:
            result.append(fn())
        except BaseException as e:  # noqa: BLE001 -- forwarded to caller.
            error.append(e)

    t = threading.Thread(target=worker, daemon=True,
                         name=f"backend-guard-{label or 'call'}")
    t.start()
    t.join(timeout_s)
    if t.is_alive():
        raise BackendError(
            "wedge_timeout",
            f"{label or 'call'} exceeded the {timeout_s:g}s deadline "
            "(runtime wedged; worker thread abandoned)",
        )
    if error:
        raise error[0]
    return result[0]


# ----------------------------------------------------------------------
# Subprocess probe (cold CUDA init + first real dispatch).
# ----------------------------------------------------------------------

FAULTS_ENV = "TAT_BACKEND_FAULTS"
DEADLINE_ENV = "TAT_BACKEND_DEADLINE_S"
# Expected topology (ints): when set, probe_subprocess compares the visible
# device/process counts against them, and a shortfall fails the probe with
# a classified topology_mismatch.
EXPECTED_DEVICES_ENV = "TAT_EXPECTED_DEVICES"
EXPECTED_PROCESSES_ENV = "TAT_EXPECTED_PROCESSES"


def _probe_code(device: str = "cuda") -> str:
    """The probe's program: initialise ``device``, run a real matmul and an
    explicit float32 -> bfloat16 -> float32 round trip, and print the
    positional token line
    ``BACKEND_OK <platform> <n_devices> <n_processes> <checksum>`` with
    ``torch.cuda.device_count()`` as the device count on the card."""
    return (
        "import torch\n"
        f"dev = torch.device({device!r})\n"
        "n = torch.cuda.device_count() if dev.type == 'cuda' else 1\n"
        "x = torch.ones((128, 128), dtype=torch.float32, device=dev)\n"
        "y = (x @ x).to(torch.bfloat16)\n"
        "s = float(y.to(torch.float32).sum())\n"
        "print('BACKEND_OK', dev.type, n, 1, s)\n"
    )


def run_group(cmd: list[str], timeout_s: float,
              env: dict | None = None, cwd: str | None = None):
    """Run ``cmd`` in its OWN session and, on timeout, SIGKILL the whole
    process group before re-raising ``subprocess.TimeoutExpired``
    (``subprocess.run(timeout=...)`` kills only the direct child, and an
    orphaned grandchild may keep holding the card). Returns a
    ``(returncode, stdout, stderr)`` namespace like
    ``subprocess.run(capture_output=True, text=True)``.
    """
    proc = subprocess.Popen(
        cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=dict(env or os.environ), cwd=cwd, start_new_session=True,
    )
    try:
        out, err = proc.communicate(timeout=timeout_s)
    except subprocess.TimeoutExpired:
        try:
            os.killpg(proc.pid, signal.SIGKILL)
        except (ProcessLookupError, PermissionError):
            proc.kill()
        proc.wait()
        raise
    return types.SimpleNamespace(
        returncode=proc.returncode, stdout=out, stderr=err
    )


def _expected_topology(env: dict | None) -> tuple[int | None, int | None]:
    """(expected_devices, expected_processes) from the env knobs; None
    means "no expectation". Garbage values raise: a typo silently
    disabling the topology gate would fake a green probe."""
    src = env or os.environ
    out = []
    for key in (EXPECTED_DEVICES_ENV, EXPECTED_PROCESSES_ENV):
        raw = src.get(key, "")
        if not raw:
            out.append(None)
            continue
        try:
            out.append(int(raw))
        except ValueError:
            raise ValueError(f"{key}={raw!r} is not an integer") from None
    return out[0], out[1]


def probe_subprocess(timeout_s: float = 60.0,
                     env: dict | None = None,
                     bundle_dir: str | None = None,
                     expect_devices: int | None = None,
                     expect_processes: int | None = None,
                     info: dict | None = None,
                     device: str = "cuda") -> tuple[bool, str]:
    """Watchdogged subprocess probe of cold CUDA initialisation and a first
    dispatch: ``(True, platform)`` when the computation ran, ``(False,
    detail)`` otherwise. A child process, because a wedged initialisation
    cannot be interrupted in-process (the thread watchdog can only abandon
    it).

    ``expect_devices`` / ``expect_processes`` (default: the
    :data:`EXPECTED_DEVICES_ENV` / :data:`EXPECTED_PROCESSES_ENV` env
    vars) arm the topology gate: the probe reports the visible counts
    (``info``, when passed, receives ``platform`` / ``n_devices`` /
    ``n_processes``) and a count BELOW the expectation fails the probe
    with a ``topology_mismatch``-classified detail; a surplus passes.
    ``device="cpu"`` probes the host (the CPU tests' form).

    ``bundle_dir`` (an AOT bundle to warm from) raises
    ``NotImplementedError``: the AOT bundles are not ported yet (ROADMAP,
    Queue 1, the ``aot/`` item).

    Honors :class:`FaultInjector`: an ``init_unavailable`` directive fails
    the probe fast, in-process.
    """
    if bundle_dir is not None:
        raise NotImplementedError(
            "probe_subprocess(bundle_dir=): the AOT bundles are not ported "
            "yet (ROADMAP Queue 1, the aot/ item)")
    inj = FaultInjector.from_env(
        (env or os.environ).get(FAULTS_ENV, ""))
    if inj.init_unavailable:
        return False, (
            "fault-injected: CUDA driver initialization failed "
            "(TAT_BACKEND_FAULTS=init_unavailable)"
        )
    env_devices, env_processes = _expected_topology(env)
    if expect_devices is None:
        expect_devices = env_devices
    if expect_processes is None:
        expect_processes = env_processes
    try:
        proc = run_group(
            [sys.executable, "-c", _probe_code(device)], timeout_s, env=env,
        )
    except subprocess.TimeoutExpired:
        return False, (
            f"timeout after {timeout_s:g}s (card unreachable/wedged)"
        )
    token = [ln for ln in proc.stdout.splitlines()
             if ln.startswith("BACKEND_OK")]
    if proc.returncode == 0 and token:
        # BACKEND_OK platform n_devices n_processes checksum [notes...]
        parts = token[0].split()
        n_dev, n_proc = int(parts[2]), int(parts[3])
        if info is not None:
            info.update(
                platform=parts[1], n_devices=n_dev, n_processes=n_proc,
            )
        want_dev = n_dev if expect_devices is None else expect_devices
        want_proc = n_proc if expect_processes is None else expect_processes
        if n_dev < want_dev or n_proc < want_proc:
            return False, (
                f"topology_mismatch: visible {n_dev} of {want_dev} devices, "
                f"{n_proc} of {want_proc} processes on {parts[1]}: refusing "
                "to run an undersized topology"
            )
        return True, parts[1]
    tail = (proc.stderr or proc.stdout).strip().splitlines()[-3:]
    return False, f"probe rc={proc.returncode}: " + " | ".join(tail)


# ----------------------------------------------------------------------
# Fault injection (test hook; env-triggered fake backend).
# ----------------------------------------------------------------------

@dataclasses.dataclass
class FaultInjector:
    """Parsed ``TAT_BACKEND_FAULTS`` directives. Comma-separated:

    - ``init_unavailable`` -- the subprocess probe fails fast, as if the
      CUDA driver could not initialise;
    - ``wedge=S`` -- every guarded PRIMARY call sleeps ``S`` seconds
      before running (exceeding the deadline => a ``wedge_timeout``);
    - ``crash@N`` -- the N-th (1-based) guarded primary call raises a fake
      ``CUDA error: unspecified launch failure`` (a mid-run crash), before
      any device work: the process's CUDA context stays healthy;
    - ``crash@LABEL`` -- primary calls whose label contains ``LABEL``
      raise it instead.

    Injection applies ONLY to the primary rung: the CPU rung always runs
    clean, so a fault-injected run still produces real (tagged) results.
    Parsing is strict: an unknown directive raises, because a typo
    silently disabling fault injection would fake a green test.
    """

    init_unavailable: bool = False
    wedge_s: float = 0.0
    crash_at: int = 0
    crash_label: str = ""
    calls: int = 0

    @classmethod
    def from_env(cls, spec: str | None = None) -> "FaultInjector":
        if spec is None:
            spec = os.environ.get(FAULTS_ENV, "")
        inj = cls()
        for raw in (spec or "").split(","):
            d = raw.strip()
            if not d:
                continue
            if d == "init_unavailable":
                inj.init_unavailable = True
            elif d.startswith("wedge="):
                inj.wedge_s = float(d.split("=", 1)[1])
            elif d.startswith("crash@"):
                tag = d.split("@", 1)[1]
                if tag.isdigit():
                    inj.crash_at = int(tag)
                else:
                    inj.crash_label = tag
            else:
                raise ValueError(
                    f"unknown {FAULTS_ENV} directive {d!r} (known: "
                    "init_unavailable, wedge=S, crash@N, crash@LABEL)"
                )
        return inj

    @property
    def active(self) -> bool:
        return bool(self.init_unavailable or self.wedge_s
                    or self.crash_at or self.crash_label)

    def maybe_fault(self, label: str = "") -> None:
        """Called by the guard before every primary execution."""
        self.calls += 1
        if self.crash_at and self.calls == self.crash_at:
            raise RuntimeError(
                f"CUDA error: unspecified launch failure (fault-injected "
                f"at call {self.calls}, label {label!r})"
            )
        if self.crash_label and self.crash_label in label:
            raise RuntimeError(
                f"CUDA error: unspecified launch failure (fault-injected "
                f"on label {label!r})"
            )
        if self.wedge_s:
            time.sleep(self.wedge_s)
            # The watchdog abandoned this worker long ago (deadline <
            # wedge); raising here makes the abandoned thread exit without
            # running device work inside a dying interpreter. If the
            # deadline outlasted the sleep, the raise is the wedge
            # surfacing.
            raise BackendError(
                "wedge_timeout",
                f"fault-injected wedge ({self.wedge_s:g}s) on {label!r}",
            )


# ----------------------------------------------------------------------
# The guard.
# ----------------------------------------------------------------------

# Rung vocabulary (the JAX package's): where a unit ACTUALLY ran.
# "on-chip" is the card, "cpu-tagged" the CPU (a CPU-primary run and its
# fallback; a valid result on the host, never published as a card number).
RUNG_ONCHIP = "on-chip"
RUNG_CPU = "cpu-tagged"

# Error kinds that indict the BACKEND (and count toward opening the
# circuit). compile_error / dtype_lowering are PROGRAM bugs and
# bundle_stale a build-artifact bug: the failing unit still fails (or, in
# a CPU-primary run, re-runs on the CPU rung), but build failures on a
# healthy card must not open the circuit on the rest of the work.
BREAKER_KINDS = frozenset(
    {"init_unavailable", "topology_mismatch", "wedge_timeout",
     "device_crash", "oom"}
)

# Default deadline for one guarded unit (one recovery chunk, one served
# chunk). Generous because a FIRST execution includes the kernels' load
# and the CUDA-graph capture; override per guard or with
# TAT_BACKEND_DEADLINE_S.
DEFAULT_DEADLINE_S = 600.0


def default_deadline_s(env: dict | None = None) -> float:
    raw = (env or os.environ).get(DEADLINE_ENV, "")
    try:
        return float(raw) if raw else DEFAULT_DEADLINE_S
    except ValueError:
        raise ValueError(f"{DEADLINE_ENV}={raw!r} is not a number")


class BackendGuard:
    """Run units of card work so that a flaky, wedged or absent runtime
    fails a unit with a structured, journaled error instead of hanging or
    killing the run.

    ``run(label, primary_fn, fallback_fn)``:

    1. circuit OPEN (cooldown pending) -> skip the primary entirely: a
       CPU-primary run takes the fallback, tagged ``cpu-tagged`` (one
       ``backend_event`` records the routing); work on the card raises
       ``BackendError("wedge_timeout")``;
    2. otherwise run ``primary_fn`` under the deadline watchdog (fault
       injection applies here), ``record_success`` and return the primary
       rung;
    3. a CLASSIFIED failure (anything but ``unknown``) records into the
       breaker and journals a ``backend_event``; then a CPU-primary run
       re-runs on the fallback, and work on the card raises the failure
       as a :class:`BackendError` of its kind. An ``unknown`` failure
       re-raises as it is: that is a code bug.

    ``fallback_fn`` is taken only when the primary rung is ``cpu-tagged``:
    the card's work is never moved to the CPU, whatever the caller passes
    (the JAX guard's CPU rung under an accelerator is not ported; ROADMAP
    Queue 1). ``primary_rung`` names the rung the primary runs at:
    ``"on-chip"`` for work on the card, ``"cpu-tagged"`` for a CPU-primary
    run (no higher rung to fall from); None resolves it lazily from
    ``torch.cuda.is_available()``, inside the watchdog on the healthy
    path. ``emit`` duck-types
    over an ``obs.export.MetricsWriter`` (``metrics``) and a
    ``resilience.recovery.RunJournal`` (``journal``), either or both None;
    ``events`` always records in-process. ``tracer`` (an
    ``obs.trace.Tracer``) wraps the primary in a ``guard_dispatch`` span
    and a degradation in a ``guard_fallback`` span; ``hub`` (an
    ``obs.live.MetricsHub``) counts the guarded runs and the backend events
    when given.
    """

    def __init__(self, *,
                 deadline_s: float | None = None,
                 breaker: CircuitBreaker | None = None,
                 faults: FaultInjector | None = None,
                 metrics=None,
                 journal=None,
                 tracer=None,
                 primary_rung: str | None = None,
                 clock=time.monotonic,
                 hub=None):
        self.deadline_s = (default_deadline_s() if deadline_s is None
                           else deadline_s)
        self.breaker = breaker or CircuitBreaker()
        self.faults = faults if faults is not None \
            else FaultInjector.from_env()
        self.metrics = metrics
        self.journal = journal
        self.tracer = tracer
        self.hub = hub
        self._primary_rung = primary_rung
        self._clock = clock
        self.events: list[dict] = []
        # Did the LAST run() return a fallback result? (Callers on a
        # CPU-primary host cannot tell from the rung alone.)
        self.last_fell_back = False
        self.fallbacks = 0
        self._seen_transitions = 0

    @property
    def primary_rung(self) -> str:
        """Lazy: "cpu-tagged" when the process has no card (a CPU run has
        no higher rung to fall from), "on-chip" otherwise. Resolving it
        initialises CUDA, which can wedge on a sick runtime, so ``run()``
        resolves it only inside the deadline watchdog; a caller that knows
        its device passes ``primary_rung`` and never pays it."""
        if self._primary_rung is None:
            import torch

            self._primary_rung = (
                RUNG_ONCHIP if torch.cuda.is_available() else RUNG_CPU
            )
        return self._primary_rung

    def emit(self, kind: str, label: str, **fields) -> dict:
        event = {"kind": kind, "label": label, **fields}
        self.events.append(event)
        if self.journal is not None:
            self.journal.append({"event": "backend_event", **event})
        if self.metrics is not None:
            self.metrics.emit("backend_event", **event)
        if self.hub is not None:
            self.hub.ingest_backend(event)
        return event

    def _emit_transitions(self, label: str) -> None:
        """Journal breaker transitions that happened since the last emit
        (allow() can transition without a failure being recorded)."""
        new = self.breaker.transitions[self._seen_transitions:]
        self._seen_transitions = len(self.breaker.transitions)
        for t in new:
            self.emit("circuit_" + t["to"], label, reason=t["reason"])

    def _on_cpu(self, rung: str | None) -> bool:
        """Does this unit's primary run on the CPU (so that its fallback,
        the CPU rung, moves nothing off the card)?"""
        return (rung or self.primary_rung) == RUNG_CPU

    def _run_fallback(self, fallback_fn, label: str, trace_parent,
                      **attrs):
        """Run the CPU fallback, wrapped in a "guard_fallback" span when
        tracing (the critical-path accountant's "retry" segment)."""
        self.last_fell_back = True
        self.fallbacks += 1
        if self.tracer is None:
            return fallback_fn()
        fspan = self.tracer.begin(
            "guard_fallback", parent=trace_parent, label=label,
            rung=RUNG_CPU, **attrs,
        )
        try:
            return fallback_fn()
        finally:
            self.tracer.end(fspan)

    def run(self, label: str, primary_fn, fallback_fn=None, *,
            rung: str | None = None, deadline_s: float | None = None,
            trace_parent=None):
        """Execute one unit. Returns ``(value, rung_it_ran_at)``.

        ``trace_parent`` (an ``obs.trace.Span`` or None) parents the
        guard's spans under the caller's span: the serving tier passes its
        ``chunk_dispatch`` span, the chunk driver its ``chunk`` span."""
        deadline = self.deadline_s if deadline_s is None else deadline_s
        self.last_fell_back = False
        if self.hub is not None:
            self.hub.inc("guard.runs")
        allowed = self.breaker.allow()
        self._emit_transitions(label)
        if not allowed:
            wait_s = self.breaker.seconds_until_half_open()
            if fallback_fn is None or not self._on_cpu(rung):
                raise BackendError(
                    "wedge_timeout",
                    f"circuit open ({wait_s:.0f}s to half-open) and no "
                    f"fallback for {label!r}",
                )
            self.emit(
                "circuit_routed_cpu", label, rung=RUNG_CPU,
                detail=f"circuit open; {wait_s:.0f}s to half-open",
            )
            return self._run_fallback(
                fallback_fn, label, trace_parent, circuit="open",
            ), RUNG_CPU

        gspan = None
        if self.tracer is not None:
            gspan = self.tracer.begin(
                "guard_dispatch", parent=trace_parent, label=label,
            )
        try:
            def _primary():
                self.faults.maybe_fault(label)
                # Rung resolution inside the watchdog: it may be the
                # process's first CUDA initialisation.
                return primary_fn(), (rung or self.primary_rung)

            value, primary_rung = call_with_deadline(
                _primary, deadline, label=label
            )
        except BaseException as e:
            if not isinstance(e, Exception):
                # KeyboardInterrupt/SystemExit inside the watchdogged
                # dispatch: end the span (idempotent) and re-raise
                # unclassified.
                if gspan is not None:
                    self.tracer.end(gspan, kind="interrupted")
                raise
            kind = classify(e)
            if gspan is not None:
                self.tracer.end(
                    gspan, kind=kind,
                    rung=rung or self._primary_rung or "unresolved",
                    detail=f"{type(e).__name__}: {e}"[:160],
                )
            if kind == "unknown":
                raise  # a code bug; degrading would only hide it.
            if kind in BREAKER_KINDS:
                self.breaker.record_failure(kind)
            self.emit(
                kind, label,
                rung=rung or self._primary_rung or "unresolved",
                detail=f"{type(e).__name__}: {e}"[:300],
                circuit=self.breaker.state,
            )
            self._emit_transitions(label)
            if fallback_fn is None or not self._on_cpu(rung):
                if isinstance(e, BackendError):
                    raise
                raise BackendError(kind, f"{type(e).__name__}: {e}"[:300]) \
                    from e
            return self._run_fallback(
                fallback_fn, label, trace_parent, after=kind,
            ), RUNG_CPU
        self.breaker.record_success()
        self._emit_transitions(label)
        if gspan is not None:
            self.tracer.end(gspan, rung=primary_rung)
        return value, primary_rung


def run_on_cpu(fn):
    """A fallback thunk running ``fn`` with the CPU as PyTorch's default
    device: tensors ``fn`` creates without a device land on the host. The
    standard ``fallback_fn`` for :meth:`BackendGuard.run`, which takes it
    only in a CPU-primary run."""
    def thunk():
        import torch

        with torch.device("cpu"):
            return fn()

    return thunk
