"""Bounded admission queue with per-request SLO accounting.

The port's own copy of the JAX package's ``serving/queue.py`` (the same
requests, statuses, structured rejection reasons and ``serving_event``
rows, field for field; the port imports nothing of the JAX package).

Requests are heterogeneous (:class:`ScenarioRequest`: family = a
registered (controller, n, chunk shape) program, horizon, scenario
parameters, deadline); admission control REJECTS with a structured reason
— never an exception into the server loop — when the queue is full, when
the request's family has no compiled-bucket coverage, or when the request
cannot be served as specified (horizon off the chunk grid, deadline
already spent). Every transition lands as a ``serving_event`` metrics
row (``obs.export`` schema v4 and later) so a reader can render
admit→complete latency percentiles and rejection/deadline-miss counts
without instrumenting the caller.

The SLO clock per request::

    t_submit --(queue)--> t_admit --(lane wait)--> t_launch --> t_complete
                 |                                        |
                 +-- deadline passes: missed "in_queue"   +-- "in_flight"

``t_admit`` is when the request entered a device batch lane (at a batch
launch or a later chunk boundary — the continuous-batching seam);
``t_launch`` is the first chunk dispatch that contained it.
"""

from __future__ import annotations

import dataclasses
import itertools
import threading
import time

import numpy as np

from tpu_aerial_transport_torch.obs import trace as trace_mod

# Statuses a ticket resolves to.
PENDING = "pending"
COMPLETED = "completed"
REJECTED = "rejected"
DEADLINE_MISSED = "deadline_missed"
# The port's own: the request's chunk failed on the card (a classified
# backend error, its kind the ticket's reason; serving/server.py). The JAX
# server reruns such a chunk on the CPU instead.
FAILED = "failed"

# Structured rejection reasons (admission control).
REASON_QUEUE_FULL = "queue_full"
REASON_NO_COVERAGE = "no_bucket_coverage"
REASON_BAD_HORIZON = "horizon_not_chunk_aligned"
REASON_DEADLINE_SPENT = "deadline_already_passed"
REASON_TENANT_RATE = "tenant_rate_limited"
# Closed-loop session tier (serving/sessions.py) — same structured
# reject-with-reason discipline, resolved BEFORE any server interaction:
# a zombie client presenting a fenced (stale) lease token, and an
# out-of-order / replayed step_seq.
REASON_LEASE_FENCED = "lease_fenced"
REASON_STALE_STEP = "stale_step"

DEFAULT_TENANT = "default"

# Deadline-miss classification.
MISSED_IN_QUEUE = "in_queue"
MISSED_IN_FLIGHT = "in_flight"

_req_counter = itertools.count()


@dataclasses.dataclass(frozen=True)
class ScenarioRequest:
    """One scenario-MPC job. ``family`` names a server-registered program
    family (controller + n + chunk shape); ``horizon`` is the requested
    high-level step count (must be a multiple of the family's chunk
    length — chunk boundaries are the only admission/harvest seams);
    ``x0``/``v0`` are the scenario's initial payload position/velocity;
    ``deadline_s`` is a wall-clock budget relative to submission (None =
    no deadline)."""

    family: str
    horizon: int
    x0: tuple = (0.0, 0.0, 0.0)
    v0: tuple = (0.0, 0.0, 0.0)
    deadline_s: float | None = None
    request_id: str = dataclasses.field(
        default_factory=lambda: f"req{next(_req_counter):06d}"
    )
    # Multi-tenant admission: the tenant the
    # request bills against — rate limits, weighted-fair dequeue share
    # and priority class come from the queue's per-tenant policy table,
    # never from the (client-controlled) request itself.
    tenant: str = DEFAULT_TENANT
    # Distributed-tracing context (obs.trace): clients propagating an
    # upstream trace set it; otherwise admission mints one when the
    # server runs a tracer. Journaled with the request so a resumed
    # run's spans land on the SAME trace as the preempted run's.
    trace_id: str | None = None
    # Closed-loop session tier (serving/sessions.py): the owning
    # session_id when this request is one delta-state step of a live
    # session, None for one-shot requests. Session steps are NEVER
    # served from (or written into) the content-addressed result cache
    # — the cache key is the full (family, x0/v0, horizon) content
    # address, but a step's identity includes its session and step_seq,
    # and serving it from cache would skip the lane write the session's
    # state stream is defined by. Journaled so resume keeps the step's
    # session binding.
    session: str | None = None

    def to_json(self) -> dict:
        return {
            "request_id": self.request_id,
            "family": self.family,
            "horizon": int(self.horizon),
            "x0": [float(v) for v in np.asarray(self.x0).reshape(-1)],
            "v0": [float(v) for v in np.asarray(self.v0).reshape(-1)],
            "deadline_s": (None if self.deadline_s is None
                           else float(self.deadline_s)),
            **({"trace_id": self.trace_id} if self.trace_id else {}),
            **({"tenant": self.tenant}
               if self.tenant != DEFAULT_TENANT else {}),
            **({"session": self.session} if self.session else {}),
        }

    @classmethod
    def from_json(cls, obj: dict) -> "ScenarioRequest":
        return cls(
            family=obj["family"], horizon=obj["horizon"],
            x0=tuple(obj["x0"]), v0=tuple(obj["v0"]),
            deadline_s=obj.get("deadline_s"),
            request_id=obj["request_id"],
            trace_id=obj.get("trace_id"),
            tenant=obj.get("tenant", DEFAULT_TENANT),
            session=obj.get("session"),
        )


@dataclasses.dataclass
class SLO:
    """Per-request SLO record: host timestamps (``clock`` domain — the
    server's monotonic clock by default) plus the deadline bookkeeping."""

    t_submit: float | None = None
    t_admit: float | None = None
    t_launch: float | None = None
    t_complete: float | None = None
    deadline_at: float | None = None  # absolute, clock domain.
    missed: str | None = None         # MISSED_IN_QUEUE / MISSED_IN_FLIGHT.

    def to_event(self) -> dict:
        out = {k: v for k, v in dataclasses.asdict(self).items()
               if v is not None}
        if self.t_complete is not None and self.t_submit is not None:
            out["latency_s"] = self.t_complete - self.t_submit
        if self.t_complete is not None and self.t_admit is not None:
            out["admit_to_complete_s"] = self.t_complete - self.t_admit
        return out


class Ticket:
    """The caller's handle for a submitted request: status, SLO record,
    and (on completion) the request's final scenario state as a host tree
    of CPU tensors. ``wait()`` blocks a consumer thread until resolution
    -- the async side of the host pipeline; the server itself never blocks
    on tickets, and a waiting thread touches no CUDA state (the result is
    already on the host when the ticket resolves)."""

    def __init__(self, request: ScenarioRequest):
        self.request = request
        self.slo = SLO()
        self.status = PENDING
        self.reason: str | None = None
        self.result = None        # host tree: the lane's final state.
        self.steps_served = 0
        self.batch_id: int | None = None
        self.lane: int | None = None
        # obs.trace.RequestTrace when the server runs a tracer; None is
        # the zero-cost path (every consumer guards on it).
        self.trace: trace_mod.RequestTrace | None = None
        self._done = threading.Event()

    @property
    def done(self) -> bool:
        return self.status != PENDING

    def wait(self, timeout: float | None = None) -> bool:
        return self._done.wait(timeout)

    def _resolve(self, status: str, reason: str | None = None) -> None:
        self.status = status
        self.reason = reason
        self._done.set()

    def __repr__(self) -> str:  # operator-facing.
        return (f"Ticket({self.request.request_id}, {self.status}"
                + (f", {self.reason}" if self.reason else "") + ")")


@dataclasses.dataclass(frozen=True)
class TenantPolicy:
    """Admission policy for one tenant.

    ``rate_per_s``/``burst`` parameterize a token bucket: each submit
    spends one token, tokens refill continuously at ``rate_per_s`` up to
    ``burst``; an empty bucket rejects with the structured
    ``tenant_rate_limited`` reason (never an exception in the front
    loop). ``rate_per_s=None`` disables the bucket (the default tenant's
    policy, so single-tenant callers see the single-tenant behavior
    byte-for-byte). ``weight`` is the tenant's weighted-fair dequeue
    share WITHIN its priority class; ``priority`` classes dequeue
    strictly high-to-low (an operator tier that must not queue behind
    batch traffic — starvation of lower classes is the documented
    trade)."""

    rate_per_s: float | None = None
    burst: int = 8
    weight: float = 1.0
    priority: int = 0


class _TokenBucket:
    """Continuous-refill token bucket on the queue's clock domain."""

    def __init__(self, policy: TenantPolicy, now: float):
        self.rate = float(policy.rate_per_s)
        self.capacity = max(1.0, float(policy.burst))
        self.tokens = self.capacity
        self.t_last = now

    def try_take(self, now: float) -> bool:
        self.tokens = min(self.capacity,
                          self.tokens + self.rate * (now - self.t_last))
        self.t_last = now
        if self.tokens >= 1.0:
            self.tokens -= 1.0
            return True
        return False


class AdmissionQueue:
    """Bounded multi-tenant queue with admission control.

    ``coverage`` maps a family name to its served chunk length (``int``)
    or ``None`` when the family has no coverage (an unknown family); the
    server supplies it so the queue never imports device code. ``emit``
    is the server's ``serving_event`` sink (may be None).

    ``tenants`` maps tenant names to :class:`TenantPolicy`; tenants not
    in the table get the default policy (unlimited rate, weight 1,
    priority 0), so the single-tenant path is unchanged. ``submit`` is
    thread-safe (one lock over queue state; ticket ids come from a
    process-global counter), the concurrent-submitter
    contract."""

    def __init__(self, coverage, capacity: int = 256,
                 clock=time.monotonic, emit=None, tracer=None,
                 tenants: dict[str, TenantPolicy] | None = None,
                 hub=None):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.coverage = coverage
        self.capacity = capacity
        self.clock = clock
        # `is None`, not truthiness: a falsy-but-callable sink (a Mock,
        # a partial with no __bool__ guarantee) must still be used.
        self.emit = (lambda **kw: None) if emit is None else emit
        self.tracer = tracer  # obs.trace.Tracer | None (zero-cost off).
        # obs.live.MetricsHub | None: live counters/gauges for the
        # console. None is the zero-cost path — every touch is guarded
        # `is not None` and allocates nothing.
        self.hub = hub
        self.tenants = dict(tenants or {})
        self._default_policy = TenantPolicy()
        self._buckets: dict[str, _TokenBucket] = {}
        # family -> tenant -> FIFO (arrival order within a tenant; the
        # cross-tenant order is weighted-fair at take() time).
        self._pending: dict[str, dict[str, list[Ticket]]] = {}
        # Weighted-fair bookkeeping: dequeues charged per (family,
        # tenant), normalized by weight at selection time.
        self._served: dict[tuple[str, str], float] = {}
        self._lock = threading.Lock()

    def policy(self, tenant: str) -> TenantPolicy:
        return self.tenants.get(tenant, self._default_policy)

    # ------------------------------------------------------ admission --
    def submit(self, request: ScenarioRequest) -> Ticket:
        """Admit or reject one request. ALWAYS returns a resolved-or-
        pending ticket (rejection is a structured status + reason +
        ``serving_event``, never an exception). Safe to call from
        multiple threads concurrently."""
        if self.tracer is not None and request.trace_id is None:
            # Mint the trace context ON the request so journal replays /
            # resumes keep the same trace identity.
            request = dataclasses.replace(
                request, trace_id=trace_mod.new_trace_id()
            )
        ticket = Ticket(request)
        with self._lock:
            now = self.clock()
            ticket.slo.t_submit = now
            if request.deadline_s is not None:
                ticket.slo.deadline_at = now + float(request.deadline_s)
            if self.tracer is not None:
                root = self.tracer.begin(
                    trace_mod.REQUEST, parent=None,
                    trace_id=request.trace_id,
                    request_id=request.request_id, family=request.family,
                    horizon=int(request.horizon),
                )
                ticket.trace = trace_mod.RequestTrace(self.tracer, root)

            reason = self._admission_reason(request, now)
            if reason is None:
                if ticket.trace is not None:
                    ticket.trace.queue_span = self.tracer.begin(
                        trace_mod.QUEUE_WAIT,
                        parent=ticket.trace.request_span,
                        request_id=request.request_id,
                        family=request.family,
                    )
                self._pending.setdefault(request.family, {}).setdefault(
                    request.tenant, []
                ).append(ticket)
            depth = self._depth()
        # Emit + trace-resolve AFTER release: the metrics sink
        # fsyncs per event and span ends write trace rows — holding the
        # admission lock across those syscalls would serialize every
        # concurrent submitter behind disk. Resolving the rejected
        # ticket out here is safe: it was never appended to the pending
        # FIFO, so no other thread can reach it until submit returns.
        if reason is not None:
            ticket._resolve(REJECTED, reason)
            self.emit(kind="rejected", request_id=request.request_id,
                      family=request.family, reason=reason,
                      tenant=request.tenant, depth=depth)
            if self.hub is not None:
                # Hub updates AFTER the lock too: the hub's own leaf
                # lock is lock-free dict math, but keeping every
                # observability side effect on one side of the
                # admission lock keeps the locking reasoning local.
                self.hub.inc("queue.rejected", key=reason)
                self.hub.gauge("queue.depth", depth)
            if ticket.trace is not None:
                # Terminal span: the rejection IS the request's trace.
                ticket.trace.resolve(REJECTED, reason=reason)
            return ticket
        self.emit(kind="submitted", request_id=request.request_id,
                  family=request.family, horizon=request.horizon,
                  tenant=request.tenant, depth=depth)
        if self.hub is not None:
            self.hub.inc("queue.submitted", key=request.tenant)
            self.hub.gauge("queue.depth", depth)
        return ticket

    def _admission_reason(self, request: ScenarioRequest,
                          now: float) -> str | None:
        if self._depth() >= self.capacity:
            return REASON_QUEUE_FULL
        chunk_len = self.coverage(request.family)
        if chunk_len is None:
            return REASON_NO_COVERAGE
        if request.horizon <= 0 or request.horizon % chunk_len:
            return REASON_BAD_HORIZON
        if request.deadline_s is not None and request.deadline_s <= 0:
            return REASON_DEADLINE_SPENT
        # Token bucket LAST: a malformed request is rejected as such
        # (and costs the tenant nothing), not masked as throttling.
        policy = self.policy(request.tenant)
        if policy.rate_per_s is not None:
            bucket = self._buckets.get(request.tenant)
            if bucket is None:
                bucket = self._buckets[request.tenant] = _TokenBucket(
                    policy, now
                )
            if not bucket.try_take(now):
                return REASON_TENANT_RATE
        return None

    # ------------------------------------------------------- draining --
    def _depth(self, family: str | None = None) -> int:
        if family is not None:
            return sum(len(q) for q in
                       self._pending.get(family, {}).values())
        return sum(len(q) for by_tenant in self._pending.values()
                   for q in by_tenant.values())

    def depth(self, family: str | None = None) -> int:
        with self._lock:
            return self._depth(family)

    def families_pending(self) -> list[str]:
        with self._lock:
            return sorted(
                f for f, by_tenant in self._pending.items()
                if any(by_tenant.values())
            )

    def take(self, family: str, k: int) -> list[Ticket]:
        """Pop up to ``k`` pending tickets of ``family`` (the batcher
        admits them into device lanes): strictly by priority class
        (high first), weighted-fair across tenants within a class
        (each dequeue charges the tenant 1/weight; the least-charged
        tenant goes next), FIFO within a tenant."""
        with self._lock:
            by_tenant = self._pending.get(family, {})
            taken: list[Ticket] = []
            while len(taken) < k:
                candidates = [t for t, q in by_tenant.items() if q]
                if not candidates:
                    break
                top = max(self.policy(t).priority for t in candidates)
                tenant = min(
                    (t for t in candidates
                     if self.policy(t).priority == top),
                    key=lambda t: (self._served.get((family, t), 0.0), t),
                )
                taken.append(by_tenant[tenant].pop(0))
                self._served[(family, tenant)] = (
                    self._served.get((family, tenant), 0.0)
                    + 1.0 / max(self.policy(tenant).weight, 1e-9)
                )
        # Hub bump after the lock (the same side as emit).
        if self.hub is not None and taken:
            self.hub.inc("queue.dequeued", key=family, n=len(taken))
        return taken

    def expire_deadlines(self) -> list[Ticket]:
        """Resolve queued tickets whose deadline passed before admission:
        status ``deadline_missed``, classified ``in_queue``."""
        missed: list[tuple[Ticket, str, str]] = []
        with self._lock:
            now = self.clock()
            for family, by_tenant in self._pending.items():
                for tenant, fifo in by_tenant.items():
                    keep = []
                    for t in fifo:
                        if (t.slo.deadline_at is not None
                                and now >= t.slo.deadline_at):
                            t.slo.missed = MISSED_IN_QUEUE
                            t._resolve(DEADLINE_MISSED)
                            missed.append((t, family, tenant))
                        else:
                            keep.append(t)
                    by_tenant[tenant] = keep
        # Emit + trace-resolve after release: state changed
        # atomically above; the fsync'd events need no lock.
        for t, family, tenant in missed:
            self.emit(kind="deadline_missed",
                      request_id=t.request.request_id,
                      family=family, tenant=tenant,
                      missed=MISSED_IN_QUEUE,
                      slo=t.slo.to_event())
            if self.hub is not None:
                self.hub.inc("queue.deadline_missed", key=tenant)
            if t.trace is not None:
                t.trace.resolve(DEADLINE_MISSED, missed=MISSED_IN_QUEUE)
        return [t for t, _, _ in missed]
