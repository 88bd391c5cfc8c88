"""Fault-tolerant serving fleet: replica supervision, health-checked
routing and failover re-dispatch over N :class:`ScenarioServer` replica
processes that share one card.

The port's own copy of the JAX package's ``serving/fleet.py`` (the same
names, states, actions, ``fleet_event`` rows and routing, field for field;
the port imports nothing of the JAX package). It composes the serving
tier instead of inventing new machinery:

- **heartbeat leases** ride the fsync'd jsonl channel
  (``obs.export.jsonl_append``): each replica appends ``fleet_event``
  heartbeat rows; the supervisor drives the per-replica health machine
  ``starting/up -> suspect -> down -> restarting`` (-> ``quarantined``)
  from missed leases and from classified ``BackendError`` kinds reported
  upward -- infra kinds strike a per-replica circuit breaker
  (``resilience.backend.BREAKER_KINDS``), ``compile_error`` never does;
- **restarts** are bounded by ``resilience.backend.BackoffPolicy``, with
  poison-replica quarantine after K restart cycles;
- **routing** is ``(family, bucket)`` consistent hashing
  (:class:`HashRing`), so each replica's working set of batch shapes (its
  CUDA-graph captures) stays hot: one family+shape key always lands on the
  same live replica, and a replica loss moves ONLY that replica's keys;
- **failover re-dispatch** replays a dead replica's in-flight requests on
  a healthy replica ON THE SAME ``trace_id`` -- the served results are
  bitwise independent of a request's batch, bucket and lane, so the
  replayed result is the uninterrupted run's, and the front's open
  ``guard_fallback`` span (member = the request's trace) makes the
  failover an explicit ``retry`` segment in ``obs.trace.critical_path``;
- **chaos** is a seeded :class:`FleetFaultPlan` (scheduled, deterministic,
  transportable through :data:`FLEET_FAULTS_ENV`) that
  ``tpu_aerial_transport_torch.tools.fleet_local --chaos`` turns into real
  SIGKILL/SIGTERM/wedge/error injections.

The front and the supervisor are host logic on an injected clock: they
touch no device, and the coordinator process that runs them never needs
a card. :func:`result_digest` runs in the replicas, on results already
copied to the host.
"""

from __future__ import annotations

import bisect
import dataclasses
import hashlib
import os
import random
import re
import time

from tpu_aerial_transport_torch.obs import trace as trace_mod
from tpu_aerial_transport_torch.resilience import backend as backend_mod
from tpu_aerial_transport_torch.serving import queue as queue_mod

# Replica health states (the supervisor's machine; every transition
# lands as a ``fleet_event`` row).
STARTING = "starting"        # spawned, no heartbeat yet (boot grace).
UP = "up"                    # lease current.
SUSPECT = "suspect"          # missed leases, still routable.
DOWN = "down"                # lease expired / breaker open / exit seen.
RESTARTING = "restarting"    # killed; respawn pending under backoff.
QUARANTINED = "quarantined"  # poison replica: K restart cycles burned.

ROUTABLE_STATES = frozenset({STARTING, UP, SUSPECT})

FLEET_FAULTS_ENV = "TAT_FLEET_FAULTS"
# Replica-side actions hit a replica process; CLIENT-side actions (the
# session storms of the serving examples) hit a session client instead:
# ``silent`` stops its heartbeats/steps (lease-eviction path), ``slow``
# delays its next steps by ARG seconds (deadline-degradation path),
# ``duplicate`` re-sends its last step_seq (stale_step path), ``zombie``
# keeps using its pre-eviction lease after the session was reclaimed
# (fence path). Same grammar; ``rR`` indexes the client for client
# actions.
FAULT_ACTIONS = ("sigkill", "sigterm", "wedge", "error",
                 "silent", "slow", "duplicate", "zombie")
CLIENT_FAULT_ACTIONS = frozenset({"silent", "slow", "duplicate",
                                  "zombie"})


def _emit_fn(sink):
    """Normalize a fleet-event sink: a MetricsWriter (anything with
    ``.emit``) gets ``fleet_event`` rows, a callable gets keyword
    fields, None is the zero-cost path."""
    if sink is None:
        return lambda **kw: None
    if hasattr(sink, "emit"):
        return lambda **kw: sink.emit("fleet_event", **kw)
    return lambda **kw: sink(**kw)


# ----------------------------------------------------------------------
# Consistent-hash routing.
# ----------------------------------------------------------------------

class HashRing:
    """Consistent hashing over replica ids with virtual nodes.

    Keys are ``(family, bucket)`` strings: all requests that will batch
    at one compiled shape route to one replica (its executable cache and
    bundle working set stay hot), and removing a replica moves ONLY the
    keys it owned (every other replica's shape set is undisturbed)."""

    def __init__(self, nodes, vnodes: int = 64):
        self.vnodes = int(vnodes)
        self._points: list[tuple[int, object]] = sorted(
            (self._hash(f"{node}#{v}"), node)
            for node in nodes for v in range(self.vnodes)
        )
        self._keys = [h for h, _ in self._points]

    @staticmethod
    def _hash(s: str) -> int:
        return int.from_bytes(
            hashlib.sha256(str(s).encode()).digest()[:8], "big"
        )

    def route(self, key, alive=None):
        """The first live node clockwise from ``key``'s point; ``alive``
        restricts to a live subset (None = all). Returns None only when
        no live node exists."""
        if not self._points:
            return None
        idx = bisect.bisect_right(self._keys, self._hash(str(key)))
        n = len(self._points)
        for i in range(n):
            node = self._points[(idx + i) % n][1]
            if alive is None or node in alive:
                return node
        return None


def bucket_hint(pending: int, buckets) -> int:
    """The shape bucket a ``pending``-wide dispatch group will batch at:
    smallest admitting bucket, largest when oversubscribed (the
    ``serving.batcher.bucket_for`` rule, restated here so the front
    never imports the device-facing batcher)."""
    bs = sorted(int(b) for b in buckets)
    for b in bs:
        if pending <= b:
            return b
    return bs[-1]


# ----------------------------------------------------------------------
# Seeded chaos plan.
# ----------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class FaultAction:
    """One scheduled fault: at ``t_s`` seconds into the storm, hit
    ``replica`` with ``action`` (sigkill/sigterm = signal the process
    group; wedge = stop the replica loop AND its heartbeats for ``arg``
    seconds; error = the replica reports a classified BackendError
    ``arg`` upward). For :data:`CLIENT_FAULT_ACTIONS` the ``replica``
    field indexes the session CLIENT the fault hits."""

    t_s: float
    replica: int
    action: str
    arg: str | None = None

    def token(self) -> str:
        base = f"{self.action}@{self.t_s:g}:r{self.replica}"
        return base + (f"={self.arg}" if self.arg is not None else "")


@dataclasses.dataclass(frozen=True)
class FleetFaultPlan:
    """A deterministic fleet chaos schedule (the ``FaultSchedule`` /
    ``TAT_BACKEND_FAULTS`` idiom at fleet scale): parse/print round-trips
    through the spec grammar ``ACTION@T:rR[=ARG],...`` so a plan travels
    through :data:`FLEET_FAULTS_ENV` to the harness."""

    actions: tuple[FaultAction, ...] = ()

    @classmethod
    def parse(cls, spec: str) -> "FleetFaultPlan":
        actions = []
        for token in (t.strip() for t in (spec or "").split(",")):
            if not token:
                continue
            head, _, arg = token.partition("=")
            try:
                act, _, where = head.partition("@")
                t_s, _, rep = where.partition(":")
                if act not in FAULT_ACTIONS or not rep.startswith("r"):
                    raise ValueError(token)
                actions.append(FaultAction(
                    t_s=float(t_s), replica=int(rep[1:]), action=act,
                    arg=arg or None,
                ))
            except (ValueError, IndexError):
                raise ValueError(
                    f"bad fault token {token!r} (grammar: "
                    f"ACTION@T:rR[=ARG], ACTION in {FAULT_ACTIONS})"
                ) from None
        return cls(actions=tuple(sorted(actions, key=lambda a: a.t_s)))

    def to_spec(self) -> str:
        return ",".join(a.token() for a in self.actions)

    @classmethod
    def from_env(cls, env=None) -> "FleetFaultPlan":
        return cls.parse((env or os.environ).get(FLEET_FAULTS_ENV, ""))

    @classmethod
    def seeded(cls, seed: int, n_replicas: int, *, t_span: float = 4.0,
               n_faults: int = 2,
               kinds=("sigkill", "wedge")) -> "FleetFaultPlan":
        """A seeded random storm: same seed => same plan (the chaos
        acceptance e2e's determinism precondition)."""
        rng = random.Random(seed)
        actions = []
        for _ in range(n_faults):
            act = kinds[rng.randrange(len(kinds))]
            arg = None
            if act in ("wedge", "slow"):
                arg = f"{rng.uniform(1.0, 3.0):.2f}"
            elif act == "error":
                infra = sorted(backend_mod.BREAKER_KINDS)
                arg = infra[rng.randrange(len(infra))]
            actions.append(FaultAction(
                t_s=round(rng.uniform(0.2, t_span), 2),
                replica=rng.randrange(n_replicas), action=act, arg=arg,
            ))
        return cls(actions=tuple(sorted(actions, key=lambda a: a.t_s)))

    def due(self, t_from: float, t_to: float) -> list[FaultAction]:
        """Actions scheduled in ``[t_from, t_to)`` (storm-relative
        seconds) — the harness polls this each round."""
        return [a for a in self.actions if t_from <= a.t_s < t_to]


# ----------------------------------------------------------------------
# Autoscaling signal.
# ----------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class AutoscalePolicy:
    """Thresholds + hysteresis for :class:`AutoscaleSignal`.

    The up/down thresholds deliberately leave a dead band (up at depth
    >= 16 or occupancy >= 0.85, down only at depth <= 0 AND occupancy
    <= 0.25 AND no live sessions) and a switch needs ``confirm``
    CONSECUTIVE raw observations agreeing — an input oscillating around
    one threshold can never flap the confirmed hint."""

    up_queue_depth: int = 16
    up_occupancy: float = 0.85
    down_queue_depth: int = 0
    down_occupancy: float = 0.25
    down_sessions: int = 0
    confirm: int = 3
    # SLO budget-burn input (the obs/live.py SLOEngine's fast-window
    # burn rate): a fleet burning its error budget at the paging rate
    # is underprovisioned even when the queue looks shallow — the
    # default up threshold matches the engine's fast-burn page
    # (obs.live.DEFAULT_BURN_RATES[0]); scale_down additionally
    # requires the burn at/below sustainable (<= 1.0 = burning no
    # faster than the budget accrues). burn_rate=None (no engine, or
    # no traffic) leaves both gates unchanged.
    up_burn_rate: float = 14.4
    down_burn_rate: float = 1.0


class AutoscaleSignal:
    """Hysteresis'd scale-up/down hint from the telemetry the SLO
    accountant already emits: queue depth (front admission), batch
    occupancy (the serving ``batch_boundary`` rows), and the live
    closed-loop session count (a session is standing capacity demand
    even when momentarily idle). Pure host logic on explicit inputs —
    no clock, no device — so it unit-tests with bare numbers. The
    confirmed ``hint`` is one of ``scale_up``/``steady``/``scale_down``
    and an ``autoscale`` fleet event lands ONLY when it changes."""

    HINTS = ("scale_up", "steady", "scale_down")

    def __init__(self, policy: AutoscalePolicy | None = None, emit=None):
        # `is None`, not truthiness: a falsy-but-real
        # policy/sink must still be used.
        self.policy = AutoscalePolicy() if policy is None else policy
        self.emit = _emit_fn(emit)
        self.hint = "steady"
        self.last: dict = {}
        self._candidate = "steady"
        self._streak = 0

    def _raw(self, queue_depth: int, occupancy, sessions: int,
             burn_rate) -> str:
        p = self.policy
        if (queue_depth >= p.up_queue_depth
                or (occupancy is not None
                    and occupancy >= p.up_occupancy)
                or (burn_rate is not None
                    and burn_rate >= p.up_burn_rate)):
            return "scale_up"
        if (queue_depth <= p.down_queue_depth
                and sessions <= p.down_sessions
                and (occupancy is None or occupancy <= p.down_occupancy)
                and (burn_rate is None
                     or burn_rate <= p.down_burn_rate)):
            return "scale_down"
        return "steady"

    def observe(self, *, queue_depth: int = 0, occupancy=None,
                sessions: int = 0, burn_rate=None) -> str:
        """Feed one telemetry observation; returns the CONFIRMED hint
        (which moves only after ``policy.confirm`` consecutive raw
        observations agree on a different value). ``burn_rate`` is the
        SLO engine's fast-window error-budget burn (obs/live.py;
        None when no engine is wired or no traffic is in the window) —
        it rides the SAME confirm-N hysteresis as every other input,
        so a burn spike flaps nothing."""
        raw = self._raw(int(queue_depth), occupancy, int(sessions),
                        burn_rate)
        if raw != self._candidate:
            self._candidate = raw
            self._streak = 1
        else:
            self._streak += 1
        self.last = {"queue_depth": int(queue_depth),
                     "occupancy": occupancy, "sessions": int(sessions),
                     "burn_rate": burn_rate, "raw": raw}
        if raw != self.hint and self._streak >= self.policy.confirm:
            self.hint = raw
            self.emit(kind="autoscale", hint=raw,
                      queue_depth=int(queue_depth), occupancy=occupancy,
                      sessions=int(sessions), burn_rate=burn_rate)
        return self.hint


# ----------------------------------------------------------------------
# Replica supervisor.
# ----------------------------------------------------------------------

class ReplicaHealth:
    """One replica's lease + breaker state (supervisor-internal)."""

    __slots__ = ("replica", "state", "last_heartbeat", "hb_seen",
                 "started_at", "restarts", "restart_at", "breaker",
                 "hb_count")

    def __init__(self, replica, now: float, breaker):
        self.replica = replica
        self.state = STARTING
        self.last_heartbeat: float | None = None
        self.hb_seen = False
        self.started_at = now
        self.restarts = 0          # completed kill→respawn cycles.
        self.restart_at: float | None = None
        self.breaker = breaker
        self.hb_count = 0


class ReplicaSupervisor:
    """Drive each replica's health machine from heartbeats, classified
    errors, and observed exits; hand the harness a list of actions to
    execute (``kill`` / ``failover`` / ``spawn`` / ``quarantine``).

    The supervisor is pure host logic on an injected clock — the
    subprocess side lives in ``tools/fleet_local.py`` of this package;
    the tests drive this class with a fake clock and no processes."""

    def __init__(self, replica_ids, *, lease_s: float = 1.0,
                 suspect_misses: int = 2, down_misses: int = 5,
                 boot_grace_s: float = 120.0,
                 backoff: backend_mod.BackoffPolicy | None = None,
                 quarantine_after: int = 3,
                 breaker_threshold: int = 3,
                 clock=time.monotonic, emit=None,
                 rng: random.Random | None = None):
        if suspect_misses >= down_misses:
            raise ValueError("suspect_misses must be < down_misses")
        self.lease_s = float(lease_s)
        self.suspect_misses = suspect_misses
        self.down_misses = down_misses
        self.boot_grace_s = float(boot_grace_s)
        self.backoff = backoff or backend_mod.BackoffPolicy(
            initial_s=0.5, factor=2.0, max_s=30.0, jitter=0.0
        )
        self.quarantine_after = int(quarantine_after)
        self.clock = clock
        self.emit = _emit_fn(emit)
        self._rng = rng or random.Random(0)
        self._seq = 0
        self.replicas: dict = {}
        now = self.clock()
        for rid in replica_ids:
            self.replicas[rid] = ReplicaHealth(
                rid, now,
                backend_mod.CircuitBreaker(
                    failure_threshold=breaker_threshold,
                    policy=self.backoff, clock=clock, rng=self._rng,
                ),
            )

    # ---------------------------------------------------- transitions --
    def _transition(self, h: ReplicaHealth, to: str, reason: str) -> None:
        if h.state == to:
            return
        self._seq += 1
        self.emit(kind="transition", replica=h.replica,
                  from_state=h.state, to_state=to, reason=reason,
                  seq=self._seq)
        h.state = to

    def state(self, rid) -> str:
        return self.replicas[rid].state

    def routable(self) -> list:
        return [rid for rid, h in self.replicas.items()
                if h.state in ROUTABLE_STATES]

    # -------------------------------------------------------- signals --
    def heartbeat(self, rid, now: float | None = None,
                  seq: int | None = None) -> None:
        h = self.replicas[rid]
        if h.state == QUARANTINED:
            return  # a poison replica's zombie heartbeat changes nothing.
        now = self.clock() if now is None else now
        h.last_heartbeat = now
        h.hb_seen = True
        h.hb_count += 1
        if h.state in (STARTING, SUSPECT, DOWN, RESTARTING):
            self._transition(h, UP, "heartbeat")

    def report_error(self, rid, kind: str, detail: str = "") -> list:
        """A classified ``BackendError`` kind surfaced by a replica.
        Infra kinds strike the replica's circuit breaker (the error
        taxonomy's boundary: ``compile_error`` NEVER does — a program bug
        must not get a healthy replica killed). An opened breaker
        declares the replica down. Returns harness actions."""
        h = self.replicas[rid]
        self.emit(kind="replica_error", replica=rid, error_kind=kind,
                  detail=detail[:300])
        if kind not in backend_mod.BREAKER_KINDS:
            return []
        h.breaker.record_failure(kind)
        if (h.breaker.state == backend_mod.OPEN
                and h.state in ROUTABLE_STATES):
            return self._declare_down(
                h, f"circuit open ({kind})", self.clock()
            )
        return []

    def notify_exit(self, rid, returncode: int | None = None) -> list:
        """The harness saw the replica process exit. Returns actions."""
        h = self.replicas[rid]
        if h.state in ROUTABLE_STATES:
            return self._declare_down(
                h, f"process exited rc={returncode}", self.clock()
            )
        return []

    def _declare_down(self, h: ReplicaHealth, reason: str,
                      now: float) -> list:
        self._transition(h, DOWN, reason)
        actions = [("kill", h.replica), ("failover", h.replica)]
        h.restarts += 1
        h.hb_seen = False
        if h.restarts > self.quarantine_after:
            self._transition(
                h, QUARANTINED,
                f"poison replica: {h.restarts - 1} restart cycles burned",
            )
            self.emit(kind="quarantine", replica=h.replica,
                      cycles=h.restarts - 1)
            actions.append(("quarantine", h.replica))
        else:
            delay = self.backoff.delay(h.restarts - 1, self._rng)
            h.restart_at = now + delay
            self._transition(h, RESTARTING, reason)
            self.emit(kind="restart", replica=h.replica,
                      attempt=h.restarts, delay_s=round(delay, 3))
        return actions

    # ----------------------------------------------------------- tick --
    def tick(self, now: float | None = None) -> list:
        """Advance lease accounting. Returns harness actions:
        ``("kill", rid)`` / ``("failover", rid)`` / ``("spawn", rid)`` /
        ``("quarantine", rid)``."""
        now = self.clock() if now is None else now
        actions: list = []
        for h in self.replicas.values():
            if h.state in (UP, SUSPECT, STARTING):
                if not h.hb_seen:
                    if now - h.started_at >= self.boot_grace_s:
                        actions += self._declare_down(
                            h, "boot deadline exceeded", now
                        )
                    continue
                misses = (now - h.last_heartbeat) / self.lease_s
                if misses >= self.down_misses:
                    actions += self._declare_down(
                        h, f"{int(misses)} missed heartbeat leases", now
                    )
                elif misses >= self.suspect_misses and h.state == UP:
                    self._transition(
                        h, SUSPECT,
                        f"{int(misses)} missed heartbeat leases",
                    )
            elif h.state == RESTARTING:
                if h.restart_at is not None and now >= h.restart_at:
                    h.restart_at = None
                    h.started_at = now
                    actions.append(("spawn", h.replica))
                elif (h.restart_at is None
                      and not h.hb_seen
                      and now - h.started_at >= self.boot_grace_s):
                    # The respawn itself never booted: burn another cycle.
                    actions += self._declare_down(
                        h, "respawn boot deadline exceeded", now
                    )
        return actions


# ----------------------------------------------------------------------
# Fleet front: admission + routing + failover bookkeeping.
# ----------------------------------------------------------------------

class FleetFront:
    """ONE admission front over N replicas.

    Owns the hardened :class:`AdmissionQueue` (per-tenant token buckets,
    weighted-fair priority dequeue), routes admitted requests by
    ``(family, bucket)`` through the :class:`HashRing`, tracks in-flight
    ownership, and on a replica death re-dispatches that replica's
    incomplete requests to a healthy one — same ``request_id``, same
    ``trace_id``, full replay (bit-identical by the lane-independence
    contract). Completion is front-authoritative: the FIRST result row
    per request wins; any duplicate (a restarted replica re-serving work
    that was already failed over) is counted, emitted as a
    ``duplicate_result`` fleet event, and dropped — no request is ever
    double-completed.

    Transport-agnostic: ``send(replica_id, op_dict)`` is injected
    (``tools/fleet_local.py`` of this package appends to per-replica
    inbox jsonls; tests use in-memory queues)."""

    def __init__(self, replica_ids, coverage, *, send,
                 buckets=(8, 16, 32), capacity: int = 1024,
                 tenants: dict | None = None,
                 supervisor: ReplicaSupervisor | None = None,
                 clock=time.monotonic, metrics=None, tracer=None,
                 autoscale_policy: AutoscalePolicy | None = None,
                 hub=None, slo=None):
        self.replica_ids = list(replica_ids)
        self.send = send
        self.buckets = tuple(sorted(buckets))
        self.supervisor = supervisor
        self.clock = clock
        self.metrics = metrics
        self.tracer = tracer
        # hub/slo=None is the default and costs nothing per request
        # (every touch point is behind an ``is not None`` guard).
        # ``slo`` duck-types obs/live.py's SLOEngine: ``max_burn()``
        # feeds the autoscale burn-rate gate each pump round.
        self.hub = hub
        self.slo = slo
        self.emit_fleet = _emit_fn(metrics)
        self.ring = HashRing(self.replica_ids)
        self.queue = queue_mod.AdmissionQueue(
            coverage, capacity=capacity, clock=clock,
            emit=self._emit_serving, tracer=tracer, tenants=tenants,
            hub=hub,
        )
        self.tickets: dict[str, queue_mod.Ticket] = {}
        self.requests: dict[str, queue_mod.ScenarioRequest] = {}
        self.inflight: dict[str, object] = {}   # request_id -> replica.
        self.results: dict[str, dict] = {}      # first result row wins.
        self.duplicates: list[dict] = []
        self.failovers = 0
        self._failover_spans: dict[str, object] = {}
        # Closed-loop sessions homed through this front:
        # session_id -> {"replica", "family", "trace_id"} (replica None
        # while orphaned by a full-fleet outage — pump() re-homes).
        self.sessions: dict[str, dict] = {}
        self._rehome_spans: dict[str, object] = {}
        self.autoscale = AutoscaleSignal(policy=autoscale_policy,
                                         emit=metrics)

    # --------------------------------------------------------- events --
    def _emit_serving(self, **fields) -> None:
        if self.metrics is not None:
            self.metrics.emit("serving_event", **fields)
        if self.hub is not None:
            # The fields dict already exists for the journal emit — the
            # hub consumes it in place (zero marginal allocation).
            self.hub.ingest_serving(fields)
        if (fields.get("kind") == "rejected"
                and fields.get("reason") == queue_mod.REASON_TENANT_RATE):
            # The throttle ALSO lands in the fleet vocabulary: the
            # run_health fleet section's per-tenant throttle counts.
            self.emit_fleet(kind="tenant_rejected",
                            tenant=fields.get("tenant"),
                            request_id=fields.get("request_id"),
                            reason=queue_mod.REASON_TENANT_RATE)

    # --------------------------------------------------------- submit --
    def submit(self, request: queue_mod.ScenarioRequest
               ) -> queue_mod.Ticket:
        """Admit or reject (structured, never an exception — the chaos
        storm's front loop runs this unguarded by design)."""
        ticket = self.queue.submit(request)
        self.tickets[ticket.request.request_id] = ticket
        if ticket.status == queue_mod.PENDING:
            # ticket.request, NOT the caller's argument: admission mints
            # trace_id onto a replaced request (the server.py rule).
            self.requests[ticket.request.request_id] = ticket.request
        return ticket

    # ------------------------------------------------------- dispatch --
    def routable(self) -> list:
        if self.supervisor is None:
            return list(self.replica_ids)
        return self.supervisor.routable()

    def pump(self) -> int:
        """One routing round: expire deadlines, then flush each family's
        pending group to the replica owning its ``(family, bucket)``
        key. Requests HOLD at the front while no replica is routable
        (nothing is lost during a full-fleet outage). Returns the number
        of requests dispatched."""
        for t in self.queue.expire_deadlines():
            self.requests.pop(t.request.request_id, None)
        alive = set(self.routable())
        burn = self.slo.max_burn() if self.slo is not None else None
        self.autoscale.observe(queue_depth=self.queue.depth(),
                               sessions=len(self.sessions),
                               burn_rate=burn)
        if not alive:
            return 0
        # Sessions orphaned by a full-fleet outage re-home as soon as a
        # replica is routable again (same hold-at-the-front rule as
        # requests).
        for sid, rec in sorted(self.sessions.items()):
            if rec["replica"] is None:
                self._rehome_session(sid, rec, None, alive)
        sent = 0
        for family in self.queue.families_pending():
            group = self.queue.take(family, self.queue.depth(family))
            bucket = bucket_hint(len(group), self.buckets)
            target = self.ring.route(f"{family}:{bucket}", alive)
            for ticket in group:
                self._dispatch(ticket.request, target)
                ticket.slo.t_admit = self.clock()
                if ticket.trace is not None:
                    ticket.trace.admitted(replica=str(target))
                sent += 1
        return sent

    def _dispatch(self, request, replica) -> None:
        self.inflight[request.request_id] = replica
        self.send(replica, {"op": "submit", "request": request.to_json()})

    # ------------------------------------------------------- sessions --
    def open_session(self, session_id: str, family: str,
                     trace_id: str | None = None):
        """Home a closed-loop session: sessions route by ``session_id``
        (NOT family:bucket — a session must stay on one replica so its
        lease/watermark table is local) and the binding persists until
        close or re-home. Returns the owning replica, or None when no
        replica is routable (the caller retries after the fleet heals)."""
        alive = set(self.routable())
        if not alive:
            return None
        sid = str(session_id)
        target = self.ring.route(f"session:{sid}", alive)
        self.sessions[sid] = {"replica": target, "family": family,
                              "trace_id": trace_id}
        self.send(target, {
            "op": "session_open", "session_id": sid, "family": family,
            **({"trace_id": trace_id} if trace_id else {}),
        })
        return target

    def session_replica(self, session_id):
        rec = self.sessions.get(str(session_id))
        return None if rec is None else rec["replica"]

    def close_session(self, session_id: str) -> None:
        rec = self.sessions.pop(str(session_id), None)
        if rec is not None and rec["replica"] is not None:
            self.send(rec["replica"], {"op": "session_close",
                                       "session_id": str(session_id)})

    def _rehome_session(self, sid: str, rec: dict, from_replica,
                        alive: set) -> None:
        """Move one session to a live replica on the SAME trace_id, the
        failover span held open until the session's next result arrives
        (the request failover's pattern — the re-serve shows up as an
        explicit retry segment on the session's trace)."""
        target = (self.ring.route(f"session:{sid}", alive)
                  if alive else None)
        if (self.tracer is not None and rec.get("trace_id") is not None
                and sid not in self._rehome_spans):
            self._rehome_spans[sid] = self.tracer.begin(
                trace_mod.GUARD_FALLBACK, parent=None,
                trace_id=rec["trace_id"], members=[rec["trace_id"]],
                session_id=sid, failover=True,
                from_replica=str(from_replica), to_replica=str(target),
            )
        rec["replica"] = target  # None = orphaned; pump() retries.
        if target is not None:
            self.send(target, {
                "op": "session_rehome", "session_id": sid,
                "family": rec["family"],
                **({"trace_id": rec["trace_id"]}
                   if rec.get("trace_id") else {}),
            })
        if self.metrics is not None:
            self.metrics.emit("session_event", kind="rehomed",
                              session_id=sid,
                              from_replica=str(from_replica),
                              to_replica=str(target))

    # ------------------------------------------------------- failover --
    def failover(self, dead_replica) -> list[str]:
        """Re-dispatch every incomplete request owned by
        ``dead_replica`` to a healthy replica, on the SAME trace_id.
        The open ``guard_fallback`` span (member = the request's trace)
        runs until the re-served completion arrives, so the critical
        path attributes the whole re-serve to the ``retry`` segment."""
        t_detect = self.clock()
        alive = set(self.routable()) - {dead_replica}
        moved: list[str] = []
        for rid, owner in sorted(self.inflight.items()):
            if owner != dead_replica or rid in self.results:
                continue
            request = self.requests.get(rid)
            if request is None:
                continue
            # Best effort: the restarted replica must not re-serve work
            # that moved (a lost cancel only costs a deduped duplicate).
            self.send(dead_replica,
                      {"op": "cancel", "request_id": rid})
            bucket = bucket_hint(1, self.buckets)
            target = (self.ring.route(f"{request.family}:{bucket}", alive)
                      if alive else None)
            if self.tracer is not None and request.trace_id is not None:
                span = self.tracer.begin(
                    trace_mod.GUARD_FALLBACK, parent=None,
                    trace_id=request.trace_id,
                    members=[request.trace_id], request_id=rid,
                    failover=True, from_replica=str(dead_replica),
                    to_replica=str(target),
                )
                self._failover_spans[rid] = span
            if target is None:
                # Full-fleet outage: hold at the front; the next pump()
                # with a routable replica re-dispatches.
                self.inflight.pop(rid, None)
                self.queue._pending.setdefault(
                    request.family, {}
                ).setdefault(request.tenant, []).append(
                    self.tickets[rid]
                )
            else:
                self._dispatch(request, target)
            self.failovers += 1
            latency = self.clock() - t_detect
            self.emit_fleet(
                kind="failover", request_id=rid,
                from_replica=str(dead_replica), to_replica=str(target),
                trace_id=request.trace_id, latency_s=round(latency, 6),
            )
            moved.append(rid)
        # Re-home the dead replica's closed-loop sessions too (their
        # lease/watermark tables restore replica-side from the journal;
        # the front only moves the binding).
        for sid, rec in sorted(self.sessions.items()):
            if rec["replica"] == dead_replica:
                self._rehome_session(sid, rec, dead_replica, alive)
        return moved

    # ------------------------------------------------------ completion --
    def deliver_result(self, row: dict) -> bool:
        """One replica outbox row ({request_id, status, digest, ...}).
        First result wins; duplicates are dropped and counted. Returns
        True when the row resolved a ticket."""
        rid = row.get("request_id")
        if rid is None or rid in self.results:
            self.duplicates.append(row)
            self.emit_fleet(kind="duplicate_result", request_id=rid,
                            replica=str(row.get("replica")))
            return False
        self.results[rid] = row
        self.inflight.pop(rid, None)
        ticket = self.tickets.get(rid)
        status = row.get("status", queue_mod.COMPLETED)
        span = self._failover_spans.pop(rid, None)
        if span is not None:
            self.tracer.end(span, status=status)
        # A session-step result closes the session's held-open re-home
        # span: the new owner is provably serving it again. Rows SHOULD
        # carry their session id; the request_id fallback only fires on
        # the exact session-step rid shape minted by SessionHost
        # ({sid}.e{epoch}.s{seq:06d}, legacy pre-epoch form tolerated)
        # AND a prefix that names a session this front actually routes
        # — a caller-chosen one-shot rid that happens to contain '.s'
        # must never end another session's re-home span.
        sid = row.get("session")
        if sid is None and rid is not None:
            m = (re.match(r"^(.+)\.e\d+\.s\d{6}$", rid)
                 or re.match(r"^(.+)\.s\d{6}$", rid))
            if m is not None and m.group(1) in self.sessions:
                sid = m.group(1)
        if sid is not None:
            rspan = self._rehome_spans.pop(sid, None)
            if rspan is not None:
                self.tracer.end(rspan, status=status)
        if ticket is None or ticket.done:
            return False
        ticket.slo.t_complete = self.clock()
        ticket.steps_served = int(row.get("steps_served", 0))
        ticket.result = row.get("digest")
        if ticket.trace is not None:
            ticket.trace.resolve(status, replica=str(row.get("replica")))
        ticket._resolve(status, row.get("reason"))
        if self.metrics is not None:
            self.metrics.emit(
                "serving_event", kind=status, request_id=rid,
                family=ticket.request.family,
                tenant=ticket.request.tenant,
                replica=str(row.get("replica")),
                slo=ticket.slo.to_event(),
            )
        return True

    # ----------------------------------------------------------- stats --
    def unresolved(self) -> list[str]:
        return sorted(rid for rid, t in self.tickets.items()
                      if not t.done)

    def stats(self) -> dict:
        by_status: dict[str, int] = {}
        for t in self.tickets.values():
            by_status[t.status] = by_status.get(t.status, 0) + 1
        by_tenant: dict[str, dict] = {}
        for t in self.tickets.values():
            bt = by_tenant.setdefault(
                t.request.tenant, {"submitted": 0, "completed": 0,
                                   "rejected": 0}
            )
            bt["submitted"] += 1
            if t.status == queue_mod.COMPLETED:
                bt["completed"] += 1
            elif t.status == queue_mod.REJECTED:
                bt["rejected"] += 1
        return {
            "requests": len(self.tickets),
            **by_status,
            "failovers": self.failovers,
            "duplicates_dropped": len(self.duplicates),
            "tenants": by_tenant,
            "sessions": len(self.sessions),
            "autoscale": {"hint": self.autoscale.hint,
                          **self.autoscale.last},
        }


# ----------------------------------------------------------------------
# Result digest (replica-side; the cross-process bit-identity token).
# ----------------------------------------------------------------------

def result_digest(result) -> str:
    """sha256 over the result tree's leaf bytes (with shape and dtype) --
    the token the chaos acceptance compares against the fault-free run.
    The leaves are walked in ``tree.leaves`` order (a dict's keys sorted,
    a ``NamedTuple``'s fields in order), so on the same arrays the digest
    is the JAX package's. Only replica processes call this, on results
    already on the host."""
    import numpy as np

    from tpu_aerial_transport_torch.tree import leaves

    h = hashlib.sha256()
    for leaf in leaves(result):
        a = np.ascontiguousarray(leaf.detach().cpu().numpy())
        h.update(str((a.shape, a.dtype.str)).encode())
        h.update(a.tobytes())
    return h.hexdigest()
