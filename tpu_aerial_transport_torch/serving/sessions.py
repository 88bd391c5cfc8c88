"""Closed-loop session serving: leases, heartbeats, fenced eviction,
and per-step deadline degradation on top of the continuous batcher.

The port's counterpart of the JAX package's ``serving/sessions.py``: the
same lease and fencing state machine, step identities, journal events and
rungs, over the port's :class:`~tpu_aerial_transport_torch.serving.server
.ScenarioServer`.

The paper's controller is receding-horizon MPC — in production it is a
LOOP: a client streams its payload state every control step and needs
the next control back under a per-step deadline. :class:`SessionHost`
is that tier. A session is a named, leased binding between a client and
the serving stack; each accepted control step is served as ONE internal
chunk-length :class:`~tpu_aerial_transport_torch.serving.queue
.ScenarioRequest` carrying the session's current (post-delta) state.
The batcher's lane-independence contract (a lane's result depends only
on its own state, never on batch composition or the global step offset
-- ``tests/test_torch_serving.py``) is what makes this exact: the served
per-step control stream is bitwise equal to the offline rollout of the
same state stream, whatever else shared the batch.

Lease / fencing state machine::

            open()                        heartbeat()/step()
    (none) ───────► LIVE(lease l_e) ◄──────────────────────┐
                      │    │ renew: expires_at = now + TTL ┘
         TTL expires  │    │
      (sweep: evict,  │    │ open() again (reconnect):
       fence l_e)     │    │   NEW lease l_{e+1}, old l_e FENCED
                      ▼    ▼
                   EVICTED / superseded — l_e ∈ fenced set
                      │
        step/heartbeat│with l_e  ──►  structured ``lease_fenced``
                      ▼               rejection (never a lane write)
                   close() ──► CLOSED (lease fenced)

Every check a zombie could race happens HERE, before any server
interaction: a stale token is rejected without touching the admission
queue, the batch, or the journal -- so a reclaimed lane can never see a
write from a fenced client (``tests/test_torch_sessions.py`` pins the
absence of even a journaled ``serving_request``). Fencing cuts BOTH directions:
step identities carry the lease epoch (``{sid}.e{epoch}.s{seq}``), and
a step submitted by a superseded incarnation that resolves after a
reconnect is dropped on the floor session-side — it can never refresh
the new incarnation's hold-last control or lane bookkeeping. Eviction
itself needs no device action in this model: the session's lane claim
ends at its in-flight step's chunk boundary, where the standard
boundary machinery (``serving/lanes.py`` surgery) reclaims the lane as
pristine filler or hands it to a late joiner.

Per-step SLOs degrade, never raise: a step whose inner request misses
its deadline resolves ``completed`` with rung ``hold_last`` (the
serving-layer mirror of the rollout's fallback ladder -- the client keeps
applying the last control it was served; before the FIRST served
control the rung is ``no_control``: there is nothing honest to hold),
the miss classified ``in_queue``/``in_flight`` by the batch SLO
machinery and journaled. The session's state stream is UNAFFECTED:
state advances by client deltas only, so a degraded step does not fork
the bitwise contract. An ADMISSION rejection (queue full, tenant
throttled) consumes nothing: watermark and state roll back, nothing is
journaled, and the client retries the same seq — the two sides' views
of the state stream cannot diverge on a transient reject.

Crash safety rides the server's fsync'd ``serving_journal.jsonl``:
``session_open``/``session_step``/``session_evict``/``session_close``
events carry the full session table (lease epoch, step_seq watermark,
exact float64 state — json round-trips doubles exactly), so
:meth:`SessionHost.resume` on top of ``ScenarioServer.resume`` restores
live sessions bit-identically. Leases RE-ARM on resume (the monotonic
clock domain dies with the process — same rule as the server's deadline
re-arm). The ``session_step`` append lands AFTER admission accepts (the
commit is conditional), so the only crash gap is an admitted inner
request whose session_step never journaled: the client's retry of the
unacked seq reattaches to the restored inner ticket by request_id
instead of double-submitting; the defensive reverse path (journaled
session_step, no server record) still resubmits from the journaled
post-delta state.

Host-synchronous and lock-free by design (the server-loop discipline):
one thread drives ``open``/``heartbeat``/``step``/``pump``; the async
surface is the :class:`StepTicket`.
"""

from __future__ import annotations

import os
import re

import numpy as np

from tpu_aerial_transport_torch.obs import trace as trace_mod
from tpu_aerial_transport_torch.serving import queue as queue_mod

# Session lifecycle states.
LIVE = "live"
EVICTED = "evicted"
CLOSED = "closed"

# Per-step serving rungs (honest labels on every resolved step).
RUNG_SERVED = "served"
RUNG_HOLD_LAST = "hold_last"
# A deadline miss before the session was EVER served: there is no last
# control to hold, and a ``hold_last`` carrying None would read as a
# served control. The step still resolves timely — the client's cue to
# keep its own local fallback engaged.
RUNG_NO_CONTROL = "no_control"

DEFAULT_LEASE_S = 30.0


def _step_rid(session_id: str, epoch: int, step_seq: int) -> str:
    """The inner request_id of one session step. The lease EPOCH is
    part of the identity: open() on reconnect resets the step_seq
    watermark, so without it epoch N+1's step k would alias epoch N's —
    and resume's done-request dedup would silently swallow a new
    incarnation's in-flight step whose seq matched a completed old one.
    A fleet front parses this shape (and only this shape) when a
    replica row omits its session id."""
    return f"{session_id}.e{epoch}.s{step_seq:06d}"


_STEP_RID_RE = re.compile(r"^(?P<sid>.+)\.e(?P<epoch>\d+)\.s(?P<seq>\d{6})$")


def parse_step_rid(request_id) -> tuple[str, int, int] | None:
    """``(session_id, epoch, step_seq)`` when ``request_id`` is a
    canonical session-step id (the :func:`_step_rid` shape), else None —
    the strict inverse, for offline replays and row->session routing."""
    m = _STEP_RID_RE.match(str(request_id))
    if m is None:
        return None
    return m.group("sid"), int(m.group("epoch")), int(m.group("seq"))


def resolve_lease_s(configured=None) -> float:
    """Resolve the session lease TTL (seconds): the ``TAT_SESSION_LEASE_S``
    env force wins, then the configured value, then
    :data:`DEFAULT_LEASE_S`.

    TUNING CRITERION: the TTL is the eviction latency for a silent
    client — the longest a dead client's session lingers before its
    (at most one in-flight) lane claim returns to the filler pool. Set
    it a few multiples of the client's heartbeat period above the p99
    network+pump gap; BELOW that, healthy-but-slow clients flap through
    evict/reconnect (every flap fences a lease and re-admits), ABOVE
    it, capacity hides behind ghosts. The default (30 s) suits ~1 s
    control steps; interactive tests force fractions of a second.
    """
    forced = os.environ.get("TAT_SESSION_LEASE_S", "").strip()
    raw = forced if forced else configured
    if raw is None or raw == "":
        return DEFAULT_LEASE_S
    try:
        val = float(raw)
    except (TypeError, ValueError):
        raise ValueError(
            f"TAT_SESSION_LEASE_S / lease_s must be a positive number "
            f"of seconds, got {raw!r}"
        )
    if val <= 0:
        raise ValueError(
            f"TAT_SESSION_LEASE_S / lease_s must be > 0, got {val!r}"
        )
    return val


class Session:
    """One session's host-side record (the session-table row)."""

    def __init__(self, session_id: str, family: str, lease: str,
                 epoch: int, x, v, trace_id, deadline_s):
        self.session_id = session_id
        self.family = family
        self.lease = lease
        self.epoch = epoch              # lease epoch (token minting).
        self.status = LIVE
        self.step_seq = 0               # watermark: highest ACCEPTED seq.
        # Exact host-float64 state stream (client deltas accumulate
        # here; json journaling round-trips these bit-exactly).
        self.x = np.asarray(x, dtype=np.float64).reshape(-1).copy()
        self.v = np.asarray(v, dtype=np.float64).reshape(-1).copy()
        self.trace_id = trace_id
        self.deadline_s = deadline_s    # per-step default (None = none).
        self.expires_at = 0.0           # monotonic clock domain.
        self.last_renew_at = 0.0        # heartbeat-gap bookkeeping.
        self.last_result = None         # last SERVED control (hold-last).
        self.lane = None                # last observed lane binding.
        self.batch_id = None


class StepTicket:
    """The client's handle for one control step: resolves ``rejected``
    (structured reason — fenced lease / stale seq / admission reject;
    an admission reject consumes NOTHING, the client retries the same
    seq) or ``completed`` with an honest ``rung``: ``served`` (fresh
    result, deadline met), ``hold_last`` (deadline missed — ``result``
    is the last served control, ``missed`` classifies
    in_queue/in_flight — or the step's chunk failed on the card, ``reason``
    its error kind), or ``no_control`` (either before any control was
    ever served — ``result`` is None, NOT a control)."""

    def __init__(self, session_id: str, step_seq: int, request_id: str,
                 epoch: int = 0):
        self.session_id = session_id
        self.step_seq = step_seq
        self.request_id = request_id
        self.epoch = epoch              # incarnation that submitted it.
        self.status = queue_mod.PENDING
        self.reason: str | None = None
        self.rung: str | None = None
        self.missed: str | None = None
        self.result = None
        self.latency_s: float | None = None
        self.ticket: queue_mod.Ticket | None = None  # inner request.
        self.span = None                # SESSION_STEP span (tracer on).

    @property
    def done(self) -> bool:
        return self.status != queue_mod.PENDING

    def __repr__(self) -> str:  # operator-facing.
        return (f"StepTicket({self.request_id}, {self.status}"
                + (f", {self.rung}" if self.rung else "")
                + (f", {self.reason}" if self.reason else "") + ")")


class SessionHost:
    """The session tier over one :class:`ScenarioServer`.

    Lock-free and host-synchronous like the server itself; every clock
    read is the server's (injectable, monotonic) ``clock`` so lease
    arithmetic is fake-clock testable. ``lease_s``
    resolves through :func:`resolve_lease_s` (``TAT_SESSION_LEASE_S``).
    ``step_deadline_s`` is the default per-step SLO (a ``step`` call may
    override per step; None = no deadline)."""

    def __init__(self, server, *, lease_s=None, clock=None,
                 step_deadline_s: float | None = None):
        self.server = server
        self.lease_s = resolve_lease_s(lease_s)
        # `is None`, not truthiness: a falsy-but-callable clock (a Mock)
        # must still be used.
        self.clock = server.clock if clock is None else clock
        self.step_deadline_s = step_deadline_s
        self.sessions: dict[str, Session] = {}
        self._fenced: dict[str, str] = {}  # stale lease -> session_id.
        # In-flight steps: inner request_id -> StepTicket.
        self._steps: dict[str, StepTicket] = {}
        # Monotone counters (stats()/autoscale inputs).
        self.evictions = 0
        self.fence_rejections = 0
        self.stale_rejections = 0
        self.steps_accepted = 0
        self.steps_degraded = 0

    # ---------------------------------------------------------- events --
    def _emit_session(self, **fields) -> None:
        if self.server.metrics is not None:
            self.server.metrics.emit("session_event", **fields)
        if self.server.hub is not None:
            # Live hub fold (obs.live.MetricsHub): the fields dict is
            # this funnel's kwargs, so hub=None adds no per-step
            # allocation — the standing zero-cost contract.
            self.server.hub.ingest_session(fields)

    def _journal(self, obj: dict) -> None:
        if self.server.journal is not None:
            self.server.journal.append(obj)

    # ----------------------------------------------------------- lease --
    def _mint_lease(self, session_id: str, epoch: int) -> str:
        # Deterministic tokens (no randomness): resume must rebuild the
        # SAME fence set from the journal alone. Fencing is correctness
        # (split-brain), not secrecy — same trust model as request_id.
        return f"{session_id}:l{epoch}"

    def _renew(self, sess: Session, now: float) -> None:
        sess.last_renew_at = now
        sess.expires_at = now + self.lease_s

    def _evict(self, sess: Session, now: float) -> None:
        sess.status = EVICTED
        self._fenced[sess.lease] = sess.session_id
        self.evictions += 1
        gap = now - sess.last_renew_at
        self._journal({"event": "session_evict",
                       "session_id": sess.session_id,
                       "lease": sess.lease, "epoch": sess.epoch})
        self._emit_session(kind="evicted", session_id=sess.session_id,
                           lease=sess.lease, gap_s=round(gap, 6),
                           step_seq=sess.step_seq)

    def sweep(self) -> list[str]:
        """Evict every live session whose lease TTL expired (the silent-
        client path). Idempotent; called from every public entrypoint so
        a zombie can never slip a write in before its eviction lands."""
        now = self.clock()
        expired = [s for s in self.sessions.values()
                   if s.status == LIVE and now >= s.expires_at]
        for sess in expired:
            self._evict(sess, now)
        return [s.session_id for s in expired]

    # ------------------------------------------------------- lifecycle --
    def open(self, session_id: str, family: str, x0=(0.0, 0.0, 0.0),
             v0=(0.0, 0.0, 0.0), *, deadline_s: float | None = None,
             tenant: str = queue_mod.DEFAULT_TENANT) -> dict:
        """Open (or re-open) a session: mint a fresh lease and absolute
        state. Reconnecting under an existing session_id fences the
        previous lease — whether it was live (duplicate client: exactly
        one writer survives) or evicted (the normal reconnect) — and
        RESETS the step_seq watermark with the state (a reconnect is a
        new incarnation, not a replay window). Structured grant, never
        an exception: ``{"ok": False, "reason": ...}`` when the family
        has no serving coverage."""
        del tenant  # reserved: a per-tenant session policy.
        now = self.clock()
        self.sweep()
        sid = str(session_id)
        if self.server._coverage(family) is None:
            return {"ok": False, "session_id": sid,
                    "reason": queue_mod.REASON_NO_COVERAGE}
        prev = self.sessions.get(sid)
        epoch = 0
        reconnect = False
        if prev is not None:
            epoch = prev.epoch + 1
            reconnect = True
            # The old incarnation's token joins the fence set even if it
            # was still live — exactly one lease per session_id can ever
            # write.
            self._fenced[prev.lease] = sid
        lease = self._mint_lease(sid, epoch)
        trace_id = (trace_mod.new_trace_id()
                    if self.server.tracer is not None else None)
        sess = Session(sid, family, lease, epoch, x0, v0, trace_id,
                       deadline_s)
        self._renew(sess, now)
        self.sessions[sid] = sess
        self._journal({
            "event": "session_open", "session_id": sid, "family": family,
            "lease": lease, "epoch": epoch,
            "x": [float(val) for val in sess.x],
            "v": [float(val) for val in sess.v],
            "deadline_s": (None if deadline_s is None
                           else float(deadline_s)),
            **({"trace_id": trace_id} if trace_id else {}),
        })
        self._emit_session(kind="opened", session_id=sid, lease=lease,
                           family=family, epoch=epoch,
                           reconnect=reconnect)
        return {"ok": True, "session_id": sid, "lease": lease,
                "expires_in_s": self.lease_s, "step_seq": 0}

    def _lease_ok(self, sid: str, lease: str) -> bool:
        sess = self.sessions.get(sid)
        return (sess is not None and sess.status == LIVE
                and lease == sess.lease)

    def heartbeat(self, session_id: str, lease: str) -> dict:
        """Renew the lease. A stale/unknown token (or an already-evicted
        session) gets the structured ``lease_fenced`` answer — the
        zombie's cue to re-``open``."""
        now = self.clock()
        self.sweep()
        sid = str(session_id)
        if not self._lease_ok(sid, lease):
            self.fence_rejections += 1
            self._emit_session(kind="fenced", session_id=sid,
                               op="heartbeat", lease=str(lease))
            return {"ok": False, "session_id": sid,
                    "reason": queue_mod.REASON_LEASE_FENCED}
        sess = self.sessions[sid]
        gap = now - sess.last_renew_at
        self._renew(sess, now)
        self._emit_session(kind="renewed", session_id=sid,
                           gap_s=round(gap, 6))
        return {"ok": True, "session_id": sid,
                "expires_in_s": self.lease_s}

    def close(self, session_id: str, lease: str) -> dict:
        """Graceful teardown: the lease is fenced immediately."""
        self.sweep()
        sid = str(session_id)
        if not self._lease_ok(sid, lease):
            self.fence_rejections += 1
            self._emit_session(kind="fenced", session_id=sid, op="close",
                               lease=str(lease))
            return {"ok": False, "session_id": sid,
                    "reason": queue_mod.REASON_LEASE_FENCED}
        sess = self.sessions[sid]
        sess.status = CLOSED
        self._fenced[sess.lease] = sid
        self._journal({"event": "session_close", "session_id": sid})
        self._emit_session(kind="session_closed", session_id=sid,
                           step_seq=sess.step_seq)
        return {"ok": True, "session_id": sid}

    # ------------------------------------------------------------ steps --
    def step(self, session_id: str, lease: str, step_seq: int,
             dx=(0.0, 0.0, 0.0), dv=(0.0, 0.0, 0.0), *,
             deadline_s: float | None = None) -> StepTicket:
        """One control step: ``(session_id, lease, step_seq, x/v delta)``.

        The validation ladder runs ENTIRELY before any server
        interaction — fence first (a stale token must not even be able
        to leak information about the session's progress), then the
        step sequence — and rejects structurally, never raising into
        the caller's loop:

        1. fenced/unknown/expired lease  -> ``lease_fenced``
        2. ``step_seq != watermark + 1`` -> ``stale_step`` (replay or
           out-of-order; the watermark does not move)

        An accepted step advances the watermark, applies the delta to
        the session's float64 state, submits one chunk-length internal
        request whose result is this step's control, and journals the
        post-delta state. The watermark/delta commit is conditional on
        ADMISSION accepting the inner request: a step rejected at
        admission (queue full, tenant throttled) rolls back and
        journals nothing — the seq is NOT consumed and the client
        retries the same step, so the client's and server's views of
        the state stream cannot diverge on a transient rejection. The
        request_id carries the lease epoch (``{sid}.e{epoch}.s{seq}``)
        so step identities are unique across reconnect incarnations —
        resume's done-request dedup and in-flight reattachment can
        never confuse epoch N's step k with epoch N+1's."""
        self.sweep()
        sid = str(session_id)
        seq = int(step_seq)
        if not self._lease_ok(sid, lease):
            self.fence_rejections += 1
            step = StepTicket(sid, seq, f"{sid}.s{seq:06d}")
            step.status = queue_mod.REJECTED
            step.reason = queue_mod.REASON_LEASE_FENCED
            self._emit_session(kind="fenced", session_id=sid, op="step",
                               step_seq=seq, lease=str(lease))
            return step
        sess = self.sessions[sid]
        step = StepTicket(sid, seq, _step_rid(sid, sess.epoch, seq),
                          epoch=sess.epoch)
        if seq != sess.step_seq + 1:
            self.stale_rejections += 1
            step.status = queue_mod.REJECTED
            step.reason = queue_mod.REASON_STALE_STEP
            self._emit_session(kind="stale_step", session_id=sid,
                               step_seq=seq,
                               expected=sess.step_seq + 1)
            return step

        now = self.clock()
        self._renew(sess, now)  # a stepping client is a live client.
        eff_deadline = (deadline_s if deadline_s is not None
                        else sess.deadline_s if sess.deadline_s is not None
                        else self.step_deadline_s)
        # Tentative commit: the delta/watermark become durable only if
        # admission accepts the inner request.
        prev = (sess.step_seq, sess.x, sess.v)
        sess.step_seq = seq
        sess.x = sess.x + np.asarray(dx, dtype=np.float64).reshape(-1)
        sess.v = sess.v + np.asarray(dv, dtype=np.float64).reshape(-1)
        self._submit_step(sess, step, eff_deadline)
        if step.status == queue_mod.REJECTED:
            # Admission rejected: roll back so the seq is retryable and
            # the unserved delta never enters the state stream (or the
            # journal — nothing was written for this step).
            sess.step_seq, sess.x, sess.v = prev
            return step
        self._journal({
            "event": "session_step", "session_id": sid, "step_seq": seq,
            "epoch": sess.epoch, "request_id": step.request_id,
            "x": [float(val) for val in sess.x],
            "v": [float(val) for val in sess.v],
            "deadline_s": (None if eff_deadline is None
                           else float(eff_deadline)),
        })
        return step

    def _submit_step(self, sess: Session, step: StepTicket,
                     deadline_s: float | None) -> None:
        """Build + submit the step's internal chunk request and open its
        SESSION_STEP span. Shared by ``step`` and resume's replay of
        journaled-but-unsubmitted steps."""
        fam = self.server.families[sess.family]
        if self.server.tracer is not None:
            step.span = self.server.tracer.begin(
                trace_mod.SESSION_STEP, parent=None,
                trace_id=sess.trace_id, session_id=sess.session_id,
                step_seq=step.step_seq, request_id=step.request_id,
            )
        inner = self.server.tickets.get(step.request_id)
        if inner is not None and not inner.done:
            # The step's identity is already admitted: the crash landed
            # between the server journal append and the session's, so
            # resume restored the inner request with no session-step
            # handle, and the client is retrying the unacked seq (a
            # retry MUST carry the original delta — the request content
            # is derived from the same journaled pre-step state).
            # Reattach instead of double-submitting the same rid.
            step.ticket = inner
        else:
            step.ticket = self.server.submit(queue_mod.ScenarioRequest(
                family=sess.family, horizon=fam.chunk_len,
                x0=tuple(float(val) for val in sess.x),
                v0=tuple(float(val) for val in sess.v),
                deadline_s=deadline_s, request_id=step.request_id,
                trace_id=sess.trace_id, session=sess.session_id,
            ))
        if step.ticket.done:
            # Admission rejected (queue full / tenant throttled /
            # coverage lost) or an immediate deadline verdict: resolve
            # the step in place so the caller never polls a dead inner
            # ticket (and, on rejection, rolls back its tentative
            # commit).
            self._resolve_step(step)
            return
        self.steps_accepted += 1
        self._emit_session(kind="step_submitted",
                           session_id=sess.session_id,
                           step_seq=step.step_seq,
                           request_id=step.request_id)
        self._steps[step.request_id] = step

    def _resolve_step(self, step: StepTicket) -> None:
        ticket = step.ticket
        cur = self.sessions.get(step.session_id)
        # Fencing applies to RESULTS too: a step submitted by a
        # superseded incarnation (the session re-opened while it was in
        # flight) resolves its OWN ticket but must never write
        # last_result / lane bookkeeping onto the new incarnation — a
        # later hold_last would otherwise serve the fenced epoch's
        # control.
        sess = (cur if cur is not None and cur.epoch == step.epoch
                else None)
        slo = ticket.slo.to_event()
        step.latency_s = slo.get("latency_s")
        if sess is not None and ticket.lane is not None:
            sess.lane = ticket.lane
            sess.batch_id = ticket.batch_id
        if ticket.status == queue_mod.COMPLETED:
            step.result = ticket.result
            step.rung = RUNG_SERVED
            step.status = queue_mod.COMPLETED
            if sess is not None:
                sess.last_result = ticket.result
            self._emit_session(kind="step_done",
                               session_id=step.session_id,
                               step_seq=step.step_seq, rung=step.rung,
                               request_id=step.request_id, slo=slo)
        elif ticket.status in (queue_mod.DEADLINE_MISSED,
                               queue_mod.FAILED):
            # Graceful degradation: the step RESOLVES (completed, honest
            # rung) — the client applies the last served control, or is
            # told there is none to apply (no_control) when the miss (or
            # the card's failure of the step's chunk) precedes the
            # session's first served step. The late fresh result, when
            # the miss was in_flight, still refreshes hold-last state for
            # the NEXT degradation.
            self.steps_degraded += 1
            step.missed = ticket.slo.missed
            step.reason = ticket.reason
            held = sess.last_result if sess is not None else None
            step.rung = (RUNG_HOLD_LAST if held is not None
                         else RUNG_NO_CONTROL)
            step.result = held
            step.status = queue_mod.COMPLETED
            if sess is not None and ticket.result is not None:
                sess.last_result = ticket.result
            self._emit_session(kind="step_degraded",
                               session_id=step.session_id,
                               step_seq=step.step_seq, rung=step.rung,
                               missed=step.missed,
                               request_id=step.request_id, slo=slo,
                               **({"reason": step.reason}
                                  if step.reason else {}))
        else:  # REJECTED by admission — structured pass-through.
            step.status = queue_mod.REJECTED
            step.reason = ticket.reason
            self._emit_session(kind="step_done",
                               session_id=step.session_id,
                               step_seq=step.step_seq, rung="rejected",
                               reason=step.reason,
                               request_id=step.request_id)
        if step.span is not None:
            self.server.tracer.end(step.span, status=step.status,
                                   rung=step.rung or "rejected")
        self._steps.pop(step.request_id, None)

    def pump(self) -> bool:
        """One session-tier round: sweep leases, pump the server, then
        resolve every finished step. Returns True while work remains."""
        self.sweep()
        more = self.server.pump()
        for step in [s for s in self._steps.values()
                     if s.ticket is not None and s.ticket.done]:
            self._resolve_step(step)
        return more or bool(self._steps)

    # ------------------------------------------------------------ stats --
    def stats(self) -> dict:
        live = sum(1 for s in self.sessions.values() if s.status == LIVE)
        return {
            "sessions": len(self.sessions),
            "live": live,
            "evicted": self.evictions,
            "fenced_rejections": self.fence_rejections,
            "stale_rejections": self.stale_rejections,
            "steps_accepted": self.steps_accepted,
            "steps_degraded": self.steps_degraded,
            "steps_in_flight": len(self._steps),
        }

    # ----------------------------------------------------------- resume --
    @classmethod
    def resume(cls, server, *, lease_s=None, clock=None,
               step_deadline_s: float | None = None) -> "SessionHost":
        """Rebuild the session table from the (already-resumed) server's
        journal: lease epochs and the fence set replay from open/evict/
        close events, watermarks and the exact float64 state from the
        last accepted step (epoch-guarded: a superseded incarnation's
        journal rows never advance, and are never reattached to, the
        incarnation that replaced it). Leases RE-ARM (fresh TTL from
        now — the monotonic domain died with the process). Restored
        in-flight steps are reattached so ``pump`` resolves them
        normally; a journaled step with no server record (defensive —
        the live path journals only after admission accepts) is
        resubmitted from its journaled post-delta state."""
        host = cls(server, lease_s=lease_s, clock=clock,
                   step_deadline_s=step_deadline_s)
        if server.journal is None:
            return host
        step_events: dict[str, dict] = {}   # request_id -> event (order).
        for e in server.journal.read():
            ev = e.get("event")
            if ev == "session_open":
                sid = e["session_id"]
                prev = host.sessions.get(sid)
                if prev is not None:
                    host._fenced[prev.lease] = sid
                sess = Session(sid, e["family"], e["lease"], e["epoch"],
                               e["x"], e["v"], e.get("trace_id"),
                               e.get("deadline_s"))
                host.sessions[sid] = sess
            elif ev == "session_step":
                sess = host.sessions.get(e["session_id"])
                # Epoch guard: a step journaled by a superseded
                # incarnation must not advance the incarnation that
                # replaced it (replay order already makes this hold for
                # well-formed journals; the guard keeps a truncated or
                # hand-edited journal from corrupting the watermark).
                if (sess is not None
                        and int(e.get("epoch", 0)) == sess.epoch):
                    sess.step_seq = int(e["step_seq"])
                    sess.x = np.asarray(e["x"], dtype=np.float64)
                    sess.v = np.asarray(e["v"], dtype=np.float64)
                step_events[e["request_id"]] = e
            elif ev == "session_evict":
                sess = host.sessions.get(e["session_id"])
                if sess is not None and sess.status == LIVE:
                    sess.status = EVICTED
                host._fenced[e["lease"]] = e["session_id"]
            elif ev == "session_close":
                sess = host.sessions.get(e["session_id"])
                if sess is not None:
                    sess.status = CLOSED
                    host._fenced[sess.lease] = sess.session_id
        now = host.clock()
        live = 0
        for sess in host.sessions.values():
            if sess.status == LIVE:
                live += 1
                host._renew(sess, now)
        reattached = 0
        for rid, e in step_events.items():
            if rid in server.done_requests:
                continue
            sess = host.sessions[e["session_id"]]
            if int(e.get("epoch", 0)) != sess.epoch:
                # A superseded incarnation's unfinished step: fenced.
                # Its restored inner ticket (if any) resolves server-
                # side as an orphan; the session tier never reattaches
                # it, so it can never write onto the new incarnation.
                continue
            step = StepTicket(sess.session_id, int(e["step_seq"]), rid,
                              epoch=sess.epoch)
            inner = server.tickets.get(rid)
            if inner is not None:
                # Restored (or replayed) by ScenarioServer.resume: just
                # rebind the session-step handle.
                step.ticket = inner
                host._steps[rid] = step
                if server.tracer is not None:
                    step.span = server.tracer.begin(
                        trace_mod.SESSION_STEP, parent=None,
                        trace_id=sess.trace_id,
                        session_id=sess.session_id,
                        step_seq=step.step_seq, request_id=rid,
                        restored=True,
                    )
            elif sess.step_seq == step.step_seq and sess.status == LIVE:
                # Accepted pre-crash, never reached the server journal:
                # resubmit from the journaled post-delta state (only the
                # watermark step can be in this gap — earlier ones are
                # in the server journal or done).
                host._submit_step(sess, step, e.get("deadline_s"))
            reattached += 1
        host._emit_session(kind="sessions_resumed", live=live,
                           sessions=len(host.sessions),
                           steps_reattached=reattached)
        return host
