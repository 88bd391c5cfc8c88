"""Continuous batching: heterogeneous requests grouped by shape bucket into
batches that reuse one chunk program per family.

Counterpart of the JAX package's ``serving/batcher.py``. A **family** is a
served program: controller + agent count + chunk shape
(:class:`FamilySpec`, pure data). Its program is the chunked rollout's
chunk ``(carry, i0) -> (carry, logs)`` (``harness.rollout
.make_chunked_rollout``), which in the port is already batched: the lanes
are the rollout's leading scenario axis, so there is no vmap. Batch
shapes are keyed on ``(family, bucket)`` and never churn: partially-full
batches pad with quarantined filler lanes (copies of the family template
whose results are discarded), and the bucket for a group of admitted
requests is the smallest admitting one (``harness.bucketing
.pick_bucket``). On the card each bucket is one CUDA-graph capture of the
substeps, made at its first chunk.

Chunk boundaries are the continuous-batching seam: after every chunk,
lanes whose requests finished their horizon are harvested (result = the
lane's slice of the boundary carry) and late-arriving requests of the
same family are admitted into the freed/filler lanes by lane surgery on
the boundary carry -- no reshape, no new capture.

Lane independence contract: a lane's result must not depend on which
OTHER lanes share its batch (admission order, filler contents) or on the
batch's global step offset. The first holds because the port's consensus
loops freeze converged lanes exactly while the worst lane iterates (the
``active`` masks of ``control/cadmm.py`` and ``control/dd.py``), and
every other operation is per lane; the second is why :func:`_build_chunk`
builds a TIME-INVARIANT tracking reference (``acc_des_fn`` ignores
``t``) -- lanes admitted at different chunk boundaries run at different
global offsets inside one batch.

A :class:`Family` lives on one ``device`` (default the card), where its
program is built lazily at the first chunk.
"""

from __future__ import annotations

import dataclasses

import torch

from tpu_aerial_transport_torch import resolve_device
from tpu_aerial_transport_torch.harness.bucketing import pick_bucket
from tpu_aerial_transport_torch.obs import phases
from tpu_aerial_transport_torch.serving import queue as queue_mod
from tpu_aerial_transport_torch.tree import leaves, tree_map

# Default shape buckets.
DEFAULT_BUCKETS = (8, 16, 32)


@dataclasses.dataclass(frozen=True)
class FamilySpec:
    """One served program family (pure data: hashable, journalable).
    ``entry`` names the family's registry and AOT-bundle entry
    (``analysis.contracts``; the canonical families have one), under
    which a bundled server serves its chunks; a family without one serves
    eagerly under its own name.
    ``surgery_entry`` names the family's device lane-surgery entry: None
    => host splice only, whatever the server's surgery mode."""

    name: str
    controller: str = "cadmm"
    n: int = 4
    chunk_len: int = 2
    hl_rel_freq: int = 2
    max_iter: int = 2
    inner_iters: int = 4
    entry: str | None = None
    surgery_entry: str | None = None

    def to_json(self) -> dict:
        return dataclasses.asdict(self)


# The canonical families, the JAX package's (names, entries and knobs).
CANONICAL_FAMILIES: dict[str, FamilySpec] = {
    "cadmm4": FamilySpec(
        name="cadmm4", controller="cadmm", n=4,
        entry="serving.batcher:serving_chunk",
        surgery_entry="serving.lanes:lane_surgery",
    ),
    "centralized4": FamilySpec(
        name="centralized4", controller="centralized", n=4,
        entry="serving.batcher:serving_chunk_centralized",
        surgery_entry="serving.lanes:lane_surgery_centralized",
    ),
}


class Family:
    """A family's handles on ``device``. The program is built lazily
    (:attr:`batched_fn`); the template carry is its initial carry, copied
    to the host."""

    def __init__(self, spec: FamilySpec, device="cuda"):
        self.spec = spec
        self.device = resolve_device(device)
        self._program: tuple | None = None
        self._template_host = None
        self._templates_b: dict[int, object] = {}
        self._templates_dev: dict[int, object] = {}
        self._config_hash: str | None = None

    @property
    def name(self) -> str:
        return self.spec.name

    @property
    def chunk_len(self) -> int:
        return self.spec.chunk_len

    @property
    def entry(self) -> str | None:
        return self.spec.entry

    @property
    def surgery_entry(self) -> str | None:
        return self.spec.surgery_entry

    # ---------------------------------------------------- lazy builds --
    def _build(self):
        if self._program is None:
            self._program = _build_chunk(self.spec, self.device)
        return self._program

    @property
    def chunk_fn(self):
        """The family's chunk on its device: ``(carry, i0) -> (carry,
        logs)`` over carries with a leading lane axis."""
        return self._build()[0]

    @property
    def batched_fn(self):
        """The served chunk: :attr:`chunk_fn` in the ``tat.serving_chunk``
        scope (the counterpart of the JAX package's vmapped entry)."""
        return _scoped(self.chunk_fn)

    def template_carry_host(self):
        """The family's canonical initial lane carry (one lane, no lane
        axis) as CPU tensors: the device program's initial carry (identity
        attitudes, equilibrium warm starts), copied to the host."""
        if self._template_host is None:
            self._template_host = tree_map(
                lambda t: t.detach().to("cpu", copy=True),
                self._build()[1])
        return self._template_host

    def set_template_carry_host(self, template) -> None:
        """Install an externally sourced template (an AOT bundle's
        ``args_sample`` lane, CPU tensors): no state factory runs for it."""
        self._template_host = template
        self._templates_b = {}
        self._templates_dev = {}

    def batched_template_host(self, bucket: int):
        """The template carry stacked to ``bucket`` lanes on the host
        (cached per bucket): the batch padding source."""
        if bucket not in self._templates_b:
            self._templates_b[bucket] = _stack(self.template_carry_host(),
                                               bucket)
        return self._templates_b[bucket]

    def batched_template(self, bucket: int):
        """:meth:`batched_template_host` on the family's device (cached):
        the device lane surgery's ``template_b`` operand."""
        if bucket not in self._templates_dev:
            self._templates_dev[bucket] = tree_map(
                lambda t: t.to(self.device, copy=True),
                self.batched_template_host(bucket))
        return self._templates_dev[bucket]

    # ------------------------------------------------- host-side lanes --
    def lane_carry(self, template, request: queue_mod.ScenarioRequest):
        """A fresh lane carry for ``request``: the template with the
        scenario's initial payload position/velocity written in (CPU
        tensors)."""
        state, rest = template[0], template[1:]
        dtype = state.xl.dtype
        state = state.replace(
            xl=torch.tensor(request.x0, dtype=dtype).reshape(3),
            vl=torch.tensor(request.v0, dtype=dtype).reshape(3),
        )
        return (state,) + tuple(rest)

    def lane_result(self, carry_host, lane: int):
        """A completed lane's deliverable: the final SCENARIO STATE (carry
        element 0), copied out of the boundary carry. The controller state
        (warm starts, duals, residual diagnostics) is server-internal and
        deliberately excluded, as in the JAX package."""
        return tree_map(lambda t: t[lane].clone(), carry_host[0])

    def config_hash(self) -> str:
        # Memoised: the spec is frozen and the result-cache path hashes
        # per submit.
        if self._config_hash is None:
            from tpu_aerial_transport_torch.harness.checkpoint import (
                config_fingerprint,
            )

            self._config_hash = config_fingerprint(
                family=self.spec.to_json()
            )
        return self._config_hash


def _scoped(chunk):
    def batched(carry, i0):
        with phases.scope(phases.SERVING_CHUNK):
            return chunk(carry, i0)

    return batched


def _stack(tree, bucket: int):
    return tree_map(lambda t: t.expand((bucket,) + t.shape).clone(), tree)


def _build_chunk(spec: FamilySpec, device: torch.device):
    """``(chunk, initial lane carry)`` of the family on ``device``. The
    tracking reference is TIME-INVARIANT (PD toward a fixed hover anchor;
    ``acc_des_fn`` drops ``t``): see the module docstring's lane
    independence contract. The agent QPs keep the JAX family's padded
    operators (``pad_operators=True``), so the carries have the JAX
    package's shapes on every device."""
    from tpu_aerial_transport_torch.control import centralized, lowlevel
    from tpu_aerial_transport_torch.harness import rollout as h_rollout
    from tpu_aerial_transport_torch.harness import setup

    params, col, state0 = setup.rqp_setup(spec.n, device=device)
    f_eq = centralized.equilibrium_forces(params)
    llc = lowlevel.make_lowlevel_controller("pd", params)
    anchor = torch.zeros(3, dtype=torch.float32, device=device)

    def acc_des_fn(state, t):
        del t  # time-invariant: lanes at different offsets are legal.
        dvl = -1.0 * state.vl - 1.0 * (state.xl - anchor)
        return (dvl, torch.zeros_like(dvl)), anchor, torch.zeros_like(anchor)

    if spec.controller in ("cadmm", "dd"):
        from tpu_aerial_transport_torch.control import cadmm, dd

        mod = cadmm if spec.controller == "cadmm" else dd
        cfg = mod.make_config(
            params, col.collision_radius, col.max_deceleration,
            max_iter=spec.max_iter, inner_iters=spec.inner_iters,
            pad_operators=True, device=device,
        )
        if spec.controller == "cadmm":
            plan = cadmm.make_plan(params, cfg)
            cs0 = cadmm.init_cadmm_state(params, cfg, f_eq)
        else:
            plan = dd.make_dd_plan(params, cfg)
            cs0 = dd.init_dd_state(params, cfg, f_eq)

        def hl(cs, s, a):
            return mod.control(params, cfg, f_eq, cs, s, a, plan=plan)

    elif spec.controller == "centralized":
        cfg = centralized.make_config(
            params, col.collision_radius, col.max_deceleration,
            solver_iters=max(spec.inner_iters, 4),
        )
        cs0 = centralized.init_ctrl_state(params, cfg, f_eq)

        def hl(cs, s, a):
            return centralized.control(params, cfg, f_eq, cs, s, a)

    else:
        raise ValueError(f"unknown serving controller {spec.controller!r}")

    run = h_rollout.make_chunked_rollout(
        hl, llc.control, params,
        n_hl_steps=spec.chunk_len, n_chunks=1,
        hl_rel_freq=spec.hl_rel_freq, acc_des_fn=acc_des_fn,
    )
    return run.chunk_fn, run.init_carry(state0, cs0)


def make_family(spec: FamilySpec | str, device="cuda") -> Family:
    if isinstance(spec, str):
        spec = CANONICAL_FAMILIES[spec]
    return Family(spec, device=device)


# ----------------------------------------------------------------------
# The per-family continuous batch.
# ----------------------------------------------------------------------

_next_batch_id = 0


def _alloc_batch_id() -> int:
    global _next_batch_id
    i = _next_batch_id
    _next_batch_id += 1
    return i


def reserve_batch_ids(past: int) -> None:
    """Advance the process-wide batch-id allocator so every FUTURE batch id
    is >= ``past`` (never moves it backward). ``ScenarioServer.resume``
    calls this with (max journaled batch id + 1): a fresh process's
    allocator restarts at 0, and a post-resume launch reusing a journaled
    id would collide with the restored batch's snapshot prefix
    (``serving_b<id>``) and journal identity."""
    global _next_batch_id
    _next_batch_id = max(_next_batch_id, past)


class Batch:
    """Host bookkeeping for one in-flight batch of ``bucket`` lanes. The
    device carry itself is owned by the server (which runs the chunks);
    this class owns lane assignment, per-lane remaining-chunk counts, SLO
    transitions and the host copy of the boundary carry."""

    def __init__(self, family: Family, bucket: int, template,
                 clock, emit, batch_id: int | None = None):
        self.family = family
        self.bucket = bucket
        self.batch_id = (_alloc_batch_id() if batch_id is None
                         else batch_id)
        self.clock = clock
        self.emit = emit
        # Filler lanes = template copies; results discarded (quarantined).
        self.carry_host = _stack(template, bucket)
        self.tickets: list[queue_mod.Ticket | None] = [None] * bucket
        self.remaining = [0] * bucket
        self.chunks_done = 0
        self.occupancy_samples: list[float] = []
        # Device-surgery mode: the post-surgery carry stays on the card
        # between chunks; carry_host is then only refreshed for snapshot
        # publication. None => host mode.
        self.carry_dev = None
        # Pipelined dispatch: the not-yet-waited-on chunk dispatch
        # (server-owned record; discarded on preemption/retire).
        self.inflight = None

    # --------------------------------------------------------- lanes ---
    @property
    def active_lanes(self) -> int:
        return sum(t is not None for t in self.tickets)

    @property
    def retired(self) -> bool:
        return self.active_lanes == 0

    def free_lanes(self) -> list[int]:
        return [i for i, t in enumerate(self.tickets) if t is None]

    def admit(self, ticket: queue_mod.Ticket, lane: int,
              remaining: int | None = None, *,
              write_carry: bool = True) -> None:
        """Lane surgery at a boundary (or at launch): write the request's
        initial carry into ``lane`` of the host boundary carry and start
        its chunk countdown. ``write_carry=False`` is the device-surgery
        path: the carry write already happened on the card
        (``serving.lanes.lane_surgery``) and this call does the ticket/SLO
        bookkeeping only."""
        req = ticket.request
        if write_carry:
            lane_carry = self.family.lane_carry(
                self.family.template_carry_host(), req
            )
            for dst, src in zip(leaves(self.carry_host),
                                leaves(lane_carry)):
                dst[lane] = src
        self.tickets[lane] = ticket
        self.remaining[lane] = (
            req.horizon // self.family.chunk_len
            if remaining is None else remaining
        )
        ticket.batch_id = self.batch_id
        ticket.lane = lane
        ticket.slo.t_admit = self.clock()
        if ticket.trace is not None:
            ticket.trace.admitted(batch_id=self.batch_id, lane=lane,
                                  bucket=self.bucket)
        self.emit(kind="admitted", request_id=req.request_id,
                  family=self.family.name, batch_id=self.batch_id,
                  lane=lane, bucket=self.bucket)

    def restore_lane(self, ticket: queue_mod.Ticket, lane: int,
                     remaining: int) -> None:
        """Resume-path bookkeeping ONLY: bind a ticket to a lane whose
        carry was just restored from a boundary snapshot -- no lane
        surgery (writing the template over the restored mid-flight carry
        would restart the scenario)."""
        self.tickets[lane] = ticket
        self.remaining[lane] = remaining
        ticket.batch_id = self.batch_id
        ticket.lane = lane
        ticket.slo.t_admit = self.clock()
        if ticket.trace is not None:
            ticket.trace.admitted(batch_id=self.batch_id, lane=lane,
                                  bucket=self.bucket, restored=True)
        self.emit(kind="admitted", request_id=ticket.request.request_id,
                  family=self.family.name, batch_id=self.batch_id,
                  lane=lane, bucket=self.bucket, restored=True)

    # ------------------------------------------------------ boundary ---
    def record_launch(self) -> None:
        """Called just before each chunk dispatch: stamp t_launch on newly
        admitted lanes and sample occupancy."""
        now = self.clock()
        for t in self.tickets:
            if t is not None and t.slo.t_launch is None:
                t.slo.t_launch = now
        self.occupancy_samples.append(self.active_lanes / self.bucket)

    def plan_finishing(self) -> list[int]:
        """Lanes whose requests finish at the NEXT boundary (their chunk
        countdown hits zero): host admission-counter arithmetic,
        independent of the chunk's numeric results -- what makes the
        device boundary plan (and pipelined dispatch) legal."""
        return [lane for lane, t in enumerate(self.tickets)
                if t is not None and self.remaining[lane] <= 1]

    def harvest(self, state_host=None) -> list[queue_mod.Ticket]:
        """Process one completed chunk boundary: decrement countdowns,
        resolve lanes that finished their horizon (deadline-classified),
        free their lanes. Returns the resolved tickets.

        ``state_host`` (device-surgery mode): the harvested batched
        scenario state (the surgery's second output, copied to the host),
        read for lane results instead of ``carry_host`` (which device mode
        does not refresh per boundary)."""
        self.chunks_done += 1
        now = self.clock()
        results_src = (
            (state_host,) if state_host is not None else self.carry_host
        )
        finished: list[queue_mod.Ticket] = []
        for lane, ticket in enumerate(self.tickets):
            if ticket is None:
                continue
            self.remaining[lane] -= 1
            if self.remaining[lane] > 0:
                continue
            ticket.slo.t_complete = now
            ticket.result = self.family.lane_result(results_src, lane)
            ticket.steps_served = (
                ticket.request.horizon // self.family.chunk_len
            ) * self.family.chunk_len
            slo = ticket.slo
            if slo.deadline_at is not None and now > slo.deadline_at:
                slo.missed = queue_mod.MISSED_IN_FLIGHT
                ticket._resolve(queue_mod.DEADLINE_MISSED)
                self.emit(kind="deadline_missed",
                          request_id=ticket.request.request_id,
                          family=self.family.name,
                          batch_id=self.batch_id,
                          missed=queue_mod.MISSED_IN_FLIGHT,
                          slo=slo.to_event())
                if ticket.trace is not None:
                    ticket.trace.resolve(
                        queue_mod.DEADLINE_MISSED,
                        missed=queue_mod.MISSED_IN_FLIGHT,
                    )
            else:
                ticket._resolve(queue_mod.COMPLETED)
                self.emit(kind="completed",
                          request_id=ticket.request.request_id,
                          family=self.family.name,
                          batch_id=self.batch_id,
                          steps=ticket.steps_served,
                          slo=slo.to_event())
                if ticket.trace is not None:
                    ticket.trace.resolve(queue_mod.COMPLETED,
                                         steps=ticket.steps_served)
            self.tickets[lane] = None
            finished.append(ticket)
        return finished

    def lanes_json(self) -> list[list]:
        """Journal form of the lane map (resume reads it back), the JAX
        server's ``[[lane, request_id, remaining], ...]``."""
        return [
            [lane, t.request.request_id, int(self.remaining[lane])]
            for lane, t in enumerate(self.tickets) if t is not None
        ]

    def lane_map(self) -> list[list]:
        """Trace form of the lane map: ``[[lane, request_id, trace_id],
        ...]``, the attribute that links every member request's trace to
        the batch's shared device spans."""
        return [
            [lane, t.request.request_id,
             t.trace.trace_id if t.trace is not None
             else t.request.trace_id]
            for lane, t in enumerate(self.tickets) if t is not None
        ]


def bucket_for(pending: int, buckets) -> int:
    """Batch size for ``pending`` waiting requests: the smallest admitting
    bucket, or the largest bucket when more are waiting than any bucket
    holds (the rest stay queued for the next batch/boundary)."""
    bs = sorted(buckets)
    picked = pick_bucket(min(pending, bs[-1]), bs)
    return bs[-1] if picked is None else picked
