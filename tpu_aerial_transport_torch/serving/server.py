"""The scenario-serving driver: admission queue + continuous batcher wired
to the card through the backend guard and the serve ladder.

Counterpart of the JAX package's ``serving/server.py``. Rules of the road:

- **every interaction with the card goes through**
  ``resilience.backend.BackendGuard``: a classified failure of a chunk on
  the card (a wedge, a crash, an OOM; or the circuit open after repeated
  ones) journals a ``backend_event`` and ends the chunk's requests with
  status ``failed`` and the error's kind as their reason, journaled and
  counted in :meth:`stats`, instead of killing the server loop; the rest
  of the queue goes on in new batches. Nothing is recomputed on the CPU.
  A server on the CPU (``device="cpu"``) reruns a failed chunk on the
  guard's tagged CPU rung, as the JAX server does on a host with no
  accelerator;
- **every call is served through** ``aot.loader.serve_entry``: a bundled
  server (``bundle=``) serves its chunks and lane surgeries on the
  ``bundle_exec`` rung, its kernel libraries installed from the bundle
  (no ``nvcc`` in the process) and, under ``require_bundle=True``, its
  template carries from the bundle's ``args_sample`` and admission
  limited to the families and buckets the bundle covers; an un-bundled
  server takes the eager rungs (``eager_cached``/``eager_cold``);
- **preemption safety rides the recovery journal**: every chunk boundary
  publishes an atomic carry snapshot and a journaled lane map (the JAX
  server's JSON, so either package's reader reads both), so a SIGTERM
  mid-batch completes at the boundary and :meth:`ScenarioServer.resume`
  re-admits the remainder -- recomputed chunks are bitwise the
  uninterrupted run's.

The server is host-synchronous by design (``pump()`` drives one
scheduling round; ``run_until_drained()`` loops it) and only the pumping
thread touches CUDA: the async surface is the ticket -- ``submit()``
never waits for device work, and consumers ``Ticket.wait()`` from their
own threads on results already copied to the host.
"""

from __future__ import annotations

import dataclasses
import time

from tpu_aerial_transport_torch import resolve_device
from tpu_aerial_transport_torch.aot import loader as loader_mod
from tpu_aerial_transport_torch.aot.bundle import BundleError
from tpu_aerial_transport_torch.harness import checkpoint
from tpu_aerial_transport_torch.obs import export as export_mod
from tpu_aerial_transport_torch.obs import trace as trace_mod
from tpu_aerial_transport_torch.parallel import mesh as mesh_mod
from tpu_aerial_transport_torch.parallel import pods as pods_mod
from tpu_aerial_transport_torch.resilience import backend as backend_mod
from tpu_aerial_transport_torch.resilience.recovery import (
    RunJournal,
    host_copy,
)
from tpu_aerial_transport_torch.serving import batcher as batcher_mod
from tpu_aerial_transport_torch.serving import cache as cache_mod
from tpu_aerial_transport_torch.serving import lanes as lanes_mod
from tpu_aerial_transport_torch.serving import queue as queue_mod
from tpu_aerial_transport_torch.serving.batcher import (
    DEFAULT_BUCKETS,
    Batch,
    Family,
    make_family,
)
from tpu_aerial_transport_torch.tree import tree_map

SERVING_JOURNAL = "serving_journal.jsonl"
SNAP_PREFIX = "serving_b"  # + batch_id (checkpoint prefix grammar: no '-').


class ScenarioServer:
    """Serve a heterogeneous scenario-MPC request stream on ``device``.

    ``families``: iterable of :class:`FamilySpec` / canonical-family names
    / :class:`Family` (default: the canonical families), each built on
    ``device`` (default the card; ``"cpu"`` runs the plain PyTorch path).
    ``run_dir`` turns on preemption safety (journal + per-boundary
    snapshots). ``guard`` (a ``BackendGuard``; default one whose primary
    rung is ``device``'s) guards every dispatch. ``surgery``/``dispatch``:
    the lane-surgery and dispatch knobs (``serving.lanes``). ``cache``: a
    ``ResultCache`` or an LRU capacity (None disables it). ``tracer`` (an
    ``obs.trace.Tracer``) and ``hub`` (an ``obs.live.MetricsHub``, handed
    on to the queue, the guard and the serve ladder) are optional sinks;
    None is the zero-cost path.

    ``mesh`` (a ``parallel.pods.make_pods_mesh`` mesh, or a one-axis
    ``parallel.mesh.Mesh``) places each chunk's batch through
    ``parallel.mesh.shard_scenarios``: on a multi-process mesh each
    process runs its slab of scenario rows and the boundary carry is
    gathered whole on every process (``parallel.pods.host_global``), so
    every process of the mesh runs the same server on the same request
    stream; on one process the card holds the whole batch and the results
    are the meshless server's bit for bit. A batch bucket must divide
    over the mesh's scenario shards. The boundary gather is host surgery,
    so ``surgery="device"`` (and pipelined dispatch, which implies it)
    with a mesh is a ValueError.

    ``bundle``: an ``aot.loader.Bundle`` or a bundle directory. The
    buckets the bundle carries for a family join the configured ones;
    ``require_bundle=True`` makes bundle coverage an admission criterion
    (an uncovered family is rejected at admission, a covered one batches
    only at the bundle's buckets), serves with no eager fallback, and
    takes each covered family's template carry from the bundle (lane 0 of
    its ``args_sample``, copied), raising when that is missing; a bundle
    built for another runtime (``bundle_stale``) or platform raises at
    construction. A bundle
    pins kernels, shapes and templates; the program is the live tree's,
    so results are bitwise the bundle-less server's on the same device.
    """

    def __init__(self, families=None, *, buckets=DEFAULT_BUCKETS,
                 capacity: int = 256, bundle=None,
                 require_bundle: bool = False, run_dir: str | None = None,
                 metrics=None, guard=None, interrupt=None, mesh=None,
                 tracer=None, clock=time.monotonic,
                 surgery: str | None = None, dispatch: str | None = None,
                 cache=None, hub=None, device="cuda"):
        self.device = resolve_device(device)
        self.surgery = lanes_mod.resolve_surgery(surgery)
        self.dispatch = lanes_mod.resolve_dispatch(dispatch)
        if self.dispatch == "pipelined":
            # A host splice needs chunk k's values on the host before
            # chunk k+1 can start -- the serialisation pipelining removes
            # -- so pipelined dispatch implies device surgery.
            self.surgery = "device"
        if self.surgery == "device" and mesh is not None:
            raise ValueError(
                "surgery='device' is single-device serving only: the "
                "mesh path gathers host-global boundary carries "
                "(pods.host_global), which IS host surgery. Use "
                "surgery='host' (default) with a mesh."
            )
        if mesh is not None and getattr(mesh, "device", self.device) \
                != self.device:
            raise ValueError(f"the mesh computes on {mesh.device}, the "
                             f"server on {self.device}")
        self.mesh = mesh
        if cache is None or isinstance(cache, cache_mod.ResultCache):
            self.cache = cache
        else:
            self.cache = cache_mod.ResultCache(int(cache))

        if families is None:
            families = list(batcher_mod.CANONICAL_FAMILIES.values())
        self.families: dict[str, Family] = {}
        for f in families:
            fam = f if isinstance(f, Family) else make_family(
                f, device=self.device)
            if fam.device != self.device:
                raise ValueError(
                    f"family {fam.name!r} lives on {fam.device}, the "
                    f"server on {self.device}")
            self.families[fam.name] = fam
        self.buckets = tuple(sorted(buckets))
        self.require_bundle = require_bundle
        if isinstance(bundle, str):
            bundle = loader_mod.load_bundle(bundle)
        self.bundle = bundle
        if bundle is not None and require_bundle:
            # A required bundle that cannot serve here refuses up front,
            # with its rebuild hint, not chunk by chunk.
            bundle.check_runtime(self.device.type)
        self._install_bundle_templates()
        self.clock = clock
        if isinstance(metrics, str):
            metrics = export_mod.MetricsWriter(metrics)
        self.metrics = metrics
        self.tracer = tracer
        self._server_trace = (None if tracer is None
                              else trace_mod.new_trace_id())
        self.hub = hub
        # `is None`, not truthiness: a caller-built guard must be used even
        # if it tests falsy.
        self.guard = (backend_mod.BackendGuard(
            metrics=metrics, hub=hub,
            primary_rung=(backend_mod.RUNG_ONCHIP
                          if self.device.type == "cuda"
                          else backend_mod.RUNG_CPU))
            if guard is None else guard)
        self.interrupt = interrupt
        self.preempted = False
        self.run_dir = run_dir
        self.journal = (RunJournal(run_dir, SERVING_JOURNAL)
                        if run_dir else None)
        # The guard's backend_event rows land in this server's sinks
        # unless the caller wired its own.
        for attr, sink in (("tracer", tracer), ("hub", hub),
                           ("metrics", metrics), ("journal", self.journal)):
            if getattr(self.guard, attr) is None:
                setattr(self.guard, attr, sink)

        self.queue = queue_mod.AdmissionQueue(
            self._coverage, capacity=capacity, clock=clock,
            emit=self._emit, tracer=tracer, hub=hub,
        )
        self.tickets: dict[str, queue_mod.Ticket] = {}
        self.done_requests: set[str] = set()  # filled by resume().
        self._batches: dict[str, Batch | None] = {}
        self._occupancy: list[float] = []
        # Chunk dispatches by the guard rung they ran at, and chunks whose
        # card work failed (their requests ended ``failed``).
        self.dispatch_rungs: dict[str, int] = {}
        self.backend_failures = 0

    # ------------------------------------------------------- coverage --
    def _bundle_entry_buckets(self, fam: Family) -> list[int]:
        """Batch sizes the bundle carries for this family's chunk (empty
        when un-bundled or uncovered)."""
        if self.bundle is None or fam.entry is None:
            return []
        try:
            return self.bundle.batch_buckets(fam.entry)
        except BundleError:  # missing entry or manifest-only: no coverage.
            return []

    def _family_buckets(self, fam: Family) -> tuple[int, ...]:
        covered = self._bundle_entry_buckets(fam)
        if covered and self.require_bundle:
            return tuple(covered)
        if covered:
            # The bundle's buckets first; a configured bucket still serves
            # on an eager rung.
            return tuple(sorted(set(covered) | set(self.buckets)))
        return self.buckets

    def _coverage(self, family: str) -> int | None:
        fam = self.families.get(family)
        if fam is None:
            return None
        if self.require_bundle and not self._bundle_entry_buckets(fam):
            return None
        return fam.chunk_len

    def _install_bundle_templates(self) -> None:
        """Template carries from the bundle's build-time arguments: lane 0
        of the entry's recorded batch, copied to CPU tensors. A family the
        bundle does not cover keeps its own template, except under
        ``require_bundle``, where a covered family whose sample cannot be
        read raises (its state factories would otherwise run in the serve
        path unseen)."""
        if self.bundle is None:
            return
        for fam in self.families.values():
            if fam.entry is None:
                continue
            try:
                sample = self.bundle.sample_args(fam.entry)
            except BundleError:
                if self.require_bundle and self._bundle_entry_buckets(fam):
                    raise
                continue
            fam.set_template_carry_host(
                tree_map(lambda t: t[0].clone(), sample[0]))

    # ---------------------------------------------------------- events --
    def _emit(self, **fields) -> None:
        if self.metrics is not None:
            self.metrics.emit("serving_event", **fields)
        if self.hub is not None:
            self.hub.ingest_serving(fields)
        if self.journal is not None and fields.get("kind") in (
            "completed", "deadline_missed",
        ):
            self.journal.append({
                "event": "serving_done",
                "request_id": fields.get("request_id"),
                "status": fields["kind"],
            })

    # ---------------------------------------------------------- submit --
    def submit(self, request: queue_mod.ScenarioRequest) -> queue_mod.Ticket:
        """Admit or reject one request (never raises out of admission --
        rejection is a resolved ticket with a structured reason). With a
        result cache configured, a content-address hit resolves the ticket
        right here: no queue, no lane, no dispatch. Session steps
        (``request.session`` set) NEVER consult the cache: a cache-resolved
        step would skip the lane write the session's state stream is
        defined by."""
        if self.cache is not None and request.session is None:
            fam = self.families.get(request.family)
            if fam is not None:
                hit = self.cache.get(
                    cache_mod.request_key(fam.config_hash(), request)
                )
                if hit is not None:
                    return self._resolve_cached(request, fam, hit)
        ticket = self.queue.submit(request)
        self.tickets[request.request_id] = ticket
        if ticket.status == queue_mod.PENDING and self.journal is not None:
            # ticket.request, not the caller's argument: admission mints
            # the trace_id onto a replaced request object, and the journal
            # must carry it so a resume keeps the trace.
            self.journal.append({
                "event": "serving_request",
                "request": ticket.request.to_json(),
            })
        return ticket

    def _resolve_cached(self, request: queue_mod.ScenarioRequest,
                        fam: Family, hit) -> queue_mod.Ticket:
        """Resolve a content-address cache hit: a ticket outside the
        admission queue with a zero-length SLO window (submit = admit =
        complete), and ``cache_hit`` + ``completed`` events. The journal's
        ``serving_done`` record still lands (via ``_emit``)."""
        if self.tracer is not None and request.trace_id is None:
            request = dataclasses.replace(
                request, trace_id=trace_mod.new_trace_id()
            )
        ticket = queue_mod.Ticket(request)
        now = self.clock()
        ticket.slo.t_submit = now
        ticket.slo.t_admit = now
        ticket.slo.t_complete = now
        if self.tracer is not None:
            root = self.tracer.begin(
                trace_mod.REQUEST, parent=None,
                trace_id=request.trace_id,
                request_id=request.request_id, family=request.family,
                horizon=int(request.horizon), cached=True,
            )
            ticket.trace = trace_mod.RequestTrace(self.tracer, root)
        ticket.result, ticket.steps_served = hit
        ticket._resolve(queue_mod.COMPLETED)
        self.tickets[request.request_id] = ticket
        self._emit(kind="cache_hit", request_id=request.request_id,
                   family=request.family)
        self._emit(kind="completed", request_id=request.request_id,
                   family=request.family, steps=ticket.steps_served,
                   cached=True, slo=ticket.slo.to_event())
        if ticket.trace is not None:
            ticket.trace.resolve(queue_mod.COMPLETED,
                                 steps=ticket.steps_served, cached=True)
        return ticket

    def _cache_put(self, fam: Family, finished) -> None:
        """Populate the result cache from a boundary's resolved tickets:
        COMPLETED only, and never session steps."""
        if self.cache is None:
            return
        for t in finished:
            if (t.status == queue_mod.COMPLETED
                    and t.request.session is None):
                self.cache.put(
                    cache_mod.request_key(fam.config_hash(), t.request),
                    t.result, t.steps_served,
                )

    # ------------------------------------------------------ scheduling --
    def _check_preempt(self) -> bool:
        if (not self.preempted and self.interrupt is not None
                and self.interrupt.triggered):
            self.preempted = True
            if self.journal is not None:
                self.journal.append({
                    "event": "serving_preempted",
                    "signal": self.interrupt.triggered,
                })
            self._emit(kind="preempted", signal=self.interrupt.triggered)
        return self.preempted

    def has_work(self) -> bool:
        return bool(
            self.queue.depth()
            or any(b is not None and not b.retired
                   for b in self._batches.values())
        )

    def pump(self) -> bool:
        """One scheduling round: expire queue deadlines, launch batches for
        families with pending work, advance every active batch by one
        chunk (the boundary then harvests finished lanes and admits late
        arrivals). Returns True while work remains (False after preemption
        -- the remainder is journaled for :meth:`resume`)."""
        if self._check_preempt():
            return False
        self.queue.expire_deadlines()
        for name, fam in self.families.items():
            if self._check_preempt():
                return False
            batch = self._batches.get(name)
            if batch is None or batch.retired:
                if not self.queue.depth(name):
                    continue
                batch = self._launch(fam)
            self._advance(fam, batch)
        return self.has_work() and not self.preempted

    def run_until_drained(self, max_rounds: int | None = None) -> dict:
        rounds = 0
        while self.pump():
            rounds += 1
            if max_rounds is not None and rounds >= max_rounds:
                break
        return self.stats()

    # -------------------------------------------------------- batches --
    def _launch(self, fam: Family) -> Batch:
        bucket = batcher_mod.bucket_for(
            self.queue.depth(fam.name), self._family_buckets(fam)
        )
        span = None
        if self.tracer is not None:
            span = self.tracer.begin(
                trace_mod.BATCH_FORM, parent=None,
                trace_id=self._server_trace, family=fam.name,
                bucket=bucket,
            )
        try:
            batch = Batch(fam, bucket, fam.template_carry_host(),
                          self.clock, self._emit)
            self._batches[fam.name] = batch
            for lane, ticket in enumerate(
                self.queue.take(fam.name, bucket)
            ):
                batch.admit(ticket, lane)
        except BaseException:
            if span is not None:
                self.tracer.end(span, error=True)
            raise
        if span is not None:
            self.tracer.end(span, batch_id=batch.batch_id,
                            lanes=batch.lane_map())
        self._emit(kind="batch_launch", family=fam.name,
                   batch_id=batch.batch_id, bucket=bucket,
                   lanes=batch.active_lanes)
        return batch

    def _advance(self, fam: Family, batch: Batch) -> None:
        """Advance one batch by one chunk + its boundary. Device surgery
        needs the family's surgery entry: families without one take the
        host splice even in device mode."""
        try:
            if self.surgery == "device" and fam.surgery_entry is not None:
                self._advance_device(fam, batch)
            else:
                self._advance_host(fam, batch)
        except backend_mod.BackendError as err:
            self._fail_batch(fam, batch, err)

    def _fail_batch(self, fam: Family, batch: Batch,
                    err: backend_mod.BackendError) -> None:
        """A classified failure of the batch's work on the card (the
        guard's ``BackendError``, its ``backend_event`` already
        journaled): every request live in the batch ends ``failed`` with
        the error's kind as its reason (a ``serving_done`` journal row, so
        a resume does not replay it), and the batch retires. A client may
        resubmit: composition independence gives the result the request
        would have had."""
        self.backend_failures += 1
        for lane, ticket in enumerate(batch.tickets):
            if ticket is None:
                continue
            batch.tickets[lane] = None
            ticket._resolve(queue_mod.FAILED, err.kind)
            if ticket.trace is not None:
                ticket.trace.resolve(queue_mod.FAILED, reason=err.kind)
            if self.journal is not None:
                self.journal.append({
                    "event": "serving_done",
                    "request_id": ticket.request.request_id,
                    "status": queue_mod.FAILED, "reason": err.kind,
                })
        batch.carry_dev = None
        batch.inflight = None
        self._occupancy.extend(batch.occupancy_samples)

    def _chunk_once(self, fam: Family, batch: Batch, carry,
                    chunk_index: int, *, block: bool = True):
        """One chunk dispatch under its shared CHUNK_DISPATCH span (the
        lane map links every member request's trace to it). ``block=False``
        is the pipelined path: the span then measures the enqueue only,
        and the device wait surfaces in the boundary's harvest copy."""
        label = f"{fam.name}:b{batch.batch_id}:c{chunk_index}"
        i0 = chunk_index * fam.chunk_len
        dspan = None
        if self.tracer is not None:
            dspan = self.tracer.begin(
                trace_mod.CHUNK_DISPATCH, parent=None,
                trace_id=self._server_trace, family=fam.name,
                batch_id=batch.batch_id, chunk=chunk_index,
                bucket=batch.bucket, lanes=batch.lane_map(),
            )
        try:
            (out, serve_rung), guard_rung = self._dispatch(
                fam, (carry, i0), label, trace_parent=dspan, block=block
            )
        except BaseException:
            if dspan is not None:
                self.tracer.end(dspan, error=True)
            raise
        if dspan is not None:
            self.tracer.end(dspan, rung=serve_rung, guard_rung=guard_rung)
        self.dispatch_rungs[guard_rung] = (
            self.dispatch_rungs.get(guard_rung, 0) + 1)
        return out, serve_rung, guard_rung

    def _advance_host(self, fam: Family, batch: Batch) -> None:
        """The host boundary: the chunk on the card, the full boundary
        carry back to the host, the splice there."""
        batch.record_launch()
        carry = batch.carry_host
        if self.mesh is not None:
            carry = mesh_mod.shard_scenarios(self.mesh, carry, "scenario")
        out, serve_rung, guard_rung = self._chunk_once(
            fam, batch, carry, batch.chunks_done
        )
        self._boundary_host(fam, batch, out[0], serve_rung, guard_rung)

    def _boundary_host(self, fam: Family, batch: Batch, new_carry,
                       serve_rung, guard_rung) -> None:
        """Harvest, splice late joiners into freed lanes and publish, on a
        host copy of the boundary carry ``new_carry`` (a chunk's output, on
        the family's device)."""
        hspan = None
        if self.tracer is not None:
            hspan = self.tracer.begin(
                trace_mod.HARVEST, parent=None,
                trace_id=self._server_trace, family=fam.name,
                batch_id=batch.batch_id, chunk=batch.chunks_done + 1,
                lanes=batch.lane_map(),
            )
        try:
            batch.carry_host = self._carry_to_host(new_carry)
            batch.carry_dev = None
            finished = batch.harvest()
            sspan = None
            if self.tracer is not None:
                sspan = self.tracer.begin(
                    trace_mod.LANE_SURGERY, parent=hspan,
                    trace_id=self._server_trace, family=fam.name,
                    batch_id=batch.batch_id, impl="host",
                )
            try:
                for lane in batch.free_lanes():
                    late = self.queue.take(fam.name, 1)
                    if not late:
                        break
                    batch.admit(late[0], lane)
            except BaseException:
                if sspan is not None:
                    self.tracer.end(sspan, error=True)
                raise
            if sspan is not None:
                self.tracer.end(sspan, lanes=batch.lane_map())
            occupancy = batch.occupancy_samples[-1]
            self._publish_boundary(fam, batch)
        except BaseException:
            # The boundary where something broke (a SnapshotError from the
            # publish) must not be the one with no harvest record.
            if hspan is not None:
                self.tracer.end(hspan, error=True)
            raise
        if hspan is not None:
            self.tracer.end(hspan)
        self._cache_put(fam, finished)
        self._emit(kind="batch_boundary", family=fam.name,
                   batch_id=batch.batch_id, chunk=batch.chunks_done,
                   occupancy=occupancy, rung=serve_rung,
                   guard_rung=guard_rung)
        if batch.retired:
            self._occupancy.extend(batch.occupancy_samples)

    def _carry_to_host(self, carry):
        """A boundary carry back to the host. The server loop is
        host-global (late joins and the splice work on the full batch on
        every process), so on a MULTI-process mesh the slabs are gathered
        whole (``pods.host_global``); otherwise the plain host copy."""
        if self.mesh is not None and mesh_mod.is_multiprocess_mesh(self.mesh):
            return pods_mod.host_global(carry, self.mesh)
        return host_copy(carry)

    def _advance_device(self, fam: Family, batch: Batch) -> None:
        """The device boundary: chunk k's carry never leaves the card. The
        boundary plan (which lanes finish = admission counters; who joins
        = queue state) is host arithmetic, independent of chunk k's
        numeric results (``Batch.plan_finishing``), so the surgery masks
        are built, the surgery runs on the card-resident carry, and
        (pipelined mode) chunk k+1 is enqueued BEFORE anything waits for
        chunk k's values. Only the harvested scenario state (the surgery's
        second output) is copied to the host, and only when a lane
        finished. The order is load-bearing: plan -> surgery ->
        [speculative dispatch] -> harvest copy -> resolve -> bind joins ->
        publish."""
        batch.record_launch()
        pipelined = self.dispatch == "pipelined"

        # --- chunk k: the previous boundary's speculative dispatch (or the
        # guard's failure of it), or dispatch it now (first chunk / sync
        # mode / post-resume).
        if batch.inflight is not None:
            inflight, batch.inflight = batch.inflight, None
            if isinstance(inflight, backend_mod.BackendError):
                raise inflight
            out, serve_rung, guard_rung = inflight
        else:
            carry = (batch.carry_dev if batch.carry_dev is not None
                     else batch.carry_host)
            out, serve_rung, guard_rung = self._chunk_once(
                fam, batch, carry, batch.chunks_done, block=not pipelined
            )
        new_carry = out[0]

        # --- boundary plan: host counters only, no device values.
        finishing = batch.plan_finishing()
        free_after = sorted(set(batch.free_lanes()) | set(finishing))
        late = self.queue.take(fam.name, len(free_after))
        joins = list(zip(free_after, late))
        joined = {lane for lane, _ in joins}
        # Freed-with-no-joiner lanes reset to pristine filler; lanes that
        # were ALREADY filler are left alone (as on the host path, which
        # only ever splices admitted lanes).
        resets = [lane for lane in finishing if lane not in joined]

        # --- surgery: lane selects on the card carry.
        sspan = None
        if self.tracer is not None:
            sspan = self.tracer.begin(
                trace_mod.LANE_SURGERY, parent=None,
                trace_id=self._server_trace, family=fam.name,
                batch_id=batch.batch_id, impl="device",
                lanes=batch.lane_map(),
            )
        try:
            args = (new_carry,) + lanes_mod.make_surgery_args(
                fam.batched_template(batch.bucket),
                [(lane, t.request) for lane, t in joins], resets,
                batch.bucket,
            )
            (sout, s_rung), s_guard = self._dispatch(
                fam, args,
                f"{fam.name}:b{batch.batch_id}:s{batch.chunks_done}",
                trace_parent=sspan, entry=fam.surgery_entry,
                fn=lanes_mod.lane_surgery, block=not pipelined,
            )
            new_carry2, harvested = sout
        except BaseException:
            if sspan is not None:
                self.tracer.end(sspan, error=True)
            raise
        if sspan is not None:
            self.tracer.end(sspan, rung=s_rung, guard_rung=s_guard)
        batch.carry_dev = new_carry2

        # --- speculative chunk k+1 (pipelined): enqueued before the
        # harvest copy waits, IF any lane stays active. Its failure fails
        # the batch at the next boundary, after this one's harvest.
        if pipelined and (batch.active_lanes - len(finishing)
                          + len(joins)) > 0:
            try:
                batch.inflight = self._chunk_once(
                    fam, batch, new_carry2, batch.chunks_done + 1,
                    block=False)
            except backend_mod.BackendError as err:
                batch.inflight = err

        # --- harvest: copy the pre-surgery scenario state (only if a lane
        # finished), resolve, THEN bind joins.
        hspan = None
        if self.tracer is not None:
            hspan = self.tracer.begin(
                trace_mod.HARVEST, parent=None,
                trace_id=self._server_trace, family=fam.name,
                batch_id=batch.batch_id, chunk=batch.chunks_done + 1,
                lanes=batch.lane_map(),
            )
        try:
            state_host = None
            if finishing:
                state_host = host_copy(harvested)
            finished = batch.harvest(state_host=state_host)
            for lane, ticket in joins:
                batch.admit(ticket, lane, write_carry=False)
            occupancy = batch.occupancy_samples[-1]
            self._publish_boundary(fam, batch, carry_dev=new_carry2)
        except BaseException:
            if hspan is not None:
                self.tracer.end(hspan, error=True)
            raise
        if hspan is not None:
            self.tracer.end(hspan, lanes=batch.lane_map())
        self._cache_put(fam, finished)
        self._emit(kind="batch_boundary", family=fam.name,
                   batch_id=batch.batch_id, chunk=batch.chunks_done,
                   occupancy=occupancy, rung=serve_rung,
                   guard_rung=guard_rung)
        if batch.retired:
            self._occupancy.extend(batch.occupancy_samples)
            batch.inflight = None  # nothing admissible rode along.

    def _dispatch(self, fam: Family, args, label: str, trace_parent=None,
                  *, entry: str | None = None, fn=None, block: bool = True):
        """One guarded call through the serve ladder. Returns ``((out,
        serve_rung), guard_rung)``; a classified failure on the card
        raises the guard's ``BackendError``. Defaults serve the family's
        chunk; device-surgery dispatches pass ``fn`` and the surgery
        entry. The call places ``args`` on the family's device (a no-op
        for a carry already there; in host-surgery mode the chunk's input
        is the last boundary's host copy). A bundled server serves the
        bundle rung first, with the eager rungs behind it unless the
        bundle is required. Only a server on the CPU gives the guard a
        fallback: the same call again, on the CPU rung."""
        entry = entry if entry is not None else (fam.entry or fam.name)
        fn = fam.batched_fn if fn is None else fn
        dev = fam.device

        def call(suffix="", bundle=self.bundle):
            placed = tree_map(lambda t: t.to(dev), args)
            return loader_mod.serve_entry(
                bundle, entry, placed, fn=fn,
                jit_fallback=None if self.require_bundle else fn,
                metrics=self.metrics, label=label + suffix, block=block,
                hub=self.hub,
            )

        fallback = (backend_mod.run_on_cpu(lambda: call(":cpu", None))
                    if dev.type == "cpu" and not self.require_bundle
                    else None)
        return self.guard.run(label, call, fallback_fn=fallback,
                              trace_parent=trace_parent)

    def _publish_boundary(self, fam: Family, batch: Batch,
                          carry_dev=None) -> None:
        """Boundary durability publication under its BOUNDARY_PUBLISH span:
        atomic snapshot + journaled lane map. Device-surgery mode passes
        ``carry_dev`` (the post-surgery carry on the card) and pays the
        host copy HERE, only when a journal is configured: an un-journaled
        device server never round-trips the carry."""
        if self.journal is None:
            return
        pspan = None
        if self.tracer is not None:
            pspan = self.tracer.begin(
                trace_mod.BOUNDARY_PUBLISH, parent=None,
                trace_id=self._server_trace, family=fam.name,
                batch_id=batch.batch_id, chunk=batch.chunks_done,
                lanes=batch.lane_map(),
            )
        try:
            if carry_dev is not None:
                batch.carry_host = host_copy(carry_dev)
            checkpoint.save_snapshot(
                self.run_dir, batch.chunks_done, batch.carry_host,
                prefix=f"{SNAP_PREFIX}{batch.batch_id}",
                config_hash=fam.config_hash(), keep_last=2,
                meta={"family": fam.name, "bucket": batch.bucket},
            )
            self.journal.append({
                "event": "serving_batch", "batch_id": batch.batch_id,
                "family": fam.name, "bucket": batch.bucket,
                "chunk": batch.chunks_done, "lanes": batch.lanes_json(),
            })
        except BaseException:
            if pspan is not None:
                self.tracer.end(pspan, error=True)
            raise
        if pspan is not None:
            self.tracer.end(pspan)

    # ----------------------------------------------------------- stats --
    def stats(self) -> dict:
        by_status: dict[str, int] = {}
        steps = 0
        for t in self.tickets.values():
            by_status[t.status] = by_status.get(t.status, 0) + 1
            if t.status == queue_mod.COMPLETED:
                steps += t.steps_served
        # Retired batches already moved their samples into _occupancy.
        live = [
            s for b in self._batches.values()
            if b is not None and not b.retired
            for s in b.occupancy_samples
        ]
        occ = self._occupancy + live
        out = {
            "requests": len(self.tickets),
            **by_status,
            "scenario_steps": steps,
            "mean_occupancy": (sum(occ) / len(occ)) if occ else None,
            "preempted": self.preempted,
            "surgery": self.surgery,
            "dispatch": self.dispatch,
            "device": str(self.device),
            "dispatch_rungs": dict(self.dispatch_rungs),
            "guard_fallbacks": self.guard.fallbacks,
            "backend_failures": self.backend_failures,
        }
        if self.cache is not None:
            out["cache"] = self.cache.stats()
        return out

    # ---------------------------------------------------------- resume --
    @classmethod
    def resume(cls, run_dir: str, families=None, **kw) -> "ScenarioServer":
        """Rebuild a server from a preempted run directory: restore each
        unfinished batch's boundary carry from its newest journaled
        snapshot (lane map + chunk count from the matching journal event),
        re-enqueue requests that were still waiting, and resolve nothing
        twice. Recomputed work is bitwise the uninterrupted run's (chunk
        determinism); a batch whose snapshot fails validation falls back
        to full request replay -- also bitwise, just more recompute.
        Restored/replayed tickets are reachable through
        ``server.tickets[request_id]``."""
        events = RunJournal(run_dir, SERVING_JOURNAL).read()
        requests: dict[str, queue_mod.ScenarioRequest] = {}
        order: list[str] = []
        done: set[str] = set()
        last_batch: dict[int, dict] = {}
        for e in events:
            if e.get("event") == "serving_request":
                req = queue_mod.ScenarioRequest.from_json(e["request"])
                if req.request_id not in requests:
                    order.append(req.request_id)
                requests[req.request_id] = req
            elif e.get("event") == "serving_done":
                done.add(e.get("request_id"))
            elif e.get("event") == "serving_batch":
                last_batch[e["batch_id"]] = e

        server = cls(families=families, run_dir=run_dir, **kw)
        # Requests the journal already saw through to resolution: clients
        # replaying their stream after a crash dedupe against this.
        server.done_requests = done
        server._emit(kind="resumed", run_dir=run_dir,
                     pending=len([r for r in requests if r not in done]))
        if server.journal is not None:
            server.journal.append({"event": "serving_resumed"})

        if last_batch:
            # Fresh-process batch ids restart at 0: future launches must
            # not collide with journaled batch identities/snapshots.
            batcher_mod.reserve_batch_ids(max(last_batch) + 1)
        restored: set[str] = set()
        for bid in sorted(last_batch):
            e = last_batch[bid]
            live = [(lane, rid, rem) for lane, rid, rem in e["lanes"]
                    if rid not in done and rid in requests]
            if not live:
                continue
            fam = server.families.get(e["family"])
            if fam is None:
                continue  # family not configured: requests replay below.
            path = checkpoint.snapshot_path(
                run_dir, e["chunk"], f"{SNAP_PREFIX}{bid}"
            )
            try:
                carry, _meta = checkpoint.load_snapshot(
                    path, fam.batched_template_host(e["bucket"]),
                    config_hash=fam.config_hash()
                )
            except checkpoint.SnapshotError as exc:
                if server.journal is not None:
                    server.journal.append({
                        "event": "serving_snapshot_skipped",
                        "batch_id": bid, "error": str(exc)[:300],
                    })
                continue  # full replay via the queue below.
            batch = Batch(fam, e["bucket"], fam.template_carry_host(),
                          server.clock, server._emit, batch_id=bid)
            batch.carry_host = carry
            batch.chunks_done = e["chunk"]
            for lane, rid, rem in live:
                ticket = queue_mod.Ticket(requests[rid])
                if server.tracer is not None:
                    # The same trace_id as the preempted run (journaled on
                    # the request), this root marked restored.
                    root = server.tracer.begin(
                        trace_mod.REQUEST, parent=None,
                        trace_id=requests[rid].trace_id,
                        request_id=rid, family=e["family"],
                        restored=True,
                    )
                    ticket.trace = trace_mod.RequestTrace(
                        server.tracer, root
                    )
                now = server.clock()
                ticket.slo.t_submit = now
                if requests[rid].deadline_s is not None:
                    # Deadlines RE-ARM on resume (the monotonic clock
                    # domain dies with the process).
                    ticket.slo.deadline_at = (
                        now + float(requests[rid].deadline_s)
                    )
                batch.restore_lane(ticket, lane, rem)
                server.tickets[rid] = ticket
                restored.add(rid)
            server._batches[fam.name] = batch

        for rid in order:
            if rid in done or rid in restored:
                continue
            server.submit(requests[rid])
        return server
