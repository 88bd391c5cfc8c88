"""Localhost serving-fleet harness: ONE admission front + N replica
``ScenarioServer`` worker processes that share one card, wired over
durable jsonl channels so every hop survives a SIGKILL:

- ``r{i}/inbox.jsonl``   -- front -> replica ops (submit/cancel/wedge/
  inject_error/shutdown), replayed idempotently on replica restart;
- ``r{i}/replica.metrics.jsonl`` -- replica -> front heartbeats
  (``fleet_event`` rows that also carry the replica's device, whether its
  server is built, its whole-solve kernel launches by body and its guard
  counts), serving/trace events (per-replica ``r{i}`` span track);
- ``r{i}/outbox.jsonl``  -- replica -> front results (request_id, status,
  digest, replica, device); the front is completion-authoritative (first
  result wins, duplicates dropped and counted);
- ``r{i}/run/``          -- the replica's serving journal and boundary
  snapshots; a respawned replica RESUMES it (durability path) while the
  front re-dispatches its in-flight work to healthy replicas (latency
  path) -- the digests agree bit for bit, so first-wins dedup is safe.

The port's counterpart of the JAX package's ``tools/fleet_local.py``. The
parent runs the :class:`serving.fleet.ReplicaSupervisor` (heartbeat
leases, classified-error breaker, bounded-backoff restarts, quarantine)
and the :class:`serving.fleet.FleetFront` ((family, bucket)
consistent-hash routing, per-tenant admission, failover re-dispatch).
``--chaos`` drives a :class:`FleetFaultPlan`: the acceptance storm
SIGKILLs and wedges replicas mid-batch and still exits 0 with every
non-rejected request's digest equal to the fault-free run's.

Each replica builds ``ScenarioServer(device=--device)``: ``cuda`` (the
default) puts every replica's chunks on the card, each replica with its
own CUDA context; ``cpu`` runs the plain PyTorch path. There is no
fallback: a replica that finds no card exits non-zero, the parent reports
its exit and the tail of its stderr, and a parent asked for ``cuda`` on a
host without a card raises before it starts any replica. On ``cuda`` the
parent builds the kernels once before spawning, so the replicas load
them instead of each starting every ``nvcc``; with ``--bundle DIR``
(``--require-bundle``) every replica serves from that AOT bundle instead,
its libraries installed from the bundle. The request stream and the
chaos clock start once every replica has reported its server built: a
replica's boot on the card (the interpreter, the CUDA context) takes
seconds that vary from host to host, and a storm timed from the spawn
would land on replicas still booting.

Process discipline: each replica leads its own process group
(``start_new_session=True``) and is signalled only through that group;
each watches its parent's pid and exits when orphaned; every process the
parent starts is reaped when the run ends, normally or by an exception.

Usage:
  python -m tpu_aerial_transport_torch.tools.fleet_local --replicas 3 \\
      --requests 48 --families cadmm4,centralized4 --buckets 2,4 \\
      --chaos "sigkill@0.1:r1,wedge@0.05:r0=2"
  python -m tpu_aerial_transport_torch.tools.fleet_local --device cpu \\
      --replicas 2 --requests 8

Multi-replica runs need two cores or more: on the CPU a 1-core host
skips with a written reason (``--force-multi`` overrides), on the card it
is an error.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import shutil
import signal
import subprocess
import sys
import threading
import time

from tpu_aerial_transport_torch.obs import export as export_mod
from tpu_aerial_transport_torch.serving import fleet as fleet_mod

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
WORKER_MODULE = "tpu_aerial_transport_torch.tools.fleet_local"
HEARTBEAT_FRACTION = 0.4  # emit cadence as a fraction of the lease.
STDERR_TAIL = 2000        # bytes of a dead replica's stderr in the summary.


def _read_new_lines(path: str, offset: int) -> tuple[list[dict], int]:
    """Complete (newline-terminated) JSON lines past ``offset``; a torn
    tail stays unread until its newline lands (the jsonl_append fsync
    contract makes line-grained tailing sound across processes)."""
    try:
        with open(path, "rb") as fh:
            fh.seek(offset)
            blob = fh.read()
    except FileNotFoundError:
        return [], offset
    if not blob:
        return [], offset
    keep = blob.rfind(b"\n") + 1
    rows = []
    for line in blob[:keep].splitlines():
        try:
            rows.append(json.loads(line))
        except ValueError:
            continue
    return rows, offset + keep


# ----------------------------------------------------------------------
# Replica worker.
# ----------------------------------------------------------------------

def _orphan_watchdog() -> None:
    """Replicas run in their own sessions (group-killability), so a
    parent crash does not reap them -- watch the parent pid and exit on
    reparent. Runs only inside a replica process (:func:`run_worker`)."""
    parent = os.getppid()

    def watch():
        while True:
            time.sleep(2.0)
            if os.getppid() != parent:
                os._exit(17)

    threading.Thread(target=watch, daemon=True).start()


class _Wedge:
    """Replica-side wedge clamp: while wedged, the main loop stalls AND
    the heartbeat thread goes silent -- exactly the failure the
    supervisor's lease machine must catch."""

    def __init__(self):
        self.until = 0.0

    def set(self, seconds: float) -> None:
        self.until = time.monotonic() + seconds

    @property
    def active(self) -> bool:
        return time.monotonic() < self.until


def run_worker(args) -> int:
    """One replica: a ``ScenarioServer`` on ``args.device`` pumped from
    its inbox, results to its outbox, heartbeats to its metrics file."""
    _orphan_watchdog()
    from tpu_aerial_transport_torch.obs import trace as trace_mod
    from tpu_aerial_transport_torch.ops import admm_kernel
    from tpu_aerial_transport_torch.serving import server as server_mod
    from tpu_aerial_transport_torch.serving.queue import ScenarioRequest

    rdir = args.dir
    rid = args.replica_id
    pid = os.getpid()
    inbox = os.path.join(rdir, "inbox.jsonl")
    outbox = os.path.join(rdir, "outbox.jsonl")
    run_dir = os.path.join(rdir, "run")
    writer = export_mod.MetricsWriter(
        os.path.join(rdir, "replica.metrics.jsonl"),
        meta={"replica": rid, "pid": pid, "device": args.device},
    )
    wedge = _Wedge()
    hb_seq = [0]
    # What each heartbeat reports; the main loop replaces the whole dict
    # (one reference store), so the heartbeat thread never reads a dict
    # that is being changed.
    report = [{"ready": False, "device": args.device}]

    def beat(**extra) -> None:
        hb_seq[0] += 1
        writer.emit("fleet_event", kind="heartbeat", replica=rid,
                    seq=hb_seq[0], pid=pid, **report[0], **extra)

    def heartbeats():
        period = max(0.05, args.lease * HEARTBEAT_FRACTION)
        while True:
            if not wedge.active:
                beat()
            time.sleep(period)

    # Heartbeats start BEFORE server construction: a slow boot (the
    # interpreter, the CUDA context, the families) must read as
    # "starting", not "dead on arrival".
    threading.Thread(target=heartbeats, daemon=True).start()

    tracer = trace_mod.Tracer(writer, track=f"r{rid}")
    kw = dict(
        families=[f for f in args.families.split(",") if f],
        buckets=tuple(int(b) for b in args.buckets.split(",") if b),
        capacity=args.capacity, metrics=writer, tracer=tracer,
        device=args.device,
        bundle=args.bundle or None, require_bundle=args.require_bundle,
    )
    journal = os.path.join(run_dir, server_mod.SERVING_JOURNAL)
    if os.path.exists(journal):
        # Respawn: restore batches from boundary snapshots, re-admit the
        # journaled queue remainder (the serving tier's durability path).
        server = server_mod.ScenarioServer.resume(run_dir, **kw)
    else:
        server = server_mod.ScenarioServer(run_dir=run_dir, **kw)

    def snapshot() -> None:
        report[0] = {
            "ready": True, "device": server.device.type,
            "launches": {k: v for k, v in
                         admm_kernel.KERNEL_LAUNCHES.items() if v},
            "dispatch_rungs": dict(server.dispatch_rungs),
            "guard_fallbacks": server.guard.fallbacks,
            "backend_failures": server.backend_failures,
        }

    cancelled: set[str] = set()
    reported: set[str] = set()
    shutdown = [False]
    offset = 0

    def apply_op(op: dict, replay: bool) -> None:
        name = op.get("op")
        if name == "submit":
            req = ScenarioRequest.from_json(op["request"])
            # Idempotent under inbox replay AND resume restore.
            if (req.request_id in server.tickets
                    or req.request_id in server.done_requests):
                return
            server.submit(req)
        elif name == "cancel":
            # Don't report a result the front already failed over --
            # a lost cancel only costs a deduped duplicate downstream.
            cancelled.add(op["request_id"])
        elif name == "shutdown" and (not replay or op.get("pid") == pid):
            # A replayed shutdown counts only when it names this process:
            # one meant for a pre-crash incarnation must not stop the
            # respawn.
            shutdown[0] = True
        elif replay:
            # wedge/inject_error are live-only: replaying a pre-crash
            # wedge against the respawn would be a self-inflicted fault.
            return
        elif name == "wedge":
            wedge.set(float(op.get("seconds", 2.0)))
        elif name == "inject_error":
            # Surface a classified BackendError kind upward; the parent
            # feeds the supervisor (infra kinds strike the breaker,
            # compile_error never does).
            writer.emit("fleet_event", kind="replica_error", replica=rid,
                        error_kind=op.get("kind", "device_crash"),
                        detail="injected")

    # Boot replay: everything already in the inbox (ops addressed to a
    # pre-crash incarnation) -- submits/cancels, and a shutdown that
    # names this pid.
    rows, offset = _read_new_lines(inbox, offset)
    for op in rows:
        apply_op(op, replay=True)
    snapshot()

    while True:
        rows, offset = _read_new_lines(inbox, offset)
        for op in rows:
            apply_op(op, replay=False)
        if wedge.active:
            time.sleep(0.05)
            continue
        worked = server.pump() if server.has_work() else False
        for req_id, ticket in list(server.tickets.items()):
            if not ticket.done or req_id in reported:
                continue
            reported.add(req_id)
            if req_id in cancelled:
                continue
            row = {"request_id": req_id, "status": ticket.status,
                   "replica": rid, "device": server.device.type,
                   "steps_served": ticket.steps_served}
            if ticket.reason:
                row["reason"] = ticket.reason
            if ticket.result is not None:
                row["digest"] = fleet_mod.result_digest(ticket.result)
            export_mod.jsonl_append(outbox, row)
        if worked:
            snapshot()
        if shutdown[0] and not server.has_work():
            snapshot()
            beat(final=True)
            return 0
        if not worked:
            time.sleep(0.02)


# ----------------------------------------------------------------------
# Parent: supervisor + front + chaos.
# ----------------------------------------------------------------------

class _Replica:
    """Parent-side handle: process + channel offsets + kill bookkeeping.
    ``procs`` holds every process started for this replica (each is
    reaped when the run ends); ``proc`` is the current one."""

    def __init__(self, rid: int, rdir: str):
        self.rid = rid
        self.rdir = rdir
        self.proc: subprocess.Popen | None = None
        self.procs: list[subprocess.Popen] = []
        self.spawned_at: dict[int, float] = {}   # pid -> wall time.
        self.metrics_offset = 0
        self.outbox_offset = 0
        self.exit_seen = True  # no process yet.
        self.ready = False     # the current process has built its server.

    @property
    def inbox(self) -> str:
        return os.path.join(self.rdir, "inbox.jsonl")

    @property
    def metrics(self) -> str:
        return os.path.join(self.rdir, "replica.metrics.jsonl")

    @property
    def outbox(self) -> str:
        return os.path.join(self.rdir, "outbox.jsonl")

    @property
    def stderr_log(self) -> str:
        return os.path.join(self.rdir, "stderr.log")

    @property
    def pid(self) -> int | None:
        return self.proc.pid if self.proc is not None else None

    def kill(self, sig=signal.SIGKILL) -> None:
        if self.proc is not None and self.proc.poll() is None:
            _signal_group(self.proc, sig)


def _signal_group(proc: subprocess.Popen, sig) -> None:
    """Signal the process group that ``proc`` leads: every replica is
    started with ``start_new_session=True``, so its pid is its group's."""
    try:
        os.killpg(proc.pid, sig)
    except (ProcessLookupError, PermissionError):
        proc.kill()


def _reap(replicas: dict, grace_s: float = 10.0) -> None:
    """Kill whatever is still running of every process started and wait
    for each (no zombie outlives the run)."""
    for rep in replicas.values():
        for proc in rep.procs:
            if proc.poll() is None:
                _signal_group(proc, signal.SIGKILL)
    for rep in replicas.values():
        for proc in rep.procs:
            with contextlib.suppress(subprocess.TimeoutExpired):
                proc.wait(grace_s)


def _spawn_replica(rep: _Replica, args) -> None:
    cmd = [
        sys.executable, "-m", WORKER_MODULE, "--worker",
        "--replica-id", str(rep.rid), "--dir", rep.rdir,
        "--families", args.families, "--buckets", args.buckets,
        "--capacity", str(args.capacity), "--lease", str(args.lease),
        "--device", args.device,
    ] + (["--bundle", args.bundle] if args.bundle else []) \
      + (["--require-bundle"] if args.require_bundle else [])
    # stderr to a file, not a pipe: nobody drains replica pipes, and a
    # chatty boot must not wedge the replica on a full pipe buffer.
    # Append mode keeps the pre-crash tail for post-mortem.
    with open(rep.stderr_log, "ab") as err:
        rep.proc = subprocess.Popen(
            cmd, stdout=subprocess.DEVNULL, stderr=err,
            env=dict(os.environ), start_new_session=True, cwd=_REPO,
        )
    rep.procs.append(rep.proc)
    rep.spawned_at[rep.proc.pid] = time.time()
    rep.exit_seen = False
    rep.ready = False


def _stderr_tail(path: str) -> str:
    try:
        with open(path, "rb") as fh:
            fh.seek(0, os.SEEK_END)
            fh.seek(max(0, fh.tell() - STDERR_TAIL))
            return fh.read().decode(errors="replace")
    except FileNotFoundError:
        return ""


def replica_report(rep: _Replica) -> list[dict]:
    """One entry per process started for ``rep``, from its heartbeats:
    pid, exit code, seconds from spawn to its server built (``boot_s``,
    None if it never got there), and its last heartbeat's device, kernel
    launches by body, dispatch rungs and guard counts."""
    beats: dict[int, list[dict]] = {}
    if os.path.exists(rep.metrics):
        for row in export_mod.jsonl_read(rep.metrics):
            if (row.get("event") == "fleet_event"
                    and row.get("kind") == "heartbeat"):
                beats.setdefault(row.get("pid"), []).append(row)
    out = []
    for proc in rep.procs:
        rows = beats.get(proc.pid, [])
        ready = [r["ts"] for r in rows if r.get("ready")]
        last = rows[-1] if rows else {}
        out.append({
            "pid": proc.pid, "rc": proc.poll(),
            "heartbeats": len(rows),
            "boot_s": (ready[0] - rep.spawned_at[proc.pid]
                       if ready else None),
            "final": bool(last.get("final")),
            **{k: last[k] for k in ("device", "launches", "dispatch_rungs",
                                    "guard_fallbacks", "backend_failures")
               if k in last},
        })
    return out


def _all_ready(replicas: dict, supervisor) -> bool:
    """Every replica has built its server, or is quarantined for good
    (and at least one is ready)."""
    live = [r for r in replicas.values()
            if supervisor.state(r.rid) != fleet_mod.QUARANTINED]
    return bool(live) and all(r.ready for r in live)


def make_fleet_stream(n_requests: int, families: list[str],
                      chunk_lens: dict, tenants: list[str], seed: int):
    """Deterministic mixed-tenant request stream (the serve_scenarios
    stream generator + a seeded tenant column): same seed => same
    stream, the chaos-vs-fault-free digest comparison's precondition.
    The JAX harness's stream, request for request."""
    import numpy as np

    from tpu_aerial_transport_torch.serving.queue import ScenarioRequest

    rng = np.random.default_rng(seed)
    out = []
    for i in range(n_requests):
        fam = families[int(rng.integers(len(families)))]
        horizon = int(rng.integers(1, 4)) * chunk_lens[fam]
        tenant = tenants[int(rng.integers(len(tenants)))]
        out.append(ScenarioRequest(
            family=fam, horizon=horizon,
            x0=tuple(float(v) for v in rng.normal(0, 1.0, 3)),
            v0=(0.1, 0.0, 0.0),
            request_id=f"req{i:05d}", tenant=tenant,
        ))
    return out


def parse_tenants(spec: str) -> dict:
    """``name:rate=R,burst=B,weight=W,priority=P;name2:...`` ->
    {name: TenantPolicy}; unknown keys are an error (a typo'd policy
    must not silently admit everything)."""
    from tpu_aerial_transport_torch.serving.queue import TenantPolicy

    out = {}
    for chunk in (c.strip() for c in (spec or "").split(";")):
        if not chunk:
            continue
        name, _, body = chunk.partition(":")
        kw: dict = {}
        for item in (i for i in body.split(",") if i):
            key, _, val = item.partition("=")
            if key == "rate":
                kw["rate_per_s"] = float(val)
            elif key == "burst":
                kw["burst"] = int(val)
            elif key == "weight":
                kw["weight"] = float(val)
            elif key == "priority":
                kw["priority"] = int(val)
            else:
                raise SystemExit(f"unknown tenant policy key {key!r}")
        out[name] = TenantPolicy(**kw)
    return out


def run_fleet(args) -> tuple[dict, int]:
    """Drive the whole storm. Returns (summary, exit code) so the
    ``serve_fleet`` example can reuse it verbatim. Raises before
    starting any replica when ``args.device`` is ``cuda`` and the host
    has no card."""
    from tpu_aerial_transport_torch import resolve_device
    from tpu_aerial_transport_torch.obs import trace as trace_lib
    from tpu_aerial_transport_torch.serving import batcher

    device = resolve_device(args.device)
    if device.type == "cuda" and not args.bundle:
        # One build, before any replica starts: N cold replicas would
        # otherwise each start every nvcc at once (a bundle's replicas
        # install its libraries instead).
        from tpu_aerial_transport_torch.ops import _build

        _build.build()

    out_dir = args.out_dir
    os.makedirs(out_dir, exist_ok=True)
    # A run's channel files (inboxes, outboxes, metrics, journals) are
    # strictly per-run state: a RE-used out_dir must not leak a prior
    # run's ops/results into this one (same seed -> same request_ids ->
    # stale outbox rows would resolve fresh tickets). Within-run resume
    # (replica respawn -> journal replay) is untouched: the wipe happens
    # once, before any replica spawns.
    for i in range(args.replicas):
        shutil.rmtree(os.path.join(out_dir, f"r{i}"), ignore_errors=True)
    for stale in ("front.metrics.jsonl", "fleet.metrics.jsonl"):
        with contextlib.suppress(FileNotFoundError):
            os.remove(os.path.join(out_dir, stale))
    families = [f for f in args.families.split(",") if f]
    buckets = tuple(int(b) for b in args.buckets.split(",") if b)
    chunk_lens = {
        f: batcher.CANONICAL_FAMILIES[f].chunk_len for f in families
    }
    tenants = parse_tenants(args.tenants)
    tenant_names = sorted(tenants) or ["default"]

    plan = fleet_mod.FleetFaultPlan()
    if args.chaos:
        if args.chaos.startswith("seeded:"):
            plan = fleet_mod.FleetFaultPlan.seeded(
                int(args.chaos.split(":", 1)[1]), args.replicas,
                t_span=args.chaos_span,
            )
        else:
            plan = fleet_mod.FleetFaultPlan.parse(args.chaos)
    elif os.environ.get(fleet_mod.FLEET_FAULTS_ENV):
        plan = fleet_mod.FleetFaultPlan.from_env()

    writer = export_mod.MetricsWriter(
        os.path.join(out_dir, "front.metrics.jsonl"),
        meta={"role": "front", "replicas": args.replicas,
              "chaos": plan.to_spec(), "device": device.type},
    )
    tracer = trace_lib.Tracer(writer, track="front")
    supervisor = fleet_mod.ReplicaSupervisor(
        list(range(args.replicas)),
        lease_s=args.lease, boot_grace_s=args.boot_grace,
        quarantine_after=args.quarantine_after, emit=writer,
    )
    replicas = {
        i: _Replica(i, os.path.join(out_dir, f"r{i}"))
        for i in range(args.replicas)
    }
    for rep in replicas.values():
        os.makedirs(os.path.join(rep.rdir, "run"), exist_ok=True)

    front = fleet_mod.FleetFront(
        list(range(args.replicas)),
        lambda fam: chunk_lens.get(fam),
        send=lambda rid, op: export_mod.jsonl_append(
            replicas[rid].inbox, op
        ),
        buckets=buckets, capacity=args.capacity, tenants=tenants,
        supervisor=supervisor, metrics=writer, tracer=tracer,
    )

    stream = make_fleet_stream(args.requests, families, chunk_lens,
                               tenant_names, args.seed)
    import numpy as np

    arrival_rng = np.random.default_rng(args.seed + 1)
    rng_wait = (1.0 / args.poisson_rate) if args.poisson_rate else 0.0
    fired: list[dict] = []
    exits: list[dict] = []

    def execute(action: str, rid: int) -> None:
        rep = replicas[rid]
        if action == "kill":
            rep.kill()
            rep.exit_seen = True  # this exit is ours, not news.
        elif action == "failover":
            front.failover(rid)
        elif action == "spawn":
            _spawn_replica(rep, args)
        elif action == "quarantine":
            pass  # terminal: no respawn, ring routes around it.

    rc = 0
    t_start = time.monotonic()
    t0 = t_start
    t_done = None
    try:
        for rep in replicas.values():
            _spawn_replica(rep, args)
        started = False
        chaos_t = 0.0
        next_due = t0
        deadline = t_start + args.timeout
        while True:
            now = time.monotonic()
            if not started and _all_ready(replicas, supervisor):
                started = True
                t0 = next_due = now
            if started:
                # Scheduled chaos (storm-relative clock).
                for fault in plan.due(chaos_t, now - t0):
                    rep = replicas[fault.replica]
                    fired.append({"fault": fault.token(),
                                  "t_s": round(now - t0, 4),
                                  "ts": time.time(), "pid": rep.pid})
                    if fault.action == "sigkill":
                        rep.kill(signal.SIGKILL)
                    elif fault.action == "sigterm":
                        rep.kill(signal.SIGTERM)
                    elif fault.action == "wedge":
                        front.send(fault.replica, {
                            "op": "wedge",
                            "seconds": float(fault.arg or 2.0),
                        })
                    elif fault.action == "error":
                        front.send(fault.replica, {
                            "op": "inject_error",
                            "kind": fault.arg or "device_crash",
                        })
                chaos_t = now - t0

                # Arrivals (Poisson or all up front) + routing.
                while stream and (not rng_wait
                                  or time.monotonic() >= next_due):
                    front.submit(stream.pop(0))
                    if rng_wait:
                        next_due += arrival_rng.exponential(rng_wait)
            front.pump()

            # Replica -> front channels.
            for rep in replicas.values():
                rows, rep.metrics_offset = _read_new_lines(
                    rep.metrics, rep.metrics_offset
                )
                for row in rows:
                    if row.get("event") != "fleet_event":
                        continue
                    if row.get("kind") == "heartbeat":
                        # Only the CURRENT incarnation's pulse counts -- a
                        # pre-kill row read post-kill must not resurrect
                        # a replica the supervisor already declared down.
                        if row.get("pid") == rep.pid and not rep.exit_seen:
                            supervisor.heartbeat(rep.rid)
                            rep.ready = rep.ready or bool(row.get("ready"))
                    elif row.get("kind") == "replica_error":
                        for act in supervisor.report_error(
                            rep.rid, row.get("error_kind", ""),
                            row.get("detail", ""),
                        ):
                            execute(*act)
                rows, rep.outbox_offset = _read_new_lines(
                    rep.outbox, rep.outbox_offset
                )
                for row in rows:
                    front.deliver_result(row)

            # Unexpected exits (chaos SIGKILL detection beats lease
            # expiry); each is reported with its stderr's tail.
            for rep in replicas.values():
                if (not rep.exit_seen and rep.proc is not None
                        and rep.proc.poll() is not None):
                    rep.exit_seen = True
                    exits.append({
                        "replica": rep.rid, "pid": rep.proc.pid,
                        "rc": rep.proc.returncode,
                        "stderr_tail": _stderr_tail(rep.stderr_log),
                    })
                    for act in supervisor.notify_exit(
                        rep.rid, rep.proc.returncode
                    ):
                        execute(*act)

            for act in supervisor.tick():
                execute(*act)

            if not stream and not front.unresolved():
                t_done = time.monotonic()
                break
            if all(supervisor.state(r) == fleet_mod.QUARANTINED
                   for r in replicas):
                rc = 1  # no replica can ever serve again.
                break
            if time.monotonic() > deadline:
                rc = 1
                break
            time.sleep(args.poll)

        # Drain: a shutdown for each live process (named by pid, so a
        # respawn still booting honours it when it replays its inbox, and
        # gets its boot grace to get there), then group-kill stragglers.
        for rep in replicas.values():
            if rep.proc is not None and rep.proc.poll() is None:
                front.send(rep.rid, {"op": "shutdown", "pid": rep.pid})
        t_stop = time.monotonic() + max(
            [10.0] + [args.boot_grace for r in replicas.values()
                      if r.proc is not None and not r.ready])
        for rep in replicas.values():
            if rep.proc is None:
                continue
            try:
                rep.proc.wait(max(0.1, t_stop - time.monotonic()))
            except subprocess.TimeoutExpired:
                rep.kill()
    finally:
        _reap(replicas)

    # Merge front + replica metrics into ONE stream (critical_path and
    # the stitcher read the whole fleet in one file).
    merged = os.path.join(out_dir, "fleet.metrics.jsonl")
    with open(merged, "w", encoding="utf-8") as out_fh:
        for path in [writer.path] + [r.metrics for r in replicas.values()]:
            if not os.path.exists(path):
                continue
            for row in export_mod.jsonl_read(path):
                out_fh.write(json.dumps(row) + "\n")

    results = {}
    for rid, t in sorted(front.tickets.items()):
        row = front.results.get(rid, {})
        results[rid] = {
            "status": t.status,
            **({"reason": t.reason} if t.reason else {}),
            **({"digest": t.result} if t.result is not None else {}),
            **{k: row[k] for k in ("replica", "device") if k in row},
        }
    if args.results:
        with open(args.results, "w") as fh:
            json.dump(results, fh, indent=1)

    summary = {
        "replicas": args.replicas,
        "device": device.type,
        "chaos": plan.to_spec(),
        "wall_s": round(time.monotonic() - t_start, 3),
        # Seconds from the stream's start (every replica ready) to the
        # last request resolved.
        "serve_s": None if t_done is None else round(t_done - t0, 4),
        **front.stats(),
        "health": {str(r): supervisor.state(r)
                   for r in sorted(supervisor.replicas)},
        "processes": {str(r): replica_report(rep)
                      for r, rep in replicas.items()},
        "faults_fired": fired,
        "exits": exits,
        "unresolved": front.unresolved(),
        "metrics": merged,
        "ok": rc == 0 and not front.unresolved(),
    }
    if args.trace:
        rows = trace_lib.trace_rows(export_mod.read_events(merged))
        trace_lib.write_chrome_trace(args.trace, trace_lib.stitch(rows))
        cp = trace_lib.critical_path(rows)
        summary["trace"] = {
            "path": args.trace, "spans": len(rows),
            "tracks": sorted({r.get("track") for r in rows}),
            "critical_path_p99": {
                seg: round(st["p99"], 4)
                for seg, st in cp["per_segment"].items()
            },
        }
    return summary, (0 if summary["ok"] else max(rc, 1))


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--worker", action="store_true",
                    help=argparse.SUPPRESS)  # internal: one replica.
    ap.add_argument("--replica-id", type=int, default=0,
                    help=argparse.SUPPRESS)
    ap.add_argument("--dir", default="", help=argparse.SUPPRESS)
    ap.add_argument("--replicas", type=int, default=2)
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--families", default="cadmm4")
    ap.add_argument("--buckets", default="4,8")
    ap.add_argument("--capacity", type=int, default=1024)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--poisson-rate", type=float, default=0.0,
                    help="mean arrivals/s (0 = submit everything up "
                         "front)")
    ap.add_argument("--tenants", default="",
                    help="per-tenant policy spec: 'name:rate=R,burst=B,"
                         "weight=W,priority=P;name2:...' (empty = one "
                         "unlimited default tenant)")
    ap.add_argument("--chaos", default="",
                    help="fault plan: 'sigkill@1.5:r0,wedge@2:r1=3' or "
                         "'seeded:<seed>' (also via "
                         f"{fleet_mod.FLEET_FAULTS_ENV})")
    ap.add_argument("--chaos-span", type=float, default=4.0,
                    help="seeded plans: spread faults over this many "
                         "storm-seconds (the storm's clock starts once "
                         "every replica is ready)")
    ap.add_argument("--lease", type=float, default=1.0,
                    help="heartbeat lease seconds (suspect at 2 missed, "
                         "down at 5)")
    ap.add_argument("--boot-grace", type=float, default=120.0,
                    help="seconds a replica may take to first heartbeat "
                         "(the interpreter's start on a loaded host)")
    ap.add_argument("--quarantine-after", type=int, default=3,
                    help="restart cycles before a poison replica is "
                         "quarantined")
    ap.add_argument("--device", default="cuda",
                    help="where every replica serves: cuda (default) or "
                         "cpu")
    ap.add_argument("--bundle", default="",
                    help="an AOT bundle directory every replica serves "
                         "from (aot/: kernel libraries installed from it)")
    ap.add_argument("--require-bundle", action="store_true",
                    help="replicas admit only what the bundle covers, "
                         "with no eager fallback")
    ap.add_argument("--out-dir", default="artifacts/fleet-torch-local")
    ap.add_argument("--results", default="",
                    help="write per-request {id: {status, digest, "
                         "replica, device}} JSON")
    ap.add_argument("--trace", default="",
                    help="write a stitched cross-replica Chrome/Perfetto "
                         "trace (front + r{i} tracks on one clock)")
    ap.add_argument("--timeout", type=float, default=600.0)
    ap.add_argument("--poll", type=float, default=0.05,
                    help="front loop poll interval")
    ap.add_argument("--force-multi", action="store_true",
                    help="run multiple replicas even on a 1-core host")
    return ap


def too_few_cores(args) -> str | None:
    """Why this host cannot run ``args.replicas`` replicas reliably
    (N replica servers time-slicing ONE core stretch every heartbeat
    lease), or None."""
    if ((os.cpu_count() or 1) < 2 and args.replicas > 1
            and not args.force_multi):
        return (f"1-core host (os.cpu_count()={os.cpu_count()}): cannot "
                f"run {args.replicas} fleet replicas reliably "
                "(--force-multi overrides)")
    return None


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.worker:
        return run_worker(args)
    why = too_few_cores(args)
    if why is not None:
        if args.device != "cpu":
            # On the card a skip would read as a pass: it is an error.
            print(json.dumps({"error": why}), file=sys.stderr, flush=True)
            return 2
        print(json.dumps({"skipped": why}), flush=True)
        return 0
    summary, rc = run_fleet(args)
    print(json.dumps(summary), flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
