"""Host-side distributed tracing: spans from admission to device, across
the chunk driver, recovery, serving, the fleet and pods.

The port's own copy of the JAX package's ``obs/trace.py`` (the port
imports nothing of the JAX package, not even its stdlib-only modules),
with the same span vocabulary and row format, so the rows each package
writes stitch, render and validate under the other's functions. A
:class:`Tracer` records **spans** -- ``trace_id`` / ``span_id`` /
``parent_id``, structured attributes, one *track* per process. In the
port, ``resilience.recovery`` opens ``run`` / ``chunk`` / ``snapshot`` /
``resume`` spans around the chunk driver, ``retry`` and ``preempted``
instants among them; ``serving/server.py`` opens the serving names
(``request``, ``queue_wait``, ``batch_form``, ``chunk_dispatch``,
``harvest``, ``lane_surgery``, ...) that :func:`critical_path` reads,
``serving/fleet.py`` the fleet's re-homing spans, and
``parallel/pods.py`` gives each process its own track
(``p{pid}of{N}``) in the run directory's per-process trace files.

**Clock model.** Every span records both a monotonic timestamp pair
(``t0_mono``/``t1_mono``: exact durations, immune to wall-clock steps)
and a wall-epoch pair (``t0_wall``/``t1_wall``). Monotonic clocks are
per-process domains, so :func:`stitch` aligns every track onto one shared
clock by the median per-row ``wall - mono`` offset, and
:func:`stitch_run_dir` does it for a multi-process run directory (the
shard manifest names how many per-process trace files make the run
complete). Durations stay exactly the monotonic ones.

**Exports.** Finished spans emit as ``trace_event`` rows through the
fsync'd metrics jsonl (``obs.export``, schema v5 and later);
:func:`chrome_trace` converts stitched rows to Chrome/Perfetto
trace-event JSON and :func:`validate_chrome_trace` checks one.
:func:`critical_path` decomposes each request's submit-to-complete
interval into queue-wait / batch-wait / device / surgery / publish /
harvest / retry segments that sum to the interval exactly.

**Zero cost when off:** ``tracer=None`` takes no locks and allocates
nothing -- every instrumentation site is a host-level ``if tracer is not
None`` -- and no span enters the device work.

Module contract: stdlib-only at module scope (no torch, no numpy), so
tools can import the span layer without the array libraries.
"""

from __future__ import annotations

import contextlib
import dataclasses
import itertools
import json
import os
import statistics
import time

# ----------------------------------------------------------------------
# Span vocabulary (the names the accountant and renderers key on).
# ----------------------------------------------------------------------

REQUEST = "request"             # root span of one request's trace.
QUEUE_WAIT = "queue_wait"       # submit -> admitted into a device lane.
BATCH_FORM = "batch_form"       # batch launch: bucket pick + admissions.
CHUNK_DISPATCH = "chunk_dispatch"  # one device chunk of a batch.
HARVEST = "harvest"             # boundary: host copy, resolve, late joins.
LANE_SURGERY = "lane_surgery"   # boundary lane surgery (serving tier).
BOUNDARY_PUBLISH = "boundary_publish"  # snapshot + journal publication.
GUARD_DISPATCH = "guard_dispatch"  # BackendGuard primary attempt.
GUARD_FALLBACK = "guard_fallback"  # BackendGuard degrade/retry on CPU.
SESSION_STEP = "session_step"   # one closed-loop session control step
#                                 (not a critical-path segment: the inner
#                                 request's spans account the time).
RUN = "run"                     # recovery.run_chunks whole-run root.
CHUNK = "chunk"                 # one recovery chunk (compile+execute).
SNAPSHOT = "snapshot"           # boundary snapshot publish.
RESUME = "resume"               # resume_run boundary walk / agreement.
RETRY = "retry"                 # host-level requeue marker (instant).

# Critical-path segment order (also the subtraction priority for
# overlapping spans inside a request's in-batch window — see
# :func:`critical_path`): the boundary lane-surgery work and the
# snapshot/journal publication are carved before ``harvest``, inside
# whose window they nest.
SEGMENTS = ("queue_wait", "batch_wait", "device", "surgery", "publish",
            "harvest", "retry")

# Process-unique id prefix: pid alone recycles, so add entropy once per
# process. Ids only need to be unique, not secret or sortable.
_PROC_TOKEN = f"{os.getpid():x}-{os.urandom(3).hex()}"
_id_counter = itertools.count(1)


def new_trace_id() -> str:
    return f"t{_PROC_TOKEN}-{next(_id_counter):x}"


def new_span_id() -> str:
    return f"s{_PROC_TOKEN}-{next(_id_counter):x}"


def default_track() -> str:
    return f"pid{os.getpid()}"


@dataclasses.dataclass
class Span:
    """One open-or-finished span. Mutable on purpose: attributes accrete
    while the span is open (rung, error kind, lane map) and the end
    timestamps land at :meth:`Tracer.end`."""

    name: str
    trace_id: str
    span_id: str
    parent_id: str | None
    track: str
    t0_mono: float
    t0_wall: float
    attrs: dict = dataclasses.field(default_factory=dict)
    t1_mono: float | None = None
    t1_wall: float | None = None

    @property
    def ended(self) -> bool:
        return self.t1_mono is not None

    def set(self, **attrs) -> "Span":
        self.attrs.update(attrs)
        return self

    def to_row(self) -> dict:
        row = {
            "name": self.name,
            "trace_id": self.trace_id,
            "span_id": self.span_id,
            "track": self.track,
            "t0_mono": self.t0_mono,
            "t0_wall": self.t0_wall,
        }
        if self.parent_id is not None:
            row["parent_id"] = self.parent_id
        if self.t1_mono is not None:
            row["t1_mono"] = self.t1_mono
            row["t1_wall"] = self.t1_wall
        if self.attrs:
            row["attrs"] = self.attrs
        return row


# Sentinel: "parent defaults to the tracer's current lexical span".
_CURRENT = object()


class Tracer:
    """Records spans and exports each finished one as a ``trace_event``
    row.

    ``sink`` duck-types: an ``obs.export.MetricsWriter`` (anything with
    ``.emit``) receives ``emit("trace_event", **row)`` — the durable
    fsync'd jsonl path — while a plain callable receives the row dict;
    ``None`` keeps rows in-process only (``self.rows``). ``track`` names
    this process's timeline in the stitched trace (``p{pid}of{N}`` for
    one process of a multi-process run).

    NOT thread-safe by design: one tracer per host driver loop (server
    pump, chunk driver, bench sweep), matching how those loops already
    own their journals. The lexical-nesting stack (:meth:`span`) is what
    makes nested ``with`` blocks parent correctly without threading span
    handles everywhere; non-lexical spans (a ``queue_wait`` opened at
    submit and closed at a later boundary) use explicit
    :meth:`begin` / :meth:`end`.
    """

    def __init__(self, sink=None, *, track: str | None = None,
                 clock_mono=time.monotonic, clock_wall=time.time):
        self.sink = sink
        self.track = track or default_track()
        self.clock_mono = clock_mono
        self.clock_wall = clock_wall
        self.rows: list[dict] = []
        self._stack: list[Span] = []

    # ------------------------------------------------------- recording --
    def begin(self, name: str, *, parent=_CURRENT,
              trace_id: str | None = None, **attrs) -> Span:
        """Open a span. ``parent`` may be a :class:`Span`, a span-id
        string (with ``trace_id`` supplied), or ``None`` for an explicit
        root; by default the tracer's current lexical span is the
        parent. A root span with no ``trace_id`` starts a new trace."""
        if parent is _CURRENT:
            parent = self._stack[-1] if self._stack else None
        if isinstance(parent, Span):
            parent_id = parent.span_id
            trace_id = trace_id or parent.trace_id
        else:
            parent_id = parent
        return Span(
            name=name, trace_id=trace_id or new_trace_id(),
            span_id=new_span_id(), parent_id=parent_id, track=self.track,
            t0_mono=self.clock_mono(), t0_wall=self.clock_wall(),
            attrs=dict(attrs),
        )

    def end(self, span: Span, **attrs) -> dict:
        """Close a span (idempotent: a second end keeps the first
        timestamps and only merges attributes — callers on error paths
        may close defensively) and export its row."""
        if attrs:
            span.attrs.update(attrs)
        if span.ended:
            return span.to_row()
        span.t1_mono = self.clock_mono()
        span.t1_wall = self.clock_wall()
        return self._export(span.to_row())

    @contextlib.contextmanager
    def span(self, name: str, *, parent=_CURRENT,
             trace_id: str | None = None, **attrs):
        """Lexically scoped span: children opened inside the ``with``
        body parent under it automatically."""
        sp = self.begin(name, parent=parent, trace_id=trace_id, **attrs)
        self._stack.append(sp)
        try:
            yield sp
        finally:
            self._stack.pop()
            self.end(sp)

    def instant(self, name: str, *, parent=_CURRENT,
                trace_id: str | None = None, **attrs) -> dict:
        """Zero-duration marker (preemption, a skipped snapshot)."""
        sp = self.begin(name, parent=parent, trace_id=trace_id, **attrs)
        sp.t1_mono, sp.t1_wall = sp.t0_mono, sp.t0_wall
        return self._export(sp.to_row())

    def _export(self, row: dict) -> dict:
        self.rows.append(row)
        if self.sink is not None:
            if hasattr(self.sink, "emit"):
                self.sink.emit("trace_event", **row)
            else:
                self.sink(row)
        return row


class RequestTrace:
    """The per-ticket trace handle the serving tier hangs off a
    ``Ticket``: the root ``request`` span plus the (possibly still open)
    ``queue_wait`` child. ``Ticket.trace`` is ``None`` when tracing is
    off — every caller guards on that, which IS the zero-cost path."""

    __slots__ = ("tracer", "request_span", "queue_span")

    def __init__(self, tracer: Tracer, request_span: Span,
                 queue_span: Span | None = None):
        self.tracer = tracer
        self.request_span = request_span
        self.queue_span = queue_span

    @property
    def trace_id(self) -> str:
        return self.request_span.trace_id

    def admitted(self, **attrs) -> None:
        """Close the queue_wait span: the request entered a device lane."""
        if self.queue_span is not None and not self.queue_span.ended:
            self.tracer.end(self.queue_span, **attrs)

    def resolve(self, status: str, **attrs) -> None:
        """Terminal: close queue_wait (if the request never left the
        queue) and the root request span, with the outcome as
        attributes."""
        if self.queue_span is not None and not self.queue_span.ended:
            self.tracer.end(self.queue_span, status=status)
        self.tracer.end(self.request_span, status=status, **attrs)


# ----------------------------------------------------------------------
# Reading + stitching.
# ----------------------------------------------------------------------

def trace_rows(events) -> list[dict]:
    """The trace rows in a mixed event stream: metrics-jsonl
    ``trace_event`` events and bare ``Tracer.rows`` dicts alike."""
    return [
        e for e in events
        if (e.get("event") == "trace_event"
            or ("event" not in e and "span_id" in e and "trace_id" in e))
    ]


def stitch(rows: list[dict]) -> list[dict]:
    """Align every track's monotonic domain onto ONE shared clock.

    Each row carries both clocks, so each track's ``wall - mono`` offset
    is directly observable; the median over the track's rows is robust
    to a wall-clock step (NTP slew) mid-run. Returns copies with
    ``t0`` / ``t1`` stitched-seconds fields added; within a track the
    offset is one constant, so per-track ordering and every duration are
    exactly the monotonic ones."""
    by_track: dict[str, list[float]] = {}
    for r in rows:
        by_track.setdefault(r.get("track", "?"), []).append(
            r["t0_wall"] - r["t0_mono"]
        )
    offsets = {t: statistics.median(a) for t, a in by_track.items()}
    out = []
    for r in rows:
        off = offsets[r.get("track", "?")]
        s = dict(r)
        s["t0"] = r["t0_mono"] + off
        if r.get("t1_mono") is not None:
            s["t1"] = r["t1_mono"] + off
        out.append(s)
    return out


def stitch_run_dir(run_dir: str, *, allow_partial: bool = False,
                   manifest_prefix: str = "carry") -> list[dict]:
    """Stitch every trace row found in a run directory's jsonl files
    into one clock -- the multi-process path.

    A multi-process run gives each process its own metrics/journal file
    inside one shared run dir, and process 0 publishes the shard manifest
    (``harness.checkpoint.save_shard_manifest``) naming how many
    processes make the run complete. When that manifest exists, a
    stitched trace covering fewer process tracks than the manifest's
    ``n_processes`` raises (a "fleet" trace silently missing a process
    is exactly the lie this module exists to prevent) unless
    ``allow_partial=True``."""
    import glob as glob_mod

    rows: list[dict] = []
    for path in sorted(
        glob_mod.glob(os.path.join(run_dir, "*.jsonl"))
    ):
        rows.extend(trace_rows(_read_jsonl(path)))
    manifest_path = os.path.join(
        run_dir, f"{manifest_prefix}.shards.json"
    )
    if os.path.exists(manifest_path) and not allow_partial:
        with open(manifest_path, encoding="utf-8") as fh:
            manifest = json.load(fh)
        want = manifest.get("n_processes")
        tracks = {r.get("track") for r in rows}
        # ZERO rows is the most complete form of the partial-fleet lie
        # (every worker killed before a span ended), so the refusal must
        # not be gated on rows being non-empty.
        if want and len(tracks) < want:
            raise ValueError(
                f"{run_dir}: shard manifest names {want} processes but "
                f"trace rows cover only {len(tracks)} track(s) "
                f"({sorted(t for t in tracks if t)}); a partial stitch "
                "would silently drop a process's spans "
                "(allow_partial=True to override)"
            )
    return stitch(rows)


def _read_jsonl(path: str) -> list[dict]:
    """Torn-tail-tolerant jsonl read. Duplicates the tiny
    ``obs.export.jsonl_read`` loop instead of importing it: export pulls
    the telemetry module (and with it torch) at import time, and this
    module stays stdlib-only."""
    out = []
    with open(path, encoding="utf-8") as fh:
        for line in fh:
            try:
                obj = json.loads(line)
            except ValueError:
                continue
            if isinstance(obj, dict):
                out.append(obj)
    return out


# ----------------------------------------------------------------------
# Chrome/Perfetto trace-event JSON.
# ----------------------------------------------------------------------

def chrome_trace(rows: list[dict]) -> dict:
    """Convert (stitched) rows to Chrome trace-event JSON.

    Layout: one Chrome *process* per track; inside it, one named thread
    row per span name, widened by greedy interval packing when same-name
    spans overlap (concurrent ``request`` spans get ``request``,
    ``request.1``, ... lanes) — every ``X`` slice track is overlap-free,
    which both Perfetto's trace processor and the ci validator's
    per-track monotonicity check require. Parent/trace linkage rides the
    ``args`` (the span graph is the source of truth; the thread layout
    is presentation)."""
    rows = [dict(r) for r in rows]
    if any("t0" not in r for r in rows):
        rows = stitch(rows)
    tracks = sorted({r.get("track", "?") for r in rows})
    pid_of = {t: i + 1 for i, t in enumerate(tracks)}
    t_origin = min((r["t0"] for r in rows), default=0.0)

    events: list[dict] = []
    for t in tracks:
        events.append({
            "ph": "M", "name": "process_name", "pid": pid_of[t], "tid": 0,
            "args": {"name": t},
        })

    # (track, name) -> packed lanes; tid allocated per (track, name, lane).
    tid_alloc: dict[tuple, int] = {}
    lane_ends: dict[tuple, list[float]] = {}

    def _tid(track: str, name: str, t0: float, t1: float) -> int:
        ends = lane_ends.setdefault((track, name), [])
        for lane, end in enumerate(ends):
            if t0 >= end - 1e-12:
                ends[lane] = t1
                break
        else:
            lane = len(ends)
            ends.append(t1)
        key = (track, name, lane)
        if key not in tid_alloc:
            tid_alloc[key] = len(tid_alloc) + 1
            events.append({
                "ph": "M", "name": "thread_name", "pid": pid_of[track],
                "tid": tid_alloc[key],
                "args": {"name": name if lane == 0 else f"{name}.{lane}"},
            })
        return tid_alloc[key]

    for r in sorted(rows, key=lambda r: (r.get("track", "?"), r["t0"])):
        track = r.get("track", "?")
        args = {
            "trace_id": r["trace_id"], "span_id": r["span_id"],
            **({"parent_id": r["parent_id"]} if r.get("parent_id") else {}),
            **r.get("attrs", {}),
        }
        ts_us = (r["t0"] - t_origin) * 1e6
        t1 = r.get("t1")
        if t1 is None or t1 <= r["t0"]:
            events.append({
                "ph": "i", "s": "t", "name": r["name"],
                "pid": pid_of[track],
                "tid": _tid(track, r["name"], r["t0"], r["t0"]),
                "ts": ts_us, "cat": "tat", "args": args,
            })
        else:
            events.append({
                "ph": "X", "name": r["name"], "pid": pid_of[track],
                "tid": _tid(track, r["name"], r["t0"], t1),
                "ts": ts_us, "dur": (t1 - r["t0"]) * 1e6,
                "cat": "tat", "args": args,
            })
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def write_chrome_trace(path: str, rows: list[dict]) -> dict:
    obj = chrome_trace(rows)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + f".tmp.{os.getpid()}"
    with open(tmp, "w", encoding="utf-8") as fh:
        json.dump(obj, fh)
        fh.flush()
        # fsync before the rename: otherwise a crash can land
        # the rename on disk ahead of the data and publish empty bytes.
        os.fsync(fh.fileno())
    os.replace(tmp, path)
    return obj


def validate_chrome_trace(obj) -> list[str]:
    """Structural checks for an emitted trace file (the ci gate):
    well-formed trace-event JSON, non-negative durations, per-(pid,tid)
    monotone begin timestamps with no overlapping slices, and — the span
    graph's integrity — every ``parent_id`` present among the file's
    span ids."""
    errs: list[str] = []
    if not isinstance(obj, dict) or not isinstance(
        obj.get("traceEvents"), list
    ):
        return ["not a trace-event JSON object with a traceEvents list"]
    span_ids = set()
    parents = []
    by_thread: dict[tuple, list[tuple[float, float]]] = {}
    for i, e in enumerate(obj["traceEvents"]):
        if not isinstance(e, dict) or "ph" not in e:
            errs.append(f"event {i}: not an object with ph")
            continue
        if e["ph"] == "M":
            continue
        for k in ("name", "pid", "tid", "ts"):
            if k not in e:
                errs.append(f"event {i}: missing {k}")
        args = e.get("args", {})
        if isinstance(args, dict):
            if "span_id" in args:
                span_ids.add(args["span_id"])
            if args.get("parent_id"):
                parents.append((i, args["parent_id"]))
        dur = e.get("dur", 0.0)
        if e["ph"] == "X" and dur < 0:
            errs.append(f"event {i}: negative dur {dur}")
        if "ts" in e and "pid" in e and "tid" in e:
            by_thread.setdefault((e["pid"], e["tid"]), []).append(
                (float(e["ts"]), float(e.get("dur", 0.0)))
            )
    for (pid, tid), slices in by_thread.items():
        last_ts, last_end = -1.0, -1.0
        for ts, dur in slices:
            if ts < last_ts:
                errs.append(
                    f"track pid={pid} tid={tid}: non-monotone ts "
                    f"{ts} after {last_ts}"
                )
            if ts < last_end - 1e-6:
                errs.append(
                    f"track pid={pid} tid={tid}: slice at {ts} overlaps "
                    f"previous slice ending {last_end}"
                )
            last_ts, last_end = ts, max(last_end, ts + dur)
    for i, pid_ in parents:
        if pid_ not in span_ids:
            errs.append(f"event {i}: parent_id {pid_} not in this trace")
    return errs


def validate_trace_file(path: str) -> list[str]:
    try:
        with open(path, encoding="utf-8") as fh:
            obj = json.load(fh)
    except Exception as e:  # noqa: BLE001 — report, don't crash the gate.
        return [f"unreadable/unparseable: {type(e).__name__}: {e}"]
    return validate_chrome_trace(obj)


# ----------------------------------------------------------------------
# Critical-path accounting.
# ----------------------------------------------------------------------

def _t0(r):
    return r["t0"] if "t0" in r else r["t0_mono"]


def _t1(r):
    if "t1" in r:
        return r["t1"]
    return r.get("t1_mono")


def _merge(intervals: list[tuple[float, float]]) -> list[tuple[float, float]]:
    out: list[list[float]] = []
    for a, b in sorted(intervals):
        if b <= a:
            continue
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def _clip(intervals, lo: float, hi: float):
    return [(max(a, lo), min(b, hi)) for a, b in intervals
            if max(a, lo) < min(b, hi)]


def _subtract(intervals, taken):
    """``intervals`` minus the (merged) ``taken`` set."""
    out = []
    for a, b in intervals:
        cur = a
        for ta, tb in taken:
            if tb <= cur or ta >= b:
                continue
            if ta > cur:
                out.append((cur, ta))
            cur = max(cur, tb)
            if cur >= b:
                break
        if cur < b:
            out.append((cur, b))
    return out


def _measure(intervals) -> float:
    return sum(b - a for a, b in intervals)


def critical_path(rows: list[dict]) -> dict:
    """Decompose each resolved request's submit→complete interval into
    the :data:`SEGMENTS`.

    Per request (one ``request`` root span): ``queue_wait`` is its own
    child span; the in-batch window (queue end → completion) is then
    carved by priority — ``retry`` (guard_fallback time on a dispatch
    that served this request), ``device`` (chunk_dispatch spans whose
    lane map contains the request's trace), ``harvest`` (boundary
    processing of those batches) — and whatever remains is
    ``batch_wait`` (admitted but the device was serving other lanes /
    the server loop was elsewhere). The segments therefore sum to the
    request's total EXACTLY by construction; the residual claim is
    honest because every carved segment is real measured span time.

    Rows may be stitched or single-process raw rows (mono clock); batch
    spans and their member requests always share a process, so the
    per-request arithmetic is clock-consistent either way.

    Re-measured requests (append-mode metrics files, resume re-resolving
    a restored ticket) are deduped per ``request_id`` — the LAST request
    span wins, the run_health dedup rule."""
    reqs = [r for r in rows
            if r.get("name") == REQUEST and _t1(r) is not None]
    by_rid: dict[str, dict] = {}
    for r in sorted(reqs, key=_t0):
        rid = r.get("attrs", {}).get("request_id")
        by_rid[rid or r["trace_id"]] = r
    reqs = list(by_rid.values())
    by_id = {r["span_id"]: r for r in rows if "span_id" in r}
    queue_by_trace: dict[str, list[dict]] = {}
    member_spans: dict[str, dict[str, list[tuple[float, float]]]] = {}
    for r in rows:
        if r.get("name") == QUEUE_WAIT and _t1(r) is not None:
            queue_by_trace.setdefault(r["trace_id"], []).append(r)
        elif (r.get("name") in (CHUNK_DISPATCH, HARVEST, GUARD_FALLBACK,
                                LANE_SURGERY, BOUNDARY_PUBLISH)
              and _t1(r) is not None):
            seg = {CHUNK_DISPATCH: "device", HARVEST: "harvest",
                   GUARD_FALLBACK: "retry", LANE_SURGERY: "surgery",
                   BOUNDARY_PUBLISH: "publish"}[r["name"]]
            for member in _members(r, by_id):
                member_spans.setdefault(member, {}).setdefault(
                    seg, []
                ).append((_t0(r), _t1(r)))

    out_reqs = []
    for r in reqs:
        tid = r["trace_id"]
        t0, t1 = _t0(r), _t1(r)
        total = t1 - t0
        qspans = queue_by_trace.get(tid, [])
        queue_ivs = _clip(
            _merge([(_t0(q), _t1(q)) for q in qspans]), t0, t1
        )
        queue_s = _measure(queue_ivs)
        # Clamped to the request span's own start: a RESTORED request
        # (resume path) has no new queue_wait span, but the dead run's
        # queue span shares its trace_id — an unclamped win_lo would
        # open the window before this request span even began and count
        # pre-resume batch spans into its segments.
        win_lo = max(t0, max((_t1(q) for q in qspans), default=t0))
        window = _clip([(win_lo, t1)], t0, t1)
        taken: list[tuple[float, float]] = []
        segs = {"queue_wait": queue_s}
        # surgery/publish carve BEFORE harvest: in sync mode their spans
        # nest inside the harvest window, and the decomposition must
        # attribute that time to the finer segment, not the envelope.
        for seg in ("retry", "device", "surgery", "publish", "harvest"):
            ivs = _clip(
                _merge(member_spans.get(tid, {}).get(seg, [])), win_lo, t1
            )
            ivs = _subtract(ivs, taken)
            segs[seg] = _measure(ivs)
            taken = _merge(taken + ivs)
        segs["batch_wait"] = max(
            0.0, _measure(window) - segs["retry"] - segs["device"]
            - segs["surgery"] - segs["publish"] - segs["harvest"]
        )
        out_reqs.append({
            "trace_id": tid,
            "request_id": r.get("attrs", {}).get("request_id"),
            "status": r.get("attrs", {}).get("status"),
            "total_s": total,
            "segments": {k: segs[k] for k in SEGMENTS},
        })

    per_segment = {}
    completed = [q for q in out_reqs if q["status"] == "completed"]
    for seg in SEGMENTS:
        xs = sorted(q["segments"][seg] for q in completed)
        if xs:
            per_segment[seg] = {
                "p50": _pctl(xs, 0.5), "p99": _pctl(xs, 0.99),
                "mean": sum(xs) / len(xs), "total": sum(xs),
            }
    worst = max(completed, key=lambda q: q["total_s"], default=None)
    return {
        "requests": out_reqs,
        "completed": len(completed),
        "per_segment": per_segment,
        "worst": worst,
    }


def _members(row: dict, by_id: dict[str, dict]) -> list[str]:
    """Trace ids a batch-level span served: its own ``lanes`` lane map
    (``[[lane, request_id, trace_id], ...]``) or ``members`` list, else
    inherited up the parent chain (guard spans nest under the dispatch
    whose lane map names the riders)."""
    seen = 0
    while row is not None and seen < 8:
        attrs = row.get("attrs", {})
        lanes = attrs.get("lanes")
        if lanes:
            return [m[2] for m in lanes if len(m) >= 3 and m[2]]
        if attrs.get("members"):
            return list(attrs["members"])
        row = by_id.get(row.get("parent_id"))
        seen += 1
    return []


def _pctl(xs_sorted: list[float], p: float) -> float:
    k = min(len(xs_sorted) - 1, max(0, round(p * (len(xs_sorted) - 1))))
    return xs_sorted[k]
