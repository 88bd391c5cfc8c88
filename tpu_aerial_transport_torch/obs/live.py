"""Live streaming telemetry: the in-process metrics hub, cross-replica jsonl
tailing, rolling windows and the declarative SLO / burn-rate engine.

The port's own copy of the JAX package's ``obs/live.py``, stdlib-only (no
torch, no numpy: a console or coordinator process never pays for a device).
Three layers:

1. :class:`MetricsHub` -- in-process counters, gauges and one latency
   distribution primitive (:class:`LogHistogram`, log-bucketed and
   mergeable: merging is per-bucket integer addition, so it is associative
   and order-independent). The serving tier feeds it: ``hub=`` on
   ``serving.server.ScenarioServer`` (its events through
   :meth:`MetricsHub.ingest_serving`), ``serving.queue.AdmissionQueue``
   (``queue.*`` counters), ``serving.sessions.SessionHost`` (session steps),
   ``resilience.backend.BackendGuard`` (backend events) and
   ``aot.loader.serve_entry`` (the serve ladder's rungs). Every site guards
   ``hub is not None``, so ``hub=None`` allocates nothing per request. Hub
   mutation holds only the hub's own leaf lock and does pure dict
   arithmetic, never I/O.

2. :class:`JsonlTailer` / :class:`FleetTailer` -- follow the
   ``obs.export`` metrics jsonl files live. Torn-tail tolerant by the rule
   of ``obs.export.jsonl_read`` (an unparseable interior line is skipped; a
   tail not yet ended by a newline is held back until the writer finishes
   it), rotation-aware (an inode change or a shrink reopens from the top)
   and resumable from a byte offset. At quiescence the tailed stream equals
   a post-hoc ``jsonl_read``.

3. :class:`RollingWindows` + :class:`SLOEngine` -- events merge into
   bounded per-second rings keyed ``(tenant, family, replica)``; window
   queries (1 s/10 s/60 s for a console, the specs' 5 min/1 h for alerting)
   sum the ring's trailing seconds. :class:`SLOSpec` rows (per-tenant p99
   step latency, deadline-miss rate, rejection rate, cache-hit rate) compile
   into error budgets; the multi-window burn-rate rule (page only when the
   short and the long window both burn above threshold) drives alert
   fire/resolve, journaled as the schema-v9 ``alert`` event kind
   (``obs.export``). :meth:`SLOEngine.max_burn` is the budget-burn input a
   fleet front's autoscale hint reads.

Clock domain: everything here lives on the wall clock -- window and alert
arithmetic keys off the events' journaled ``ts`` (wall epoch), never the
host's monotonic clock, so replaying a file gives the windows the live run
saw.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import threading

__all__ = [
    "LogHistogram", "MetricsHub", "JsonlTailer", "FleetTailer",
    "RollingWindows", "SLOSpec", "SLOEngine", "DEFAULT_SLOS",
    "parse_slo_spec", "resolve_refresh_s", "resolve_burn_rates",
]

# ----------------------------------------------------------------------
# Log-bucketed mergeable histogram (THE latency-distribution primitive).
# ----------------------------------------------------------------------

# Buckets per octave: bucket(v) = floor(log2(v) * 4), i.e. boundaries at
# quarter-powers-of-two (~19% relative width — p99 resolution well under
# the rung-to-rung latency ratios the serving tier cares about).
_SUB = 4


class LogHistogram:
    """Sparse log-bucketed histogram over positive floats.

    Values <= 0 land in a dedicated zero bucket (a zero-length SLO
    window from a cache hit is data, not an error). Quantiles return
    the UPPER edge of the bucket where the cumulative count crosses the
    rank — a deterministic, merge-invariant answer: ``quantile`` over
    ``a.merge(b)`` equals ``quantile`` over the concatenated
    observations bucketed the same way, regardless of merge order
    (per-bucket integer addition is associative and commutative)."""

    __slots__ = ("counts", "n", "total", "zero")

    def __init__(self):
        self.counts: dict[int, int] = {}
        self.n = 0
        self.total = 0.0
        self.zero = 0

    @staticmethod
    def bucket_of(value: float) -> int | None:
        """Bucket index for a positive value; None = the zero bucket."""
        if value <= 0.0:
            return None
        return math.floor(math.log2(value) * _SUB)

    @staticmethod
    def upper_edge(idx: int) -> float:
        return 2.0 ** ((idx + 1) / _SUB)

    def add(self, value: float, n: int = 1) -> None:
        idx = self.bucket_of(value)
        if idx is None:
            self.zero += n
        else:
            self.counts[idx] = self.counts.get(idx, 0) + n
        self.n += n
        self.total += float(value) * n

    def merge(self, other: "LogHistogram") -> "LogHistogram":
        """In-place per-bucket addition; returns self."""
        for idx, c in other.counts.items():
            self.counts[idx] = self.counts.get(idx, 0) + c
        self.n += other.n
        self.total += other.total
        self.zero += other.zero
        return self

    def copy(self) -> "LogHistogram":
        out = LogHistogram()
        out.counts = dict(self.counts)
        out.n, out.total, out.zero = self.n, self.total, self.zero
        return out

    def quantile(self, q: float) -> float | None:
        """Upper bucket edge at the ``q`` cumulative rank (None when
        empty). The zero bucket sorts first (edge 0.0)."""
        if self.n == 0:
            return None
        rank = max(1, math.ceil(q * self.n))
        cum = self.zero
        if cum >= rank:
            return 0.0
        for idx in sorted(self.counts):
            cum += self.counts[idx]
            if cum >= rank:
                return self.upper_edge(idx)
        return self.upper_edge(max(self.counts))

    def count_above(self, threshold: float) -> int:
        """Observations in buckets strictly ABOVE the bucket containing
        ``threshold`` — the deterministic (bucket-resolution,
        merge-invariant) "requests slower than the SLO threshold"
        count the latency burn rate is computed from."""
        cut = self.bucket_of(threshold)
        if cut is None:
            return self.n - self.zero
        return sum(c for idx, c in self.counts.items() if idx > cut)

    def to_dict(self) -> dict:
        return {
            "n": self.n, "total": self.total, "zero": self.zero,
            "counts": {str(k): v for k, v in sorted(self.counts.items())},
        }

    @classmethod
    def from_dict(cls, obj: dict) -> "LogHistogram":
        out = cls()
        out.n = int(obj.get("n", 0))
        out.total = float(obj.get("total", 0.0))
        out.zero = int(obj.get("zero", 0))
        out.counts = {int(k): int(v)
                      for k, v in obj.get("counts", {}).items()}
        return out

    def summary(self) -> dict:
        return {
            "count": self.n,
            "mean": (self.total / self.n) if self.n else None,
            "p50": self.quantile(0.50),
            "p90": self.quantile(0.90),
            "p99": self.quantile(0.99),
        }


# ----------------------------------------------------------------------
# In-process metrics hub.
# ----------------------------------------------------------------------

class MetricsHub:
    """Thread-safe in-process counters / gauges / histograms.

    The hub is the live-ops sibling of ``obs.export.MetricsWriter``: the
    writer journals events durably (fsync per row), the hub keeps cheap
    in-memory aggregates the process can snapshot at any point with no
    file reads. Mutation holds only the hub's own lock and does pure
    dict arithmetic — never any I/O — and the
    hub's lock is a LEAF: hub methods take no other lock, so no
    lock-order cycle can involve it.

    Every instrumentation site is guarded ``hub is not None`` (identity,
    never truthiness), which is the whole zero-cost contract:
    with ``hub=None`` no per-request allocation or call happens."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: dict[tuple, float] = {}
        self._gauges: dict[tuple, float] = {}
        self._hists: dict[tuple, LogHistogram] = {}

    # ---------------------------------------------------- primitives --
    def inc(self, name: str, key=None, n: float = 1) -> None:
        with self._lock:
            k = (name, key)
            self._counters[k] = self._counters.get(k, 0) + n

    def gauge(self, name: str, value: float, key=None) -> None:
        with self._lock:
            self._gauges[(name, key)] = float(value)

    def observe(self, name: str, value: float, key=None) -> None:
        with self._lock:
            h = self._hists.get((name, key))
            if h is None:
                h = self._hists[(name, key)] = LogHistogram()
            h.add(float(value))

    # ------------------------------------- instrumentation ingestors --
    # One mapper per instrumented tier, taking the ALREADY-BUILT event
    # fields dict (the emit funnels allocate it regardless of the hub),
    # so a hub adds zero marginal allocation at the call site.

    def ingest_serving(self, fields: dict) -> None:
        kind = fields.get("kind")
        tenant = fields.get("tenant")
        self.inc("serving.events", key=kind)
        if kind == "rejected":
            self.inc("serving.rejected", key=fields.get("reason"))
        elif kind in ("completed", "deadline_missed"):
            slo = fields.get("slo")
            lat = slo.get("latency_s") if isinstance(slo, dict) else None
            if lat is not None:
                self.observe("serving.latency_s", lat, key=tenant)
        elif kind == "batch_boundary":
            occ = fields.get("occupancy")
            if occ is not None:
                self.gauge("serving.occupancy", occ,
                           key=fields.get("family"))
        if "depth" in fields:
            self.gauge("queue.depth", fields["depth"])

    def ingest_session(self, fields: dict) -> None:
        kind = fields.get("kind")
        self.inc("session.events", key=kind)
        if kind in ("step_done", "step_degraded"):
            slo = fields.get("slo")
            lat = slo.get("latency_s") if isinstance(slo, dict) else None
            if lat is not None:
                self.observe("session.step_latency_s", lat,
                             key=fields.get("rung"))

    def ingest_backend(self, event: dict) -> None:
        self.inc("backend.events", key=event.get("kind"))

    def ingest_aot(self, event: dict) -> None:
        rung = event.get("rung")
        self.inc("aot.serves", key=rung)
        wall = event.get("wall_s")
        if wall is not None:
            self.observe("aot.wall_s", wall, key=rung)

    # ------------------------------------------------------ snapshot --
    @staticmethod
    def _label(k: tuple) -> str:
        name, key = k
        return name if key is None else f"{name}{{{key}}}"

    def snapshot(self) -> dict:
        """JSON-ready copy of every aggregate (counters, gauges, and
        histogram summaries + raw buckets for exact downstream merges)."""
        with self._lock:
            counters = dict(self._counters)
            gauges = dict(self._gauges)
            hists = {k: h.copy() for k, h in self._hists.items()}
        return {
            "counters": {self._label(k): v
                         for k, v in sorted(counters.items(),
                                            key=lambda kv: str(kv[0]))},
            "gauges": {self._label(k): v
                       for k, v in sorted(gauges.items(),
                                          key=lambda kv: str(kv[0]))},
            "histograms": {
                self._label(k): {**h.summary(), "buckets": h.to_dict()}
                for k, h in sorted(hists.items(),
                                   key=lambda kv: str(kv[0]))
            },
        }


# ----------------------------------------------------------------------
# Live jsonl tailing.
# ----------------------------------------------------------------------

class JsonlTailer:
    """Follow ONE append-only jsonl file.

    ``poll()`` returns the events appended since the last poll. Byte
    offsets (``self.offset``) are the resume token: construct with
    ``offset=`` to continue a previous console's position. Reads are in
    binary so offsets are exact regardless of encoding.

    Torn-tail rule (the ``jsonl_read`` discipline, live edition): only
    NEWLINE-TERMINATED lines are parsed; the unfinished tail a
    concurrent ``jsonl_append`` is mid-write on stays buffered until
    its newline arrives. An unparseable *terminated* line (the torn
    interior a crash left) is skipped, exactly as ``jsonl_read`` skips
    it. Rotation (a new inode at the path, or the file shrinking below
    our offset) reopens from byte 0."""

    def __init__(self, path: str, offset: int = 0):
        self.path = path
        self.offset = int(offset)
        self._ino: int | None = None
        self._buf = b""

    def poll(self) -> list[dict]:
        try:
            st = os.stat(self.path)
        except OSError:
            return []
        if self._ino is None:
            self._ino = st.st_ino
        elif st.st_ino != self._ino or st.st_size < self.offset:
            # Rotated (new file at the path) or truncated: restart.
            self._ino = st.st_ino
            self.offset = 0
            self._buf = b""
        if st.st_size <= self.offset and not self._buf:
            return []
        with open(self.path, "rb") as fh:
            fh.seek(self.offset)
            data = fh.read()
        self.offset += len(data)
        self._buf += data
        lines = self._buf.split(b"\n")
        self._buf = lines.pop()  # the (possibly empty) unfinished tail.
        out = []
        for line in lines:
            if not line.strip():
                continue
            try:
                out.append(json.loads(line))
            except ValueError:
                continue  # torn interior line — jsonl_read skips it too.
        return out


class FleetTailer:
    """Tail every replica's metrics jsonl, discovering new files live.

    ``roots`` is a list of file paths and/or directories; directories
    are re-scanned for ``*.metrics.jsonl`` on every poll (a replica that
    boots mid-run starts streaming as soon as its file appears).
    ``poll()`` yields ``(replica, event)`` pairs, the replica label
    being the file stem (``r0.metrics.jsonl`` -> ``r0``)."""

    SUFFIX = ".metrics.jsonl"

    def __init__(self, roots, offsets: dict[str, int] | None = None):
        self.roots = [roots] if isinstance(roots, str) else list(roots)
        self.tailers: dict[str, JsonlTailer] = {}
        self._offsets = dict(offsets or {})

    @classmethod
    def replica_of(cls, path: str) -> str:
        base = os.path.basename(path)
        if base.endswith(cls.SUFFIX):
            return base[: -len(cls.SUFFIX)]
        return os.path.splitext(base)[0]

    def _discover(self) -> list[str]:
        found = []
        for root in self.roots:
            if os.path.isdir(root):
                try:
                    names = sorted(os.listdir(root))
                except OSError:
                    continue
                found.extend(os.path.join(root, n) for n in names
                             if n.endswith(self.SUFFIX))
            else:
                found.append(root)
        return found

    def poll(self) -> list[tuple[str, dict]]:
        out: list[tuple[str, dict]] = []
        for path in self._discover():
            t = self.tailers.get(path)
            if t is None:
                t = self.tailers[path] = JsonlTailer(
                    path, offset=self._offsets.get(path, 0)
                )
            replica = self.replica_of(path)
            for event in t.poll():
                out.append((replica, event))
        return out

    def offsets(self) -> dict[str, int]:
        """Resume tokens for every tailed file."""
        return {path: t.offset for path, t in self.tailers.items()}


# ----------------------------------------------------------------------
# Rolling windows.
# ----------------------------------------------------------------------

class _Slot:
    """One (second, group) aggregation cell."""

    __slots__ = ("counts", "latency")

    def __init__(self):
        self.counts: dict[str, int] = {}
        self.latency = LogHistogram()

    def bump(self, key: str, n: int = 1) -> None:
        self.counts[key] = self.counts.get(key, 0) + n


# The console's standard display windows (seconds).
CONSOLE_WINDOWS = (1, 10, 60)

_DEF_TENANT = "default"


class RollingWindows:
    """Per-second ring of event aggregates keyed (tenant, family,
    replica).

    The ring is a bounded dict of whole-second slots: ingest folds one
    event into its ``int(ts)`` slot, and slots older than ``horizon_s``
    behind the newest timestamp are dropped (the ring wraps). Window
    queries sum the trailing N seconds — any N up to the horizon, so the
    console's 1s/10s/60s views and the SLO engine's 5m/1h burn windows
    read the same ring. All arithmetic is on journaled wall ``ts``
    values: replaying a file reproduces the live run's windows
    exactly."""

    def __init__(self, horizon_s: int = 3600):
        self.horizon_s = int(horizon_s)
        self._seconds: dict[int, dict[tuple, _Slot]] = {}
        self.latest_ts: float | None = None

    # ------------------------------------------------------- ingest --
    def ingest(self, replica: str, event: dict) -> None:
        etype = event.get("event")
        ts = event.get("ts")
        if not isinstance(ts, (int, float)):
            return
        if etype == "serving_event":
            self._ingest_serving(replica, event, ts)
        elif etype == "session_event":
            self._ingest_session(replica, event, ts)
        else:
            return
        if self.latest_ts is None or ts > self.latest_ts:
            self.latest_ts = ts
            self._prune(int(ts))

    def _slot(self, ts: float, tenant: str, family: str,
              replica: str) -> _Slot:
        sec = self._seconds.setdefault(int(ts), {})
        key = (tenant, family, replica)
        slot = sec.get(key)
        if slot is None:
            slot = sec[key] = _Slot()
        return slot

    def _ingest_serving(self, replica: str, event: dict,
                        ts: float) -> None:
        kind = event.get("kind")
        tenant = event.get("tenant", _DEF_TENANT)
        family = event.get("family", "?")
        slot = self._slot(ts, tenant, family, replica)
        if kind == "submitted":
            slot.bump("submitted")
        elif kind == "rejected":
            slot.bump("submitted")  # a rejected submit is an attempt.
            slot.bump("rejected")
        elif kind == "cache_hit":
            slot.bump("cache_hit")
        elif kind == "completed":
            slot.bump("completed")
            slo = event.get("slo")
            lat = slo.get("latency_s") if isinstance(slo, dict) else None
            if lat is not None:
                slot.latency.add(lat)
        elif kind == "deadline_missed":
            slot.bump("missed")

    def _ingest_session(self, replica: str, event: dict,
                        ts: float) -> None:
        kind = event.get("kind")
        tenant = event.get("tenant", _DEF_TENANT)
        family = event.get("family", "session")
        if kind == "step_done":
            slot = self._slot(ts, tenant, family, replica)
            slot.bump("steps")
            slo = event.get("slo")
            lat = slo.get("latency_s") if isinstance(slo, dict) else None
            if lat is not None:
                slot.latency.add(lat)
        elif kind == "step_degraded":
            slot = self._slot(ts, tenant, family, replica)
            slot.bump("steps")
            slot.bump("degraded")

    def _prune(self, newest_sec: int) -> None:
        floor = newest_sec - self.horizon_s
        if len(self._seconds) > self.horizon_s + 60:
            for sec in [s for s in self._seconds if s < floor]:
                del self._seconds[sec]

    # ------------------------------------------------------ queries --
    def groups(self) -> list[tuple]:
        seen = set()
        for sec in self._seconds.values():
            seen.update(sec)
        return sorted(seen)

    def tenants(self) -> list[str]:
        return sorted({g[0] for g in self.groups()})

    def window(self, window_s: int, now: float | None = None,
               tenant: str | None = None):
        """Aggregate the trailing ``window_s`` seconds ending at ``now``
        (default: the newest ingested ts) into one counts dict + merged
        latency histogram; ``tenant`` restricts to one tenant."""
        now = self.latest_ts if now is None else now
        counts: dict[str, int] = {}
        hist = LogHistogram()
        if now is None:
            return counts, hist
        end = int(now)
        for sec in range(end - int(window_s) + 1, end + 1):
            by_group = self._seconds.get(sec)
            if not by_group:
                continue
            for (t, _f, _r), slot in by_group.items():
                if tenant is not None and t != tenant:
                    continue
                for k, v in slot.counts.items():
                    counts[k] = counts.get(k, 0) + v
                hist.merge(slot.latency)
        return counts, hist

    def rates(self, window_s: int, now: float | None = None) -> dict:
        """Per-tenant derived rates over one window — the console row."""
        out: dict[str, dict] = {}
        for tenant in self.tenants():
            counts, hist = self.window(window_s, now=now, tenant=tenant)
            resolved = counts.get("completed", 0) + counts.get("missed", 0)
            attempts = counts.get("submitted", 0)
            out[tenant] = {
                "window_s": int(window_s),
                **counts,
                "latency": hist.summary(),
                "miss_rate": (counts.get("missed", 0) / resolved
                              if resolved else None),
                "rejection_rate": (counts.get("rejected", 0) / attempts
                                   if attempts else None),
                "cache_hit_rate": (
                    counts.get("cache_hit", 0) / counts["completed"]
                    if counts.get("completed") else None
                ),
            }
        return out


# ----------------------------------------------------------------------
# Declarative SLOs + multi-window burn-rate alerting.
# ----------------------------------------------------------------------

# Metric -> (bad, total) extractors over one window's (counts, hist).
SLO_METRICS = ("step_latency", "deadline_miss", "rejection", "cache_hit")

DEFAULT_BURN_RATES = (14.4, 6.0)


def resolve_burn_rates(configured=None) -> tuple[float, float]:
    """Resolve the (fast, slow) burn-rate thresholds: the
    ``TAT_SLO_BURN_RATES`` env force (``"FAST:SLOW"``) wins, then the
    configured pair, then :data:`DEFAULT_BURN_RATES`.

    TUNING CRITERION: a burn rate of B exhausts the error budget in
    ``period / B`` — the defaults are the classic SRE pair (14.4 over
    the short window pages when a 30-day budget would die in ~2 days;
    6 warns at ~5 days). Lower them when budgets are tighter than the
    window ratio assumes; raising them above ~30 makes the fast alert
    fire only on total outages."""
    spec = os.environ.get("TAT_SLO_BURN_RATES")
    if spec:
        parts = spec.split(":")
        if len(parts) != 2:
            raise ValueError(
                f"TAT_SLO_BURN_RATES must be 'FAST:SLOW', got {spec!r}"
            )
        fast, slow = (float(p) for p in parts)
    elif configured is not None:
        fast, slow = (float(v) for v in configured)
    else:
        fast, slow = DEFAULT_BURN_RATES
    if fast <= 0 or slow <= 0:
        raise ValueError(
            f"burn-rate thresholds must be > 0, got ({fast}, {slow})"
        )
    return fast, slow


DEFAULT_REFRESH_S = 1.0


def resolve_refresh_s(configured=None) -> float:
    """Resolve the live-console refresh period (seconds): the
    ``TAT_CONSOLE_REFRESH_S`` env force wins, then the configured value,
    then :data:`DEFAULT_REFRESH_S`.

    TUNING CRITERION: the refresh is pure reader-side cost (tail +
    window math; the serving path is untouched), so the floor is
    terminal legibility, not overhead — but every refresh re-stats N
    replica files, so fleets with hundreds of replicas on networked
    filesystems should back off to a few seconds."""
    env = os.environ.get("TAT_CONSOLE_REFRESH_S")
    if env:
        value = float(env)
    elif configured is not None:
        value = float(configured)
    else:
        value = DEFAULT_REFRESH_S
    if value <= 0:
        raise ValueError(f"refresh period must be > 0, got {value}")
    return value


@dataclasses.dataclass(frozen=True)
class SLOSpec:
    """One declarative SLO: ``objective`` is the GOOD fraction target
    (0.99 = 99% of events good), compiling to an error budget of
    ``1 - objective``. ``metric`` picks the bad/total extractor:

    - ``step_latency``: bad = resolved requests/steps slower than
      ``threshold_s`` (bucket-resolution, merge-invariant);
    - ``deadline_miss``: bad = deadline misses / resolved;
    - ``rejection``: bad = rejected / submit attempts;
    - ``cache_hit``: bad = uncached completions / completions (an
      inverted SLI: the objective is the hit rate).

    ``tenant=None`` evaluates per tenant over every tenant seen. The
    burn rule is multi-window: an alert fires only when the burn rate
    over BOTH the fast and slow window clears a threshold (fast pair
    pages, slow pair warns), and resolves when the fast window drops
    back below the slow threshold."""

    name: str
    metric: str
    objective: float
    threshold_s: float | None = None
    tenant: str | None = None
    fast_window_s: int = 300
    slow_window_s: int = 3600
    fast_burn: float | None = None
    slow_burn: float | None = None

    def __post_init__(self):
        if self.metric not in SLO_METRICS:
            raise ValueError(
                f"unknown SLO metric {self.metric!r} "
                f"(known: {SLO_METRICS})"
            )
        if not 0.0 < self.objective < 1.0:
            raise ValueError(
                f"objective must be in (0, 1), got {self.objective}"
            )
        if self.metric == "step_latency" and self.threshold_s is None:
            raise ValueError("step_latency SLOs need threshold_s")

    @property
    def budget(self) -> float:
        return 1.0 - self.objective

    def bad_total(self, counts: dict, hist: LogHistogram) -> tuple:
        if self.metric == "step_latency":
            resolved = hist.n
            return (hist.count_above(self.threshold_s), resolved)
        if self.metric == "deadline_miss":
            resolved = (counts.get("completed", 0)
                        + counts.get("steps", 0)
                        + counts.get("missed", 0))
            return (counts.get("missed", 0)
                    + counts.get("degraded", 0), resolved)
        if self.metric == "rejection":
            return (counts.get("rejected", 0),
                    counts.get("submitted", 0))
        # cache_hit: bad = completions NOT served from cache.
        done = counts.get("completed", 0)
        return (done - min(done, counts.get("cache_hit", 0)), done)


def parse_slo_spec(spec: str) -> SLOSpec:
    """Parse the console grammar
    ``NAME:METRIC:OBJECTIVE[:key=value...]`` — keys: ``threshold_s``,
    ``tenant``, ``fast_window_s``, ``slow_window_s``, ``fast_burn``,
    ``slow_burn``. Example: ``p99:step_latency:0.99:threshold_s=0.5``."""
    parts = spec.split(":")
    if len(parts) < 3:
        raise ValueError(
            f"bad SLO spec {spec!r} (grammar: NAME:METRIC:OBJECTIVE"
            "[:key=value...])"
        )
    kw: dict = {"name": parts[0], "metric": parts[1],
                "objective": float(parts[2])}
    casts = {"threshold_s": float, "tenant": str,
             "fast_window_s": int, "slow_window_s": int,
             "fast_burn": float, "slow_burn": float}
    for extra in parts[3:]:
        key, sep, value = extra.partition("=")
        if not sep or key not in casts:
            raise ValueError(
                f"bad SLO spec field {extra!r} in {spec!r} "
                f"(known keys: {sorted(casts)})"
            )
        kw[key] = casts[key](value)
    return SLOSpec(**kw)


# The console/examples defaults: conservative enough that a nominal
# storm (no deadline pressure) fires nothing.
DEFAULT_SLOS = (
    SLOSpec(name="step_p99", metric="step_latency", objective=0.99,
            threshold_s=30.0),
    SLOSpec(name="miss_rate", metric="deadline_miss", objective=0.99),
    SLOSpec(name="rejection", metric="rejection", objective=0.95),
)


class SLOEngine:
    """Compile :class:`SLOSpec` rows against a :class:`RollingWindows`
    and drive alert fire/resolve.

    ``evaluate(now)`` recomputes every (spec, tenant) burn rate over the
    spec's fast and slow windows and walks the alert state machine; each
    transition is journaled through ``metrics`` (an
    ``obs.export.MetricsWriter`` or None) as a schema-v9 ``alert`` event
    (kind ``fire``/``resolve``) and kept in ``self.alerts`` for
    in-process consumers. ``max_burn()`` is the fleet front's autoscale
    input: the worst fast-window burn across every evaluated pair. All
    timestamps are the journaled wall-``ts`` domain."""

    def __init__(self, specs=None, *, windows: RollingWindows | None = None,
                 metrics=None, burn_rates=None):
        self.specs = tuple(DEFAULT_SLOS if specs is None else specs)
        fast, slow = resolve_burn_rates(burn_rates)
        self._default_burns = (fast, slow)
        horizon = max(
            [3600] + [s.slow_window_s for s in self.specs]
        )
        # `is None`, not truthiness: a falsy-but-real windows /
        # metrics sink must still be used.
        self.windows = (RollingWindows(horizon_s=horizon)
                        if windows is None else windows)
        self.metrics = metrics
        self.firing: dict[tuple, dict] = {}   # (spec, tenant) -> record.
        self.alerts: list[dict] = []          # fire/resolve journal.
        self.last_burns: dict[tuple, float] = {}

    # ------------------------------------------------------- ingest --
    def ingest(self, replica: str, event: dict) -> None:
        self.windows.ingest(replica, event)

    def ingest_all(self, pairs) -> int:
        n = 0
        for replica, event in pairs:
            self.ingest(replica, event)
            n += 1
        return n

    # -------------------------------------------------------- burns --
    def _burn(self, spec: SLOSpec, tenant: str, window_s: int,
              now: float | None) -> float | None:
        counts, hist = self.windows.window(window_s, now=now,
                                           tenant=tenant)
        bad, total = spec.bad_total(counts, hist)
        if total <= 0:
            return None
        return (bad / total) / spec.budget

    def burn_rates(self, now: float | None = None) -> dict:
        """(spec name, tenant) -> {fast, slow} burn rates (None = no
        traffic in that window)."""
        out: dict = {}
        for spec in self.specs:
            tenants = ([spec.tenant] if spec.tenant is not None
                       else self.windows.tenants())
            for tenant in tenants:
                out[(spec.name, tenant)] = {
                    "fast": self._burn(spec, tenant, spec.fast_window_s,
                                       now),
                    "slow": self._burn(spec, tenant, spec.slow_window_s,
                                       now),
                }
        return out

    def max_burn(self) -> float | None:
        """Worst fast-window burn from the LAST evaluate() — the
        autoscale hint's budget-burn input (None before any traffic)."""
        if not self.last_burns:
            return None
        return max(self.last_burns.values())

    # ----------------------------------------------------- evaluate --
    def _severity(self, spec: SLOSpec, fast: float | None,
                  slow: float | None) -> str | None:
        fast_thr = (spec.fast_burn if spec.fast_burn is not None
                    else self._default_burns[0])
        slow_thr = (spec.slow_burn if spec.slow_burn is not None
                    else self._default_burns[1])
        if fast is None or slow is None:
            return None
        if fast >= fast_thr and slow >= fast_thr:
            return "fast"
        if fast >= slow_thr and slow >= slow_thr:
            return "slow"
        return None

    def evaluate(self, now: float | None = None) -> list[dict]:
        """One alerting pass at wall time ``now`` (default: the newest
        ingested ts). Returns the transitions (fired/resolved) this
        pass produced."""
        now = self.windows.latest_ts if now is None else now
        if now is None:
            return []
        specs = {s.name: s for s in self.specs}
        transitions: list[dict] = []
        self.last_burns = {}
        for (name, tenant), burns in self.burn_rates(now=now).items():
            spec = specs[name]
            fast, slow = burns["fast"], burns["slow"]
            if fast is not None:
                self.last_burns[(name, tenant)] = fast
            severity = self._severity(spec, fast, slow)
            key = (name, tenant)
            active = self.firing.get(key)
            if severity is not None and active is None:
                record = {
                    "kind": "fire", "slo": name, "tenant": tenant,
                    "severity": severity,
                    "burn_rate": round(fast, 4),
                    "window_s": spec.fast_window_s, "ts": now,
                }
                self.firing[key] = record
                self.alerts.append(record)
                transitions.append(record)
                if self.metrics is not None:
                    self.metrics.emit(
                        "alert", kind="fire", slo=name, tenant=tenant,
                        severity=severity, burn_rate=round(fast, 4),
                        window_s=spec.fast_window_s, ts=now,
                        objective=spec.objective, metric=spec.metric,
                    )
            elif severity is None and active is not None:
                del self.firing[key]
                record = {"kind": "resolve", "slo": name,
                          "tenant": tenant, "ts": now,
                          "fired_ts": active["ts"]}
                self.alerts.append(record)
                transitions.append(record)
                if self.metrics is not None:
                    self.metrics.emit(
                        "alert", kind="resolve", slo=name, tenant=tenant,
                        ts=now, fired_ts=active["ts"],
                    )
        return transitions

    # -------------------------------------------------------- state --
    def snapshot(self, now: float | None = None) -> dict:
        burns = self.burn_rates(now=now)
        return {
            "specs": [dataclasses.asdict(s) for s in self.specs],
            "burn_rates": {
                f"{name}/{tenant}": v
                for (name, tenant), v in sorted(burns.items())
            },
            "firing": sorted(
                f"{name}/{tenant}" for name, tenant in self.firing
            ),
            "alerts": list(self.alerts),
        }
