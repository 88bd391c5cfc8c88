"""Tier C (hostlint) of the port: static analysis of the host-side
concurrency, durability and observability contracts, rules HL001-HL010
over the port's host tier: ``serving/``, ``resilience/``, ``obs/``,
``parallel/pods.py`` and ``tools/`` of ``tpu_aerial_transport_torch``.

Tier A (torchlint) guards the hot path; this tier guards the concurrent
host Python around it. The rules, their numbers and their meaning are the
JAX package's hostlint's; each encodes one recurring bug class:

- HL001 clock-domain mixing: deadlines/timeouts are anchored on
  ``time.monotonic`` by contract (wall clocks step under NTP and die
  across restarts); ``time.time()`` may only stamp record fields.
- HL002 span leak: every ``Tracer.begin`` needs an ``end`` that
  survives BaseException (try/finally or an ``except BaseException``
  re-raise): the harvest/snapshot-span leak class.
- HL003 blocking call under lock: fsync'd emits, file opens, sleeps,
  subprocess waits, and thread joins inside a ``with <lock>`` body
  serialize every other thread behind one slow syscall.
- HL004 lock-order cycle: two methods of a class acquiring the same
  locks in opposite orders (computed as a fixpoint over self-calls).
- HL005 jsonl durability bypass: ``obs.export.jsonl_append`` is THE
  fsync'd append primitive; a raw ``open(...).write`` to a ``*.jsonl``
  path silently drops the durability contract readers rely on.
- HL006 non-atomic artifact publish: published files are written
  temp + fsync + ``os.replace`` — a rename without fsync can publish
  an empty file after a crash; a direct write tears mid-crash.
- HL007 event-vocabulary drift: emitted ``kind=`` literals must exist
  in ``obs/export.py``'s kind tables and carry that kind's minimum
  keys — schema drift becomes lint-visible, not review-visible.
- HL008 unregistered knob: ``TAT_*``/``TPU_AERIAL_*`` env reads must
  be registered in the port's ``analysis/knobs.py`` (name, owning
  resolver, documented default).
- HL009 subprocess hygiene: ``Popen`` without ``start_new_session``
  (group-kill) and an explicit ``stderr`` orphans children and wedges
  pipes — the pods_local/fleet_local discipline.
- HL010 truthiness gate on an observability/guard parameter: the
  zero-cost contract is ``is not None``; ``if tracer:`` or
  ``tracer is True`` lets a falsy-but-real (or truthy-but-wrong)
  sink slip through: the ``tracer=False`` pods-resume crash class.

HL003 also counts ``torch.cuda.synchronize`` (the port's counterpart of
``block_until_ready``) as blocking.

Stdlib-only: it imports neither torch nor jax (``tests/test_torch_lint.py``
checks that in a subprocess), and ``tools/lint.py`` loads it by file
path. Per-line ``# torchlint: disable=HLxxx`` pragmas and ``# torchlint:
skip-file`` work exactly as in Tier A. Intentional exceptions live in
:data:`HOST_WAIVERS` with a written reason; a waiver on a clean site
is itself an error (stale-waiver hygiene), as is a blank reason.
"""

from __future__ import annotations

import ast
import os

if __package__:
    from tpu_aerial_transport_torch.analysis import hostflow as _flow
    from tpu_aerial_transport_torch.analysis import knobs as _knobs
    from tpu_aerial_transport_torch.analysis import rules as _rules
else:  # loaded by file path (tools/lint.py): siblings on sys.path.
    import hostflow as _flow  # type: ignore
    import knobs as _knobs  # type: ignore
    import rules as _rules  # type: ignore

Finding = _rules.Finding

HOST_RULE_DOCS = {
    "HL000": (
        "hostlint-meta: syntax error, stale waiver (a HOST_WAIVERS "
        "entry whose site no longer trips its rule), or a waiver with "
        "no written reason."
    ),
    "HL001": (
        "clock-domain-mixing: time.time() flowing into deadline/timeout "
        "arithmetic or compared against a time.monotonic() anchor. "
        "Deadlines are monotonic by contract; wall time only stamps "
        "record fields (trace rows carry BOTH)."
    ),
    "HL002": (
        "span-leak: a Tracer.begin(...) whose span is not end()-ed on "
        "every path including BaseException — use try/finally or an "
        "except BaseException re-raise (end() is idempotent, so a "
        "defensive close is free)."
    ),
    "HL003": (
        "blocking-under-lock: file I/O, subprocess work, sleeps, "
        "thread joins, or an fsync'd metrics emit inside a `with "
        "<lock>` body. Collect under the lock, emit after release."
    ),
    "HL004": (
        "lock-order-cycle: methods of one class acquire the same locks "
        "in opposite orders (self-call acquisition graph fixpoint) — "
        "two threads can deadlock."
    ),
    "HL005": (
        "jsonl-durability-bypass: writing a *.jsonl path with raw "
        "open()/json.dump instead of obs.export.jsonl_append, the ONE "
        "fsync'd append primitive (readers tolerate a torn tail only "
        "because every durable line was fsync'd)."
    ),
    "HL006": (
        "non-atomic-publish: artifact writes must be temp + fsync + "
        "os.replace. A rename without fsync can publish empty bytes "
        "after a crash; a direct artifacts/ write tears mid-crash."
    ),
    "HL007": (
        "event-vocabulary-drift: an emitted kind=\"...\" literal absent "
        "from obs/export.py's SERVING_EVENT_KINDS/FLEET_EVENT_KINDS, "
        "an unknown event type, or a call missing that kind's minimum "
        "keys at the current SCHEMA_VERSION."
    ),
    "HL008": (
        "unregistered-knob: an os.environ read of a TAT_*/TPU_AERIAL_* "
        "name not registered in analysis/knobs.py (name, owning "
        "resolver, documented default)."
    ),
    "HL009": (
        "subprocess-hygiene: Popen without start_new_session=True "
        "(group-kill discipline) or without an explicit stderr "
        "destination (an undrained pipe wedges chatty children; "
        "inherited stderr loses the post-mortem tail)."
    ),
    "HL010": (
        "truthiness-gated-observability: `if tracer:` / `tracer or "
        "...` / `tracer is True` on a tracer/telemetry/metrics/guard/"
        "emit/sink parameter. The zero-cost contract is `is not None` "
        "— truthiness lets tracer=False crash the first traced span."
    ),
}

# Per-site waivers: "<relpath>::<rule>::<enclosing-function>" -> reason.
# A key whose site no longer trips its rule is flagged HL000 (stale);
# a blank reason is flagged HL000 (un-reasoned). Keep reasons WRITTEN —
# they are the review record for why the contract bends here.
HOST_WAIVERS: dict[str, str] = {
    "tpu_aerial_transport_torch/parallel/pods.py::HL010::"
    "pods_rollout_resumable": (
        "tracer is a tri-state convenience flag by design here: True "
        "wires a per-process tracer into the shared run dir, a Tracer "
        "instance passes through, and any falsy value is normalized to "
        "None at this boundary, so the chunk driver's `is not None` "
        "zero-cost gate stays sound downstream. The `is True` / `not "
        "tracer` tests are the normalization."
    ),
    "tpu_aerial_transport_torch/tools/fleet_local.py::HL005::run_fleet": (
        "fleet.metrics.jsonl is a derived merge written once at shutdown "
        "from the front's and the replicas' metrics files, each already "
        "fsync'd line by line through jsonl_append. Re-fsyncing the merge "
        "a line buys nothing (it is rebuilt from its durable inputs) and "
        "would add an fsync an event of the whole fleet to the drain."
    ),
}

# The host-tier scan set (relative to the repo root). Directories are
# globbed recursively, so a NEW module under serving/resilience/obs is
# covered automatically; tests/test_torch_lint.py fails if this tuple
# stops spanning those trees.
HOST_SCAN = (
    "tpu_aerial_transport_torch/serving",
    "tpu_aerial_transport_torch/resilience",
    "tpu_aerial_transport_torch/obs",
    "tpu_aerial_transport_torch/parallel/pods.py",
    "tpu_aerial_transport_torch/tools",
)

# File that owns the jsonl durability primitive (exempt from HL005) and
# the event vocabulary HL007 reads.
_EXPORT_RELPATH = "tpu_aerial_transport_torch/obs/export.py"


def relpath_of(path: str) -> str:
    """Stable repo-relative posix path: slice at the last
    tpu_aerial_transport_torch/tools/tests component so waiver keys do
    not depend on the invocation cwd."""
    p = os.path.abspath(path).replace(os.sep, "/")
    for anchor in ("/tpu_aerial_transport_torch/", "/tools/", "/tests/"):
        idx = p.rfind(anchor)
        if idx >= 0:
            return p[idx + 1:]
    return os.path.basename(p)


def host_paths(repo_root: str) -> list[str]:
    """The default --host scan set (existing entries only)."""
    out = []
    for rel in HOST_SCAN:
        p = os.path.join(repo_root, rel)
        if os.path.exists(p):
            out.append(p)
    return out


class HostContext:
    """Parsed module + the bookkeeping every HL rule shares."""

    def __init__(self, path: str, source: str):
        self.path = path
        self.relpath = relpath_of(path)
        self.source = source
        self.lines = source.splitlines()
        self.tree = ast.parse(source, filename=path)
        self.skip_file = any(
            _rules._SKIP_FILE_RE.search(ln) for ln in self.lines[:10]
        )
        self.suppressed: dict[int, frozenset[str]] = {}
        for i, ln in enumerate(self.lines, start=1):
            m = _rules._PRAGMA_RE.search(ln)
            if m:
                self.suppressed[i] = frozenset(
                    s.strip() for s in m.group(1).split(",") if s.strip()
                )
        self.parents = _flow.attach_parents(self.tree)
        self.consts = _flow.module_str_consts(self.tree)
        self.waiver_hits: set[str] = set()

    def enclosing_name(self, node: ast.AST) -> str:
        cur = self.parents.get(node)
        while cur is not None:
            if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef,
                                ast.ClassDef)):
                return cur.name
            cur = self.parents.get(cur)
        return "<module>"

    def _function_name(self, node: ast.AST) -> str:
        cur = node if isinstance(
            node, (ast.FunctionDef, ast.AsyncFunctionDef)
        ) else self.parents.get(node)
        while cur is not None:
            if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef)):
                return cur.name
            cur = self.parents.get(cur)
        return "<module>"

    def is_suppressed(self, rule: str, line: int) -> bool:
        ids = self.suppressed.get(line)
        return ids is not None and (rule in ids or "all" in ids)

    def finding(self, rule: str, node: ast.AST, message: str,
                severity: str = "error") -> Finding | None:
        line = getattr(node, "lineno", 0)
        if self.is_suppressed(rule, line):
            return None
        key = f"{self.relpath}::{rule}::{self._function_name(node)}"
        if key in HOST_WAIVERS:
            self.waiver_hits.add(key)
            return None
        return Finding(
            rule=rule, path=self.path, line=line,
            col=getattr(node, "col_offset", 0), message=message,
            context=self.enclosing_name(node), severity=severity,
        )


def _scopes(ctx: HostContext):
    """Every function plus the module body (as one pseudo-scope)."""
    yield ctx.tree
    yield from _flow.functions(ctx.tree)


def _own_nodes(scope: ast.AST):
    """Walk a scope WITHOUT descending into nested function scopes
    (module scope would otherwise re-report every function's nodes)."""
    stack = list(ast.iter_child_nodes(scope))
    while stack:
        node = stack.pop()
        yield node
        if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            stack.extend(ast.iter_child_nodes(node))


# ---------------------------------------------------------- HL001 -----


def rule_hl001_clock_mixing(ctx: HostContext):
    out = []
    for scope in _scopes(ctx):
        domains = _flow.clock_domains(scope)
        for node in _own_nodes(scope):
            if isinstance(node, ast.Compare):
                doms = {
                    d for d in (
                        _flow.expr_domain(e, domains)
                        for e in [node.left] + node.comparators
                    ) if d
                }
                if "mixed" in doms or {"wall", "mono"} <= doms:
                    f = ctx.finding(
                        "HL001", node,
                        "wall-clock value compared against a monotonic "
                        "anchor — deadlines/timeouts are monotonic by "
                        "contract (NTP steps and restarts break wall "
                        "comparisons)",
                    )
                    if f:
                        out.append(f)
            elif isinstance(node, ast.BinOp):
                left = _flow.expr_domain(node.left, domains)
                right = _flow.expr_domain(node.right, domains)
                if left and right and left != right:
                    f = ctx.finding(
                        "HL001", node,
                        "arithmetic mixes the wall clock with the "
                        "monotonic domain — anchor deadline math on "
                        "time.monotonic(); wall time only stamps "
                        "record fields",
                    )
                    if f:
                        out.append(f)
            elif (isinstance(node, ast.Assign) and len(node.targets) == 1):
                tname = _flow.terminal(node.targets[0])
                if (tname is not None
                        and _flow._DEADLINE_NAME_RE.search(tname)
                        and _flow.expr_domain(node.value, domains)
                        == "wall"):
                    f = ctx.finding(
                        "HL001", node,
                        f"deadline/timeout '{tname}' anchored on the "
                        "wall clock (time.time()) — use the monotonic "
                        "clock so restarts/NTP cannot fire or starve it",
                    )
                    if f:
                        out.append(f)
    return out


# ---------------------------------------------------------- HL002 -----


def rule_hl002_span_leak(ctx: HostContext):
    out = []
    for func in _flow.functions(ctx.tree):
        for assign, var in _flow.span_begins(func):
            if _flow.var_escapes(func, var, assign):
                continue  # handed off — lifecycle owned elsewhere.
            if _flow.span_protected(func, var, ctx.parents):
                continue
            f = ctx.finding(
                "HL002", assign,
                f"span '{var}' from .begin(...) is not end()-ed on "
                "every path including BaseException — wrap in "
                "try/finally or add an `except BaseException` that "
                "ends it and re-raises (end() is idempotent)",
            )
            if f:
                out.append(f)
    return out


# ---------------------------------------------------------- HL003 -----

_BLOCKING_NAME_CALLS = frozenset({"open", "sleep"})
_BLOCKING_TERMINALS = frozenset({
    "sleep", "fsync", "jsonl_append", "communicate", "Popen", "run",
    "check_call", "check_output", "block_until_ready", "device_put",
    "synchronize",
    "emit", "emit_fleet", "_emit", "_emit_serving",
})


def _is_blocking_call(node: ast.Call) -> str | None:
    if isinstance(node.func, ast.Name):
        if node.func.id in _BLOCKING_NAME_CALLS:
            return node.func.id
        return None
    term = _flow.terminal(node.func)
    d = _flow.dotted(node.func)
    if term in _BLOCKING_TERMINALS:
        # `run`/`check_*`/`Popen` only as subprocess attributes; the
        # emit family and sync primitives match on any receiver.
        if term in ("run", "check_call", "check_output", "Popen"):
            return d if d.startswith("subprocess.") else None
        return d
    if term == "join":
        # Thread/process join, not str.join: a constant-string receiver
        # is the separator idiom and never blocks.
        if not (isinstance(node.func, ast.Attribute)
                and isinstance(node.func.value, ast.Constant)):
            return d
    return None


def rule_hl003_blocking_under_lock(ctx: HostContext):
    out = []
    for with_node, label in _flow.iter_lock_withs(ctx.tree):
        for stmt in with_node.body:
            for node in ast.walk(stmt):
                if not isinstance(node, ast.Call):
                    continue
                what = _is_blocking_call(node)
                if what is None:
                    continue
                f = ctx.finding(
                    "HL003", node,
                    f"blocking call {what}(...) while holding {label} "
                    "— every other thread serializes behind this "
                    "syscall; collect under the lock, emit/flush after "
                    "release",
                )
                if f:
                    out.append(f)
    return out


# ---------------------------------------------------------- HL004 -----


def rule_hl004_lock_order(ctx: HostContext):
    out = []
    for node in ast.walk(ctx.tree):
        if not isinstance(node, ast.ClassDef):
            continue
        cycle = _flow.find_lock_cycle(_flow.class_lock_graph(node))
        if cycle is None:
            continue
        f = ctx.finding(
            "HL004", node,
            f"lock-order cycle across methods of {node.name}: "
            + " -> ".join(cycle)
            + " — two threads taking these paths concurrently can "
            "deadlock; impose one global acquisition order",
        )
        if f:
            out.append(f)
    return out


# ---------------------------------------------------------- HL005 -----


def _open_mode(node: ast.Call) -> str:
    if len(node.args) >= 2:
        m = node.args[1]
        if isinstance(m, ast.Constant) and isinstance(m.value, str):
            return m.value
    for kw in node.keywords:
        if kw.arg == "mode" and isinstance(kw.value, ast.Constant) \
                and isinstance(kw.value.value, str):
            return kw.value.value
    return "r"


def _mentions_literal(node: ast.AST, needle: str,
                      consts: dict[str, str]) -> bool:
    for s in _flow.literal_strings(node):
        if needle in s:
            return True
    for sub in ast.walk(node):
        if isinstance(sub, ast.Name) and needle in consts.get(sub.id, ""):
            return True
    return False


def _scope_str_consts(ctx: HostContext, scope: ast.AST) -> dict[str, str]:
    """Module-level string constants plus this scope's own simple
    ``name = <expr>`` bindings, each mapped to the concatenation of the
    string literals its value mentions — enough to see through the
    ``path = os.path.join(d, "x.jsonl")`` idiom."""
    consts = dict(ctx.consts)
    for node in ast.walk(scope):
        if not (isinstance(node, ast.Assign) and len(node.targets) == 1
                and isinstance(node.targets[0], ast.Name)):
            continue
        lits = " ".join(_flow.literal_strings(node.value))
        if lits:
            consts[node.targets[0].id] = (
                consts.get(node.targets[0].id, "") + " " + lits
            )
    return consts


def rule_hl005_jsonl_bypass(ctx: HostContext):
    if ctx.relpath == _EXPORT_RELPATH:
        return []  # the primitive itself.
    out = []
    for scope in _scopes(ctx):
        consts = _scope_str_consts(ctx, scope)
        for node in _own_nodes(scope):
            if not (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Name)
                    and node.func.id == "open" and node.args):
                continue
            mode = _open_mode(node)
            if not any(c in mode for c in "wa+"):
                continue
            if not _mentions_literal(node.args[0], ".jsonl", consts):
                continue
            f = ctx.finding(
                "HL005", node,
                "raw write-mode open() of a *.jsonl path — route the "
                "append through obs.export.jsonl_append (THE fsync'd "
                "primitive); a non-fsync'd line can vanish after the "
                "reader already acted on it",
            )
            if f:
                out.append(f)
    return out


# ---------------------------------------------------------- HL006 -----


def rule_hl006_nonatomic_publish(ctx: HostContext):
    out = []
    for func in _flow.functions(ctx.tree):
        replaces = [
            n for n in ast.walk(func)
            if isinstance(n, ast.Call)
            and _flow.dotted(n.func) == "os.replace"
        ]
        opens_w = [
            n for n in ast.walk(func)
            if isinstance(n, ast.Call) and isinstance(n.func, ast.Name)
            and n.func.id == "open" and n.args
            and any(c in _open_mode(n) for c in "wa+")
        ]
        has_fsync = any(
            isinstance(n, ast.Call)
            and _flow.terminal(n.func) == "fsync"
            for n in ast.walk(func)
        )
        if replaces and opens_w and not has_fsync:
            f = ctx.finding(
                "HL006", replaces[0],
                "os.replace publish without fsync of the temp file — "
                "after a crash the rename can land on disk before the "
                "data, publishing an empty/torn artifact; fsync before "
                "replacing",
            )
            if f:
                out.append(f)
        if not replaces:
            consts = _scope_str_consts(ctx, func)
            for n in opens_w:
                if _mentions_literal(n.args[0], "artifacts", consts):
                    f = ctx.finding(
                        "HL006", n,
                        "direct write into an artifacts/ path — publish "
                        "via temp file + fsync + os.replace so readers "
                        "never observe a torn file",
                    )
                    if f:
                        out.append(f)
    return out


# ---------------------------------------------------------- HL007 -----

_vocab_cache: dict[str, dict | None] = {}


def load_event_vocab(start_path: str) -> dict | None:
    """Kind tables parsed out of the port's obs/export.py AST (hostlint never
    imports the package — export pulls in numpy). Returns
    ``{"serving": {...}, "fleet": {...}, "session": {...},
    "events": {...}}`` or None when no export.py is reachable above
    ``start_path``."""
    d = os.path.dirname(os.path.abspath(start_path))
    root = d
    while True:
        if os.path.exists(os.path.join(root, _EXPORT_RELPATH)):
            break
        parent = os.path.dirname(root)
        if parent == root:
            return _vocab_cache.setdefault(d, None)
        root = parent
    export_path = os.path.join(root, _EXPORT_RELPATH)
    if export_path in _vocab_cache:
        return _vocab_cache[export_path]
    with open(export_path, encoding="utf-8") as fh:
        tree = ast.parse(fh.read(), filename=export_path)
    vocab = {
        "serving": _flow.module_dict_literal(tree, "SERVING_EVENT_KINDS"),
        "fleet": _flow.module_dict_literal(tree, "FLEET_EVENT_KINDS"),
        # Session (v8) and alert (v9) tables are newer vocabulary —
        # tolerated missing (None) so the linter still runs against
        # older export files.
        "session": _flow.module_dict_literal(tree, "SESSION_EVENT_KINDS"),
        "alert": _flow.module_dict_literal(tree, "ALERT_EVENT_KINDS"),
        "events": _flow.module_dict_literal(tree, "EVENT_FIELDS"),
    }
    if vocab["serving"] is None or vocab["fleet"] is None:
        vocab = None
    _vocab_cache[export_path] = vocab
    _vocab_cache[d] = vocab
    return vocab


_EMIT_TERMINALS = frozenset({"emit", "_emit", "emit_fleet",
                             "_emit_serving", "_emit_session"})


def rule_hl007_event_vocab(ctx: HostContext):
    if ctx.relpath == _EXPORT_RELPATH:
        return []  # the vocabulary's own definition site.
    vocab = load_event_vocab(ctx.path)
    if vocab is None:
        return []
    serving, fleet = vocab["serving"], vocab["fleet"]
    session = vocab.get("session") or {}
    alert = vocab.get("alert") or {}
    events = vocab["events"] or {}
    known = {**serving, **fleet, **session, **alert}
    out = []
    for node in ast.walk(ctx.tree):
        if not isinstance(node, ast.Call):
            continue
        term = _flow.terminal(node.func)
        recv = (_flow.dotted(node.func.value).lower()
                if isinstance(node.func, ast.Attribute) else "")
        # Unknown event TYPE on a metrics-writer emit.
        if (term == "emit" and node.args
                and ("metrics" in recv or "writer" in recv)
                and isinstance(node.args[0], ast.Constant)
                and isinstance(node.args[0].value, str)
                and events and node.args[0].value not in events):
            f = ctx.finding(
                "HL007", node,
                f"unknown metrics event type "
                f"{node.args[0].value!r} — not in obs.export."
                "EVENT_FIELDS (the writer raises at runtime; extend "
                "the vocabulary and bump SCHEMA_VERSION if readers "
                "must distinguish it)",
            )
            if f:
                out.append(f)
            continue
        if term not in _EMIT_TERMINALS:
            continue
        event_type = None
        if (node.args and isinstance(node.args[0], ast.Constant)
                and isinstance(node.args[0].value, str)):
            event_type = node.args[0].value
        kws = {kw.arg: kw.value for kw in node.keywords}
        if None in kws:  # **kwargs — contents invisible to the AST.
            continue
        kind_node = kws.get("kind")
        if not (isinstance(kind_node, ast.Constant)
                and isinstance(kind_node.value, str)):
            continue
        kind = kind_node.value
        table = {"serving_event": serving, "fleet_event": fleet,
                 "session_event": session,
                 "alert": alert}.get(event_type, known)
        if not table:
            continue  # newer vocabulary absent from this export file.
        if kind not in table:
            f = ctx.finding(
                "HL007", node,
                f"event kind {kind!r} is not in obs/export.py's kind "
                f"vocabulary ({', '.join(sorted(table))}) — add it "
                "there (and bump SCHEMA_VERSION if readers must "
                "distinguish it) before emitting",
            )
            if f:
                out.append(f)
            continue
        missing = [k for k in table[kind] if k not in kws]
        if missing:
            f = ctx.finding(
                "HL007", node,
                f"event kind {kind!r} missing its minimum keys "
                f"{missing} — the per-kind reader contract "
                "(obs/export.py validate_event) requires them",
            )
            if f:
                out.append(f)
    return out


# ---------------------------------------------------------- HL008 -----

_KNOB_PREFIXES = ("TAT_", "TPU_AERIAL_")


def rule_hl008_unregistered_knob(ctx: HostContext):
    out = []
    for node, key in _flow.iter_env_reads(ctx.tree, ctx.consts):
        if not key.startswith(_KNOB_PREFIXES):
            continue
        if key in _knobs.KNOBS:
            continue
        f = ctx.finding(
            "HL008", node,
            f"env knob {key!r} read here is not registered in "
            "the port's analysis/knobs.py — register it (name, owning "
            "resolver, documented default) so the knob surface stays "
            "auditable",
        )
        if f:
            out.append(f)
    return out


# ---------------------------------------------------------- HL009 -----


def rule_hl009_subprocess_hygiene(ctx: HostContext):
    out = []
    for node in ast.walk(ctx.tree):
        if not (isinstance(node, ast.Call)
                and _flow.terminal(node.func) == "Popen"):
            continue
        kws = {kw.arg: kw.value for kw in node.keywords}
        if None in kws:
            continue  # **kwargs — invisible.
        problems = []
        sns = kws.get("start_new_session")
        if not (isinstance(sns, ast.Constant) and sns.value is True):
            problems.append("start_new_session=True (group-kill "
                            "discipline: one killpg reaps the tree)")
        if "stderr" not in kws:
            problems.append("an explicit stderr destination (a chatty "
                            "child wedges on a full inherited pipe; a "
                            "file keeps the post-mortem tail)")
        if problems:
            f = ctx.finding(
                "HL009", node,
                "Popen without " + " and ".join(problems),
            )
            if f:
                out.append(f)
    return out


# ---------------------------------------------------------- HL010 -----

_WATCHED_PARAMS = frozenset({
    "tracer", "telemetry", "metrics", "guard", "emit", "sink",
})


def _watched_params(func: ast.AST) -> set[str]:
    a = func.args
    names = {p.arg for p in a.args + a.kwonlyargs + a.posonlyargs}
    return names & _WATCHED_PARAMS


def rule_hl010_truthiness_gate(ctx: HostContext):
    out = []

    def hit(node, name, form):
        f = ctx.finding(
            "HL010", node,
            f"truthiness gate `{form}` on observability/guard "
            f"parameter '{name}' — the zero-cost contract is `is "
            "not None`; a falsy-but-real sink (or tracer=False) "
            "slips through truthiness and crashes downstream",
        )
        if f:
            out.append(f)

    for func in _flow.functions(ctx.tree):
        watched = _watched_params(func)
        if not watched:
            continue
        for node in _own_nodes(func):
            if isinstance(node, (ast.If, ast.While, ast.IfExp)):
                t = node.test
                if isinstance(t, ast.Name) and t.id in watched:
                    hit(t, t.id, f"if {t.id}:")
                elif (isinstance(t, ast.UnaryOp)
                        and isinstance(t.op, ast.Not)
                        and isinstance(t.operand, ast.Name)
                        and t.operand.id in watched):
                    hit(t, t.operand.id, f"if not {t.operand.id}:")
            elif isinstance(node, ast.BoolOp):
                for v in node.values:
                    if isinstance(v, ast.Name) and v.id in watched:
                        op = "or" if isinstance(node.op, ast.Or) else "and"
                        hit(v, v.id, f"{v.id} {op} ...")
            elif isinstance(node, ast.Compare):
                if (isinstance(node.left, ast.Name)
                        and node.left.id in watched
                        and len(node.ops) == 1
                        and isinstance(node.ops[0], (ast.Is, ast.Eq))
                        and isinstance(node.comparators[0], ast.Constant)
                        and isinstance(node.comparators[0].value, bool)):
                    hit(node, node.left.id,
                        f"{node.left.id} is "
                        f"{node.comparators[0].value}")
    return out


# ------------------------------------------------------------ driver --

HOST_RULES = {
    "HL001": rule_hl001_clock_mixing,
    "HL002": rule_hl002_span_leak,
    "HL003": rule_hl003_blocking_under_lock,
    "HL004": rule_hl004_lock_order,
    "HL005": rule_hl005_jsonl_bypass,
    "HL006": rule_hl006_nonatomic_publish,
    "HL007": rule_hl007_event_vocab,
    "HL008": rule_hl008_unregistered_knob,
    "HL009": rule_hl009_subprocess_hygiene,
    "HL010": rule_hl010_truthiness_gate,
}


def run_host_rules(ctx: HostContext,
                   disabled: frozenset[str] = frozenset()
                   ) -> list[Finding]:
    if ctx.skip_file:
        return []
    out: list[Finding] = []
    for rule_id, impl in HOST_RULES.items():
        if rule_id in disabled:
            continue
        out.extend(impl(ctx))
    out.sort(key=lambda f: (f.path, f.line, f.rule))
    return out


def lint_host_file(path: str,
                   disabled: frozenset[str] = frozenset()
                   ) -> tuple[list[Finding], set[str], str]:
    """(findings, waiver keys that matched, relpath) for one file."""
    with open(path, encoding="utf-8") as fh:
        source = fh.read()
    try:
        ctx = HostContext(path, source)
    except SyntaxError as e:
        return ([Finding(
            rule="HL000", path=path, line=e.lineno or 0,
            col=e.offset or 0, message=f"syntax error: {e.msg}",
        )], set(), relpath_of(path))
    return run_host_rules(ctx, disabled), ctx.waiver_hits, ctx.relpath


def waiver_hygiene(scanned_relpaths: set[str],
                   used_keys: set[str]) -> list[Finding]:
    """HL000 findings for stale waivers (site scanned, rule no longer
    trips) and waivers with no written reason."""
    out = []
    for key, reason in sorted(HOST_WAIVERS.items()):
        path = key.split("::", 1)[0]
        if not reason.strip():
            out.append(Finding(
                rule="HL000", path=path, line=0, col=0,
                message=f"waiver {key!r} has no written reason — every "
                "HOST_WAIVERS entry must say WHY the contract bends",
            ))
        if path in scanned_relpaths and key not in used_keys:
            out.append(Finding(
                rule="HL000", path=path, line=0, col=0,
                message=f"stale waiver {key!r}: the site no longer "
                "trips its rule — delete the entry (waivers must not "
                "outlive their reason)",
            ))
    return out


def lint_host_files(files: list[str],
                    disabled: frozenset[str] = frozenset()
                    ) -> list[Finding]:
    """Lint concrete files with the HL rules + waiver hygiene."""
    findings: list[Finding] = []
    used: set[str] = set()
    scanned: set[str] = set()
    for f in files:
        file_findings, hits, rel = lint_host_file(f, disabled)
        findings.extend(file_findings)
        used |= hits
        scanned.add(rel)
    findings.extend(waiver_hygiene(scanned, used))
    findings.sort(key=lambda f: (f.path, f.line, f.rule))
    return findings
