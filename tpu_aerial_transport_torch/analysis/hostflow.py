"""Host-side dataflow helpers for Tier C (hostlint) of the port.

Everything here is pure-AST bookkeeping shared by the HL rules in
``hostrules.py``: parent links, module string-constant resolution,
clock-domain tagging (wall vs monotonic), lock-region iteration, the
per-class lock-acquisition graph (HL004's fixpoint), span begin/end
path analysis (HL002), and ``os.environ`` read detection (HL008).

Stdlib-only: it imports neither torch nor jax, so the lint CLI
(``tools/lint.py``) loads it by file path on a host with no stack at all
(``tests/test_torch_lint.py`` checks that in a subprocess).
"""

from __future__ import annotations

import ast
import re

# --------------------------------------------------------------- AST --


def attach_parents(tree: ast.AST) -> dict[ast.AST, ast.AST]:
    parents: dict[ast.AST, ast.AST] = {}
    for node in ast.walk(tree):
        for child in ast.iter_child_nodes(node):
            parents[child] = node
    return parents


def enclosing_function(node: ast.AST, parents: dict) -> ast.AST | None:
    cur = parents.get(node)
    while cur is not None:
        if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef)):
            return cur
        cur = parents.get(cur)
    return None


def functions(tree: ast.AST):
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            yield node


def dotted(node: ast.expr) -> str:
    """``self.tracer.begin`` -> "self.tracer.begin"; best effort."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
    return ".".join(reversed(parts))


def terminal(node: ast.expr) -> str | None:
    if isinstance(node, ast.Attribute):
        return node.attr
    if isinstance(node, ast.Name):
        return node.id
    return None


def module_str_consts(tree: ast.Module) -> dict[str, str]:
    """Module/class-level ``NAME = "literal"`` bindings — the idiom env
    knob names use (``FAULTS_ENV = "TAT_BACKEND_FAULTS"``)."""
    out: dict[str, str] = {}
    scopes = [tree.body] + [
        n.body for n in ast.walk(tree) if isinstance(n, ast.ClassDef)
    ]
    for body in scopes:
        for stmt in body:
            targets: list[ast.expr] = []
            value = None
            if isinstance(stmt, ast.Assign):
                targets, value = stmt.targets, stmt.value
            elif isinstance(stmt, ast.AnnAssign) and stmt.value is not None:
                targets, value = [stmt.target], stmt.value
            if not (isinstance(value, ast.Constant)
                    and isinstance(value.value, str)):
                continue
            for t in targets:
                if isinstance(t, ast.Name):
                    out[t.id] = value.value
    return out


def literal_strings(node: ast.AST):
    """Every string constant anywhere inside an expression tree."""
    for sub in ast.walk(node):
        if isinstance(sub, ast.Constant) and isinstance(sub.value, str):
            yield sub.value


def module_dict_literal(tree: ast.Module, name: str) -> dict | None:
    """``NAME = {...literal...}`` evaluated via ``ast.literal_eval``:
    how hostlint reads the event-kind vocabulary out of
    ``obs/export.py`` without importing it (export pulls in numpy)."""
    for stmt in tree.body:
        target = None
        if isinstance(stmt, ast.Assign) and len(stmt.targets) == 1:
            target, value = stmt.targets[0], stmt.value
        elif isinstance(stmt, ast.AnnAssign):
            target, value = stmt.target, stmt.value
        else:
            continue
        if not (isinstance(target, ast.Name) and target.id == name):
            continue
        try:
            return ast.literal_eval(value)
        except (ValueError, SyntaxError):
            return None
    return None


# ------------------------------------------------------ clock domains --

_WALL_CALLS = frozenset({"time.time", "time.time_ns"})
_MONO_CALLS = frozenset({
    "time.monotonic", "time.monotonic_ns",
    "time.perf_counter", "time.perf_counter_ns",
})
# Names that live in the monotonic domain BY CONTRACT: every deadline /
# timeout in the host tier is anchored on the queue/guard clock
# (time.monotonic) so restarts and NTP steps cannot fire or starve it.
_DEADLINE_NAME_RE = re.compile(r"deadline|timeout", re.IGNORECASE)


def call_domain(node: ast.AST) -> str | None:
    if isinstance(node, ast.Call):
        d = dotted(node.func)
        if d in _WALL_CALLS:
            return "wall"
        if d in _MONO_CALLS:
            return "mono"
    return None


def clock_domains(func: ast.AST) -> dict[str, str]:
    """``{var: "wall"|"mono"}`` for simple ``v = time.<clock>()`` (and
    ``v = <tagged> ± x``) assignments inside one function."""
    domains: dict[str, str] = {}
    for _ in range(2):  # one re-pass picks up derived anchors.
        for node in ast.walk(func):
            if not (isinstance(node, ast.Assign) and len(node.targets) == 1
                    and isinstance(node.targets[0], ast.Name)):
                continue
            dom = expr_domain(node.value, domains)
            if dom is not None:
                domains[node.targets[0].id] = dom
    return domains


def expr_domain(node: ast.AST, domains: dict[str, str]) -> str | None:
    """The clock domain of an expression: a tagged call, a tagged
    variable, a deadline/timeout-named value (monotonic by contract),
    or arithmetic over one domain."""
    d = call_domain(node)
    if d is not None:
        return d
    if isinstance(node, ast.Name):
        if node.id in domains:
            return domains[node.id]
        if _DEADLINE_NAME_RE.search(node.id):
            return "mono"
        return None
    if isinstance(node, ast.Attribute):
        if _DEADLINE_NAME_RE.search(node.attr):
            return "mono"
        return None
    if isinstance(node, ast.BinOp):
        left = expr_domain(node.left, domains)
        right = expr_domain(node.right, domains)
        if left and right and left != right:
            return "mixed"
        return left or right
    return None


# ------------------------------------------------------- lock regions --

_LOCK_NAME_RE = re.compile(r"lock|mutex|(^|_)mu$|(^|_)cv$|cond",
                           re.IGNORECASE)


def lock_label(expr: ast.expr) -> str | None:
    """A with-item context expression's lock identity, or None when the
    expression does not look like a lock. ``with self._lock:`` ->
    "self._lock"; ``with lock_for(k):`` -> "lock_for(...)"."""
    target = expr.func if isinstance(expr, ast.Call) else expr
    name = terminal(target)
    if name is not None and _LOCK_NAME_RE.search(name):
        d = dotted(target)
        return d + "(...)" if isinstance(expr, ast.Call) else d
    return None


def iter_lock_withs(tree: ast.AST):
    """Yield ``(with_node, label)`` for every lock-acquiring with."""
    for node in ast.walk(tree):
        if isinstance(node, (ast.With, ast.AsyncWith)):
            for item in node.items:
                label = lock_label(item.context_expr)
                if label is not None:
                    yield node, label


# -------------------------------------------- lock-order (HL004) -------


def _method_index(cls: ast.ClassDef) -> dict[str, ast.AST]:
    return {
        n.name: n for n in cls.body
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))
    }


def _self_calls(func: ast.AST) -> set[str]:
    out = set()
    for node in ast.walk(func):
        if (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and isinstance(node.func.value, ast.Name)
                and node.func.value.id == "self"):
            out.add(node.func.attr)
    return out


def class_lock_graph(cls: ast.ClassDef) -> dict[str, set[str]]:
    """Edges ``held -> acquired-while-held`` over a class's methods,
    with self-method calls propagated to a fixpoint: if ``a()`` holds
    L1 while calling ``self.b()`` and ``b`` (transitively) acquires L2,
    the graph gains L1 -> L2. A cycle means two call paths can take the
    same locks in opposite orders — the classic supervisor/front
    deadlock shape."""
    methods = _method_index(cls)
    # locks each method may acquire, directly or via self calls.
    acquires: dict[str, set[str]] = {
        name: {label for _, label in iter_lock_withs(m)}
        for name, m in methods.items()
    }
    changed = True
    while changed:
        changed = False
        for name, m in methods.items():
            for callee in _self_calls(m):
                extra = acquires.get(callee, set()) - acquires[name]
                if extra:
                    acquires[name] |= extra
                    changed = True

    edges: dict[str, set[str]] = {}
    for name, m in methods.items():
        for with_node, label in iter_lock_withs(m):
            inner: set[str] = set()
            for stmt in with_node.body:
                for _, nested in iter_lock_withs(stmt):
                    inner.add(nested)
                for node in ast.walk(stmt):
                    if (isinstance(node, ast.Call)
                            and isinstance(node.func, ast.Attribute)
                            and isinstance(node.func.value, ast.Name)
                            and node.func.value.id == "self"):
                        inner |= acquires.get(node.func.attr, set())
            inner.discard(label)
            if inner:
                edges.setdefault(label, set()).update(inner)
    return edges


def find_lock_cycle(edges: dict[str, set[str]]) -> list[str] | None:
    """One acquisition-order cycle (as a lock-name path), or None."""
    WHITE, GREY, BLACK = 0, 1, 2
    color = {n: WHITE for n in edges}
    path: list[str] = []

    def visit(n: str) -> list[str] | None:
        color[n] = GREY
        path.append(n)
        for m in sorted(edges.get(n, ())):
            if color.get(m, WHITE) == GREY:
                return path[path.index(m):] + [m]
            if color.get(m, WHITE) == WHITE and m in edges:
                found = visit(m)
                if found:
                    return found
        path.pop()
        color[n] = BLACK
        return None

    for n in sorted(edges):
        if color[n] == WHITE:
            found = visit(n)
            if found:
                return found
    return None


# ------------------------------------------------- span paths (HL002) --

_TRACERISH_RE = re.compile(r"trace", re.IGNORECASE)


def span_begins(func: ast.AST):
    """Yield ``(assign_node, var)`` for ``v = <tracer-ish>.begin(...)``
    where the target is a plain local name. Attribute/subscript targets
    (``self._spans[rid] = ...``) are cross-method handoffs whose
    lifecycle HL002 cannot see — they are skipped, like escapes."""
    for node in ast.walk(func):
        if not (isinstance(node, ast.Assign) and len(node.targets) == 1
                and isinstance(node.targets[0], ast.Name)):
            continue
        call = node.value
        if not (isinstance(call, ast.Call)
                and isinstance(call.func, ast.Attribute)
                and call.func.attr == "begin"
                and _TRACERISH_RE.search(dotted(call.func.value))):
            continue
        yield node, node.targets[0].id


def _reads_var(node: ast.AST, var: str) -> bool:
    return any(isinstance(s, ast.Name) and s.id == var
               for s in ast.walk(node))


def var_escapes(func: ast.AST, var: str, begin_assign: ast.AST) -> bool:
    """Does ``var`` leave this function's span lifecycle — stored on an
    attribute/subscript, returned/yielded, aliased, or passed to a call
    that is not ``.end(...)``? Escaped spans are someone else's contract."""
    for node in ast.walk(func):
        if node is begin_assign:
            continue
        if (isinstance(node, ast.Assign)
                and not isinstance(node.value, ast.Call)
                and _reads_var(node.value, var)):
            return True  # alias or handoff store (call values are
            # judged by the Call branch below — a child begin reading
            # the span as parent= is a reference, not a handoff).
        if isinstance(node, (ast.Return, ast.Yield, ast.YieldFrom)):
            if (node.value is not None
                    and not isinstance(node.value, ast.Call)
                    and _reads_var(node.value, var)):
                return True
        if isinstance(node, ast.Call):
            t = terminal(node.func)
            if t in ("end", "instant", "begin"):
                continue
            # parent/trace_parent keywords link a child's span to this
            # one without transferring its lifecycle.
            args = list(node.args) + [
                k.value for k in node.keywords
                if k.arg not in ("parent", "trace_parent")
            ]
            for arg in args:
                if _reads_var(arg, var):
                    return True
        if isinstance(node, (ast.Dict, ast.List, ast.Tuple, ast.Set)):
            parent_ok = isinstance(node, ast.Tuple)  # unpack targets etc.
            if not parent_ok and _reads_var(node, var):
                return True
    return False


def _catches_baseexception(handler: ast.ExceptHandler) -> bool:
    if handler.type is None:
        return True
    names = []
    if isinstance(handler.type, ast.Tuple):
        names = [terminal(e) for e in handler.type.elts]
    else:
        names = [terminal(handler.type)]
    return "BaseException" in names or "KeyboardInterrupt" in names


def span_protected(func: ast.AST, var: str, parents: dict) -> bool:
    """Is some ``.end(var...)`` on a path that survives BaseException —
    a ``finally`` block, or an except handler that catches
    BaseException (bare / explicit / KeyboardInterrupt)? This is the
    contract the serving/recovery span fixes converged on: success-path
    ends carry attributes, and ONE defensive end sits where a second
    Ctrl-C or SystemExit still passes through."""
    for node in ast.walk(func):
        if not (isinstance(node, ast.Call)
                and terminal(node.func) == "end" and node.args
                and isinstance(node.args[0], ast.Name)
                and node.args[0].id == var):
            continue
        cur = parents.get(node)
        prev: ast.AST = node
        while cur is not None and cur is not func:
            if isinstance(cur, ast.Try) and prev in cur.finalbody:
                return True
            if (isinstance(cur, ast.ExceptHandler)
                    and _catches_baseexception(cur)):
                return True
            prev, cur = cur, parents.get(cur)
    return False


# --------------------------------------------- environ reads (HL008) --


def environ_aliases(tree: ast.AST) -> set[str]:
    """Local names bound to ``os.environ`` (directly or as the
    ``env or os.environ`` fallback idiom)."""
    out: set[str] = set()
    for node in ast.walk(tree):
        if not (isinstance(node, ast.Assign) and len(node.targets) == 1
                and isinstance(node.targets[0], ast.Name)):
            continue
        value = node.value
        exprs = [value]
        if isinstance(value, ast.BoolOp) and isinstance(value.op, ast.Or):
            exprs = value.values
        for e in exprs:
            if dotted(e) == "os.environ":
                out.add(node.targets[0].id)
    return out


def _is_environ(expr: ast.expr, aliases: set[str]) -> bool:
    if dotted(expr) == "os.environ":
        return True
    if isinstance(expr, ast.Name) and expr.id in aliases:
        return True
    if isinstance(expr, ast.BoolOp) and isinstance(expr.op, ast.Or):
        return any(_is_environ(v, aliases) for v in expr.values)
    return False


def _loop_bindings(tree: ast.AST, consts: dict[str, str]) -> dict[str, set[str]]:
    """``for key in (A, B):`` over resolvable string constants — each
    binding resolves to the full candidate set (backend's expected-
    topology reader)."""
    out: dict[str, set[str]] = {}
    for node in ast.walk(tree):
        if not (isinstance(node, ast.For)
                and isinstance(node.target, ast.Name)
                and isinstance(node.iter, (ast.Tuple, ast.List))):
            continue
        values = set()
        for elt in node.iter.elts:
            if isinstance(elt, ast.Constant) and isinstance(elt.value, str):
                values.add(elt.value)
            elif isinstance(elt, ast.Name) and elt.id in consts:
                values.add(consts[elt.id])
        if values and len(values) == len(node.iter.elts):
            out.setdefault(node.target.id, set()).update(values)
    return out


def iter_env_reads(tree: ast.AST, consts: dict[str, str]):
    """Yield ``(node, key)`` for every resolvable ``os.environ`` /
    ``os.getenv`` read: ``.get(k)``, ``[k]``, including reads through a
    local ``env = os.environ``-style alias or the ``(env or
    os.environ).get(k)`` fallback form. Unresolvable keys (call
    results, cross-module attributes) are skipped — the knob drift TEST
    greps the raw text and closes that gap."""
    aliases = environ_aliases(tree)
    loops = _loop_bindings(tree, consts)

    def keys_of(expr: ast.expr) -> set[str]:
        if isinstance(expr, ast.Constant) and isinstance(expr.value, str):
            return {expr.value}
        if isinstance(expr, ast.Name):
            if expr.id in consts:
                return {consts[expr.id]}
            if expr.id in loops:
                return loops[expr.id]
        return set()

    for node in ast.walk(tree):
        key_expr = None
        if (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr in ("get", "pop", "setdefault")
                and node.args
                and _is_environ(node.func.value, aliases)):
            key_expr = node.args[0]
        elif (isinstance(node, ast.Call)
                and dotted(node.func) == "os.getenv" and node.args):
            key_expr = node.args[0]
        elif (isinstance(node, ast.Subscript)
                and _is_environ(node.value, aliases)):
            key_expr = node.slice
        if key_expr is None:
            continue
        for key in sorted(keys_of(key_expr)):
            yield node, key
