"""Tier-A torchlint rules: pure-AST checks of the port's hot path.

HARD CONSTRAINT: this module imports nothing beyond the stdlib (no torch,
no jax, no numpy, no package module): ``tools/lint.py`` loads it by file
path so the lint runs on a host with no stack at all, and
``tests/test_torch_lint.py`` checks that in a subprocess.

The counterpart of the JAX package's jaxlint Tier A. Where a JAX rule has
a meaning in eager PyTorch on a CUDA card, its TL twin keeps its number:

- TL001 (JL001): ``float()/int()/bool()/complex()`` of a tensor
  expression, a device-to-host synchronisation;
- TL002 (JL002): ``.item()``, ``.tolist()``, ``.cpu()``, ``.numpy()``,
  ``synchronize()``, and the ops that synchronise on CUDA to size their
  output: ``nonzero``, ``masked_select``, ``unique``, boolean-mask
  indexing;
- TL003 (JL003): numpy called in hot code (a host round trip, or an error,
  on a card tensor);
- TL004 (JL004): float64 reaching torch (``torch.float64``/``torch.double``
  anywhere; ``.double()``, ``dtype=float``, ``np.float64`` in hot code or
  passed to a torch call);
- TL005 (JL005): Python ``if``/``while`` on a tensor expression;
- TL006 (JL006): ``torch.tensor``/``as_tensor``/``from_numpy`` of host
  data inside a loop body, or anywhere in a function captured into a CUDA
  graph, whose capture refuses host-to-device copies;
- TL007 (JL007): bare ``assert`` on a tensor expression;
- TL011 (JL011, a warning): ``print()`` of a tensor expression.

JL008 and JL009 (``static_argnames``) and JL010 (``pure_callback``) have
no meaning without ``jax.jit``: no TL rule takes their numbers.

**Hot code.** A syntactic approximation of "this runs on the hot path":

- seeds: functions named in the per-module table
  (``analysis.entrypoints.HOT_FUNCTIONS``: the controllers' ``control``,
  the solves, the rollout and chunk step bodies, the serving chunk, the
  substeps); functions passed to (or decorated by) ``GraphedFn``
  (``harness/cuda_graph.py``), ``make_graphed_callables`` or
  ``torch.utils.checkpoint.checkpoint``; functions called from a ``with
  torch.cuda.graph(...)`` body, and that body itself; the ``forward`` and
  ``backward`` of a ``torch.autograd.Function`` subclass;
- propagation: a module-level function called (by bare name, or as an
  attribute) from hot code becomes hot, and a def nested in a hot function
  is hot, to a fixpoint, as in jaxlint. Cross-module propagation is left
  to the table.

Functions captured into a CUDA graph (``GraphedFn``, ``torch.cuda.graph``,
``make_graphed_callables``) and everything they reach are *captured*:
TL006 holds anywhere in them, not only in loop bodies.

A *tensor expression* is one that calls torch (a ``torch.*`` or
``F.*`` call) or a tensor method that computes on the values (``.any()``,
``.sum()``, ``.max()``, ...). Calls that read metadata (``.dim()``,
``.numel()``, ``.size()``, ``.shape``, ``torch.is_floating_point``,
``isinstance``, ...) do not count, nor do calls of the module's own
helpers, which in eager PyTorch return Python values as often as tensors.

**Host-region exemption.** The body of ``if not isinstance(x,
torch.Tensor):`` (and the ``else`` of ``if isinstance(x, torch.Tensor):``)
handles a value that is not a tensor: it is exempt from every rule, the
counterpart of jaxlint's Tracer guard.

**Suppression.** ``# torchlint: disable=TL002`` on a line suppresses those
rules for that line; ``# torchlint: disable=all`` suppresses every rule;
``# torchlint: skip-file`` in the first 10 lines skips the module. Each
pragma carries a one-line reason on its line or the one above: it is the
record of why the host waits there.
"""

from __future__ import annotations

import ast
import dataclasses
import re


@dataclasses.dataclass(frozen=True)
class Finding:
    """One lint finding. ``severity`` is "error" (fails the lint) or
    "warn"."""

    rule: str
    path: str
    line: int
    col: int
    message: str
    context: str = ""  # enclosing function, dotted.
    severity: str = "error"

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    def render(self) -> str:
        ctx = f" [{self.context}]" if self.context else ""
        return (
            f"{self.path}:{self.line}:{self.col}: {self.rule} "
            f"({self.severity}){ctx} {self.message}"
        )


RULE_DOCS = {
    "TL001": (
        "host-cast-sync: float()/int()/bool()/complex() applied to a "
        "tensor expression in hot code copies the value to the host and "
        "waits for the card (a device->host synchronisation)."
    ),
    "TL002": (
        "host-item-sync: .item()/.tolist()/.cpu()/.numpy()/synchronize() "
        "in hot code, or an op that synchronises on CUDA to size its "
        "output (nonzero, masked_select, unique, boolean-mask indexing); "
        "keep the values on the card and read them outside the hot path."
    ),
    "TL003": (
        "numpy-in-hot-path: numpy called in hot code runs on the host "
        "(a card tensor is copied back, or raises); use torch ops, or "
        "guard a non-tensor value with an isinstance(x, torch.Tensor) "
        "host region."
    ),
    "TL004": (
        "f64-promotion: float64 reaching torch (torch.float64/"
        "torch.double, .double(), dtype=float, np.float64 into a torch "
        "call) runs at a fraction of the card's float32 rate and doubles "
        "the bytes moved."
    ),
    "TL005": (
        "tensor-branch: Python if/while on a tensor expression in hot "
        "code synchronises with the card to decide; use torch.where or "
        "a mask."
    ),
    "TL006": (
        "tensor-in-loop-body: torch.tensor/as_tensor/from_numpy inside a "
        "loop body copies host data to the card every iteration (hoist "
        "it), and inside a function captured into a CUDA graph anywhere "
        "(a capture refuses host-to-device copies)."
    ),
    "TL007": (
        "assert-on-tensor: bare assert on a tensor expression in hot code "
        "synchronises with the card (and vanishes under python -O); check "
        "on the host, outside the hot path."
    ),
    "TL011": (
        "print-of-tensor: print() of a tensor expression in hot code "
        "synchronises with the card to format it; log outside the hot "
        "path."
    ),
}

# Callables whose first argument is captured into a CUDA graph, or run
# under activation checkpointing (hot either way).
_CAPTURE_CALLS = frozenset({"GraphedFn", "make_graphed_callables"})
_HOT_CALLS = _CAPTURE_CALLS | {"checkpoint"}
_AUTOGRAD_METHODS = frozenset({"forward", "backward"})

_PRAGMA_RE = re.compile(r"#\s*torchlint:\s*disable=([A-Za-z0-9_,\s]+)")
_SKIP_FILE_RE = re.compile(r"#\s*torchlint:\s*skip-file")

_HOST_CASTS = frozenset({"float", "int", "bool", "complex"})
_HOST_SYNC_ATTRS = frozenset({"item", "tolist", "cpu", "numpy",
                              "synchronize"})
_SYNC_OPS = frozenset({"nonzero", "masked_select", "unique",
                       "unique_consecutive"})
_STAGING_CALLS = frozenset({"tensor", "as_tensor", "from_numpy"})
_MASK_CALLS = frozenset({"isfinite", "isnan", "isinf", "logical_and",
                         "logical_or", "logical_not", "logical_xor"})
# Tensor methods that compute on the values (a call of one makes an
# expression a tensor expression).
_TENSOR_METHODS = frozenset({
    "any", "all", "sum", "mean", "max", "min", "amax", "amin", "norm",
    "abs", "prod", "std", "var", "argmax", "argmin", "count_nonzero",
    "isfinite", "isnan", "eq", "ne", "gt", "lt", "ge", "le", "float",
    "double", "half", "clone", "sqrt", "square", "exp", "log", "dot",
    "matmul", "item",
})
# Calls that read metadata (dtype, shape, device, type): no value of a
# tensor reaches the host, so branching or asserting on them is safe.
_METADATA_CALLS = frozenset({
    "is_floating_point", "is_complex", "is_tensor", "isinstance",
    "hasattr", "len", "dim", "ndimension", "numel", "size", "shape",
    "get_device", "is_contiguous", "data_ptr", "element_size",
    "result_type", "promote_types", "can_cast", "type", "getattr",
})


def _terminal_name(node: ast.expr) -> str | None:
    """``torch.linalg.solve`` -> "solve"; ``scan`` -> "scan"."""
    if isinstance(node, ast.Attribute):
        return node.attr
    if isinstance(node, ast.Name):
        return node.id
    return None


def _root_name(node: ast.expr) -> str | None:
    """``torch.linalg.norm`` -> "torch"; ``np.asarray`` -> "np"."""
    while isinstance(node, ast.Attribute):
        node = node.value
    if isinstance(node, ast.Name):
        return node.id
    return None


def _dotted(node: ast.expr) -> str:
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
    return ".".join(reversed(parts))


def _iter_names(node: ast.AST):
    for sub in ast.walk(node):
        if isinstance(sub, ast.Name):
            yield sub.id
        elif isinstance(sub, ast.Attribute):
            yield sub.attr


_FUNC_NODES = (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)


def _tensor_guard_host_span(node: ast.If) -> tuple[int, int] | None:
    """Line span of the HOST branch of an isinstance-Tensor guard, if this
    ``if`` is one: ``not isinstance(x, torch.Tensor)`` -> the body handles
    a non-tensor; ``isinstance(x, torch.Tensor)`` -> the else branch does.
    Compound tests get no exemption."""
    test = node.test
    negated = False
    if isinstance(test, ast.UnaryOp) and isinstance(test.op, ast.Not):
        test = test.operand
        negated = True
    if not (isinstance(test, ast.Call)
            and _terminal_name(test.func) == "isinstance"
            and len(test.args) == 2
            and any(n == "Tensor" for n in _iter_names(test.args[1]))):
        return None
    stmts = node.body if negated else node.orelse
    if not stmts:
        return None
    return (stmts[0].lineno, stmts[-1].end_lineno or stmts[-1].lineno)


def _is_graph_with(node: ast.AST) -> bool:
    """``with torch.cuda.graph(g):`` (any alias ending in ``cuda.graph``
    or a bare ``graph(...)`` imported from torch.cuda)."""
    if not isinstance(node, (ast.With, ast.AsyncWith)):
        return False
    for item in node.items:
        e = item.context_expr
        if isinstance(e, ast.Call):
            d = _dotted(e.func)
            if d.endswith("cuda.graph") or d == "graph":
                return True
    return False


class ModuleContext:
    """Parsed module + alias tables + hot-code inference (module
    docstring). One instance per linted file."""

    def __init__(self, path: str, source: str,
                 entry_names: frozenset[str] = frozenset()):
        self.path = path
        self.source = source
        self.tree = ast.parse(source, filename=path)
        self.lines = source.splitlines()
        self.skip_file = any(
            _SKIP_FILE_RE.search(ln) for ln in self.lines[:10]
        )
        self.entry_names = entry_names

        # Per-line suppressed rule ids ("all" suppresses everything).
        self.suppressed: dict[int, frozenset[str]] = {}
        for i, ln in enumerate(self.lines, start=1):
            m = _PRAGMA_RE.search(ln)
            if m:
                self.suppressed[i] = frozenset(
                    s.strip() for s in m.group(1).split(",") if s.strip()
                )

        # Alias tables (module-wide, including function-local imports).
        self.np_aliases: set[str] = set()
        self.torch_aliases: set[str] = set()
        for node in ast.walk(self.tree):
            if isinstance(node, ast.Import):
                for a in node.names:
                    if a.name == "numpy":
                        self.np_aliases.add(a.asname or "numpy")
                    elif a.name == "torch" or a.name.startswith("torch."):
                        self.torch_aliases.add(
                            a.asname or a.name.split(".")[0])
            elif isinstance(node, ast.ImportFrom) and node.module:
                if node.module == "torch" or node.module.startswith(
                        "torch."):
                    for a in node.names:
                        # from torch.nn import functional as F; from torch
                        # import linalg: module aliases whose calls are
                        # torch calls.
                        if a.name in ("functional", "linalg", "fft",
                                      "special", "nn", "cuda"):
                            self.torch_aliases.add(a.asname or a.name)

        # Parent / enclosing-function annotation.
        self.func_of: dict[ast.AST, ast.AST | None] = {}
        self.parent: dict[ast.AST, ast.AST] = {}
        self.functions: list[ast.AST] = []

        def annotate(node, func):
            for child in ast.iter_child_nodes(node):
                self.parent[child] = node
                if isinstance(child, _FUNC_NODES):
                    self.functions.append(child)
                    self.func_of[child] = func
                    annotate(child, child)
                else:
                    self.func_of[child] = func
                    annotate(child, func)

        annotate(self.tree, None)

        self.top_funcs: dict[str, ast.AST] = {
            n.name: n
            for n in self.tree.body
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))
        }
        self.funcs_by_name: dict[str, list[ast.AST]] = {}
        for fn in self.functions:
            if not isinstance(fn, ast.Lambda):
                self.funcs_by_name.setdefault(fn.name, []).append(fn)

        self.host_ranges: list[tuple[int, int]] = []
        for node in ast.walk(self.tree):
            if isinstance(node, ast.If):
                span = _tensor_guard_host_span(node)
                if span is not None:
                    self.host_ranges.append(span)

        self._infer_hot()

    # --- hot-code inference -------------------------------------------
    def _infer_hot(self) -> None:
        hot: set[ast.AST] = set()
        captured: set[ast.AST] = set()
        # Bodies of `with torch.cuda.graph(...)`: hot and captured code
        # outside any function of their own.
        self.graph_withs: list[ast.AST] = []

        def resolve_all(arg: ast.expr) -> list[ast.AST]:
            if isinstance(arg, ast.Lambda):
                return [arg]
            if isinstance(arg, (ast.Name, ast.Attribute)):
                return self.funcs_by_name.get(_terminal_name(arg), [])
            if isinstance(arg, ast.Call):
                tname = _terminal_name(arg.func)
                if tname == "partial" and arg.args:
                    return resolve_all(arg.args[0])
                if tname in _HOT_CALLS and arg.args:
                    return resolve_all(arg.args[0])
            return []

        for fn in self.functions:
            if isinstance(fn, ast.Lambda):
                continue
            for dec in fn.decorator_list:
                names = set(_iter_names(dec))
                if names & _HOT_CALLS:
                    hot.add(fn)
                if names & _CAPTURE_CALLS:
                    captured.add(fn)

        for name in self.entry_names:
            fn = self.top_funcs.get(name)
            if fn is not None:
                hot.add(fn)

        for node in ast.walk(self.tree):
            if isinstance(node, ast.ClassDef) and any(
                    _terminal_name(b) == "Function" for b in node.bases):
                for item in node.body:
                    if (isinstance(item, (ast.FunctionDef,
                                          ast.AsyncFunctionDef))
                            and item.name in _AUTOGRAD_METHODS):
                        hot.add(item)
            elif isinstance(node, ast.Call):
                tname = _terminal_name(node.func)
                if tname in _HOT_CALLS and node.args:
                    for target in resolve_all(node.args[0]):
                        hot.add(target)
                        if tname in _CAPTURE_CALLS:
                            captured.add(target)
            elif _is_graph_with(node):
                self.graph_withs.append(node)
                for stmt in node.body:
                    for sub in ast.walk(stmt):
                        if isinstance(sub, ast.Call):
                            for target in self.funcs_by_name.get(
                                    _terminal_name(sub.func), []):
                                hot.add(target)
                                captured.add(target)

        self.hot = self._propagate(hot)
        self.captured = self._propagate(captured)
        self.loop_nodes: set[ast.AST] = set()
        for node in ast.walk(self.tree):
            if isinstance(node, (ast.For, ast.While, ast.AsyncFor)):
                for stmt in node.body:
                    for sub in ast.walk(stmt):
                        self.loop_nodes.add(sub)

    def _propagate(self, seeds: set[ast.AST]) -> set[ast.AST]:
        """Close ``seeds`` over calls from their bodies (to module-level
        functions) and over nested defs, to a fixpoint."""
        out = set(seeds)
        changed = True
        while changed:
            changed = False
            for fn in list(out):
                for node in ast.walk(fn):
                    if not isinstance(node, ast.Call):
                        continue
                    target = self.top_funcs.get(_terminal_name(node.func))
                    if target is not None and target not in out:
                        out.add(target)
                        changed = True
            for fn in self.functions:
                if fn in out:
                    continue
                outer = self.func_of.get(fn)
                if outer is not None and outer in out:
                    out.add(fn)
                    changed = True
        return out

    # --- helpers used by rules ----------------------------------------
    def _in(self, node: ast.AST, funcs: set[ast.AST]) -> bool:
        fn = self.func_of.get(node)
        while fn is not None:
            if fn in funcs:
                return True
            fn = self.func_of.get(fn)
        return self._in_graph_with(node)

    def _in_graph_with(self, node: ast.AST) -> bool:
        line = getattr(node, "lineno", None)
        if line is None:
            return False
        return any(
            w.body[0].lineno <= line <= (w.body[-1].end_lineno or line)
            for w in self.graph_withs
        )

    def in_hot(self, node: ast.AST) -> bool:
        return self._in(node, self.hot)

    def in_captured(self, node: ast.AST) -> bool:
        return self._in(node, self.captured)

    def in_host_region(self, node: ast.AST) -> bool:
        line = getattr(node, "lineno", None)
        if line is None:
            return False
        return any(lo <= line <= hi for lo, hi in self.host_ranges)

    def enclosing_name(self, node: ast.AST) -> str:
        parts = []
        fn = self.func_of.get(node)
        while fn is not None:
            parts.append(getattr(fn, "name", "<lambda>"))
            fn = self.func_of.get(fn)
        return ".".join(reversed(parts))

    def is_suppressed(self, rule: str, line: int) -> bool:
        ids = self.suppressed.get(line)
        return ids is not None and (rule in ids or "all" in ids)

    def is_torch_call(self, call: ast.Call) -> bool:
        return _root_name(call.func) in self.torch_aliases

    def mentions_tensor_call(self, node: ast.AST) -> bool:
        """Does this expression compute on tensor values: call torch or a
        value-reading tensor method (not merely read metadata such as
        ``.shape`` or ``.dim()``)? A call of the module's own helpers does
        not count: in eager PyTorch they return Python values as often as
        tensors (jaxlint counts them, since a traced function returns a
        tracer)."""
        for sub in ast.walk(node):
            if not isinstance(sub, ast.Call):
                continue
            callee = _terminal_name(sub.func)
            if callee in _METADATA_CALLS:
                continue
            if self.is_torch_call(sub):
                return True
            if (isinstance(sub.func, ast.Attribute)
                    and callee in _TENSOR_METHODS
                    and _root_name(sub.func) not in self.np_aliases):
                return True
        return False

    def finding(self, rule: str, node: ast.AST, message: str,
                severity: str = "error") -> Finding | None:
        line = getattr(node, "lineno", 0)
        if self.is_suppressed(rule, line) or self.in_host_region(node):
            return None
        return Finding(
            rule=rule, path=self.path, line=line,
            col=getattr(node, "col_offset", 0), message=message,
            context=self.enclosing_name(node), severity=severity,
        )


# ----------------------------------------------------------------------
# Rules. Each takes a ModuleContext and yields Findings.
# ----------------------------------------------------------------------

def rule_tl001_host_cast(ctx: ModuleContext):
    for node in ast.walk(ctx.tree):
        if not (isinstance(node, ast.Call) and isinstance(node.func, ast.Name)
                and node.func.id in _HOST_CASTS and node.args):
            continue
        if not ctx.in_hot(node):
            continue
        if ctx.mentions_tensor_call(node.args[0]):
            f = ctx.finding(
                "TL001", node,
                f"`{node.func.id}()` of a tensor expression copies it to "
                "the host and waits for the card",
            )
            if f:
                yield f


def _is_mask_index(node: ast.Subscript) -> bool:
    """``x[mask]`` with a mask the syntax shows to be boolean: a
    comparison, a negation ``~m``, a ``&``/``|`` of such, or an
    ``isfinite``-like call."""
    s = node.slice
    if isinstance(s, ast.Compare):
        return True
    if isinstance(s, ast.UnaryOp) and isinstance(s.op, ast.Invert):
        return True
    if isinstance(s, ast.BinOp) and isinstance(s.op, (ast.BitAnd,
                                                      ast.BitOr)):
        return True
    return isinstance(s, ast.Call) and _terminal_name(s.func) in _MASK_CALLS


def rule_tl002_host_item(ctx: ModuleContext):
    for node in ast.walk(ctx.tree):
        what = None
        if isinstance(node, ast.Call):
            name = _terminal_name(node.func)
            if (isinstance(node.func, ast.Attribute)
                    and name in _HOST_SYNC_ATTRS
                    and _root_name(node.func) not in ctx.np_aliases):
                what = f"`.{name}()` is a device->host round trip"
            elif name in _SYNC_OPS and (
                    isinstance(node.func, ast.Attribute)):
                what = (f"`{name}` sizes its output on the host: it "
                        "synchronises with the card")
        elif (isinstance(node, ast.Subscript)
              and isinstance(node.ctx, ast.Load) and _is_mask_index(node)):
            what = ("boolean-mask indexing sizes its output on the host: "
                    "it synchronises with the card (use torch.where)")
        if what is None or not ctx.in_hot(node):
            continue
        f = ctx.finding("TL002", node, f"{what} in hot code")
        if f:
            yield f


def rule_tl003_numpy_in_hot(ctx: ModuleContext):
    for node in ast.walk(ctx.tree):
        if not isinstance(node, ast.Call):
            continue
        if _root_name(node.func) not in ctx.np_aliases:
            continue
        if ctx.in_hot(node):
            f = ctx.finding(
                "TL003", node,
                f"numpy call `{_dotted(node.func)}(...)` in hot code runs "
                "on the host; use torch ops or an isinstance(x, "
                "torch.Tensor) host region",
            )
            if f:
                yield f


def rule_tl004_f64(ctx: ModuleContext):
    torch_roots = ctx.torch_aliases
    np_roots = ctx.np_aliases

    def in_torch_call(node):
        p = ctx.parent.get(node)
        while p is not None:
            if isinstance(p, ast.Call) and _root_name(p.func) in torch_roots:
                return True
            if isinstance(p, (ast.stmt,) + _FUNC_NODES):
                return False
            p = ctx.parent.get(p)
        return False

    for node in ast.walk(ctx.tree):
        if isinstance(node, ast.Attribute) and node.attr in ("float64",
                                                             "double"):
            root = _root_name(node)
            bad = root in torch_roots or (
                root in np_roots and node.attr == "float64"
                and (ctx.in_hot(node) or in_torch_call(node)))
            if bad:
                f = ctx.finding(
                    "TL004", node,
                    f"`{_dotted(node)}` brings float64 into torch code",
                )
                if f:
                    yield f
        elif isinstance(node, ast.keyword) and node.arg == "dtype":
            v = node.value
            is_str64 = isinstance(v, ast.Constant) and v.value in (
                "float64", "double")
            is_pyfloat = isinstance(v, ast.Name) and v.id == "float"
            if (is_str64 or is_pyfloat) and (
                    ctx.in_hot(v) or in_torch_call(v)):
                f = ctx.finding(
                    "TL004", v,
                    "dtype=%s is float64 in torch"
                    % ("'float64'" if is_str64 else "float (Python)"),
                )
                if f:
                    yield f
        elif (isinstance(node, ast.Call)
              and isinstance(node.func, ast.Attribute)
              and node.func.attr == "double" and not node.args
              and _root_name(node.func) not in np_roots
              and ctx.in_hot(node)):
            f = ctx.finding("TL004", node, "`.double()` widens to float64")
            if f:
                yield f


def rule_tl005_tensor_branch(ctx: ModuleContext):
    for node in ast.walk(ctx.tree):
        if not isinstance(node, (ast.If, ast.While)):
            continue
        if not ctx.in_hot(node):
            continue
        if ctx.mentions_tensor_call(node.test):
            kind = "if" if isinstance(node, ast.If) else "while"
            f = ctx.finding(
                "TL005", node,
                f"Python `{kind}` on a tensor expression in hot code "
                "synchronises with the card to decide; use torch.where "
                "or a mask",
            )
            if f:
                yield f


def rule_tl006_tensor_in_loop(ctx: ModuleContext):
    for node in ast.walk(ctx.tree):
        if not (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr in _STAGING_CALLS
                and _root_name(node.func) in ctx.torch_aliases):
            continue
        if ctx.in_captured(node):
            where = ("inside a function captured into a CUDA graph (the "
                     "capture refuses host-to-device copies)")
        elif node in ctx.loop_nodes and ctx.in_hot(node):
            where = ("inside a loop body: it copies host data to the card "
                     "every iteration; hoist it out of the loop")
        else:
            continue
        f = ctx.finding("TL006", node,
                        f"`{_dotted(node.func)}(...)` {where}")
        if f:
            yield f


def rule_tl007_assert_on_tensor(ctx: ModuleContext):
    for node in ast.walk(ctx.tree):
        if not isinstance(node, ast.Assert):
            continue
        if not ctx.in_hot(node):
            continue
        if ctx.mentions_tensor_call(node.test):
            f = ctx.finding(
                "TL007", node,
                "bare `assert` on a tensor expression in hot code "
                "synchronises with the card; check on the host",
            )
            if f:
                yield f


def rule_tl011_print(ctx: ModuleContext):
    for node in ast.walk(ctx.tree):
        if not (isinstance(node, ast.Call) and isinstance(node.func, ast.Name)
                and node.func.id == "print" and ctx.in_hot(node)):
            continue
        if any(ctx.mentions_tensor_call(a) for a in node.args) or any(
                ctx.mentions_tensor_call(k.value) for k in node.keywords):
            f = ctx.finding(
                "TL011", node,
                "print() of a tensor expression in hot code synchronises "
                "with the card to format it; log outside the hot path",
                severity="warn",
            )
            if f:
                yield f


RULES = {
    "TL001": rule_tl001_host_cast,
    "TL002": rule_tl002_host_item,
    "TL003": rule_tl003_numpy_in_hot,
    "TL004": rule_tl004_f64,
    "TL005": rule_tl005_tensor_branch,
    "TL006": rule_tl006_tensor_in_loop,
    "TL007": rule_tl007_assert_on_tensor,
    "TL011": rule_tl011_print,
}


def run_rules(ctx: ModuleContext,
              disabled: frozenset[str] = frozenset()) -> list[Finding]:
    if ctx.skip_file:
        return []
    out: list[Finding] = []
    for rule_id, impl in RULES.items():
        if rule_id in disabled:
            continue
        out.extend(impl(ctx))
    out.sort(key=lambda f: (f.path, f.line, f.rule))
    return out
