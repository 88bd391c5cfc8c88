"""The lint driver of the port: file discovery, the hot-function table's
lookup, rule execution and output. Stdlib only (no torch, no jax);
``tools/lint.py`` loads it by file path.
"""

from __future__ import annotations

import json
import os
import sys

if __package__:
    from tpu_aerial_transport_torch.analysis import entrypoints as _entry
    from tpu_aerial_transport_torch.analysis import hostrules as _host
    from tpu_aerial_transport_torch.analysis import rules as _rules
else:  # loaded by file path (tools/lint.py): sibling modules on sys.path.
    import entrypoints as _entry  # type: ignore
    import hostrules as _host  # type: ignore
    import rules as _rules  # type: ignore

Finding = _rules.Finding
RULES = _rules.RULES
RULE_DOCS = _rules.RULE_DOCS


def _posix(path: str) -> str:
    return path.replace(os.sep, "/")


def entry_names_for(path: str) -> frozenset[str]:
    """Hot-function seeds for a file, matched by path suffix on the
    absolute path (so a relative invocation from inside the package still
    finds them)."""
    p = _posix(os.path.abspath(path))
    for suffix, names in _entry.HOT_FUNCTIONS.items():
        if p.endswith(suffix):
            return frozenset(names)
    return frozenset()


def iter_py_files(paths: list[str]):
    for path in paths:
        if os.path.isfile(path):
            if path.endswith(".py"):
                yield path
        else:
            for root, dirs, files in os.walk(path):
                dirs[:] = sorted(
                    d for d in dirs
                    if d not in {"__pycache__", ".git", ".pytest_cache"}
                )
                for f in sorted(files):
                    if f.endswith(".py"):
                        yield os.path.join(root, f)


def lint_file(path: str,
              disabled: frozenset[str] = frozenset()) -> list[Finding]:
    with open(path, encoding="utf-8") as fh:
        source = fh.read()
    try:
        ctx = _rules.ModuleContext(path, source, entry_names_for(path))
    except SyntaxError as e:
        return [Finding(
            rule="TL000", path=path, line=e.lineno or 0, col=e.offset or 0,
            message=f"syntax error: {e.msg}",
        )]
    return _rules.run_rules(ctx, disabled)


def lint_paths(paths: list[str],
               disabled: frozenset[str] = frozenset()) -> list[Finding]:
    out: list[Finding] = []
    for f in iter_py_files(paths):
        out.extend(lint_file(f, disabled))
    return out


def render_text(findings: list[Finding]) -> str:
    if not findings:
        return "torchlint: clean (0 findings)"
    lines = [f.render() for f in findings]
    n_err = sum(f.severity == "error" for f in findings)
    n_warn = len(findings) - n_err
    lines.append(f"torchlint: {n_err} error(s), {n_warn} warning(s)")
    return "\n".join(lines)


def render_json(findings: list[Finding],
                rules: list[str] | None = None) -> str:
    return json.dumps(
        {
            "findings": [f.to_dict() for f in findings],
            "errors": sum(f.severity == "error" for f in findings),
            "warnings": sum(f.severity == "warn" for f in findings),
            "rules": sorted(RULES) if rules is None else sorted(rules),
        },
        indent=2,
    )


def main(argv: list[str] | None = None) -> int:
    """The CLI body of ``tools/lint.py`` (which runs this by file path)."""
    import argparse

    ap = argparse.ArgumentParser(
        prog="torchlint",
        description="static analysis of the PyTorch port: Tier A (TL "
        "rules, pure AST), Tier C (--host: HL rules, pure AST), Tier B "
        "(--contracts: the registry's contracts, imports torch).",
    )
    ap.add_argument("paths", nargs="*", default=None,
                    help="files/dirs to lint (default: the port package, "
                    "or with --host its host tier)")
    ap.add_argument("--format", choices=("text", "json"), default="text")
    ap.add_argument("--disable", default="",
                    help="comma-separated rule ids to skip (e.g. TL003)")
    ap.add_argument("--list-rules", action="store_true")
    ap.add_argument("--host", action="store_true",
                    help="run Tier C (HL rules) over the host tier -- "
                    "serving/, resilience/, obs/, parallel/pods.py, "
                    "tools/ -- instead of Tier A")
    ap.add_argument("--contracts", action="store_true",
                    help="also run Tier B over the registry (imports "
                    "torch)")
    ap.add_argument("--device", default="cpu",
                    help="device of --contracts: cpu or cuda")
    ap.add_argument("--only", default="",
                    help="comma-separated registry names restricting "
                    "--contracts")
    ap.add_argument("--assert-no-torch", action="store_true",
                    help="exit 2 if torch or jax was imported by a Tier A "
                    "or C run (the test suite's self-check)")
    ap.add_argument("--strict-warn", action="store_true",
                    help="exit nonzero on warnings too")
    args = ap.parse_args(argv)

    if args.list_rules:
        docs = {**RULE_DOCS, **_host.HOST_RULE_DOCS}
        for rid in sorted(docs):
            print(f"{rid}  {docs[rid]}")
        return 0

    pkg_root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    disabled = frozenset(
        s.strip() for s in args.disable.split(",") if s.strip()
    )
    if args.host:
        paths = args.paths or _host.host_paths(os.path.dirname(pkg_root))
        findings = _host.lint_host_files(
            list(iter_py_files(paths)), disabled
        )
    else:
        paths = args.paths or [pkg_root]
        findings = lint_paths(paths, disabled)

    if args.assert_no_torch and ({"torch", "jax"} & set(sys.modules)):
        print("torchlint: FAIL -- a Tier A/C run imported "
              f"{sorted({'torch', 'jax'} & set(sys.modules))}",
              file=sys.stderr)
        return 2

    if args.contracts:
        sys.path.insert(0, os.path.dirname(pkg_root))
        from tpu_aerial_transport_torch.analysis import contracts

        only = [s.strip() for s in args.only.split(",") if s.strip()] \
            or None
        if only:
            unknown = [n for n in only if n not in contracts.REGISTRY]
            if unknown:
                print(f"torchlint: unknown --only entry point(s) {unknown}",
                      file=sys.stderr)
                return 1
        findings.extend(contracts.run_contracts(
            names=only, device=args.device, disabled=disabled))

    json_rules = sorted(_host.HOST_RULES) if args.host else None
    print(render_json(findings, rules=json_rules)
          if args.format == "json" else render_text(findings))

    n_err = sum(f.severity == "error" for f in findings)
    n_warn = len(findings) - n_err
    if n_err or (args.strict_warn and n_warn):
        return 1
    return 0
