"""What of the JAX tree has no counterpart in the port, and why.

Every ``.py`` file of the JAX package, every file of the repo-root
``tools/`` and ``examples/``, and ``bench.py`` has a port file (at the same
relative path, under ``tpu_aerial_transport_torch/tools|examples`` for the
tools and examples) or a ``FILES`` row of ``analysis/entrypoints.py
NO_COUNTERPART``; every public name of ``utils/compat.py`` and
``utils/platform.py``, and every public name and flag of a JAX tool or
example with a port file, has a counterpart or a ``NAMES`` row; every JAX
knob is in the port's ``KNOBS`` or has a ``KNOBS`` row. Every reason is
written, and no row names what the port has. AST and file walks only.
"""

import ast
import importlib.util
import os
import re

import pytest

from tpu_aerial_transport_torch.analysis import entrypoints, knobs

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_PKG = "tpu_aerial_transport"
PORT = "tpu_aerial_transport_torch"
# Repo-root files whose port counterpart has another name.
RENAMED = {"tools/jaxlint.py": PORT + "/tools/lint.py",
           "tools/ci_check.sh": PORT + "/tools/ci_check.py"}
TABLE = entrypoints.NO_COUNTERPART
_FLAG = re.compile(r"add_argument\(\s*\"(--[a-z0-9-]+)\"")


def _rows(table: str) -> dict[str, str]:
    return {k[len(table) + 1:]: v for k, v in TABLE.items()
            if k.startswith(table + ":")}


def _jax_files() -> list[str]:
    """Every JAX file the port should mirror, repo-relative."""
    out = []
    for root, dirs, names in os.walk(os.path.join(REPO, JAX_PKG)):
        dirs[:] = [d for d in dirs if d != "__pycache__"]
        out += [os.path.relpath(os.path.join(root, f), REPO)
                for f in names if f.endswith(".py")]
    for sub in ("tools", "examples"):
        out += [f"{sub}/{f}" for f in os.listdir(os.path.join(REPO, sub))
                if os.path.isfile(os.path.join(REPO, sub, f))]
    return sorted(out + ["bench.py"])


def _port_file(path: str) -> str:
    """Where ``path``'s port file would live, repo-relative."""
    if path in RENAMED:
        return RENAMED[path]
    if path.startswith(JAX_PKG + "/"):
        return PORT + path[len(JAX_PKG):]
    return f"{PORT}/{path}"


def _exists(rel: str) -> bool:
    return os.path.isfile(os.path.join(REPO, rel))


def _public(path: str, *, imported: bool = False) -> set[str]:
    """Module-level public functions, classes and UPPER_CASE constants of a
    file (and, with ``imported``, the names it imports)."""
    with open(os.path.join(REPO, path), encoding="utf-8") as fh:
        tree = ast.parse(fh.read())
    out = set()
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            out.add(node.name)
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = (node.targets if isinstance(node, ast.Assign)
                       else [node.target])
            out |= {t.id for t in targets if isinstance(t, ast.Name)
                    and t.id.isupper()}
        elif imported and isinstance(node, (ast.Import, ast.ImportFrom)):
            out |= {(a.asname or a.name).split(".")[0] for a in node.names}
    return {n for n in out if not n.startswith("_")}


def _flags(path: str) -> set[str]:
    with open(os.path.join(REPO, path), encoding="utf-8") as fh:
        return set(_FLAG.findall(fh.read()))


def _mirrored_modules() -> list[str]:
    """The JAX tools and examples (``.py``) that have a port file."""
    return [p for p in _jax_files() if p.startswith(("tools/", "examples/"))
            and p.endswith(".py") and _exists(_port_file(p))]


def test_every_jax_file_has_a_port_file_or_a_row():
    files = _rows("FILES")
    missing = [p for p in _jax_files()
               if not _exists(_port_file(p)) and p not in files]
    assert not missing
    for path, port in RENAMED.items():
        assert _exists(port) and path in files
        assert port.rsplit("/", 1)[1] in files[path], path


def test_no_stale_file_rows():
    """A ``FILES`` row names a JAX file that exists, has no port file at
    the same path, and (a renamed one) names its counterpart."""
    jax = set(_jax_files())
    for path in _rows("FILES"):
        assert path in jax, path
        same = (PORT + path[len(JAX_PKG):] if path.startswith(JAX_PKG + "/")
                else f"{PORT}/{path}")
        assert not _exists(same), path


@pytest.mark.parametrize("module", ["compat", "platform"])
def test_every_utils_name_has_a_row(module):
    path = f"{JAX_PKG}/utils/{module}.py"
    names = _public(path)
    assert names
    rows = {k.split(":", 1)[1] for k in _rows("NAMES")
            if k.startswith(path + ":")}
    assert names == rows
    assert f"NAMES rows of utils/{module}.py" in TABLE[f"FILES:{path}"]


def test_every_tool_and_example_name_and_flag_has_a_counterpart_or_row():
    """A public name or flag of a JAX tool or example with a port file is
    in the port file or has a ``NAMES`` row."""
    rows = _rows("NAMES")
    for path in _mirrored_modules():
        port = _port_file(path)
        for name in _public(path) - _public(port, imported=True):
            assert f"{path}:{name}" in rows, (path, name)
        for flag in _flags(path) - _flags(port):
            assert f"{path}:{flag}" in rows, (path, flag)


def test_no_stale_name_rows():
    """A ``NAMES`` row names what its JAX file has and its port file (if
    any) has not."""
    for key in _rows("NAMES"):
        path, name = key.rsplit(":", 1)
        has = _flags(path) if name.startswith("--") else _public(path)
        assert name in has, key
        port = _port_file(path)
        if _exists(port):
            port_has = (_flags(port) if name.startswith("--")
                        else _public(port, imported=True))
            assert name not in port_has, key


def _jax_knobs() -> dict:
    spec = importlib.util.spec_from_file_location(
        "_jax_knobs", os.path.join(REPO, JAX_PKG, "analysis", "knobs.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.KNOBS


def test_every_jax_knob_is_ported_or_has_a_row():
    jax = _jax_knobs()
    rows = _rows("KNOBS")
    assert set(jax) - set(knobs.KNOBS) == set(rows)
    assert not set(rows) & set(knobs.KNOBS)


def test_every_reason_is_written():
    for key, reason in TABLE.items():
        assert key.split(":", 1)[0] in (
            "TRACED_FUNCTIONS", "DONATION_CONTRACTS", "FILES", "NAMES",
            "KNOBS"), key
        assert isinstance(reason, str) and len(reason.strip()) >= 40, key
