"""The port's lint tiers (``tpu_aerial_transport_torch/analysis``).

- Tier C (hostlint): the port's HL rules give the JAX HL rules' findings
  on every fixture of tests/fixtures/hostlint (read only).
- Tier A (torchlint): each TL rule has a violation fixture and a clean
  twin below, line-for-line torch transcriptions of their JL twins in
  tests/fixtures/jaxlint, and fires at the lines where the JL rules fire on
  the twin.
- The port lints clean in both tiers; pragmas and waivers carry reasons;
  the knob registry does not drift from the code; the CLI's Tiers A and C
  import neither torch nor jax; its JSON output and exit codes.
- The hot-function and donation tables hold the counterpart of every JAX
  row that has one.
"""

import importlib.util
import json
import os
import re
import subprocess
import sys

import pytest

from tpu_aerial_transport.analysis import hostrules as jax_hostrules
from tpu_aerial_transport.analysis import linter as jax_linter
from tpu_aerial_transport_torch.analysis import (entrypoints, hostrules,
                                                 knobs, linter, rules)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "tpu_aerial_transport_torch")
HL_FIXTURES = os.path.join(REPO, "tests", "fixtures", "hostlint")
JL_FIXTURES = os.path.join(REPO, "tests", "fixtures", "jaxlint")
LINT = os.path.join(PKG, "tools", "lint.py")

G = "from tpu_aerial_transport_torch.harness.cuda_graph import GraphedFn"

# Line-for-line transcriptions of tests/fixtures/jaxlint/jlNNN_{bad,ok}.py:
# ``@jax.jit`` and ``jax.jit(f)``/``jax.vmap(f)`` become ``GraphedFn``,
# ``lax.scan(body, ...)`` a GraphedFn capture or a checkpoint of ``body``,
# jnp calls torch calls, the Tracer guard the Tensor guard.
TL_FIXTURES = {
    "tl001_bad": f'''"""Seeded violation: host cast of a tensor expression (TL001)."""
import torch
{G}


@GraphedFn
def energy(x):
    scale = float(torch.sum(x * x))  # expect: TL001
    return scale * x


def loop(x):
    n = int(torch.max(x))  # expect: TL001
    return n


GraphedFn(loop)
''',
    "tl001_ok": f'''"""Clean twin of tl001_bad: casts on static config values."""
{G}
import torch

SCALE = float(torch.pi / 4)  # module level: not hot code.


@GraphedFn
def energy(x, cfg_gain=2.0):
    gain = cfg_gain * SCALE  # no host cast of a tensor value.
    return gain * torch.sum(x * x)


def make_config(theta):
    # Host-side factory (not hot): eager casts are fine.
    return {{"sec": float(torch.cos(theta)), "n": int(theta // 1)}}
''',
    "tl002_bad": f'''"""Seeded violation: .item()/.tolist() in hot code (TL002)."""
{G}
import torch


@GraphedFn
def step(x):
    worst = torch.max(x).item()  # expect: TL002
    rows = x.tolist()  # expect: TL002
    return worst, rows
''',
    "tl002_ok": f'''"""Clean twin of tl002_bad: read on the host, outside the capture."""
{G}
import torch


@GraphedFn
def step(x):
    return torch.max(x), x


def report(x):
    worst, rows = step(x)
    return worst.item(), rows.tolist()  # host context: fine.
''',
    "tl003_bad": f'''"""Seeded violation: numpy call inside hot code (TL003)."""
{G}
import torch
import numpy as np
from torch.utils.checkpoint import checkpoint


@GraphedFn
def normalize(x):
    nrm = np.linalg.norm(x)  # expect: TL003
    return x / nrm


def body(carry, _):
    return carry + np.asarray([1.0, 2.0]), None  # expect: TL003


def run(c0):
    return checkpoint(body, c0, None, use_reentrant=False)
''',
    "tl003_ok": f'''"""Clean twin of tl003_bad: torch in hot code; np behind a guard."""
{G}
import torch
import numpy as np


@GraphedFn
def normalize(x):
    return x / torch.linalg.norm(x)


def checked_plan(scale):
    if not isinstance(scale, torch.Tensor):
        # Host-only region (a number or an array): numpy is fine here.
        assert np.all(np.isfinite(np.asarray(scale)))
    return scale ** 0.5


GraphedFn(checked_plan)
''',
    "tl004_bad": f'''"""Seeded violation: float64 reaching torch code (TL004)."""
{G}
import torch
import numpy as np


def widen(x):
    hi = torch.as_tensor(np.float64(x))  # expect: TL004
    return hi


@GraphedFn
def accumulate(x):
    acc = np.float64(0.0)  # expect: TL004
    return x + acc


def stringly(x):
    return torch.zeros_like(x, dtype=float)  # expect: TL004
''',
    "tl004_ok": '''"""Clean twin of tl004_bad: float32 in torch; host np float64 is fine."""
import torch
import numpy as np


def widen(x):
    return torch.as_tensor(x, dtype=torch.float32)


def host_geometry(vertices):
    # Host-side double-precision geometry (not hot) is legitimate.
    return np.asarray(vertices, np.float64)


def stringly(x):
    return torch.zeros_like(x, dtype=torch.float32)
''',
    "tl005_bad": f'''"""Seeded violation: Python branch on a tensor value (TL005)."""
{G}
import torch


@GraphedFn
def clamp(x):
    if torch.max(x) > 1.0:  # expect: TL005
        x = x / torch.max(x)
    while torch.any(x > 2.0):  # expect: TL005
        x = x * 0.5
    return x
''',
    "tl005_ok": f'''"""Clean twin of tl005_bad: data branches via where; static ones ok."""
{G}
import torch


@GraphedFn
def clamp(x, n_steps: int = 3):
    mx = torch.max(x)
    x = torch.where(mx > 1.0, x / mx, x)
    if n_steps > 2:  # static Python value: fine.
        x = x * 0.5
    if torch.is_floating_point(x):  # dtype metadata: fine.
        x = x + 0.0
    return x
''',
    "tl006_bad": f'''"""Seeded violation: torch.tensor inside a captured body (TL006)."""
import torch
{G}

OFFSETS = [1.0, 2.0, 3.0]


def body(carry, _):
    ofs = torch.as_tensor(OFFSETS)  # expect: TL006
    bias = torch.tensor([0.5, 0.5, 0.5])  # expect: TL006
    return carry + ofs + bias, None


def run(c0):
    return GraphedFn(body)(c0, None)
''',
    "tl006_ok": f'''"""Clean twin of tl006_bad: conversions hoisted out of the capture."""
import torch
{G}

OFFSETS = torch.as_tensor([1.0, 2.0, 3.0])
BIAS = torch.tensor([0.5, 0.5, 0.5])


def body(carry, _):
    return carry + OFFSETS + BIAS, None


def run(c0):
    return GraphedFn(body)(c0, None)
''',
    "tl007_bad": f'''"""Seeded violation: bare assert on a tensor expression (TL007)."""
{G}
import torch


@GraphedFn
def project(x):
    assert torch.all(torch.isfinite(x)), "non-finite input"  # expect: TL007
    return x / torch.linalg.norm(x)
''',
    "tl007_ok": f'''"""Clean twin of tl007_bad: shape asserts are metadata; value checks
via where or host code."""
{G}
import torch


@GraphedFn
def project(x):
    assert x.dim() == 1, x.shape  # shape metadata: fine.
    nrm = torch.linalg.norm(x)
    return x / torch.where(nrm > 0, nrm, 1.0)
''',
    "tl011_bad": f'''"""Seeded violation: print() of a tensor in hot code (TL011, warn)."""
{G}
import torch


@GraphedFn
def step(x):
    print("residual:", torch.max(x))  # expect: TL011
    return x * 0.5
''',
    "tl011_ok": f'''"""Clean twin of tl011_bad: no tensor formatted in hot code."""
{G}
import torch


@GraphedFn
def step(x):
    print("step: halving the input")
    return x * 0.5
''',
}

_EXPECT_RE = re.compile(r"#\s*expect:\s*([A-Z]L\d{3})")


def _expected(source):
    return sorted((rule, i) for i, line in enumerate(source.splitlines(), 1)
                  for rule in _EXPECT_RE.findall(line))


def _jl_path(name):
    return os.path.join(JL_FIXTURES, "jl" + name[2:] + ".py")


def _write(tmp_path, name):
    p = tmp_path / f"{name}.py"
    p.write_text(TL_FIXTURES[name])
    return str(p)


def _tl_of_jl(findings):
    """JL findings as the TL findings their twins should make."""
    return sorted(("TL" + f.rule[2:], f.line) for f in findings
                  if "TL" + f.rule[2:] in rules.RULES)


# ------------------------------ Tier A ---------------------------------

def test_every_tl_rule_has_a_fixture_pair_and_a_jl_twin():
    bad = {r for n, s in TL_FIXTURES.items() if n.endswith("_bad")
           for r, _ in _expected(s)}
    assert bad == set(rules.RULES)
    assert set(rules.RULE_DOCS) == set(rules.RULES)
    for name in TL_FIXTURES:
        assert os.path.exists(_jl_path(name)), name
    # JL008-JL010 (static_argnames, pure_callback) have no torch meaning:
    # no TL rule takes their numbers.
    assert not {"TL008", "TL009", "TL010"} & set(rules.RULES)


@pytest.mark.parametrize(
    "name", sorted(n for n in TL_FIXTURES if n.endswith("_bad")))
def test_tl_fixture_fires_at_its_jl_twins_lines(name, tmp_path):
    source = TL_FIXTURES[name]
    with open(_jl_path(name), encoding="utf-8") as fh:
        jl_source = fh.read()
    assert len(source.splitlines()) == len(jl_source.splitlines())
    # The markers sit on the twin's lines, rule for rule.
    assert [(r, i) for r, i in _expected(source)] == [
        ("TL" + r[2:], i) for r, i in _expected(jl_source)]
    got = sorted((f.rule, f.line)
                 for f in linter.lint_file(_write(tmp_path, name)))
    assert got == _tl_of_jl(jax_linter.lint_file(_jl_path(name)))
    assert set(_expected(source)) <= set(got)


@pytest.mark.parametrize(
    "name", sorted(n for n in TL_FIXTURES if n.endswith("_ok")))
def test_tl_clean_twin_is_clean(name, tmp_path):
    with open(_jl_path(name), encoding="utf-8") as fh:
        assert len(TL_FIXTURES[name].splitlines()) == len(
            fh.read().splitlines())
    assert jax_linter.lint_file(_jl_path(name)) == []
    findings = linter.lint_file(_write(tmp_path, name))
    assert findings == [], [f.render() for f in findings]


def _lint_src(tmp_path, src, name="case.py"):
    p = tmp_path / name
    p.write_text(src)
    return [(f.rule, f.line) for f in linter.lint_file(str(p))]


def test_pragma_and_skip_file(tmp_path):
    src = (f"{G}\nimport torch\n\n\n@GraphedFn\ndef f(x):\n"
           "    return float(torch.sum(x))  # torchlint: disable=TL001\n")
    assert _lint_src(tmp_path, src) == []
    assert _lint_src(tmp_path, src.replace(
        "  # torchlint: disable=TL001", "")) == [("TL001", 7)]
    assert _lint_src(tmp_path, "# torchlint: skip-file\n" + src.replace(
        "  # torchlint: disable=TL001", "")) == []


def test_tensor_guard_exempts_only_the_host_branch(tmp_path):
    src = (f"{G}\nimport numpy as np\nimport torch\n\n\n@GraphedFn\n"
           "def f(x):\n"
           "    if isinstance(x, torch.Tensor):\n"
           "        y = float(torch.sum(x))  # a tensor: a real sync\n"
           "    else:\n"
           "        y = float(np.sum(np.asarray(x)))  # host value: fine\n"
           "    return y\n")
    assert _lint_src(tmp_path, src) == [("TL001", 9)]


def test_hot_seeds_and_torch_sync_ops(tmp_path):
    """The seeds beyond decorators: a torch.cuda.graph body and what it
    calls, an autograd Function's forward, the hot-function table; and the
    syncs particular to CUDA: nonzero, boolean masks, .cpu()."""
    src = (
        "import torch\n\n\n"
        "def captured(x):\n"
        "    return torch.tensor([1.0]) + x\n\n\n"       # 5: TL006
        "def capture(g, x):\n"
        "    with torch.cuda.graph(g):\n"
        "        y = captured(x)\n"
        "        z = torch.as_tensor([2.0])\n"           # 11: TL006
        "    return y, z\n\n\n"
        "class Op(torch.autograd.Function):\n"
        "    @staticmethod\n"
        "    def forward(ctx, x):\n"
        "        return x[x > 0].cpu()\n\n\n"            # 18: TL002 x2
        "def control(x):\n"
        "    for _ in range(3):\n"
        "        x = x + torch.tensor(1.0)\n"            # 23: TL006
        "    return torch.nonzero(x), x.double()\n"      # 24: TL002, TL004
    )
    # At a path the hot-function table names: its ``control`` is seeded.
    p = tmp_path / "tpu_aerial_transport_torch" / "control" / "cadmm.py"
    p.parent.mkdir(parents=True)
    p.write_text(src)
    got = [(f.rule, f.line) for f in linter.lint_file(str(p))]
    assert sorted(got) == sorted([
        ("TL006", 5), ("TL006", 11), ("TL002", 18), ("TL002", 18),
        ("TL006", 23), ("TL002", 24), ("TL004", 24)])


def test_port_lints_clean_tier_a():
    findings = linter.lint_paths([PKG])
    assert not findings, "\n".join(f.render() for f in findings)


_PRAGMA = re.compile(r"#\s*torchlint:\s*disable=")


def test_every_pragma_carries_a_reason():
    """A pragma's reason is the comment line above the statement that
    holds it: each deliberate host read says why."""
    import ast
    import io
    import tokenize

    found = 0
    for path in linter.iter_py_files([PKG]):
        with open(path, encoding="utf-8") as fh:
            source = fh.read()
        lines = source.splitlines()
        marked = [tok.start[0] for tok in tokenize.generate_tokens(
            io.StringIO(source).readline)
            if tok.type == tokenize.COMMENT and _PRAGMA.search(tok.string)]
        if not marked:
            continue
        stmts = [n for n in ast.walk(ast.parse(source))
                 if isinstance(n, ast.stmt)]
        for line in marked:
            found += 1
            start = max(n.lineno for n in stmts
                        if n.lineno <= line <= n.end_lineno)
            k = start - 2
            # One comment may speak for a run of pragma'd statements.
            while k > 0 and _PRAGMA.search(lines[k]) and not lines[
                    k].strip().startswith("#"):
                k -= 1
            above = lines[k].strip()
            assert above.startswith("#") and len(above) > 12, (
                f"{path}:{line}: a pragma with no reason above its "
                "statement")
    assert found >= 9  # the consensus loops, the chunk loop, the plan...


# ------------------------------ Tier C ---------------------------------

def _fixture_files(kind):
    return sorted(os.path.join(HL_FIXTURES, f)
                  for f in os.listdir(HL_FIXTURES) if f.endswith(f"_{kind}.py"))


@pytest.mark.parametrize(
    "path", _fixture_files("bad") + _fixture_files("ok"),
    ids=os.path.basename)
def test_hostrules_match_jax_on_fixtures(path):
    """The same (rule, line) findings as the JAX hostlint. The knob
    registries differ (the port's has no XLA knobs), but no fixture reads
    a knob only one of them registers, so no difference is expected."""
    got = sorted((f.rule, f.line) for f in hostrules.lint_host_file(path)[0])
    ref = sorted((f.rule, f.line)
                 for f in jax_hostrules.lint_host_file(path)[0])
    assert got == ref
    if path.endswith("_bad.py"):
        assert got


def test_port_hostlints_clean_and_spans_the_host_tree():
    files = list(linter.iter_py_files(hostrules.host_paths(REPO)))
    findings = hostrules.lint_host_files(files)
    assert not findings, "\n".join(f.render() for f in findings)
    scanned = {os.path.abspath(f) for f in files}
    for sub in ("serving", "resilience", "obs", "tools"):
        for dirpath, dirnames, names in os.walk(os.path.join(PKG, sub)):
            dirnames[:] = [d for d in dirnames if d != "__pycache__"]
            for f in names:
                if f.endswith(".py"):
                    assert os.path.abspath(os.path.join(dirpath, f)) \
                        in scanned, f
    assert os.path.join(PKG, "parallel", "pods.py") in scanned


def test_waiver_hygiene(tmp_path, monkeypatch):
    for key, reason in hostrules.HOST_WAIVERS.items():
        path, rule, _ = key.split("::")
        assert rule in hostrules.HOST_RULES
        assert os.path.exists(os.path.join(REPO, path)), key
        assert len(reason.strip()) >= 40, key
    p = tmp_path / "mod.py"
    p.write_text("def f(tracer=None):\n    return tracer is not None\n")
    key = "mod.py::HL010::f"
    monkeypatch.setitem(hostrules.HOST_WAIVERS, key, "obsolete reason")
    stale = hostrules.lint_host_files([str(p)])
    assert [f.rule for f in stale] == ["HL000"]
    assert "stale waiver" in stale[0].message
    p.write_text("def f(tracer=None):\n    if tracer:\n        pass\n")
    assert hostrules.lint_host_files([str(p)]) == []
    monkeypatch.setitem(hostrules.HOST_WAIVERS, key, "  ")
    bare = hostrules.lint_host_files([str(p)])
    assert [f.rule for f in bare] == ["HL000"]
    assert "no written reason" in bare[0].message


# ------------------------------ knobs -----------------------------------

_KNOB_RE = re.compile(r"\b(?:TAT_|TPU_AERIAL_)[A-Z0-9_]+")


def test_knob_registry_has_no_drift():
    """Every TAT_*/TPU_AERIAL_* token in the port, its tools and
    chip_smoke.py is registered (or a prefix passthrough), and every
    registered knob is read somewhere."""
    registry = os.path.join(PKG, "analysis", "knobs.py")
    # The JAX knobs the port has not, recorded as rows of NO_COUNTERPART's
    # KNOBS table in entrypoints.py, are named there and read nowhere.
    table = os.path.join(PKG, "analysis", "entrypoints.py")
    recorded = {k.split(":", 1)[1] for k in entrypoints.NO_COUNTERPART
                if k.startswith("KNOBS:")}
    seen: dict[str, set] = {}
    for path in list(linter.iter_py_files([PKG])) + [
            os.path.join(REPO, "chip_smoke.py")]:
        if os.path.abspath(path) == registry:
            continue
        with open(path, encoding="utf-8") as fh:
            for tok in _KNOB_RE.findall(fh.read()):
                if os.path.abspath(path) == table and tok in recorded:
                    continue
                seen.setdefault(tok, set()).add(os.path.relpath(path, REPO))
    unregistered = {t: sorted(p) for t, p in seen.items()
                    if t not in knobs.KNOBS
                    and t not in knobs.PREFIX_PASSTHROUGHS}
    assert not unregistered
    assert not set(knobs.KNOBS) - set(seen)
    for name, row in knobs.KNOBS.items():
        assert set(row) == {"resolver", "default", "doc"}, name
        assert os.path.exists(os.path.join(REPO, row["resolver"])), name
        assert name in open(os.path.join(REPO, row["resolver"]),
                            encoding="utf-8").read() or any(
            p in name for p in knobs.PREFIX_PASSTHROUGHS), name


def test_readme_carries_the_generated_knob_table():
    with open(os.path.join(REPO, "README.md"), encoding="utf-8") as fh:
        assert knobs.readme_table() in fh.read()


# ------------------------------- CLI ------------------------------------

def _cli(*args, cwd=REPO):
    return subprocess.run([sys.executable, LINT, *args],
                          capture_output=True, text=True, cwd=cwd)


def test_cli_tiers_a_and_c_import_neither_torch_nor_jax():
    """Over a slice of the port each (the whole port is linted in
    process above): the run's interpreter never imports torch or jax."""
    for tier in (["tpu_aerial_transport_torch/analysis"],
                 ["--host", "tpu_aerial_transport_torch/tools"]):
        proc = _cli(*tier, "--assert-no-torch")
        assert proc.returncode == 0, proc.stdout + proc.stderr
        assert "clean (0 findings)" in proc.stdout


def test_cli_json_output_and_exit_codes(tmp_path):
    for name in TL_FIXTURES:
        _write(tmp_path, name)
    proc = _cli("--format", "json", str(tmp_path))
    assert proc.returncode == 1, proc.stderr
    payload = json.loads(proc.stdout)
    assert payload["rules"] == sorted(rules.RULES)
    assert payload["errors"] > 0 and payload["warnings"] == 1  # TL011.
    assert {f["rule"] for f in payload["findings"]} == set(rules.RULES)
    only_warn = _cli("--disable", ",".join(set(rules.RULES) - {"TL011"}),
                     str(tmp_path))
    assert only_warn.returncode == 0
    assert _cli("--strict-warn", "--disable",
                ",".join(set(rules.RULES) - {"TL011"}),
                str(tmp_path)).returncode == 1
    host = _cli("--host", "--format", "json", HL_FIXTURES)
    assert host.returncode == 1
    hp = json.loads(host.stdout)
    assert hp["rules"] == sorted(hostrules.HOST_RULES)
    assert {f["rule"] for f in hp["findings"]} == set(hostrules.HOST_RULES)
    # Tier B from the CLI: the registry's contracts on the CPU.
    tier_b = _cli("--contracts", "--only", "ops.socp:solve_socp",
                  "--device", "cpu", os.path.join(PKG, "native"))
    assert tier_b.returncode == 0, tier_b.stdout + tier_b.stderr
    assert _cli("--contracts", "--only", "no.such:entry").returncode == 1
    listed = _cli("--list-rules")
    assert listed.returncode == 0
    for rid in list(rules.RULES) + list(hostrules.HOST_RULES):
        assert rid in listed.stdout


# ----------------------------- the tables -------------------------------

def _jax_entrypoints():
    spec = importlib.util.spec_from_file_location(
        "_jax_entrypoints", os.path.join(
            REPO, "tpu_aerial_transport", "analysis", "entrypoints.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_hot_table_holds_every_jax_counterpart():
    """Every JAX TRACED_FUNCTIONS row is in HOT_FUNCTIONS at the port's
    path (the ring's two kernel names map to the port's wrapper and plain
    version) or in NO_COUNTERPART with a reason; every name exists as a
    top-level function of its module."""
    import ast

    jx = _jax_entrypoints()
    renamed = {"_pallas_ring_allreduce": "ring_sum_shards",
               "_ring_sum_kernel": "ring_sum_shards_reference"}
    for path, names in jx.TRACED_FUNCTIONS.items():
        port = path.replace("tpu_aerial_transport/",
                            "tpu_aerial_transport_torch/")
        for name in names:
            key = f"TRACED_FUNCTIONS:{path}:{name}"
            if key in entrypoints.NO_COUNTERPART:
                continue
            assert renamed.get(name, name) in entrypoints.HOT_FUNCTIONS[
                port], (port, name)
    for path, names in entrypoints.HOT_FUNCTIONS.items():
        with open(os.path.join(REPO, path), encoding="utf-8") as fh:
            tree = ast.parse(fh.read())
        top = {n.name for n in tree.body if isinstance(n, ast.FunctionDef)}
        assert set(names) <= top, (path, set(names) - top)
    assert set(entrypoints.CONTRACT_ENTRYPOINTS) == set(
        jx.CONTRACT_ENTRYPOINTS)
    for key in jx.HOT_NON_ENTRYPOINTS:
        port = key.replace("tpu_aerial_transport/",
                           "tpu_aerial_transport_torch/")
        assert port in entrypoints.HOT_NON_ENTRYPOINTS, key


def test_donation_table_holds_every_jax_counterpart():
    jx = _jax_entrypoints()
    for name, minimum in jx.DONATION_CONTRACTS.items():
        if f"DONATION_CONTRACTS:{name}" in entrypoints.NO_COUNTERPART:
            assert name not in entrypoints.DONATION_CONTRACTS
            continue
        assert entrypoints.DONATION_CONTRACTS[name] == minimum, name
    # No registered entry donates: an eager call returns new tensors.
    assert entrypoints.DONATION_CONTRACTS == {}
    for key, reason in entrypoints.NO_COUNTERPART.items():
        assert len(reason) >= 40, key
