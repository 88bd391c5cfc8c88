"""Shared set-up of the benchmark's own tests: a copy of the benchmark
(``BENCHMARK.json`` and ``port_bench/``) in a temporary directory, its
cells cut to a few scenarios so that a run fits the CPU."""

from __future__ import annotations

import json
import os
import shutil

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CELLS = ("rqp-cadmm-n8.forest-mc", "rqp-centralized-n4.forest-mc")
SMALL_S = 4


def copy_bench(dst: str, scenarios: int = SMALL_S) -> str:
    """``BENCHMARK.json`` and ``port_bench/`` under ``dst``, every
    configuration at ``scenarios``; returns the copy's ``port_bench``."""
    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), dst)
    bench = os.path.join(dst, "port_bench")
    shutil.copytree(os.path.join(REPO, "port_bench"), bench,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    cdir = os.path.join(bench, "configs")
    for f in os.listdir(cdir):
        path = os.path.join(cdir, f)
        with open(path, encoding="utf-8") as fh:
            cfg = json.load(fh)
        cfg["scenarios"] = scenarios
        with open(path, "w", encoding="utf-8") as fh:
            json.dump(cfg, fh)
    return bench


@pytest.fixture
def small_bench(tmp_path):
    """``(root, bench_dir)`` of a small copy of the benchmark."""
    return str(tmp_path), copy_bench(str(tmp_path))


def run_cell(root, bench, workload, *, seed=2**31 + 5, seconds=0.5,
             trace=False, patch=None):
    """One CPU run of ``workload`` in the copy: ``(exit code, the result
    line as a dict, the standard error's text)``."""
    import io

    from port_bench import harness

    out, err = io.StringIO(), io.StringIO()
    rc = harness.run(workload, seed, seconds, trace, device="cpu", root=root,
                     bench_dir=bench, check_imports=False, patch=patch,
                     out=out, err=err)
    lines = out.getvalue().strip().splitlines()
    return rc, (json.loads(lines[-1]) if lines else None), err.getvalue()
