"""Nothing a run loads is JAX or the JAX package, and a run without a card
prints no result. Subprocesses: the root ``conftest.py`` imports JAX into
the test process."""

from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest

from port_bench.tests.conftest import CELLS, REPO, copy_bench

SETUP = """
import json, sys
sys.path.insert(0, {repo!r})
from port_bench import harness
cell = harness.Cell({cell!r}, {root!r}, {bench!r})
drv = cell.driver.build(cell.config, cell.traffic, 3, "cpu")
drv.warm_up(1)
drv.step()
drv.free()
drv.check()
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


@pytest.mark.parametrize("workload", CELLS)
def test_setup_and_check_load_no_jax(tmp_path, workload):
    bench = copy_bench(str(tmp_path))
    code = SETUP.format(repo=REPO, cell=workload, root=str(tmp_path),
                        bench=bench)
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, cwd=str(tmp_path), timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    top = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "tpu_aerial_transport_torch" in top
    assert not top & {"jax", "jaxlib", "flax", "tpu_aerial_transport"}


def test_reference_loads_nothing_of_the_program():
    code = ("import json, sys; import port_bench.reference.controllers, "
            "port_bench.traffic.generator, port_bench.trace, "
            "port_bench.yardstick; print(json.dumps(sorted({m.split('.')[0] "
            "for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=REPO, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    top = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert not top & {"jax", "jaxlib", "flax", "tpu_aerial_transport",
                      "tpu_aerial_transport_torch"}


def test_no_card_no_result():
    out = subprocess.run(
        [sys.executable, "-m", "port_bench.run", "--workload", CELLS[0],
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, cwd=REPO, timeout=300,
        env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert out.returncode != 0
    assert out.stdout.strip() == ""


def test_bench_files_alone_no_result(tmp_path):
    """In a directory with only ``BENCHMARK.json`` and ``port_bench/``."""
    copy_bench(str(tmp_path))
    out = subprocess.run(
        [sys.executable, "-m", "port_bench.run", "--workload", CELLS[0],
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, cwd=str(tmp_path), timeout=300,
        env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"})
    assert out.returncode != 0
    assert out.stdout.strip() == ""
