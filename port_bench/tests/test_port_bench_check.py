"""The comparison that decides ``correct``: the reference agrees with the
port's plain path, the TF32 control fails the cells' limits, and a run
with the timed path broken underneath comes out not correct."""

from __future__ import annotations

import json
import os

import pytest
import torch

from port_bench import harness
from port_bench.tests.conftest import CELLS, REPO, run_cell


def small_driver(bench_dir, workload, seed=41, steps=3):
    cell = harness.Cell(workload, os.path.dirname(bench_dir), bench_dir)
    drv = cell.driver.build(cell.config, cell.traffic, seed, "cpu")
    drv.warm_up(1)
    drv.sample_steps = list(range(steps))
    while drv.k < steps:
        drv.step()
    return cell, drv


@pytest.mark.parametrize("workload", CELLS)
def test_reference_is_the_ports_plain_path(small_bench, workload):
    """On the CPU the port runs its kernels' plain versions: the same
    float32 arithmetic as the reference, at three steps from a start."""
    _, bench_dir = small_bench
    cell, drv = small_driver(bench_dir, workload)
    gaps = drv.check()
    assert bool(gaps["same"].all())
    for key in ("force", "carry", "env", "state"):
        assert float(gaps[key].max()) <= 1e-5, key


@pytest.mark.parametrize("workload", CELLS)
def test_control_fails_the_limits(small_bench, workload):
    """The reference with TF32 products in the program's place."""
    _, bench_dir = small_bench
    cell, drv = small_driver(bench_dir, workload)
    with open(os.path.join(REPO, "port_bench", "configs",
                           cell.entry["config"] + ".json"),
              encoding="utf-8") as fh:
        limits = json.load(fh)["limits"]
    _, n_bad = harness.judge(drv.check(tf32_control=True), limits)
    assert n_bad > 0
    _, n_bad = harness.judge(drv.check(), limits)
    assert n_bad == 0


def state_unchanged(drv):
    drv.substeps = lambda states, f_des: states


def half_batch(drv):
    control = drv.ctl.control
    S = drv.S

    def first_half(css, states, acc_des):
        f, css_new, stats = control(css, states, acc_des)
        f = torch.cat([f[:S // 2], f[:S // 2]])
        return f, css_new, stats

    drv.ctl = drv.ctl._replace(control=first_half)


def answer_altered(drv):
    control = drv.ctl.control

    def altered(css, states, acc_des):
        f, css_new, stats = control(css, states, acc_des)
        f = f.clone()
        f[-1, 0, 2] += 0.05
        return f, css_new, stats

    drv.ctl = drv.ctl._replace(control=altered)


@pytest.mark.parametrize("fault", [state_unchanged, half_batch,
                                   answer_altered])
@pytest.mark.parametrize("workload", CELLS)
def test_broken_step_is_not_correct(small_bench, workload, fault):
    root, bench_dir = small_bench
    rc, res, err = run_cell(root, bench_dir, workload, patch=fault)
    assert rc == 0
    assert res["correct"] is False and res["failed"] > 0


@pytest.mark.parametrize("workload", CELLS)
def test_sound_run_is_correct(small_bench, workload):
    root, bench_dir = small_bench
    rc, res, _ = run_cell(root, bench_dir, workload)
    assert rc == 0 and res["correct"] is True


@pytest.mark.cuda
@pytest.mark.parametrize("workload", CELLS)
def test_cell_on_the_card(tmp_path, workload):
    """A short run of each cell on the card at 256 scenarios."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    from port_bench.tests.conftest import copy_bench
    bench_dir = copy_bench(str(tmp_path), scenarios=256)
    rc, res, _ = run_cell(str(tmp_path), bench_dir, workload, seconds=2.0)
    assert rc == 0 and res["correct"] is True
