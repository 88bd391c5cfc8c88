"""The benchmark's frozen copies equal the port's functions today, at the
cells' shapes: the kernel counts, the peaks, the tracking law, the world
and start generators. Drift in the port shows here; the yardstick stays."""

from __future__ import annotations

import os
import re

import numpy as np
import pytest
import torch

from port_bench import yardstick
from port_bench.tests.conftest import REPO
from port_bench.traffic import generator

# (nv, m, n_box, soc_dims, iters) of the cells' solves: the Schur-reduced
# agent QP (raw and padded) and the centralized QP at n = 4.
SHAPES = [(12, 25, 17, (4, 4), 20), (16, 32, 24, (4, 4), 20),
          (21, 58, 26, (4,) * 8, 120), (21, 58, 26, (4,) * 8, 25)]


@pytest.mark.parametrize("nv,m,n_box,soc,iters", SHAPES)
def test_counts_are_the_ports(nv, m, n_box, soc, iters):
    from tpu_aerial_transport_torch.ops import admm_kernel as ak

    for early in (False, True):
        for gated in (False, True):
            assert yardstick.fused_solve_bytes_per_lane(
                nv, m, n_box, early=early, gated_off=gated) == \
                ak.fused_solve_bytes_per_lane(nv, m, n_box, early=early,
                                              gated_off=gated)
    for checks in (0, 1, 5):
        for build in (False, True):
            assert yardstick.fused_solve_flops_per_lane(
                nv, m, iters, soc, checks, build) == \
                ak.fused_solve_flops_per_lane(nv, m, iters, soc, checks,
                                              build)
    assert yardstick._iter_flops(nv, m, soc) == ak._iter_flops(nv, m, soc)
    assert yardstick._residual_flops(nv, m) == ak._residual_flops(nv, m)


def test_peaks_are_the_smokes():
    with open(os.path.join(REPO, "chip_smoke.py"), encoding="utf-8") as fh:
        text = fh.read()
    for name in ("PEAK_BYTES_S", "PEAK_F32_FLOP_S"):
        value = float(re.search(rf"^{name} = (\S+)$", text, re.M).group(1))
        assert getattr(yardstick, name) == value


@pytest.mark.parametrize("seed", [0, 7, 2**31 + 11])
def test_world_is_the_ports(seed):
    from tpu_aerial_transport_torch.envs import forest

    rng = np.random.default_rng(seed)
    pos3, num = generator.world_from_rng(
        {"kind": "mountain_forest", "max_trees": 200, "min_spacing": 3.2},
        rng)
    port = forest.make_forest(seed, device="cpu")
    assert num == int(port.num_trees)
    assert torch.equal(torch.as_tensor(pos3, dtype=torch.float32),
                       port.tree_pos)


def test_starts_are_the_ports():
    from tpu_aerial_transport_torch.harness import rollout, setup

    _, _, state0 = setup.rqp_setup(8, device="cpu")
    port = rollout.scenario_batch(state0, 64)
    xl, vl = generator.starts_from_rng(
        {"mean": [5.0, 0.0, 2.0], "std": 2.0, "velocity": [0.5, 0.0, 0.0]},
        np.random.default_rng(0), 64)
    assert torch.equal(torch.as_tensor(xl, dtype=torch.float32), port.xl)
    assert torch.equal(torch.as_tensor(vl, dtype=torch.float32), port.vl)


def test_tracking_law_is_the_ports():
    from tpu_aerial_transport_torch.envs import forest
    from tpu_aerial_transport_torch.harness import rollout, setup

    world = forest.make_forest(0, device="cpu")
    _, _, state0 = setup.rqp_setup(8, device="cpu")
    g = torch.Generator().manual_seed(1)
    xl = torch.rand((256, 3), generator=g) * 40.0 + torch.tensor(
        [5.0, -20.0, 0.0])
    vl = torch.randn((256, 3), generator=g)
    states = rollout.stack_scenarios(state0, 256).replace(xl=xl, vl=vl)
    port = rollout.make_forest_acc_des(world)(states, 0.0)
    law = generator.make_command(
        {"kind": "terrain_following", "lookahead": 1.5, "clearance": 1.5,
         "v_ref": [0.5, 0.0, 0.0], "max_acc": 1.0}, "cpu")
    mine = law(xl, vl)
    for a, b in zip(torch.utils._pytree.tree_leaves(mine),
                    torch.utils._pytree.tree_leaves(port)):
        assert torch.equal(a, b)
