"""Tests of the port that need an NVIDIA card (marked ``cuda``): the CUDA
kernels have no CPU form, so without a card each test skips with its
reason. On a card run them with ``python -m pytest --noconftest -m cuda
tests/test_torch_card.py`` (they build the kernels first). This file
imports torch and the port only, no JAX, and ``--noconftest`` skips the
repository's conftest files, which configure JAX: a card's machine may
have none.

- The whole-solve kernel's shared-memory body at the RP centralized QP at
  n = 8 (d = 111, 150 iterations, 256 lanes) against its plain version:
  every output within the smoke's kernel bar, max(1e-4 max(1, |ref|), 2 x
  the plain version's own float32 rounding against float64).
"""

import numpy as np
import pytest
import torch

from tpu_aerial_transport_torch.control import rp_centralized
from tpu_aerial_transport_torch.harness import rollout, setup

ACC = ((0.3, 0.0, 0.1), (0.0, 0.0, 0.05))


def _t(a, device):
    return torch.as_tensor(np.asarray(a, np.float32), device=device)


@pytest.fixture
def card():
    """The card with the kernels built, or a skip: a CUDA kernel has no
    CPU form."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU form")
    from tpu_aerial_transport_torch.ops import _build

    _build.build()
    return torch.device("cuda")


@pytest.mark.cuda
def test_shared_body_rounding_at_d111(card, monkeypatch):
    """The kernel's one-block-a-lane body on the RP centralized QP at n = 8
    (d = 111, 150 iterations, 256 lanes) rounds no farther from its plain
    version than the smoke's kernel bar allows: a single FMA chain a K2
    row missed it on the duals of the 1e3-boosted equality rows."""
    from tpu_aerial_transport_torch.ops import admm_kernel

    S = 256
    params, _, state0 = setup.rp_setup(8, device=card)
    rng = np.random.default_rng(0)
    states = rollout.stack_scenarios(state0, S).replace(
        vl=_t(rng.normal(size=(S, 3)) * 0.15, card),
        wl=_t(rng.normal(size=(S, 3)) * 0.05, card))
    cfg = rp_centralized.make_config(params)
    f_eq = rp_centralized.equilibrium_forces(params)
    calls = []
    launch = admm_kernel.fused_solve_lanes

    def record(*args, **kw):
        calls.append(([None if a is None else a.clone() for a in args], kw))
        return launch(*args, **kw)

    monkeypatch.setattr(admm_kernel, "fused_solve_lanes", record)
    rp_centralized.control(
        params, cfg, f_eq, rollout.stack_scenarios(
            rp_centralized.init_ctrl_state(params, cfg), S), states,
        tuple(_t(a, card) for a in ACC))
    (args, kw), = calls
    assert args[8].shape[-1] + kw["nv"] == 111
    got = launch(*args, **kw)
    ref = admm_kernel.fused_solve_lanes_reference(*args, **kw)
    ref64 = admm_kernel.fused_solve_lanes_reference(
        *[a.double() if a is not None else None for a in args], **kw)
    for g, r, r64 in zip(got, ref, ref64):
        noise = float((r.double() - r64).abs().max())
        bar = max(1e-4 * max(1.0, float(r.abs().max())), 2.0 * noise)
        assert float((g - r).abs().max()) <= bar
