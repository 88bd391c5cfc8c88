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
- ``harness/diff.py tune_gains`` (SGD, the grad-tuning example's problem
  at n = 8) replayed from its CUDA graph against ``graph=False``: the
  histories and best gains bitwise equal (the same kernels on the same
  inputs), one capture and ``iters + 1`` replays.
- One served chunk of each canonical serving family (``cadmm4``: the
  warp body; ``centralized4``: the block body) through ``ScenarioServer``
  on the card: the whole-solve kernel launched from the server's own
  dispatch, and on the inputs captured there it agrees with its plain
  version at the same bar (the early-exit form on the lanes whose
  effective counts agree, counts equal on all but at most one lane, one
  chunk apart at most).
- A real ``torch.OutOfMemoryError``, from asking for more memory than the
  card has, classifies as ``oom`` and leaves the process usable.
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


@pytest.fixture
def cuda_device():
    """The card, or a skip: a CUDA graph has no CPU form."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: a CUDA graph has no CPU form")
    return torch.device("cuda")


@pytest.mark.cuda
def test_descent_graph_bitwise_eager(cuda_device):
    """Three SGD iterations of the grad-tuning example's problem (n = 8, 5
    MPC steps) from its CUDA graph and eagerly: bitwise equal."""
    from tpu_aerial_transport_torch import convert
    from tpu_aerial_transport_torch.examples import grad_tuning
    from tpu_aerial_transport_torch.harness import diff

    loss, state0 = grad_tuning.problem(8, 5, cuda_device)
    gains0 = convert.gains(grad_tuning.DETUNED, cuda_device)
    before = dict(diff.GRAPH_COUNTS)
    d = diff.Descent(loss, gains0, state0, lr=0.05)
    d.capture()
    best_g, hist_g = d.run(3)
    counts = {k: diff.GRAPH_COUNTS[k] - before[k] for k in before}
    best_e, hist_e = diff.tune_gains(loss, gains0, state0, lr=0.05, iters=3,
                                     graph=False)
    assert counts == {"captures": 1, "replays": 4}
    assert torch.equal(hist_g, hist_e) and bool(torch.isfinite(hist_g).all())
    assert all(torch.equal(best_g[k], best_e[k]) for k in best_e)


def _bar_ok(got, ref, ref64, lanes):
    """Each output within max(1e-4 max(1, |ref|), 2 x the plain version's
    own float32 rounding against float64), on ``lanes``."""
    for g, r, r64 in zip(got, ref, ref64):
        g, r, r64 = g[lanes], r[lanes], r64[lanes]
        if not g.numel():
            continue
        noise = float((r.double() - r64).abs().max())
        bar = max(1e-4 * max(1.0, float(r.abs().max())), 2.0 * noise)
        if not (float((g - r).abs().max()) <= bar
                and bool(torch.isfinite(g).all())):
            return False
    return True


@pytest.mark.cuda
@pytest.mark.parametrize("family,body", [("cadmm4", "warp_"),
                                         ("centralized4", "fused_")])
def test_served_chunk_kernel_matches_plain(card, monkeypatch, family, body):
    """One served chunk of ``family`` (4 requests, bucket 4) launches the
    whole-solve kernel's expected body from the server's dispatch, on the
    card's rung; the kernel on the captured inputs agrees with its plain
    version."""
    from tpu_aerial_transport_torch.ops import admm_kernel
    from tpu_aerial_transport_torch.serving import server
    from tpu_aerial_transport_torch.serving.queue import ScenarioRequest

    calls = []
    launch = admm_kernel.fused_solve_lanes

    def record(*args, **kw):
        if not calls:
            calls.append(([None if a is None else a.clone() for a in args],
                          dict(kw)))
        return launch(*args, **kw)

    monkeypatch.setattr(admm_kernel, "fused_solve_lanes", record)
    srv = server.ScenarioServer(families=[family], buckets=(4,),
                                device=card)
    for k in admm_kernel.KERNEL_LAUNCHES:
        admm_kernel.KERNEL_LAUNCHES[k] = 0
    tickets = [srv.submit(ScenarioRequest(
        family=family, horizon=2, x0=(0.2 * i, 0.1, 1.0),
        request_id=f"k{i}")) for i in range(4)]
    while srv.pump():
        pass
    assert all(t.status == "completed" for t in tickets)
    assert srv.stats()["dispatch_rungs"] == {"on-chip": 1}
    launched = {k: v for k, v in admm_kernel.KERNEL_LAUNCHES.items() if v}
    assert launched and all(k.startswith(body) for k in launched), launched
    (args, kw), = calls
    got = launch(*args, **kw)
    ref = admm_kernel.fused_solve_lanes_reference(*args, **kw)
    ref64 = admm_kernel.fused_solve_lanes_reference(
        *[a.double() if a is not None and a.is_floating_point() else a
          for a in args], **kw)
    lanes = torch.ones(args[0].shape[0], dtype=torch.bool, device=card)
    if len(got) == 6:  # the early-exit form: counts, then the equal lanes.
        lanes = got[5] == ref[5]
        assert int((~lanes).sum()) <= 1
        assert int((got[5] - ref[5]).abs().max()) <= kw["check_every"]
    assert _bar_ok(got[:5], ref[:5], ref64[:5], lanes)


@pytest.mark.cuda
def test_real_oom_classifies_as_oom(card):
    """Asking for more than the card's memory raises
    ``torch.OutOfMemoryError``, which the guard classifies ``oom``; the
    process stays usable (a non-sticky error)."""
    from tpu_aerial_transport_torch.resilience import backend

    total = torch.cuda.get_device_properties(card).total_memory
    with pytest.raises(torch.OutOfMemoryError) as e:
        torch.empty(2 * total, dtype=torch.uint8, device=card)
    assert backend.classify(e.value) == "oom"
    torch.cuda.empty_cache()
    x = torch.ones(1024, device=card)
    assert float((x @ x).item()) == 1024.0
