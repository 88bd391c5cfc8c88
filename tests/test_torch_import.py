"""Import hygiene of the PyTorch port: it never imports JAX, flax or the JAX
package, and its entry points never fall back to the CPU on their own."""

import json
import os
import pkgutil
import re
import subprocess
import sys

import pytest
import torch

import tpu_aerial_transport_torch
from tpu_aerial_transport_torch import entry
from tpu_aerial_transport_torch.control import (
    cadmm,
    centralized,
    dd,
    lowlevel,
    pmrl_centralized,
    rp_cadmm,
    rp_centralized,
    types,
)
from tpu_aerial_transport_torch.envs import forest, spatial
from tpu_aerial_transport_torch.harness import (
    checkpoint,
    cuda_graph,
    rollout,
    setup,
)
from tpu_aerial_transport_torch.obs import telemetry
from tpu_aerial_transport_torch.ops import admm_kernel, lie, socp
from tpu_aerial_transport_torch.parallel import ring
from tpu_aerial_transport_torch.resilience import faults, prng, recovery
from tpu_aerial_transport_torch.resilience import rollout as resilient
from tpu_aerial_transport_torch.tree import leaves

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "tpu_aerial_transport_torch")


def _modules():
    return sorted(
        m.name for m in pkgutil.walk_packages(
            tpu_aerial_transport_torch.__path__, "tpu_aerial_transport_torch."
        )
    )


def test_import_leaves_jax_out_of_sys_modules():
    """Every submodule imported in a fresh interpreter: no jax, no flax,
    nothing of the JAX package, and no matplotlib (the figures import it
    when they draw, so a host without it imports every module)."""
    mods = ["tpu_aerial_transport_torch"] + _modules()
    assert "tpu_aerial_transport_torch.ops.admm_kernel" in mods
    assert "tpu_aerial_transport_torch.control.dd" in mods
    for m in ("harness.bucketing", "harness.cuda_graph", "harness.rollout",
              "tree", "resilience.faults", "resilience.prng",
              "resilience.quarantine", "resilience.rollout",
              "obs.telemetry", "utils.stats", "harness.checkpoint",
              "obs.export", "obs.trace", "resilience.recovery", "models.rp",
              "models.pmrl", "control.rp_centralized", "control.rp_cadmm",
              "control.pmrl_centralized", "harness.diff",
              "examples.grad_tuning", "resilience.backend",
              "serving.queue", "serving.cache", "serving.lanes",
              "serving.batcher", "serving.server", "serving.sessions",
              "serving", "aot.loader", "examples.serve_scenarios",
              "examples.serve_sessions", "utils.geometry", "viz",
              "viz.plots", "viz.scene", "obs.live", "examples.rqp_forest",
              "examples.fault_injection", "examples.city_forest",
              "examples.convergence_rates", "examples.replay"):
        assert "tpu_aerial_transport_torch." + m in mods
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'tpu_aerial_transport', 'matplotlib'))\n"
        "print(repr(bad))\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True,
        text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]", out.stdout


# Import statements of jax/flax or of the JAX package (the package name not
# followed by ``_torch``), and dynamic imports naming either. Prose that
# names a module's JAX counterpart (``tpu_aerial_transport/ops/lie.py``) is
# not an import.
_REF = r"(jax|jaxlib|flax|tpu_aerial_transport(?!_torch))\b"
_FORBIDDEN = re.compile(
    rf"^\s*(import\s+[^#\n]*\b{_REF}|from\s+{_REF})"
    rf"|(import_module|__import__)\(\s*['\"]{_REF}",
    re.M,
)


def _sources():
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(PKG):
        files += [os.path.join(root, f) for f in names
                  if f.endswith((".py", ".cu", ".cuh"))]
    return sorted(files)


def test_source_scan_covers_the_slice():
    """The scan reaches every module and kernel source of the port,
    including the shared kernel header."""
    rel = {os.path.relpath(p, REPO) for p in _sources()}
    for f in ("control/centralized.py", "control/dd.py", "csrc/admm_chunk.cu",
              "csrc/admm_common.cuh", "csrc/fused_solve.cu",
              "csrc/ring_sum.cu", "entry.py", "harness/bucketing.py",
              "harness/cuda_graph.py", "harness/rollout.py",
              "ops/admm_kernel.py", "ops/socp.py", "parallel/mesh.py",
              "parallel/ring.py", "tree.py", "envs/spatial.py",
              "control/so3_tracking.py", "convert.py",
              "resilience/faults.py", "resilience/prng.py",
              "resilience/quarantine.py", "resilience/rollout.py",
              "obs/telemetry.py", "utils/stats.py", "harness/checkpoint.py",
              "obs/export.py", "obs/trace.py", "resilience/recovery.py",
              "models/rp.py", "models/pmrl.py", "control/rp_centralized.py",
              "control/rp_cadmm.py", "control/pmrl_centralized.py",
              "harness/setup.py", "harness/diff.py",
              "examples/grad_tuning.py", "resilience/backend.py",
              "serving/__init__.py", "serving/queue.py", "serving/cache.py",
              "serving/lanes.py", "serving/batcher.py", "serving/server.py",
              "serving/sessions.py", "aot/__init__.py", "aot/loader.py",
              "examples/serve_scenarios.py", "examples/serve_sessions.py",
              "utils/geometry.py", "viz/__init__.py", "viz/plots.py",
              "viz/scene.py", "obs/live.py", "examples/rqp_forest.py",
              "examples/fault_injection.py", "examples/city_forest.py",
              "examples/convergence_rates.py", "examples/replay.py"):
        assert os.path.join("tpu_aerial_transport_torch", f) in rel, f


@pytest.mark.parametrize("path", _sources(),
                         ids=lambda p: os.path.relpath(p, REPO))
def test_source_names_no_jax_or_reference_package(path):
    """Source scan: no ``import jax``/``from jax``/flax and no name of the
    JAX package (``tpu_aerial_transport`` not followed by ``_torch``)."""
    with open(path) as f:
        text = f.read()
    hits = [m.group(0).strip() for m in _FORBIDDEN.finditer(text)]
    assert not hits, hits


def test_entry_point_default_device_is_the_card():
    """Without ``device=`` an entry point targets the card: on a host with
    no CUDA device it raises instead of running on the CPU."""
    if torch.cuda.is_available():
        params, _, state = setup.rqp_setup(4)
        assert params.r.is_cuda and state.R.is_cuda
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        setup.rqp_setup(4)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        forest.make_forest(seed=0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        rollout.build(n=4, n_scenarios=2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        rollout.build(n=4, n_scenarios=2, buckets=2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        rollout.make_controller("cadmm", 4)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tpu_aerial_transport_torch.resolve_device()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        entry.entry()


def test_slice8_entry_points_default_to_the_card():
    """The city forest, the cone sampler and a controller on a given forest
    target the card unless asked for the CPU; a grid lives on its forest's
    device, and ``jit_control_step`` runs where its inputs are."""
    if torch.cuda.is_available():
        city = forest.make_forest(seed=0, max_trees=400, world_size=60.0)
        assert city.tree_pos.is_cuda
        assert spatial.with_grid(city, 6.3).grid.cell_idx.is_cuda
        assert lie.random_cone_vector(
            torch.Generator(device="cuda"), 0.3).is_cuda
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        forest.make_forest(seed=0, max_trees=400, world_size=60.0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        lie.random_cone_vector(torch.Generator(), 0.3)
    city = forest.make_forest(seed=0, max_trees=400, world_size=60.0,
                              device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        rollout.make_controller("cadmm", 4, forest=city)
    grid = spatial.with_grid(city, 6.3).grid
    assert not any(t.is_cuda for t in (grid.cell_idx, grid.cell_valid,
                                       grid.origin, grid.inv_cell))
    ctl = rollout.make_controller("cadmm", 4, max_iter=2, inner_iters=4,
                                  forest=spatial.with_grid(city, 6.3),
                                  device="cpu")
    assert ctl.forest.grid is not None
    params, col, state = setup.rqp_setup(4, device="cpu")
    cfg = cadmm.make_config(params, col.collision_radius,
                            col.max_deceleration, max_iter=2, inner_iters=4,
                            device="cpu")
    f_eq = centralized.equilibrium_forces(params)
    step = cadmm.jit_control_step(params, cfg, f_eq)
    out = step(rollout.stack_scenarios(
        cadmm.init_cadmm_state(params, cfg, f_eq), 1),
        rollout.stack_scenarios(state, 1), (torch.zeros(3), torch.zeros(3)))
    assert not out[0].is_cuda


def test_slice9_entry_points_default_to_the_card():
    """A fault schedule, a telemetry accumulator and the resilient rollout's
    controller target the card unless asked for the CPU; the schedule's
    draws run on its key's device."""
    if torch.cuda.is_available():
        assert faults.make_schedule(4).t_fail.is_cuda
        assert faults.no_faults(4).key.is_cuda
        assert telemetry.init_telemetry(telemetry.TelemetryConfig()
                                        ).steps.is_cuda
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        faults.make_schedule(4)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        faults.no_faults(4)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        telemetry.init_telemetry(telemetry.TelemetryConfig())
    sched = faults.make_schedule(4, drop_rate=0.5, device="cpu")
    assert not faults.fault_step(sched, 3).msg_ok.is_cuda
    assert not prng.bits32(prng.prng_key(0, device="cpu"), (3,)).is_cuda
    # The resilient rollout runs where its inputs are.
    params, col, state = setup.rqp_setup(4, device="cpu")
    cfg = cadmm.make_config(params, col.collision_radius,
                            col.max_deceleration, max_iter=2, inner_iters=4,
                            device="cpu")
    hl = resilient.make_cadmm_hl_step(params, cfg)
    ll = lowlevel.make_lowlevel_controller("pd", params)
    out = resilient.jit_resilient_rollout(
        hl, ll.control, params, n_hl_steps=1, faults=sched)(
        rollout.stack_scenarios(state, 1),
        rollout.stack_scenarios(cadmm.init_cadmm_state(params, cfg), 1))
    assert not out[0].xl.is_cuda and out[1].held is not None


def test_slice10_entry_points_default_to_the_card(tmp_path):
    """``prng_key`` targets the card unless asked for the CPU; the chunked
    rollout runs where its inputs are, and a resume restores a snapshot
    onto the devices of the carry it is given."""
    if torch.cuda.is_available():
        assert prng.prng_key(0).is_cuda
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        prng.prng_key(0)
    assert not prng.prng_key(0, device="cpu").is_cuda
    ctl = rollout.make_controller("cadmm", 4, max_iter=2, inner_iters=4,
                                  device="cpu")
    run = rollout.make_chunked_rollout(
        ctl.control, ctl.ll.control, ctl.params, n_hl_steps=2, n_chunks=2,
        acc_des_fn=rollout.make_forest_acc_des(ctl.forest))
    carry = run.init_carry(rollout.scenario_batch(ctl.state0, 1),
                           rollout.stack_scenarios(ctl.cs0, 1))
    plan = recovery.RunPlan(run_dir=str(tmp_path), n_hl_steps=2, n_chunks=2)
    res = recovery.run_chunks(plan, run.chunk_jit, carry)
    assert not res.logs.xl.is_cuda
    back, _, _ = checkpoint.load_latest_valid(
        str(tmp_path), carry, prefix=recovery.CARRY_PREFIX)
    assert not any(t.is_cuda for t in leaves(back))


def test_slice11_entry_points_default_to_the_card():
    """The RP and PMRL parameters, states and set-ups, and the controllers'
    initial states built from them, target the card unless asked for the
    CPU; the controllers run where their inputs are."""
    from tpu_aerial_transport_torch.models import pmrl, rp

    if torch.cuda.is_available():
        rp_p, _, rp_s = setup.rp_setup(8)
        pm_p, _, pm_s = setup.pmrl_setup(8)
        assert rp_p.r.is_cuda and rp_s.Rl.is_cuda and pm_p.L.is_cuda
        assert pm_s.q.is_cuda and rp.rp_identity_state().xl.is_cuda
        return
    for fn in (lambda: setup.rp_setup(4), lambda: setup.pmrl_setup(4),
               lambda: rp.rp_params(0.2, torch.eye(3), torch.ones(3, 3)),
               lambda: rp.rp_state(torch.zeros(3), torch.zeros(3),
                                   torch.eye(3), torch.zeros(3)),
               lambda: rp.rp_identity_state(),
               lambda: pmrl.pmrl_params(torch.ones(3), 0.2, torch.eye(3),
                                        torch.ones(3, 3), torch.ones(3)),
               lambda: pmrl.pmrl_state(torch.ones(3, 3), torch.zeros(3, 3),
                                       torch.zeros(3), torch.zeros(3),
                                       torch.eye(3), torch.zeros(3))):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            fn()
    rp_p, _, rp_s = setup.rp_setup(4, device="cpu")
    pm_p, _, pm_s = setup.pmrl_setup(4, device="cpu")
    f_eq = rp_centralized.equilibrium_forces(rp_p)
    c_cfg = rp_centralized.make_config(rp_p)
    d_cfg = rp_cadmm.make_config(rp_p, max_iter=2, inner_iters=4)
    p_cfg = pmrl_centralized.make_config(pm_p, solver_iters=25)
    for cs in (rp_centralized.init_ctrl_state(rp_p, c_cfg),
               rp_cadmm.init_state(rp_p, d_cfg, f_eq),
               pmrl_centralized.init_ctrl_state(pm_p, p_cfg, pm_s)):
        assert not any(t.is_cuda for t in leaves(cs))
    acc = (torch.zeros(3), torch.zeros(3))
    f, _, _ = rp_cadmm.control(
        rp_p, d_cfg, f_eq, rollout.stack_scenarios(
            rp_cadmm.init_state(rp_p, d_cfg, f_eq), 1),
        rollout.stack_scenarios(rp_s, 1), acc)
    assert not f.is_cuda and bool(torch.isfinite(f).all())


def test_slice12_entry_points_default_to_the_card():
    """The grad-tuning example's problem and ``convert.gains`` target the
    card unless asked for the CPU; the differentiable harness runs where
    its state is."""
    from tpu_aerial_transport_torch import convert
    from tpu_aerial_transport_torch.examples import grad_tuning
    from tpu_aerial_transport_torch.harness import diff

    if torch.cuda.is_available():
        assert convert.gains({"k_R": 0.25})["k_R"].is_cuda
        assert grad_tuning.problem(3, 1)[1].R.is_cuda
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        convert.gains({"k_R": 0.25})
    with pytest.raises(RuntimeError, match="device='cpu'"):
        grad_tuning.problem(3, 1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        grad_tuning.main(["--steps", "1", "--iters", "1"])
    loss, state0 = grad_tuning.problem(3, 1, device="cpu")
    best, hist = diff.tune_gains(loss, convert.gains(
        grad_tuning.DETUNED, device="cpu"), state0, iters=1)
    assert not hist.is_cuda and not best["k_R"].is_cuda


def test_slice13_entry_points_default_to_the_card(capsys):
    """The serving tier's entry points -- a family, the server, both
    example scripts -- target the card unless asked for the CPU; the
    guard's CPU rung is never a stand-in for a missing card."""
    from tpu_aerial_transport_torch.examples import (
        serve_scenarios,
        serve_sessions,
    )
    from tpu_aerial_transport_torch.serving import batcher, server

    if torch.cuda.is_available():
        assert batcher.make_family("cadmm4").device.type == "cuda"
        return
    for fn in (lambda: batcher.make_family("cadmm4"),
               lambda: server.ScenarioServer(),
               lambda: serve_scenarios.main(["--requests", "2"]),
               lambda: serve_sessions.main(["--clients", "1"])):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            fn()
    assert serve_scenarios.main(["--requests", "6", "--buckets", "2,4",
                                 "--device", "cpu"]) == 0
    assert serve_sessions.main(["--clients", "2", "--steps", "2",
                                "--buckets", "2,4", "--offline-check",
                                "--device", "cpu"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    first, second = (json.loads(line) for line in lines[-2:])
    assert first["completed"] == 6 and first["device"] == "cpu"
    assert second["offline_check"]["mismatches"] == []
    assert second["offline_check"]["checked"] == 4


def test_inactive_env_cbf_defaults_to_the_card():
    """The no-environment CBF rows are built on the card unless the caller
    asks for the CPU."""
    if torch.cuda.is_available():
        assert types.inactive_env_cbf(3, 5.0, 0.1, 1.5).lhs.is_cuda
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        types.inactive_env_cbf(3, 5.0, 0.1, 1.5)
    cbf = types.inactive_env_cbf(3, 5.0, 0.1, 1.5, device="cpu")
    assert cbf.lhs.shape == (3, 3) and not cbf.lhs.is_cuda


def _cfg(**kw):
    params, col, _ = setup.rqp_setup(8, device="cpu")
    return cadmm.make_config(params, col.collision_radius,
                             col.max_deceleration, device="cpu", **kw)


@pytest.mark.parametrize("kw", [
    dict(tau_incr=1.5), dict(socp_precision="bf16"),
    dict(env_query="bucketed"), dict(reduced_qp=False),
    dict(inner_iters_warm=5),
], ids=lambda kw: next(iter(kw)))
def test_left_out_options_raise(kw):
    """The options the port has taken up (the rho schedule, bf16 storage,
    the bucketed environment query, the full agent QP, the two-phase
    budget) build and hold their values; none of them is left out any
    more."""
    cfg = _cfg(**kw)
    for k, v in kw.items():
        assert getattr(cfg, k) == v
    assert cadmm._use_reduced(cfg, 8) == (kw != dict(reduced_qp=False))


@pytest.mark.parametrize("kw", [
    dict(effort="adaptive"), dict(inner_tol=1e-3),
    dict(socp_fused="pallas"), dict(socp_fused="kernel"),
], ids=lambda kw: f"{next(iter(kw))}={next(iter(kw.values()))}")
def test_ported_options_build(kw):
    """Adaptive effort, tolerance-chunked solves and both solve routes are
    ported: the configs build and hold the resolved values, for C-ADMM
    and for DD's shared base."""
    cfg = _cfg(**kw)
    params, col, _ = setup.rqp_setup(8, device="cpu")
    base = dd.make_config(params, col.collision_radius, col.max_deceleration,
                          device="cpu", **kw).base
    for c in (cfg, base):
        for k, v in kw.items():
            assert getattr(c, k) == v
        assert c.socp_fused in socp.ROUTES and c.effort in socp.EFFORTS


def test_resolve_effort_and_route(monkeypatch):
    """``effort="auto"`` follows TAT_EFFORT, else fixed; junk raises; the
    route "auto" is the whole-solve kernel, "scan" is a route of its own,
    and the JAX package's interpret modes have no counterpart here."""
    monkeypatch.delenv("TAT_EFFORT", raising=False)
    assert socp.resolve_effort("auto") == "fixed"
    assert socp.resolve_effort(None) == "fixed"
    monkeypatch.setenv("TAT_EFFORT", "adaptive")
    assert socp.resolve_effort("auto") == "adaptive"
    assert socp.resolve_effort("fixed") == "fixed"
    assert _cfg().effort == "adaptive"
    monkeypatch.setenv("TAT_EFFORT", "lazy")
    with pytest.raises(ValueError):
        socp.resolve_effort("auto")
    with pytest.raises(ValueError):
        socp.resolve_effort("turbo")
    assert socp.resolve_route("auto") == "kernel"
    assert socp.resolve_route("scan") == "scan"
    for mode in ("interpret", "kernel_interpret", "reference"):
        with pytest.raises(ValueError, match="socp_fused"):
            socp.resolve_route(mode)


def test_left_out_call_paths_raise():
    """No call path of the slice is left out: fault-aware control
    (``health=``, C-ADMM and DD), the SM law, the bucketed query, n = 3
    C-ADMM, bf16 solves, the centralized rollout and agent sharding run,
    and a world above 200 slots without a grid is the JAX package's
    ValueError; junk option values are ValueErrors."""
    params, col, state = setup.rqp_setup(4, device="cpu")
    params3 = setup.rqp_setup(3, device="cpu")[0]
    cfg3 = cadmm.make_config(params3, col.collision_radius,
                             col.max_deceleration, device="cpu")
    assert not cadmm._use_reduced(cfg3, 3) and cadmm.make_plan(
        params3, cfg3) is None
    sm = lowlevel.make_lowlevel_controller("sm", params)
    f, M = sm.control(state, torch.full((4, 3), 1.0))
    assert torch.isfinite(f).all() and torch.isfinite(M).all()
    with pytest.raises(ValueError, match="'pd' or 'sm'"):
        lowlevel.make_lowlevel_controller("lqr", params)
    big = forest.make_forest(seed=0, max_trees=201, device="cpu")
    with pytest.raises(ValueError, match="no spatial grid"):
        spatial.runtime_env_query("auto", big)
    gridded = spatial.with_grid(big, 6.3)
    assert spatial.runtime_env_query("auto", gridded) == "bucketed"
    x = torch.zeros((2, 4))
    eye = torch.eye(4).expand(2, 4, 4)
    sol = socp.solve_socp(eye, x, eye, -torch.ones(2, 4), torch.ones(2, 4),
                          n_box=4, iters=5, precision="bf16")
    assert torch.isfinite(sol.x).all()
    # Fault-aware control runs: agent 1 dead, agent 2 dropped.
    health = faults.FaultStep(
        alive=torch.tensor([[True, False, True, True]]),
        thrust_scale=torch.tensor([[1.0, 0.0, 1.0, 1.0]]),
        msg_ok=torch.tensor([[True, False, False, True]]))
    f_eq = centralized.equilibrium_forces(params, health.alive)
    acc = (torch.zeros(3), torch.zeros(3))
    c_cfg = cadmm.make_config(params, col.collision_radius,
                              col.max_deceleration, max_iter=3,
                              inner_iters=5, device="cpu")
    c_cs = rollout.stack_scenarios(cadmm.init_cadmm_state(params, c_cfg), 1)
    dd_cfg = dd.make_config(params, col.collision_radius,
                            col.max_deceleration, device="cpu")
    dd_cs = rollout.stack_scenarios(dd.init_dd_state(params, dd_cfg), 1)
    states1 = rollout.stack_scenarios(state, 1)
    for mod, cfg_h, cs_h in ((cadmm, c_cfg, c_cs), (dd, dd_cfg, dd_cs)):
        f_h, _, _ = mod.control(params, cfg_h, f_eq, cs_h, states1, acc,
                                health=health)
        assert torch.isfinite(f_h).all() and torch.all(f_h[0, 1] == 0.0)
    # Agent sharding is ported: the shard count must divide n.
    with pytest.raises(ValueError, match="divide"):
        dd.control(params, dd_cfg, dd_cs.f[0], dd_cs,
                   rollout.stack_scenarios(state, 1), None, shards=3)
    step, cs0, st0 = rollout.make_mpc_step("centralized", 4, device="cpu")
    _, st1, stats = step(rollout.stack_scenarios(cs0, 2),
                         rollout.stack_scenarios(st0, 2))
    assert torch.isfinite(st1.xl).all() and stats.iters.tolist() == [-1, -1]
    with pytest.raises(ValueError, match="socp_fused"):
        _cfg(socp_fused="interpret")
    with pytest.raises(ValueError, match="precision"):
        _cfg(socp_precision="fp8")
    with pytest.raises(ValueError, match="precision"):
        socp.solve_socp(eye, x, eye, -torch.ones(2, 4), torch.ones(2, 4),
                        n_box=4, precision="fp8")
    with pytest.raises(ValueError, match="tau_incr"):
        _cfg(tau_incr=0.5)
    with pytest.raises(ValueError, match="controller"):
        rollout.make_mpc_step("lqr", 4, device="cpu")


def test_kernel_wrapper_refuses_other_devices():
    """The kernel wrappers run the plain version, and the CUDA-graph
    replay the plain calls, only for CPU tensors; any other device is the
    kernel's (the graph's) or an error, never a quiet fallback."""
    x = torch.zeros((1, 4), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        admm_kernel.fused_solve_lanes(
            x, x, x, x, x, x, x, x, x, x, x, nv=4, n_box=4, soc_dims=(),
            iters=1, alpha=1.6,
        )
    with pytest.raises(ValueError, match="unsupported device"):
        admm_kernel.fused_solve_lanes(
            x, x, x, x, x, x, x, x, x, x, x, nv=4, n_box=4, soc_dims=(),
            iters=1, alpha=1.6, check_every=1, tol=1e-3,
        )
    with pytest.raises(ValueError, match="unsupported device"):
        admm_kernel.admm_chunk_lanes(
            x, x, x, x, x, x, x, x, x, nv=4, n_box=4, soc_dims=(), iters=1,
            alpha=1.6,
        )
    with pytest.raises(ValueError, match="unsupported device"):
        ring.ring_sum_shards(x)
    with pytest.raises(ValueError, match="unsupported device"):
        cuda_graph.GraphedFn(lambda s, f: s)(x, x)


def test_active_gate_needs_the_tolerance_path():
    """A fixed-iteration solve cannot express the 0-iteration
    pass-through: ``active=`` without check_every/tol is a ValueError on
    the solver and on the kernel wrapper, as in the JAX package."""
    x = torch.zeros((2, 4))
    eye = torch.eye(4).expand(2, 4, 4)
    gate = torch.ones(2, dtype=torch.bool)
    with pytest.raises(ValueError, match="active"):
        socp.solve_socp(eye, x, eye, -torch.ones(2, 4), torch.ones(2, 4),
                        n_box=4, active=gate)
    with pytest.raises(ValueError, match="active"):
        admm_kernel.fused_solve_lanes(
            x, x, x, torch.zeros(2, 8, 8), eye, eye, eye, x, torch.ones(2, 4),
            x, x, None, gate, nv=4, n_box=4, soc_dims=(), iters=1, alpha=1.6)
