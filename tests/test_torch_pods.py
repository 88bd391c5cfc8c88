"""PyTorch port vs the JAX package: scenario sharding across processes
(``tpu_aerial_transport_torch/parallel/pods.py``, the scenario tier of
``parallel/mesh.py``, ``ScenarioServer(mesh=)`` and the harness
``tpu_aerial_transport_torch/tools/pods_local.py``).

No tier-1 test here starts a process. Two ranks run as two daemon threads
of the test process, each with its own ``ProcessGroupGloo`` (60 s
timeout) over one ``HashStore``; every join has a timeout, so a rank that
diverges fails the test instead of hanging the worker. The port passes
its group explicitly and never touches the default process group, which
is what makes that possible. Inputs are seeded with numpy.

Tolerances, and why: the port's 2x2 pods step against the JAX
``pods_control_step`` on the virtual 2x2 mesh holds forces and the batch
residual to 2e-3 N, the JAX pods tests' bar (``tests/test_pods.py``
``_TOL``, float32 summation order), with consensus counts equal. Within
the port, the two-rank step against the single-process step holds forces
to 1e-6 N (the batch-against-solo bar of ``tests/test_torch_parallel.py``)
and the batch residual exactly: max is exact under any schedule. Resumed
runs and the one-process server are bitwise.

The 2-process e2e through the harness is ``slow``.
"""

import argparse
import importlib.util
import json
import os
import subprocess
import sys
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from tpu_aerial_transport.control import cadmm as jcadmm
from tpu_aerial_transport.control import centralized as jcentral
from tpu_aerial_transport.harness import setup as jsetup
from tpu_aerial_transport.parallel import mesh as jmesh
from tpu_aerial_transport.parallel import pods as jpods
from tpu_aerial_transport_torch import convert
from tpu_aerial_transport_torch.control import cadmm, centralized
from tpu_aerial_transport_torch.harness import checkpoint, rollout, setup
from tpu_aerial_transport_torch.parallel import mesh as mesh_mod
from tpu_aerial_transport_torch.parallel import pods
from tpu_aerial_transport_torch.resilience import backend, faults, recovery
from tpu_aerial_transport_torch.serving import batcher
from tpu_aerial_transport_torch.serving import server as server_mod
from tpu_aerial_transport_torch.serving.queue import ScenarioRequest
from tpu_aerial_transport_torch.tools import pods_local
from tpu_aerial_transport_torch.tree import leaves, tree_map

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_TOL = 2e-3
SOLO_BAR = 1e-6
N, S = 4, 4  # tests/test_pods.py:163-196's step: n = 4, 4 scenarios.
CFG = dict(max_iter=2, inner_iters=4)
ACC = ((0.3, 0.0, 0.1), (0.0, 0.0, 0.0))
JOIN_S = 120.0


def _ranks(fn, world=2):
    """``fn(rank, group)`` on ``world`` ranks, each a daemon thread with
    its own gloo group over one ``HashStore``; the ranks' returns in rank
    order. A rank's exception re-raises here; a rank still running after
    ``JOIN_S`` fails the test."""
    store = dist.HashStore()
    out, errs = [None] * world, []

    def go(r):
        try:
            out[r] = fn(r, pods.gloo_group(store, r, world, timeout_s=60))
        except BaseException as e:  # noqa: BLE001 -- re-raised below.
            errs.append(e)

    threads = [threading.Thread(target=go, args=(r,), daemon=True)
               for r in range(world)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(JOIN_S)
    assert not any(t.is_alive() for t in threads), "a rank hung"
    if errs:
        raise errs[0]
    return out


def _bits(a, b, what=""):
    la, lb = leaves(a), leaves(b)
    assert len(la) == len(lb) and la, what
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and torch.equal(x, y), what


def _mesh(spec="2x2", group=None, world=1, n=N):
    return pods.make_pods_mesh(
        pods.resolve_pods_spec(n, spec, n_devices=4, n_processes=world),
        group, device="cpu")


# ---------------------------------------------------- (1) resolution --


def _spec_or_error(resolve, n, spec, n_devices, n_processes):
    try:
        s = resolve(n, spec, n_devices=n_devices, n_processes=n_processes)
    except ValueError:
        return "ValueError"
    return (s.scenario_shards, s.agent_shards, s.n_processes, s.n_devices,
            s.local_devices, s.topology())


SPECS = ("auto", "2x4", "4x2", "2x2", "3x2", "8x1", "2×4", "1X8", "bogus",
         "2x", "ax2", (2, 2), (4, 1))


@pytest.mark.parametrize("n", [4, 6, 8])
@pytest.mark.parametrize("n_devices,n_processes",
                         [(8, 1), (8, 2), (8, 4), (4, 2), (6, 3), (6, 4)])
def test_resolve_pods_spec_matches_jax(monkeypatch, n, n_devices,
                                       n_processes):
    """Explicit specs, strings and tuples, and the auto rule: the same
    topology as the JAX resolver, or a ValueError where it raises one;
    ``PodsSpec.validate`` likewise."""
    monkeypatch.delenv(pods.ENV_VAR, raising=False)
    for spec in SPECS:
        assert (_spec_or_error(pods.resolve_pods_spec, n, spec, n_devices,
                               n_processes)
                == _spec_or_error(jpods.resolve_pods_spec, n, spec,
                                  n_devices, n_processes)), spec
    for s, a in ((2, 2), (3, 2), (0, 1), (2, 3), (4, 2)):
        got = want = "ok"
        try:
            pods.PodsSpec(s, a, n_processes).validate(n)
        except ValueError:
            got = "ValueError"
        try:
            jpods.PodsSpec(s, a, n_processes).validate(n)
        except ValueError:
            want = "ValueError"
        assert got == want, (s, a)


@pytest.mark.parametrize("force", ["4x2", "2x4", "auto", "", "bogus", "3x2"])
def test_resolve_pods_spec_env_force_matches_jax(monkeypatch, force):
    """The ``TAT_PODS_MESH`` force, under "auto" and under an explicit
    spec (which wins over it)."""
    monkeypatch.setenv(pods.ENV_VAR, force)
    assert pods.ENV_VAR == jpods.ENV_VAR
    for spec in ("auto", None, "2x4"):
        assert (_spec_or_error(pods.resolve_pods_spec, 8, spec, 8, 1)
                == _spec_or_error(jpods.resolve_pods_spec, 8, spec, 8, 1))


def test_topology_gate_and_bootstrap():
    """A group of the wrong size, or the card asked for where none is, is
    a classified ``topology_mismatch``; ``initialize`` with no
    coordinator is the single-process no-op; ``mesh_spec`` and the
    defaults of ``resolve_pods_spec`` without a group."""
    spec = pods.resolve_pods_spec(N, "2x2", n_devices=4, n_processes=2)
    with pytest.raises(backend.BackendError) as ei:
        pods.make_pods_mesh(spec, None, device="cpu")
    assert ei.value.kind == "topology_mismatch"
    assert backend.classify(str(ei.value)) == "topology_mismatch"
    if not torch.cuda.is_available():
        one = pods.PodsSpec(2, 2, 1)
        with pytest.raises(backend.BackendError) as ei:
            pods.check_topology(one, None, device="cuda")
        assert ei.value.kind == "topology_mismatch"
    for name in ("COORDINATOR_ENV", "NUM_PROCESSES_ENV", "PROCESS_ID_ENV",
                 "SCENARIO_AXIS", "AGENT_AXIS"):
        assert getattr(pods, name) == getattr(jpods, name)
    assert pods.initialize(coordinator="", num_processes=2) is None
    assert pods.initialize(coordinator="127.0.0.1:1", num_processes=1) is None
    m = _mesh()
    assert pods.mesh_spec(m) == pods.PodsSpec(2, 2, 1)
    assert m.shape == {"scenario": 2, "agent": 2} and m.rank == 0
    auto = pods.resolve_pods_spec(8)
    assert auto.n_processes == 1
    assert auto.n_devices == max(torch.cuda.device_count(), 1)


def test_initialize_over_tcp_store_in_threads():
    """``initialize`` on two ranks (threads) at a localhost coordinator:
    rank 0 serves the ``TCPStore``, and the groups built over it agree on
    an all-reduce."""
    port = pods_local._free_port()

    def fn(r, _group):
        g = pods.initialize(coordinator=f"127.0.0.1:{port}", num_processes=2,
                            process_id=r, timeout_s=60)
        m = _mesh(group=g, world=2)
        return (g.rank(), g.size(), float(pods._allreduce_max(
            torch.tensor(float(r) + 0.5), g)), m.rank)

    assert _ranks(fn) == [(0, 2, 1.5, 0), (1, 2, 1.5, 1)]


# ----------------------------------------------------- (2) placement --


def _batch():
    rng = np.random.default_rng(0)
    return {"a": torch.as_tensor(rng.normal(size=(8, 3)), dtype=torch.float32),
            "b": torch.as_tensor(rng.integers(0, 9, size=(8,)),
                                 dtype=torch.int32),
            "c": torch.as_tensor(rng.normal(size=(8, 2)) > 0),
            "s": torch.tensor(3.0)}


def test_placement_round_trip_two_ranks():
    """``place_global_batch`` -> ``local_host_shard`` -> ``host_global``
    on two ranks: each rank holds its half, fresh host copies, and the
    gather rebuilds the batch bitwise on both; ``place_local_batch`` of a
    slab gathers back likewise."""
    batch = _batch()

    def fn(r, g):
        m = _mesh(group=g, world=2)
        placed = mesh_mod.shard_scenarios(m, batch)
        local = pods.local_host_shard(placed)
        _bits(local["a"], batch["a"][4 * r:4 * r + 4])
        assert local["a"].data_ptr() != placed["a"].data_ptr()
        whole = pods.host_global(local, m)
        again = pods.host_global(pods.place_local_batch(m, local), m)
        with pytest.raises(ValueError, match="not divisible"):
            pods.place_global_batch(m, {"x": torch.zeros(3)})
        with pytest.raises(ValueError, match="scenario"):
            pods.place_global_batch(m, batch, axis="agent")
        return whole, again

    for whole, again in _ranks(fn):
        _bits(whole, batch)
        _bits(again, batch)


# --------------------------------------------- (3) against the JAX step --


@pytest.fixture(scope="module")
def jax_pods_step():
    """The JAX ``pods_control_step`` on the virtual 2x2 mesh at
    ``tests/test_pods.py:163-196``'s inputs, once for the module: its
    inputs and outputs as numpy trees."""
    if jax.device_count() < 4:
        pytest.skip("the JAX 2x2 mesh needs 4 virtual devices")
    params, col, state0 = jsetup.rqp_setup(N)
    f_eq = jcentral.equilibrium_forces(params)
    m = jpods.make_pods_mesh(jpods.resolve_pods_spec(N, "2x2"))
    cfg = jcadmm.make_config(params, col.collision_radius,
                             col.max_deceleration, **CFG)
    cs0 = jcadmm.init_cadmm_state(params, cfg)
    step = jpods.pods_control_step(params, cfg, f_eq, m, None, "cadmm")
    states = jpods.scenario_batch(state0, S)
    css = jax.vmap(lambda _: cs0)(jnp.arange(S))
    acc = tuple(jnp.asarray(a, jnp.float32) for a in ACC)
    f, _, stats, batch_res = jax.jit(step)(
        jmesh.shard_scenarios(m, css), jmesh.shard_scenarios(m, states), acc)
    return jax.tree.map(np.asarray, (css, states, f, stats.iters, batch_res))


def _port_setup(n=N):
    params, col, state0 = setup.rqp_setup(n, device="cpu")
    f_eq = centralized.equilibrium_forces(params)
    cfg = cadmm.make_config(params, col.collision_radius,
                            col.max_deceleration, device="cpu", **CFG)
    cs0 = cadmm.init_cadmm_state(params, cfg, f_eq)
    acc = tuple(torch.tensor(a, dtype=torch.float32) for a in ACC)
    return params, cfg, f_eq, cs0, state0, acc


def test_pods_step_matches_jax(jax_pods_step):
    """The port's 2x2 step (one process) against the JAX pods step on the
    same inputs: forces and the batch residual within 2e-3 N, consensus
    counts equal; the two scenario batches are the same numbers."""
    jcss, jstates, jf, jiters, jres = jax_pods_step
    params, cfg, f_eq, _cs0, state0, acc = _port_setup()
    np.testing.assert_array_equal(
        pods.scenario_batch(state0, S).xl.numpy(), jstates.xl)
    m = _mesh()
    step = pods.pods_control_step(params, cfg, f_eq, m)
    f, _, stats, batch_res = step(
        mesh_mod.shard_scenarios(m, convert.cadmm_state(jcss, "cpu")),
        mesh_mod.shard_scenarios(m, convert.rqp_state(jstates, "cpu")), acc)
    assert np.abs(f.numpy() - jf).max() < JAX_TOL
    assert abs(float(batch_res) - float(jres)) < JAX_TOL
    np.testing.assert_array_equal(stats.iters.numpy(), jiters)


# ------------------------------------------ (4) two ranks against one --


def _health_inputs(params, cs0, n=N, s=S):
    alive = np.ones(n, dtype=bool)
    alive[0] = False
    msg_ok = np.ones(n, dtype=bool)
    msg_ok[2] = False
    health = faults.FaultStep(
        alive=torch.as_tensor(alive),
        thrust_scale=torch.as_tensor(alive, dtype=torch.float32),
        msg_ok=torch.as_tensor(msg_ok))
    healths = tree_map(lambda t: t[None].expand((s,) + t.shape).clone(),
                       health)
    f_eq = centralized.equilibrium_forces(params, alive=health.alive)
    return healths, f_eq, cs0._replace(held=cs0.f)


@pytest.mark.parametrize("with_health", [False, True],
                         ids=["nominal", "health"])
def test_two_rank_step_matches_single_process(with_health):
    """The pods step on two ranks (threads) against the single-process
    step on the same 2x2 mesh: forces within 1e-6 N, consensus counts
    equal, and the batch residual -- an all-reduce MAX across the ranks
    -- exactly the single process's; with health (agent 0 dead, agent 2's
    message dropped) the dead agent's forces are 0."""
    params, cfg, f_eq, cs0, state0, acc = _port_setup()
    extra = ()
    if with_health:
        healths, f_eq, cs0 = _health_inputs(params, cs0)
        extra = (healths,)
    css = rollout.stack_scenarios(cs0, S)
    states = pods.scenario_batch(state0, S)

    def run(m):
        step = pods.pods_control_step(params, cfg, f_eq, m,
                                      with_health=with_health)
        f, _, stats, res = step(
            mesh_mod.shard_scenarios(m, css),
            mesh_mod.shard_scenarios(m, states), acc,
            *(mesh_mod.shard_scenarios(m, e) for e in extra))
        return pods.host_global((f, stats.iters), m), res

    (f1, it1), res1 = run(_mesh())
    for (f2, it2), res2 in _ranks(lambda r, g: run(_mesh(group=g, world=2))):
        assert (f2 - f1).abs().max() <= SOLO_BAR
        assert torch.equal(it2, it1)
        assert float(res2) == float(res1) == float(
            torch.max(cadmm.control(params, cfg, f_eq, css, states, acc,
                                    shards=2, health=extra[0] if extra
                                    else None)[2].solve_res))
    if with_health:
        assert float(f1[:, 0].abs().max()) == 0.0


# ------------------------------------------------ (5) resumable runs --


HL, CHUNKS = 6, 3


def _resume_setup():
    params, cfg, f_eq, llc, hl, acc_des_fn = pods_local._centralized_bits(
        N, torch.device("cpu"))
    runner = rollout.make_chunked_rollout(
        hl, llc.control, params, n_hl_steps=HL, n_chunks=CHUNKS,
        hl_rel_freq=2, acc_des_fn=acc_des_fn)
    _p, _c, state0 = setup.rqp_setup(N, device="cpu")
    states = pods.scenario_batch(state0, S)
    css = rollout.stack_scenarios(
        centralized.init_ctrl_state(params, cfg, f_eq), S)
    return runner, runner.init_carry(states, css)


def _resumable(runner, m, d):
    return pods.pods_rollout_resumable(
        runner.chunk_fn, m, n_hl_steps=HL, n_chunks=CHUNKS, run_dir=str(d),
        seed=0)


def _local(carry, m):
    return pods.local_host_shard(tree_map(lambda t: t[m.rows(S)], carry))


def _preempt_resume(runner, carry, m, d, stop_after, corrupt=None):
    """Preempt at boundary ``stop_after``, optionally corrupt a carry
    shard (``corrupt(run_dir, rank)``), resume: the resumed result."""
    run = _resumable(runner, m, d)
    local = _local(carry, m)
    pre = run(local, interrupt=pods_local._simulated_preemption(
        run.plan, stop_after))
    assert pre.status == "preempted" and pre.chunks_done == stop_after
    if corrupt is not None:
        corrupt(str(d), m.rank)
    if m.group is not None:
        m.group.barrier().wait()  # every shard final before any resume.
    return _resumable(runner, m, d)(local, resume=True)


def test_pods_resumable_one_rank(tmp_path):
    """One process: preempted at boundary 1 and resumed, bitwise the
    uninterrupted run (carry and logs, the logs scenario-first); the
    manifest written by one process refuses a 2-process check."""
    runner, carry = _resume_setup()
    m = _mesh()
    full = _resumable(runner, m, tmp_path / "full")(_local(carry, m))
    assert full.status == "done" and full.logs.xl.shape[:2] == (S, HL)
    res = _preempt_resume(runner, carry, m, tmp_path / "pre", 1)
    assert res.status == "done" and res.resumed_from_chunk == 1
    _bits(res.carry, full.carry)
    _bits(res.logs, full.logs)
    assert os.path.exists(checkpoint.shard_manifest_path(
        str(tmp_path / "pre"), "carry"))
    with pytest.raises(checkpoint.SnapshotError) as ei:
        checkpoint.load_shard_manifest(str(tmp_path / "pre"), prefix="carry",
                                       n_processes=2)
    assert ei.value.kind == "config_mismatch"


def _corrupt_rank1_newest(run_dir, rank):
    if rank != 1:
        return
    newest = checkpoint.snapshot_path(
        run_dir, 1, checkpoint.shard_prefix(recovery.CARRY_PREFIX, 1, 2))
    raw = dict(np.load(newest, allow_pickle=False))
    raw["leaf_000000"] = raw["leaf_000000"] + 1  # stale manifest digests.
    with open(newest, "wb") as fh:
        np.savez(fh, **raw)


@pytest.mark.parametrize("corrupt", [False, True],
                         ids=["preempt", "corrupt_rank1"])
def test_pods_resumable_two_ranks(tmp_path, corrupt):
    """Two processes (threads) preempted and resumed: each rank's slab
    and logs bitwise its rows of the one-process uninterrupted run. With
    rank 1's newest carry shard corrupted, both ranks agree on the same
    earlier boundary (the validity masks gathered and ANDed), and rank 1
    journals a ``pods_shard_validation`` row."""
    runner, carry = _resume_setup()
    m1 = _mesh()
    full = _resumable(runner, m1, tmp_path / "full")(_local(carry, m1))
    d = tmp_path / "two"

    def fn(r, g):
        m = _mesh(group=g, world=2)
        res = _preempt_resume(runner, carry, m, d, 2,
                              _corrupt_rank1_newest if corrupt else None)
        return res, m.rows(S)

    for r, (res, rows) in enumerate(_ranks(fn)):
        assert res.status == "done"
        assert res.resumed_from_chunk == (1 if corrupt else 2)
        _bits(res.carry, tree_map(lambda t: t[rows], full.carry))
        _bits(res.logs, tree_map(lambda t: t[rows], full.logs))
        rows_j = recovery.RunJournal(
            str(d), f"journal.p{r}of2.jsonl").read()
        checks = [e for e in rows_j
                  if e.get("event") == "pods_shard_validation"]
        if corrupt and r == 1:
            assert checks and checks[-1]["agreed_cap"] == 1
            assert checks[-1]["valid"] == [True, False, False]
        else:
            assert not checks


# --------------------------------------- (6) the scenario tier of mesh --


def test_shard_scenarios_one_process_never_routes_to_pods(monkeypatch):
    """One-process meshes (the one-axis agent mesh and a 2x2 pods mesh)
    never take the multi-process placement; a leading axis that does not
    divide over the shards, or an unknown axis, is a ValueError."""
    def boom(*a, **k):
        raise AssertionError("pods placement taken on a one-process mesh")

    monkeypatch.setattr(pods, "place_global_batch", boom)
    batch = {"a": torch.ones((4, 3))}
    m1 = mesh_mod.make_mesh({"agent": 4})
    assert not mesh_mod.is_multiprocess_mesh(m1)
    assert mesh_mod.shard_scenarios(m1, batch, axis="agent")["a"] is \
        batch["a"]
    m2 = _mesh()
    assert not mesh_mod.is_multiprocess_mesh(m2)
    _bits(mesh_mod.shard_scenarios(m2, batch), batch)
    with pytest.raises(ValueError, match="divide"):
        mesh_mod.shard_scenarios(m2, {"a": torch.ones((3, 3))})
    with pytest.raises(ValueError, match="not an axis"):
        mesh_mod.shard_scenarios(m1, batch)


def test_scenario_rollout_resumable_is_run_chunks(tmp_path):
    """``scenario_rollout_resumable`` on a one-process mesh: the carry
    bitwise ``recovery.run_chunks`` on the same chunk, the logs the same
    bits laid out scenario-first (``vmap_chunk_jit``, whose ``logs_spec``
    says so); ``scenario_rollout`` places and calls; an uneven chunking is
    a ValueError."""
    runner, carry = _resume_setup()
    ref = recovery.run_chunks(
        recovery.RunPlan(run_dir=str(tmp_path / "ref"), n_hl_steps=HL,
                         n_chunks=CHUNKS), runner.chunk_jit, carry)
    run = mesh_mod.scenario_rollout_resumable(
        runner.chunk_fn, _mesh(), n_hl_steps=HL, n_chunks=CHUNKS,
        run_dir=str(tmp_path / "sr"), seed=0)
    assert run.plan.logs_time_axis == 1
    got = run(carry)
    _bits(got.carry, ref.carry)
    _bits(got.logs, tree_map(lambda t: t.movedim(0, 1), ref.logs))
    spec = run.batched_jit.logs_spec(carry)
    assert [s.shape for s in leaves(spec)] == [t.shape for t in
                                               leaves(tree_map(
                                                   lambda t: t[:, :HL // CHUNKS],
                                                   got.logs))]
    with pytest.raises(ValueError, match="not divisible"):
        mesh_mod.scenario_rollout_resumable(
            runner.chunk_fn, _mesh(), n_hl_steps=HL, n_chunks=4,
            run_dir=str(tmp_path / "bad"))
    sr = mesh_mod.scenario_rollout(lambda st, cs: (st.xl * 2, cs), _mesh())
    assert torch.equal(sr(carry)[0], carry[0].xl * 2)


# ------------------------------------------ (7) ScenarioServer(mesh=) --


FAMILY = "cadmm4"


def _requests(fam):
    rng = np.random.default_rng(0)
    out = []
    for i in range(6):
        x0 = rng.normal(0.0, 0.3, 3) + np.array([0.0, 0.0, 1.0])
        out.append(ScenarioRequest(
            family=FAMILY, horizon=fam.chunk_len * (1 + i % 2),
            x0=tuple(float(v) for v in x0), request_id=f"r{i}"))
    return out


def _serve(mesh=None):
    fam = batcher.make_family(FAMILY, device="cpu")
    srv = server_mod.ScenarioServer(
        families=[fam], buckets=(2, 4), device="cpu", mesh=mesh,
        clock=lambda: 0.0)
    tickets = [srv.submit(r) for r in _requests(fam)]
    srv.run_until_drained(max_rounds=64)
    assert all(t.status == "completed" for t in tickets)
    return {t.request.request_id: t.result for t in tickets}


def _same_results(a, b):
    assert set(a) == set(b)
    for rid in a:
        _bits(a[rid], b[rid], rid)


def test_server_on_a_mesh_serves_the_meshless_results():
    """A one-process 2x2 pods mesh serves bitwise the meshless server's
    results; two ranks (threads, one fake clock), each a server on its
    slab with the boundary carry gathered whole, serve the same results
    on both ranks."""
    ref = _serve()
    _same_results(_serve(_mesh()), ref)
    for got in _ranks(lambda r, g: _serve(_mesh(group=g, world=2))):
        _same_results(got, ref)


def test_server_mesh_refuses_device_surgery():
    """Device lane surgery, and pipelined dispatch (which implies it),
    with a mesh: the JAX server's ValueError."""
    fam = batcher.make_family(FAMILY, device="cpu")
    for kw in (dict(surgery="device"), dict(dispatch="pipelined")):
        with pytest.raises(ValueError, match="surgery='device'"):
            server_mod.ScenarioServer(families=[fam], device="cpu",
                                      mesh=_mesh(), **kw)


# ------------------------------------------------ (8) the harness CLI --


def _jax_harness_parser(monkeypatch):
    """The JAX harness's argument parser, loaded under its own module name
    and caught at ``parse_args`` (its ``main`` builds it inline)."""
    spec = importlib.util.spec_from_file_location(
        "jax_tools_pods_local", os.path.join(REPO, "tools", "pods_local.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)

    class Caught(Exception):
        pass

    def grab(self, *a, **k):
        raise Caught(self)

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", grab)
    with pytest.raises(Caught) as ei:
        mod.main()
    monkeypatch.undo()
    return mod, ei.value.args[0]


def test_harness_cli_matches_jax(monkeypatch):
    """``build_parser``'s defaults and choices are the JAX harness's, with
    ``--platform cpu`` become ``--device cuda`` and the port's
    ``--inner-iters``/``--consensus-impl`` added; ``_agents_div`` and the
    parity bar agree."""
    jmod, jparser = _jax_harness_parser(monkeypatch)
    ours = {a.dest: a for a in pods_local.build_parser()._actions}
    theirs = {a.dest: a for a in jparser._actions}
    assert set(ours) - set(theirs) == {"device", "inner_iters",
                                       "consensus_impl"}
    assert set(theirs) - set(ours) == {"platform"}
    for dest, a in theirs.items():
        if dest in ours:
            assert ours[dest].default == a.default, dest
            assert ours[dest].choices == a.choices, dest
    assert ours["device"].default == "cuda"
    assert pods_local.PARITY_ATOL == jmod.PARITY_ATOL
    assert pods_local.RESULT_TAG == jmod.RESULT_TAG
    for local in (1, 2, 3, 4, 8):
        for n in (1, 3, 4, 6, 8, 16):
            ns = argparse.Namespace(local_devices=local, n=n)
            assert pods_local._agents_div(ns) == jmod._agents_div(ns)


# ------------------------------------------------------ the slow e2e --


@pytest.mark.slow
def test_two_process_parity_e2e(tmp_path):
    """Two REAL worker processes on the CPU against the single-process
    pod of the same 2x2 mesh, through the harness as a user runs it."""
    proc = subprocess.run(
        [sys.executable, "-m", "tpu_aerial_transport_torch.tools.pods_local",
         "--mode", "parity", "--check-parity", "--device", "cpu",
         "--processes", "2", "--local-devices", "2", "--n", "4",
         "--scenarios", "4", "--steps", "1", "--max-iter", "2",
         "--out-dir", str(tmp_path), "--timeout", "300"],
        capture_output=True, text=True, timeout=600, cwd=REPO)
    row = json.loads(proc.stdout.strip().splitlines()[-1])
    if "skipped" in row:
        pytest.skip(row["skipped"])
    assert proc.returncode == 0, (row, proc.stderr[-2000:])
    assert row["parity_ok"] and row["residuals_equal"], row
    assert "f_masked" in row["max_diffs"], row
