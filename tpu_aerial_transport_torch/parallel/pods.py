"""Scenario sharding across processes: one Monte-Carlo batch split over
several processes along the scenario axis.

Counterpart of the JAX package's ``parallel/pods.py`` (the pods tier), with
its public names. The boundary between processes always lies on the
scenario axis, so the consensus of a scenario never crosses a process:
each process owns a contiguous slab of scenario rows and every agent shard
of them.

The design the port takes:

- **A sharded batch is a local slab, not a global array.** The JAX package
  assembles a global ``jax.Array`` from the blocks of each process; PyTorch
  has no global array. Here each process holds *its rows* of the scenario
  axis as tensors on its device, the mesh says which rows those are
  (:class:`PodsMesh`), and :func:`host_global` (an all-gather over the
  group, in rank order) is the only thing that rebuilds the whole batch.
- **The transport is an explicit ``torch.distributed`` group, on gloo.**
  :func:`initialize` builds a ``TCPStore`` (rank 0 its server) and a
  ``ProcessGroupGloo`` from the ``TAT_PODS_*`` environment and returns the
  group (None for one process). The mesh carries the group and every
  collective here goes through ``mesh.group``: nothing calls
  ``init_process_group`` or touches the default group, so two ranks can
  run as two threads of one process over a ``HashStore`` (the tests do).
  What crosses processes is small -- a residual scalar a step, a validity
  mask at resume, the :func:`host_global` gather -- and crosses as host
  tensors; each slab's compute stays on its device. NCCL is left out: it
  refuses two ranks on one card.
- **On one card, a device is a logical shard.** :class:`PodsSpec` keeps
  the JAX topology (``scenario_shards x agent_shards`` over
  ``n_processes``): inside a process the scenario shards of its slab are
  just more lanes of the batched program, and the agent shards are the
  controllers' ``shards=agent_shards`` (through the ring-sum kernel under
  ``consensus_impl="pallas_ring"``), as ``parallel/mesh.py`` runs them.

Entry points: :func:`resolve_pods_spec`, :func:`initialize`,
:func:`check_topology`, :func:`make_pods_mesh`; placement
(:func:`place_global_batch`, :func:`place_local_batch`,
:func:`local_host_shard`, :func:`host_global`); the step
(:func:`pods_control_step`); the benchmark workload
(:func:`make_pods_workload`, :func:`parity_digest`); and resumable runs
(:func:`pods_rollout_resumable`). The localhost harness is
``tpu_aerial_transport_torch.tools.pods_local``.
"""

from __future__ import annotations

import dataclasses
import os
from datetime import timedelta

import numpy as np
import torch

from tpu_aerial_transport_torch import resolve_device
from tpu_aerial_transport_torch.obs import phases
from tpu_aerial_transport_torch.resilience.recovery import host_copy
from tpu_aerial_transport_torch.tree import tree_map

SCENARIO_AXIS = "scenario"
AGENT_AXIS = "agent"

# Config-build-time force switch: "SxA", e.g. TAT_PODS_MESH=2x4 forces a
# 2-scenario-shard x 4-agent-shard mesh.
ENV_VAR = "TAT_PODS_MESH"

# Bootstrap environment (tools/pods_local.py exports these into its
# workers; a launcher on several hosts sets the same three).
COORDINATOR_ENV = "TAT_PODS_COORDINATOR"
NUM_PROCESSES_ENV = "TAT_PODS_NUM_PROCESSES"
PROCESS_ID_ENV = "TAT_PODS_PROCESS_ID"

# The group's collective timeout: a rank that stopped answering fails its
# peers' collectives after this, instead of wedging them.
DEFAULT_TIMEOUT_S = 300.0
STORE_PREFIX = "tat_pods"


# ----------------------------------------------------------------------
# Topology spec + resolution.
# ----------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class PodsSpec:
    """Static 2-D mesh topology: ``scenario_shards x agent_shards`` over
    ``n_processes`` processes, process boundary along the scenario axis
    (``scenario_shards % n_processes == 0`` -- each process owns a
    contiguous slab of scenario rows and ALL agent shards inside it, so
    consensus never crosses a process)."""

    scenario_shards: int
    agent_shards: int
    n_processes: int = 1

    @property
    def n_devices(self) -> int:
        return self.scenario_shards * self.agent_shards

    @property
    def local_devices(self) -> int:
        return self.n_devices // self.n_processes

    def topology(self) -> dict:
        """JSON-able description -- journaled in run metadata and folded
        into the resume config hash."""
        return {
            "scenario_shards": self.scenario_shards,
            "agent_shards": self.agent_shards,
            "n_processes": self.n_processes,
            "n_devices": self.n_devices,
        }

    def validate(self, n_agents: int | None = None) -> "PodsSpec":
        if self.scenario_shards < 1 or self.agent_shards < 1:
            raise ValueError(f"non-positive mesh shape: {self}")
        if self.n_processes < 1 or self.n_devices % self.n_processes:
            raise ValueError(
                f"{self.n_devices} devices not divisible by "
                f"{self.n_processes} processes: {self}"
            )
        if self.scenario_shards % self.n_processes:
            raise ValueError(
                f"scenario_shards={self.scenario_shards} not divisible by "
                f"n_processes={self.n_processes}: the process boundary must "
                "lie along the scenario axis (consensus stays intra-process)"
            )
        if n_agents is not None and n_agents % self.agent_shards:
            raise ValueError(
                f"n_agents={n_agents} not divisible by "
                f"agent_shards={self.agent_shards}"
            )
        return self


def _parse_mesh_str(raw: str) -> tuple[int, int]:
    parts = raw.lower().replace("×", "x").split("x")
    if len(parts) != 2:
        raise ValueError(
            f"{ENV_VAR}={raw!r}: expected 'SxA' (scenario_shards x "
            "agent_shards), e.g. '2x4'"
        )
    try:
        return int(parts[0]), int(parts[1])
    except ValueError:
        raise ValueError(f"{ENV_VAR}={raw!r}: shards must be ints") from None


def resolve_pods_spec(
    n_agents: int,
    spec: "str | tuple | PodsSpec | None" = "auto",
    *,
    n_devices: int | None = None,
    n_processes: int | None = None,
    group=None,
) -> PodsSpec:
    """Resolve the 2-D mesh topology at config build time. Precedence:

    1. an explicit ``spec`` (``PodsSpec`` / ``(S, A)`` / ``"SxA"``);
    2. else the ``TAT_PODS_MESH`` env force (``"SxA"`` / ``"auto"``);
    3. else auto: the largest ``agent_shards`` dividing BOTH ``n_agents``
       and the per-process device count (so agent shards never straddle a
       process), scenario taking the rest.

    ``n_processes`` defaults to the world size of ``group`` (1 without
    one) and ``n_devices`` to that times the cards this process sees (one
    logical device on a host without a card); pass both to plan a
    topology of logical shards."""
    if n_processes is None:
        n_processes = 1 if group is None else group.size()
    if n_devices is None:
        n_devices = n_processes * max(torch.cuda.device_count(), 1)
    if n_devices % n_processes:
        raise ValueError(
            f"{n_devices} devices not divisible by {n_processes} processes"
        )
    local = n_devices // n_processes

    if spec is None or spec == "auto":
        env = os.environ.get(ENV_VAR, "").strip()
        if env and env != "auto":
            spec = env
    if isinstance(spec, PodsSpec):
        return spec.validate(n_agents)
    if isinstance(spec, str) and spec not in ("auto", ""):
        s, a = _parse_mesh_str(spec)
        return PodsSpec(s, a, n_processes).validate(n_agents)
    if isinstance(spec, tuple):
        return PodsSpec(spec[0], spec[1], n_processes).validate(n_agents)

    agent_shards = max(
        d for d in range(1, min(local, n_agents) + 1)
        if n_agents % d == 0 and local % d == 0
    )
    return PodsSpec(
        scenario_shards=n_devices // agent_shards,
        agent_shards=agent_shards,
        n_processes=n_processes,
    ).validate(n_agents)


# ----------------------------------------------------------------------
# Bootstrap + topology gate.
# ----------------------------------------------------------------------

def gloo_group(store, rank: int, world_size: int,
               timeout_s: float = DEFAULT_TIMEOUT_S):
    """A gloo process group of ``world_size`` ranks over ``store`` (a
    ``TCPStore`` across processes, a ``HashStore`` for ranks that are
    threads of one process), under this module's store prefix. Never the
    default group."""
    import torch.distributed as dist

    return dist.ProcessGroupGloo(
        dist.PrefixStore(STORE_PREFIX, store), rank, world_size,
        timedelta(seconds=timeout_s))


def initialize(coordinator: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None,
               timeout_s: float = DEFAULT_TIMEOUT_S):
    """The bootstrap: arguments default from the ``TAT_PODS_*`` env vars
    (what tools/pods_local.py exports into its workers). Builds a
    ``TCPStore`` at ``coordinator`` (``host:port``; rank 0 serves it) and
    a gloo group over it, and returns the group; None for the
    single-process no-op (no coordinator, or fewer than two
    processes)."""
    env = os.environ
    if coordinator is None:
        coordinator = env.get(COORDINATOR_ENV, "")
    if num_processes is None and env.get(NUM_PROCESSES_ENV):
        num_processes = int(env[NUM_PROCESSES_ENV])
    if process_id is None and env.get(PROCESS_ID_ENV):
        process_id = int(env[PROCESS_ID_ENV])
    if not coordinator or not num_processes or num_processes < 2:
        return None
    import torch.distributed as dist

    rank = 0 if process_id is None else process_id
    host, _, port = coordinator.rpartition(":")
    store = dist.TCPStore(host, int(port), num_processes,
                          is_master=rank == 0,
                          timeout=timedelta(seconds=timeout_s))
    return gloo_group(store, rank, num_processes, timeout_s)


def check_topology(spec: PodsSpec, group=None, device="cuda") -> None:
    """Refuse to run on the wrong mesh: a classified
    ``BackendError("topology_mismatch")`` when the group's world size is
    not ``spec.n_processes`` or ``device`` is the card and none is visible
    (running undersharded would mis-measure)."""
    from tpu_aerial_transport_torch.resilience.backend import BackendError

    world = 1 if group is None else group.size()
    if world != spec.n_processes:
        raise BackendError(
            "topology_mismatch",
            f"{world} of {spec.n_processes} processes in the group -- the "
            f"pods mesh {spec.scenario_shards}x{spec.agent_shards} cannot "
            "be built",
        )
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise BackendError(
            "topology_mismatch",
            f"visible 0 of {spec.n_processes} cards: the pods mesh "
            f"{spec.scenario_shards}x{spec.agent_shards} asks for "
            "device='cuda'",
        )


@dataclasses.dataclass(frozen=True)
class PodsMesh:
    """The 2-D ``(scenario, agent)`` mesh as one process sees it: the
    ``spec``, the gloo ``group`` (None for one process), this process's
    ``rank`` (its slab of scenario rows is the ``rank``-th of
    ``spec.n_processes`` equal slabs) and the ``device`` it computes
    on."""

    spec: PodsSpec
    group: object
    rank: int
    device: torch.device

    @property
    def shape(self) -> dict:
        return {SCENARIO_AXIS: self.spec.scenario_shards,
                AGENT_AXIS: self.spec.agent_shards}

    def rows(self, n_scenarios: int) -> slice:
        """This process's rows of a global scenario axis of
        ``n_scenarios`` (a multiple of the scenario shard count)."""
        if n_scenarios % self.spec.scenario_shards:
            raise ValueError(
                f"{n_scenarios} scenarios not divisible by "
                f"{self.spec.scenario_shards} scenario shards"
            )
        per = n_scenarios // self.spec.n_processes
        return slice(self.rank * per, (self.rank + 1) * per)


def make_pods_mesh(spec: PodsSpec, group=None, device="cuda") -> PodsMesh:
    """The mesh of ``spec`` for this process, after :func:`check_topology`
    (a classified ``topology_mismatch`` on a wrong group or a missing
    card)."""
    check_topology(spec, group, device)
    return PodsMesh(spec=spec, group=group,
                    rank=0 if group is None else group.rank(),
                    device=resolve_device(device))


def mesh_spec(mesh: PodsMesh) -> PodsSpec:
    """The :class:`PodsSpec` a pods mesh realizes."""
    return mesh.spec


# ----------------------------------------------------------------------
# Placement / extraction (the multi-process data plane).
# ----------------------------------------------------------------------

def _check_axis(axis: str) -> None:
    if axis != SCENARIO_AXIS:
        raise ValueError(
            f"axis={axis!r}: a pods mesh shards the {SCENARIO_AXIS!r} axis "
            "across processes")


def place_global_batch(mesh: PodsMesh, batch, axis: str = SCENARIO_AXIS):
    """This process's rows of a HOST-GLOBAL batch (every process holds the
    same full host copy -- the serving server's carry) on the mesh's
    device: each leaf's leading axis is the global scenario axis; 0-d
    leaves are replicated."""
    _check_axis(axis)

    def put(t):
        if not t.dim():
            return t.to(mesh.device, copy=True)
        return t[mesh.rows(t.shape[0])].to(mesh.device, copy=True)

    return tree_map(put, batch)


def place_local_batch(mesh: PodsMesh, local_batch, axis: str = SCENARIO_AXIS):
    """This process's LOCAL block (the leading-axis rows it owns) on the
    mesh's device: the process-local ingestion path, on which no host ever
    holds the global batch. The global leading dimension is the local rows
    times the process count."""
    _check_axis(axis)

    def put(t):
        if t.dim():
            mesh.rows(t.shape[0] * mesh.spec.n_processes)  # divisibility.
        return t.to(mesh.device, copy=True)

    return tree_map(put, local_batch)


def local_host_shard(tree):
    """This process's slab as fresh host tensors (the CPU copy the
    recovery tier's ``to_host`` hook snapshots; ``.numpy()`` of a leaf is
    its numpy view). A slab is already local, so this is
    ``recovery.host_copy``."""
    return host_copy(tree)


def host_global(tree, mesh: PodsMesh | None = None):
    """The whole batch as host tensors on EVERY process: each leaf's
    slabs all-gathered over ``mesh.group`` in rank order along the leading
    axis (0-d leaves, replicated, are copied). Without a group, the host
    copy. Parity and digest tooling, and the serving tier's boundary: a
    large pods workload should not materialize the global batch."""
    group = None if mesh is None else mesh.group
    if group is None or group.size() == 1:
        return host_copy(tree)

    def pull(t):
        h = t.detach().to("cpu", copy=True).contiguous()
        if not h.dim():
            return h
        outs = [torch.empty_like(h) for _ in range(group.size())]
        group.allgather([outs], [h]).wait()
        return torch.cat(outs)

    return tree_map(pull, tree)


def _allreduce_max(x: torch.Tensor, group) -> torch.Tensor:
    """The maximum of the 0-d ``x`` over the group's ranks, on the host."""
    import torch.distributed as dist

    h = x.detach().to("cpu", copy=True).reshape(1)
    opts = dist.AllreduceOptions()
    opts.reduceOp = dist.ReduceOp.MAX
    group.allreduce([h], opts).wait()
    return h[0]


# ----------------------------------------------------------------------
# The 2-D sharded control step.
# ----------------------------------------------------------------------

def pods_control_step(params, cfg, f_eq, mesh: PodsMesh, forest=None,
                      controller: str = "cadmm",
                      with_health: bool = False):
    """The distributed-MPC control step over the pods mesh.

    Returns ``step(css, states, acc_des[, healths]) -> (f, css, stats,
    batch_res)`` on this process's slab: ``css``/``states`` (and
    ``healths``, a batched ``resilience.faults.FaultStep`` with the full
    per-agent masks of every lane, and the ``held*`` fields in the state)
    carry the local scenario rows; ``f``, ``css`` and ``stats`` are local.
    The controller runs with ``shards=spec.agent_shards`` and its plan
    built once. ``batch_res`` is the global residual max over every
    scenario of every process: the slab's max, then an all-reduce MAX over
    the group on the host (the only exchange that crosses processes); max
    is exact under any schedule, so it equals the host-side max of a
    single-process run exactly. It comes back on the mesh's device."""
    spec = mesh.spec
    if params.n % spec.agent_shards:
        raise ValueError(f"n={params.n} not divisible by "
                         f"agent_shards={spec.agent_shards}")
    if controller == "cadmm":
        from tpu_aerial_transport_torch.control import cadmm as ctrl_mod

        plan = ctrl_mod.make_plan(params, cfg)
    elif controller == "dd":
        from tpu_aerial_transport_torch.control import dd as ctrl_mod

        plan = ctrl_mod.make_dd_plan(params, cfg)
    else:
        raise ValueError(controller)

    def step(css, states, acc_des, *maybe_health):
        if bool(maybe_health) != with_health:
            raise TypeError("pods_control_step: healths is an argument "
                            "exactly when with_health=True")
        health = maybe_health[0] if with_health else None
        # Coarse scope for the pods plumbing; the controllers' fine tat.*
        # scopes inside (being innermost) win the attribution.
        with phases.scope(phases.PODS_STEP):
            f, css, stats = ctrl_mod.control(
                params, cfg, f_eq, css, states, acc_des, forest,
                shards=spec.agent_shards, plan=plan, health=health)
            batch_res = torch.max(stats.solve_res)
            if mesh.group is not None and mesh.group.size() > 1:
                batch_res = _allreduce_max(batch_res, mesh.group).to(
                    batch_res.device)
            return f, css, stats, batch_res

    return step


# ----------------------------------------------------------------------
# Benchmark workload (tools/pods_local.py).
# ----------------------------------------------------------------------

def scenario_batch(state0, n_scenarios: int, seed: int = 0):
    """Deterministic host-side Monte-Carlo batch: payload positions
    ``N(0, 2^2) + (5, 0, 2)`` from ``numpy.random.default_rng(seed)``,
    every payload moving at (0.5, 0, 0) m/s, everything else from
    ``state0`` (one scenario, no scenario axis). Every process builds the
    SAME global batch from the seed, so the slabs agree without any
    exchange."""
    from tpu_aerial_transport_torch.harness.rollout import stack_scenarios

    xs = (np.random.default_rng(seed).normal(size=(n_scenarios, 3)) * 2.0
          + np.array([5.0, 0.0, 2.0]))
    dev = state0.xl.device
    vl = torch.zeros((n_scenarios, 3), dtype=torch.float32, device=dev)
    vl[:, 0] = 0.5
    return stack_scenarios(state0, n_scenarios).replace(
        xl=torch.as_tensor(xs, dtype=torch.float32, device=dev), vl=vl)


def _controller_setup(n: int, controller: str, max_iter: int,
                      inner_iters: int | None, consensus_impl: str, dev):
    """The workload's set-up on ``dev``: ``(params, col, state0, forest,
    f_eq, ll, ctrl_mod, cfg, cs0)``."""
    from tpu_aerial_transport_torch.control import centralized, lowlevel
    from tpu_aerial_transport_torch.envs import forest as forest_mod
    from tpu_aerial_transport_torch.harness import setup

    params, col, state0 = setup.rqp_setup(n, device=dev)
    forest = forest_mod.make_forest(seed=0, device=dev)
    f_eq = centralized.equilibrium_forces(params)
    ll = lowlevel.make_lowlevel_controller("pd", params)
    if controller == "cadmm":
        from tpu_aerial_transport_torch.control import cadmm as ctrl_mod

        inner = 20 if inner_iters is None else inner_iters
    elif controller == "dd":
        from tpu_aerial_transport_torch.control import dd as ctrl_mod

        inner = 40 if inner_iters is None else inner_iters
    else:
        raise ValueError(controller)
    cfg = ctrl_mod.make_config(
        params, col.collision_radius, col.max_deceleration,
        max_iter=max_iter, inner_iters=inner, consensus_impl=consensus_impl,
        device=dev)
    cs0 = (ctrl_mod.init_cadmm_state(params, cfg, f_eq)
           if controller == "cadmm"
           else ctrl_mod.init_dd_state(params, cfg, f_eq))
    return params, col, state0, forest, f_eq, ll, ctrl_mod, cfg, cs0


def make_pods_workload(n: int, mesh: PodsMesh, controller: str = "cadmm",
                       max_iter: int = 8, inner_iters: int | None = None,
                       seed: int = 0, consensus_impl: str = "auto"):
    """The full pods MPC workload on this process's slab: env CBFs + the
    sharded consensus solve + low-level control + 10x physics (the bench
    set-up's ``harness.rollout.make_substeps``, replayed from a CUDA graph
    on the card), stepped ``n_steps`` times.

    Returns ``(roll, init_batch)``: ``roll(css, states, n_steps) -> (css,
    states, res_trace)`` with ``res_trace`` the ``(n_steps,)`` per-step
    global batch residuals (the cross-process statistic, and the parity
    digest the localhost harness compares across topologies);
    ``init_batch(n_scenarios) -> (css, states)`` the HOST-GLOBAL initial
    batch as CPU tensors (place it with ``parallel.mesh.shard_scenarios``
    or :func:`place_local_batch`). ``consensus_impl`` is the agent
    exchange's (``"pallas_ring"`` for the ring-sum kernel).
    ``roll.config`` is the controller's config."""
    from tpu_aerial_transport_torch.harness import rollout as h_rollout

    (params, _col, state0, forest, f_eq, ll, _mod, cfg,
     cs0) = _controller_setup(n, controller, max_iter, inner_iters,
                              consensus_impl, mesh.device)
    dev = mesh.device
    step = pods_control_step(params, cfg, f_eq, mesh, forest, controller)
    substeps = h_rollout.make_substeps(params, ll.control)
    dvl_des = torch.zeros(3, dtype=torch.float32, device=dev)
    dvl_des[0] = 0.3
    acc_des = (dvl_des, torch.zeros(3, dtype=torch.float32, device=dev))

    def roll(css, states, n_steps):
        res = []
        for _ in range(n_steps):
            f, css, _stats, batch_res = step(css, states, acc_des)
            states = substeps(states, f)
            res.append(batch_res)
        return css, states, torch.stack(res)

    def init_batch(n_scenarios: int):
        states = scenario_batch(state0, n_scenarios, seed=seed)
        css = h_rollout.stack_scenarios(cs0, n_scenarios)
        return host_copy((css, states))

    roll.config = cfg
    return roll, init_batch


def parity_digest(mesh: PodsMesh, *, n: int = 8, n_scenarios: int = 8,
                  n_steps: int = 2, max_iter: int = 4,
                  inner_iters: int = 8, controller: str = "cadmm",
                  masked: bool = True,
                  consensus_impl: str = "auto") -> dict:
    """The pods parity probe: run the deterministic workload over ``mesh``
    and return host-global numpy digests -- final payload positions
    ``xl``, the per-step global batch residuals ``res_trace`` and
    (``masked``) one alive-masked, fault-injected control step's forces
    ``f_masked``, its ``res_masked`` and its consensus counts
    ``iters_masked`` (agent 0 dead, agent 2's consensus message dropped,
    tiled over the batch).

    The SAME function runs in every process of the localhost harness and
    in a single process; the two digests agree to float32 rounding, and
    every process returns the same digest (:func:`host_global`)."""
    from tpu_aerial_transport_torch.parallel import mesh as mesh_mod

    roll, init_batch = make_pods_workload(
        n, mesh, controller=controller, max_iter=max_iter,
        inner_iters=inner_iters, consensus_impl=consensus_impl,
    )
    css, states = init_batch(n_scenarios)
    _css, st_out, res_trace = roll(
        mesh_mod.shard_scenarios(mesh, css),
        mesh_mod.shard_scenarios(mesh, states), n_steps)
    digest = {
        "xl": host_global(st_out.xl, mesh).numpy(),
        "res_trace": res_trace.cpu().numpy(),
    }

    if masked:
        f_m, stats_m, bres_m = masked_step(
            mesh, n=n, n_scenarios=n_scenarios, max_iter=max_iter,
            inner_iters=inner_iters, controller=controller,
            consensus_impl=consensus_impl)
        digest["f_masked"] = host_global(f_m, mesh).numpy()
        digest["res_masked"] = bres_m.cpu().numpy()
        digest["iters_masked"] = host_global(stats_m.iters, mesh).numpy()
    return digest


def masked_step(mesh: PodsMesh, *, n: int, n_scenarios: int, max_iter: int,
                inner_iters: int | None, controller: str = "cadmm",
                consensus_impl: str = "auto"):
    """:func:`parity_digest`'s alive-masked, fault-injected control step
    (agent 0 dead, agent 2's consensus message dropped, every lane; the
    seed-0 :func:`scenario_batch`, ``acc_des = ((0.3, 0, 0.1), 0)``) on
    this process's slab: ``(f, stats, batch_res)``, local but for
    ``batch_res``."""
    from tpu_aerial_transport_torch.control import centralized
    from tpu_aerial_transport_torch.harness.rollout import stack_scenarios
    from tpu_aerial_transport_torch.parallel import mesh as mesh_mod
    from tpu_aerial_transport_torch.resilience import faults as faults_mod

    (params, _col, state0, _forest, _f_eq, _ll, ctrl_mod, cfg,
     _cs0) = _controller_setup(n, controller, max_iter, inner_iters,
                               consensus_impl, mesh.device)
    alive = np.ones(n, dtype=bool)
    alive[0] = False
    msg_ok = np.ones(n, dtype=bool)
    msg_ok[min(2, n - 1)] = False
    health = faults_mod.FaultStep(
        alive=torch.as_tensor(alive),
        thrust_scale=torch.as_tensor(alive, dtype=torch.float32),
        msg_ok=torch.as_tensor(msg_ok),
    )
    healths = tree_map(
        lambda t: t[None].expand((n_scenarios,) + t.shape).clone(), health)
    f_eq_m = centralized.equilibrium_forces(
        params, alive=health.alive.to(mesh.device))
    if controller == "cadmm":
        cs0 = ctrl_mod.init_cadmm_state(params, cfg)
        cs0 = cs0._replace(held=cs0.f)
    else:
        cs0 = ctrl_mod.init_dd_state(params, cfg)
        cs0 = cs0._replace(held_f=cs0.f, held_lam_F=cs0.lam_F,
                           held_lam_M=cs0.lam_M)
    css = host_copy(stack_scenarios(cs0, n_scenarios))
    states = host_copy(scenario_batch(state0, n_scenarios))
    dvl = torch.tensor([0.3, 0.0, 0.1], device=mesh.device)
    acc = (dvl, torch.zeros(3, device=mesh.device))
    step = pods_control_step(params, cfg, f_eq_m, mesh, None, controller,
                             with_health=True)
    f, _, stats, batch_res = step(
        mesh_mod.shard_scenarios(mesh, css),
        mesh_mod.shard_scenarios(mesh, states), acc,
        mesh_mod.shard_scenarios(mesh, healths),
    )
    return f, stats, batch_res


# ----------------------------------------------------------------------
# Resumable pods runs: per-process snapshot shards + agreement.
# ----------------------------------------------------------------------

def _agreed_boundary_cap(valid: np.ndarray, group=None) -> int:
    """The newest chunk boundary valid on EVERY process (+1 = the agreed
    start chunk). ``valid[c]`` is this process's verdict on the boundary
    after chunk ``c``; the masks all-gather over the group and AND -- a
    process that died mid-publish fails its own newest boundary and drags
    every process back one chunk, instead of the processes deadlocking on
    mismatched collectives."""
    if group is not None and group.size() > 1:
        mine = torch.as_tensor(np.asarray(valid, dtype=np.int32))
        outs = [torch.empty_like(mine) for _ in range(group.size())]
        group.allgather([outs], [mine]).wait()
        valid = torch.stack(outs).min(dim=0).values.numpy()
    agreed = np.nonzero(valid)[0]
    return int(agreed.max()) + 1 if agreed.size else 0


def pods_rollout_resumable(
    chunk_fn,
    mesh: PodsMesh,
    *,
    n_hl_steps: int,
    n_chunks: int,
    run_dir: str,
    config_hash: str | None = None,
    seed: int | None = None,
    keep_last: int = 3,
    max_retries: int = 1,
    meta: dict | None = None,
    metrics=None,
    tracer=None,
):
    """Preemption-safe pods twin of
    ``parallel.mesh.scenario_rollout_resumable``: each PROCESS drives the
    batched chunk (``parallel.mesh.vmap_chunk_jit``: logs lead with the
    scenario axis, so a process's logs are its slab) over its own slab and
    snapshots only it (``checkpoint.shard_prefix`` carry/log prefixes and
    a ``journal.p{pid}of{N}.jsonl`` journal inside ONE shared run_dir;
    rank 0 publishes the shard manifest), and a resume restarts every
    process from the newest boundary that EVERY process still holds (the
    validity masks gathered and ANDed; a process that rejected one of its
    boundaries journals a ``pods_shard_validation`` row).

    The config hash FOLDS THE TOPOLOGY IN (``config_hash`` combined with
    ``spec.topology()``), so resuming 2-process shards under another mesh
    refuses with ``config_mismatch``, and the shard manifest refuses a
    wrong process count before any shard is read.

    ``run(local_carry, resume=False, interrupt=None) -> RunResult`` takes
    and returns PROCESS-LOCAL slabs (leading axis = this process's
    scenario rows; ``local_carry`` on the host, the chunk-0 carry or the
    resume template); ``RunResult.logs`` is this process's block of the
    concatenated chunk logs.

    ``tracer`` (an ``obs.trace.Tracer``, or ``True`` for one per process
    writing ``trace.p{pid}of{N}.metrics.jsonl`` into the run dir on track
    ``p{pid}of{N}``) traces the chunk driver;
    ``obs.trace.stitch_run_dir`` stitches the processes' tracks into one
    trace through this run dir's shard manifest."""
    from tpu_aerial_transport_torch.harness import checkpoint
    from tpu_aerial_transport_torch.parallel import mesh as mesh_mod
    from tpu_aerial_transport_torch.resilience import recovery

    spec = mesh_spec(mesh)
    pid = mesh.rank
    topo_hash = checkpoint.config_fingerprint(
        base=config_hash or "", topology=tuple(sorted(
            spec.topology().items()
        )),
    )
    if n_hl_steps % n_chunks:
        raise ValueError(
            f"n_hl_steps={n_hl_steps} not divisible by n_chunks={n_chunks}"
        )
    chunk_jit = mesh_mod.vmap_chunk_jit(chunk_fn)
    plan = recovery.RunPlan(
        run_dir=run_dir, n_hl_steps=n_hl_steps, n_chunks=n_chunks,
        seed=seed, config_hash=topo_hash, keep_last=keep_last,
        logs_time_axis=1,
        meta={**(meta or {}), "topology": spec.topology()},
        carry_prefix=checkpoint.shard_prefix(
            recovery.CARRY_PREFIX, pid, spec.n_processes
        ),
        logs_prefix=checkpoint.shard_prefix(
            recovery.LOGS_PREFIX, pid, spec.n_processes
        ),
        journal_filename=f"journal.p{pid}of{spec.n_processes}.jsonl",
    )

    if tracer is True:
        from tpu_aerial_transport_torch.obs import export as export_mod
        from tpu_aerial_transport_torch.obs import trace as trace_lib

        track = f"p{pid}of{spec.n_processes}"
        tracer = trace_lib.Tracer(
            export_mod.MetricsWriter(
                os.path.join(run_dir, f"trace.{track}.metrics.jsonl")
            ),
            track=track,
        )
    elif not tracer:
        # False from a bool(flag) caller: the chunk driver's zero-cost
        # gate is `tracer is not None`.
        tracer = None

    def place(local_carry):
        return place_local_batch(mesh, local_carry)

    def _publish_manifest():
        if pid == 0:
            checkpoint.save_shard_manifest(
                run_dir, prefix=recovery.CARRY_PREFIX,
                n_processes=spec.n_processes, topology=spec.topology(),
                config_hash=topo_hash,
            )

    def _valid_boundaries(local_carry) -> tuple[np.ndarray, list[str]]:
        """Per-boundary validity of THIS process's shard files -- the
        carry + complete-log-prefix rule resume_run applies -- and the
        reasons for every rejected boundary."""
        logs_template = chunk_jit.logs_spec(local_carry)
        valid = np.zeros(n_chunks, dtype=bool)
        reasons: list[str] = []
        log_ok: dict[int, bool] = {}

        def _log_valid(lc: int) -> bool:
            # Memoized: boundary candidates share log prefixes (resume_run
            # re-validates the chosen boundary when it loads it).
            if lc not in log_ok:
                try:
                    checkpoint.load_snapshot(
                        checkpoint.snapshot_path(
                            run_dir, lc, plan.logs_prefix
                        ),
                        logs_template, config_hash=topo_hash,
                    )
                    log_ok[lc] = True
                except checkpoint.SnapshotError as e:
                    reasons.append(str(e)[:300])
                    log_ok[lc] = False
            return log_ok[lc]

        for step, path in checkpoint.list_snapshots(
            run_dir, plan.carry_prefix
        ):
            if step >= n_chunks:
                continue
            try:
                checkpoint.load_snapshot(
                    path, local_carry, config_hash=topo_hash
                )
            except checkpoint.SnapshotError as e:
                reasons.append(str(e)[:300])
                continue
            valid[step] = all(_log_valid(lc) for lc in range(step + 1))
        return valid, reasons

    def run(local_carry, resume: bool = False, interrupt=None):
        if resume:
            checkpoint.load_shard_manifest(
                run_dir, prefix=recovery.CARRY_PREFIX,
                n_processes=spec.n_processes, config_hash=topo_hash,
            )
            valid, reasons = _valid_boundaries(local_carry)
            cap = _agreed_boundary_cap(valid, mesh.group)
            if reasons:
                recovery.RunJournal(
                    run_dir, filename=plan.journal_filename
                ).append({
                    "event": "pods_shard_validation",
                    "valid": [bool(v) for v in valid],
                    "agreed_cap": cap, "skipped": reasons[:8],
                })
            return recovery.resume_run(
                run_dir, chunk_jit, local_carry,
                config_hash=topo_hash, interrupt=interrupt, place=place,
                max_retries=max_retries, metrics=metrics,
                journal_filename=plan.journal_filename,
                to_host=local_host_shard, max_start_chunk=cap,
                tracer=tracer,
            )
        _publish_manifest()
        return recovery.run_chunks(
            plan, chunk_jit, local_carry, interrupt=interrupt,
            place=place, max_retries=max_retries, metrics=metrics,
            to_host=local_host_shard, tracer=tracer,
        )

    run.batched_jit = chunk_jit
    run.plan = plan
    run.spec = spec
    return run
