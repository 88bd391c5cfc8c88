"""Agent-sharded controller steps on one card.

Counterpart of the agent axis of ``tpu_aerial_transport/parallel/mesh.py``:
the JAX package ``shard_map``s the C-ADMM and DD consensus loops over a
device mesh, each device holding a block of agents, and its tests run that
mesh as eight virtual devices in one process. On one card the shards are
an explicit axis of the batched program (``control.cadmm`` /
``control.dd`` with ``shards=d``): the per-agent work is one batched
program over every agent, and the cross-agent reductions are exchanges
over the shard axis through ``parallel.ring``. The state a sharded step
takes and returns is the same global state as the single program's, as
``shard_map`` takes and returns the global arrays. ``make_mesh`` and the
``*_control_sharded`` builders keep the JAX package's signatures; the mesh
is no more than its shard count.

The scenario tier: :func:`shard_scenarios`, :func:`scenario_rollout`,
:func:`vmap_chunk_jit` and :func:`scenario_rollout_resumable`. A mesh over
processes is ``parallel.pods.make_pods_mesh``'s (:func:`is_multiprocess_mesh`),
on which :func:`shard_scenarios` places each process's slab of scenario rows;
on one process the card holds the whole batch. The port's rollouts and
chunks already take the scenario axis explicitly, so the ``jax.vmap`` and
``jax.jit`` of the JAX functions have no counterpart here, and neither has
``donate``: PyTorch hands back new tensors. ``jit_sharded_step`` has no
counterpart: an eager step has nothing to compile, and ``cadmm`` /
``dd.jit_control_step(donate=True)`` write the new state into the storage
passed in.

Not ported yet (ROADMAP): the cross-card form of the exchange.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch

from tpu_aerial_transport_torch.control import cadmm, dd, rp_cadmm
from tpu_aerial_transport_torch.envs import forest as forest_mod
from tpu_aerial_transport_torch.models.rqp import RQPParams
from tpu_aerial_transport_torch.obs import phases
from tpu_aerial_transport_torch.tree import TensorSpec, tree_map


@dataclass(frozen=True)
class Mesh:
    """One named shard axis: ``shape = {name: d}``, as a JAX mesh's."""

    shape: dict[str, int]


def make_mesh(axes: dict[str, int]) -> Mesh:
    """The shard axis ``axes = {name: d}`` (one axis; a mesh over
    processes is ``parallel.pods.make_pods_mesh``'s)."""
    if len(axes) != 1:
        raise ValueError(f"axes={axes}: one shard axis only")
    if int(next(iter(axes.values()))) < 1:
        raise ValueError(f"axes={axes}: the shard count must be >= 1")
    return Mesh(shape={k: int(v) for k, v in axes.items()})


def sharded_step(control_fn: Callable, n: int, shards: int) -> Callable:
    """The plumbing of every agent-sharded step: the divisibility check at
    build time and the ``tat.sharded_step`` scope around
    ``control_fn(ctrl_state, state, acc_des)``."""
    cadmm.check_shards(n, shards)

    def step(ctrl_state, state, acc_des):
        with phases.scope(phases.SHARDED_STEP):
            return control_fn(ctrl_state, state, acc_des)

    return step


def cadmm_control_sharded(
    params: RQPParams,
    cfg: cadmm.RQPCADMMConfig,
    f_eq: torch.Tensor,
    mesh: Mesh,
    forest: forest_mod.Forest | None = None,
    axis: str = "agent",
) -> Callable:
    """Agent-sharded C-ADMM control step ``step(admm_state, state,
    acc_des) -> (f_app, admm_state, stats)`` over ``mesh.shape[axis]``
    shards, for scenario-batched state as ``cadmm.control`` takes it. The
    Schur plan is built once, for every agent. Requires ``n % d == 0``."""
    d = mesh.shape[axis]
    plan = cadmm.make_plan(params, cfg)
    return sharded_step(
        lambda cs, s, a: cadmm.control(params, cfg, f_eq, cs, s, a, forest,
                                       shards=d, plan=plan),
        params.n, d)


def dd_control_sharded(
    params: RQPParams,
    cfg: dd.RQPDDConfig,
    f_eq: torch.Tensor,
    mesh: Mesh,
    forest: forest_mod.Forest | None = None,
    axis: str = "agent",
) -> Callable:
    """Agent-sharded DD control step ``step(dd_state, state, acc_des) ->
    (f, dd_state, stats)`` (the C-ADMM twin above); the quasi-Newton plan
    is built once. Requires ``n % d == 0``."""
    d = mesh.shape[axis]
    plan = dd.make_dd_plan(params, cfg)
    return sharded_step(
        lambda cs, s, a: dd.control(params, cfg, f_eq, cs, s, a, forest,
                                    shards=d, plan=plan),
        params.n, d)


def rp_cadmm_control_sharded(
    params,
    cfg: rp_cadmm.RPCADMMConfig,
    f_eq: torch.Tensor,
    mesh: Mesh,
    axis: str = "agent",
) -> Callable:
    """Agent-sharded RP C-ADMM control step ``step(cstate, state, acc_des)
    -> (f_own, cstate, stats)`` over ``mesh.shape[axis]`` shards, for
    scenario-batched state as ``rp_cadmm.control`` takes it: the consensus
    mean as a block sum exchanged over the shards, over n, and the
    residual as a block max exchanged likewise (the JAX package's
    ``psum``/``pmax``). Requires ``n % d == 0``."""
    d = mesh.shape[axis]
    return sharded_step(
        lambda cs, s, a: rp_cadmm.control(params, cfg, f_eq, cs, s, a,
                                          shards=d),
        params.n, d)


# ----------------------------------------------------------------------
# The scenario tier: Monte-Carlo batches placed on a mesh.
# ----------------------------------------------------------------------

def is_multiprocess_mesh(mesh) -> bool:
    """True when ``mesh`` spans more than one process (a pods mesh whose
    gloo group has two ranks or more): placement then takes this process's
    slab of a host-global batch (``parallel.pods.place_global_batch``).
    The one-axis :class:`Mesh` never does."""
    group = getattr(mesh, "group", None)
    return group is not None and group.size() > 1


def shard_scenarios(mesh, batch, axis: str = "scenario"):
    """Place a leading-axis Monte-Carlo batch (a tree of tensors) on the
    mesh, sharded over ``axis``: on a MULTI-process mesh, each process's
    rows of the host-global batch every process passes
    (``parallel.pods.place_global_batch``, the serving tier's ``mesh=``
    contract); otherwise one card holds the whole batch, moved to the
    mesh's device (a one-axis :class:`Mesh` has none, and leaves the batch
    where it is). Every leaf's leading axis must divide by the axis's
    shard count, as a sharding over it requires."""
    if is_multiprocess_mesh(mesh):
        from tpu_aerial_transport_torch.parallel import pods

        return pods.place_global_batch(mesh, batch, axis=axis)
    if axis not in mesh.shape:
        raise ValueError(f"axis={axis!r} is not an axis of the mesh "
                         f"{mesh.shape}")
    d = mesh.shape[axis]
    dev = getattr(mesh, "device", None)

    def put(t):
        if t.dim() and t.shape[0] % d:
            raise ValueError(f"a leading axis of {t.shape[0]} does not "
                             f"divide over {d} {axis!r} shards")
        return t if dev is None else t.to(dev)

    return tree_map(put, batch)


def scenario_rollout(rollout_fn: Callable, mesh, axis: str = "scenario"):
    """A Monte-Carlo batch rollout on the mesh: ``run(batch_args)`` places
    the batch (:func:`shard_scenarios`) and calls
    ``rollout_fn(*batch_args)``, which takes the scenario axis itself (the
    port's rollouts are batched; there is no ``vmap`` or ``jit`` to
    build, and no ``donate``: PyTorch hands back new tensors).
    ``run.batched_jit`` is ``rollout_fn``."""

    def run(batch_args):
        return rollout_fn(*shard_scenarios(mesh, batch_args, axis))

    run.batched_jit = rollout_fn
    return run


def vmap_chunk_jit(chunk_fn: Callable) -> Callable:
    """The batched chunk of :func:`scenario_rollout_resumable`: the port's
    chunk ``(carry, i0) -> (carry, logs)`` is batched already, so this
    only lays its logs out as ``jax.vmap`` of the JAX chunk does, scenario
    first and time second (``(S, T, ...)``), so a process's logs are its
    slab of scenario rows. The chunk's ``logs_spec`` (the resume template)
    is carried over in the same layout."""

    def batched(carry, i0):
        carry, logs = chunk_fn(carry, i0)
        return carry, tree_map(lambda t: t.movedim(0, 1).contiguous(), logs)

    spec = getattr(chunk_fn, "logs_spec", None)
    if spec is not None:
        batched.logs_spec = lambda carry: tree_map(
            lambda s: TensorSpec((s.shape[1], s.shape[0]) + s.shape[2:],
                                 s.dtype, s.device), spec(carry))
    return batched


def scenario_rollout_resumable(
    chunk_fn: Callable,
    mesh,
    *,
    n_hl_steps: int,
    n_chunks: int,
    run_dir: str,
    axis: str = "scenario",
    config_hash: str | None = None,
    seed: int | None = None,
    keep_last: int = 3,
    max_retries: int = 1,
    meta: dict | None = None,
    metrics=None,
):
    """Preemption-safe twin of :func:`scenario_rollout`: the batch's
    chunked rollout with the batched carry snapshotted at every chunk
    boundary (``resilience.recovery``) and a host-level retry that re-places
    the last boundary's host copy on the mesh (:func:`shard_scenarios`).

    ``chunk_fn`` is the chunk ``(carry, i0) -> (carry, logs)`` of a
    chunked rollout (``make_chunked_rollout(...).chunk_fn``), batched by
    :func:`vmap_chunk_jit`: the logs lead with the scenario axis, time is
    axis 1. ``n_hl_steps`` must divide into ``n_chunks`` as the chunk was
    built. Returns ``run(batch_carry, resume=False, interrupt=None) ->
    recovery.RunResult``; ``resume=True`` restores the newest fully valid
    boundary from ``run_dir`` (``batch_carry`` then being the regenerated
    chunk-0 carry, the template). ``run.batched_jit`` is the batched
    chunk; ``metrics`` as in ``recovery.run_chunks``."""
    from tpu_aerial_transport_torch.resilience import recovery

    if n_hl_steps % n_chunks:
        # RunPlan.chunk_len is a floor division: an uneven split would give
        # chunk offsets that disagree with the chunk's own length.
        raise ValueError(
            f"n_hl_steps={n_hl_steps} not divisible by n_chunks={n_chunks}"
            " -- must match the chunking the chunk_fn was built with"
        )
    batched_jit = vmap_chunk_jit(chunk_fn)
    plan = recovery.RunPlan(
        run_dir=run_dir, n_hl_steps=n_hl_steps, n_chunks=n_chunks,
        seed=seed, config_hash=config_hash, keep_last=keep_last,
        logs_time_axis=1, meta=meta or {},
    )

    def place(batch_carry):
        return shard_scenarios(mesh, batch_carry, axis)

    def run(batch_carry, resume: bool = False, interrupt=None):
        if resume:
            return recovery.resume_run(
                run_dir, batched_jit, batch_carry,
                config_hash=config_hash, interrupt=interrupt, place=place,
                max_retries=max_retries, metrics=metrics,
            )
        return recovery.run_chunks(
            plan, batched_jit, batch_carry, interrupt=interrupt,
            place=place, max_retries=max_retries, metrics=metrics,
        )

    run.batched_jit = batched_jit
    run.plan = plan
    return run
