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

Not ported yet (ROADMAP): sharding scenarios across cards
(``shard_scenarios``, ``scenario_rollout*``) and the cross-card form of the
exchange.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch

from tpu_aerial_transport_torch.control import cadmm, dd, rp_cadmm
from tpu_aerial_transport_torch.envs import forest as forest_mod
from tpu_aerial_transport_torch.models.rqp import RQPParams
from tpu_aerial_transport_torch.obs import phases


@dataclass(frozen=True)
class Mesh:
    """One named shard axis: ``shape = {name: d}``, as a JAX mesh's."""

    shape: dict[str, int]


def make_mesh(axes: dict[str, int]) -> Mesh:
    """The shard axis ``axes = {name: d}`` (one axis)."""
    if len(axes) != 1:
        raise ValueError(
            f"axes={axes}: one shard axis only (scenario axes across cards "
            "are not ported)")
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
