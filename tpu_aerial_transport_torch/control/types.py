"""Shared controller data types.

Counterpart of ``tpu_aerial_transport/control/types.py``. Fields may carry
leading batch axes (scenarios, agents).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field

import torch

from tpu_aerial_transport_torch import resolve_device

@dataclass(frozen=True)
class SolverStats:
    """Per-control-step statistics (per scenario when batched): consensus
    iterations, final consensus residual, any-collision flag, min env
    distance, the NaN-padded per-iteration residual sequence, the
    worst-iteration fraction of agent solves that met ``solver_tol``, and
    the fallback-ladder rung the resilient rollout stamps on the step
    (controllers leave it 0), every agent's exit-time QP residual (set
    only under the controllers' ``track_agent_stats``, empty ``(..., 0)``
    otherwise) and the total effective inner ADMM iterations of the step
    (summed over agents and consensus iterations; set only under
    ``effort="adaptive"``, empty ``(..., 0)`` otherwise, as in the JAX
    package). An empty sentinel means "not tracked"."""

    iters: torch.Tensor  # (...) int32.
    solve_res: torch.Tensor  # (...).
    collision: torch.Tensor  # (...) bool.
    min_env_dist: torch.Tensor  # (...).
    err_seq: torch.Tensor  # (..., max_iter + 1).
    ok_frac: torch.Tensor  # (...).
    # 0 clean, 1 retried, 2 held previous force, 3 equilibrium forces.
    fallback_rung: torch.Tensor = field(  # (...) int32.
        default_factory=lambda: torch.zeros((), dtype=torch.int32))
    agent_solve_res: torch.Tensor = field(  # (..., n), or (..., 0).
        default_factory=lambda: torch.zeros((0,)))
    inner_iters: torch.Tensor = field(  # (...) int32, or (..., 0).
        default_factory=lambda: torch.zeros((0,), dtype=torch.int32))

    def replace(self, **kw) -> "SolverStats":
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class EnvCBF:
    """Environment CBF rows ``lhs @ dvl >= rhs`` plus observability outputs;
    inactive rows are ``lhs = 0`` with ``rhs < 0``."""

    lhs: torch.Tensor  # (..., k, 3).
    rhs: torch.Tensor  # (..., k).
    collision: torch.Tensor  # (...) bool.
    min_dist: torch.Tensor  # (...).

    def replace(self, **kw) -> "EnvCBF":
        return dataclasses.replace(self, **kw)


def inactive_env_cbf(n_rows: int, vision_radius: float, dist_eps: float,
                     alpha: float, device="cuda",
                     dtype=torch.float32) -> EnvCBF:
    """The no-environment default, on ``device`` (the card unless the
    caller asks for the CPU)."""
    device = resolve_device(device)
    return EnvCBF(
        lhs=torch.zeros((n_rows, 3), dtype=dtype, device=device),
        rhs=torch.full((n_rows,), -alpha * (vision_radius - dist_eps),
                       dtype=dtype, device=device),
        collision=torch.zeros((), dtype=torch.bool, device=device),
        min_dist=torch.full((), vision_radius, dtype=dtype, device=device),
    )
