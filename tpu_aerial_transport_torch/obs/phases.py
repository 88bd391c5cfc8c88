"""Phase vocabulary for trace attribution.

Counterpart of ``tpu_aerial_transport/obs/phases.py``: every hot region is
wrapped in ``torch.profiler.record_function("tat.<phase>")``, so a
``torch.profiler`` trace on the card attributes host and device time to the
same phase names the JAX package's op profile uses.
"""

from __future__ import annotations

import functools

import torch

PREFIX = "tat."

QP_BUILD = "qp_build"          # per-agent QP matrix assembly + KKT ops.
CBF_ROWS = "cbf_rows"          # env CBF row construction.
ENV_QUERY = "env_query"        # the environment distance sweep itself.
LOCAL_SOLVE = "local_solve"    # per-agent conic QP solves (inner ADMM).
FUSED_SOLVE = "fused_solve"    # the whole-solve ADMM kernel launch.
CONSENSUS = "consensus"        # consensus mean / residual.
# Cross-shard exchange of the agent-sharded controllers (parallel/ring.py).
CONSENSUS_EXCHANGE = "consensus_exchange"
DUAL_UPDATE = "dual_update"    # dual ascent step.
DYNAMICS = "dynamics"          # low-level control + physics substeps.
PAD = "pad"                    # tile pad of operators.
SHARDED_STEP = "sharded_step"  # an agent-sharded step's plumbing.
FAULTS = "faults"              # fault-schedule evaluation + sensor noise.
FALLBACK = "fallback"          # force-fallback ladder + NaN quarantine.
TELEMETRY = "telemetry"        # run-health accumulator update.


def scope(phase: str) -> torch.profiler.record_function:
    """``with scope(phases.LOCAL_SOLVE): ...`` -- a fresh
    ``record_function`` carrying the ``tat.`` prefix."""
    return torch.profiler.record_function(PREFIX + phase)


def scoped(phase: str):
    """Decorator form of :func:`scope` (a new range per call)."""

    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            with scope(phase):
                return fn(*args, **kwargs)

        return inner

    return wrap
