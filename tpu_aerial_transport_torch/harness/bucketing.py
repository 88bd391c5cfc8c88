"""Shape bucketing and congestion-bucketed Monte-Carlo batching.

Counterpart of ``tpu_aerial_transport/harness/bucketing.py``. A batched
consensus loop runs every scenario until the slowest one converges (a
converged scenario's carry freezes, but the batch pays its iterations),
so one congested scenario drags the batch. Consensus iteration counts
follow how many obstacle CBF rows are active, which is observable before
solving: :func:`bucketed_step` sorts the batch by a cheap congestion metric
(:func:`env_congestion_metric`), runs the step once per contiguous group of
``B / n_buckets`` scenarios, and scatters the results back to input order.
Per-scenario results are the unbucketed ones: the same solves on the same
data, grouped. ``quarantine_guarded_metric`` comes with the NaN
quarantine it wraps (ROADMAP Queue 1 item 6).
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch

from tpu_aerial_transport_torch.tree import leaves, tree_map


def bucket_dim(d: int, tile: int) -> int:
    """Round a static dim up to the next ``tile`` multiple."""
    if d < 0 or tile <= 0:
        raise ValueError((d, tile))
    return ((d + tile - 1) // tile) * tile


def pick_bucket(size: int, buckets: Sequence[int]) -> int | None:
    """The smallest bucket that admits ``size`` (bucket >= size), or None
    when none does. Duplicate bucket values resolve to that value."""
    if size < 0:
        raise ValueError(f"pick_bucket: negative size {size}")
    if not buckets:
        raise ValueError("pick_bucket: empty bucket list")
    admitting = [b for b in buckets if b >= size]
    return min(admitting) if admitting else None


def env_congestion_metric(forest, vision_radius: float) -> Callable:
    """``metric(states) -> (B,) int64``: per scenario, the number of live
    trees whose axis lies within ``vision_radius`` of the payload (in the
    horizontal plane), a proxy for how many environment CBF rows will be
    active."""

    def metric(states):
        dxy = forest.tree_pos[:, :2] - states.xl[..., None, :2]
        d = torch.sqrt(torch.sum(dxy * dxy, dim=-1))
        alive = (torch.arange(forest.tree_pos.shape[0],
                              device=forest.tree_pos.device)
                 < forest.num_trees)
        return torch.sum((d < vision_radius) & alive, dim=-1)

    return metric


def bucketed_step(step_fn: Callable, metric_fn: Callable,
                  n_buckets: int = 2) -> Callable:
    """Wrap a batched MPC step ``step_fn(css, states) -> (css, states,
    stats)`` (leading scenario axis on every leaf) into one that runs
    ``step_fn`` once per group of ``B / n_buckets`` scenarios, grouped by
    ascending ``metric_fn(states)``, and returns the results in input
    order. The sort is stable, as ``jnp.argsort`` is, so tied metrics
    group as in the JAX package. ``B`` must be divisible by
    ``n_buckets``; ``n_buckets < 2`` returns ``step_fn``."""
    if n_buckets < 2:
        return step_fn

    def batched(css, states):
        B = leaves(states)[0].shape[0]
        if B % n_buckets != 0:
            divisors = [d for d in range(2, B + 1) if B % d == 0]
            raise ValueError(
                f"bucketed_step: batch size {B} is not divisible by "
                f"n_buckets={n_buckets} (static shapes require equal "
                f"buckets); valid bucket counts for this batch: {divisors}"
            )
        per = B // n_buckets
        order = torch.argsort(metric_fn(states), stable=True)
        inv = torch.argsort(order)
        css_s = tree_map(lambda t: t.index_select(0, order), css)
        states_s = tree_map(lambda t: t.index_select(0, order), states)
        outs = [step_fn(tree_map(lambda t: t[b * per:(b + 1) * per], css_s),
                        tree_map(lambda t: t[b * per:(b + 1) * per],
                                 states_s))
                for b in range(n_buckets)]
        out = tree_map(lambda *ts: torch.cat(ts, dim=0), *outs)
        return tree_map(lambda t: t.index_select(0, inv), out)

    return batched
