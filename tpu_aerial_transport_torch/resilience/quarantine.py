"""Per-scenario NaN quarantine utilities.

Counterpart of ``tpu_aerial_transport/resilience/quarantine.py`` over the
port's explicit scenario axis. In a Monte-Carlo batch one diverging
scenario would otherwise poison every batched statistic and, through the
batched consensus loop's any-scenario trip count, hold the batch's loop
open. Quarantine freezes a scenario at its last finite state and raises a
sticky flag; aggregate statistics then exclude flagged scenarios
(:func:`utils.stats.compute_aggregate_statistics` with ``valid=``).
"""

from __future__ import annotations

import torch

from tpu_aerial_transport_torch.tree import leaves, tree_map


def tree_all_finite(tree) -> torch.Tensor:
    """``(S,)`` bool: True for a scenario whose floating leaves are all
    finite. Every leaf carries the leading scenario axis; the reduction
    runs over every other axis. Integer and bool leaves (step counters,
    flags) are ignored: they cannot hold NaN or inf."""
    ts = leaves(tree)
    ok = torch.ones((ts[0].shape[0],), dtype=torch.bool,
                    device=ts[0].device)
    for t in ts:
        if t.is_floating_point():
            ok = ok & torch.isfinite(t).reshape(t.shape[0], -1).all(dim=1)
    return ok


def tree_where(pred: torch.Tensor, on_true, on_false):
    """``torch.where`` over matching trees with a per-scenario ``(S,)``
    predicate broadcast over each leaf. Both trees must have the same
    structure, ``None`` leaves included."""

    def sel(a, b):
        return torch.where(pred.reshape(pred.shape + (1,) * (a.dim() - 1)),
                           a, b)

    return tree_map(sel, on_true, on_false)
