"""Aggregate statistics.

Counterpart of ``tpu_aerial_transport/utils/stats.py``.
"""

from __future__ import annotations

import math

import torch


def compute_aggregate_statistics(a, axis: int = 0, valid=None):
    """``(min, max, avg, std)`` of ``a`` along ``axis`` (population std).

    ``valid``: optional bool mask of length ``a.shape[axis]`` selecting the
    slices that enter the statistics -- the NaN-quarantine hook: pass
    ``~logs.quarantined[-1]`` so a diverged scenario is excluded instead of
    poisoning every aggregate. With no valid slice the min/max are
    ``+inf``/``-inf`` and avg/std 0. ``valid=None`` is the unmasked path."""
    a = torch.as_tensor(a)
    if valid is None:
        return (torch.amin(a, dim=axis), torch.amax(a, dim=axis),
                torch.mean(a, dim=axis), torch.std(a, dim=axis, correction=0))
    valid = torch.as_tensor(valid, device=a.device).to(torch.bool)
    shape = [1] * a.dim()
    shape[axis] = valid.shape[0]
    m = valid.reshape(shape)
    w = m.to(a.dtype)
    cnt = torch.clamp(torch.sum(w, dim=axis), min=1.0)
    zero = torch.zeros((), dtype=a.dtype, device=a.device)
    avg = torch.sum(torch.where(m, a, zero), dim=axis) / cnt
    var = torch.sum(torch.where(m, (a - avg.unsqueeze(axis)) ** 2, zero),
                    dim=axis) / cnt
    return (
        torch.amin(torch.where(m, a, zero + math.inf), dim=axis),
        torch.amax(torch.where(m, a, zero - math.inf), dim=axis),
        avg,
        torch.sqrt(var),
    )
