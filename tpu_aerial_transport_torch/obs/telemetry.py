"""Run-health telemetry: a :class:`TelemetryState` accumulator threaded
through the rollouts and updated once per HL control step on the device, so
a long run answers "was this fleet healthy" from O(1) state instead of O(T)
logs.

Counterpart of ``tpu_aerial_transport/obs/telemetry.py``, over the port's
explicit scenario axis: every leaf of a batched accumulator carries the
leading scenario axis ``S`` (what ``jax.vmap`` gives in the JAX package).

Accumulated per step, from the controller's ``SolverStats`` and the
resilience layer's quarantine flag:

- the **fallback-rung histogram** (rungs 0-3, ``resilience.rollout``);
- **consensus-residual running percentiles** by the P² (P-squared)
  streaming estimator of Jain & Chlamtac -- 5 markers per tracked quantile,
  vectorized over the quantile axis -- plus exact running min/max/sum;
- the **safety-margin minima**: min environment CBF margin and worst-step
  ``ok_frac``;
- **counts**: collision steps, quarantined steps, consensus iterations and
  their log2-bucketed histogram (:data:`ITER_BUCKETS`), and, under
  ``effort="adaptive"``, the inner iterations per solve;
- **per-agent solve health** (``track_agents``; needs the controller's
  ``track_agent_stats``): per agent, the steps whose final QP residual
  missed ``solver_tol`` and the worst residual.

``telemetry=None`` and ``no_telemetry()`` take the telemetry-less path at
the Python level. The host readers (:func:`summary` and the rest) return
the JAX package's dict keys.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass

import numpy as np
import torch

from tpu_aerial_transport_torch import resolve_device

# Fallback-ladder rung count (resilience.rollout RUNG_* 0-3).
N_RUNGS = 4

# Solver-effort histogram buckets: log2-spaced upper edges, the last bucket
# the overflow. Bucket i counts v with ITER_BUCKETS[i-1] < v <= ITER_BUCKETS[i].
ITER_BUCKETS = (1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024, 2048)
N_ITER_BUCKETS = len(ITER_BUCKETS) + 1


def iter_bucket_index(v: torch.Tensor) -> torch.Tensor:
    """The bucket of each observation (int or float; the inner-effort
    stream is a per-solve ratio, bucketed un-floored). The edges, powers
    of two, are made on the device: no host-to-device copy a step."""
    edges = (2 ** torch.arange(len(ITER_BUCKETS), device=v.device)).to(
        v.dtype)
    return torch.sum((v[..., None] > edges).to(torch.int32), dim=-1)


def _iter_one_hot(v: torch.Tensor) -> torch.Tensor:
    return (iter_bucket_index(v)[..., None]
            == torch.arange(N_ITER_BUCKETS, device=v.device)).to(torch.int32)


def iter_histogram(values) -> np.ndarray:
    """Host histogram on the :data:`ITER_BUCKETS` grid with the same
    right-closed buckets as :func:`iter_bucket_index`."""
    v = np.asarray(values).reshape(-1)
    idx = np.searchsorted(np.asarray(ITER_BUCKETS), v, side="left")
    return np.bincount(idx, minlength=N_ITER_BUCKETS)


@dataclass(frozen=True)
class TelemetryConfig:
    """Telemetry knobs: ``active``, ``quantiles`` and ``track_agents`` fix
    the accumulator's structure; ``solver_tol`` is the per-agent failure
    threshold (the controllers' ``solver_tol``)."""

    active: bool = True
    quantiles: tuple = (0.5, 0.9, 0.99)
    # Needs the controller config's track_agent_stats=True (C-ADMM, DD).
    track_agents: bool = False
    solver_tol: float = 5e-3


@dataclass(frozen=True)
class TelemetryState:
    """The accumulator; leaves ``(*batch, ...)``. ``quantiles`` and
    ``n_agents`` are static fields (the P² rows' labels and the fleet size
    the inner-effort histogram divides by), so a host copy is
    self-describing."""

    steps: torch.Tensor  # int32 HL steps accumulated.
    rung_hist: torch.Tensor  # (N_RUNGS,) int32.
    iters_sum: torch.Tensor  # int32 consensus iterations.
    consensus_hist: torch.Tensor  # (N_ITER_BUCKETS,) int32.
    inner_hist: torch.Tensor  # (N_ITER_BUCKETS,) int32.
    inner_iters_sum: torch.Tensor  # int32.
    ok_frac_min: torch.Tensor
    min_env_dist: torch.Tensor
    collision_steps: torch.Tensor  # int32.
    quarantine_steps: torch.Tensor  # int32.
    # The consensus-residual stream (finite observations only).
    res_count: torch.Tensor  # int32.
    res_min: torch.Tensor
    res_max: torch.Tensor
    res_sum: torch.Tensor
    p2_q: torch.Tensor  # (Q, 5) P² marker heights.
    p2_n: torch.Tensor  # (Q, 5) P² marker positions.
    agent_fail_steps: torch.Tensor  # (n,) int32, or (0,).
    agent_res_max: torch.Tensor  # (n,), or (0,).
    quantiles: tuple = (0.5, 0.9, 0.99)
    n_agents: int = 0

    def replace(self, **kw) -> "TelemetryState":
        return dataclasses.replace(self, **kw)


LEAF_FIELDS = tuple(f.name for f in dataclasses.fields(TelemetryState)
                    if f.name not in ("quantiles", "n_agents"))
INT_FIELDS = ("steps", "rung_hist", "iters_sum", "consensus_hist",
              "inner_hist", "inner_iters_sum", "collision_steps",
              "quarantine_steps", "res_count", "agent_fail_steps")


def no_telemetry() -> TelemetryConfig:
    """A disabled config: the rollouts take their telemetry-less path."""
    return TelemetryConfig(active=False)


def init_telemetry(cfg: TelemetryConfig, n_agents: int = 0,
                   dtype=torch.float32, device="cuda",
                   batch: tuple = ()) -> TelemetryState:
    """A fresh accumulator on ``device`` with leading axes ``batch`` (the
    rollouts pass ``(S,)``). ``n_agents`` sizes the per-agent leaves when
    ``cfg.track_agents``."""
    dev = resolve_device(device)
    batch = tuple(batch)
    nq = len(cfg.quantiles)
    na = n_agents if cfg.track_agents else 0

    def zeros(*shape, dt=torch.int32):
        return torch.zeros(batch + shape, dtype=dt, device=dev)

    def full(v, *shape):
        return torch.full(batch + shape, v, dtype=dtype, device=dev)

    return TelemetryState(
        quantiles=tuple(cfg.quantiles),
        n_agents=int(n_agents),
        steps=zeros(),
        rung_hist=zeros(N_RUNGS),
        iters_sum=zeros(),
        consensus_hist=zeros(N_ITER_BUCKETS),
        inner_hist=zeros(N_ITER_BUCKETS),
        inner_iters_sum=zeros(),
        ok_frac_min=full(1.0),
        min_env_dist=full(math.inf),
        collision_steps=zeros(),
        quarantine_steps=zeros(),
        res_count=zeros(),
        res_min=full(math.inf),
        res_max=full(-math.inf),
        res_sum=full(0.0),
        # +inf padding: the bootstrap insert-and-sort keeps the first < 5
        # observations sorted in the leading columns.
        p2_q=full(math.inf, nq, 5),
        p2_n=torch.arange(1.0, 6.0, dtype=dtype, device=dev).expand(
            batch + (nq, 5)).clone(),
        agent_fail_steps=zeros(na),
        agent_res_max=full(-math.inf, na),
    )


def _p2_update(cfg: TelemetryConfig, q, npos, count, x):
    """One P² observation, vectorized over the quantile axis and any
    leading batch axes. ``q``/``npos`` ``(..., Q, 5)`` are the marker
    heights and positions, ``count (...)`` the number of prior
    observations, ``x (...)`` the new one. The three middle markers adjust
    in parallel from the pre-observation snapshot, as in the JAX package."""
    dtype, dev = q.dtype, q.device
    # (Q,), from fills: no host-to-device copy an observation.
    quant = torch.stack([torch.full((), p, dtype=dtype, device=dev)
                         for p in cfg.quantiles])
    # Desired positions for count+1 observations: 1 + count * d.
    dvec = torch.stack([
        torch.zeros_like(quant), quant / 2.0, quant,
        (1.0 + quant) / 2.0, torch.ones_like(quant),
    ], dim=1)  # (Q, 5)
    xq = x[..., None, None]  # (..., 1, 1)

    # Bootstrap (< 5 observations): insert sorted, positions fixed.
    col = torch.clamp(count, max=4).to(torch.int64)[..., None, None]
    q_boot = torch.sort(q.scatter(
        -1, col.expand(q.shape[:-1] + (1,)),
        xq.expand(q.shape[:-1] + (1,))), dim=-1).values

    # Main path (>= 5 observations), computed unconditionally and selected
    # below; the inf-padded bootstrap rows' NaNs never pass the select.
    qc = torch.cat([torch.minimum(q[..., :1], xq), q[..., 1:4],
                    torch.maximum(q[..., 4:], xq)], dim=-1)
    # Cell k in 0..3 with q[k] <= x < q[k+1] (edges clamped).
    k = torch.clamp(torch.sum((xq >= qc[..., 1:4]).to(torch.int32), dim=-1),
                    0, 3)
    npos_inc = npos + (torch.arange(5, device=dev) > k[..., None]).to(dtype)
    ndes = 1.0 + count.to(dtype)[..., None, None] * dvec
    nm, ni, npl = npos_inc[..., :-2], npos_inc[..., 1:-1], npos_inc[..., 2:]
    qm, qi, qp = qc[..., :-2], qc[..., 1:-1], qc[..., 2:]
    di = ndes[..., 1:-1] - ni
    one = torch.ones((), dtype=dtype, device=dev)
    s = torch.where(
        (di >= 1.0) & (npl - ni > 1.0), one,
        torch.where((di <= -1.0) & (nm - ni < -1.0), -one, 0.0 * one))
    # Piecewise-parabolic height, linear where the parabola leaves the
    # bracketing markers.
    gap_r = torch.clamp(npl - ni, min=1.0)
    gap_l = torch.clamp(ni - nm, min=1.0)
    qpar = qi + s / (npl - nm) * (
        (ni - nm + s) * (qp - qi) / gap_r + (npl - ni - s) * (qi - qm) / gap_l
    )
    qlin = qi + s * torch.where(s >= 0.0, (qp - qi) / gap_r,
                                (qi - qm) / gap_l)
    q_mid = torch.where(
        s != 0.0, torch.where((qm < qpar) & (qpar < qp), qpar, qlin), qi)
    q_main = torch.cat([qc[..., :1], q_mid, qc[..., 4:]], dim=-1)
    npos_main = torch.cat([npos_inc[..., :1], npos_inc[..., 1:-1] + s,
                           npos_inc[..., 4:]], dim=-1)

    boot = (count < 5)[..., None, None]
    return (torch.where(boot, q_boot, q_main),
            torch.where(boot, npos, npos_main))


def _tracked(x: torch.Tensor | None, batch: torch.Size) -> bool:
    """A per-step stat is tracked when it has the accumulator's batch shape
    (the empty ``(..., 0)`` sentinel means not tracked)."""
    return x is not None and x.shape == batch


def update(cfg: TelemetryConfig, tel: TelemetryState, stats,
           quarantined: torch.Tensor | None = None) -> TelemetryState:
    """Fold one control step's ``SolverStats`` (after the ladder's rung
    stamp) into the accumulator: tensor ops on the accumulator's device,
    no host round trip. ``quarantined`` is the resilience layer's sticky
    per-scenario flag (None in the nominal rollout). Raises ValueError when
    ``track_agents`` is on and the stats carry no matching
    ``agent_solve_res``."""
    dtype, dev = tel.res_min.dtype, tel.res_min.device
    batch = tel.steps.shape
    i32 = torch.int32
    rung = torch.clamp(stats.fallback_rung.to(i32), 0, N_RUNGS - 1)
    rung_hist = tel.rung_hist + (
        rung[..., None] == torch.arange(N_RUNGS, device=dev)).to(i32)

    # The residual stream: finite observations only.
    x = stats.solve_res.to(dtype)
    finite = torch.isfinite(x)
    p2_q, p2_n = _p2_update(cfg, tel.p2_q, tel.p2_n, tel.res_count, x)

    na = tel.agent_fail_steps.shape[-1]
    agent_res = getattr(stats, "agent_solve_res", None)
    if na and (agent_res is None or agent_res.shape != batch + (na,)):
        raise ValueError(
            "telemetry.track_agents is on but this controller's "
            "SolverStats carries no matching agent_solve_res -- enable "
            "track_agent_stats in the controller make_config "
            f"(telemetry expects {tuple(batch + (na,))}, stats has "
            f"{None if agent_res is None else tuple(agent_res.shape)})")
    if na:
        a_res = agent_res.to(dtype)
        a_fin = torch.isfinite(a_res)
        agent_fail = tel.agent_fail_steps + (
            ~a_fin | (a_res >= cfg.solver_tol)).to(i32)
        agent_max = torch.maximum(
            tel.agent_res_max,
            torch.where(a_fin, a_res, torch.full_like(a_res, -math.inf)))
    else:
        agent_fail, agent_max = tel.agent_fail_steps, tel.agent_res_max

    quar = (torch.zeros(batch, dtype=torch.bool, device=dev)
            if quarantined is None else quarantined.to(torch.bool))
    # Consensus effort: a negative iteration count (the centralized
    # controller's "no consensus loop") stays out of the histogram; the
    # inner effort enters per solve (per consensus iteration per agent)
    # when the controller tracks it.
    iters = stats.iters.to(i32)
    iters_step = torch.clamp(iters, min=0)
    consensus_hist = tel.consensus_hist + _iter_one_hot(iters_step) * (
        iters >= 0).to(i32)[..., None]
    inner = getattr(stats, "inner_iters", None)
    if _tracked(inner, batch):
        inner_step = torch.clamp(inner.to(i32), min=0)
        inner_hist = tel.inner_hist + _iter_one_hot(
            inner_step.to(dtype)
            / (torch.clamp(iters_step, min=1) * max(tel.n_agents, 1)))
        inner_sum = tel.inner_iters_sum + inner_step
    else:
        inner_hist, inner_sum = tel.inner_hist, tel.inner_iters_sum
    fin_q = finite[..., None, None]
    return TelemetryState(
        quantiles=tel.quantiles,
        n_agents=tel.n_agents,
        steps=tel.steps + 1,
        rung_hist=rung_hist,
        iters_sum=tel.iters_sum + iters_step,
        consensus_hist=consensus_hist,
        inner_hist=inner_hist,
        inner_iters_sum=inner_sum,
        ok_frac_min=torch.minimum(tel.ok_frac_min, stats.ok_frac.to(dtype)),
        min_env_dist=torch.minimum(tel.min_env_dist,
                                   stats.min_env_dist.to(dtype)),
        collision_steps=tel.collision_steps + stats.collision.to(i32),
        quarantine_steps=tel.quarantine_steps + quar.to(i32),
        res_count=tel.res_count + finite.to(i32),
        res_min=torch.where(finite, torch.minimum(tel.res_min, x),
                            tel.res_min),
        res_max=torch.where(finite, torch.maximum(tel.res_max, x),
                            tel.res_max),
        res_sum=torch.where(finite, tel.res_sum + x, tel.res_sum),
        p2_q=torch.where(fin_q, p2_q, tel.p2_q),
        p2_n=torch.where(fin_q, p2_n, tel.p2_n),
        agent_fail_steps=agent_fail,
        agent_res_max=agent_max,
    )


# --- Host readers (numpy). ---------------------------------------------


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def find_state(tree):
    """The first :class:`TelemetryState` inside a carry (tuples, lists,
    dataclasses), or None."""
    if isinstance(tree, TelemetryState):
        return tree
    if isinstance(tree, (tuple, list)):
        kids = list(tree)
    elif dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        kids = [getattr(tree, f.name) for f in dataclasses.fields(tree)]
    else:
        return None
    for kid in kids:
        found = find_state(kid)
        if found is not None:
            return found
    return None


def _lane_summaries(tel: TelemetryState) -> list[TelemetryState]:
    """A batched accumulator split into per-scenario states with numpy
    leaves."""
    leaves = {k: _host(getattr(tel, k)) for k in LEAF_FIELDS}
    return [tel.replace(**{k: v[i] for k, v in leaves.items()})
            for i in range(leaves["steps"].shape[0])]


def residual_percentiles(tel: TelemetryState,
                         quantiles=None) -> dict[str, float]:
    """Percentile estimates from the P² markers: the centre marker from 5
    observations on, exact small-sample percentiles of the sorted
    bootstrap markers below that; a running max keeps ascending quantiles
    monotone. The labels come from ``tel.quantiles``."""
    quantiles = tel.quantiles if quantiles is None else quantiles
    q_arr = _host(tel.p2_q)
    if len(quantiles) != q_arr.shape[0]:
        raise ValueError(
            f"{len(quantiles)} quantile labels for {q_arr.shape[0]} P² "
            "marker rows -- read the labels from tel.quantiles (they are "
            "part of the state)")
    count = int(_host(tel.res_count))
    out = {}
    prev = -np.inf
    for i, p in enumerate(quantiles):
        key = "p%g" % (p * 100)
        if count == 0:
            out[key] = None
        elif count < 5:
            vals = q_arr[i][np.isfinite(q_arr[i])]
            out[key] = (float(np.percentile(vals, p * 100)) if len(vals)
                        else None)
        else:
            out[key] = float(max(q_arr[i, 2], prev))
            prev = out[key]
    return out


def hist_percentile(hist, p: float):
    """The upper edge of the first :data:`ITER_BUCKETS` bucket whose
    cumulative count reaches ``p`` of the total; None for an empty
    histogram and for the overflow bucket."""
    hist = _host(hist)
    total = int(hist.sum())
    if not total:
        return None
    idx = int(np.searchsorted(np.cumsum(hist), p * total))
    if idx >= len(ITER_BUCKETS):
        return None
    return ITER_BUCKETS[idx]


def _effort_summary(tel: TelemetryState) -> dict:
    """The solver-effort block: the consensus-iteration histogram, its mean
    and bucket p99, and the per-solve inner-iteration histogram and totals
    where the controller tracked them."""
    steps = int(_host(tel.steps))
    iters_sum = int(_host(tel.iters_sum))
    inner_sum = int(_host(tel.inner_iters_sum))
    out = {
        "buckets": list(ITER_BUCKETS),
        "consensus_hist": [int(v) for v in _host(tel.consensus_hist)],
        "iters_mean": (iters_sum / steps) if steps else None,
        "iters_p99": hist_percentile(tel.consensus_hist, 0.99),
    }
    if int(_host(tel.inner_hist).sum()) or inner_sum:
        na = max(tel.n_agents, 1)
        out["inner_hist"] = [int(v) for v in _host(tel.inner_hist)]
        out["inner_iters_sum"] = inner_sum
        out["n_agents"] = tel.n_agents
        out["inner_per_solve_mean"] = (
            inner_sum / (iters_sum * na) if iters_sum else None)
        out["inner_per_solve_p99"] = hist_percentile(tel.inner_hist, 0.99)
    return out


def summary(tel: TelemetryState, cfg: TelemetryConfig | None = None) -> dict:
    """The accumulator as a JSON-ready dict (the JAX package's keys). A
    batched accumulator rolls up across scenarios: counts and histograms
    sum, minima take the fleet min, maxima the fleet max, each percentile
    the worst scenario's; ``lanes`` is the batch width. ``cfg`` is not
    consulted (the labels are the state's)."""
    del cfg
    if _host(tel.steps).ndim:
        return _batched_summary(tel)
    count = int(_host(tel.res_count))
    out = {
        "steps": int(_host(tel.steps)),
        "rung_hist": [int(v) for v in _host(tel.rung_hist)],
        "iters_sum": int(_host(tel.iters_sum)),
        "ok_frac_min": float(_host(tel.ok_frac_min)),
        "min_env_dist": float(_host(tel.min_env_dist)),
        "collision_steps": int(_host(tel.collision_steps)),
        "quarantine_steps": int(_host(tel.quarantine_steps)),
        "effort": _effort_summary(tel),
        "residual": {
            "count": count,
            "min": float(_host(tel.res_min)) if count else None,
            "max": float(_host(tel.res_max)) if count else None,
            "mean": float(_host(tel.res_sum)) / count if count else None,
            **residual_percentiles(tel),
        },
    }
    if _host(tel.agent_fail_steps).shape[0]:
        out["agent_fail_steps"] = [int(v)
                                   for v in _host(tel.agent_fail_steps)]
        out["agent_res_max"] = [float(v) for v in _host(tel.agent_res_max)]
    return out


def _rollup_effort(per: list[dict], iters_sums: list[int]) -> dict:
    """Per-scenario effort blocks rolled up: histograms sum, means from the
    exact integer totals ``iters_sums``."""
    nb = N_ITER_BUCKETS
    hist = [sum(p["consensus_hist"][i] for p in per) for i in range(nb)]
    steps = sum(hist)
    iters_sum = sum(iters_sums)
    out = {
        "buckets": list(ITER_BUCKETS),
        "consensus_hist": hist,
        "iters_mean": (iters_sum / steps) if steps else None,
        "iters_p99": hist_percentile(hist, 0.99),
    }
    inners = [p for p in per if "inner_hist" in p]
    if inners:
        ih = [sum(p["inner_hist"][i] for p in inners) for i in range(nb)]
        isum = sum(p["inner_iters_sum"] for p in inners)
        na = max(inners[0].get("n_agents", 0), 1)
        out["inner_hist"] = ih
        out["inner_iters_sum"] = isum
        out["n_agents"] = inners[0].get("n_agents", 0)
        out["inner_per_solve_mean"] = (
            isum / (iters_sum * na) if iters_sum else None)
        out["inner_per_solve_p99"] = hist_percentile(ih, 0.99)
    return out


def _batched_summary(tel: TelemetryState) -> dict:
    """The cross-scenario roll-up of :func:`summary`."""
    per = [summary(t) for t in _lane_summaries(tel)]
    counts = [p["residual"]["count"] for p in per]
    total = sum(counts)

    def extreme(fn, key):
        return fn((p["residual"][key] for p in per
                   if p["residual"][key] is not None), default=None)

    out = {
        "lanes": len(per),
        "steps": max(p["steps"] for p in per),
        "rung_hist": [sum(p["rung_hist"][i] for p in per)
                      for i in range(N_RUNGS)],
        "iters_sum": sum(p["iters_sum"] for p in per),
        "effort": _rollup_effort([p["effort"] for p in per],
                                 [p["iters_sum"] for p in per]),
        "ok_frac_min": min(p["ok_frac_min"] for p in per),
        "min_env_dist": min(p["min_env_dist"] for p in per),
        "collision_steps": sum(p["collision_steps"] for p in per),
        "quarantine_steps": sum(p["quarantine_steps"] for p in per),
        "residual": {
            "count": total,
            "min": extreme(min, "min"),
            "max": extreme(max, "max"),
            "mean": (sum(p["residual"]["mean"] * c
                         for p, c in zip(per, counts) if c) / total
                     if total else None),
            # The worst scenario per quantile.
            **{"p%g" % (q * 100): extreme(max, "p%g" % (q * 100))
               for q in tel.quantiles},
        },
    }
    if "agent_fail_steps" in per[0]:
        na = len(per[0]["agent_fail_steps"])
        out["agent_fail_steps"] = [
            sum(p["agent_fail_steps"][i] for p in per) for i in range(na)]
        out["agent_res_max"] = [
            max(p["agent_res_max"][i] for p in per) for i in range(na)]
    return out
