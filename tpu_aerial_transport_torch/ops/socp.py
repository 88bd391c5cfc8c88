"""Batched conic QP/SOCP solver on tensors (ADMM).

Counterpart of ``tpu_aerial_transport/ops/socp.py``. Problem form:

    minimize    (1/2) x^T P x + q^T x
    subject to  A x + shift in C,   C = Box(lb, ub) x SOC(d_1) x ... x SOC(d_k)

with the first ``n_box`` rows box rows (equalities as ``lb == ub``) and the
rest second-order-cone blocks of static dims ``soc_dims``. Every argument
carries explicit leading batch axes (e.g. ``(S scenarios, n agents)``); the
solver folds them into one lane axis.

Three routes run the ADMM iterations (``solve_socp(fused=...)``, the
JAX package's ``fused`` modes of the same names):

- ``"kernel"`` (what ``"auto"`` asks for): the whole solve -- the ``w2 =
  [Minv q; A Minv q]`` build, the iterations with the prebuilt fused
  operator ``K2``, the exit residuals, and in the tolerance-chunked form
  the per-lane early exit -- in one call of
  ``ops.admm_kernel.fused_solve_lanes``;
- ``"pallas"``: ``w2`` and the residuals in plain tensor ops, the
  iterations in chunks through ``ops.admm_kernel.admm_chunk_lanes`` (one
  call for a fixed-iteration solve, one per chunk of a tolerance-chunked
  one, under :func:`_masked_chunk_loop`);
- ``"scan"``: the same as ``"pallas"`` with the chunks a plain loop of
  :func:`_admm_step`, on the tensors' device.

Each kernel call is the hand-written CUDA kernel for tensors on the card
and its plain PyTorch version for tensors on the CPU. Which route runs is
decided from the solve's shape alone, before any launch, by
:func:`runtime_fused_mode`: ``"kernel"`` or ``"pallas"`` becomes
``"scan"`` where the kernel cannot hold the shape (the centralized QPs
from n = 9 on: more than 16 SOC blocks), on the CPU and on the card alike.

``precision="bf16"`` stores the operators K2, Minv, A and P of route
``"kernel"`` in bfloat16 (the kernel's bf16 form; :func:`resolve_precision`).
On route ``"pallas"`` it is inert, as in the JAX package: the solve runs in
float32.
"""

from __future__ import annotations

import os
from typing import NamedTuple, Sequence

import torch

from tpu_aerial_transport_torch.harness.bucketing import bucket_dim
from tpu_aerial_transport_torch.obs import phases
from tpu_aerial_transport_torch.ops import admm_kernel

EQ_RHO_SCALE = 1e3  # rho boost for equality rows.
INF = 1e20  # "infinity" bound.

# The routes that run the ADMM iterations (see the module docstring).
ROUTES = ("kernel", "pallas", "scan")
# The consensus-level solver-effort vocabulary (controllers' ``effort=``
# knob; see :func:`resolve_effort`).
EFFORTS = ("fixed", "adaptive")
# Operator storage of route "kernel" (controllers' ``socp_precision=``; see
# :func:`resolve_precision`): float32, or bfloat16 storage with float32 sums.
PRECISIONS = ("f32", "bf16")

# Operator edges are padded to multiples of this when pad_operators is on
# (the JAX package's f32 sublane tile; on the card it keeps rows aligned).
SUBLANE_TILE = 8


class KKTOp(NamedTuple):
    """Precomputed ADMM x-update operator (see :func:`kkt_operator`)."""

    Minv: torch.Tensor  # (..., nv, nv) inverse of P + sigma I + A^T rho A.
    MinvAT: torch.Tensor  # (..., nv, m).
    K2: torch.Tensor  # (..., nv+m, nv+m) fused iteration operator.


class SOCPSolution(NamedTuple):
    x: torch.Tensor  # (..., nv) primal solution.
    y: torch.Tensor  # (..., m) dual solution.
    z: torch.Tensor  # (..., m) projected constraint values.
    prim_res: torch.Tensor  # (...) inf-norm of A x - z.
    dual_res: torch.Tensor  # (...) inf-norm of P x + q + A^T y.


class PaddedKKTOp(NamedTuple):
    """A tile-aligned solve bundle (:func:`padded_kkt_operator`): the
    padded problem data and the KKT operator built on it. Built once per
    (P, A), solved many times with only ``q`` and the warm start moving."""

    P: torch.Tensor  # (..., nv_p, nv_p) identity on the pad block.
    A: torch.Tensor  # (..., m_p, nv_p) zero pad rows and columns.
    lb: torch.Tensor  # (..., n_box_p) pad rows free.
    ub: torch.Tensor  # (..., n_box_p)
    shift: torch.Tensor  # (..., m_p) zero on the pad rows.
    op: KKTOp  # built from the padded data.


def padded_dims(nv: int, n_box: int, soc_dims: Sequence[int] = ()):
    """``(nv_p, n_box_p)``: ``nv`` and ``m = n_box + sum(soc_dims)`` rounded
    up to :data:`SUBLANE_TILE`; the row padding goes into the box region,
    so the SOC blocks keep their exact dims."""
    m = n_box + sum(soc_dims)
    return (bucket_dim(nv, SUBLANE_TILE),
            n_box_p_from(m, bucket_dim(m, SUBLANE_TILE), n_box))


def n_box_p_from(m: int, m_p: int, n_box: int) -> int:
    """Padded box-row count: all row padding lands in the box region."""
    return n_box + (m_p - m)


@phases.scoped(phases.PAD)
def pad_qp(P, q, A, lb, ub, shift=None, *, n_box: int,
           soc_dims: Sequence[int] = ()):
    """Pad a (batched) QP to its tile bucket, exactly: pad variables get a
    unit diagonal in ``P`` and zero ``q``/columns (they rest at 0); pad rows
    are zero ``A`` rows with free bounds and zero shift, placed after the
    real box rows and before the SOC blocks."""
    nv = P.shape[-1]
    m = A.shape[-2]
    nv_p, n_box_p = padded_dims(nv, n_box, soc_dims)
    pad_v = nv_p - nv
    pad_b = n_box_p - n_box
    batch = P.shape[:-2]
    kw = dict(dtype=P.dtype, device=P.device)
    P_p = torch.nn.functional.pad(P, (0, pad_v, 0, pad_v))
    if pad_v:
        P_p[..., nv:, nv:] += torch.eye(pad_v, **kw)
    q_p = torch.nn.functional.pad(q, (0, pad_v))
    A_rows = torch.cat(
        [A[..., :n_box, :], torch.zeros(batch + (pad_b, nv), **kw),
         A[..., n_box:, :]], dim=-2,
    )
    A_p = torch.nn.functional.pad(A_rows, (0, pad_v))
    lb_p = torch.cat([lb, torch.full(batch + (pad_b,), -INF, **kw)], dim=-1)
    ub_p = torch.cat([ub, torch.full(batch + (pad_b,), INF, **kw)], dim=-1)
    if shift is None:
        shift_p = torch.zeros(batch + (m + pad_b,), **kw)
    else:
        shift_p = torch.cat(
            [shift[..., :n_box], torch.zeros(batch + (pad_b,), **kw),
             shift[..., n_box:]], dim=-1,
        )
    return P_p, q_p, A_p, lb_p, ub_p, shift_p


@phases.scoped(phases.PAD)
def pad_warm(warm: SOCPSolution, *, n_box: int,
             soc_dims: Sequence[int] = ()) -> SOCPSolution:
    """An unpadded (batched) warm start in the padded layout: zero pad
    entries, the exact fixed point of the pad rows and variables."""
    nv = warm.x.shape[-1]
    nv_p, n_box_p = padded_dims(nv, n_box, soc_dims)
    pad_b = n_box_p - n_box

    def pad_rows(v):
        zeros = torch.zeros(v.shape[:-1] + (pad_b,), dtype=v.dtype,
                            device=v.device)
        return torch.cat([v[..., :n_box], zeros, v[..., n_box:]], dim=-1)

    return SOCPSolution(
        x=torch.nn.functional.pad(warm.x, (0, nv_p - nv)),
        y=pad_rows(warm.y), z=pad_rows(warm.z),
        prim_res=warm.prim_res, dual_res=warm.dual_res,
    )


@phases.scoped(phases.PAD)
def unpad_solution(sol: SOCPSolution, nv: int, n_box: int,
                   n_box_p: int) -> SOCPSolution:
    """A padded-layout solution in the unpadded layout: the pad variables
    and rows dropped. The residuals are already exact: the pad rows add
    exactly 0 to both inf-norms."""

    def drop_rows(v):
        return torch.cat([v[..., :n_box], v[..., n_box_p:]], dim=-1)

    return SOCPSolution(
        x=sol.x[..., :nv], y=drop_rows(sol.y), z=drop_rows(sol.z),
        prim_res=sol.prim_res, dual_res=sol.dual_res,
    )


def project_soc(z: torch.Tensor) -> torch.Tensor:
    """Projection of ``z = (t, v) (..., d)`` onto ``||v|| <= t``: keep inside,
    zero in the polar cone, radial shrink otherwise (``nrm > 0`` guarded)."""
    t = z[..., 0]
    v = z[..., 1:]
    nrm = torch.sqrt(torch.sum(v * v, dim=-1))
    inside = nrm <= t
    polar = nrm <= -t
    s = 0.5 * (t + nrm)
    zero = torch.zeros_like(t)
    pos = nrm > 0
    scale = torch.where(pos, s / torch.where(pos, nrm, torch.ones_like(nrm)),
                        zero)
    t_out = torch.where(inside, t, torch.where(polar, zero, s))
    v_out = torch.where(
        inside[..., None], v,
        torch.where(polar[..., None], torch.zeros_like(v),
                    scale[..., None] * v),
    )
    return torch.cat([t_out[..., None], v_out], dim=-1)


def _project_cone(z, lb, ub, n_box: int, soc_dims: Sequence[int], shift=None):
    """Projection onto the translated cone ``{z : z + shift in Box x SOC..}``,
    equal-dim SOC blocks projected together. ``shift=None`` adds nothing."""
    if shift is not None:
        z = z + shift
    parts = []
    if n_box:
        zb = z[..., :n_box]
        parts.append(torch.minimum(torch.maximum(zb, lb), ub))
    off = n_box
    dims = list(soc_dims)
    i = 0
    while i < len(dims):
        d = dims[i]
        j = i
        while j < len(dims) and dims[j] == d:
            j += 1
        k = j - i
        blk = z[..., off: off + k * d].reshape(*z.shape[:-1], k, d)
        parts.append(project_soc(blk).reshape(*z.shape[:-1], k * d))
        off += k * d
        i = j
    out = torch.cat(parts, dim=-1) if len(parts) > 1 else parts[0]
    if shift is not None:
        out = out - shift
    return out


def _mv(M: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return (M @ v[..., None])[..., 0]


def _admm_step(carry, K2, w2, rho_vec, lb, ub, shift, *, nv, n_box,
               soc_dims, alpha):
    """One batched ADMM iteration:
    ``v = K2 [x; rho z - y] - w2``, over-relaxation by ``alpha``, the
    translated cone projection and the dual update."""
    x, y, z = carry
    v = _mv(K2, torch.cat([x, rho_vec * z - y], dim=-1)) - w2
    x_new, Ax = v[..., :nv], v[..., nv:]
    Ax_rel = alpha * Ax + (1 - alpha) * z
    z_new = _project_cone(Ax_rel + y / rho_vec, lb, ub, n_box, soc_dims, shift)
    y_new = y + rho_vec * (Ax_rel - z_new)
    return (x_new, y_new, z_new)


def make_rho_vec(m: int, n_box: int, lb, ub, rho: float):
    """Per-row penalty: equality box rows (``ub - lb < 1e-9``) get
    ``rho * EQ_RHO_SCALE``. ``lb``/``ub`` ``(..., n_box)``."""
    batch = lb.shape[:-1]
    rho_vec = torch.full(batch + (m,), rho, dtype=lb.dtype, device=lb.device)
    if n_box:
        is_eq = (ub - lb) < 1e-9
        rho_vec[..., :n_box] = torch.where(
            is_eq, torch.full_like(lb, rho * EQ_RHO_SCALE),
            torch.full_like(lb, rho),
        )
    return rho_vec


def kkt_operator(P, A, rho_vec, sigma: float = 1e-6) -> KKTOp:
    """Invert ``P + sigma I + A^T diag(rho) A`` (symmetrised) and prebuild the
    fused iteration operator ``K2 = [[sigma Minv, Minv A^T], [A sigma Minv,
    A Minv A^T]]``. Batched over leading axes."""
    nv = P.shape[-1]
    AT = A.transpose(-1, -2)
    eye = torch.eye(nv, dtype=P.dtype, device=P.device)
    M = P + sigma * eye + (AT * rho_vec[..., None, :]) @ A
    Minv = torch.linalg.inv(M)
    Minv = 0.5 * (Minv + Minv.transpose(-1, -2))
    MinvAT = Minv @ AT
    K = torch.cat([sigma * Minv, MinvAT], dim=-1)
    K2 = torch.cat([K, A @ K], dim=-2)
    return KKTOp(Minv=Minv, MinvAT=MinvAT, K2=K2)


def padded_kkt_operator(P, A, lb, ub, shift=None, *, n_box: int,
                        soc_dims: Sequence[int] = (), rho: float = 0.4,
                        sigma: float = 1e-6) -> PaddedKKTOp:
    """The tile-aligned solve bundle of a (batched) QP: padded by
    :func:`pad_qp` (with a zero ``q``: it moves per solve) and the KKT
    operator built on the padded data. The padded system matrix is
    block-diagonal, ``[[M, 0], [0, (1 + sigma) I]]``, so the real block of
    ``Minv`` matches the unpadded operator to the inverse's rounding."""
    nv = P.shape[-1]
    q0 = torch.zeros(P.shape[:-1], dtype=P.dtype, device=P.device)
    P_p, _, A_p, lb_p, ub_p, shift_p = pad_qp(
        P, q0, A, lb, ub, shift, n_box=n_box, soc_dims=soc_dims)
    n_box_p = padded_dims(nv, n_box, soc_dims)[1]
    rho_vec = make_rho_vec(A_p.shape[-2], n_box_p, lb_p, ub_p, rho)
    op = kkt_operator(P_p, A_p, rho_vec, sigma)
    return PaddedKKTOp(P=P_p, A=A_p, lb=lb_p, ub=ub_p, shift=shift_p, op=op)


def kkt_residuals(P, q, A, lb, ub, n_box, soc_dims, sol: SOCPSolution,
                  shift=None):
    """The KKT check of a (batched) solution: ``(stat, prim, comp)``, the
    inf-norm of the stationarity residual ``P x + q + A^T y``, the
    inf-norm distance of ``A x`` to the translated cone, and the
    complementarity proxy ``|<y, A x - proj(A x)>|``; each ``(...)``."""
    x, y = sol.x, sol.y
    Ax = _mv(A, x)
    gap = Ax - _project_cone(Ax, lb, ub, n_box, soc_dims, shift)
    prim = torch.amax(torch.abs(gap), dim=-1)
    stat = torch.amax(torch.abs(_mv(P, x) + q + _mv(A.transpose(-1, -2), y)),
                      dim=-1)
    comp = torch.abs(torch.sum(y * gap, dim=-1))
    return stat, prim, comp


def equilibrate_rows(A, lb, ub, shift, n_box: int, soc_dims):
    """Exact row/block equilibration: each box row scaled by
    ``1 / max(||row||, 1)``, each SOC block by one scalar from its largest
    row norm. Returns ``(A', lb', ub', shift', scales (..., m))``."""
    norms = torch.sqrt(torch.sum(A * A, dim=-1))
    s = 1.0 / torch.clamp(norms[..., :n_box], min=1.0)
    scales = [s]
    off = n_box
    for dsoc in soc_dims:
        blk = torch.amax(norms[..., off:off + dsoc], dim=-1, keepdim=True)
        sb = 1.0 / torch.clamp(blk, min=1.0)
        scales.append(sb.expand(sb.shape[:-1] + (dsoc,)))
        off += dsoc
    scales = torch.cat(scales, dim=-1)
    A_s = A * scales[..., None]
    lb_s = lb * scales[..., :n_box]
    ub_s = ub * scales[..., :n_box]
    shift_s = None if shift is None else shift * scales
    return A_s, lb_s, ub_s, shift_s, scales


def solution_is_finite(sols: SOCPSolution) -> torch.Tensor:
    """Per-instance all-finite check over the iterates."""
    return (
        torch.all(torch.isfinite(sols.x), dim=-1)
        & torch.all(torch.isfinite(sols.y), dim=-1)
        & torch.all(torch.isfinite(sols.z), dim=-1)
    )


def _where_lanes(pred: torch.Tensor, new, old):
    """Per-lane select ``pred (batch)`` over tensors ``(batch, rows)``."""
    return tuple(torch.where(pred[..., None], a, b) for a, b in zip(new, old))


def _masked_chunk_loop(carry0, run_chunk, above_tol, gate, iters: int,
                       check_every: int):
    """The tolerance-chunked early-exit loop over a batch of lanes (the JAX
    package's ``_masked_chunk_loop``, ``socp.py:607``, under ``vmap``).

    Chunks of ``check_every`` iterations (``run_chunk(carry, k)``) run while
    any lane is active; a lane is active while it has run fewer than
    ``iters // check_every`` chunks and ``above_tol`` holds for its carry
    (tested before the first chunk too), and only if its ``gate`` ((batch,)
    bool or None) is on. An inactive lane keeps its carry (a select), so
    its result does not depend on the lanes that are still running. Then
    one remainder chunk of ``iters % check_every`` for the lanes still
    above tolerance: under ``vmap`` the JAX package runs it as a select for
    every lane; here it is skipped when no lane needs it (the values are
    the same). One host synchronisation per chunk (the ``any`` test).

    Returns ``(carry, n_chunks, eff_iters)``: per-lane chunks run and
    effective iterations (int32; 0 for a gated-off lane)."""
    n_full, rem = divmod(iters, check_every)
    carry = tuple(carry0)
    batch = carry[0].shape[:-1]
    n_chunks = torch.zeros(batch, dtype=torch.int32, device=carry[0].device)

    def working(c):
        return above_tol(c) if gate is None else gate & above_tol(c)

    if n_full:
        act = working(carry)
        # The early exit's test: one deliberate host read a chunk.
        while bool(act.any()):  # torchlint: disable=TL001,TL005
            carry = _where_lanes(act, run_chunk(carry, check_every), carry)
            n_chunks = n_chunks + act.to(torch.int32)
            act = act & (n_chunks < n_full) & above_tol(carry)
    eff = n_chunks * check_every
    if rem:
        need = working(carry)
        # Skip the remainder when no lane needs it: one host read.
        if bool(need.any()):  # torchlint: disable=TL001,TL005
            carry = _where_lanes(need, run_chunk(carry, rem), carry)
        eff = eff + torch.where(need, rem, 0).to(torch.int32)
    return carry, n_chunks, eff


def resolve_effort(effort: str | None = "auto") -> str:
    """Resolve the controllers' consensus-level solver-effort knob at config
    build time (the JAX package's ``resolve_effort``): ``"auto"`` (or None)
    reads ``TAT_EFFORT`` (``fixed`` | ``adaptive`` | ``auto``/unset) and
    otherwise stays ``"fixed"``, the fixed-iteration-cap behaviour.
    ``"adaptive"`` runs the inner solves tolerance-chunked with per-lane
    early exit and gates each lane with its scenario's own consensus
    continue predicate, so a converged scenario's solves are
    0-effective-iteration pass-throughs while the loop drains stragglers;
    per-step effort lands on ``SolverStats.inner_iters``."""
    if effort is None:
        effort = "auto"
    if effort == "auto":
        env = os.environ.get("TAT_EFFORT", "").strip().lower()
        if env in EFFORTS:
            return env
        if env not in ("", "auto"):
            raise ValueError(
                f"TAT_EFFORT={env!r}: expected one of {EFFORTS} or 'auto'"
            )
        return "fixed"
    if effort not in EFFORTS:
        raise ValueError(
            f"effort={effort!r}: expected one of {EFFORTS} or 'auto'"
        )
    return effort


def resolve_precision(precision: str | None = "auto") -> str:
    """Resolve the operator storage precision at config build time (the
    JAX package's ``resolve_precision``): ``"auto"`` (or None) reads
    ``TPU_AERIAL_PRECISION`` (``f32`` | ``bf16`` | ``auto``/unset) and
    otherwise stays ``"f32"``; explicit values pass through validated;
    anything else is a ValueError. ``"bf16"`` acts on route ``"kernel"``
    only."""
    if precision is None:
        precision = "auto"
    if precision == "auto":
        env = os.environ.get("TPU_AERIAL_PRECISION", "").strip().lower()
        if env in PRECISIONS:
            return env
        if env not in ("", "auto"):
            raise ValueError(
                f"TPU_AERIAL_PRECISION={env!r}: expected one of "
                f"{PRECISIONS} or 'auto'"
            )
        return "f32"
    if precision not in PRECISIONS:
        raise ValueError(
            f"precision={precision!r}: expected one of {PRECISIONS} or "
            "'auto'"
        )
    return precision


def stored_operators(op: KKTOp, A: torch.Tensor, P: torch.Tensor,
                     precision: str, route: str):
    """``(op, A, P)`` in the storage ``solve_socp(precision=, fused=route)``
    hands the kernel: under ``"bf16"`` on route ``"kernel"``, K2, Minv, A
    and P each rounded to bfloat16 (``MinvAT`` dropped: the kernel does
    not read it); otherwise unchanged. A controller calls this once per
    operator build, so the consensus iterations do not round them again."""
    if precision == "f32" or route != "kernel":
        return op, A, P
    K2, Minv, A, P = admm_kernel.store_operators((op.K2, op.Minv, A, P),
                                                 precision)
    return KKTOp(Minv=Minv, MinvAT=None, K2=K2), A, P


def resolve_route(fused: str) -> str:
    """The configured route, at config build time: ``"auto"`` ->
    ``"kernel"``; a route of :data:`ROUTES` passes through; anything else
    (the JAX package's ``"interpret"`` modes included, which have no
    counterpart here) is a ValueError. The device of the tensors, not the
    route, decides between a kernel and its plain version; the shape
    decides whether a kernel route holds (:func:`runtime_fused_mode`)."""
    if fused == "auto":
        return "kernel"
    if fused not in ROUTES:
        raise ValueError(
            f"socp_fused={fused!r}: expected one of {ROUTES} or 'auto'"
        )
    return fused


def runtime_fused_mode(fused: str, nv: int, m: int, n_box: int,
                       soc_dims: Sequence[int], *, check_every: int = 0,
                       tol: float = 0.0) -> str:
    """The route :func:`solve_socp` runs for ``fused`` at this solve's
    shape: ``"kernel"``, ``"pallas"`` or ``"scan"`` (the JAX package's
    ``runtime_fused_mode``). ``fused`` is resolved by
    :func:`resolve_route`; then ``"kernel"`` becomes ``"scan"`` where the
    whole-solve kernel cannot hold the shape
    (``admm_kernel.fused_solve_fits``), and ``"pallas"`` where the chunk
    kernel cannot (``admm_kernel.admm_chunk_fits``). The one resolver that
    dispatches a solve and labels it: a measurement records the route that
    ran. The decision reads the shape only -- the same on the CPU and on
    the card, taken before any launch -- and a shape a kernel holds never
    takes ``"scan"``. ``check_every``/``tol`` are part of the contract:
    both kernels take every chunking today."""
    del check_every, tol
    route = resolve_route(fused)
    if route == "kernel" and not admm_kernel.fused_solve_fits(
            nv, m, n_box, soc_dims):
        return "scan"
    if route == "pallas" and not admm_kernel.admm_chunk_fits(
            nv, m, n_box, soc_dims):
        return "scan"
    return route


def solve_socp(
    P: torch.Tensor,
    q: torch.Tensor,
    A: torch.Tensor,
    lb: torch.Tensor,
    ub: torch.Tensor,
    *,
    n_box: int,
    soc_dims: Sequence[int] = (),
    iters: int = 200,
    rho: float = 0.4,
    sigma: float = 1e-6,
    alpha: float = 1.6,
    warm: SOCPSolution | None = None,
    check_every: int = 0,
    tol: float = 0.0,
    shift: torch.Tensor | None = None,
    op: KKTOp | None = None,
    fused: str = "auto",
    precision: str = "f32",
    active: torch.Tensor | None = None,
    report_iters: bool = False,
):
    """Solve a batch of conic QPs by ADMM.

    Shapes: ``P (..., nv, nv)``, ``q (..., nv)``, ``A (..., m, nv)``,
    ``lb``/``ub`` ``(..., n_box)``, ``shift (..., m)`` or None, ``warm`` a
    :class:`SOCPSolution` with the same leading axes (None: cold start),
    ``op`` a prebuilt :class:`KKTOp` (built here when None). The warm ``z``
    is always projected onto the translated cone first (identity for an
    in-cone start; repairs an all-zeros cold start).

    ``iters`` fixed iterations, or, with ``check_every > 0`` and ``tol >
    0``, the tolerance-chunked early exit: chunks of ``check_every``
    iterations per lane until both residuals are at most ``tol``, capped at
    ``iters`` (see :func:`_masked_chunk_loop`). ``active`` ((...) bool, the
    consensus-level adaptive-effort gate; tolerance-chunked path only)
    makes a lane a 0-effective-iteration pass-through of its warm start.
    ``fused`` names the route (see the module docstring), which
    :func:`runtime_fused_mode` resolves from the shape. ``precision``
    (``"f32"`` or ``"bf16"``) is the operators' storage on route
    ``"kernel"`` and inert on the others; under ``"bf16"``, ``op``, ``A``
    and ``P`` may come already rounded (:func:`stored_operators`) or in
    float32 (rounded here). With ``report_iters`` the return is
    ``(solution, eff_iters)``, the (...) int32 iterations each lane
    applied."""
    if precision not in PRECISIONS:
        raise ValueError(
            f"precision={precision!r}: expected one of {PRECISIONS}")
    tol_path = bool(check_every) and tol > 0
    if active is not None and not tol_path:
        raise ValueError(
            "solve_socp(active=) needs the tolerance-chunked path "
            "(check_every > 0 and tol > 0): a fixed-iteration solve cannot "
            "express a 0-effective-iteration pass-through"
        )
    m, nv = A.shape[-2:]
    assert m == n_box + sum(soc_dims)
    route = runtime_fused_mode(fused, nv, m, n_box, soc_dims,
                               check_every=check_every, tol=tol)
    if route != "kernel":
        precision = "f32"  # inert off the whole-solve kernel.
    batch = A.shape[:-2]
    dtype, device = q.dtype, q.device

    rho_vec = make_rho_vec(m, n_box, lb, ub, rho)
    if op is None:
        if P.dtype != dtype or A.dtype != dtype:
            raise ValueError(
                "solve_socp builds the KKT operator from float32 P and A; "
                "pass op= with operators stored in another type")
        op = kkt_operator(P, A, rho_vec, sigma)
    if warm is None:
        x0 = torch.zeros(batch + (nv,), dtype=dtype, device=device)
        y0 = torch.zeros(batch + (m,), dtype=dtype, device=device)
        z0 = torch.zeros(batch + (m,), dtype=dtype, device=device)
    else:
        x0, y0, z0 = warm.x, warm.y, warm.z
    z0 = _project_cone(z0, lb, ub, n_box, soc_dims, shift)

    def lanes(t: torch.Tensor, k: int) -> torch.Tensor:
        """Fold the leading axes into one contiguous lane axis."""
        return t.reshape((-1,) + t.shape[t.dim() - k:]).contiguous()

    carry0 = (lanes(x0, 1), lanes(y0, 1), lanes(z0, 1))
    gate = None if active is None else lanes(active, 0)
    solve_kw = dict(nv=nv, n_box=n_box, soc_dims=tuple(soc_dims),
                    iters=iters, alpha=alpha)
    if route == "kernel":
        args = [*carry0, lanes(op.K2, 2), lanes(op.Minv, 2), lanes(A, 2),
                lanes(P, 2), lanes(q, 1), lanes(rho_vec, 1), lanes(lb, 1),
                lanes(ub, 1), None if shift is None else lanes(shift, 1)]
        with phases.scope(phases.FUSED_SOLVE):
            if tol_path:
                x, y, z, prim, dual, eff = admm_kernel.fused_solve_lanes(
                    *args, gate, check_every=check_every, tol=tol,
                    precision=precision, **solve_kw)
            else:
                x, y, z, prim, dual = admm_kernel.fused_solve_lanes(
                    *args, precision=precision, **solve_kw)
                eff = None
    else:
        # The chunked routes: w2 and the residuals in plain tensor ops, the
        # iterations through the chunk kernel ("pallas") or a plain loop of
        # _admm_step ("scan") (JAX: socp.py:1020-1021, :1051-1076).
        Al, Pl, ql = lanes(A, 2), lanes(P, 2), lanes(q, 1)
        wq = _mv(lanes(op.Minv, 2), ql)
        w2 = torch.cat([wq, _mv(Al, wq)], dim=-1)
        K2l, rho_l = lanes(op.K2, 2), lanes(rho_vec, 1)
        lb_l, ub_l = lanes(lb, 1), lanes(ub, 1)
        if route == "pallas":
            # The kernel adds a shift always: zeros stand in for none.
            shift_l = (lanes(shift, 1) if shift is not None
                       else torch.zeros(carry0[1].shape, dtype=dtype,
                                        device=device))

            def run_chunk(carry, k):
                return admm_kernel.admm_chunk_lanes(
                    *carry, K2l, w2, rho_l, lb_l, ub_l, shift_l,
                    **dict(solve_kw, iters=k))
        else:
            shift_l = None if shift is None else lanes(shift, 1)
            step_kw = dict(nv=nv, n_box=n_box, soc_dims=tuple(soc_dims),
                           alpha=alpha)

            def run_chunk(carry, k):
                for _ in range(k):
                    carry = _admm_step(carry, K2l, w2, rho_l, lb_l, ub_l,
                                       shift_l, **step_kw)
                return carry

        def residuals(carry):
            x_, y_, z_ = carry
            prim_ = torch.amax(torch.abs(_mv(Al, x_) - z_), dim=-1)
            ATy = _mv(Al.transpose(-1, -2), y_)
            dual_ = torch.amax(torch.abs(_mv(Pl, x_) + ql + ATy), dim=-1)
            return prim_, dual_

        if tol_path:
            def above_tol(carry):
                prim_, dual_ = residuals(carry)
                return (prim_ > tol) | (dual_ > tol)

            carry, _, eff = _masked_chunk_loop(
                carry0, run_chunk, above_tol,
                None if gate is None else gate > 0, iters, check_every)
        else:
            carry, eff = run_chunk(carry0, iters), None
        x, y, z = carry
        prim, dual = residuals(carry)
    sol = SOCPSolution(
        x=x.reshape(batch + (nv,)), y=y.reshape(batch + (m,)),
        z=z.reshape(batch + (m,)), prim_res=prim.reshape(batch),
        dual_res=dual.reshape(batch),
    )
    if not report_iters:
        return sol
    if eff is None:
        eff = torch.full(batch, iters, dtype=torch.int32, device=device)
    return sol, eff.reshape(batch)


def solve_socp_padded(
    P: torch.Tensor,
    q: torch.Tensor,
    A: torch.Tensor,
    lb: torch.Tensor,
    ub: torch.Tensor,
    *,
    n_box: int,
    soc_dims: Sequence[int] = (),
    iters: int = 200,
    rho: float = 0.4,
    sigma: float = 1e-6,
    alpha: float = 1.6,
    warm: SOCPSolution | None = None,
    check_every: int = 0,
    tol: float = 0.0,
    shift: torch.Tensor | None = None,
    pqp: PaddedKKTOp | None = None,
    fused: str = "auto",
    precision: str = "f32",
    active: torch.Tensor | None = None,
    report_iters: bool = False,
):
    """Tile-aligned :func:`solve_socp`: the (batched) QP padded to its
    bucket (:func:`padded_dims`), solved on the padded layout through the
    same route resolver as an unpadded solve, and the solution returned in
    the unpadded layout. ``pqp`` is a prebuilt :class:`PaddedKKTOp` for
    operator reuse across solves; ``warm`` is an unpadded warm start;
    ``active`` and ``report_iters`` pass through to :func:`solve_socp`.
    Agrees with the unpadded solve to the rounding of the matvecs' other
    sums (the pad entries are exact zeros)."""
    nv = P.shape[-1]
    n_box_p = padded_dims(nv, n_box, soc_dims)[1]
    if pqp is None:
        pqp = padded_kkt_operator(P, A, lb, ub, shift, n_box=n_box,
                                  soc_dims=soc_dims, rho=rho, sigma=sigma)
    q_p = torch.nn.functional.pad(q, (0, pqp.P.shape[-1] - nv))
    warm_p = None if warm is None else pad_warm(warm, n_box=n_box,
                                                soc_dims=soc_dims)
    out = solve_socp(
        pqp.P, q_p, pqp.A, pqp.lb, pqp.ub, n_box=n_box_p,
        soc_dims=tuple(soc_dims), iters=iters, rho=rho, sigma=sigma,
        alpha=alpha, warm=warm_p, check_every=check_every, tol=tol,
        shift=pqp.shift, op=pqp.op, fused=fused, precision=precision,
        active=active, report_iters=report_iters,
    )
    if report_iters:
        sol, eff = out
        return unpad_solution(sol, nv, n_box, n_box_p), eff
    return unpad_solution(out, nv, n_box, n_box_p)
