"""The chip's peaks and the solve kernels' least work: frozen copies of
``chip_smoke.py`` (``PEAK_BYTES_S``, ``PEAK_F32_FLOP_S``) and of the port's
``ops/admm_kernel.py`` (``fused_solve_bytes_per_lane``,
``fused_solve_flops_per_lane``), as they stood when the benchmark was
written. The counts depend on the QP's shape and the iterations a lane
needs, not on what implements the solve.
"""

from __future__ import annotations

from typing import Sequence

# NVIDIA H100 SXM data sheet: HBM3 bandwidth, and float32 outside the
# tensor cores (the configurations run with TF32 off). Both assume the
# card's full 700 W power limit; a run prints the card's own limit.
PEAK_BYTES_S = 3.35e12
PEAK_F32_FLOP_S = 67e12
OPERATOR_BYTES = {"f32": 4, "bf16": 2}


def _iter_flops(nv: int, m: int, soc_dims: Sequence[int]) -> int:
    """One ADMM iteration of one lane: the K2 matvec, ~12 elementwise
    operations a row and each SOC norm."""
    d = nv + m
    return 2 * d * d + 12 * m + sum(2 * (k - 1) + 4 for k in soc_dims)


def _residual_flops(nv: int, m: int) -> int:
    return 2 * m * nv + 2 * nv * nv + 2 * m * nv + 6 * nv + 2 * m


def fused_solve_bytes_per_lane(nv: int, m: int, n_box: int, *,
                               early: bool = False, gated_off: bool = False,
                               precision: str = "f32") -> int:
    """Bytes a lane's solve reads and writes at least once: K2 ``(d, d)``,
    Minv and P ``(nv, nv)``, A ``(m, nv)``, the vectors in and the
    solution and residuals out (the early form also the gate and its
    count); a gated-off lane needs neither K2 nor Minv."""
    d = nv + m
    mats = d * d + 2 * nv * nv + m * nv
    if gated_off:
        mats -= d * d + nv * nv
    reads = nv + m + 2 * n_box + m + (nv + 2 * m)
    writes = (nv + 2 * m) + 2
    if early:
        reads += 1
        writes += 1
    return OPERATOR_BYTES[precision] * mats + 4 * (reads + writes)


def fused_solve_flops_per_lane(nv: int, m: int, iters: int,
                               soc_dims: Sequence[int] = (),
                               residual_checks: int = 1,
                               build: bool = True) -> int:
    """float32 operations of a lane's solve: the w2 build (when the lane
    iterates), ``iters`` iterations and ``residual_checks`` evaluations of
    both residuals."""
    w2 = 2 * nv * nv + 2 * m * nv if build else 0
    return (w2 + iters * _iter_flops(nv, m, soc_dims)
            + residual_checks * _residual_flops(nv, m))


def bound_s(bytes_: float, flops: float) -> float:
    """The least seconds the card needs for ``bytes_`` and ``flops``."""
    return max(bytes_ / PEAK_BYTES_S, flops / PEAK_F32_FLOP_S)
