"""Whole-solve batched ADMM: the hand-written CUDA kernel and its plain twin.

Counterpart of ``tpu_aerial_transport/ops/admm_kernel.py``'s
``fused_solve_lanes`` / ``_fused_solve_kernel`` in its compiled form
(``exact_dot=False``), fixed-iteration, float32, with or without a cone
shift. Per lane (one small conic QP) it computes:

1. the qp-build tail ``wq = Minv q``, ``w2 = [wq; A wq]``;
2. ``iters`` iterations of ``v = K2 [x; rho z - y] - w2``, ``x = v[:nv]``,
   ``Ax_rel = alpha v[nv:] + (1 - alpha) z``, ``z = Pi(Ax_rel + y / rho)``
   (the translated box x SOC projection), ``y += rho (Ax_rel - z)``;
3. the exit residuals ``prim = max|A x - z|``, ``dual = max|P x + q + A^T y|``.

Layout is batch-first, ``(B lanes, rows...)``, with no lane padding.
:func:`fused_solve_lanes` launches the kernel (``csrc/fused_solve.cu``,
built at first use by :mod:`ops._build`) for tensors on the card and runs
:func:`fused_solve_lanes_reference` for tensors on the CPU; it never falls
back from the one to the other. The early-exit and bf16 forms are not ported
yet (ROADMAP Queue 2 items 1(b), 1(c)).
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import torch

# Plain launch counter: the wrapper adds one where it launches the kernel,
# and nowhere else.
LAUNCHES = {"fused_solve": 0}

# The kernel's compile-time bounds (csrc/fused_solve.cu FS_MAX_*).
MAX_SOC_BLOCKS = 16
MAX_DIM = 256
# Shared memory a block may opt in to on Hopper (227 KB).
MAX_SMEM_BYTES = 232448


class _SocDims(ctypes.Structure):
    """The cone layout passed by value: ``n`` SOC blocks of dims ``d[:n]``."""

    _fields_ = [("n", ctypes.c_int), ("d", ctypes.c_int * MAX_SOC_BLOCKS)]


# fused_solve_launch(16 pointers, B, nv, m, n_box, iters, has_shift, alpha,
# 1 - alpha, soc, device, stream) -> cudaError_t.
_ARGTYPES = [ctypes.c_void_p] * 16 + [ctypes.c_int] * 6 + [
    ctypes.c_float, ctypes.c_float, _SocDims, ctypes.c_int, ctypes.c_void_p,
]


def fused_solve_bytes_per_lane(nv: int, m: int, n_box: int) -> int:
    """float32 bytes one lane's solve must read and write at least once:
    K2 ``(d, d)``, Minv and P ``(nv, nv)``, A ``(m, nv)``, q, rho, lb/ub,
    shift and the (x, y, z) carry in; (x, y, z) and both residuals out."""
    d = nv + m
    mats = d * d + 2 * nv * nv + m * nv
    reads = mats + nv + m + 2 * n_box + m + (nv + 2 * m)
    writes = (nv + 2 * m) + 2
    return 4 * (reads + writes)


def fused_solve_flops_per_lane(nv: int, m: int, iters: int,
                               soc_dims: Sequence[int] = ()) -> int:
    """float32 operations of one lane's solve: the w2 build, ``iters``
    iterations (the K2 matvec plus ~12 elementwise operations a row and
    each SOC norm), and the two residual matvecs."""
    d = nv + m
    build = 2 * nv * nv + 2 * m * nv
    per_iter = 2 * d * d + 12 * m + sum(2 * (k - 1) + 4 for k in soc_dims)
    residuals = 2 * m * nv + 2 * nv * nv + 2 * m * nv + 6 * nv + 2 * m
    return build + iters * per_iter + residuals


def fused_solve_smem_bytes(nv: int, m: int) -> int:
    """Dynamic shared memory of one block (one lane): K2, Minv, P, A with
    row strides padded to odd word counts, two d-vectors and the reduction
    scratch (csrc/fused_solve.cu fs_smem_floats)."""
    d = nv + m
    return 4 * (d * (d | 1) + (2 * nv + m) * (nv | 1) + 2 * d + 64)


def _mv(M: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return (M @ v[..., None])[..., 0]


def fused_solve_lanes_reference(
    x, y, z, K2, Minv, A, P, q, rho, lb, ub, shift=None,
    *, nv: int, n_box: int, soc_dims: Sequence[int], iters: int,
    alpha: float,
):
    """Plain PyTorch version of the kernel, on any device: batched tensor ops
    in the kernel's order of operations (``ops.socp._admm_step``) and a
    Python loop over ``iters``. Returns ``(x, y, z, prim_res, dual_res)``."""
    from tpu_aerial_transport_torch.ops import socp

    wq = _mv(Minv, q)
    w2 = torch.cat([wq, _mv(A, wq)], dim=-1)
    carry = (x, y, z)
    for _ in range(iters):
        carry = socp._admm_step(
            carry, K2, w2, rho, lb, ub, shift, nv=nv, n_box=n_box,
            soc_dims=tuple(soc_dims), alpha=alpha,
        )
    x, y, z = carry
    prim = torch.amax(torch.abs(_mv(A, x) - z), dim=-1)
    ATy = _mv(A.transpose(-1, -2), y)
    dual = torch.amax(torch.abs(_mv(P, x) + q + ATy), dim=-1)
    return x, y, z, prim, dual


def _check(name, t, shape, device):
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a tensor, got {type(t).__name__}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != torch.float32:
        raise TypeError(f"{name}: dtype {t.dtype}, the kernel takes float32")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name} is not contiguous")


def fused_solve_lanes(
    x, y, z, K2, Minv, A, P, q, rho, lb, ub, shift=None,
    *, nv: int, n_box: int, soc_dims: Sequence[int], iters: int,
    alpha: float,
):
    """Whole batched solves, batch-first ``(B, rows...)``; returns
    ``(x, y, z, prim_res, dual_res)``.

    CPU tensors run :func:`fused_solve_lanes_reference`. CUDA tensors launch
    the kernel on the current stream (no synchronisation) or raise: on a
    wrong device, dtype, shape or layout, on dims the kernel does not take,
    or on a launch error."""
    if x.device.type == "cpu":
        return fused_solve_lanes_reference(
            x, y, z, K2, Minv, A, P, q, rho, lb, ub, shift, nv=nv,
            n_box=n_box, soc_dims=soc_dims, iters=iters, alpha=alpha,
        )
    if x.device.type != "cuda":
        raise ValueError(f"fused_solve_lanes: unsupported device {x.device}")
    soc_dims = tuple(int(k) for k in soc_dims)
    B = x.shape[0]
    m = rho.shape[-1]
    d = nv + m
    if m != n_box + sum(soc_dims):
        raise ValueError(
            f"m={m} != n_box={n_box} + sum(soc_dims)={sum(soc_dims)}"
        )
    if (len(soc_dims) > MAX_SOC_BLOCKS or d > MAX_DIM or iters < 0
            or fused_solve_smem_bytes(nv, m) > MAX_SMEM_BYTES):
        raise ValueError(
            f"fused_solve kernel takes d <= {MAX_DIM}, at most "
            f"{MAX_SOC_BLOCKS} SOC blocks, {MAX_SMEM_BYTES} B of shared "
            f"memory a lane and iters >= 0 (got d={d}, {len(soc_dims)} "
            f"blocks, {fused_solve_smem_bytes(nv, m)} B, iters={iters})"
        )
    if any(k < 2 for k in soc_dims):
        raise ValueError(
            f"soc_dims={soc_dims}: every SOC block needs dim >= 2")
    dev = x.device
    for name, t, shape in (
        ("x", x, (B, nv)), ("y", y, (B, m)), ("z", z, (B, m)),
        ("K2", K2, (B, d, d)), ("Minv", Minv, (B, nv, nv)),
        ("A", A, (B, m, nv)), ("P", P, (B, nv, nv)), ("q", q, (B, nv)),
        ("rho", rho, (B, m)), ("lb", lb, (B, n_box)), ("ub", ub, (B, n_box)),
    ):
        _check(name, t, shape, dev)
    if shift is not None:
        _check("shift", shift, (B, m), dev)

    from tpu_aerial_transport_torch.ops import _build

    lib = _build.load("fused_solve")
    fn = lib.fused_solve_launch
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    xo = torch.empty((B, nv), dtype=torch.float32, device=dev)
    yo = torch.empty((B, m), dtype=torch.float32, device=dev)
    zo = torch.empty((B, m), dtype=torch.float32, device=dev)
    res = torch.empty((B, 2), dtype=torch.float32, device=dev)
    dims = _SocDims()
    dims.n = len(soc_dims)
    for i, k in enumerate(soc_dims):
        dims.d[i] = k
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = fn(
        ptr(K2), ptr(Minv), ptr(A), ptr(P), ptr(q), ptr(rho), ptr(lb),
        ptr(ub), ptr(shift), ptr(x), ptr(y), ptr(z),
        ptr(xo), ptr(yo), ptr(zo), ptr(res),
        B, nv, m, n_box, iters, 1 if shift is not None else 0,
        float(alpha), float(1 - alpha), dims, dev.index, stream,
    )
    if err != 0:
        raise RuntimeError(
            f"fused_solve kernel launch failed: {_build.error_string(err)} "
            f"(cudaError {err})"
        )
    LAUNCHES["fused_solve"] += 1
    return xo, yo, zo, res[:, 0], res[:, 1]
