"""Batched ADMM kernels for the inner conic QPs, and their plain twins.

Counterparts of ``tpu_aerial_transport/ops/admm_kernel.py``:

- :func:`fused_solve_lanes` -- ``_fused_solve_kernel``, the whole solve per
  lane in its compiled form (``exact_dot=False``), float32, with or without
  a cone shift:

  1. the qp-build tail ``wq = Minv q``, ``w2 = [wq; A wq]``;
  2. ``iters`` iterations of ``v = K2 [x; rho z - y] - w2``, ``x = v[:nv]``,
     ``Ax_rel = alpha v[nv:] + (1 - alpha) z``, ``z = Pi(Ax_rel + y / rho)``
     (the translated box x SOC projection), ``y += rho (Ax_rel - z)``;
  3. the exit residuals ``prim = max|A x - z|``, ``dual = max|P x + q +
     A^T y|``.

  With ``check_every > 0`` and ``tol > 0`` it is the early-exit form: the
  iterations run in chunks of ``check_every`` and a lane stops once its
  residuals are both at most ``tol`` (tested before the first chunk too;
  NaN counts as converged), or an ``active`` gate switches it off from the
  start; the return gains ``eff_iters`` (B,) int32.

  With ``precision="bf16"`` the four operators K2, Minv, A and P are stored
  in bfloat16 (each rounded on its own from float32, round-to-nearest-even
  as ``jnp.astype`` rounds) and every use reads them upcast to float32:
  the w2 build, the iterations and the exit residuals. Vectors, the
  (x, y, z) carry and every sum stay float32 (``admm_kernel.py:541-546``
  of the JAX package). It halves the operator bytes a launch reads.
- :func:`admm_chunk_lanes` -- ``_admm_chunk_kernel``: ``iters`` iterations
  with ``K2`` and ``w2`` given; returns ``(x, y, z)`` and nothing else.

Layout is batch-first, ``(B lanes, rows...)``, with no lane padding. Each
wrapper launches its kernel (``csrc/fused_solve.cu``, ``csrc/admm_chunk.cu``,
built at first use by :mod:`ops._build`) for tensors on the card and runs
its ``*_reference`` twin for tensors on the CPU; it never falls back from
the one to the other.

The whole-solve kernel has two bodies, chosen from the shape ``(nv, m)``
alone (:func:`fused_solve_geometry`): ``nv`` and ``m`` at most
``WARP_MAX_ROWS`` (every agent QP) runs one warp per lane, each thread
holding one constraint row of K2 in registers (``warp_solve_*kernel``);
other shapes (the centralized, full, RP and PMRL QPs) one block per lane,
one thread a K2 row (``fused_solve_*kernel``), the row in that thread's
registers where ``ROW_MIN_D <= d <= ROW_MAX_D`` (:func:`register_rows`),
read from shared memory otherwise. The chunk kernel has the same two
bodies (:func:`admm_chunk_geometry`): ``warp_chunk_kernel`` for the agent
QPs, with K2's x rows in registers where ``nv <= 16`` and in shared memory
otherwise, and the one-block-a-lane ``admm_chunk_kernel`` beyond, in the
same two layouts.

:func:`fused_solve_fits` and :func:`admm_chunk_fits` say from the shape
alone whether a kernel takes a solve; the solver's route resolver
(``ops.socp.runtime_fused_mode``) reads them, and the wrappers refuse what
they reject (:func:`_check_layout`), from the same limits.
"""

from __future__ import annotations

import ctypes
import functools
import os
import re
from typing import NamedTuple, Sequence

import torch

from tpu_aerial_transport_torch.ops import _build

# Plain launch counters: each wrapper adds one where it launches its kernel,
# and nowhere else. "fused_solve" counts the fixed-iteration form,
# "fused_solve_early" the early-exit form of the same kernel source, and the
# "_bf16" keys the same forms with bfloat16 operator storage.
LAUNCHES = {"fused_solve": 0, "fused_solve_early": 0, "fused_solve_bf16": 0,
            "fused_solve_early_bf16": 0, "admm_chunk": 0}

# The whole-solve kernel's entry points by (body, form, storage), their
# names as a trace shows them (none a substring of another), and a launch
# counter for each, added to beside LAUNCHES.
BODIES = ("shared", "warp")
KERNEL_NAMES = {
    (body, early, precision):
        f"{'warp' if body == 'warp' else 'fused'}_solve"
        f"{'_early' if early else ''}"
        f"{'_bf16' if precision == 'bf16' else ''}_kernel"
    for body in BODIES for early in (False, True)
    for precision in ("f32", "bf16")
}
KERNEL_LAUNCHES = {name: 0 for name in KERNEL_NAMES.values()}

# The chunk kernel's entry points by body, as a trace names them, and a
# launch counter for each, added to beside LAUNCHES["admm_chunk"].
CHUNK_BODIES = ("block", "warp")
CHUNK_KERNEL_NAMES = {"block": "admm_chunk_kernel",
                      "warp": "warp_chunk_kernel"}
CHUNK_LAUNCHES = {name: 0 for name in CHUNK_KERNEL_NAMES.values()}
# Layouts of K2's x rows in the chunk kernel's warp body (csrc/admm_chunk.cu
# WC_SHARED, WC_SPLIT): the warp's shared memory, or each row's two halves
# in two threads' registers (at most WARP_SPLIT_MAX_NV rows).
X_ROWS = ("shared", "split")
WARP_SPLIT_MAX_NV = 16

# Operator storage of the whole-solve kernel, by precision name.
STORAGE = {"f32": torch.float32, "bf16": torch.bfloat16}

# The kernels' compile-time bounds (csrc/admm_common.cuh FS_MAX_*).
MAX_SOC_BLOCKS = 16
MAX_DIM = 256
# Shared memory a block may opt in to on Hopper (227 KB).
MAX_SMEM_BYTES = 232448
# The warp body (csrc/fused_solve.cu WS_MAX_ROWS, WS_LANES): the most x
# rows and constraint rows it takes, and lanes (warps) a block.
WARP_MAX_ROWS = 32
WARP_LANES_PER_BLOCK = 4
# The block bodies' register-row layout (csrc/admm_common.cuh RB_MIN_D,
# RB_MAX_D): the d it takes; every other d keeps K2 in shared memory.
ROW_MIN_D, ROW_MAX_D = 65, 128
# What the occupancy calculator gives a Hopper SM: registers, threads,
# resident blocks, shared memory, and the shared memory the runtime reserves
# a block.
SM_REGISTERS, SM_THREADS, SM_BLOCKS = 65536, 2048, 32
SM_SMEM_BYTES, BLOCK_RESERVED_SMEM_BYTES = 233472, 1024


class _SocDims(ctypes.Structure):
    """The cone layout passed by value: ``n`` SOC blocks of dims ``d[:n]``."""

    _fields_ = [("n", ctypes.c_int), ("d", ctypes.c_int * MAX_SOC_BLOCKS)]


# fused_solve_launch(13 input and 5 output pointers, B, nv, m, n_box, iters,
# check_every, tol, has_shift, bf16, body, alpha, 1 - alpha, soc, device,
# stream) -> cudaError_t.
_FUSED_ARGTYPES = [ctypes.c_void_p] * 18 + [ctypes.c_int] * 6 + [
    ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float,
    ctypes.c_float, _SocDims, ctypes.c_int, ctypes.c_void_p,
]
# fused_solve_info(nv, m, bf16, early, body, device, int out[6]).
_INFO_ARGTYPES = [ctypes.c_int] * 6 + [ctypes.c_void_p]
# admm_chunk_launch(9 input and 3 output pointers, B, nv, m, n_box, iters,
# has_shift, body, x_rows, alpha, 1 - alpha, soc, device, stream) ->
# cudaError_t.
_CHUNK_ARGTYPES = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 8 + [
    ctypes.c_float, ctypes.c_float, _SocDims, ctypes.c_int, ctypes.c_void_p,
]
# admm_chunk_info(nv, m, body, x_rows, device, int out[6]).
_CHUNK_INFO_ARGTYPES = [ctypes.c_int] * 5 + [ctypes.c_void_p]


def _iter_flops(nv: int, m: int, soc_dims: Sequence[int]) -> int:
    """float32 operations of one ADMM iteration of one lane: the K2 matvec
    plus ~12 elementwise operations a row and each SOC norm."""
    d = nv + m
    return 2 * d * d + 12 * m + sum(2 * (k - 1) + 4 for k in soc_dims)


def _residual_flops(nv: int, m: int) -> int:
    """float32 operations of one evaluation of both residuals."""
    return 2 * m * nv + 2 * nv * nv + 2 * m * nv + 6 * nv + 2 * m


def fused_solve_bytes_per_lane(nv: int, m: int, n_box: int, *,
                               early: bool = False, gated_off: bool = False,
                               precision: str = "f32") -> int:
    """Bytes one lane's solve must read and write at least once: K2
    ``(d, d)``, Minv and P ``(nv, nv)``, A ``(m, nv)`` (4 bytes an entry, 2
    under ``precision="bf16"``), then float32 q, rho, lb/ub, shift and the
    (x, y, z) carry in; (x, y, z) and both residuals out. The early-exit
    form also reads the gate and writes ``eff_iters``; a gated-off lane
    iterates 0 times and needs neither K2 nor Minv."""
    d = nv + m
    mats = d * d + 2 * nv * nv + m * nv
    if gated_off:
        mats -= d * d + nv * nv
    reads = nv + m + 2 * n_box + m + (nv + 2 * m)
    writes = (nv + 2 * m) + 2
    if early:
        reads += 1
        writes += 1
    return STORAGE[precision].itemsize * mats + 4 * (reads + writes)


def fused_solve_flops_per_lane(nv: int, m: int, iters: int,
                               soc_dims: Sequence[int] = (),
                               residual_checks: int = 1,
                               build: bool = True) -> int:
    """float32 operations of one lane's solve: the w2 build (when the lane
    iterates), ``iters`` iterations and ``residual_checks`` evaluations of
    both residuals (1 for the fixed form: the exit residuals)."""
    w2 = 2 * nv * nv + 2 * m * nv if build else 0
    return (w2 + iters * _iter_flops(nv, m, soc_dims)
            + residual_checks * _residual_flops(nv, m))


def _round_up(k: int, w: int) -> int:
    return -(-k // w) * w


def _ld16(k: int) -> int:
    """A shared-memory row stride for k floats: whole 16-byte words, an
    odd number of them (csrc/fused_solve.cu ws_ld)."""
    r = _round_up(k, 4)
    return r if (r // 4) % 2 else r + 4


def register_rows(d: int) -> bool:
    """Whether the block bodies' thread a K2 row holds its row in
    registers at ``d``; otherwise it reads the row from shared memory
    (csrc/admm_common.cuh rb_takes)."""
    return ROW_MIN_D <= d <= ROW_MAX_D


def _row_ld(k: int) -> int:
    """An operator's shared-memory row stride in the register-row layout:
    whole 16-byte words (an odd number) for rows of a multiple of 4
    floats, else an odd number of floats (csrc/admm_common.cuh rb_ld)."""
    return _ld16(k) if k % 4 == 0 else k | 1


def _row_bucket(d: int) -> int:
    """The longest row of the register-row instantiation that takes d
    (csrc/admm_common.cuh rb_bucket)."""
    return next(b for b in (72, 80, 112, ROW_MAX_D) if d <= b)


def _row_smem_floats(nv: int, m: int, solve: bool) -> int:
    """One lane's shared memory in the register-row layout, in floats:
    K2, for the whole solve Minv, P and A, two u buffers of the
    instantiation's row length, for the whole solve a d-vector, the
    pre-projection values and, for the whole solve, the reduction scratch;
    each region whole 16-byte words (csrc/admm_common.cuh rb_smem)."""
    d = nv + m
    ops = ([_row_ld(nv) * k for k in (nv, nv, m)] if solve else [])
    vecs = [d, m, 66] if solve else [m]
    return (_round_up(d * _row_ld(d), 4) + sum(_round_up(k, 4) for k in ops)
            + 2 * _ld16(_row_bucket(d)) + sum(_round_up(k, 4) for k in vecs))


@functools.lru_cache(maxsize=None)
def _row_register_budgets() -> dict:
    """The register-row instantiations' register budget a thread, as
    their launch bounds take it (csrc/admm_common.cuh RB_SHORT_D,
    RB_SOLVE_SHORT_REGS, RB_CHUNK_SHORT_REGS, RB_LONG_REGS), read from the
    header the kernels are built from."""
    with open(os.path.join(_build.CSRC, "admm_common.cuh")) as fh:
        text = fh.read()
    return {name: int(re.search(rf"^#define {name} (\d+)$", text,
                                re.M).group(1))
            for name in ("RB_SHORT_D", "RB_SOLVE_SHORT_REGS",
                         "RB_CHUNK_SHORT_REGS", "RB_LONG_REGS")}


def block_lanes_per_sm(nv: int, m: int, chunk: bool = False) -> int:
    """The lanes an SM keeps resident in the register-row layout at
    ``(nv, m)`` when a thread takes its whole register budget: the fewest
    that the SM's registers (allocated 256 a warp), threads, blocks and
    shared memory allow. The build's own count (``fused_solve_info``,
    ``admm_chunk_info``: ``lanes_per_sm``) is at least this."""
    d = nv + m
    if not register_rows(d):
        raise ValueError(f"d={d} is outside the register-row layout "
                         f"({ROW_MIN_D}..{ROW_MAX_D})")
    b = _row_register_budgets()
    short = "RB_CHUNK_SHORT_REGS" if chunk else "RB_SOLVE_SHORT_REGS"
    budget = b["RB_LONG_REGS" if _row_bucket(d) > b["RB_SHORT_D"] else short]
    geo = (admm_chunk_geometry(nv, m, "block") if chunk
           else fused_solve_geometry(nv, m, "shared"))
    warp_regs = _round_up(32 * budget, 256)
    return min(SM_REGISTERS // (geo.threads // 32 * warp_regs),
               SM_THREADS // geo.threads, SM_BLOCKS,
               SM_SMEM_BYTES // (geo.smem_bytes + BLOCK_RESERVED_SMEM_BYTES))


def fused_solve_smem_bytes(nv: int, m: int) -> int:
    """Dynamic shared memory of one block (one lane) of the whole-solve
    kernel's block body (csrc/fused_solve.cu fs_smem_floats): in the
    register-row layout K2 (staged once, then held in registers), Minv, P,
    A, the u buffers and vectors (:func:`_row_smem_floats`); otherwise K2,
    Minv, P, A with row strides padded to odd word counts, two d-vectors
    and the reduction scratch."""
    d = nv + m
    if register_rows(d):
        return 4 * _row_smem_floats(nv, m, True)
    return 4 * (d * (d | 1) + (2 * nv + m) * (nv | 1) + 2 * d + 66)


def warp_smem_bytes(nv: int, m: int) -> int:
    """Shared memory of one lane (warp) of the warp body: A and P with an
    odd-word row stride, K2's x rows and u at d rounded up to 8 entries,
    and y for the residuals (csrc/fused_solve.cu ws_smem_floats)."""
    dr = _round_up(nv + m, 8)
    return 4 * ((m + nv) * _ld16(nv) + nv * _ld16(dr) + dr
                + _round_up(m, 4))


class Geometry(NamedTuple):
    """How the whole-solve kernel launches for one (nv, m)."""

    body: str  # "warp" or "shared".
    lanes_per_block: int
    threads: int  # a block.
    smem_bytes: int  # dynamic shared memory a block.


def fused_solve_geometry(nv: int, m: int, body: str | None = None
                         ) -> Geometry:
    """The body and launch shape for ``(nv, m)``. ``body=None`` decides
    from the shape alone, as the wrapper does: one warp per lane,
    ``WARP_LANES_PER_BLOCK`` lanes a block, when ``nv`` and ``m`` are both
    at most ``WARP_MAX_ROWS`` (then ``d <= 64``); else one block of ``d``
    threads (whole warps) per lane."""
    d = nv + m
    fits = nv <= WARP_MAX_ROWS and m <= WARP_MAX_ROWS
    if body is None:
        body = "warp" if fits else "shared"
    if body not in BODIES or (body == "warp" and not fits):
        raise ValueError(f"body={body!r} for nv={nv}, m={m}: expected one "
                         f"of {BODIES}, 'warp' only for nv and m at most "
                         f"{WARP_MAX_ROWS}")
    if body == "warp":
        return Geometry("warp", WARP_LANES_PER_BLOCK,
                        32 * WARP_LANES_PER_BLOCK,
                        WARP_LANES_PER_BLOCK * warp_smem_bytes(nv, m))
    return Geometry("shared", 1, _round_up(d, 32),
                    fused_solve_smem_bytes(nv, m))


def fused_solve_info(nv: int, m: int, *, early: bool = False,
                     precision: str = "f32", body: str | None = None,
                     device=None) -> dict:
    """What the build made of the entry point a launch at ``(nv, m)``
    takes (``body`` as in :func:`fused_solve_geometry`), from the library
    itself: its name, lanes and threads a block, dynamic shared memory a
    block, registers and local memory (spill bytes) a thread, and resident
    lanes an SM (the occupancy calculator)."""
    geo = fused_solve_geometry(nv, m, body)
    fn = _build.bind("fused_solve", _INFO_ARGTYPES, "info")
    index = torch.device("cuda" if device is None else device).index
    index = torch.cuda.current_device() if index is None else index
    out = (ctypes.c_int * 6)()
    err = fn(nv, m, int(precision == "bf16"), int(early),
             BODIES.index(geo.body), index, out)
    _build.raise_on(err, "fused_solve")
    return {"name": KERNEL_NAMES[geo.body, early, precision],
            "lanes_per_block": out[0], "threads": out[1],
            "smem_bytes": out[2], "registers": out[3],
            "local_bytes": out[4], "lanes_per_sm": out[5]}


def admm_chunk_bytes_per_lane(nv: int, m: int, n_box: int) -> int:
    """float32 bytes one lane's chunk must read and write at least once:
    K2 ``(d, d)``, w2 ``(d,)``, rho, lb/ub, shift and (x, y, z) in;
    (x, y, z) out."""
    d = nv + m
    reads = d * d + d + m + 2 * n_box + m + (nv + 2 * m)
    writes = nv + 2 * m
    return 4 * (reads + writes)


def admm_chunk_flops_per_lane(nv: int, m: int, iters: int,
                              soc_dims: Sequence[int] = ()) -> int:
    """float32 operations of one lane's chunk: ``iters`` iterations."""
    return iters * _iter_flops(nv, m, soc_dims)


def admm_chunk_smem_bytes(nv: int, m: int) -> int:
    """Dynamic shared memory of one block (one lane) of the chunk kernel's
    block body (csrc/admm_chunk.cu chunk_smem_floats): in the register-row
    layout K2 (staged once), the u buffers and the pre-projection values;
    otherwise K2 with an odd row stride and two d-vectors."""
    d = nv + m
    if register_rows(d):
        return 4 * _row_smem_floats(nv, m, False)
    return 4 * (d * (d | 1) + 2 * d)


def warp_chunk_smem_bytes(nv: int, m: int, x_rows: str) -> int:
    """Shared memory of one lane (warp) of the chunk kernel's warp body: u
    at d rounded up to 8 entries, and K2's x rows with an odd-word row
    stride where they live in shared memory (csrc/admm_chunk.cu
    wc_smem_floats)."""
    dr = _round_up(nv + m, 8)
    return 4 * (dr + (nv * _ld16(dr) if x_rows == "shared" else 0))


class ChunkGeometry(NamedTuple):
    """How the chunk kernel launches for one (nv, m)."""

    body: str  # "warp" or "block".
    x_rows: str | None  # the warp body's layout of K2's x rows.
    lanes_per_block: int
    threads: int  # a block.
    smem_bytes: int  # dynamic shared memory a block.


def admm_chunk_geometry(nv: int, m: int, body: str | None = None,
                        x_rows: str | None = None) -> ChunkGeometry:
    """The chunk kernel's body and launch shape for ``(nv, m)``.
    ``body=None`` decides from the shape alone, as the wrapper does: one
    warp per lane, ``WARP_LANES_PER_BLOCK`` lanes a block, when ``nv`` and
    ``m`` are both at most ``WARP_MAX_ROWS`` (every agent QP); else one
    block of ``d`` threads (whole warps) per lane. In the warp body
    ``x_rows=None`` holds K2's x rows in registers, split across the two
    half-warps, where ``nv <= WARP_SPLIT_MAX_NV`` (the C-ADMM headline,
    d = 48: no spills, faster than shared memory on an H100), and in the
    warp's shared memory otherwise (DD, d = 56, where whole rows in
    registers spill at the 128-register cap that keeps 16 lanes an SM).
    ``body``/``x_rows`` force a body or layout, to time one against another
    on the same inputs."""
    d = nv + m
    fits = nv <= WARP_MAX_ROWS and m <= WARP_MAX_ROWS
    if body is None:
        body = "warp" if fits else "block"
    if body not in CHUNK_BODIES or (body == "warp" and not fits):
        raise ValueError(f"body={body!r} for nv={nv}, m={m}: expected one "
                         f"of {CHUNK_BODIES}, 'warp' only for nv and m at "
                         f"most {WARP_MAX_ROWS}")
    if body == "block":
        if x_rows is not None:
            raise ValueError("x_rows= applies to the warp body only")
        return ChunkGeometry("block", None, 1, _round_up(d, 32),
                             admm_chunk_smem_bytes(nv, m))
    if x_rows is None:
        x_rows = "split" if nv <= WARP_SPLIT_MAX_NV else "shared"
    if x_rows not in X_ROWS or (x_rows == "split"
                                and nv > WARP_SPLIT_MAX_NV):
        raise ValueError(f"x_rows={x_rows!r} for nv={nv}: expected one of "
                         f"{X_ROWS}, 'split' only for nv at most "
                         f"{WARP_SPLIT_MAX_NV}")
    return ChunkGeometry("warp", x_rows, WARP_LANES_PER_BLOCK,
                         32 * WARP_LANES_PER_BLOCK,
                         WARP_LANES_PER_BLOCK
                         * warp_chunk_smem_bytes(nv, m, x_rows))


def admm_chunk_info(nv: int, m: int, *, body: str | None = None,
                    x_rows: str | None = None, device=None) -> dict:
    """What the build made of the chunk entry point a launch at ``(nv, m)``
    takes (``body``/``x_rows`` as in :func:`admm_chunk_geometry`), from
    the library itself, as :func:`fused_solve_info` reports it."""
    geo = admm_chunk_geometry(nv, m, body, x_rows)
    fn = _build.bind("admm_chunk", _CHUNK_INFO_ARGTYPES, "info")
    index = torch.device("cuda" if device is None else device).index
    index = torch.cuda.current_device() if index is None else index
    out = (ctypes.c_int * 6)()
    err = fn(nv, m, CHUNK_BODIES.index(geo.body),
             X_ROWS.index(geo.x_rows) if geo.x_rows else 0, index, out)
    _build.raise_on(err, "admm_chunk")
    return {"name": CHUNK_KERNEL_NAMES[geo.body], "x_rows": geo.x_rows,
            "lanes_per_block": out[0], "threads": out[1],
            "smem_bytes": out[2], "registers": out[3],
            "local_bytes": out[4], "lanes_per_sm": out[5]}


def _mv(M: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return (M @ v[..., None])[..., 0]


def _early(check_every: int, tol: float) -> bool:
    """The early-exit form is selected by both ``check_every`` and ``tol``
    being set (``admm_kernel.py:555`` of the JAX package)."""
    return bool(check_every) and tol > 0.0


def _check_precision(precision: str, ops) -> None:
    """``precision`` is a storage name, and the four operators share one
    dtype: float32, or bfloat16 under ``precision="bf16"``."""
    if precision not in STORAGE:
        raise ValueError(
            f"precision={precision!r}: expected one of {tuple(STORAGE)}")
    dtypes = {t.dtype for t in ops}
    if len(dtypes) != 1:
        raise TypeError("K2, Minv, A and P must share one dtype, got "
                        f"{sorted(map(str, dtypes))}")
    (dt,) = dtypes
    if dt != torch.float32 and dt != STORAGE[precision]:
        raise TypeError(
            f"operators of dtype {dt} with precision={precision!r}: expected "
            f"float32 or {STORAGE[precision]}")


def store_operators(ops, precision: str):
    """The operators in their storage type: each float32 one rounded on
    its own to bfloat16 under ``precision="bf16"`` (round to nearest even,
    as ``jnp.astype`` rounds); already-stored ones pass through."""
    return tuple(t.to(STORAGE[precision]) for t in ops)


def fused_solve_lanes_reference(
    x, y, z, K2, Minv, A, P, q, rho, lb, ub, shift=None, active=None,
    *, nv: int, n_box: int, soc_dims: Sequence[int], iters: int,
    alpha: float, check_every: int = 0, tol: float = 0.0,
    precision: str = "f32",
):
    """Plain PyTorch version of the kernel, on any device: batched tensor ops
    in the kernel's order of operations (``ops.socp._admm_step``) and Python
    loops. Returns ``(x, y, z, prim_res, dual_res)``, and ``eff_iters`` last
    in the early-exit form, whose loop is ``ops.socp._masked_chunk_loop``:
    the JAX kernel's masked loop (``admm_kernel.py:442-491``) over the whole
    batch, every lane frozen by a select once it stops. Under
    ``precision="bf16"`` the operators are rounded to bfloat16 (if they are
    not already) and every use reads them upcast to ``x``'s dtype."""
    from tpu_aerial_transport_torch.ops import socp

    early = _early(check_every, tol)
    if active is not None and not early:
        raise ValueError(
            "active= gating needs the early-exit form (check_every > 0 and "
            "tol > 0): a fixed-iteration kernel cannot express a "
            "0-effective-iteration pass-through"
        )
    if precision != "f32":
        _check_precision(precision, (K2, Minv, A, P))
        K2, Minv, A, P = (t.to(x.dtype) for t in
                          store_operators((K2, Minv, A, P), precision))
    wq = _mv(Minv, q)
    w2 = torch.cat([wq, _mv(A, wq)], dim=-1)
    step_kw = dict(nv=nv, n_box=n_box, soc_dims=tuple(soc_dims), alpha=alpha)

    def run_chunk(carry, k):
        for _ in range(k):
            carry = socp._admm_step(carry, K2, w2, rho, lb, ub, shift,
                                    **step_kw)
        return carry

    def residuals(carry):
        x_, y_, z_ = carry
        prim = torch.amax(torch.abs(_mv(A, x_) - z_), dim=-1)
        ATy = _mv(A.transpose(-1, -2), y_)
        dual = torch.amax(torch.abs(_mv(P, x_) + q + ATy), dim=-1)
        return prim, dual

    if not early:
        carry = run_chunk((x, y, z), iters)
        return (*carry, *residuals(carry))

    def above_tol(carry):
        prim, dual = residuals(carry)
        return (prim > tol) | (dual > tol)

    gate = None if active is None else active > 0
    carry, _, eff = socp._masked_chunk_loop(
        (x, y, z), run_chunk, above_tol, gate, iters, check_every)
    return (*carry, *residuals(carry), eff)


def admm_chunk_lanes_reference(
    x, y, z, K2, w2, rho, lb, ub, shift,
    *, nv: int, n_box: int, soc_dims: Sequence[int], iters: int,
    alpha: float,
):
    """Plain PyTorch version of the chunk kernel: ``iters`` batched
    ``ops.socp._admm_step`` calls. Returns ``(x, y, z)``."""
    from tpu_aerial_transport_torch.ops import socp

    carry = (x, y, z)
    for _ in range(iters):
        carry = socp._admm_step(carry, K2, w2, rho, lb, ub, shift, nv=nv,
                                n_box=n_box, soc_dims=tuple(soc_dims),
                                alpha=alpha)
    return carry


def _check(name, t, shape, device, dtype=torch.float32):
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a tensor, got {type(t).__name__}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, the kernel takes {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name} is not contiguous")


def _holds(nv: int, m: int, soc_dims, smem: int) -> bool:
    """Whether a kernel's limits take the shape: at most MAX_SOC_BLOCKS
    SOC blocks, d at most MAX_DIM, and ``smem`` (its launch's dynamic
    shared memory a block) at most MAX_SMEM_BYTES."""
    return (len(soc_dims) <= MAX_SOC_BLOCKS and nv + m <= MAX_DIM
            and smem <= MAX_SMEM_BYTES)


def fused_solve_fits(nv: int, m: int, n_box: int,
                     soc_dims: Sequence[int]) -> bool:
    """Whether the whole-solve kernel takes a solve of this shape, at the
    body and shared memory :func:`fused_solve_geometry` gives it: the limits
    :func:`_check_layout` enforces in :func:`fused_solve_lanes`. ``n_box``
    is part of the shape the solver passes; the limits do not read it."""
    del n_box
    return _holds(nv, m, soc_dims, fused_solve_geometry(nv, m).smem_bytes)


def admm_chunk_fits(nv: int, m: int, n_box: int,
                    soc_dims: Sequence[int]) -> bool:
    """Whether the chunk kernel takes a solve of this shape, at the body
    and shared memory :func:`admm_chunk_geometry` gives it (the limits
    :func:`_check_layout` enforces in :func:`admm_chunk_lanes`)."""
    del n_box
    return _holds(nv, m, soc_dims, admm_chunk_geometry(nv, m).smem_bytes)


def _check_layout(kernel, nv, m, n_box, soc_dims, iters, smem):
    """Raise on a cone layout or size the kernels do not take."""
    d = nv + m
    if m != n_box + sum(soc_dims):
        raise ValueError(
            f"m={m} != n_box={n_box} + sum(soc_dims)={sum(soc_dims)}"
        )
    if not _holds(nv, m, soc_dims, smem) or iters < 0:
        raise ValueError(
            f"{kernel} kernel takes d <= {MAX_DIM}, at most "
            f"{MAX_SOC_BLOCKS} SOC blocks, {MAX_SMEM_BYTES} B of shared "
            f"memory a lane and iters >= 0 (got d={d}, {len(soc_dims)} "
            f"blocks, {smem} B, iters={iters})"
        )
    if any(k < 2 for k in soc_dims):
        raise ValueError(
            f"soc_dims={soc_dims}: every SOC block needs dim >= 2")


def _soc_struct(soc_dims) -> _SocDims:
    dims = _SocDims()
    dims.n = len(soc_dims)
    for i, k in enumerate(soc_dims):
        dims.d[i] = k
    return dims


def _ptr(t):
    return None if t is None else t.data_ptr()


def fused_solve_lanes(
    x, y, z, K2, Minv, A, P, q, rho, lb, ub, shift=None, active=None,
    *, nv: int, n_box: int, soc_dims: Sequence[int], iters: int,
    alpha: float, check_every: int = 0, tol: float = 0.0,
    precision: str = "f32", body: str | None = None,
):
    """Whole batched solves, batch-first ``(B, rows...)``; returns
    ``(x, y, z, prim_res, dual_res)``, plus ``eff_iters`` ((B,) int32) in
    the early-exit form (``check_every > 0`` and ``tol > 0``), which also
    takes the ``active`` gate ((B,) bool or float; > 0 is on).
    ``precision="bf16"`` stores K2, Minv, A and P in bfloat16: pass them
    rounded already (``store_operators``, once per operator build) or in
    float32 (rounded here, each call). A mix of dtypes raises.

    CPU tensors run :func:`fused_solve_lanes_reference`. CUDA tensors launch
    the kernel on the current stream (no synchronisation) or raise: on a
    wrong device, dtype, shape or layout, on dims the kernel does not take,
    or on a launch error. The kernel's body is chosen from the shape alone
    (:func:`fused_solve_geometry`); ``body`` forces one, to time one body
    against the other on the same inputs (the port's callers never pass
    it)."""
    early = _early(check_every, tol)
    if active is not None and not early:
        raise ValueError(
            "active= gating needs the early-exit form (check_every > 0 and "
            "tol > 0): a fixed-iteration kernel cannot express a "
            "0-effective-iteration pass-through"
        )
    _check_precision(precision, (K2, Minv, A, P))
    if x.device.type == "cpu":
        return fused_solve_lanes_reference(
            x, y, z, K2, Minv, A, P, q, rho, lb, ub, shift, active, nv=nv,
            n_box=n_box, soc_dims=soc_dims, iters=iters, alpha=alpha,
            check_every=check_every, tol=tol, precision=precision,
        )
    if x.device.type != "cuda":
        raise ValueError(f"fused_solve_lanes: unsupported device {x.device}")
    K2, Minv, A, P = store_operators((K2, Minv, A, P), precision)
    soc_dims = tuple(int(k) for k in soc_dims)
    B = x.shape[0]
    m = rho.shape[-1]
    d = nv + m
    geo = fused_solve_geometry(nv, m, body)
    _check_layout("fused_solve", nv, m, n_box, soc_dims, iters,
                  geo.smem_bytes)
    dev = x.device
    for name, t, shape in (
        ("K2", K2, (B, d, d)), ("Minv", Minv, (B, nv, nv)),
        ("A", A, (B, m, nv)), ("P", P, (B, nv, nv)),
    ):
        _check(name, t, shape, dev, STORAGE[precision])
    for name, t, shape in (
        ("x", x, (B, nv)), ("y", y, (B, m)), ("z", z, (B, m)),
        ("q", q, (B, nv)), ("rho", rho, (B, m)), ("lb", lb, (B, n_box)),
        ("ub", ub, (B, n_box)),
    ):
        _check(name, t, shape, dev)
    if shift is not None:
        _check("shift", shift, (B, m), dev)
    gate = None
    if active is not None:
        if tuple(active.shape) != (B,) or active.device != dev:
            raise ValueError(
                f"active: shape {tuple(active.shape)} on {active.device}, "
                f"expected ({B},) on {dev}")
        gate = active.to(torch.float32).contiguous()

    fn = _build.bind("fused_solve", _FUSED_ARGTYPES)
    xo = torch.empty((B, nv), dtype=torch.float32, device=dev)
    yo = torch.empty((B, m), dtype=torch.float32, device=dev)
    zo = torch.empty((B, m), dtype=torch.float32, device=dev)
    res = torch.empty((B, 2), dtype=torch.float32, device=dev)
    eff = (torch.empty((B,), dtype=torch.int32, device=dev) if early
           else None)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = fn(
        _ptr(K2), _ptr(Minv), _ptr(A), _ptr(P), _ptr(q), _ptr(rho), _ptr(lb),
        _ptr(ub), _ptr(shift), _ptr(x), _ptr(y), _ptr(z), _ptr(gate),
        _ptr(xo), _ptr(yo), _ptr(zo), _ptr(res), _ptr(eff),
        B, nv, m, n_box, iters, int(check_every) if early else 0,
        float(tol) if early else 0.0, 1 if shift is not None else 0,
        1 if precision == "bf16" else 0, BODIES.index(geo.body),
        float(alpha), float(1 - alpha), _soc_struct(soc_dims), dev.index,
        stream,
    )
    _build.raise_on(err, "fused_solve")
    KERNEL_LAUNCHES[KERNEL_NAMES[geo.body, early, precision]] += 1
    suffix = "" if precision == "f32" else "_" + precision
    if early:
        LAUNCHES["fused_solve_early" + suffix] += 1
        return xo, yo, zo, res[:, 0], res[:, 1], eff
    LAUNCHES["fused_solve" + suffix] += 1
    return xo, yo, zo, res[:, 0], res[:, 1]


def admm_chunk_lanes(
    x, y, z, K2, w2, rho, lb, ub, shift,
    *, nv: int, n_box: int, soc_dims: Sequence[int], iters: int,
    alpha: float, body: str | None = None, x_rows: str | None = None,
):
    """``iters`` ADMM iterations per lane with ``K2`` and ``w2`` given,
    batch-first ``(B, rows...)``; returns ``(x, y, z)``.

    CPU tensors run :func:`admm_chunk_lanes_reference`. CUDA tensors launch
    the kernel on the current stream (no synchronisation) or raise, as
    :func:`fused_solve_lanes` does. The body and the x-row layout are
    chosen from the shape alone (:func:`admm_chunk_geometry`); ``body`` and
    ``x_rows`` force them, to time one against another on the same inputs
    (the port's callers never pass them)."""
    if x.device.type == "cpu":
        return admm_chunk_lanes_reference(
            x, y, z, K2, w2, rho, lb, ub, shift, nv=nv, n_box=n_box,
            soc_dims=soc_dims, iters=iters, alpha=alpha,
        )
    if x.device.type != "cuda":
        raise ValueError(f"admm_chunk_lanes: unsupported device {x.device}")
    soc_dims = tuple(int(k) for k in soc_dims)
    B = x.shape[0]
    m = rho.shape[-1]
    d = nv + m
    geo = admm_chunk_geometry(nv, m, body, x_rows)
    _check_layout("admm_chunk", nv, m, n_box, soc_dims, iters,
                  geo.smem_bytes)
    dev = x.device
    for name, t, shape in (
        ("x", x, (B, nv)), ("y", y, (B, m)), ("z", z, (B, m)),
        ("K2", K2, (B, d, d)), ("w2", w2, (B, d)), ("rho", rho, (B, m)),
        ("lb", lb, (B, n_box)), ("ub", ub, (B, n_box)),
        ("shift", shift, (B, m)),
    ):
        _check(name, t, shape, dev)

    fn = _build.bind("admm_chunk", _CHUNK_ARGTYPES)
    xo = torch.empty((B, nv), dtype=torch.float32, device=dev)
    yo = torch.empty((B, m), dtype=torch.float32, device=dev)
    zo = torch.empty((B, m), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = fn(
        _ptr(K2), _ptr(w2), _ptr(rho), _ptr(lb), _ptr(ub), _ptr(shift),
        _ptr(x), _ptr(y), _ptr(z), _ptr(xo), _ptr(yo), _ptr(zo),
        B, nv, m, n_box, iters, 1, CHUNK_BODIES.index(geo.body),
        X_ROWS.index(geo.x_rows) if geo.x_rows else 0, float(alpha),
        float(1 - alpha), _soc_struct(soc_dims), dev.index, stream,
    )
    _build.raise_on(err, "admm_chunk")
    CHUNK_LAUNCHES[CHUNK_KERNEL_NAMES[geo.body]] += 1
    LAUNCHES["admm_chunk"] += 1
    return xo, yo, zo
