"""Consensus-exchange seam: the cross-shard collective behind the agent-
sharded C-ADMM consensus mean and residual and the DD price and violation
sums, with three implementations behind one gate resolved at config build.

Counterpart of ``tpu_aerial_transport/parallel/ring.py``. The JAX package
runs each shard as its own program under ``shard_map``; the port holds the
d shards of one card as an explicit leading axis, the stacked view that
``shard_map``'s ``in_specs=P("agent")`` gives. Every exchange takes ``x``
of shape ``(d, ...)``, row r being what shard r holds, and returns
``(d, ...)``, row r being what shard r receives; a gather returns
``(d, d, ...)``. The implementations (``impl``):

- ``"allreduce"``: one reduction over the shard axis, broadcast back (the
  JAX package's ``psum``/``pmax``/``pmin`` and ``all_gather``);
- ``"ring"``: the JAX package's ring written hop by hop, each hop
  vectorised over the shard axis (``torch.roll(buf, 1, dims=0)`` is the
  ``ppermute`` to the right neighbour): sums as reduce-scatter then
  all-gather, the same float32 adds in the same order, so bitwise equal to
  the JAX package's ring sum and identical on every shard; max and min as
  rotate-and-accumulate, gathers as a rotation scattered by source. It
  reproduces the JAX ring's arithmetic on any device; on one card it is
  the slowest impl (2 (d - 1) hops of small ops a sum);
- ``"pallas_ring"``: sums through the ring-sum kernel
  (``csrc/ring_sum.cu``: one launch, each thread adding its columns' d
  shard values in every shard's ring order in registers); max, min and
  gathers take the ring's rotate paths, as in the JAX package.

One deliberate difference: off the TPU the JAX package quietly runs
``"pallas_ring"`` as ``"ring"``. The port launches its kernel for tensors
on the card and runs the kernel's plain version
(:func:`ring_sum_shards_reference`) for tensors on the CPU, as every kernel
of the port does. The plain version adds in the kernel's order, not the
ring's, so under ``"pallas_ring"`` the shards' copies of a sum may differ
in their last bits; exact exchanges (max, min, gathers, sums of 0/1 flags)
stay uniform, so every shard stops its loops together.

Every exchange runs inside the ``tat.consensus_exchange`` scope.
"""

from __future__ import annotations

import ctypes
import os

import torch

from tpu_aerial_transport_torch.obs import phases
from tpu_aerial_transport_torch.ops import _build

IMPLS = ("allreduce", "ring", "pallas_ring")
ENV_VAR = "TPU_AERIAL_CONSENSUS"
OPS = ("sum", "max", "min")
# The most shards the ring-sum kernel is built for (csrc/ring_sum.cu
# RS_MAX_SHARDS): a thread holds its columns' d values in registers. More
# shards, or shards on several cards, need the cross-card form.
MAX_SHARDS = 32

# Plain launch counter: the wrapper adds one where it launches its kernel.
LAUNCHES = {"ring_sum": 0}

# ring_sum_launch(x, out, d, P, device, stream) -> cudaError_t.
_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
             ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]
# ring_sum_info(d, P, device, int out[3]) -> cudaError_t.
_INFO_ARGTYPES = [ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
                  ctypes.c_void_p]

_ALLREDUCE = {
    "sum": lambda x: torch.sum(x, dim=0, keepdim=True),
    "max": lambda x: torch.amax(x, dim=0, keepdim=True),
    "min": lambda x: torch.amin(x, dim=0, keepdim=True),
}
_COMBINE = {"sum": torch.add, "max": torch.maximum, "min": torch.minimum}


def resolve_consensus(impl: str | None = "auto", device="cuda") -> str:
    """Resolve ``"auto"`` (or None) at config build time: the
    ``TPU_AERIAL_CONSENSUS`` env var (``allreduce`` | ``ring`` |
    ``pallas_ring`` | ``auto``/unset), else ``"allreduce"`` on the CPU and
    ``"ring"`` on the card (the JAX package's rule for a non-CPU backend).
    An explicit impl wins over the env var; anything else is a
    ValueError."""
    if impl is None:
        impl = "auto"
    if impl == "auto":
        env = os.environ.get(ENV_VAR, "").strip().lower()
        if env in IMPLS:
            return env
        if env not in ("", "auto"):
            raise ValueError(
                f"{ENV_VAR}={env!r}: expected one of {IMPLS} or 'auto'"
            )
        return "allreduce" if torch.device(device).type == "cpu" else "ring"
    if impl not in IMPLS:
        raise ValueError(
            f"consensus_impl={impl!r}: expected one of {IMPLS} or 'auto'"
        )
    return impl


def _check_impl(impl: str) -> None:
    if impl not in IMPLS:
        raise ValueError(
            f"impl={impl!r}: expected one of {IMPLS} -- resolve 'auto' at "
            "config build time with resolve_consensus()"
        )


def _check_shards(x: torch.Tensor, axis_size: int) -> None:
    if x.dim() < 1 or x.shape[0] != axis_size:
        raise ValueError(
            f"x of shape {tuple(x.shape)}: expected a leading shard axis of "
            f"{axis_size}"
        )


def consensus_exchange(x: torch.Tensor, *, axis_size: int, op: str = "sum",
                       impl: str = "allreduce") -> torch.Tensor:
    """All-reduce the stacked shards ``x (d, ...)`` with ``op`` in
    ``{"sum", "max", "min"}``: row r of the result is shard r's copy.
    Max and min are exact under any impl; a sum under ``"ring"`` differs
    from ``"allreduce"`` only in summation order, is bitwise identical
    across shards and bitwise equal to the JAX package's ``"ring"``; under
    ``"pallas_ring"`` each shard adds in its own ring order (see the module
    docstring)."""
    if op not in OPS:
        raise ValueError(f"op={op!r}: expected one of {OPS}")
    _check_impl(impl)
    _check_shards(x, axis_size)
    with phases.scope(phases.CONSENSUS_EXCHANGE):
        if axis_size == 1:
            return x
        if impl == "allreduce":
            return _ALLREDUCE[op](x).expand_as(x)
        if impl == "pallas_ring" and op == "sum":
            flat = x.reshape(axis_size, -1).contiguous()
            return ring_sum_shards(flat).reshape(x.shape)
        if op == "sum":
            return _ring_allreduce_sum(x)
        return _rotate_allreduce(x, _COMBINE[op])


def consensus_gather(x: torch.Tensor, *, axis_size: int,
                     impl: str = "allreduce") -> torch.Tensor:
    """``all_gather`` through the seam: ``(d, ...) -> (d, d, ...)``, row r
    the shard-ordered stack shard r receives, identical on every shard
    under every impl. ``"ring"`` and ``"pallas_ring"`` rotate each shard's
    block around the ring (d - 1 hops), scattered by source."""
    _check_impl(impl)
    _check_shards(x, axis_size)
    with phases.scope(phases.CONSENSUS_EXCHANGE):
        if impl == "allreduce" or axis_size == 1:
            return x[None].expand((axis_size,) + x.shape)
        return _ring_gather(x)


def _right(buf: torch.Tensor) -> torch.Tensor:
    """One hop to the right neighbour: shard r receives shard r - 1's."""
    return torch.roll(buf, 1, dims=0)


def _ring_allreduce_sum(x: torch.Tensor) -> torch.Tensor:
    """Ring reduce-scatter + all-gather sum (2 (d - 1) hops of 1/d of the
    payload; JAX ``ring.py:206-235``). After d - 1 hops shard i owns the
    complete chunk (i + 1) % d, which the all-gather hops rotate to
    everyone. A payload that does not divide by d is zero-padded."""
    d = x.shape[0]
    flat = x.reshape(d, -1)
    size = flat.shape[1]
    chunk = -(-size // d)
    chunks = torch.nn.functional.pad(flat, (0, chunk * d - size))
    chunks = chunks.reshape(d, d, chunk).clone()
    i = torch.arange(d, device=x.device)
    # Reduce-scatter: at hop s shard i forwards its running sum of chunk
    # (i - s) % d and folds the incoming one into chunk (i - s - 1) % d.
    for s in range(d - 1):
        buf = _right(chunks[i, (i - s) % d])
        dst = (i - s - 1) % d
        chunks[i, dst] = chunks[i, dst] + buf
    # All-gather: rotate the complete chunks around the ring.
    for s in range(d - 1):
        chunks[i, (i - s) % d] = _right(chunks[i, (i + 1 - s) % d])
    return chunks.reshape(d, -1)[:, :size].reshape(x.shape)


def _rotate_allreduce(x: torch.Tensor, combine) -> torch.Tensor:
    """Rotate-and-accumulate (d - 1 full-payload hops): each shard's value
    travels the whole ring, folded in on arrival."""
    acc, buf = x, x
    for _ in range(x.shape[0] - 1):
        buf = _right(buf)
        acc = combine(acc, buf)
    return acc


def _ring_gather(x: torch.Tensor) -> torch.Tensor:
    """Ring all-gather: after s hops shard i holds shard (i - s) % d's
    block, written into its output at that source index."""
    d = x.shape[0]
    i = torch.arange(d, device=x.device)
    out = torch.empty((d,) + x.shape, dtype=x.dtype, device=x.device)
    out[i, i] = x
    buf = x
    for s in range(1, d):
        buf = _right(buf)
        out[i, (i - s) % d] = buf
    return out


# ----------------------------------------------------------------------
# The ring-sum kernel and its plain version.
# ----------------------------------------------------------------------


def ring_sum_shards_reference(x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the ring-sum kernel on any device: the
    kernel's hops with ``torch.roll``, in its order. Row r of the result is
    ``x_r + x_{r-1} + ... + x_{r-d+1}`` (indices mod d), added left to
    right in ``x``'s dtype."""
    acc, buf = x, x
    for _ in range(x.shape[0] - 1):
        buf = _right(buf)
        acc = acc + buf
    return acc


def ring_sum_bytes(d: int, P: int) -> int:
    """Bytes the ring sum must move: the (d, P) float32 input read once and
    the output written once."""
    return 2 * d * P * 4


def ring_sum_flops(d: int, P: int) -> int:
    """float32 adds of the ring sum: d - 1 for each of the d x P outputs."""
    return (d - 1) * d * P


def ring_sum_shards(x: torch.Tensor) -> torch.Tensor:
    """Ring all-reduce sum of the stacked shards ``x (d, P)`` float32: row
    r of the result is shard r's copy of the sum, in the TPU kernel's ring
    order (:func:`ring_sum_shards_reference`).

    Raises on a dtype or shape the kernel does not take and on more than
    ``MAX_SHARDS`` shards, on any device. CPU tensors run the plain
    version. CUDA tensors launch ``ring_sum_kernel`` on the current stream
    (no synchronisation) or raise: on a layout the kernel does not take or
    a launch error."""
    if not isinstance(x, torch.Tensor):
        raise TypeError(f"x: expected a tensor, got {type(x).__name__}")
    if x.dtype != torch.float32:
        raise TypeError(f"x: dtype {x.dtype}, the kernel takes float32")
    if x.dim() != 2 or x.shape[0] < 1:
        raise ValueError(f"x: shape {tuple(x.shape)}, expected (d >= 1, P)")
    d, P = x.shape
    if d > MAX_SHARDS:
        raise ValueError(
            f"{d} shards: the ring-sum kernel takes at most {MAX_SHARDS} (a "
            "thread holds a column's d values in registers; the cross-card "
            "form is not ported)"
        )
    if x.device.type == "cpu":
        return ring_sum_shards_reference(x)
    if x.device.type != "cuda":
        raise ValueError(f"ring_sum_shards: unsupported device {x.device}")
    if not x.is_contiguous():
        raise ValueError("x is not contiguous")
    out = torch.empty_like(x)
    if P == 0:
        return out
    fn = _build.bind("ring_sum", _ARGTYPES)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = fn(x.data_ptr(), out.data_ptr(), d, P, x.device.index, stream)
    _build.raise_on(err, "ring_sum")
    LAUNCHES["ring_sum"] += 1
    return out


def ring_sum_info(d: int, P: int, device=None) -> dict:
    """What the build made of the kernel a ``(d, P)`` launch takes:
    ``{"registers", "local_bytes", "vec16"}`` (registers a thread, local
    memory a thread -- spills -- and whether it takes the 16-byte form)."""
    fn = _build.bind("ring_sum", _INFO_ARGTYPES, "info")
    index = torch.device("cuda" if device is None else device).index
    index = torch.cuda.current_device() if index is None else index
    out = (ctypes.c_int * 3)()
    _build.raise_on(fn(d, P, index, out), "ring_sum")
    return {"registers": out[0], "local_bytes": out[1], "vec16": bool(out[2])}
