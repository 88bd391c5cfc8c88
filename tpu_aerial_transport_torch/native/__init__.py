"""The float64 host oracle: ``socp_solver.cpp`` bound through ctypes.

``socp_solver.cpp`` is the ADMM of :mod:`tpu_aerial_transport_torch.ops.socp`
(the same splitting, equality-row penalty, over-relaxation and cone regimes)
in dependency-free float64 C++. The tests and ``chip_smoke.py`` hold the
port's float32 solves, the whole-solve kernel's among them, against it: an
implementation that shares no code with the one under test.

Build: at first use, ``g++ -O3 -shared -fPIC`` (``CXX_FLAGS``) into
``build/native/`` beside the package (listed in ``.gitignore``), under a
library name that carries the digest of the source and the flags, so an
edited source or a changed flag is rebuilt and a stale library is never
loaded. The library is written to a temporary file and renamed into place,
so processes building at once never load a torn file. A failed build
raises with the compiler's stderr, and so does every later call in the
process: nothing falls back. :func:`available` says whether the library
built and loaded.

Arguments are numpy arrays or CPU tensors (anything ``np.asarray`` takes);
results are float64 numpy arrays.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(_HERE, "socp_solver.cpp")
CXX = "g++"
CXX_FLAGS = ("-O3", "-shared", "-fPIC")

_lib = None
_build_error: str | None = None


def build_dir() -> str:
    return os.path.join(os.path.dirname(os.path.dirname(_HERE)), "build",
                        "native")


def library_path() -> str:
    """Where the library of the live source and flags lives."""
    digest = hashlib.sha256()
    with open(SOURCE, "rb") as f:
        digest.update(f.read())
    digest.update(" ".join((CXX,) + CXX_FLAGS).encode())
    name = f"libtat_socp-{digest.hexdigest()[:16]}.so"
    return os.path.join(build_dir(), name)


def build() -> str:
    """Compile the library unless the build directory holds it; returns its
    path. Raises ``RuntimeError`` with the compiler's stderr on failure, or
    when no compiler is found."""
    out = library_path()
    if os.path.isfile(out):
        return out
    cxx = shutil.which(CXX)
    if cxx is None:
        raise RuntimeError(
            f"native: no C++ compiler {CXX!r} on PATH: the float64 oracle "
            "is built from native/socp_solver.cpp at first use")
    os.makedirs(build_dir(), exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    proc = subprocess.run([cxx, *CXX_FLAGS, SOURCE, "-o", tmp],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise RuntimeError(
            f"native: {CXX} failed (rc {proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, out)
    return out


def _load():
    global _lib, _build_error
    if _lib is not None:
        return _lib
    if _build_error is not None:
        raise RuntimeError(_build_error)
    try:
        lib = ctypes.CDLL(build())
    except (OSError, RuntimeError) as e:
        _build_error = str(e)
        raise RuntimeError(_build_error) from e
    d = ctypes.POINTER(ctypes.c_double)
    i32 = ctypes.POINTER(ctypes.c_int32)
    lib.socp_solve.restype = ctypes.c_int
    lib.socp_solve.argtypes = [
        d, d, d, d, d, d,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, i32, ctypes.c_int,
        ctypes.c_int, ctypes.c_double, ctypes.c_double, ctypes.c_double,
        d, d, d, d, d, d, d,
    ]
    lib.socp_solve_batch.restype = ctypes.c_int
    lib.socp_solve_batch.argtypes = [
        d, d, d, d, d, d,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, i32,
        ctypes.c_int,
        ctypes.c_int, ctypes.c_double, ctypes.c_double, ctypes.c_double,
        d, d, d, d,
    ]
    _lib = lib
    return _lib


def available() -> bool:
    """True when the library built (or was built) and loaded here."""
    try:
        _load()
    except RuntimeError:
        return False
    return True


def _f64(a) -> np.ndarray:
    """A C-contiguous float64 copy of ``a`` (a numpy array or a CPU
    tensor; a tensor on another device is a ValueError: the oracle runs on
    the host, and the caller moves what it compares)."""
    device = getattr(a, "device", None)
    if device is not None and getattr(device, "type", "cpu") != "cpu":
        raise ValueError(f"native: a tensor on {device}; pass it on the CPU")
    if hasattr(a, "detach"):
        a = a.detach().numpy()
    return np.ascontiguousarray(a, np.float64)


def _ptr(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def _check_shapes(batch: tuple, nv: int, m: int, n_box: int, **arrays):
    """Raise unless each array has the shape the C solver reads (it reads
    through raw pointers: a short array would be read past its end)."""
    want = {"P": (nv, nv), "q": (nv,), "A": (m, nv), "lb": (n_box,),
            "ub": (n_box,), "shift": (m,), "x0": (nv,), "y0": (m,),
            "z0": (m,)}
    for name, a in arrays.items():
        if a is not None and a.shape != batch + want[name]:
            raise ValueError(f"native: {name} has shape {a.shape}, "
                             f"expected {batch + want[name]}")


def solve_socp_native(
    P, q, A, lb, ub, *, n_box: int, soc_dims=(), iters: int = 200,
    rho: float = 0.4, sigma: float = 1e-6, alpha: float = 1.6, shift=None,
    warm=None,
):
    """Solve one conic QP in float64. The problem layout and defaults of
    :func:`tpu_aerial_transport_torch.ops.socp.solve_socp` without its
    batch axis. Returns ``(x, y, z, prim_res, dual_res)`` as numpy arrays
    and floats."""
    lib = _load()
    P, q, A, lb, ub = (_f64(a) for a in (P, q, A, lb, ub))
    m, nv = A.shape
    dims = np.ascontiguousarray(soc_dims, np.int32)
    if m != n_box + int(dims.sum()):
        raise ValueError(f"native: A has {m} rows, the cones {n_box} + "
                         f"{int(dims.sum())}")
    shift_p = None
    if shift is not None:
        shift = _f64(shift)
        shift_p = _ptr(shift)
    x = np.zeros(nv)
    y = np.zeros(m)
    z = np.zeros(m)
    res = np.zeros(2)
    x0 = y0 = z0 = None
    if warm is not None:
        x0, y0, z0 = (_f64(w) for w in warm)
    _check_shapes((), nv, m, n_box, P=P, q=q, lb=lb, ub=ub, shift=shift,
                  x0=x0, y0=y0, z0=z0)
    rc = lib.socp_solve(
        _ptr(P), _ptr(q), _ptr(A), _ptr(lb), _ptr(ub), shift_p,
        nv, m, n_box,
        dims.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), len(dims),
        iters, rho, sigma, alpha,
        _ptr(x0) if x0 is not None else None,
        _ptr(y0) if y0 is not None else None,
        _ptr(z0) if z0 is not None else None,
        _ptr(x), _ptr(y), _ptr(z), _ptr(res),
    )
    if rc != 0:
        raise RuntimeError("native: KKT factorization failed (P not PSD?)")
    return x, y, z, float(res[0]), float(res[1])


def solve_socp_native_batch(
    P, q, A, lb, ub, *, n_box: int, soc_dims=(), iters: int = 200,
    rho: float = 0.4, sigma: float = 1e-6, alpha: float = 1.6, shift=None,
):
    """Float64 solves over the leading axis (problems of one layout, each
    its own data; ``shift`` is ``(nb, m)`` when given). Returns ``(x (nb,
    nv), residuals (nb, 2))``, the residuals ``(prim, dual)``."""
    lib = _load()
    P, q, A, lb, ub = (_f64(a) for a in (P, q, A, lb, ub))
    nb, m, nv = A.shape
    dims = np.ascontiguousarray(soc_dims, np.int32)
    if m != n_box + int(dims.sum()):
        raise ValueError(f"native: A has {m} rows, the cones {n_box} + "
                         f"{int(dims.sum())}")
    shift_p = None
    if shift is not None:
        shift = _f64(shift)
        shift_p = _ptr(shift)
    _check_shapes((nb,), nv, m, n_box, P=P, q=q, lb=lb, ub=ub, shift=shift)
    x = np.zeros((nb, nv))
    y = np.zeros((nb, m))
    z = np.zeros((nb, m))
    res = np.zeros((nb, 2))
    rc = lib.socp_solve_batch(
        _ptr(P), _ptr(q), _ptr(A), _ptr(lb), _ptr(ub), shift_p,
        nb, nv, m, n_box,
        dims.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), len(dims),
        iters, rho, sigma, alpha,
        _ptr(x), _ptr(y), _ptr(z), _ptr(res),
    )
    if rc != 0:
        raise RuntimeError("native: KKT factorization failed in the batch")
    return x, res
