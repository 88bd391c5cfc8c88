"""Build and load the port's CUDA kernels (``csrc/*.cu``) at first use.

Each source is compiled by ``nvcc`` into its own shared library with a plain C
interface, loaded through ``ctypes``:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -Xptxas -v -split-compile=0 \\
         -o <build>/<name>-<hash>.so csrc/<name>.cu

The library name carries a hash of the source, the shared headers
(``csrc/*.cuh``) and the flags, so an edited source or header is rebuilt and
a stale library is never loaded. The build directory is
``build/kernels`` beside the package (listed in ``.gitignore``), or
``TAT_TORCH_BUILD_DIR``. :func:`build` compiles several sources at once, one
``nvcc`` process each, all started together; ``-split-compile=0`` lets
each one compile its entry functions on every core, so the build (which
counts against the smoke's time limit) does not wait on one core a source.

A library built elsewhere (an AOT bundle's, ``aot/``) is put in place by
:func:`install` under the name :func:`library_path` gives it, so that
:func:`build` finds it and compiles nothing. :func:`nvcc_builds` counts the
libraries this process compiled (the zero-compile counter of a bundled
serving process).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
KERNELS = ("fused_solve", "admm_chunk", "ring_sum")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-split-compile=0",
)

_LOCK = threading.Lock()
_LIBS: dict[str, ctypes.CDLL] = {}
_LOADED: dict[str, str] = {}  # name -> source digest of the loaded library.
_NVCC_BUILDS = 0


class StaleLibrary(ValueError):
    """A prebuilt library whose source digest is not the live source's, or
    not the one this process already loaded: its launchers' argument types
    (which live in Python) may not match it, so it is never loaded."""


def build_dir() -> str:
    return os.environ.get("TAT_TORCH_BUILD_DIR") or os.path.join(
        os.path.dirname(_PKG), "build", "kernels"
    )


def nvcc_path() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [os.path.join(home, "bin", "nvcc")] if home else []
    found = shutil.which("nvcc")
    if found:
        candidates.append(found)
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME or put nvcc on PATH): the port's "
        "CUDA kernels are built from csrc/ at first use"
    )


def _source(name: str) -> str:
    path = os.path.join(CSRC, name + ".cu")
    if not os.path.isfile(path):
        raise FileNotFoundError(path)
    return path


def source_digest(name: str) -> str:
    """The 16 hex digits of the sha256 over library ``name``'s source, the
    shared headers and the flags: what its file name carries."""
    digest = hashlib.sha256()
    headers = sorted(f for f in os.listdir(CSRC) if f.endswith(".cuh"))
    for path in [_source(name)] + [os.path.join(CSRC, h) for h in headers]:
        with open(path, "rb") as f:
            digest.update(f.read())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return digest.hexdigest()[:16]


def library_path(name: str, digest: str | None = None) -> str:
    digest = source_digest(name) if digest is None else digest
    return os.path.join(build_dir(), f"{name}-{digest}.so")


def nvcc_builds() -> int:
    """How many libraries :func:`build` compiled in this process."""
    return _NVCC_BUILDS


def install(name: str, payload: bytes, digest: str) -> str:
    """Put a prebuilt library of ``name`` (``payload``, the bytes of a
    library built from sources of ``digest``, already verified by the
    caller) where :func:`load` looks for it, so that nothing is compiled.
    Returns ``"loaded"`` when this process already loaded a library of
    that digest, ``"present"`` when the build directory holds one, else
    ``"installed"`` (written to a temporary file, synced and renamed into
    place). Raises :class:`StaleLibrary` when ``digest`` is not the live
    source's, or not that of the library already loaded."""
    live = source_digest(name)
    with _LOCK:
        loaded = _LOADED.get(name)
        if loaded is not None:
            if loaded != digest:
                raise StaleLibrary(
                    f"{name}: this process loaded the library of sources "
                    f"{loaded}, the bundle's is of {digest}")
            return "loaded"
        if digest != live:
            raise StaleLibrary(
                f"{name}: the bundle's library is of sources {digest}, the "
                f"live csrc/ is {live}")
        path = library_path(name, digest)
        if os.path.isfile(path):
            return "present"
        os.makedirs(build_dir(), exist_ok=True)
        tmp = f"{path}.{os.getpid()}.tmp"
        with open(tmp, "wb") as f:
            f.write(payload)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
        return "installed"


def build(names=KERNELS) -> dict[str, tuple[float, str]]:
    """Compile every missing library of ``names`` in parallel (one ``nvcc``
    each, all started together); raise with the compiler's output if any
    fails. Returns ``{name: (seconds, nvcc output)}`` for the ones built."""
    global _NVCC_BUILDS
    os.makedirs(build_dir(), exist_ok=True)
    todo = [n for n in names if not os.path.isfile(library_path(n))]
    if not todo:
        return {}
    nvcc = nvcc_path()
    procs = {}
    t0 = time.perf_counter()
    for n in todo:
        out = library_path(n)
        tmp = f"{out}.{os.getpid()}.tmp"
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, _source(n)]
        procs[n] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        ), tmp, out)
    done, failed = {}, []
    for n, (p, tmp, out) in procs.items():
        log, _ = p.communicate()
        secs = time.perf_counter() - t0
        if p.returncode != 0:
            failed.append(f"{n}: nvcc exited {p.returncode}\n{log}")
            continue
        os.replace(tmp, out)
        done[n] = (secs, log)
    _NVCC_BUILDS += len(procs)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return done


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``name``, built first if missing."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            digest = source_digest(name)
            path = library_path(name, digest)
            if not os.path.isfile(path):
                build((name,))
            lib = ctypes.CDLL(path)
            _LIBS[name] = lib
            _LOADED[name] = digest
        return lib


def error_string(err: int, name: str = "fused_solve") -> str:
    """The CUDA runtime's text for ``err``, from kernel library ``name``."""
    lib = load(name)
    fn = getattr(lib, f"{name}_error_string")
    fn.argtypes = [ctypes.c_int]
    fn.restype = ctypes.c_char_p
    return fn(err).decode()


def bind(name: str, argtypes, entry: str = "launch"):
    """Library ``name``'s ``<name>_<entry>`` (the launcher, or another C
    entry such as ``info``) with its argument types set (pointers and the
    stream as ``c_void_p``) and a ``cudaError_t`` result."""
    fn = getattr(load(name), f"{name}_{entry}")
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn


def raise_on(err: int, name: str) -> None:
    """Raise with the runtime's text when a launch returned an error."""
    if err != 0:
        raise RuntimeError(
            f"{name} kernel launch failed: {error_string(err, name)} "
            f"(cudaError {err})"
        )
