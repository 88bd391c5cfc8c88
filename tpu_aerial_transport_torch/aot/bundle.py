"""Build side of the AOT bundles: the entry-point registry
(``analysis.contracts``) turned into a versioned, content-addressed bundle,
so that a serving replica loads its CUDA kernels prebuilt and runs no
``nvcc``.

Counterpart of the JAX package's ``aot/bundle.py``, with its manifest
discipline and its names. A bundle directory holds::

    <bundle>/manifest.json        # schema version, runtime fingerprint,
                                  # kernel libraries, per-entry variants
    <bundle>/objects/<sha>.bin    # content-addressed payloads

What a bundle carries in the port:

- **kernel libraries** (the counterpart of the JAX ``exec`` artifact):
  every ``.so`` that ``ops/_build.py`` builds (``_build.KERNELS``), each
  recorded with the source digest its file name carries
  (``_build.library_path``). The manifest pins :func:`runtime_fingerprint`
  (torch version, CUDA runtime version, the card's compute capability and
  name, the driver version). A library is valid only where the
  capability, the torch version, the CUDA runtime version and the source
  digest all equal the live process's; otherwise the loader refuses with
  ``bundle_stale`` and the rebuild hint. ``nvcc --version`` of the build
  is recorded for provenance only: a serving host may have no ``nvcc``.
  A bundle built on the CPU carries no library (nothing there launches
  one).
- **variants**, one per entry x shape signature: ``sig``
  (:func:`abstract_signature`, never the device), ``in_avals`` and
  ``out_avals``, the in and out tree structures, ``args_sample`` (the
  build-time arguments as host numpy: a serving replica's template carry)
  and ``kernels``, the libraries the entry launched while the variant was
  built. The :data:`BUCKETED_ENTRIES` add one variant for each scenario
  batch bucket (:func:`bucketed_batch`).

There is no ``bundle_export`` flavor. The JAX export rung replays a
serialized program so that Python is not traced again; the port runs
eagerly, so there is no trace to skip, and the driver cannot replay a
library built for another fingerprint. The Python that runs is the live
tree's: the loader checks a call's signature and tree structure against
the manifest, installs the bundle's libraries and runs the caller's (or
the registry's) callable, then checks its outputs against ``out_avals``.

CUDA graph captures are not bundled (PyTorch cannot serialize them): a
bundled replica still captures the substeps' graph at each batch shape's
first chunk.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import pickle
import subprocess

import numpy as np
import torch

from tpu_aerial_transport_torch.tree import TensorSpec, tree_map

SCHEMA_VERSION = 1

MANIFEST_NAME = "manifest.json"
OBJECTS_DIR = "objects"

# Synthetic probe entry built into every bundle: the device computation of
# ``resilience.backend``'s probe (a matmul and an explicit float32 ->
# bfloat16 -> float32 round trip) plus, on the card, one ring-sum kernel
# launch on a (2, 128) input, so that a backend probe touches a bundled
# library.
PROBE_ENTRY = "aot:probe"

# Scenario-batch tile for bucketed variants (``bucket_dim`` grid).
BATCH_BUCKET_TILE = 8

# Entries with a leading scenario-batch axis that may be built at several
# batch buckets (entry name -> batch axis). The serving chunk entries are
# the continuous-batching tier's admission surface; the lane-surgery
# entries ride the same buckets, since a device-surgery replica serves both
# at every boundary.
BUCKETED_ENTRIES: dict[str, int] = {
    "parallel.mesh:scenario_rollout": 0,
    "serving.batcher:serving_chunk": 0,
    "serving.batcher:serving_chunk_centralized": 0,
    "serving.lanes:lane_surgery": 0,
    "serving.lanes:lane_surgery_centralized": 0,
}

# Fingerprint keys a bundle's libraries are valid under; the others (the
# card's name, the driver version) are recorded for provenance.
ENFORCED_KEYS = ("platform", "torch", "cuda_runtime", "capability")


@dataclasses.dataclass(frozen=True)
class BundleError(Exception):
    """Structured bundle failure (the JAX package's kinds).

    kind: ``unreadable`` (missing or truncated manifest or object),
    ``schema`` (newer bundle format), ``missing_entry`` (entry or variant
    not in the bundle), ``signature_mismatch`` (caller shapes or dtypes
    differ from every built variant), ``treedef_mismatch`` (caller tree
    structure differs from the recorded one), ``corrupt`` (object payload
    digest mismatch), ``bundle_stale`` (the fingerprint or a library's
    source digest differs from this process: rebuild the bundle),
    ``exec_unavailable`` (the bundle was built for another platform than
    the call's, or a card bundle lacks a kernel library), and the port's
    ``output_mismatch`` (a served call's outputs differ from the variant's
    record: the program drifted since the build).
    """

    kind: str
    path: str
    detail: str = ""

    def __str__(self) -> str:
        msg = f"[{self.kind}] {self.path}: {self.detail}"
        if self.kind == "bundle_stale":
            out = (os.path.dirname(self.path) if self.path.endswith(".json")
                   else self.path)
            msg += (" -- rebuild hint: python3 -m "
                    "tpu_aerial_transport_torch.tools.aot_bundle build "
                    f"--out {out}")
        return msg


# ----------------------------------------------------------------------
# Fingerprints and signatures.
# ----------------------------------------------------------------------

def _driver_version() -> str | None:
    """The CUDA driver's version (``cuDriverGetVersion``), or None."""
    import ctypes

    try:
        lib = ctypes.CDLL("libcuda.so.1")
        v = ctypes.c_int()
        if lib.cuDriverGetVersion(ctypes.byref(v)) != 0:
            return None
    except OSError:
        return None
    return f"{v.value // 1000}.{(v.value % 1000) // 10}"


def runtime_fingerprint(platform: str | None = None) -> dict:
    """Identity of the building or serving runtime on ``platform``
    (``"cuda"`` or ``"cpu"``; default the card when one is visible): the
    torch version, ``torch.version.cuda``, and on the card its compute
    capability, name and driver version. A bundle's libraries are valid
    only where :data:`ENFORCED_KEYS` are equal."""
    if platform is None:
        platform = default_device()
    fp = {"platform": platform, "torch": torch.__version__,
          "cuda_runtime": torch.version.cuda, "capability": None,
          "device_name": None, "driver": None}
    if platform == "cuda" and torch.cuda.is_available():
        major, minor = torch.cuda.get_device_capability(0)
        fp.update(capability=f"{major}.{minor}",
                  device_name=torch.cuda.get_device_name(0),
                  driver=_driver_version())
    return fp


def nvcc_version() -> str | None:
    """The last line of ``nvcc --version`` (provenance), or None."""
    from tpu_aerial_transport_torch.ops import _build

    try:
        out = subprocess.run([_build.nvcc_path(), "--version"],
                             capture_output=True, text=True, timeout=60)
    except (RuntimeError, OSError, subprocess.TimeoutExpired):
        return None
    lines = out.stdout.strip().splitlines()
    return lines[-1] if lines else None


_LEAVES = (torch.Tensor, TensorSpec, np.ndarray, np.generic)
_SCALARS = (bool, int, float)


class ScalarSpec:
    """A Python number of an argument tuple (the chunk offset), as a leaf
    of a recorded tree structure."""

    __slots__ = ("dtype",)

    def __init__(self, dtype: str):
        self.dtype = dtype


def _walk(tree, out: list, top: bool) -> str:
    """Structure string of ``tree`` (``tree.tree_structure``'s, with
    numpy arrays and :class:`ScalarSpec` as leaves too), appending the
    leaves to ``out``. ``top``: ``tree`` is an element of the argument
    tuple, where a Python number is a leaf (as ``jax.tree`` takes one)."""
    if isinstance(tree, _LEAVES + (ScalarSpec,)) or (
            top and isinstance(tree, _SCALARS)):
        out.append(tree)
        return "*"
    if tree is None:
        return "None"
    if isinstance(tree, _SCALARS + (str,)):
        return repr(tree)
    if isinstance(tree, tuple):
        if hasattr(tree, "_fields"):
            return (f"{type(tree).__qualname__}("
                    + ", ".join(f"{f}={_walk(t, out, False)}"
                                for f, t in zip(tree._fields, tree)) + ")")
        return "(" + ", ".join(_walk(t, out, False) for t in tree) + ")"
    if dataclasses.is_dataclass(tree):
        return (f"{type(tree).__qualname__}(" + ", ".join(
            f"{f.name}={_walk(getattr(tree, f.name), out, False)}"
            for f in dataclasses.fields(tree)) + ")")
    if isinstance(tree, dict):
        return ("{" + ", ".join(f"{k!r}: {_walk(tree[k], out, False)}"
                                for k in sorted(tree)) + "}")
    raise TypeError(f"bundle: unsupported tree node {type(tree).__name__}")


def flatten(args) -> tuple[str, list]:
    """``(structure, leaves)`` of an argument tuple (or any tree): tensors,
    numpy arrays and the tuple's own Python numbers are the leaves."""
    out: list = []
    if isinstance(args, tuple) and not hasattr(args, "_fields"):
        s = "(" + ", ".join(_walk(a, out, True) for a in args) + ")"
    else:
        s = _walk(args, out, False)
    return s, out


def _dtype_name(x) -> str:
    if isinstance(x, (torch.Tensor, TensorSpec)):
        return str(x.dtype).removeprefix("torch.")
    if isinstance(x, ScalarSpec):
        return x.dtype
    return np.asarray(x).dtype.name


def leaf_aval(x) -> dict:
    shape = [] if isinstance(x, _SCALARS + (ScalarSpec,)) else list(x.shape)
    return {"shape": shape, "dtype": _dtype_name(x)}


def avals_of(args) -> list[dict]:
    return [leaf_aval(x) for x in flatten(args)[1]]


def abstract_signature(args) -> str:
    """Shape signature of an argument tuple: its tree structure plus every
    leaf's shape and dtype, hashed. The device is not part of it: a carry
    on the card, the same carry on the host, as host numpy or as
    ``TensorSpec``s all hash alike. The bundle keys variants on it, the
    coverage gate diffs it, and the loader refuses callers whose arguments
    hash differently."""
    structure, leaves = flatten(args)
    spec = [structure] + [
        f"{tuple(a['shape'])}:{a['dtype']}" for a in map(leaf_aval, leaves)]
    return hashlib.sha256("\n".join(spec).encode()).hexdigest()[:16]


def skeleton(args):
    """``args`` with every tensor leaf a host ``TensorSpec`` and every
    Python number of the tuple a :class:`ScalarSpec`: the picklable tree
    structure a bundle records (``unflatten`` rebuilds a tree from it)."""
    def spec(t):
        return TensorSpec(t.shape, t.dtype, "cpu")

    if isinstance(args, tuple) and not hasattr(args, "_fields"):
        return tuple(ScalarSpec(_dtype_name(a)) if isinstance(a, _SCALARS)
                     else tree_map(spec, a) for a in args)
    return tree_map(spec, args)


def unflatten(skel, leaves, device="cpu"):
    """The tree of ``skel`` (:func:`skeleton`) with ``leaves`` in order:
    numpy arrays become tensors of the recorded dtype on ``device``,
    Python numbers stay Python numbers."""
    it = iter(leaves)

    def fill(spec):
        leaf = next(it)
        if isinstance(spec, ScalarSpec):
            return leaf
        return torch.from_numpy(np.array(leaf, copy=True)).to(
            device=device, dtype=spec.dtype)

    if isinstance(skel, tuple) and not hasattr(skel, "_fields"):
        return tuple(fill(s) if isinstance(s, ScalarSpec)
                     else tree_map(fill, s) for s in skel)
    return tree_map(fill, skel)


def host_leaves(args) -> list:
    """The leaves of ``args`` as host numpy (bfloat16 widened to float32;
    the recorded dtype narrows it back), Python numbers as they are."""
    out = []
    for leaf in flatten(args)[1]:
        if isinstance(leaf, torch.Tensor):
            t = leaf.detach().to("cpu")
            if t.dtype == torch.bfloat16:
                t = t.float()
            out.append(t.numpy().copy())
        else:
            out.append(leaf)
    return out


# ----------------------------------------------------------------------
# Registry iteration (shared by build and the coverage gate).
# ----------------------------------------------------------------------

def _probe_build(device):
    """The bundled probe program (see :data:`PROBE_ENTRY`)."""
    from tpu_aerial_transport_torch import resolve_device
    from tpu_aerial_transport_torch.parallel import ring

    def fn(x, r):
        y = (x @ x).to(torch.bfloat16)
        return y.to(torch.float32).sum(), ring.ring_sum_shards(r)

    def make_args():
        dev = resolve_device(device)
        r = np.random.default_rng(0).normal(size=(2, 128))
        return (torch.ones((128, 128), dtype=torch.float32, device=dev),
                torch.as_tensor(r, dtype=torch.float32, device=dev))

    return fn, make_args


def default_device() -> str:
    return "cuda" if torch.cuda.is_available() else "cpu"


def entry_specs(names=None, device: str | None = None) -> dict:
    """``{name: spec}`` over the registry (and :data:`PROBE_ENTRY`), where a
    buildable spec is ``{"sig", "build"}`` and a skipped one ``{"skip":
    reason}``: an entry that needs a CUDA device on a host without one, or
    a process group (``analysis.contracts.Contract.skip_reason``).
    Computing a signature only needs ``make_args()``, on ``device``
    (default: the card when one is visible)."""
    from tpu_aerial_transport_torch.analysis import contracts

    device = default_device() if device is None else device
    out: dict = {}
    selected = (sorted(contracts.REGISTRY) + [PROBE_ENTRY]
                if names is None else list(names))
    for name in selected:
        if name == PROBE_ENTRY:
            fn, make_args = _probe_build(device)
        else:
            contract = contracts.REGISTRY.get(name)
            if contract is None:
                raise KeyError(f"{name!r} is not in the entry-point registry")
            reason = contract.skip_reason(device)
            if reason:
                out[name] = {"skip": reason}
                continue
            fn, make_args = contract.build(device)
        out[name] = {"sig": abstract_signature(make_args()),
                     "build": (fn, make_args)}
    return out


def bucketed_batch(args, batch_axis: int, batch: int):
    """Re-batch ``args`` along ``batch_axis`` to the bucket grid:
    ``bucket_dim(batch, BATCH_BUCKET_TILE)`` lanes, tiled cyclically from
    the originals (shape bucketing: the values only seed the variant).
    Python numbers and tensors with no batch axis (the chunk offset) are
    left alone."""
    from tpu_aerial_transport_torch.harness.bucketing import bucket_dim

    b = bucket_dim(batch, BATCH_BUCKET_TILE)

    def retile(x):
        if x.dim() <= batch_axis:
            return x
        cur = x.shape[batch_axis]
        reps = [1] * x.dim()
        reps[batch_axis] = -(-b // cur)
        return x.repeat(*reps).narrow(batch_axis, 0, b).contiguous()

    if isinstance(args, tuple) and not hasattr(args, "_fields"):
        return tuple(a if isinstance(a, _SCALARS) else tree_map(retile, a)
                     for a in args), b
    return tree_map(retile, args), b


# ----------------------------------------------------------------------
# Build.
# ----------------------------------------------------------------------

def _write_object(out_dir: str, payload: bytes) -> dict:
    digest = hashlib.sha256(payload).hexdigest()
    objdir = os.path.join(out_dir, OBJECTS_DIR)
    os.makedirs(objdir, exist_ok=True)
    path = os.path.join(objdir, digest[:32] + ".bin")
    if not os.path.exists(path):
        tmp = path + f".tmp.{os.getpid()}"
        with open(tmp, "wb") as fh:
            fh.write(payload)
            fh.flush()
            os.fsync(fh.fileno())
        os.replace(tmp, path)
    return {"object": os.path.basename(path), "sha256": digest}


def _sync(device: str) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def library_launches() -> dict:
    """Kernel launches so far by library of ``ops._build.KERNELS``, summed
    from the kernels' own launch counters."""
    from tpu_aerial_transport_torch.ops import admm_kernel
    from tpu_aerial_transport_torch.parallel import ring

    return {"fused_solve": sum(admm_kernel.KERNEL_LAUNCHES.values()),
            "admm_chunk": sum(admm_kernel.CHUNK_LAUNCHES.values()),
            "ring_sum": ring.LAUNCHES["ring_sum"]}


def _build_variant(fn, args, device: str, out_dir: str,
                   meta: dict | None = None) -> dict:
    """One entry x signature: run ``fn`` once on ``args`` (on the build
    device) to record its outputs and the kernel libraries it launched.
    The sample and the signature are taken before the run."""
    sig = abstract_signature(args)
    in_avals = avals_of(args)
    in_skel = skeleton(args)
    sample = host_leaves(args)
    before = library_launches()
    out = fn(*args)
    _sync(device)
    launched = sorted(n for n, c in library_launches().items()
                      if c > before[n])
    return {
        "sig": sig,
        "in_avals": in_avals,
        "out_avals": avals_of(out),
        "in_treedef": _write_object(out_dir, pickle.dumps(in_skel)),
        "out_treedef": _write_object(out_dir, pickle.dumps(skeleton(out))),
        "args_sample": _write_object(out_dir, pickle.dumps(sample)),
        "kernels": launched,
        **(meta or {}),
    }


def _kernel_objects(out_dir: str) -> dict:
    """Every library of ``_build.KERNELS`` (built here first if missing),
    written as an object with the source digest its file name carries."""
    from tpu_aerial_transport_torch.ops import _build

    _build.build()
    out = {}
    for name in _build.KERNELS:
        digest = _build.source_digest(name)
        with open(_build.library_path(name, digest), "rb") as fh:
            payload = fh.read()
        out[name] = {**_write_object(out_dir, payload), "digest": digest}
    return out


def build_bundle(out_dir: str, *, names=None, manifest_only: bool = False,
                 batch_buckets=(), device: str | None = None,
                 progress=None) -> dict:
    """Build (or re-build) a bundle under ``out_dir`` on ``device``
    (default: the card when one is visible) and return the manifest.
    ``manifest_only`` records coverage (names, signatures, skip reasons)
    without running anything. ``batch_buckets`` adds bucketed variants for
    :data:`BUCKETED_ENTRIES`. On the card the bundle carries every kernel
    library (built first if missing). The manifest is published
    atomically (temporary file, fsync, ``os.replace``)."""
    device = default_device() if device is None else device
    platform = torch.device(device).type
    if names is not None and PROBE_ENTRY not in names:
        names = list(names) + [PROBE_ENTRY]  # every bundle has the probe.
    specs = entry_specs(names, device)
    manifest: dict = {
        "schema": SCHEMA_VERSION,
        "platform": platform,
        "fingerprint": runtime_fingerprint(platform),
        "nvcc": None,
        "manifest_only": bool(manifest_only),
        "kernels": {},
        "entries": {},
        "skipped": {},
    }
    if platform == "cuda" and not manifest_only:
        manifest["kernels"] = _kernel_objects(out_dir)
        manifest["nvcc"] = nvcc_version()
    for name, spec in specs.items():
        if "skip" in spec:
            manifest["skipped"][name] = spec["skip"]
            continue
        fn, make_args = spec["build"]
        if manifest_only:
            manifest["entries"][name] = {"variants": [{"sig": spec["sig"]}]}
            continue
        if progress:
            progress(name)
        args = make_args()
        variants = [_build_variant(fn, args, device, out_dir)]
        axis = BUCKETED_ENTRIES.get(name)
        if axis is not None:
            for b in batch_buckets:
                bargs, bb = bucketed_batch(args, axis, int(b))
                variants.append(_build_variant(
                    fn, bargs, device, out_dir,
                    meta={"batch": bb, "batch_axis": axis}))
        manifest["entries"][name] = {"variants": variants}
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, MANIFEST_NAME)
    tmp = path + f".tmp.{os.getpid()}"
    with open(tmp, "w") as fh:
        json.dump(manifest, fh, indent=1, sort_keys=True)
        fh.flush()
        os.fsync(fh.fileno())
    os.replace(tmp, path)
    return manifest


# ----------------------------------------------------------------------
# Coverage diff (the drift gate's core).
# ----------------------------------------------------------------------

def coverage_diff(manifest: dict, names=None,
                  device: str | None = None) -> dict:
    """Diff a bundle manifest against the LIVE registry. Returns
    ``{"missing", "stale", "changed", "uncovered_skips", "ok"}``:

    - ``missing``: registry entries the bundle does not carry;
    - ``stale``: bundle entries no longer in the registry;
    - ``changed``: entries whose live default signature is not among the
      bundle's variants (argument shapes or structure drifted);
    - ``uncovered_skips``: entries the bundle skipped that build on this
      host (the skip reason no longer holds).

    Entries this host cannot build (no card, no process group) are not
    findings when the bundle carries them."""
    specs = entry_specs(names, device)
    built = manifest.get("entries", {})
    skipped = manifest.get("skipped", {})
    diff = {"missing": [], "stale": [], "changed": [], "uncovered_skips": []}
    for name, spec in specs.items():
        if "skip" in spec:
            continue
        if name in built:
            have = {v.get("sig") for v in built[name].get("variants", [])}
            if spec["sig"] not in have:
                diff["changed"].append(
                    f"{name}: live sig {spec['sig']} not in built "
                    f"{sorted(have)}")
        elif name in skipped:
            diff["uncovered_skips"].append(
                f"{name}: bundle skipped it ({skipped[name][:80]}) but it "
                "builds on this host")
        else:
            diff["missing"].append(name)
    live = set(specs)
    for name in sorted(set(built) | set(skipped)):
        if name not in live:
            diff["stale"].append(name)
    diff["ok"] = not any(diff[k] for k in
                         ("missing", "stale", "changed", "uncovered_skips"))
    return diff


def read_manifest(bundle_dir: str) -> dict:
    path = os.path.join(bundle_dir, MANIFEST_NAME)
    try:
        with open(path, encoding="utf-8") as fh:
            manifest = json.load(fh)
    except Exception as e:
        raise BundleError(
            "unreadable", path, f"{type(e).__name__}: {e}") from e
    if manifest.get("schema", -1) > SCHEMA_VERSION:
        raise BundleError(
            "schema", path,
            f"written by schema {manifest.get('schema')} > supported "
            f"{SCHEMA_VERSION}")
    return manifest
