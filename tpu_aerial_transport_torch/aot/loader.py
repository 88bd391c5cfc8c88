"""Serve side of the AOT bundles: load a bundle, install its kernel
libraries, and serve entry point calls through a journaled ladder.

Counterpart of the JAX package's ``aot/loader.py``. The ladder, per serve
(:func:`serve_entry`)::

    bundle_exec    the variant matches (signature, tree structure) and its
                   bundle's kernel libraries (every one it carries,
                   installed once a process, before the first call) are
                   in place: no ``nvcc`` runs. Refused with
                   ``bundle_stale`` when the fingerprint or a library's
                   source digest differs from this process, and with
                   ``exec_unavailable`` when a card bundle lacks a library
                   of ``ops._build.KERNELS``. A call that launches no
                   kernel (every call on the CPU) needs no library and
                   lands here too.
    eager_cached   the caller's callable, in a process that ran no
                   ``nvcc`` (the libraries were in the build directory).
    eager_cold     the caller's callable, in a process that ran ``nvcc``.

A coverage miss (``missing_entry``, ``signature_mismatch``,
``treedef_mismatch``, ``bundle_stale``, ``exec_unavailable``) falls through
to the caller's callable; an integrity failure (:data:`INTEGRITY_KINDS`)
re-raises even then. So does ``output_mismatch``, raised after the call
ran when its outputs differ from the variant's: the program drifted from
its bundle, and running it again eagerly would serve the same drift at
twice the cost. Every serve emits one ``aot_serve`` event (``entry``,
``rung``, ``label``, ``wall_s``, and ``tried``/``error`` when set).

The Python that runs is the live tree's (the port runs eagerly): a bundle
pins kernels, shapes and template inputs, not the program. CUDA graph
captures are not bundled, so a bundled replica still captures its substeps
at each batch shape's first chunk.
"""

from __future__ import annotations

import hashlib
import os
import pickle
import time

import torch

from tpu_aerial_transport_torch.aot.bundle import (
    ENFORCED_KEYS,
    MANIFEST_NAME,
    OBJECTS_DIR,
    PROBE_ENTRY,
    BundleError,
    ScalarSpec,
    abstract_signature,
    flatten,
    leaf_aval,
    read_manifest,
    runtime_fingerprint,
    unflatten,
)
from tpu_aerial_transport_torch.tree import leaves

RUNG_EXEC = "bundle_exec"
RUNG_EAGER_CACHED = "eager_cached"
RUNG_EAGER_COLD = "eager_cold"

# BundleError kinds that re-raise from serve_entry even when a fallback is
# available (coverage gaps degrade, integrity failures page an operator):
# the bundle itself is damaged, or (output_mismatch) the call ran and its
# outputs drifted from the bundle's record.
INTEGRITY_KINDS = frozenset({"corrupt", "unreadable", "schema",
                             "output_mismatch"})


def _device_type(args) -> str:
    """The device type of the first tensor of ``args`` ("cpu" without)."""
    for leaf in flatten(args)[1]:
        if isinstance(leaf, torch.Tensor):
            return leaf.device.type
    return "cpu"


class Bundle:
    """A loaded bundle directory. Objects are read lazily and verified
    against their manifest sha256 when first read (``corrupt`` refusal);
    tree structures, samples, libraries and the registry's callables are
    memoized, so a serving replica pays each once a process."""

    def __init__(self, directory: str, manifest: dict):
        self.directory = directory
        self.manifest = manifest
        self.platform = manifest.get("platform")
        self._objects: dict = {}    # object name -> unpickled payload
        self._structures: dict = {}  # object name -> structure string
        self._installed: dict = {}  # library name -> install status
        self._fns: dict = {}        # (entry, device type) -> callable
        self._checked: set = set()  # device types whose runtime matched
        self.install_s = 0.0         # seconds spent installing libraries

    @property
    def _manifest_path(self) -> str:
        return os.path.join(self.directory, MANIFEST_NAME)

    # -------------------------------------------------- object access --
    def _read_object(self, ref: dict) -> bytes:
        path = os.path.join(self.directory, OBJECTS_DIR, ref["object"])
        try:
            with open(path, "rb") as fh:
                payload = fh.read()
        except OSError as e:
            raise BundleError(
                "unreadable", path, f"{type(e).__name__}: {e}") from e
        digest = hashlib.sha256(payload).hexdigest()
        if digest != ref["sha256"]:
            raise BundleError(
                "corrupt", path,
                f"payload digest {digest[:12]} != manifest "
                f"{ref['sha256'][:12]}")
        return payload

    def _unpickled(self, ref: dict):
        key = ref["object"]
        if key not in self._objects:
            self._objects[key] = pickle.loads(self._read_object(ref))
        return self._objects[key]

    def _structure(self, ref: dict) -> str:
        key = ref["object"]
        if key not in self._structures:
            self._structures[key] = flatten(self._unpickled(ref))[0]
        return self._structures[key]

    # ------------------------------------------------ variant lookup ---
    def entry_names(self) -> list[str]:
        return sorted(self.manifest.get("entries", {}))

    def variants(self, name: str) -> list[dict]:
        entry = self.manifest.get("entries", {}).get(name)
        if entry is None:
            skipped = self.manifest.get("skipped", {}).get(name)
            detail = (f"entry skipped at build time: {skipped}"
                      if skipped else "entry not in bundle")
            raise BundleError("missing_entry", self._manifest_path,
                              f"{name}: {detail}")
        variants = entry.get("variants", [])
        if not variants or "in_treedef" not in variants[0]:
            raise BundleError(
                "missing_entry", self._manifest_path,
                f"{name}: manifest-only bundle carries no variants "
                "(coverage record; build without --manifest-only to serve)")
        return variants

    def variant_for(self, name: str, args) -> dict:
        """The variant whose signature matches ``args`` exactly. A
        structural mismatch refuses with ``treedef_mismatch``; a pure shape
        or dtype mismatch with ``signature_mismatch``."""
        sig = abstract_signature(args)
        variants = self.variants(name)
        for v in variants:
            if v["sig"] == sig:
                return v
        if flatten(args)[0] != self._structure(variants[0]["in_treedef"]):
            raise BundleError(
                "treedef_mismatch", self.directory,
                f"{name}: caller argument tree structure differs from the "
                "built one (controller or carry schema drifted since the "
                "bundle was built)")
        raise BundleError(
            "signature_mismatch", self.directory,
            f"{name}: caller shapes hash {sig}, built "
            f"{sorted(v['sig'] for v in variants)}: no variant for this "
            "shape bucket")

    def variant_for_batch(self, name: str, batch: int) -> dict:
        """Smallest bucketed variant admitting ``batch`` lanes; the largest
        when the request exceeds every bucket. Selection is
        ``harness.bucketing.pick_bucket``, the rule the serving batcher
        shares."""
        from tpu_aerial_transport_torch.harness.bucketing import pick_bucket

        vs = [v for v in self.variants(name) if "batch" in v]
        if not vs:
            raise BundleError(
                "missing_entry", self.directory,
                f"{name}: no bucketed variants (build with --batch-buckets)")
        vs.sort(key=lambda v: v["batch"])
        picked = pick_bucket(batch, [v["batch"] for v in vs])
        if picked is None:
            return vs[-1]
        return next(v for v in vs if v["batch"] == picked)

    def batch_buckets(self, name: str, batch_axis: int = 0) -> list[int]:
        """Sorted batch sizes this bundle carries for ``name`` (the serving
        tier's admission coverage). The default variant counts too: its
        batch is its first input's size along ``batch_axis``."""
        out = set()
        for v in self.variants(name):
            if "batch" in v:
                out.add(int(v["batch"]))
                continue
            avals = v.get("in_avals") or []
            if avals and len(avals[0]["shape"]) > batch_axis:
                out.add(int(avals[0]["shape"][batch_axis]))
        return sorted(out)

    def sample_args(self, name: str, *, batch: int | None = None,
                    device="cpu"):
        """The concrete arguments a variant was built from (the build-time
        ``make_args()`` values, stored as host numpy), as tensors on
        ``device``: a serving replica's template carry, with no state
        factory run."""
        variant = (self.variant_for_batch(name, batch)
                   if batch is not None else self.variants(name)[0])
        ref = variant.get("args_sample")
        if ref is None:
            raise BundleError(
                "missing_entry", self.directory,
                f"{name}: variant carries no args_sample")
        return unflatten(self._unpickled(variant["in_treedef"]),
                         self._unpickled(ref), device=device)

    def probe_args(self, name: str = PROBE_ENTRY, device="cpu"):
        """Unit-valued arguments from a variant's recorded shapes and
        dtypes (Python numbers kept as recorded zeros): inputs without the
        registry or the sample."""
        import numpy as np

        skel = self._unpickled(self.variants(name)[0]["in_treedef"])
        ones = [0 if isinstance(s, ScalarSpec)
                else np.ones(tuple(s.shape), np.float32)
                for s in flatten(skel)[1]]
        return unflatten(skel, ones, device=device)

    # ------------------------------------------------------ libraries --
    def check_runtime(self, device_type: str, name: str = "") -> None:
        """``exec_unavailable`` for a call on another platform than the
        bundle's; ``bundle_stale`` (with the rebuild hint) where an
        enforced fingerprint key differs from this process's. Then every
        library the bundle carries is installed (:meth:`install_kernels`),
        so that no call served from the bundle can reach ``nvcc``; a card
        bundle that lacks a library of ``ops._build.KERNELS`` is
        ``exec_unavailable``."""
        if device_type in self._checked:
            return
        if device_type != self.platform:
            raise BundleError(
                "exec_unavailable", self.directory,
                f"{name or 'bundle'}: built for {self.platform}, the "
                f"call runs on {device_type}")
        fp = self.manifest.get("fingerprint", {})
        here = runtime_fingerprint(self.platform)
        drift = {k: (fp.get(k), here.get(k)) for k in ENFORCED_KEYS
                 if fp.get(k) != here.get(k)}
        if drift:
            raise BundleError(
                "bundle_stale", self.directory,
                f"{name or 'bundle'}: the fingerprint differs from this "
                f"runtime: {drift}")
        from tpu_aerial_transport_torch.ops import _build

        carried = self.manifest.get("kernels", {})
        missing = [k for k in _build.KERNELS if k not in carried]
        if device_type == "cuda" and missing:
            raise BundleError(
                "exec_unavailable", self._manifest_path,
                f"the bundle carries no {', '.join(missing)} library")
        self.install_kernels()
        self._checked.add(device_type)

    def install_kernels(self) -> dict:
        """Install every library the bundle carries where the kernel loader
        looks (``ops._build.install``), sha-verified, before anything
        loads them; returns ``{name: status}``. A library whose source
        digest differs from the live ``csrc/`` (or from the one this
        process loaded) is ``bundle_stale``, never loaded."""
        from tpu_aerial_transport_torch.ops import _build

        t0 = time.perf_counter()
        for lib, ref in sorted(self.manifest.get("kernels", {}).items()):
            if lib in self._installed:
                continue
            try:
                status = _build.install(lib, self._read_object(ref),
                                        ref["digest"])
            except _build.StaleLibrary as e:
                raise BundleError("bundle_stale", self.directory,
                                  str(e)) from e
            self._installed[lib] = status
        self.install_s += time.perf_counter() - t0
        return dict(self._installed)

    # ------------------------------------------------------ calling ----
    def _entry_fn(self, name: str, device_type: str):
        """The registry's callable of ``name`` on ``device_type``."""
        key = (name, device_type)
        if key not in self._fns:
            if name == PROBE_ENTRY:
                from tpu_aerial_transport_torch.aot.bundle import _probe_build

                fn, _ = _probe_build(device_type)
            else:
                from tpu_aerial_transport_torch.analysis import contracts

                fn, _ = contracts.REGISTRY[name].build(device_type)
            self._fns[key] = fn
        return self._fns[key]

    def call(self, name: str, args, fn=None):
        """Run ``name`` on ``args`` (the entry's calling convention) from
        the bundle: the variant found by signature, the runtime checked
        against the fingerprint and the bundle's libraries installed, then
        ``fn`` (default: the registry's callable) called, and its outputs
        checked against the recorded tree structure and shapes
        (``output_mismatch``, an integrity kind: the call ran). Returns
        ``(out, RUNG_EXEC)``."""
        variant = self.variant_for(name, args)
        dev = _device_type(args)
        self.check_runtime(dev, name)
        fn = self._entry_fn(name, dev) if fn is None else fn
        out = fn(*args)
        structure, got = flatten(out)
        want = variant["out_avals"]
        if (structure != self._structure(variant["out_treedef"])
                or [leaf_aval(x) for x in got] != want):
            raise BundleError(
                "output_mismatch", self.directory,
                f"{name}: the outputs' structure or shapes differ from the "
                "built variant's (the program drifted since the bundle was "
                "built; rebuild it)")
        return out, RUNG_EXEC


def load_bundle(directory: str) -> Bundle:
    """Open a bundle directory (manifest schema-checked; objects verified
    lazily per read)."""
    return Bundle(directory, read_manifest(directory))


def call_probe(bundle: Bundle, device="cuda") -> float:
    """Run the bundled probe (the matmul and bf16 round trip, and the ring
    sum) on ``device`` from the bundle, on its recorded sample inputs: the
    bundle rung pinned, so a stale or absent library raises instead of
    being built. Returns the checksum; raises when the ring sum is not
    ``x.sum(0)`` in every row."""
    from tpu_aerial_transport_torch import resolve_device

    dev = resolve_device(device)
    args = bundle.sample_args(PROBE_ENTRY, device=dev)
    (s, ring), _ = bundle.call(PROBE_ENTRY, args)
    r = args[1]
    if not torch.equal(ring, r.sum(0, keepdim=True).expand_as(ring)):
        raise RuntimeError("the bundled probe's ring sum differs from "
                           "x.sum(0)")
    return float(s)


# ----------------------------------------------------------------------
# The serve ladder.
# ----------------------------------------------------------------------

def _fallback_rung() -> str:
    from tpu_aerial_transport_torch.ops import _build

    return RUNG_EAGER_COLD if _build.nvcc_builds() else RUNG_EAGER_CACHED


def serve_entry(bundle: Bundle | None, name: str, args, *, fn=None,
                jit_fallback=None, metrics=None, journal=None,
                label: str | None = None, block: bool = True, hub=None):
    """Serve one entry point call through the ladder and journal what this
    process paid. Returns ``(out, rung)``.

    ``fn`` is the callable the bundle rung runs (default ``jit_fallback``,
    else the registry's). ``jit_fallback`` (the name keeps the JAX
    ladder's keyword; the port calls it eagerly) serves a bundle coverage
    miss, or every call when ``bundle`` is None; the rung is then
    ``eager_cold`` if this process ran ``nvcc`` and ``eager_cached`` if not.
    Without a fallback a miss raises. An integrity failure
    (:data:`INTEGRITY_KINDS`) re-raises after journaling even with one.

    ``block`` waits for the card (a synchronise when an output lives
    there); ``block=False`` is the pipelined path: the call returns once
    its work is enqueued, ``wall_s`` measures the dispatch only, and an
    execution error surfaces at the caller's next wait. The ``aot_serve``
    row goes to ``metrics`` (an ``obs.export.MetricsWriter``), ``journal``
    (a ``RunJournal``) and ``hub`` (an ``obs.live.MetricsHub``), each
    optional."""
    label = label or name
    t0 = time.perf_counter()
    tried: list[str] = []

    def finish(out):
        if block and any(t.is_cuda for t in leaves(out)):
            torch.cuda.synchronize()

    def emit(rung: str, error: str | None = None) -> None:
        event = {
            "entry": name, "rung": rung, "label": label,
            "wall_s": time.perf_counter() - t0,
            **({"tried": tried} if tried else {}),
            **({"error": error} if error else {}),
        }
        if journal is not None:
            journal.append({"event": "aot_serve", **event})
        if metrics is not None:
            metrics.emit("aot_serve", **event)
        if hub is not None:
            hub.ingest_aot(event)

    if bundle is not None:
        try:
            out, rung = bundle.call(
                name, args, fn=fn if fn is not None else jit_fallback)
            finish(out)
            emit(rung)
            return out, rung
        except BundleError as e:
            tried.append(f"bundle[{e.kind}]")
            if jit_fallback is None or e.kind in INTEGRITY_KINDS:
                emit("error", error=str(e)[:300])
                raise
    if jit_fallback is None:
        raise BundleError(
            "missing_entry", getattr(bundle, "directory", "<no bundle>"),
            f"{name}: no bundle and no fallback callable")
    out = jit_fallback(*args)
    finish(out)
    rung = _fallback_rung()
    emit(rung)
    return out, rung
