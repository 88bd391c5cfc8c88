"""Checkpoint / resume for rollouts and solver state.

Counterpart of the JAX package's ``harness/checkpoint.py``, with its three
tiers and its container format:

- :func:`save_run` / :func:`load_run` -- the reference example's artifact:
  the ``rollout.logs_to_dict`` dict as npz, tree positions included;
- :func:`save_state` / :func:`load_state` -- loose persistence of a tree of
  tensors (a carry, a controller state) as npz, with no integrity
  metadata (the JAX package's npz backend; the port has no orbax);
- :func:`save_snapshot` / :func:`load_snapshot` / :func:`load_latest_valid`
  -- the crash-recovery tier (``resilience.recovery`` drives it): atomic
  snapshots with a schema version, a structure fingerprint, per-leaf
  payload digests and a caller's config hash. A write goes to a temp file
  that is fsync'd and then ``os.replace``'d under its name, retention is
  keep-last-K, and a load classifies truncation, corruption, structure
  drift and config mismatch into a :class:`SnapshotError` instead of
  returning garbage; :func:`load_latest_valid` falls back to the newest
  snapshot that passes every check.

Snapshot container: one uncompressed ``.ckpt`` file in npz layout --
``__manifest__`` (UTF-8 JSON as a uint8 array, schema 1) and ``leaf_NNNNNN``
arrays in :func:`tpu_aerial_transport_torch.tree.leaves` order. Leaves are
stored at their dtype and restored with it onto each template leaf's
device, so a resume is bit-exact; nothing is pickled (``allow_pickle=False``
on read). The manifest is the JAX package's (its ``read_manifest`` reads a
port snapshot), but the structure fingerprint is the port's own
(:func:`tree_fingerprint`), so a JAX snapshot does not load here.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import re

import numpy as np
import torch

from tpu_aerial_transport_torch.tree import (  # noqa: F401 (TensorSpec)
    TensorSpec,
    leaves,
    tree_map,
    tree_structure,
)

SCHEMA_VERSION = 1

_MANIFEST_KEY = "__manifest__"
# The prefix grammar is shared by snapshot_path (write side) and
# list_snapshots (read side): a prefix the filename pattern cannot parse
# back would publish snapshots that retention and recovery never see.
_PREFIX_RE = re.compile(r"^[A-Za-z0-9_.]+$")
_SNAP_RE = re.compile(r"^(?P<prefix>[A-Za-z0-9_.]+)-(?P<step>\d{8})\.ckpt$")


def _host_array(t, what: str = "leaf") -> np.ndarray:
    """A leaf as a numpy array on the host. ``bfloat16`` has no numpy
    dtype, so such a leaf is refused rather than widened (a widened leaf
    would not restore to the bits it was)."""
    if isinstance(t, torch.Tensor):
        if t.dtype == torch.bfloat16:
            raise ValueError(
                f"{what} is bfloat16, which has no numpy dtype: convert it "
                "before snapshotting")
        return t.detach().cpu().numpy()
    return np.asarray(t)


def _dtype_str(leaf) -> str:
    """A leaf's dtype as numpy writes it (``<f4``, ``|b1``, ...)."""
    dt = leaf.dtype
    if isinstance(dt, torch.dtype):
        if dt == torch.bfloat16:
            return "bfloat16"
        dt = torch.empty((), dtype=dt).numpy().dtype
    return np.dtype(dt).str


def save_run(path: str, log_dict: dict) -> None:
    """Persist a rollout log dict (from ``rollout.logs_to_dict``) as npz."""
    flat = {}
    for k, v in log_dict.items():
        if isinstance(v, dict):
            for k2, v2 in v.items():
                flat[f"{k}.{k2}"] = _host_array(v2, k2)
        else:
            flat[k] = _host_array(v, k)
    np.savez_compressed(path, **flat)


def load_run(path: str) -> dict:
    """Inverse of :func:`save_run`; nested keys are restored. 0-d arrays
    come back as numpy scalars of the saved dtype (``v[()]``)."""
    raw = np.load(path, allow_pickle=False)
    out: dict = {}
    for k in raw.files:
        v = raw[k]
        if v.ndim == 0:
            v = v[()]
        if "." in k:
            outer, inner = k.split(".", 1)
            out.setdefault(outer, {})[inner] = v
        else:
            out[k] = v
    return out


def save_state(path: str, state) -> None:
    """Checkpoint a tree of tensors as npz (the JAX package's npz
    backend: one ``leaf_N`` array a leaf, ``.npz`` appended to ``path``
    when missing)."""
    path = os.path.abspath(path)
    if not path.endswith(".npz"):
        path += ".npz"
    np.savez(path, **{f"leaf_{i}": _host_array(l, f"leaf {i}")
                      for i, l in enumerate(leaves(state))})


def load_state(path: str, template):
    """Restore a :func:`save_state` checkpoint into ``template``'s
    structure, each leaf at the template leaf's dtype and device (pass the
    same tree you saved, e.g. a freshly initialised state)."""
    path = os.path.abspath(path)
    if not path.endswith(".npz"):
        path += ".npz"
    with np.load(path, allow_pickle=False) as raw:
        arrs = iter([raw[f"leaf_{i}"] for i in range(len(raw.files))])
    return tree_map(
        lambda t: torch.from_numpy(next(arrs)).to(t.device, t.dtype),
        template)


# ----------------------------------------------------------------------
# Crash-recovery snapshot tier.
# ----------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class SnapshotError(Exception):
    """Structured load failure -- the record ``resilience.recovery``
    journals when it skips a snapshot.

    kind: ``unreadable`` (truncated/not-a-zip/missing manifest),
    ``corrupt`` (a leaf's payload digest mismatches its manifest entry),
    ``schema`` (written by a newer format), ``structure_mismatch`` (the
    structure fingerprint differs from the template's),
    ``config_mismatch`` (the run's config hash changed: resuming would mix
    configurations), ``no_valid_snapshot`` (every candidate failed;
    ``errors`` holds the per-file reasons).
    """

    kind: str
    path: str
    detail: str = ""
    errors: tuple = ()

    def __str__(self) -> str:
        msg = f"[{self.kind}] {self.path}: {self.detail}"
        if self.errors:
            msg += "".join(f"\n  - {e}" for e in self.errors)
        return msg


def tree_fingerprint(tree) -> str:
    """Fingerprint of a tree's structure: :func:`tree_structure` (container
    types, field names, ``None`` positions, static values) and each leaf's
    shape and dtype, hashed. A tree of tensors and its template of
    :class:`TensorSpec` leaves fingerprint the same, so a resume can verify
    a snapshot without running a chunk."""
    spec = [tree_structure(tree)] + [
        f"{tuple(l.shape)}:{_dtype_str(l)}" for l in leaves(tree)]
    return hashlib.sha256("\n".join(spec).encode()).hexdigest()[:32]


def config_fingerprint(**named) -> str:
    """Hash of named configuration objects (params, controller config,
    fault schedule, arguments...): any drift between save and resume flips
    it, and :func:`load_snapshot` refuses the mix.

    Array leaves (tensors and numpy arrays) are hashed from their full
    bytes with their shape and dtype, not their repr: a repr elides the
    interior of an array of over 1000 elements, so two different
    big-fleet tables would hash the same. Other values (Python numbers,
    strings, devices) hash by their repr."""

    def _digest(v) -> str:
        parts: list[str] = []

        def walk(x):
            if isinstance(x, (torch.Tensor, np.ndarray)):
                a = np.ascontiguousarray(_host_array(x))
                parts.append(f"ndarray:{a.dtype}:{a.shape}:"
                             + hashlib.sha256(a.tobytes()).hexdigest())
            elif isinstance(x, (tuple, list)):
                parts.append(f"{type(x).__qualname__}[{len(x)}]")
                for y in x:
                    walk(y)
            elif isinstance(x, dict):
                parts.append(f"dict[{len(x)}]")
                for k in sorted(x, key=repr):
                    parts.append(repr(k))
                    walk(x[k])
            elif dataclasses.is_dataclass(x) and not isinstance(x, type):
                parts.append(type(x).__qualname__)
                for f in dataclasses.fields(x):
                    parts.append(f.name)
                    walk(getattr(x, f.name))
            else:
                parts.append(repr(x))

        walk(v)
        return "\x00".join(parts)

    blob = json.dumps({k: _digest(v) for k, v in sorted(named.items())})
    return hashlib.sha256(blob.encode()).hexdigest()[:32]


def snapshot_path(directory: str, step: int, prefix: str = "snap") -> str:
    if not _PREFIX_RE.match(prefix):
        raise ValueError(
            f"snapshot prefix {prefix!r} must match {_PREFIX_RE.pattern} "
            "(list_snapshots could not parse the filename back, making the "
            "snapshot invisible to retention and recovery)"
        )
    return os.path.join(directory, f"{prefix}-{step:08d}.ckpt")


def list_snapshots(directory: str, prefix: str = "snap") -> list[tuple[int, str]]:
    """``(step, path)`` pairs for every published snapshot, step-ascending.
    In-flight temp files (``*.tmp.*``) are invisible by construction."""
    if not os.path.isdir(directory):
        return []
    out = []
    for name in os.listdir(directory):
        m = _SNAP_RE.match(name)
        if m and m.group("prefix") == prefix:
            out.append((int(m.group("step")), os.path.join(directory, name)))
    return sorted(out)


def save_snapshot(
    directory: str,
    step: int,
    state,
    *,
    prefix: str = "snap",
    config_hash: str | None = None,
    meta: dict | None = None,
    keep_last: int = 3,
) -> str:
    """Atomically publish snapshot ``step`` of ``state`` (a tree of
    tensors on any device, or of numpy arrays) under ``directory`` and
    prune to the newest ``keep_last`` (0 disables pruning). The file
    appears under its name only after a complete, fsync'd write (temp file
    + ``os.replace``), so a crash at any byte leaves either the previous
    snapshot set or the new one. Returns the published path."""
    os.makedirs(directory, exist_ok=True)
    arrays = [_host_array(l, f"leaf {i}")
              for i, l in enumerate(leaves(state))]
    manifest = {
        "schema": SCHEMA_VERSION,
        "step": int(step),
        "treedef": tree_fingerprint(state),
        "config_hash": config_hash,
        "leaves": [
            {
                "shape": list(a.shape),
                "dtype": a.dtype.str,
                "sha256": hashlib.sha256(
                    np.ascontiguousarray(a).tobytes()).hexdigest(),
            }
            for a in arrays
        ],
        "meta": meta or {},
    }
    arrs = {f"leaf_{i:06d}": a for i, a in enumerate(arrays)}
    arrs[_MANIFEST_KEY] = np.frombuffer(json.dumps(manifest).encode(),
                                        np.uint8)
    path = snapshot_path(directory, step, prefix)
    tmp = path + f".tmp.{os.getpid()}"
    with open(tmp, "wb") as fh:
        # Uncompressed: the payload is mostly incompressible float32 state,
        # and the digests protect its integrity.
        np.savez(fh, **arrs)
        fh.flush()
        os.fsync(fh.fileno())
    os.replace(tmp, path)
    if keep_last > 0:
        for _, old in list_snapshots(directory, prefix)[:-keep_last]:
            os.remove(old)
    return path


def _parse_manifest(raw, path: str) -> dict:
    """Manifest from an open npz handle (schema-checked); raises
    :class:`SnapshotError` (kind ``unreadable``/``schema``)."""
    if _MANIFEST_KEY not in raw.files:
        raise SnapshotError("unreadable", path, "manifest missing")
    manifest = json.loads(bytes(raw[_MANIFEST_KEY]).decode())
    if manifest.get("schema", -1) > SCHEMA_VERSION:
        raise SnapshotError(
            "schema", path,
            f"written by schema {manifest.get('schema')} > supported "
            f"{SCHEMA_VERSION}",
        )
    return manifest


def read_manifest(path: str) -> dict:
    """Manifest of a snapshot file, or raise :class:`SnapshotError`
    (kind ``unreadable``/``schema``)."""
    try:
        with np.load(path, allow_pickle=False) as raw:
            return _parse_manifest(raw, path)
    except SnapshotError:
        raise
    except Exception as e:  # truncated zip, bad CRC, bad JSON, missing file
        raise SnapshotError(
            "unreadable", path, f"{type(e).__name__}: {e}"
        ) from e


def load_snapshot(
    path: str,
    template,
    *,
    config_hash: str | None = None,
):
    """Verify and restore one snapshot into ``template``'s structure.

    Every check runs before any data is trusted: container readability and
    schema, the config hash (when both sides have one), the structure
    fingerprint against ``template`` (tensors or :class:`TensorSpec`
    leaves), then each leaf's payload digest. A failure raises a
    :class:`SnapshotError`; success returns ``(state, manifest)`` with every
    leaf at its saved dtype on the device of the matching template leaf
    (bit-exact, whatever the template's values). The file is opened once,
    and the manifest checks run before any leaf payload is read."""
    try:
        with np.load(path, allow_pickle=False) as raw:
            manifest = _parse_manifest(raw, path)
            if (config_hash is not None
                    and manifest.get("config_hash") is not None
                    and manifest["config_hash"] != config_hash):
                raise SnapshotError(
                    "config_mismatch", path,
                    f"snapshot config {manifest['config_hash']} != current "
                    f"{config_hash}: resuming would mix configurations",
                )
            if manifest.get("treedef") != tree_fingerprint(template):
                raise SnapshotError(
                    "structure_mismatch", path,
                    "snapshot structure differs from the template "
                    "(the carry's schema drifted since the run was started)",
                )
            arrays = [raw[f"leaf_{i:06d}"]
                      for i in range(len(manifest["leaves"]))]
    except SnapshotError:
        raise
    except Exception as e:
        raise SnapshotError(
            "unreadable", path, f"{type(e).__name__}: {e}"
        ) from e
    for i, (a, spec) in enumerate(zip(arrays, manifest["leaves"])):
        digest = hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()
        if digest != spec["sha256"]:
            raise SnapshotError(
                "corrupt", path,
                f"leaf {i} payload digest mismatch (stored "
                f"{spec['sha256'][:12]}, read {digest[:12]})",
            )
    it = iter(arrays)
    state = tree_map(lambda t: torch.from_numpy(next(it)).to(t.device),
                     template)
    return state, manifest


# ----------------------------------------------------------------------
# Multi-process shard snapshots: per-process shard files + one global
# manifest.
# ----------------------------------------------------------------------

def shard_prefix(prefix: str, process_id: int, n_processes: int) -> str:
    """Snapshot prefix for one process's shard of a sharded carry --
    ``carry.p0of2`` -- inside the normal prefix grammar, so retention,
    :func:`list_snapshots` and recovery see shard snapshots like any
    other. Each process writes only its own prefix; the shard manifest
    ties the set together."""
    if not 0 <= process_id < n_processes:
        raise ValueError(f"process_id {process_id} not in [0, {n_processes})")
    return f"{prefix}.p{process_id}of{n_processes}"


def shard_manifest_path(directory: str, prefix: str = "snap") -> str:
    return os.path.join(directory, f"{prefix}.shards.json")


def save_shard_manifest(
    directory: str,
    *,
    prefix: str = "snap",
    n_processes: int,
    topology: dict | None = None,
    config_hash: str | None = None,
) -> str:
    """Atomically publish the global manifest of a sharded snapshot
    family: how many per-process shard prefixes make a complete boundary,
    the topology the carry was sharded under and the run's config hash.
    Written once a run by process 0; a resume validates against it
    (:func:`load_shard_manifest`) before trusting any shard."""
    path = shard_manifest_path(directory, prefix)
    os.makedirs(directory, exist_ok=True)
    payload = {
        "schema": SCHEMA_VERSION,
        "prefix": prefix,
        "n_processes": int(n_processes),
        "shard_prefixes": [
            shard_prefix(prefix, p, n_processes) for p in range(n_processes)
        ],
        "topology": topology or {},
        "config_hash": config_hash,
    }
    tmp = path + f".tmp.{os.getpid()}"
    with open(tmp, "w") as fh:
        json.dump(payload, fh, indent=1)
        fh.flush()
        os.fsync(fh.fileno())
    os.replace(tmp, path)
    return path


def load_shard_manifest(
    directory: str,
    *,
    prefix: str = "snap",
    n_processes: int | None = None,
    config_hash: str | None = None,
) -> dict:
    """Read and validate the shard manifest. Raises :class:`SnapshotError`:
    ``unreadable`` when missing or corrupt, ``schema`` for a newer writer,
    ``config_mismatch`` when the process count or the config hash
    disagrees with what the shards were written under (re-placing
    2-process shards on 4 processes would load half a carry each)."""
    path = shard_manifest_path(directory, prefix)
    try:
        with open(path) as fh:
            manifest = json.load(fh)
    except Exception as e:
        raise SnapshotError(
            "unreadable", path, f"{type(e).__name__}: {e}"
        ) from e
    if manifest.get("schema", -1) > SCHEMA_VERSION:
        raise SnapshotError(
            "schema", path,
            f"written by schema {manifest.get('schema')} > supported "
            f"{SCHEMA_VERSION}",
        )
    if (n_processes is not None
            and manifest.get("n_processes") != n_processes):
        raise SnapshotError(
            "config_mismatch", path,
            f"shards written by {manifest.get('n_processes')} processes, "
            f"resuming with {n_processes}: re-placing would split the "
            "carry wrong (rebuild with the journaled topology or restart "
            "fresh)",
        )
    if (config_hash is not None
            and manifest.get("config_hash") is not None
            and manifest["config_hash"] != config_hash):
        raise SnapshotError(
            "config_mismatch", path,
            f"shard manifest config {manifest['config_hash']} != current "
            f"{config_hash}: resuming would mix configurations/topologies",
        )
    return manifest


def load_latest_valid(
    directory: str,
    template,
    *,
    prefix: str = "snap",
    config_hash: str | None = None,
):
    """Newest snapshot that passes every check, walking back over older
    ones on failure (keep-last-K retention exists so there is something to
    fall back to). Returns ``(state, manifest, skipped)``, ``skipped`` the
    errors of every newer snapshot rejected; raises :class:`SnapshotError`
    (kind ``no_valid_snapshot``) when none survives."""
    skipped: list[SnapshotError] = []
    for _, path in reversed(list_snapshots(directory, prefix)):
        try:
            state, manifest = load_snapshot(path, template,
                                            config_hash=config_hash)
            return state, manifest, skipped
        except SnapshotError as e:
            skipped.append(e)
    raise SnapshotError(
        "no_valid_snapshot", directory,
        f"no loadable '{prefix}' snapshot",
        errors=tuple(str(e) for e in skipped),
    )

