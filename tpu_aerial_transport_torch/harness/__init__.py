"""Set-up factories, the batched rollouts with their chunk tier, and the
checkpoint tier.

The chunk tier's and the checkpoint tier's names are exported here and
resolved on first use: ``ops.socp`` imports ``harness.bucketing``, so an
eager import of ``harness.rollout`` (which imports the controllers, and
they ``ops.socp``) would be circular."""

import importlib

_EXPORTS = {
    **{name: "rollout" for name in (
        "chunk_index_offset", "chunked_rollout", "concat_chunk_logs",
        "make_chunk_driver", "make_chunked_rollout", "rqp_logs_spec",
        "validate_chunking")},
    **{name: "checkpoint" for name in (
        "SnapshotError", "config_fingerprint", "list_snapshots",
        "load_latest_valid", "load_run", "load_snapshot", "read_manifest",
        "save_run", "save_snapshot", "snapshot_path", "tree_fingerprint")},
}


def __getattr__(name):
    if name in _EXPORTS:
        module = importlib.import_module(f"{__name__}.{_EXPORTS[name]}")
        return getattr(module, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
