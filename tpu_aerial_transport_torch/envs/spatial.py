"""Environment-query mode resolution.

Counterpart of the resolution half of ``tpu_aerial_transport/envs/spatial.py``.
Only the dense sweep is ported: the spatial-hash ``"bucketed"`` tier raises
(ROADMAP Queue 1 item 5). The paper-class forest (``MAX_TREES = 200`` slots)
resolves to dense under ``"auto"``.
"""

from __future__ import annotations

ENV_QUERY_IMPLS = ("dense", "bucketed")
ENV_QUERY_MODES = ("auto",) + ENV_QUERY_IMPLS

DENSE_AUTO_MAX_TREES = 200


def _bucketed_missing():
    return NotImplementedError(
        "env_query='bucketed' (the spatial-hash query tier) is not ported "
        "yet (ROADMAP Queue 1 item 5); use 'dense' or 'auto' on a world of "
        f"at most {DENSE_AUTO_MAX_TREES} tree slots"
    )


def resolve_env_query(env_query: str | None = "auto") -> str:
    """Config-build-time resolution: ``"auto"`` stays ``"auto"`` (the world's
    slot count decides at query time), explicit values are validated."""
    if env_query is None:
        env_query = "auto"
    if env_query not in ENV_QUERY_MODES:
        raise ValueError(
            f"env_query={env_query!r}: expected one of {ENV_QUERY_MODES}"
        )
    if env_query == "bucketed":
        raise _bucketed_missing()
    return env_query


def runtime_env_query(env_query: str, forest) -> str:
    """The implementation a query runs against ``forest``: dense at
    ``<= DENSE_AUTO_MAX_TREES`` slots under ``"auto"``."""
    if env_query not in ENV_QUERY_MODES:
        raise ValueError(
            f"env_query={env_query!r}: expected one of {ENV_QUERY_MODES}"
        )
    if env_query == "auto":
        max_trees = forest.tree_pos.shape[0]
        env_query = "bucketed" if max_trees > DENSE_AUTO_MAX_TREES else "dense"
    if env_query == "bucketed":
        raise _bucketed_missing()
    return env_query
