"""Shape bucketing: counterpart of ``bucket_dim`` in
``tpu_aerial_transport/harness/bucketing.py`` (the rest is not on the ported
path)."""

from __future__ import annotations


def bucket_dim(d: int, tile: int) -> int:
    """Round a static dim up to the next ``tile`` multiple."""
    if d < 0 or tile <= 0:
        raise ValueError((d, tile))
    return ((d + tile - 1) // tile) * tile
