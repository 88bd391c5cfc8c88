"""Content-addressed serving result cache: a scenario request is a PURE
function of ``(family program, x0, v0, horizon)`` -- the served chunk is
deterministic by the chunked-rollout contract and the family's config
hash pins every solver and shape knob -- so a completed result can be
served again without touching the card.

The port's own copy of the JAX package's ``serving/cache.py``: the same
keys (sha256 over the family's ``config_hash``, the horizon and the
canonical little-endian float64 bytes of ``x0``/``v0``; tenant, deadline
and request identity deliberately left out -- they change SLO
accounting, not the computed trajectory), LRU bound and hit/miss counts.
Values are deep copies of the result trees (CPU tensors) plus the served
step count. Host-only and lock-free by design: it lives inside the
server's single-threaded pump loop, as the batcher's bookkeeping does.
"""

from __future__ import annotations

import collections
import hashlib

import numpy as np

from tpu_aerial_transport_torch.tree import tree_map


def request_key(config_hash: str, request) -> str:
    """The content address of one request's result (see module doc)."""
    h = hashlib.sha256()
    h.update(config_hash.encode())
    h.update(str(int(request.horizon)).encode())
    for vec in (request.x0, request.v0):
        h.update(np.asarray(vec, np.float64).astype("<f8").tobytes())
    return h.hexdigest()


def _copy_tree(tree):
    return tree_map(lambda t: t.detach().clone(), tree)


class ResultCache:
    """LRU-bounded completed-result cache. ``get`` returns
    ``(result, steps_served)`` copies (callers own their ticket results
    and may mutate them) or ``None``; ``put`` stores COMPLETED results
    only -- the caller enforces that, because a deadline-missed ticket's
    result is legitimate data but its status is an SLO verdict that must
    not be replayed onto a fresh request."""

    def __init__(self, max_entries: int = 256):
        if max_entries < 1:
            raise ValueError("ResultCache needs max_entries >= 1")
        self.max_entries = int(max_entries)
        self._entries: collections.OrderedDict = collections.OrderedDict()
        self.hits = 0
        self.misses = 0

    def __len__(self) -> int:
        return len(self._entries)

    def get(self, key: str):
        entry = self._entries.get(key)
        if entry is None:
            self.misses += 1
            return None
        self._entries.move_to_end(key)
        self.hits += 1
        result, steps = entry
        return _copy_tree(result), steps

    def put(self, key: str, result, steps_served: int) -> None:
        if result is None:
            return
        self._entries[key] = (_copy_tree(result), int(steps_served))
        self._entries.move_to_end(key)
        while len(self._entries) > self.max_entries:
            self._entries.popitem(last=False)

    def stats(self) -> dict:
        lookups = self.hits + self.misses
        return {
            "entries": len(self._entries),
            "max_entries": self.max_entries,
            "hits": self.hits,
            "misses": self.misses,
            "hit_rate": (self.hits / lookups) if lookups else None,
        }
