"""The serve ladder: one entry point call served and journaled.

Counterpart of ``serve_entry`` in the JAX package's ``aot/loader.py`` (the
same ``(out, rung)`` return and the same ``aot_serve`` event fields). The
JAX ladder descends from a bundle's precompiled executable to a cached or
cold jit; the port has no bundles yet (ROADMAP, Queue 1, the ``aot/``
item) and one rung: the eager program (``"eager"``), on whatever device
its inputs live. Where it ran is the backend guard's rung
(``resilience.backend``), which the serving tier records beside this
one.
"""

from __future__ import annotations

import time

import torch

from tpu_aerial_transport_torch.tree import leaves

RUNG_EAGER = "eager"


def serve_entry(bundle, name: str, args, *, jit_fallback=None,
                metrics=None, label: str | None = None, block: bool = True,
                hub=None):
    """Serve one entry point call and journal what this process paid.
    Returns ``(out, rung)``.

    ``bundle`` must be None (the AOT bundles are not ported: anything else
    raises ``NotImplementedError``). ``jit_fallback`` is the callable
    served, with ``args`` (the name keeps the JAX ladder's keyword; the
    port calls it eagerly). ``block`` waits for the card (a synchronise
    when any output lives there); ``block=False`` is the pipelined path:
    the call returns once its work is enqueued, ``wall_s`` measures the
    dispatch only, and an execution error surfaces at the caller's next
    wait. The ``aot_serve`` row (``entry``, ``rung``, ``label``,
    ``wall_s``) goes to ``metrics`` (an ``obs.export.MetricsWriter``) and
    ``hub`` (an ``obs.live.MetricsHub``), each optional."""
    if bundle is not None:
        raise NotImplementedError(
            "serve_entry(bundle=): the AOT bundles are not ported yet "
            "(ROADMAP Queue 1, the aot/ item); pass bundle=None to serve "
            "eagerly")
    if jit_fallback is None:
        raise ValueError(f"serve_entry({name!r}): nothing to serve (no "
                         "bundle and no callable)")
    label = label or name
    t0 = time.perf_counter()
    out = jit_fallback(*args)
    if block and any(t.is_cuda for t in leaves(out)):
        torch.cuda.synchronize()
    event = {"entry": name, "rung": RUNG_EAGER, "label": label,
             "wall_s": time.perf_counter() - t0}
    if metrics is not None:
        metrics.emit("aot_serve", **event)
    if hub is not None:
        hub.ingest_aot(event)
    return out, RUNG_EAGER
