"""The serve ladder of the port (``loader.serve_entry``).

Counterpart of the JAX package's ``aot/`` with only its serve ladder: the
AOT bundles themselves (build, load, the precompiled rungs) are not ported
yet (ROADMAP, Queue 1, the ``aot/`` item), so the port's ladder has one
rung, the eager program.
"""

from tpu_aerial_transport_torch.aot.loader import (  # noqa: F401
    RUNG_EAGER,
    serve_entry,
)
