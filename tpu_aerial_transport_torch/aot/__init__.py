"""AOT bundles: the kernels' build moved out of the serving process.

``bundle`` builds versioned, content-addressed bundles from the entry-point
registry (``analysis.contracts``): the kernel libraries of ``csrc/``, pinned
to a runtime fingerprint, and one variant per entry x shape signature with
its template arguments. ``loader`` installs the libraries and serves calls
through a journaled ladder (``bundle_exec`` -> ``eager_cached`` ->
``eager_cold``). Counterpart of the JAX package's ``aot/``.
"""

from tpu_aerial_transport_torch.aot.bundle import (  # noqa: F401
    PROBE_ENTRY,
    SCHEMA_VERSION,
    BundleError,
    abstract_signature,
    build_bundle,
    entry_specs,
    runtime_fingerprint,
)
from tpu_aerial_transport_torch.aot.loader import (  # noqa: F401
    RUNG_EAGER_CACHED,
    RUNG_EAGER_COLD,
    RUNG_EXEC,
    Bundle,
    load_bundle,
    serve_entry,
)
