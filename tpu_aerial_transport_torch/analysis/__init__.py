"""The port's entry-point registry (``contracts.REGISTRY``), which the AOT
bundles (``aot/``) iterate. Counterpart of the JAX package's
``analysis/`` with its registry only: the trace contracts and the lint
rules are not ported."""
