"""The port's static analysis and contracts, the counterpart of the JAX
package's ``analysis/``, in three tiers:

- **Tier A** (torchlint; :mod:`rules`, :mod:`linter`, :mod:`entrypoints`):
  pure-AST rules TL001-TL007 and TL011 over the hot path (host syncs,
  numpy, float64, tensor branches, host copies in loops and CUDA-graph
  captures, asserts and prints of tensors).
- **Tier C** (hostlint; :mod:`hostrules`, :mod:`hostflow`, :mod:`knobs`):
  pure-AST rules HL001-HL010 over the host tier and the knob registry.
- **Tier B** (:mod:`contracts`): the entry-point registry (which the AOT
  bundles, ``aot/``, also iterate) and the contracts TC101, TC102, TC103
  and TC105 run over it on a device.

Tiers A and C import neither torch nor jax; ``tools/lint.py`` loads them
by file path. Tier B imports torch. The float64 oracle the tests hold the
solves against is ``native/``.
"""
