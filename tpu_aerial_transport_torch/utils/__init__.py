"""Small numeric and geometry helpers.

The JAX package's ``utils/compat.py`` and ``utils/platform.py`` have no
port files: no port module needs their names, and each has a counterpart
elsewhere (``analysis/entrypoints.py NO_COUNTERPART``, the ``FILES`` and
``NAMES`` rows):

- ``shard_map``: the explicit shard axis of ``parallel/mesh.py``;
- ``pytree_io``: ``harness/checkpoint.py`` ``save_state`` / ``load_state``;
- ``honor_jax_platforms_env``: ``resolve_device`` (the package
  ``__init__``), which never falls back from the card;
- the XLA cache names (``XLA_CACHE_ENV``, ``default_cache_dir``,
  ``enable_persistent_cache``): ``ops/_build.py``'s build directory
  (``TAT_TORCH_BUILD_DIR``) and the AOT bundles;
- the virtual-device names (``VIRTUAL_DEVICES_ENV``,
  ``virtual_device_count``, ``apply_virtual_devices``): the shard axis on
  one card, and the pods ranks run as threads in the tier-1 tests.
"""
