"""Maps over the port's state containers: a tensor, ``None``, or a
dataclass, ``NamedTuple`` or tuple of them (the counterpart of
``jax.tree.map`` over the JAX package's pytrees)."""

from __future__ import annotations

import dataclasses

import torch


def tree_map(fn, tree, *rest):
    """``fn`` applied leaf by leaf to ``tree`` and the trees in ``rest``
    (same structure); ``None`` leaves stay ``None``."""
    if isinstance(tree, torch.Tensor):
        return fn(tree, *rest)
    if tree is None:
        return None
    if isinstance(tree, tuple):
        parts = [tree_map(fn, *xs) for xs in zip(tree, *rest)]
        return type(tree)(*parts) if hasattr(tree, "_fields") else tuple(
            parts)
    if dataclasses.is_dataclass(tree):
        return type(tree)(**{
            f.name: tree_map(fn, getattr(tree, f.name),
                             *(getattr(r, f.name) for r in rest))
            for f in dataclasses.fields(tree)})
    raise TypeError(f"tree_map: unsupported node {type(tree).__name__}")


def leaves(tree) -> list[torch.Tensor]:
    """The tensors of ``tree`` in :func:`tree_map`'s order."""
    out = []
    tree_map(out.append, tree)
    return out
