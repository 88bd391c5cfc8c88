"""Maps over the port's state containers: a tensor, ``None``, or a
dataclass, ``NamedTuple``, tuple or dict of them (the counterpart of
``jax.tree.map`` over the JAX package's pytrees; a dict's entries in the
order of its sorted keys, as ``jax.tree`` walks them). Python numbers and
strings inside a dataclass (a forest's bark size, a grid's shape) are
static fields, carried unchanged as the JAX package's static fields are.
A :class:`TensorSpec` is a leaf as a tensor is: a tree of them describes a
tree of tensors without holding one (the counterpart of
``jax.ShapeDtypeStruct``)."""

from __future__ import annotations

import dataclasses
import torch


class TensorSpec:
    """A tensor's shape, dtype and device, with no storage: a leaf that
    stands in for a tensor in a template tree (``harness.checkpoint``
    verifies snapshots against such templates and restores onto
    ``device``)."""

    __slots__ = ("shape", "dtype", "device")

    def __init__(self, shape, dtype: torch.dtype, device="cpu"):
        self.shape = torch.Size(shape)
        self.dtype = dtype
        self.device = torch.device(device)

    def __repr__(self) -> str:
        return (f"TensorSpec({tuple(self.shape)}, {self.dtype}, "
                f"{self.device})")


LEAF_TYPES = (torch.Tensor, TensorSpec)


def tree_map(fn, tree, *rest):
    """``fn`` applied leaf by leaf to ``tree`` and the trees in ``rest``
    (same structure); ``None`` leaves stay ``None``."""
    if isinstance(tree, LEAF_TYPES):
        return fn(tree, *rest)
    if tree is None:
        return None
    if isinstance(tree, (bool, int, float, str)):
        return tree
    if isinstance(tree, tuple):
        parts = [tree_map(fn, *xs) for xs in zip(tree, *rest)]
        return type(tree)(*parts) if hasattr(tree, "_fields") else tuple(
            parts)
    if dataclasses.is_dataclass(tree):
        return type(tree)(**{
            f.name: tree_map(fn, getattr(tree, f.name),
                             *(getattr(r, f.name) for r in rest))
            for f in dataclasses.fields(tree)})
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    raise TypeError(f"tree_map: unsupported node {type(tree).__name__}")


def leaves(tree) -> list[torch.Tensor]:
    """The tensors (and :class:`TensorSpec` leaves) of ``tree`` in
    :func:`tree_map`'s order."""
    out = []
    tree_map(out.append, tree)
    return out


def tree_structure(tree) -> str:
    """The structure of ``tree`` as a string, leaves left out: each
    container's type (qualified name) and field names, the positions of
    ``None``, and the static values (Python numbers and strings) -- the
    counterpart of ``str(jax.tree.structure(tree))``. Two trees that
    :func:`tree_map` can walk together have the same string."""
    if isinstance(tree, LEAF_TYPES):
        return "*"
    if tree is None:
        return "None"
    if isinstance(tree, (bool, int, float, str)):
        return repr(tree)
    if isinstance(tree, tuple):
        if hasattr(tree, "_fields"):
            return (f"{type(tree).__qualname__}("
                    + ", ".join(f"{f}={tree_structure(t)}" for f, t in
                                zip(tree._fields, tree)) + ")")
        return "(" + ", ".join(tree_structure(t) for t in tree) + ")"
    if dataclasses.is_dataclass(tree):
        return (f"{type(tree).__qualname__}("
                + ", ".join(f"{f.name}={tree_structure(getattr(tree, f.name))}"
                            for f in dataclasses.fields(tree)) + ")")
    if isinstance(tree, dict):
        return ("{" + ", ".join(f"{k!r}: {tree_structure(tree[k])}"
                                for k in sorted(tree)) + "}")
    raise TypeError(f"tree_structure: unsupported node {type(tree).__name__}")
