"""Nested-container helpers for the training state (the port's stand-in for
``jax.tree_util`` on the trees the trainer and the checkpoints handle).

A tree is a nested ``dict``, ``NamedTuple``, ``tuple`` or ``list`` whose
leaves are tensors, numpy arrays or :class:`~repro_torch.models.layers.Spec`
shapes; ``None`` is an empty subtree, and an object with ``coeffs`` and
``metas`` (an ``InterpLibrary``) is a node with the one leaf ``coeffs``.
Leaves come in the reference's flattening order: dict keys sorted,
``NamedTuple`` fields and sequence items in order. Path names join the dict
keys, field names and indices with ``/``, as
``repro/checkpoint/checkpoint.py`` ``_leaf_paths`` names them.
"""
from __future__ import annotations

from repro_torch.models.layers import Spec


def _is_library(x) -> bool:
    return hasattr(x, "coeffs") and hasattr(x, "metas")


def _children(x):
    """(name, child) pairs of an inner node, or None for a leaf."""
    if x is None:
        return []
    if isinstance(x, Spec):
        return None
    if isinstance(x, dict):
        return [(str(k), x[k]) for k in sorted(x)]
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return [(f, getattr(x, f)) for f in x._fields]
    if isinstance(x, (tuple, list)):
        return [(str(i), v) for i, v in enumerate(x)]
    if _is_library(x):
        return [("coeffs", x.coeffs)]
    return None


def leaves_with_paths(tree, prefix: str = "") -> list[tuple[str, object]]:
    """Every leaf of ``tree`` with its path name, in flattening order."""
    kids = _children(tree)
    if kids is None:
        return [(prefix, tree)]
    out = []
    for name, child in kids:
        out += leaves_with_paths(child, f"{prefix}/{name}" if prefix
                                 else name)
    return out


def tree_leaves(tree) -> list:
    return [leaf for _, leaf in leaves_with_paths(tree)]


def unflatten_like(like, leaves):
    """``like``'s structure with its leaves replaced, in flattening order,
    by ``leaves``."""
    it = iter(leaves)

    def build(x):
        kids = _children(x)
        if kids is None:
            return next(it)
        if x is None:
            return None
        if isinstance(x, dict):
            new = {k: build(x[k]) for k in sorted(x)}
            return {k: new[k] for k in x}  # the caller's key order
        vals = [build(v) for _, v in kids]
        if isinstance(x, tuple) and hasattr(x, "_fields"):
            return type(x)(*vals)
        if isinstance(x, (tuple, list)):
            return type(x)(vals)
        return type(x)(vals[0], x.metas)  # a library: new coeffs

    out = build(like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree has places")
    return out


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` (and the matching leaves of each
    tree in ``rest``), keeping ``tree``'s structure."""
    cols = [tree_leaves(t) for t in (tree, *rest)]
    if any(len(c) != len(cols[0]) for c in cols):
        raise ValueError("trees differ in their number of leaves")
    return unflatten_like(tree, [fn(*xs) for xs in zip(*cols)])
