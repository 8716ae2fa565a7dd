"""Trees of tensors: nested dicts and lists, the port's pytrees.

Dicts are walked in sorted key order, as ``jax.tree`` walks them, so two
trees with the same keys give their leaves in the same order whatever
order their dicts were built in.
"""
from __future__ import annotations

from typing import Callable, List


def leaves(tree) -> List:
    """Every leaf, depth first."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in leaves(t)]
    return [tree]


def unflatten(like, flat):
    """A tree shaped like ``like`` whose leaves are ``flat``, in order."""
    it = iter(flat)

    def build(node):
        if isinstance(node, dict):
            out = {k: build(node[k]) for k in sorted(node)}
            return {k: out[k] for k in node}   # keep the caller's key order
        if isinstance(node, (list, tuple)):
            items = [build(t) for t in node]
            if hasattr(node, "_fields"):   # a NamedTuple (ScanState)
                return type(node)(*items)
            return type(node)(items)
        return next(it)

    out = build(like)
    if next(it, None) is not None:
        raise ValueError("unflatten: more leaves than the tree holds")
    return out


def map(fn: Callable, tree, *rest):   # noqa: A001 - jax.tree.map's name
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest`` (trees of the same structure)."""
    cols = [leaves(t) for t in (tree, *rest)]
    if any(len(c) != len(cols[0]) for c in cols):
        raise ValueError("tree.map: trees differ in their number of leaves")
    return unflatten(tree, [fn(*xs) for xs in zip(*cols)])
