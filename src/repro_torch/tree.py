"""Params trees: nested dicts, lists, tuples and NamedTuples whose leaves
are tensors, host arrays or scalars — the port's counterpart of the JAX
package's pytrees for the params a compiled graph takes and a training
state (``(params, AdamWState)``).  Dicts are walked in sorted key order,
as JAX flattens them, so trees of one structure line up whatever order
their keys were inserted in."""

from __future__ import annotations

from typing import Callable

__all__ = ["tree_map", "tree_leaves", "tree_structure"]


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree``, keeping its structure.  With
    ``rest`` trees of the same structure, ``fn`` takes the matching leaf
    of each (``jax.tree_util.tree_map(fn, tree, *rest)``)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        children = [tree_map(fn, *vs) for vs in zip(tree, *rest)]
        if hasattr(tree, "_fields"):             # a NamedTuple
            return type(tree)(*children)
        return type(tree)(children)
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    """The leaves of ``tree`` in :func:`tree_map` order."""
    out: list = []
    tree_map(out.append, tree)
    return out


def tree_structure(tree):
    """A hashable description of ``tree``'s containers (their types,
    dict keys and lengths), every leaf ``"*"``: two trees whose
    structures compare equal line up leaf for leaf; a NamedTuple is told
    apart from a plain tuple by its type's name."""
    if isinstance(tree, dict):
        return ("dict", tuple((k, tree_structure(tree[k]))
                              for k in sorted(tree)))
    if isinstance(tree, (list, tuple)):
        return (type(tree).__name__,
                tuple(tree_structure(v) for v in tree))
    return "*"
