"""Params trees: nested dicts, lists and tuples whose leaves are tensors
or host arrays — the port's counterpart of the JAX package's pytrees for
the params a compiled graph takes.  Dicts are walked in sorted key
order, as JAX flattens them, so trees of one structure line up whatever
order their keys were inserted in."""

from __future__ import annotations

from typing import Callable

__all__ = ["tree_map", "tree_leaves"]


def tree_map(fn: Callable, tree):
    """``fn`` over the leaves of ``tree``, keeping its structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k]) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def tree_leaves(tree) -> list:
    """The leaves of ``tree`` in :func:`tree_map` order."""
    out: list = []
    tree_map(out.append, tree)
    return out
