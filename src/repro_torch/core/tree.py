"""Nested dicts of leaves (parameters, moments, gradients, ParamDefs).

A dict is walked in sorted key order, the order ``jax.tree`` flattens a
dict in, so that leaf order (and float sums over the leaves) follows the
reference's; anything that is not a dict is a leaf.
"""
from __future__ import annotations

from typing import Any, Callable, List


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` and of the trees in ``rest``,
    which have its structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    return fn(tree, *rest)


def tree_leaves(tree) -> List[Any]:
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    return [tree]
