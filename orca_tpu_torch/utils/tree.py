"""Nested dict/list parameter trees with tensor leaves (the port's
counterpart of jax.tree): dicts keep their keys (ints for decoder levels),
lists their order."""

from __future__ import annotations

from typing import Callable, List


def tree_map(fn: Callable, tree, *rest):
    """Apply `fn` leaf-wise over trees of one structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v, *(r[i] for r in rest))
                for i, v in enumerate(tree)]
    return fn(tree, *rest)


def tree_leaves(tree) -> List:
    """The leaves in tree_map's order."""
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in tree_leaves(v)]
    return [tree]


def tree_unflatten(tree, leaves: List):
    """A tree of `tree`'s structure holding `leaves` in tree_leaves order."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), tree)
