"""Nested containers of tensors, the port's counterpart of ``jax.tree``.

A tree is a dict, list, tuple or named tuple of subtrees, ``None`` (an
empty subtree) or a leaf (anything else).  ``flatten`` gives the leaves in
``jax.tree.flatten``'s order: dict keys sorted, sequences and named tuple
fields in order.  ``unflatten`` rebuilds the containers with their own
types, so a named tuple comes back as itself.
"""
from __future__ import annotations

from typing import Any, Callable

Tree = Any


class _Leaf:
    pass


LEAF = _Leaf()


def flatten(tree: Tree):
    """(leaves, structure)."""
    if isinstance(tree, dict):
        keys = sorted(tree)
        leaves, subs = [], []
        for k in keys:
            lv, sub = flatten(tree[k])
            leaves += lv
            subs.append(sub)
        return leaves, (dict, keys, subs)
    if isinstance(tree, (list, tuple)):
        leaves, subs = [], []
        for v in tree:
            lv, sub = flatten(v)
            leaves += lv
            subs.append(sub)
        return leaves, (type(tree), None, subs)
    if tree is None:
        return [], (None, None, [])
    return [tree], LEAF


def unflatten(structure, leaves) -> Tree:
    it = iter(leaves)

    def build(node):
        if node is LEAF:
            return next(it)
        kind, keys, subs = node
        if kind is dict:
            return {k: build(sub) for k, sub in zip(keys, subs)}
        if kind is None:
            return None
        vals = [build(sub) for sub in subs]
        return kind(*vals) if hasattr(kind, "_fields") else kind(vals)

    return build(structure)


def leaves(tree: Tree) -> list:
    return flatten(tree)[0]


def tree_map(fn: Callable, tree: Tree, *rest: Tree) -> Tree:
    """``fn`` of the leaves of ``tree`` and of the same places of
    ``rest`` (trees of the same structure), in ``tree``'s containers."""
    flat, structure = flatten(tree)
    others = [flatten(r)[0] for r in rest]
    if any(len(o) != len(flat) for o in others):
        raise ValueError("trees of different structure")
    return unflatten(structure, [fn(*args) for args in zip(flat, *others)])
