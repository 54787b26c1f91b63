"""Minimal pytrees over nested dicts / lists / tuples, in JAX's leaf order.

``jax.tree_util`` flattens dict keys in SORTED order, while
``torch.utils._pytree`` and ``nn.Module`` keep insertion order. The flat
wire layout (``FlatLayout`` offsets, bucket boundaries, checkpoint leaf
order) depends on that order, so the port flattens its parameter dicts
here, the JAX way: dict children by sorted key, list/tuple children in
order, ``None`` as an empty node, anything else a leaf.

A treedef is a hashable nested tuple, so it can key caches like JAX's.
"""
from __future__ import annotations

from typing import Any, Callable

_LEAF = ("*",)


def tree_flatten(tree) -> tuple[list, Any]:
    """-> (leaves, treedef)."""
    leaves: list = []

    def walk(node):
        if isinstance(node, dict):
            keys = tuple(sorted(node))
            return ("dict", keys, tuple(walk(node[k]) for k in keys))
        if isinstance(node, (list, tuple)):
            kind = "list" if isinstance(node, list) else "tuple"
            return (kind, len(node), tuple(walk(c) for c in node))
        if node is None:
            return ("none",)
        leaves.append(node)
        return _LEAF

    treedef = walk(tree)
    return leaves, treedef


def tree_leaves(tree) -> list:
    return tree_flatten(tree)[0]


def tree_unflatten(treedef, leaves) -> Any:
    it = iter(leaves)

    def build(td):
        if td == _LEAF:
            return next(it)
        kind = td[0]
        if kind == "dict":
            return {k: build(c) for k, c in zip(td[1], td[2])}
        if kind == "list":
            return [build(c) for c in td[2]]
        if kind == "tuple":
            return tuple(build(c) for c in td[2])
        return None

    out = build(treedef)
    if next(it, None) is not None:
        raise ValueError("more leaves than the treedef holds")
    return out


def tree_map(fn: Callable, tree, *rest) -> Any:
    """Apply ``fn`` leafwise over trees of one structure."""
    leaves, treedef = tree_flatten(tree)
    others = [tree_leaves(r) for r in rest]
    return tree_unflatten(treedef,
                          [fn(*xs) for xs in zip(leaves, *others)])
