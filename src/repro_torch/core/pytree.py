"""Minimal pytrees over nested dicts / lists / tuples, in JAX's leaf order.

``jax.tree_util`` flattens dict keys in SORTED order, while
``torch.utils._pytree`` and ``nn.Module`` keep insertion order. The flat
wire layout (``FlatLayout`` offsets, bucket boundaries, checkpoint leaf
order) depends on that order, so the port flattens its parameter dicts
here, the JAX way: dict children by sorted key, list/tuple children in
order, ``None`` as an empty node, anything else a leaf.

A treedef is a hashable nested tuple, so it can key caches like JAX's.
``tree_flatten_with_path`` / ``tree_map_with_path`` give each leaf its
key path — a tuple of dict keys and sequence indices, in the same order
and with the same names as ``jax.tree_util``'s key paths.
"""
from __future__ import annotations

from typing import Any, Callable

_LEAF = ("*",)


def _flatten(node, leaves: list):
    if isinstance(node, dict):
        keys = tuple(sorted(node))
        return ("dict", keys, tuple(_flatten(node[k], leaves) for k in keys))
    if isinstance(node, (list, tuple)):
        kind = "list" if isinstance(node, list) else "tuple"
        return (kind, len(node), tuple(_flatten(c, leaves) for c in node))
    if node is None:
        return ("none",)
    leaves.append(node)
    return _LEAF


def tree_flatten(tree) -> tuple[list, Any]:
    """-> (leaves, treedef). The walk is a module-level function: a
    self-referencing closure over ``leaves`` would be a reference cycle
    that keeps every leaf alive until the cycle collector runs."""
    leaves: list = []
    treedef = _flatten(tree, leaves)
    return leaves, treedef


def tree_leaves(tree) -> list:
    return tree_flatten(tree)[0]


def _build(td, it):
    if td == _LEAF:
        return next(it)
    kind = td[0]
    if kind == "dict":
        return {k: _build(c, it) for k, c in zip(td[1], td[2])}
    if kind == "list":
        return [_build(c, it) for c in td[2]]
    if kind == "tuple":
        return tuple(_build(c, it) for c in td[2])
    return None


def tree_unflatten(treedef, leaves) -> Any:
    it = iter(leaves)
    out = _build(treedef, it)
    if next(it, None) is not None:
        raise ValueError("more leaves than the treedef holds")
    return out


def tree_map(fn: Callable, tree, *rest) -> Any:
    """Apply ``fn`` leafwise over trees of one structure."""
    leaves, treedef = tree_flatten(tree)
    others = [tree_leaves(r) for r in rest]
    return tree_unflatten(treedef,
                          [fn(*xs) for xs in zip(leaves, *others)])


def _paths(td, path: tuple, out: list) -> None:
    if td == _LEAF:
        out.append(path)
    elif td[0] == "dict":
        for k, c in zip(td[1], td[2]):
            _paths(c, path + (k,), out)
    elif td[0] in ("list", "tuple"):
        for i, c in enumerate(td[2]):
            _paths(c, path + (i,), out)


def tree_flatten_with_path(tree) -> tuple[list, Any]:
    """-> ([(path, leaf), ...], treedef), leaves in ``tree_flatten``'s
    order; a path is a tuple of dict keys and list/tuple indices."""
    leaves, treedef = tree_flatten(tree)
    paths: list = []
    _paths(treedef, (), paths)
    return list(zip(paths, leaves)), treedef


def tree_map_with_path(fn: Callable, tree) -> Any:
    """``fn(path, leaf)`` leafwise, the result in ``tree``'s structure."""
    pairs, treedef = tree_flatten_with_path(tree)
    return tree_unflatten(treedef, [fn(p, leaf) for p, leaf in pairs])
