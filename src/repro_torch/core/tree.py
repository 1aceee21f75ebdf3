"""Minimal parameter-tree utilities with JAX's flattening order.

The port keeps parameters as nested dicts / tuples of tensors, as the JAX
reference keeps pytrees.  Flattening follows ``jax.tree_util``: dict keys
in sorted order, tuples and lists by index, everything else a leaf.  Leaf
paths are spelled like ``jax.tree_util.keystr`` (``"['layers'][0]['attn']
['wk']"``), so wire layouts match the reference slot for slot.
"""
from __future__ import annotations

from typing import Any, Callable

__all__ = ["tree_flatten", "tree_flatten_with_path", "tree_unflatten",
           "tree_leaves", "tree_map"]

#: hashable structure of a tree: ("dict", keys, children) |
#: ("tuple", None, children) | ("list", None, children) | ("leaf",)
TreeDef = tuple

_LEAF: TreeDef = ("leaf",)


def _flatten(tree, path: str, out: list) -> TreeDef:
    if isinstance(tree, dict):
        keys = tuple(sorted(tree))
        return ("dict", keys, tuple(_flatten(tree[k], f"{path}[{k!r}]", out)
                                    for k in keys))
    if isinstance(tree, (tuple, list)):
        kind = "tuple" if isinstance(tree, tuple) else "list"
        return (kind, None, tuple(_flatten(c, f"{path}[{i}]", out)
                                  for i, c in enumerate(tree)))
    out.append((path, tree))
    return _LEAF


def tree_flatten_with_path(tree: Any) -> tuple[list[tuple[str, Any]],
                                               TreeDef]:
    """([(keystr path, leaf), ...] in JAX order, treedef)."""
    out: list = []
    treedef = _flatten(tree, "", out)
    return out, treedef


def tree_flatten(tree: Any) -> tuple[list, TreeDef]:
    pairs, treedef = tree_flatten_with_path(tree)
    return [leaf for _, leaf in pairs], treedef


def tree_leaves(tree: Any) -> list:
    return tree_flatten(tree)[0]


def tree_unflatten(treedef: TreeDef, leaves) -> Any:
    it = iter(leaves)

    def build(td):
        if td[0] == "leaf":
            return next(it)
        children = [build(c) for c in td[2]]
        if td[0] == "dict":
            return dict(zip(td[1], children))
        return tuple(children) if td[0] == "tuple" else children

    out = build(treedef)
    if next(it, _LEAF) is not _LEAF:
        raise ValueError("more leaves than the tree structure holds")
    return out


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` over corresponding leaves of trees of one structure."""
    leaves, treedef = tree_flatten(tree)
    others = []
    for r in rest:
        lr, td = tree_flatten(r)
        if td != treedef:
            raise ValueError("tree_map: tree structures differ")
        others.append(lr)
    return tree_unflatten(treedef, [fn(*xs) for xs in zip(leaves, *others)])
