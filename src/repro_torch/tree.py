"""Parameter trees as plain containers, flattened in ``jax.tree.leaves`` order.

A tree is a tensor (a leaf), a dict (children in SORTED key order, as JAX
flattens dicts), a list or tuple (children in order), or None / an empty
container (no leaves).  The order is hash identity: leaf i of worker w at
step t uses the salt ``fold(seed, t, w, i)``, so a different order changes
every direction.
"""
from __future__ import annotations

from typing import Any, Callable, List, Tuple


def tree_flatten(tree: Any) -> Tuple[List[Any], Any]:
    """``(leaves, treedef)``; ``tree_unflatten(treedef, leaves)`` inverts it."""
    if isinstance(tree, dict):
        keys = sorted(tree)
        leaves, defs = [], []
        for k in keys:
            ls, d = tree_flatten(tree[k])
            leaves += ls
            defs.append(d)
        return leaves, ("dict", keys, defs)
    if isinstance(tree, (list, tuple)):
        leaves, defs = [], []
        for x in tree:
            ls, d = tree_flatten(x)
            leaves += ls
            defs.append(d)
        return leaves, (type(tree), None, defs)
    if tree is None:
        return [], ("none", None, None)
    return [tree], ("leaf", None, None)


def tree_unflatten(treedef: Any, leaves: List[Any]) -> Any:
    it = iter(leaves)
    out = _build(treedef, it)
    rest = list(it)
    if rest:
        raise ValueError(f"{len(rest)} leaves left over when unflattening")
    return out


def _build(treedef, it):
    kind, keys, defs = treedef
    if kind == "leaf":
        return next(it)
    if kind == "none":
        return None
    if kind == "dict":
        return {k: _build(d, it) for k, d in zip(keys, defs)}
    return kind(_build(d, it) for d in defs)


def tree_leaves(tree: Any) -> List[Any]:
    return tree_flatten(tree)[0]


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    leaves, treedef = tree_flatten(tree)
    others = [tree_leaves(r) for r in rest]
    for o in others:
        if len(o) != len(leaves):
            raise ValueError(f"tree_map: {len(o)} leaves vs {len(leaves)}")
    return tree_unflatten(treedef, [fn(*xs) for xs in zip(leaves, *others)])
