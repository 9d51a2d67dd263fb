"""Flatten and rebuild the port's nested param trees in JAX's leaf order.

The port keeps params, grads and optimizer moments as plain nested dicts of
tensors. Bucket plans sort leaves by size with ties broken by leaf index,
so a plan equals the reference's only if the leaves are numbered the same
way: ``jax.tree_util`` visits dict keys in sorted order (the port's dicts
are in insertion order: ``embed, layers, final_norm``), lists and tuples in
order, and treats ``None`` as an empty subtree. These two functions do the
same for the containers the port uses.

A treedef is a hashable nested tuple, so it can key a plan cache.
"""

from __future__ import annotations

from typing import Any, List, Tuple

_LEAF = ("*",)


def _flatten(tree: Any, out: List[Any]) -> tuple:
    if tree is None:
        return ("none",)
    if isinstance(tree, dict):
        keys = tuple(sorted(tree))
        return ("dict", keys, tuple(_flatten(tree[k], out) for k in keys))
    if isinstance(tree, (list, tuple)) and not hasattr(tree, "_fields"):
        kind = "list" if isinstance(tree, list) else "tuple"
        return (kind, len(tree), tuple(_flatten(v, out) for v in tree))
    out.append(tree)
    return _LEAF


def tree_flatten(tree: Any) -> Tuple[List[Any], tuple]:
    """``(leaves, treedef)`` with leaves in ``jax.tree_util`` order."""
    leaves: List[Any] = []
    treedef = _flatten(tree, leaves)
    return leaves, treedef


def tree_leaves(tree: Any) -> List[Any]:
    return tree_flatten(tree)[0]


def tree_unflatten(treedef: tuple, leaves) -> Any:
    """Inverse of :func:`tree_flatten` (dicts come back in sorted key order,
    as ``jax.tree_util.tree_unflatten`` returns them)."""
    it = iter(leaves)

    def build(td):
        if td == _LEAF:
            return next(it)
        kind = td[0]
        if kind == "none":
            return None
        if kind == "dict":
            return {k: build(c) for k, c in zip(td[1], td[2])}
        vals = [build(c) for c in td[2]]
        return vals if kind == "list" else tuple(vals)

    out = build(treedef)
    if next(it, _LEAF) is not _LEAF:
        raise ValueError("more leaves than the treedef holds")
    return out


def tree_map(fn, tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of ``tree`` (and the same leaves of ``rest``,
    which must have the same structure)."""
    leaves, treedef = tree_flatten(tree)
    others = []
    for r in rest:
        r_leaves, r_def = tree_flatten(r)
        if r_def != treedef:
            raise ValueError("trees differ in structure")
        others.append(r_leaves)
    return tree_unflatten(treedef, [fn(*xs) for xs in zip(leaves, *others)])
