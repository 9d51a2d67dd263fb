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


def _key_str(key: Any) -> str:
    """A path entry as the reference's checkpoint writes it: a dict key or
    a NamedTuple field by name, a list or tuple index as ``[i]``."""
    return f"[{key}]" if isinstance(key, int) else str(key)


def _children(tree: Any):
    """``(key, child)`` pairs of a container in ``jax.tree_util`` order,
    or ``None`` for a leaf. NamedTuples are containers (their fields in
    order), as they are there."""
    if isinstance(tree, dict):
        return [(k, tree[k]) for k in sorted(tree)]
    if isinstance(tree, (list, tuple)):
        if hasattr(tree, "_fields"):
            return list(zip(tree._fields, tree))
        return list(enumerate(tree))
    return None


def tree_flatten_with_paths(tree: Any, is_leaf=None
                            ) -> List[Tuple[Tuple[str, ...], Any]]:
    """``(path, leaf)`` for every leaf, in ``jax.tree_util`` order, each
    path the tuple of its keys (see :func:`_key_str`); NamedTuples (a
    ``TrainState``, an optimizer state) are walked by field. ``None`` is an
    empty subtree; ``is_leaf(x)`` stops the walk at ``x``."""
    out: List[Tuple[Tuple[str, ...], Any]] = []

    def walk(t, at):
        if t is None:
            return
        kids = None if is_leaf is not None and is_leaf(t) else _children(t)
        if kids is None:
            out.append((at, t))
            return
        for k, c in kids:
            walk(c, at + (_key_str(k),))

    walk(tree, ())
    return out


def tree_map_with_paths(fn, tree: Any, is_leaf=None) -> Any:
    """``fn(path, leaf)`` over every leaf of ``tree``, rebuilt with the same
    containers (dicts in sorted key order, NamedTuples by field)."""
    def build(t, at):
        if t is None:
            return None
        kids = None if is_leaf is not None and is_leaf(t) else _children(t)
        if kids is None:
            return fn(at, t)
        vals = [build(c, at + (_key_str(k),)) for k, c in kids]
        if isinstance(t, dict):
            return dict(zip(sorted(t), vals))
        if hasattr(t, "_fields"):
            return type(t)(*vals)
        return vals if isinstance(t, list) else tuple(vals)

    return build(tree, ())
