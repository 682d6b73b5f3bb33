"""Trees of tensors: the nested dicts and lists that hold a model's
parameters, its gradients, its optimizer state and a training state.

Leaves are walked in the order ``jax.tree_util`` walks the reference's
trees: a dict's keys sorted, a list's or tuple's items in order.  So a
checkpoint's ``leaf_00000.npy, ...`` name the same leaves in both
packages wherever their trees have the same structure.  Anything that is
not a dict, list or tuple is a leaf.
"""

from __future__ import annotations

from typing import Any, Callable


def leaves(tree) -> list:
    """The leaves of ``tree``, in order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for item in tree for x in leaves(item)]
    return [tree]


def unflatten(like, flat) -> Any:
    """A tree of ``like``'s structure whose leaves are ``flat``, in order."""
    it = iter(flat)

    def build(node):
        if isinstance(node, dict):
            built = {k: build(node[k]) for k in sorted(node)}
            return {k: built[k] for k in node}   # the caller's key order
        if isinstance(node, (list, tuple)):
            return type(node)(build(item) for item in node)
        return next(it)

    out = build(like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree has")
    return out


def map(fn: Callable, tree, *rest) -> Any:  # noqa: A001 - jax.tree.map
    """``fn`` over the leaves of ``tree`` and of trees of its structure."""
    others = [leaves(t) for t in rest]
    flat = leaves(tree)
    if any(len(o) != len(flat) for o in others):
        raise ValueError("trees of different structure")
    return unflatten(tree, [fn(*xs) for xs in zip(flat, *others)])
