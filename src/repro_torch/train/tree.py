"""The few pytree operations the training substrate needs, in JAX's order.

``tree_flatten`` visits a tree as ``jax.tree.flatten`` does: dict
entries by sorted key, lists and tuples (NamedTuples by field) in order,
``None`` as an empty node, anything else as a leaf. The order decides
which ``leaf_<i>.npy`` of a checkpoint holds which array, so a
checkpoint written by one package restores in the other.
"""
from __future__ import annotations


def _children(node):
    if isinstance(node, dict):
        return [node[k] for k in sorted(node)]
    if isinstance(node, (list, tuple)):
        return list(node)
    return None


def _rebuild(node, children):
    if isinstance(node, dict):
        return dict(zip(sorted(node), children))
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        return type(node)(*children)
    return type(node)(children)


def tree_flatten(tree, is_leaf=None) -> list:
    """The leaves of ``tree`` in JAX's order."""
    if tree is None:
        return []
    if is_leaf is not None and is_leaf(tree):
        return [tree]
    kids = _children(tree)
    if kids is None:
        return [tree]
    return [leaf for k in kids for leaf in tree_flatten(k, is_leaf)]



def tree_unflatten(like, leaves):
    """A tree shaped like ``like`` holding ``leaves`` (in JAX's order)."""
    it = iter(leaves)

    def build(node):
        if node is None:
            return None
        kids = _children(node)
        if kids is None:
            return next(it)
        return _rebuild(node, [build(k) for k in kids])

    out = build(like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree has")
    return out


def tree_map(fn, tree, *rest, is_leaf=None):
    """``fn`` over the leaves of ``tree`` and of the trees in ``rest``
    (each with ``tree``'s structure), as ``jax.tree.map``."""
    if tree is None:
        return None
    if is_leaf is not None and is_leaf(tree):
        return fn(tree, *rest)
    kids = _children(tree)
    if kids is None:
        return fn(tree, *rest)
    others = [_children(r) for r in rest]
    return _rebuild(tree, [tree_map(fn, k, *(o[i] for o in others),
                                    is_leaf=is_leaf)
                           for i, k in enumerate(kids)])
