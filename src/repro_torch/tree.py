"""Nested dicts as trees: the parameter, gradient, optimizer-state and
cache trees of the LM scaffold (the reference's jax.tree over dicts)."""
from __future__ import annotations


def tree_leaves(tree, is_leaf=lambda x: not isinstance(x, dict)):
    """(path, leaf) pairs of a nested dict, keys in sorted order (the
    order in which JAX flattens a dict)."""
    if is_leaf(tree):
        yield (), tree
        return
    for k in sorted(tree):
        for path, leaf in tree_leaves(tree[k], is_leaf):
            yield (k,) + path, leaf


def tree_map(fn, tree, *rest):
    """fn over the leaves of nested dicts of one layout (fn(leaf, *the
    leaves of `rest` at its path)), keeping the layout."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def tree_from_leaves(items) -> dict:
    """The nested dict of (path, leaf) pairs (an iterable of pairs or a
    {path: leaf} dict): the inverse of tree_leaves."""
    out: dict = {}
    for path, leaf in (items.items() if isinstance(items, dict) else items):
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = leaf
    return out
