"""Nested dicts of tensors as the reference's pytrees: leaves in JAX's
order (dict keys sorted, lists and tuples by index) and their paths."""
from __future__ import annotations

__all__ = ["leaves", "tree_map", "flatten_with_paths", "map_with_paths", "unflatten"]


def _children(tree):
    if isinstance(tree, dict):
        return [(k, tree[k]) for k in sorted(tree)]
    if isinstance(tree, (list, tuple)):
        return list(enumerate(tree))
    return None


def flatten_with_paths(tree, prefix: tuple = ()) -> list:
    """[(path, leaf)] in JAX's leaf order; a path is the tuple of keys."""
    kids = _children(tree)
    if kids is None:
        return [(prefix, tree)]
    return [item for k, v in kids for item in flatten_with_paths(v, prefix + (k,))]


def leaves(tree) -> list:
    return [leaf for _, leaf in flatten_with_paths(tree)]


def tree_map(fn, tree, *rest):
    """``jax.tree.map``: ``fn`` on the leaves of ``tree`` and the matching
    leaves of ``rest``, rebuilt in ``tree``'s structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree))
    return fn(tree, *rest)


def map_with_paths(fn, tree, prefix: tuple = ()):
    """``fn(path, leaf)`` on every leaf, rebuilt in ``tree``'s structure."""
    if isinstance(tree, dict):
        return {k: map_with_paths(fn, v, prefix + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_with_paths(fn, v, prefix + (i,)) for i, v in enumerate(tree))
    return fn(prefix, tree)


def unflatten(template, flat: list):
    """``template``'s structure holding ``flat`` (leaves in ``leaves``'s order)."""
    it = iter(flat)

    def build(tree):
        kids = _children(tree)
        if kids is None:
            return next(it)
        if isinstance(tree, dict):
            return {k: build(v) for k, v in kids}
        return type(tree)(build(v) for _, v in kids)

    return build(template)
