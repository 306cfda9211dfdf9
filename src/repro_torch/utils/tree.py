"""Nested-dict helpers: the port's params, grads and optimizer state are
plain dicts of tensors, as the JAX package's pytrees are."""
from __future__ import annotations


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` (and the same leaves of ``rest``,
    which share its nesting)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    """Leaves in JAX's flattening order (dict keys sorted), so sums over
    leaves add in the same order."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    return [tree]


def merge_trees(a: dict, b: dict) -> dict:
    """Recursively merge two nested dicts (b wins at leaf level)."""
    out = dict(a)
    for k, v in b.items():
        if k in out and isinstance(out[k], dict) and isinstance(v, dict):
            out[k] = merge_trees(out[k], v)
        else:
            out[k] = v
    return out
