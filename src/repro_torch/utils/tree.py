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


def tree_paths(tree, prefix: str = "") -> dict:
    """Flatten to ``{"a/b/c": leaf}`` with slash-joined string paths: dict
    keys as strings, list and tuple positions as their index, in JAX's
    order (dict keys sorted), so one state tree gives the same paths in
    both packages (the checkpoint keys)."""
    if isinstance(tree, dict):
        items = [(str(k), tree[k]) for k in sorted(tree)]
    elif isinstance(tree, (list, tuple)):
        items = [(str(i), v) for i, v in enumerate(tree)]
    else:
        return {prefix: tree}
    out = {}
    for k, v in items:
        out.update(tree_paths(v, f"{prefix}/{k}" if prefix else k))
    return out


def map_with_path(fn, tree, prefix: str = ""):
    """``fn(path, leaf)`` over the leaves of ``tree``, the paths as
    ``tree_paths`` gives them, keeping the nesting."""
    if isinstance(tree, dict):
        return {k: map_with_path(fn, v, f"{prefix}/{k}" if prefix else
                                 str(k)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_with_path(fn, v, f"{prefix}/{i}" if prefix
                                        else str(i))
                          for i, v in enumerate(tree))
    return fn(prefix, tree)


def merge_trees(a: dict, b: dict) -> dict:
    """Recursively merge two nested dicts (b wins at leaf level)."""
    out = dict(a)
    for k, v in b.items():
        if k in out and isinstance(out[k], dict) and isinstance(v, dict):
            out[k] = merge_trees(out[k], v)
        else:
            out[k] = v
    return out
