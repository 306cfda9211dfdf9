"""Nested-dict helpers: the port's params, grads and optimizer state are
plain dicts of tensors, as the JAX package's pytrees are."""
from __future__ import annotations

import numpy as np
import torch


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


def leaf_name(path: str) -> str:
    """The last component of a slash-joined path."""
    return path.rsplit("/", 1)[-1]


def map_with_path(fn, tree, prefix: str = ""):
    """``fn(path, leaf)`` over the leaves of ``tree``, the paths as
    ``tree_paths`` gives them, keeping the nesting."""
    return map_with_paths(fn, tree, prefix=prefix)


def map_with_paths(fn, tree, *rest, prefix: str = ""):
    """``fn(path, leaf, *other_leaves)`` over the leaves of ``tree`` and
    the same leaves of ``rest`` (which share its nesting), the paths as
    ``tree_paths`` gives them, keeping the nesting."""
    def sub(k):
        return f"{prefix}/{k}" if prefix else str(k)

    if isinstance(tree, dict):
        return {k: map_with_paths(fn, v, *(r[k] for r in rest),
                                  prefix=sub(k)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_with_paths(fn, v, *(r[i] for r in rest),
                                         prefix=sub(i))
                          for i, v in enumerate(tree))
    return fn(prefix, tree, *rest)


def _leaf_size(x) -> int:
    return int(np.prod(tuple(x.shape))) if hasattr(x, "shape") else 1


def _leaf_bytes(x) -> int:
    if isinstance(x, torch.Tensor):
        itemsize = x.element_size()
    else:
        itemsize = np.dtype(x.dtype).itemsize if hasattr(x, "dtype") else 4
    return _leaf_size(x) * itemsize


def _present(tree) -> list:
    """The leaves of ``tree`` but None, which JAX's pytrees hold as an
    empty subtree."""
    return [x for x in tree_paths(tree).values() if x is not None]


def param_count(tree) -> int:
    """Elements over the leaves of ``tree`` (a leaf without a shape counts
    one, as in the JAX package)."""
    return sum(_leaf_size(x) for x in _present(tree))


def param_bytes(tree) -> int:
    """Bytes over the leaves of ``tree`` (4 for a leaf without a dtype)."""
    return sum(_leaf_bytes(x) for x in _present(tree))


def tree_zeros_like(tree):
    """Zeros of each leaf's shape, dtype and device (None stays None)."""
    return map_with_path(
        lambda _, x: None if x is None else torch.zeros_like(x), tree)


def merge_trees(a: dict, b: dict) -> dict:
    """Recursively merge two nested dicts (b wins at leaf level)."""
    out = dict(a)
    for k, v in b.items():
        if k in out and isinstance(out[k], dict) and isinstance(v, dict):
            out[k] = merge_trees(out[k], v)
        else:
            out[k] = v
    return out
