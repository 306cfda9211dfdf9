"""Bridge between the JAX package's pytrees and the port's tensors.

``to_torch`` takes the JAX package's param / state / cache pytrees as
numpy arrays (the caller does ``np.asarray`` on each leaf; this module
never imports jax) and returns the same nesting of dicts / lists / tuples
with torch tensors on ``device``. ``to_numpy`` goes back.

bf16 travels through a ``uint16`` view in both directions:
``torch.from_numpy`` rejects ``ml_dtypes.bfloat16`` arrays, and torch has
no numpy bf16 dtype, so the 16 bits move unchanged and are re-labelled.
"""
from __future__ import annotations

import numpy as np
import torch


def _leaf_to_torch(a, device) -> torch.Tensor:
    a = np.array(a)  # a writable copy: JAX hands out read-only buffers
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(device)


def _leaf_to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        import ml_dtypes  # numpy's bf16 dtype; only this direction needs it
        return t.view(torch.int16).numpy().view(np.uint16).view(
            ml_dtypes.bfloat16)
    return t.numpy()


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(v, fn) for v in tree)
    if tree is None:
        return None
    return fn(tree)


def to_torch(tree, device="cpu"):
    """numpy pytree -> the same nesting of torch tensors on ``device``."""
    return _map(tree, lambda a: _leaf_to_torch(a, device))


def to_numpy(tree):
    """torch pytree -> the same nesting of numpy arrays (bf16 as
    ``ml_dtypes.bfloat16``, the dtype JAX hands out)."""
    return _map(tree, _leaf_to_numpy)
