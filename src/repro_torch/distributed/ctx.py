"""Mesh context for intra-model sharding hints.

The port of ``repro.distributed.ctx``: ``mesh_context`` declares the
active mesh and the activation rules, ``active_mesh`` and ``axis_size``
read them, and ``hint_spec`` resolves logical dim names to a partition
spec exactly as JAX's ``hint`` does (``_DEFAULT_ACT_RULES``, axes kept
only where present and dividing the dim, the first dim claiming an axis
winning).

JAX's ``hint`` then constrains the array to that spec and lets GSPMD
move it. The port's layout has no GSPMD: the serving engine keeps every
activation whole on its rank (each data rank runs its own slots, and a
layer's model-sharded weights are gathered before use), so ``hint``
checks its arguments and returns the tensor unchanged. The model calls
it nowhere: it would do nothing there.
"""
from __future__ import annotations

import contextlib
from contextvars import ContextVar
from typing import Optional

from repro_torch.distributed.sharding import P, axis_sizes

# logical activation dims -> mesh axis (or tuple of axes)
_DEFAULT_ACT_RULES = {
    "batch": ("pod", "data"),
    "seq": None,          # becomes "data" under sequence parallelism
    "embed": None,
    "heads": "model",
    "kv_heads": "model",
    # context-parallel fallback: when kv_heads doesn't divide the model
    # axis, the key/value sequence dim claims it instead (hint order
    # arbitrates)
    "kv_seq": "model",
    "mlp": "model",
    "vocab": "model",
    "expert": "model",
    "adapter_n": None,
    "bottleneck": None,
}

_state: ContextVar[Optional[dict]] = ContextVar("mesh_ctx", default=None)


@contextlib.contextmanager
def mesh_context(mesh, act_rules: Optional[dict] = None,
                 sizes: Optional[dict] = None):
    """Declare the active mesh + activation sharding rules.

    sizes: optional {axis_name: size} override (defaults from the mesh).
    """
    rules = dict(_DEFAULT_ACT_RULES)
    if act_rules:
        rules.update(act_rules)
    axis_sz = axis_sizes(mesh) if mesh is not None else {}
    if sizes:
        axis_sz.update(sizes)
    tok = _state.set({"mesh": mesh, "rules": rules, "sizes": axis_sz})
    try:
        yield
    finally:
        _state.reset(tok)


def current():
    """The active context (mesh, rules, sizes), or None: what
    ``restored`` re-enters where the context variable does not reach (an
    autograd worker thread recomputing a checkpointed layer)."""
    return _state.get()


@contextlib.contextmanager
def restored(state):
    """Re-enter a context ``current()`` returned."""
    tok = _state.set(state)
    try:
        yield
    finally:
        _state.reset(tok)


def active_mesh():
    st = _state.get()
    return st["mesh"] if st else None


def axis_size(name: str) -> int:
    st = _state.get()
    if not st:
        return 1
    return int(st["sizes"].get(name, 1))


def _resolve(logical: Optional[str], dim_size: int, st):
    if logical is None:
        return None
    axes = st["rules"].get(logical, None)
    if axes is None:
        return None
    if isinstance(axes, str):
        axes = (axes,)
    # keep only axes present in the mesh; require divisibility
    axes = tuple(a for a in axes if a in st["sizes"])
    if not axes:
        return None
    total = 1
    for a in axes:
        total *= st["sizes"][a]
    if total == 0 or dim_size % total != 0:
        return None
    return axes if len(axes) > 1 else axes[0]


def hint_spec(shape, *logical_dims: Optional[str]) -> Optional[P]:
    """The spec JAX's ``hint(x, *logical_dims)`` would constrain an array
    of ``shape`` to under the active mesh, or None without one."""
    st = _state.get()
    if st is None or st["mesh"] is None:
        return None
    assert len(logical_dims) == len(shape), (logical_dims, shape)
    entries = []
    used = set()
    for lg, s in zip(logical_dims, shape):
        e = _resolve(lg, s, st)
        axes = e if isinstance(e, tuple) else (e,) if e else ()
        # first dim claiming a mesh axis wins; later dims keep what's left
        left = tuple(a for a in axes if a not in used)
        if left != axes:
            total = 1
            for a in left:
                total *= st["sizes"][a]
            left = left if left and s % total == 0 else ()
        used.update(left)
        entries.append(left if len(left) > 1 else (left[0] if left
                                                   else None))
    return P(*entries)


def hint(x, *logical_dims: Optional[str]):
    """JAX's sharding hint: resolved (``hint_spec``) and checked, and the
    tensor returned as it is — the port's activations stay whole on
    their rank."""
    hint_spec(tuple(x.shape), *logical_dims)
    return x
