"""Sharding rules: param-name-based logical axes -> partition specs, and
the placement helpers that hold a tensor as this rank's block.

The port of ``repro.distributed.sharding``. ``_RULES``,
``_LOGICAL_TO_MESH``, ``spec_for``, ``param_specs``, ``batch_specs``,
``cache_specs``, ``paged_cache_specs``, ``leading_axis_specs`` and
``sharded_bytes_per_device`` give JAX's specs for the same shapes. They
read only a ``{axis: size}`` mapping (``axis_sizes``: a
``torch.distributed`` ``DeviceMesh``, a dict, or anything with a
``.shape`` mapping, as JAX's read ``mesh.shape``), and their leaves are
anything with a ``.shape`` (tensors, meta tensors, ``Sharded``).

Scheme (as JAX's):
- TP over the "model" axis: heads / kv_heads / mlp / experts / vocab / the
  adapter bank's d_model dim.
- FSDP over the "data" axis: every parameter's largest still-unsharded
  dim, when divisible and large enough.
- The "pod" axis never shards parameters.

JAX places a tree with ``device_put`` and lets GSPMD gather what a
kernel needs. The port has no GSPMD, so it places explicitly:
``shard`` cuts this rank's block out of a whole tensor, ``gather`` puts
the whole tensor back together with one ``all_gather`` per named axis
(bitwise: gathering moves bytes), and ``Sharded`` holds a leaf as its
block at rest, to be gathered where it is used (``whole``, ``layer``,
``rows``). A ``Sharding`` is a (mesh, spec) pair, JAX's
``NamedSharding``: ``put`` holds a whole tensor under one,
``constrain_leading`` holds a slot-packed tree as each rank's rows of
its leading dim, and ``whole_tree`` gathers any such tree back whole.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.utils.tree import map_with_path, tree_map


class P(tuple):
    """A partition spec: one entry per dim, each None (whole), an axis
    name, or a tuple of axis names (the first the major one); the
    stand-in for ``jax.sharding.PartitionSpec``."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self):
        return f"P{tuple.__repr__(self)}"


def axis_sizes(mesh) -> Dict[str, int]:
    """``{axis: size}`` of a ``DeviceMesh``, a dict, or an object with a
    ``.shape`` mapping (JAX's meshes and the tests' stubs)."""
    if isinstance(mesh, dict):
        return dict(mesh)
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, mesh.shape))
    return dict(mesh.shape)


def _spec_leaves(specs) -> list:
    """The specs of a spec tree in ``tree_leaves`` order (dict keys
    sorted); a ``P`` is a leaf."""
    if isinstance(specs, dict):
        return [s for k in sorted(specs) for s in _spec_leaves(specs[k])]
    return [specs]


def _leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    return [tree]


# leaf-name (+ndim disambiguation) -> logical dims for the TRAILING dims.
# Leading stack dims (layers L, profile table P) are covered implicitly:
# unmatched leading dims get None (then FSDP may claim them).
_RULES: Dict[Tuple[str, Optional[int]], Tuple] = {}


def _rule(name, *logical, ndim=None):
    _RULES[(name, ndim)] = tuple(logical)


# embeddings / heads
_rule("embed", "vocab", None)
_rule("pos_embed", None, None)
_rule("lm_head", None, "vocab")
# attention
_rule("wq", None, "heads", None)
_rule("wk", None, "kv_heads", None)
_rule("wv", None, "kv_heads", None)
_rule("wo", "heads", None, None)
_rule("bq", "heads", None)
_rule("bk", "kv_heads", None)
_rule("bv", "kv_heads", None)
# dense mlp
_rule("wg", None, "mlp")
_rule("wu", None, "mlp")
_rule("wd", "mlp", None)
_rule("w1", None, "mlp")
_rule("w2", "mlp", None)
_rule("b1", "mlp")
_rule("b2", None)
# moe: experts over model, FSDP pinned to the ff dim
_rule("router", None, None)
_rule("ew_g", "expert", None, "mlp_fsdp")
_rule("ew_u", "expert", None, "mlp_fsdp")
_rule("ew_d", "expert", "mlp_fsdp", None)
# X-PEFT adapter bank [L, N, d, b] / [L, N, b, d]: d_model TP-sharded
_rule("bank_a", "adapter_n", "tp_d", None)
_rule("bank_b", "adapter_n", None, "tp_d")
# heterogeneous bank segments: LoRA pairs keep the bottleneck bank's
# layout; IA3 scale vectors and prefix KV rows are replicated
_rule("lora_a", "adapter_n", "tp_d", None)
_rule("lora_b", "adapter_n", None, "tp_d")
_rule("ia3_v", "adapter_n", None)
_rule("prefix_k", "adapter_n", None, None)
_rule("prefix_v", "adapter_n", None, None)
# quantized bank: payloads keep the bf16 bank's layout, scales ride along
# (int8 scales drop the quantized axis, ndim 3; int4 group scales keep a
# trailing group axis, ndim 4)
_rule("bank_a_q", "adapter_n", "tp_d", None)
_rule("bank_b_q", "adapter_n", None, "tp_d")
_rule("bank_a_scale", "adapter_n", "tp_d", ndim=3)
_rule("bank_a_scale", "adapter_n", "tp_d", None, ndim=4)
_rule("bank_b_scale", "adapter_n", None, ndim=3)
_rule("bank_b_scale", "adapter_n", None, "tp_d", ndim=4)
_rule("lora_a_q", "adapter_n", "tp_d", None)
_rule("lora_b_q", "adapter_n", None, "tp_d")
_rule("lora_a_scale", "adapter_n", "tp_d", ndim=3)
_rule("lora_a_scale", "adapter_n", "tp_d", None, ndim=4)
_rule("lora_b_scale", "adapter_n", None, ndim=3)
_rule("lora_b_scale", "adapter_n", None, "tp_d", ndim=4)
# rwkv (2D projections over flattened heads)
_rule("rwr", None, "tp_d")
_rule("rwk", None, "tp_d")
_rule("rwv", None, "tp_d")
_rule("rwg", None, "tp_d")
_rule("rwo", "tp_d", None)
_rule("cw_k", None, "mlp")
_rule("cw_v", "mlp", None)
_rule("cw_r", None, None)
_rule("dec_a", None, None)
_rule("dec_b", None, "tp_d")
# mamba
_rule("in_proj", None, "tp_d")
_rule("out_proj", "tp_d", None)

_LOGICAL_TO_MESH = {
    "vocab": "model",
    "heads": "model",
    "kv_heads": "model",
    "mlp": "model",
    "expert": "model",
    "tp_d": "model",
    "mlp_fsdp": "data",
}

FSDP_MIN_SIZE = 2 ** 16


def _lookup(name: str, ndim: int):
    """Rules align to trailing dims; (name, None) matches every rank."""
    if (name, ndim) in _RULES:
        return _RULES[(name, ndim)]
    if (name, None) in _RULES:
        return _RULES[(name, None)]
    return None


def spec_for(path: str, shape, mesh_axes: Dict[str, int], *, fsdp: bool,
             logical_map: Optional[dict] = None,
             overrides: Optional[dict] = None) -> P:
    """The partition spec of one parameter (JAX's rule, dim by dim)."""
    name = path.rsplit("/", 1)[-1]
    ndim = len(shape)
    lmap = dict(_LOGICAL_TO_MESH)
    if logical_map:
        lmap.update(logical_map)

    logical = None
    if overrides:
        for pat, val in overrides.items():
            if pat in path:
                logical = val
                break
    if logical is None:
        logical = _lookup(name, ndim)
    if logical is None:
        logical = (None,) * ndim
    logical = (None,) * (ndim - len(logical)) + tuple(logical)

    assigned = []
    used_axes = set()
    for dim, lg in zip(shape, logical):
        ax = lmap.get(lg) if lg else None
        if ax and ax in mesh_axes and dim % mesh_axes[ax] == 0 \
                and ax not in used_axes:
            assigned.append(ax)
            used_axes.add(ax)
        else:
            assigned.append(None)

    if fsdp and "data" in mesh_axes and "data" not in assigned \
            and int(np.prod(shape)) >= FSDP_MIN_SIZE:
        # shard the largest remaining dim over data (ties: the later one)
        cands = [(dim, i) for i, (dim, a) in enumerate(zip(shape, assigned))
                 if a is None and dim % mesh_axes["data"] == 0]
        if cands:
            _, i = max(cands)
            assigned[i] = "data"
    return P(*assigned)


def param_specs(params, mesh, *, fsdp: bool = True,
                logical_map: Optional[dict] = None,
                overrides: Optional[dict] = None):
    """A spec per leaf of ``params`` (the "pod" axis never shards one)."""
    mesh_axes = axis_sizes(mesh)
    mesh_axes.pop("pod", None)
    return map_with_path(
        lambda p, x: spec_for(p, tuple(x.shape), mesh_axes, fsdp=fsdp,
                              logical_map=logical_map, overrides=overrides),
        params)


# ----------------------------------------------------------------------------
# Activations / batch / cache
# ----------------------------------------------------------------------------

def batch_axes(mesh) -> tuple:
    sizes = axis_sizes(mesh)
    return tuple(a for a in ("pod", "data") if a in sizes)


def batch_specs(batch, mesh, global_batch: int):
    """The leading batch dim of every leaf over pod+data; the sequence dim
    (dim 1) where the batch does not divide; else replicated."""
    sizes = axis_sizes(mesh)
    ba = batch_axes(mesh)
    n = int(np.prod([sizes[a] for a in ba]))

    def one(x):
        shape = tuple(x.shape)
        if shape and shape[0] % n == 0 and shape[0] >= n:
            return P(ba, *([None] * (len(shape) - 1)))
        if len(shape) >= 2 and shape[1] % n == 0:
            return P(None, ba, *([None] * (len(shape) - 2)))
        return P(*([None] * len(shape)))

    return tree_map(one, batch)


_KV = ("k", "v", "attn_k", "attn_v")


def cache_specs(cache, mesh, cfg, batch: int):
    """KV/state cache specs: the slot dim (1) over data when divisible,
    else the sequence dim of K/V; K/V heads (dim 3) over model, else the
    sequence dim (context-parallel fallback); recurrent state heads (dim
    2 of ``wkv``/``ssd``) over model."""
    sizes = axis_sizes(mesh)
    dsize = sizes.get("data", 1)
    msize = sizes.get("model", 1)

    def one(path, x):
        name = path.rsplit("/", 1)[-1]
        shape = tuple(x.shape)
        nd = len(shape)
        spec = [None] * nd
        if nd >= 2 and shape[1] % dsize == 0 and shape[1] >= dsize:
            spec[1] = "data"
        elif name in _KV and nd >= 3 and shape[2] % dsize == 0:
            spec[2] = "data"
        if name in _KV and nd >= 4:
            if shape[3] % msize == 0:
                spec[3] = "model"
            elif spec[2] is None and shape[2] % msize == 0:
                spec[2] = "model"
        if name in ("wkv", "ssd") and nd >= 3 and shape[2] % msize == 0:
            spec[2] = "model"
        return P(*spec)

    return map_with_path(one, cache)


def paged_cache_specs(paged_cache, mesh, cfg, n_slots: int):
    """The continuous engine's paged cache: ``cache_specs`` on the pools
    (the page axis where the dense slot axis sat), the page table's slot
    axis over data."""
    dsize = axis_sizes(mesh).get("data", 1)
    data = cache_specs(paged_cache["data"], mesh, cfg, n_slots)
    t = tuple(paged_cache["table"].shape)
    lead = "data" if t[0] % dsize == 0 and t[0] >= dsize else None
    return {"data": data, "table": P(lead, None)}


def leading_axis_specs(tree, mesh, axis: str = "data"):
    """Every leaf's leading dim over ``axis`` when divisible, else
    replicated: the spec of slot-packed state (slot arrays, mask buffers,
    page tables)."""
    n = axis_sizes(mesh).get(axis, 1)

    def one(x):
        shape = tuple(x.shape)
        nd = len(shape)
        if nd >= 1 and n > 1 and shape[0] % n == 0 and shape[0] >= n:
            return P(axis, *([None] * (nd - 1)))
        return P(*([None] * nd))

    return tree_map(one, tree)


def _itemsize(dtype) -> int:
    if isinstance(dtype, torch.dtype):
        return torch.empty((), dtype=dtype).element_size()
    return np.dtype(dtype).itemsize


def sharded_bytes_per_device(tree, specs, mesh) -> int:
    """Analytic per-device bytes of ``tree`` (leaves with ``.shape`` and
    ``.dtype``: tensors, meta tensors, ``Sharded``) laid out by ``specs``.
    Raises rather than under-report: exactly one spec per leaf, each
    covering its leaf's full rank, every named axis in the mesh."""
    sizes = axis_sizes(mesh)
    flat_x = _leaves(tree)
    flat_s = _spec_leaves(specs)
    if len(flat_x) != len(flat_s):
        raise ValueError(
            f"specs tree has {len(flat_s)} PartitionSpecs for "
            f"{len(flat_x)} leaves — every leaf needs exactly one spec")
    total = 0
    for x, spec in zip(flat_x, flat_s):
        if not isinstance(spec, tuple):
            raise ValueError(f"expected PartitionSpec, got {spec!r}")
        shape = tuple(x.shape)
        if len(spec) != len(shape):
            raise ValueError(
                f"spec {spec} has {len(spec)} entries for a rank-"
                f"{len(shape)} leaf of shape {shape} — specs "
                "must cover the full rank")
        n = 1
        for entry in spec:
            if entry is None:
                continue
            for a in (entry if isinstance(entry, tuple) else (entry,)):
                if a not in sizes:
                    raise ValueError(
                        f"spec {spec} names mesh axis {a!r} not in "
                        f"{sorted(sizes)}")
                n *= sizes[a]
        total += int(np.prod(shape)) * _itemsize(x.dtype) // n
    return total


# ----------------------------------------------------------------------------
# Placement: a rank's block of a whole tensor, and the whole tensor back
# ----------------------------------------------------------------------------

def all_gather(x, group) -> list:
    """Every rank's ``x`` (same shape and dtype on each) in group rank
    order, as bytes so that any dtype travels; on ``x``'s device."""
    flat = x.contiguous().view(-1).view(torch.uint8)
    outs = [torch.empty_like(flat) for _ in range(dist.get_world_size(group))]
    dist.all_gather(outs, flat, group=group)
    all_gather.bytes += flat.numel() * (len(outs) - 1)
    return [o.view(x.dtype).view(x.shape) for o in outs]


all_gather.bytes = 0   # bytes this rank received, summed over calls


def _axes(entry) -> tuple:
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def _group(mesh, axis):
    return mesh.get_group(axis)


def shard(x, spec, mesh):
    """This rank's block of the whole tensor ``x`` under ``spec`` (a
    contiguous copy): each named dim cut into as many blocks as its axes
    hold ranks, the first axis of a tuple the major one."""
    sizes = axis_sizes(mesh)
    for dim, entry in enumerate(spec):
        axes = _axes(entry)
        if not axes:
            continue
        n = int(np.prod([sizes[a] for a in axes]))
        idx = 0
        for a in axes:
            idx = idx * sizes[a] + mesh.get_local_rank(a)
        size = x.shape[dim] // n
        x = x.narrow(dim, idx * size, size)
    return x.contiguous()


def gather(x_local, spec, mesh):
    """The whole tensor from every rank's block under ``spec``: one
    ``all_gather`` per named axis, the minor axis of a tuple first."""
    sizes = axis_sizes(mesh)
    x = x_local
    for dim, entry in enumerate(spec):
        for a in reversed(_axes(entry)):
            if sizes[a] > 1:
                x = torch.cat(all_gather(x, _group(mesh, a)), dim=dim)
    return x


def _size(spec, sizes) -> int:
    return int(np.prod([sizes[a] for e in spec for a in _axes(e)] or [1]))


class Sharded:
    """A leaf held as this rank's block at rest (``local``), whole shape
    ``shape`` under ``spec``; the model gathers it where it is used
    (``whole``, ``layer``, ``rows``)."""

    def __init__(self, local, spec, mesh, shape):
        self.local, self.spec, self.mesh = local, P(*spec), mesh
        self.shape = torch.Size(shape)

    dtype = property(lambda self: self.local.dtype)
    device = property(lambda self: self.local.device)

    def numel(self) -> int:
        return int(np.prod(self.shape))

    def element_size(self) -> int:
        return self.local.element_size()

    def whole(self):
        return gather(self.local, self.spec, self.mesh)

    def layer(self, l):
        """The whole of ``[l]`` of a layer-stacked leaf (its leading dim
        is never sharded)."""
        assert self.spec[0] is None, self.spec
        return gather(self.local[l], P(*self.spec[1:]), self.mesh)


def place(tree, specs, mesh):
    """Hold each leaf of ``tree`` as its block under its spec: a
    ``Sharded`` where the spec splits it, the tensor itself where it is
    whole (or every named axis has one rank)."""
    sizes = axis_sizes(mesh)

    def one(x, spec):
        if _size(spec, sizes) == 1:
            return x
        return Sharded(shard(x, spec, mesh), spec, mesh, x.shape)

    return tree_map(one, tree, specs)


def whole(x):
    """``x`` itself, or a ``Sharded`` leaf gathered whole."""
    return x.whole() if isinstance(x, Sharded) else x


def whole_tree(tree):
    return tree_map(whole, tree)


def layer(x, l):
    """``x[l]`` of a layer-stacked leaf, gathered whole if sharded."""
    return x.layer(l) if isinstance(x, Sharded) else x[l]


def rows(table, idx):
    """``table[idx]`` for a row table (the embedding): on a vocab-sharded
    table each rank looks up the rows it holds, and the gathered lookups
    are picked per index from the rank that holds its row (copies, so
    bitwise the whole table's lookup)."""
    if not isinstance(table, Sharded):
        return table[idx]
    if table.spec[0] is None or any(e is not None for e in table.spec[1:]):
        return table.whole()[idx]
    (axis,) = _axes(table.spec[0])
    n = table.local.shape[0]
    own = table.mesh.get_local_rank(axis)
    local = idx - own * n
    hit = (local >= 0) & (local < n)
    got = table.local[local.clamp(0, n - 1)]
    got = torch.where(hit[..., None], got, torch.zeros_like(got))
    parts = torch.stack(all_gather(got, _group(table.mesh, axis)))
    owner = (idx // n).clamp(0, parts.shape[0] - 1)
    return torch.take_along_dim(parts, owner[None, ..., None], dim=0)[0]


def global_meta(local, spec, mesh):
    """A meta tensor of the whole shape a rank's block ``local`` stands
    for under ``spec``."""
    sizes = axis_sizes(mesh)
    shape = [s * _size(P(e), sizes) for s, e in zip(local.shape, spec)]
    return torch.empty(shape, dtype=local.dtype, device="meta")


# ----------------------------------------------------------------------------
# Shardings: where a leaf lives, and trees of them
# ----------------------------------------------------------------------------

class Sharding:
    """A (mesh, spec) pair: the stand-in for ``jax.sharding.NamedSharding``.
    ``put`` holds a whole tensor under it."""

    def __init__(self, mesh, spec):
        self.mesh, self.spec = mesh, P(*spec)

    def __repr__(self):
        return f"Sharding({axis_sizes(self.mesh)}, {self.spec!r})"


def to_shardings(specs, mesh):
    """A spec tree -> a tree of ``Sharding(mesh, spec)`` (JAX's
    ``to_shardings``)."""
    return tree_map(lambda s: Sharding(mesh, s), specs)


def param_shardings(params, mesh, **kw):
    """``Sharding(mesh, spec)`` of every leaf of ``params`` under
    ``param_specs(params, mesh, **kw)``."""
    return to_shardings(param_specs(params, mesh, **kw), mesh)


def sharding_of(x):
    """The ``Sharding`` a ``Sharded`` leaf is held under; None for a whole
    tensor."""
    return Sharding(x.mesh, x.spec) if isinstance(x, Sharded) else None


def shardings_of(tree):
    return tree_map(sharding_of, tree)


def in_mesh(mesh) -> bool:
    """Whether this process holds a position in ``mesh`` (a mesh built
    over part of the world leaves the other ranks out)."""
    return mesh.get_coordinate() is not None


def is_lead(mesh) -> bool:
    """Whether this rank sits at coordinate 0 of every axis of ``mesh``:
    the rank that writes files and prints."""
    coord = mesh.get_coordinate()
    return coord is not None and not any(coord)


def barrier(mesh) -> None:
    """Every rank of ``mesh`` meets here: a barrier on each axis's group
    in turn, which together reach every rank."""
    for g in mesh.get_all_groups():
        dist.barrier(group=g)


def put(x, sharding):
    """A whole tensor held under ``sharding``: this rank's ``Sharded``
    block, ``x`` itself where the spec keeps it whole (or with no
    sharding), None on a rank outside the sharding's mesh."""
    if sharding is None:
        return x
    if not in_mesh(sharding.mesh):
        return None
    return place(x, sharding.spec, sharding.mesh)


def constrain_leading(tree, mesh, axis: str = "data"):
    """JAX's ``constrain_leading`` for the port: a slot-packed tree of
    whole tensors held as each rank's rows of its leading dim
    (``leading_axis_specs``), so per-slot work stays on the rank that
    holds the slot. No-op without a mesh."""
    if mesh is None:
        return tree
    return place(tree, leading_axis_specs(tree, mesh, axis), mesh)


def local(x):
    """This rank's block of a ``Sharded`` leaf, or the tensor itself."""
    return x.local if isinstance(x, Sharded) else x


def to(x, **kw):
    """``Tensor.to`` on a tensor or on a ``Sharded`` leaf's block."""
    if isinstance(x, Sharded):
        return Sharded(x.local.to(**kw), x.spec, x.mesh, x.shape)
    return x.to(**kw)


def local_tree(tree):
    return tree_map(local, tree)


def row_range(x) -> Tuple[int, int]:
    """(first row, rows) this rank holds of a leaf's leading dim: all of
    them for a whole tensor, its block's for a leading-axis ``Sharded``."""
    if not isinstance(x, Sharded) or x.spec[0] is None:
        return 0, int(x.shape[0])
    n = x.local.shape[0]
    idx = 0
    sizes = axis_sizes(x.mesh)
    for a in _axes(x.spec[0]):
        idx = idx * sizes[a] + x.mesh.get_local_rank(a)
    return idx * n, n


def layer_block(x, l):
    """``x[l]`` of a layer-stacked leaf with its "model" axis left as this
    rank's block and every other named axis gathered (the expert-parallel
    weights: experts stay over "model", a "data" split of their ff dim is
    gathered, as ``_moe_shard_map`` all-gathers it)."""
    if not isinstance(x, Sharded):
        return x[l]
    assert x.spec[0] is None, x.spec
    assert all("model" not in _axes(e) or _axes(e) == ("model",)
               for e in x.spec), x.spec
    spec = P(*(None if _axes(e) == ("model",) else e for e in x.spec[1:]))
    return gather(x.local[l], spec, x.mesh)


def rank_sum(x, mesh, axis: str):
    """``x`` summed over the ranks of ``axis`` in rank order (gathered,
    then added): the same bits on every rank and every backend."""
    if axis_sizes(mesh)[axis] == 1:
        return x
    return torch.stack(all_gather(x, mesh.get_group(axis))).sum(0)
