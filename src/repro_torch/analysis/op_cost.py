"""Op-stream cost analysis: the port's counterpart of
``repro.analysis.hlo_cost``, ``repro.analysis.attribute`` and
``repro.analysis.hlo.collective_bytes``.

JAX costs a step by reading its compiled, SPMD-partitioned HLO. The port
has no compiled step: what a step runs is the stream of aten ops that
eager mode dispatches, one kernel each. ``OpCounter`` is a
``TorchDispatchMode`` that sees every op of that stream (forward,
backward, recompute and ``torch.distributed`` collectives alike) and
costs it with ``hlo_cost.py``'s documented model:

- dot-like ops (``mm``, ``addmm``, ``bmm``, ``baddbmm``, ``mv``, ``dot``,
  ``convolution``): 2 x prod(result) x the contracted size;
- reductions (``sum``, ``mean``, ``amax``, ...): prod(operand);
- sorts (``sort``, ``topk``): n x log2 n, n = prod(operand);
- every other op with a tensor result: prod(result);
- views and metadata ops (``view``, ``permute``, ``empty``, ...): free;
- bytes: each op's tensor inputs plus its tensor outputs. That is eager
  mode's unfused traffic, each op being a kernel; JAX counts the traffic
  at fusion boundaries, after XLA has fused, so the port's bytes run
  higher for the same math;
- collectives: the ``c10d`` ops, keyed by JAX's kinds, each the bytes of
  its result tensors on this rank (``hlo.py``'s definition: result-shape
  bytes per device), also added to the bytes;
- loops: no trip multiplication. The port's loops are Python: every op
  they run is dispatched, and seen, once per iteration.

Shapes are this rank's, so every number is per device. The counter runs
on any device; on ``meta`` tensors (the dry run) nothing is computed, and
the kernel wrappers take their plain versions there, so a meta run counts
the plain versions' ops, not the CUDA kernels'.

``sites=True`` also keys each op's cost by (aten op, the innermost
``repro_torch`` function on the Python stack) for ``attribute``;
``memory=True`` tracks the bytes of the storages the ops allocate that
are alive at once (``peak_bytes``), each freed when its storage dies.
"""
from __future__ import annotations

import math
import os
import sys
import weakref
from typing import Dict, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

# hlo_cost.py's collective kinds, and hlo.py's (no ragged all-to-all)
COLLS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
         "collective-permute", "ragged-all-to-all")
HLO_COLLS = COLLS[:5]

# c10d op -> JAX's kind; every one takes its result tensor(s) first
_C10D = {
    "allgather_": "all-gather", "_allgather_base_": "all-gather",
    "allgather_coalesced_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "allreduce_": "all-reduce", "allreduce_coalesced_": "all-reduce",
    "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "reduce_scatter_tensor_coalesced_": "reduce-scatter",
    "alltoall_": "all-to-all", "alltoall_base_": "all-to-all",
    "send": "collective-permute", "recv_": "collective-permute",
}

# (the operand whose last dim is contracted) per dot-like op
_DOTS = {"mm": 0, "addmm": 1, "bmm": 0, "baddbmm": 1, "mv": 0, "addmv": 1}
_REDUCE = frozenset({
    "sum", "mean", "amax", "amin", "max", "min", "prod", "var", "std",
    "var_mean", "std_mean", "argmax", "argmin", "any", "all", "logsumexp",
    "linalg_vector_norm", "norm", "nansum", "count_nonzero", "aminmax"})
_SORT = frozenset({"sort", "topk", "argsort", "msort", "kthvalue"})
_FREE = frozenset({
    "_unsafe_view", "_reshape_alias", "lift_fresh", "empty", "empty_like",
    "empty_strided", "new_empty", "new_empty_strided", "detach", "alias",
    "_local_scalar_dense", "resize_", "set_", "record_stream"})

_PKG = os.sep + "repro_torch" + os.sep
_SELF = os.path.abspath(__file__)


def _name(func) -> str:
    return func._schema.name.split("::")[-1]


def _tensors(tree) -> list:
    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


def _nbytes(ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def _numel(ts) -> int:
    return sum(t.numel() for t in ts)


def op_flops(func, args, out) -> float:
    """FLOPs of one op occurrence under ``hlo_cost.py``'s model (0 for a
    collective, a view or a metadata op)."""
    name = _name(func)
    if func.namespace == "c10d" or func.is_view or name in _FREE:
        return 0.0
    if name in _DOTS:
        k = args[_DOTS[name]].shape[-1]
        return 2.0 * _numel(_tensors(out)) * k
    if name == "dot" or name == "vdot":
        return 2.0 * args[0].numel()
    if name == "convolution":
        w = args[1]
        k = w.shape[1] * math.prod(w.shape[2:])
        return 2.0 * _numel(_tensors(out)) * k
    if name in _REDUCE:
        return float(_numel(_tensors(args[:1])))
    if name in _SORT:
        n = _numel(_tensors(args[:1]))
        return n * max(1.0, math.log2(max(n, 2)))
    return float(_numel(_tensors(out)))


def _site() -> str:
    """The innermost ``repro_torch`` function on the Python stack, as
    ``path/under/repro_torch.py:function`` (``?`` outside the package)."""
    f = sys._getframe(2)
    while f is not None:
        fn = f.f_code.co_filename
        if _PKG in fn and os.path.abspath(fn) != _SELF:
            rel = fn.split(_PKG, 1)[1].replace(os.sep, "/")
            return f"{rel}:{f.f_code.co_name}"
        f = f.f_back
    return "?"


class OpCounter(TorchDispatchMode):
    """Costs every aten op dispatched while it is entered (``with
    OpCounter() as c: step(...)``): ``flops``, ``bytes``, ``collectives``
    ({kind: result bytes}), ``counts`` ({kind: ops}), ``ops`` (ops seen,
    free ones included) and ``by_op`` ({aten op: [flops, bytes]}); with
    ``sites`` also ``sites`` ({(aten op, site): [flops, bytes]}); with
    ``memory`` also ``live_bytes`` and ``peak_bytes``, the bytes of the
    storages the ops allocated that are alive now and at most at once."""

    def __init__(self, *, sites: bool = False, memory: bool = False):
        super().__init__()
        self.flops = 0.0
        self.bytes = 0.0
        self.collectives = {k: 0 for k in COLLS}
        self.counts = {k: 0 for k in COLLS}
        self.ops = 0
        self.by_op: Dict[str, list] = {}
        self.sites: Dict[Tuple[str, str], list] = {} if sites else None
        self.memory = memory
        self.live_bytes = self.peak_bytes = 0
        self._alive: Dict[int, int] = {}

    def _free(self, key):
        self.live_bytes -= self._alive.pop(key, 0)

    def _track(self, ins, outs):
        """Count the storages ``outs`` allocated: those not shared with an
        input and not seen before; each leaves the count when it dies."""
        seen = {t.untyped_storage()._cdata for t in ins}
        for t in outs:
            st = t.untyped_storage()
            key = st._cdata
            if key in seen or key in self._alive:
                continue
            seen.add(key)
            self._alive[key] = st.nbytes()
            self.live_bytes += st.nbytes()
            weakref.finalize(st, self._free, key)
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        self.ops += 1
        name = _name(func)
        ins = _tensors((args, kwargs))
        outs = _tensors(out)
        if self.memory:
            self._track(ins, outs)
        if func.namespace == "c10d":
            kind = _C10D.get(name)
            if kind is None:
                return out
            nb = _nbytes(_tensors(args[:1]))
            self.collectives[kind] += nb
            self.counts[kind] += 1
            flops, nbytes = 0.0, float(nb)
        elif func.is_view or name in _FREE:
            return out
        else:
            flops = op_flops(func, args, out)
            nbytes = float(_nbytes(ins) + _nbytes(outs))
        self.flops += flops
        self.bytes += nbytes
        key = f"{func.namespace}.{name}"
        acc = self.by_op.setdefault(key, [0.0, 0.0])
        acc[0] += flops
        acc[1] += nbytes
        if self.sites is not None:
            acc = self.sites.setdefault((key, _site()), [0.0, 0.0])
            acc[0] += flops
            acc[1] += nbytes
        return out


def analyze(counter: OpCounter) -> dict:
    """``hlo_cost.analyze``'s record of a step a counter has seen:
    {"flops", "bytes", "collectives": {kind: bytes, ..., "total"}}."""
    colls = dict(counter.collectives)
    colls["total"] = sum(colls[k] for k in COLLS)
    return {"flops": counter.flops, "bytes": counter.bytes,
            "collectives": colls}


def collective_bytes(counter: OpCounter) -> Dict[str, int]:
    """``hlo.collective_bytes``'s record: {kind: bytes, ..., "total",
    "counts": {kind: ops}} per device."""
    out = {k: int(counter.collectives[k]) for k in HLO_COLLS}
    out["total"] = sum(out[k] for k in HLO_COLLS)
    out["counts"] = {k: counter.counts[k] for k in HLO_COLLS}
    return out


def attribute(counter: OpCounter, top: int = 15, key: str = "bytes"):
    """Top sites by bytes (or flops): [(value, aten op, site)], the site
    the innermost ``repro_torch`` function that ran the op (the counter
    needs ``sites=True``)."""
    if counter.sites is None:
        raise ValueError("attribute needs an OpCounter(sites=True)")
    i = 1 if key == "bytes" else 0
    out = sorted(((v[i], op, site) for (op, site), v in
                  counter.sites.items() if v[i] > 0), reverse=True)
    return out[:top]
