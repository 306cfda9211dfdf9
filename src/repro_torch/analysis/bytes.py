"""Analytic bank/record byte accounting: the one place the admission byte
math lives.

Consumers: ``serve/engine.py``'s admission stats (what one k-sparse
admission reads) and the port's benchmarks. The quantized numbers equal
the true bytes of the tensors ``quant.schemes.quantize_bank`` produces, so
the analytic figures and the engine's own accounting cannot drift apart.
Every function gives the integers of ``repro.analysis.bytes``.
"""
from __future__ import annotations

import torch

from repro_torch.quant.schemes import check_scheme, group_for
from repro_torch.utils.tree import tree_leaves


def itemsize_for(dtype: str) -> int:
    """Byte width of a model dtype string ('bfloat16', 'float32', ...)."""
    t = getattr(torch, dtype, None)
    if not isinstance(t, torch.dtype):
        raise TypeError(f"data type {dtype!r} not understood")
    return t.itemsize


def row_bytes(n: int, *, scheme: str = "none", itemsize: int = 2,
              group: int = 32) -> int:
    """Bytes of ONE length-n quantized-or-not row (payload + fp16 scales).

    none: n * itemsize.  int8: n + one fp16 scale.  int4: n/2 packed +
    one fp16 scale per group_for(n, group) values."""
    check_scheme(scheme)
    if scheme == "none":
        return n * itemsize
    if scheme == "int8":
        return n + 2
    g = group_for(n, group)
    return n // 2 + 2 * (n // g)


def bank_slice_bytes(d: int, b: int, *, scheme: str = "none",
                     itemsize: int = 2, group: int = 32) -> int:
    """Bytes of one (layer, adapter) bank slice across BOTH banks: the Â
    row block [d, b] (d rows of length b) + the B̂ row block [b, d]."""
    return d * row_bytes(b, scheme=scheme, itemsize=itemsize, group=group) \
        + b * row_bytes(d, scheme=scheme, itemsize=itemsize, group=group)


def admission_bank_bytes(L: int, N: int, k: int, d: int, b: int, *,
                         dense: bool = False, scheme: str = "none",
                         itemsize: int = 2, group: int = 32) -> int:
    """Bank bytes ONE admission aggregation reads: k rows per layer on the
    sparse path (N with ``dense=True``), both banks, under ``scheme``."""
    rows = N if dense else k
    return rows * L * bank_slice_bytes(d, b, scheme=scheme,
                                       itemsize=itemsize, group=group)


def record_bytes(L: int, d: int, b: int, *, scheme: str,
                 group: int = 32) -> int:
    """Bytes of one profile's stored aggregated Â/B̂ record (+ scales):
    what the profile cache budgets per entry and the store persists for
    quantized stores. scheme='none' gives the fp16 record."""
    if scheme == "none":
        return 2 * 2 * L * d * b  # fp16 Â + B̂
    return L * bank_slice_bytes(d, b, scheme=scheme, group=group)


def aggregation_bytes(cfg) -> dict:
    """The serve-bench analytic record: dense vs k-sparse admission reads
    at cfg's dims, plus the quantized-sparse column for each scheme and
    the reductions between them."""
    xp = cfg.xpeft
    L, N, k, d, b = (cfg.num_layers, xp.num_adapters, xp.k, cfg.d_model,
                     xp.bottleneck)
    itemsize = itemsize_for(cfg.dtype)
    kw = dict(itemsize=itemsize, group=xp.quant_group)
    dense = admission_bank_bytes(L, N, k, d, b, dense=True, **kw)
    sparse = admission_bank_bytes(L, N, k, d, b, **kw)
    out = {"N": N, "k": k, "L": L, "d": d, "b": b,
           "bytes_dense": dense, "bytes_sparse": sparse,
           "reduction": round(dense / sparse, 2)}
    for scheme in ("int8", "int4"):
        q = admission_bank_bytes(L, N, k, d, b, scheme=scheme, **kw)
        out[f"bytes_sparse_{scheme}"] = q
        out[f"{scheme}_vs_sparse"] = round(q / sparse, 3)
        out[f"{scheme}_vs_dense"] = round(q / dense, 4)
    return out


def tree_nbytes(tree) -> int:
    """TRUE byte count of a nested dict of tensors (numel x element size);
    None leaves hold nothing."""
    return int(sum(t.numel() * t.element_size() for t in tree_leaves(tree)
                   if t is not None))
