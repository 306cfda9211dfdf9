"""CUDA kernel wrapper: a heterogeneous bank's per-layer adapters in one
launch (bottleneck -> LoRA -> IA3).

The hetero composed step applies up to three adapters per layer, in JAX's
fixed order (``src/repro/models/model.py:166-177``): the bottleneck
``y1 = x + act(LN(x·Â))·B̂``, LoRA ``y2 = y1 + (y1·Â_lora)·B̂_lora`` and
IA3 ``y = y2 · (1 + s)``, each rounded to x's dtype. Run as three kernels
(#2, #2's LoRA route, #7), IA3's launch — TPU kernel #7,
``src/repro/kernels/ia3_apply.py:45`` — is its whole time: it moves
24 KB at decode. This launch (``csrc/fused_adapter.cu``,
``xpeft_hetero_adapter_batched``) runs the stages present on #2's device
code in one grid of clusters: every stage's tiles copied in at once, each
matmul stage as #2 computes it with the stage's result kept in shared
memory, the IA3 scale as the last stage's epilogue. Its sum orders,
cluster size and roundings are the separate launches', so where ``plan``
picks the cluster size each stage's own ``fused_adapter_batched.plan``
picks, its output equals theirs bit for bit.

On a CPU tensor the wrapper computes the plain version
(``ref.hetero_adapter_batched_ref``, the three plain versions composed);
on a CUDA tensor it launches the kernel or raises.
``hetero_adapter_batched.launches`` counts kernel launches.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ref
from repro_torch.kernels._build import load_library
from repro_torch.kernels.fused_adapter_batched import (
    _ACTS, _DTYPES, CLUSTERS, MAX_B, MAX_SMEM, THREADS, TILE_T, _check_vectors,
    _ln_layout, _row_stride)
from repro_torch.utils import PLAIN_DEVICES


def _red_floats(nb, tt, vec, mma):
    """fp32 scratch of a CUDA-core stage (``red_floats`` in the source)."""
    if mma:
        return 0
    red = (THREADS // nb) * tt * nb
    return max(red, THREADS * vec) if tt == 1 else red


def smem_bytes(ds, nbs, tt, itemsize, mma, s_itemsize):
    """Shared memory of one block (``csrc/fused_adapter.cu``'s
    ``hetero_layout``) for matmul stages of widths ``nbs`` (0-2 of them)
    and s of ``s_itemsize`` bytes a value (0: no IA3): the x tile
    [tt, ds], each stage's Â rows [ds, nb] (rows of both padded by 16
    bytes), B̂ columns [nb, ds] and partial h [tt, nb] fp32; one h
    [tt, nb], LN affines [2, nb] and CUDA-core scratch sized for the
    wider stage; s's slice [ds]."""
    vec = 16 // itemsize
    total = tt * (ds + vec) * itemsize
    for nb in nbs:
        total += ds * (nb + vec) * itemsize + nb * ds * itemsize + tt * nb * 4
    nbmax = max(nbs, default=0)
    red = max((_red_floats(nb, tt, vec, mma) for nb in nbs), default=0)
    return total + tt * nbmax * 4 + 2 * nbmax * 4 + 4 * red \
        + ds * s_itemsize


def widths_ok(nbs, itemsize) -> bool:
    """Whether every matmul stage's width is a whole number of 16-byte
    vectors in [1, MAX_B], as the launch needs."""
    vec = 16 // itemsize
    return all(nb % vec == 0 and 1 <= nb <= MAX_B for nb in nbs)


def cluster_for(d, nbs, T, itemsize, s_itemsize=0):
    """Blocks per cluster for matmul stages of widths ``nbs`` and an IA3
    scale of ``s_itemsize`` bytes a value (0: none): the first of
    ``CLUSTERS`` whose d-slice is a whole number of 16-byte vectors (of 16
    values in bf16), whose s slice is too, and whose shared memory, both
    stages' tiles together, fits in a block; None when none does. Raises
    ValueError when a width is not a whole number of 16-byte vectors.
    ``kernels/ops.py``'s ``hetero_adapter`` asks this first: where no
    cluster fits (a bottleneck + LoRA entry at d=6144 with T > 1, or
    d=7168; dbrx-132b's and llava-next-34b's widths) it runs the stages
    as their own kernels, #2 -> #2's LoRA route -> #7."""
    vec = 16 // itemsize
    for nb in nbs:
        if not widths_ok([nb], itemsize):
            raise ValueError(f"width {nb} is not a whole number of 16-byte "
                             f"vectors ({vec} values) in [1, {MAX_B}]")
    step = 16 if itemsize == 2 else vec
    tt = 1 if T == 1 else TILE_T
    mma = itemsize == 2 and T > 1
    for cs in CLUSTERS:
        ds = d // cs
        if d % (cs * step) == 0 and (ds * s_itemsize) % 16 == 0 \
                and smem_bytes(ds, nbs, tt, itemsize, mma,
                               s_itemsize) <= MAX_SMEM:
            return cs
    return None


def plan(d, nbs, T, itemsize, s_itemsize=0):
    """``cluster_for``'s cluster size, raising ValueError where no cluster
    fits: this launch never splits into separate launches itself."""
    cs = cluster_for(d, nbs, T, itemsize, s_itemsize)
    if cs is not None:
        return cs
    step = 16 if itemsize == 2 else 16 // itemsize
    raise ValueError(f"no cluster of {CLUSTERS} blocks fits d={d}, widths "
                     f"{tuple(nbs)} at {itemsize}-byte values: the d-slice "
                     f"must be a multiple of {step} values and the block's "
                     f"shared memory at most {MAX_SMEM} bytes")


def hetero_adapter_batched(x, *, bottleneck=None, lora=None, ia3=None,
                           activation: str = "gelu"):
    """x [B, T, d] (bf16/fp32), with any of: ``bottleneck`` = (a_hat
    [B, d, b] or [d, b], b_hat [B, b, d] or [b, d], ln_scale, ln_bias
    [B, b] or [b] fp32) applied with ``activation``; ``lora`` = (lora_a
    [B, d, r] or [d, r], lora_b [B, r, d] or [r, d]); ``ia3`` = s [B, d]
    or [d] (bf16/fp32). Â/B̂ in x's dtype. -> [B, T, d] in x's dtype,
    the stages applied in that order."""
    if x.device.type in PLAIN_DEVICES:
        return ref.hetero_adapter_batched_ref(
            x, bottleneck=bottleneck, lora=lora, ia3=ia3,
            activation=activation)
    out = launch(x, bottleneck=bottleneck, lora=lora, ia3=ia3,
                 activation=activation)
    hetero_adapter_batched.launches += 1
    return out


def _stage(x, a_hat, b_hat, name):
    """Width, batch strides and vector checks of one matmul stage."""
    B, _, d = x.shape
    nb = a_hat.shape[-1]
    if not x.dtype == a_hat.dtype == b_hat.dtype:
        raise TypeError(f"{name}: x/a/b dtypes {x.dtype}/{a_hat.dtype}/"
                        f"{b_hat.dtype} must be one")
    for part, t in (("a", a_hat), ("b", b_hat)):
        if t.device != x.device:
            raise ValueError(f"{name} {part} on {t.device}, x on {x.device}")
    a_bs = _row_stride(a_hat, (d, nb), f"{name} a")
    b_bs = _row_stride(b_hat, (nb, d), f"{name} b")
    for part, t, bs in (("a", a_hat, a_bs), ("b", b_hat, b_bs)):
        if bs and t.shape[0] != B:
            raise ValueError(f"{name} {part} has {t.shape[0]} rows for "
                             f"batch {B}")
    _check_vectors(x, a_hat, b_hat, a_bs, b_bs)
    return nb, a_bs, b_bs


def _ia3_layout(x, s):
    """s's batch stride in elements (0 for a shared s)."""
    B, _, d = x.shape
    if s.dtype not in _DTYPES:
        raise TypeError(f"ia3 s dtype {s.dtype} not in {list(_DTYPES)}")
    if s.device != x.device:
        raise ValueError(f"ia3 s on {s.device}, x on {x.device}")
    s_bs = _row_stride(s, (d,), "ia3 s")
    if s_bs and s.shape[0] != B:
        raise ValueError(f"ia3 s has {s.shape[0]} rows for batch {B}")
    if s.data_ptr() % 16 or (s_bs * s.element_size()) % 16:
        raise ValueError(f"ia3 s must start 16-byte aligned with a batch "
                         f"stride of whole 16-byte vectors, got "
                         f"{s.data_ptr():#x} / {s_bs}")
    return s_bs


def launch(x, *, bottleneck, lora, ia3, activation):
    """Check the operands and launch on x's device (uncounted), on
    ``plan``'s cluster size."""
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    if x.ndim != 3 or not x.is_contiguous():
        raise ValueError(f"x must be a contiguous [B, T, d], got "
                         f"{tuple(x.shape)}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"x dtype {x.dtype} not in {list(_DTYPES)}")
    if activation not in _ACTS:
        raise ValueError(f"activation {activation!r} not in {list(_ACTS)}")
    if bottleneck is None and lora is None and ia3 is None:
        raise ValueError("no stage to apply")
    B, T, d = x.shape
    nbs = []
    bn_args, ln, nb, bn_bs, ln_bs = (None, None), (None, None), 0, (0, 0), 0
    if bottleneck is not None:
        a_hat, b_hat, ln_scale, ln_bias = bottleneck
        nb, *bn_bs = _stage(x, a_hat, b_hat, "bottleneck")
        lnt, ln_bs = _ln_layout(ln_scale, ln_bias, nb, True)
        for t in lnt:
            if t.device != x.device:
                raise ValueError(f"LN affines on {t.device}, x on "
                                 f"{x.device}")
        if ln_bs and ln_scale.shape[0] != B:
            raise ValueError(f"ln_scale has {ln_scale.shape[0]} rows for "
                             f"batch {B}")
        bn_args, ln = (a_hat, b_hat), lnt
        nbs.append(nb)
    lora_args, nr, lora_bs = (None, None), 0, (0, 0)
    if lora is not None:
        nr, *lora_bs = _stage(x, *lora, "lora")
        lora_args = tuple(lora)
        nbs.append(nr)
    s_bs, s_itemsize = 0, 0
    if ia3 is not None:
        s_bs = _ia3_layout(x, ia3)
        s_itemsize = ia3.element_size()
    cs = plan(d, nbs, T, x.element_size(), s_itemsize)

    def ptr(t):
        return None if t is None else t.data_ptr()
    out = torch.empty_like(x)
    lib = load_library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.xpeft_hetero_adapter_batched(
            x.data_ptr(), *map(ptr, bn_args), *map(ptr, ln),
            *map(ptr, lora_args), ptr(ia3), out.data_ptr(),
            B, T, d, nb, nr, *bn_bs, ln_bs, *lora_bs, s_bs,
            _DTYPES[x.dtype], _DTYPES[ia3.dtype] if ia3 is not None else 0,
            _ACTS[activation], cs, stream)
    if err:
        raise RuntimeError(f"hetero_adapter launch failed: CUDA error {err}")
    return out


hetero_adapter_batched.launches = 0
