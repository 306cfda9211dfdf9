"""CUDA kernel wrapper: batched fused adapter over quantized records.

Replaces the Pallas TPU kernel ``src/repro/kernels/fused_adapter_quant.py:53``
(``fused_adapter_quant_batched``, ``pallas_call`` at ``:78``):
``y = x + act(LN(x·Â))·B̂`` per batch row, with each row's Â/B̂ stored as
int8 or planar int4 with fp16 scales. The kernel
(``csrc/fused_adapter_quant.cu``) is bound by bytes on the H100: at decode
(T=1) a GEMV pair per slot over its quantized records, at prefill a small
grouped GEMM. Its design is the bf16 fused adapter's
(``fused_adapter_batched``) with the dequantization moved into the copy-in
phase: each (T-tile, batch row) spreads over a thread-block cluster of
``plan`` blocks, each taking d / cluster columns (int8: a contiguous
slice; int4: the column pair-set its B̂ bytes hold); every copy a block
needs in flight at once, each value dequantized once from shared memory
into an fp32 tile (the shared ``csrc/dequant.cuh``), the partial h of each
block summed in rank order through distributed shared memory, LN and the
activation in every block, then that block's columns of h·B̂ and the
residual. Products stay on CUDA cores in fp32 (a dequantized value is
exact in neither bf16 nor TF32); fp32 inside and one rounding to x's
dtype, as the plain version. Where no cluster fits with the whole tile
(int4 at gemma3-27b's d=5376), ``launch_plan`` takes 8 blocks whose fp32
tile holds one int4 pair-part at a time (two passes over it, the same
products in the same order: bitwise the one-pass outputs wherever both
fit). Every operand takes a batch stride, so one
layer of the engine's [B, L, ...] quantized slot buffers needs no copy.

On a CPU tensor the wrapper computes the plain version
(``kernels/ref.py``); on a CUDA tensor it launches the kernel or raises (a
shape no cluster fits raises too).
``fused_adapter_quant_batched.launches`` counts kernel launches.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ref
from repro_torch.kernels._build import load_library
from repro_torch.kernels.fused_adapter_batched import _row_stride
from repro_torch.kernels.mask_aggregate_quant import check_rows
from repro_torch.utils import PLAIN_DEVICES

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ACTS = {"identity": 0, "gelu": 1}
MAX_B = 256
THREADS = 256                  # per block
TILE_T = 16                    # tokens per block at T > 1
CLUSTERS = (8, 16)             # blocks per cluster
# (blocks per cluster, passes over the fp32 tile), in order of preference;
# two passes (one int4 pair-part at a time) only where neither fits whole
PLANS = ((8, 1), (16, 1), (8, 2))
MAX_SMEM = 232448              # shared memory one block may opt in to


def _up16(n):
    return (n + 15) // 16 * 16


def smem_bytes(ds, nb, tt, itemsize, int4, a_groups, b_groups, passes=1):
    """Shared memory of one block (``csrc/fused_adapter_quant.cu``'s
    ``layout``): the x tile [tt, ds]; the block's Â rows [ds, nb] as
    bytes and their scales; its B̂ bytes [nb, ds] and B̂'s whole scale
    block [nb, b_groups]; one fp32 tile [ds / passes, nb] that holds Â,
    then B̂ (each pass's part);
    the partial and full h [tt, nb] and the LN affines [2, nb] fp32; the
    sub-slice partials [THREADS // nb, tt, nb] fp32, at T = 1 at least
    THREADS vectors of fp32 (the up-projection's bottleneck-group
    partials)."""
    qa, qb = (nb // 2, ds // 2) if int4 else (nb, ds)
    red = (THREADS // nb) * tt * nb
    if tt == 1:
        red = max(red, THREADS * (16 // itemsize))
    return (_up16(tt * ds * itemsize) + _up16(ds * qa)
            + _up16(ds * a_groups * 2) + _up16(nb * qb)
            + _up16(nb * b_groups * 2) + 4 * (ds // passes) * nb
            + 2 * 4 * tt * nb
            + 2 * 4 * nb + 4 * red)


def ranges_whole(d, nb, int4, cs):
    """Whether every range that a block of a cluster of ``cs`` copies is
    whole 16-byte vectors. Its columns form one range (int8: the slice)
    or two (int4: the pair-set) of w columns; w a multiple of 16 makes
    x's ranges, the Â rows and scales over them and each B̂ row's bytes
    whole vectors; nb a multiple of 8 makes B̂'s scale block whole vectors
    and keeps each 4-byte word of quantized bytes in one row. The
    kernel's ``ranges_whole``."""
    parts = 2 * cs if int4 else cs
    return d % parts == 0 and nb % 8 == 0 and (d // parts) % 16 == 0


def launch_plan(d, nb, T, itemsize, scheme, a_groups=1, b_groups=1):
    """(blocks per cluster, passes over the fp32 tile): the first of
    ``PLANS`` whose ranges are whole 16-byte vectors (``ranges_whole``)
    and whose shared memory fits in a block; two passes only in int4,
    where the pair-set's two ranges are the passes' parts. Each block
    takes d / cluster columns. B̂'s scale rows are copied whole, so a
    block's columns need not be whole scale groups. Raises ValueError
    when no plan fits."""
    int4 = scheme == "int4"
    tt = 1 if T == 1 else TILE_T
    for cs, passes in PLANS:
        if (passes == 1 or int4) and ranges_whole(d, nb, int4, cs) \
                and smem_bytes(d // cs, nb, tt, itemsize, int4, a_groups,
                               b_groups, passes) <= MAX_SMEM:
            return cs, passes
    raise ValueError(f"no cluster of {CLUSTERS} blocks fits {scheme} d={d}, "
                     f"b={nb} ({a_groups}/{b_groups} scales per Â/B̂ row) "
                     f"at {itemsize}-byte x: each block's column ranges "
                     "must be whole 16-byte vectors of x, of the quantized "
                     "bytes and of their scales, b a multiple of 8, and "
                     f"the block's shared memory at most {MAX_SMEM} bytes")


def plan(d, nb, T, itemsize, scheme, a_groups=1, b_groups=1):
    """Blocks per cluster of ``launch_plan``."""
    return launch_plan(d, nb, T, itemsize, scheme, a_groups, b_groups)[0]


def _per_row(t, inner, B, name):
    """Batch stride of a per-row [B, *inner] operand (a layer slice of a
    [B, L, *inner] buffer included)."""
    if t.ndim != len(inner) + 1 or t.shape[0] != B:
        raise ValueError(f"{name} must be per-row [{B}, *{inner}], got "
                         f"{tuple(t.shape)}")
    return _row_stride(t, inner, name)


def fused_adapter_quant_batched(x, a_q, a_scale, b_q, b_scale, ln_scale,
                                ln_bias, *, scheme: str,
                                activation: str = "gelu"):
    """x [B, T, d] (bf16 or fp32); a_q [B, d, b] int8 with a_scale [B, d],
    or [B, d, b/2] uint8 (planar int4) with [B, d, b/g]; b_q [B, b, d] /
    [B, b, d/2] with b_scale [B, b] / [B, b, d/g] (fp16 scales); ln_*
    [B, b] fp32 -> [B, T, d] in x's dtype."""
    kw = dict(scheme=scheme, activation=activation)
    if x.device.type in PLAIN_DEVICES:
        return ref.fused_adapter_quant_batched_ref(
            x, a_q, a_scale, b_q, b_scale, ln_scale, ln_bias, **kw)
    out = _launch(x, a_q, a_scale, b_q, b_scale, ln_scale, ln_bias, **kw)
    fused_adapter_quant_batched.launches += 1
    return out


def _launch(x, a_q, a_scale, b_q, b_scale, ln_scale, ln_bias, *, scheme,
            activation, passes=None):
    """One launch; ``passes`` (1 or 2) overrides the plan's, for checking
    the two-pass tile against the one-pass one where both fit."""
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    nb, groups, strides = _check(x, a_q, a_scale, b_q, b_scale, ln_scale,
                                 ln_bias, scheme, activation)
    B, T, d = x.shape
    cs, planned = launch_plan(d, nb, T, x.element_size(), scheme, *groups)
    passes = planned if passes is None else passes
    out = torch.empty_like(x)
    lib = load_library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.xpeft_fused_adapter_quant_batched(
            x.data_ptr(), a_q.data_ptr(), a_scale.data_ptr(),
            b_q.data_ptr(), b_scale.data_ptr(), ln_scale.data_ptr(),
            ln_bias.data_ptr(), out.data_ptr(), B, T, d, nb, *groups,
            *strides, _DTYPES[x.dtype], int(scheme == "int4"),
            _ACTS[activation], cs, passes, stream)
    if err:
        raise RuntimeError(f"fused_adapter_quant launch failed: CUDA error "
                           f"{err}")
    return out


def _check(x, a_q, a_scale, b_q, b_scale, ln_scale, ln_bias, scheme,
           activation):
    """Raise on operands the kernel does not take; return (b, (scales
    per Â row, per B̂ row), batch strides of a_q, a_scale, b_q, b_scale,
    ln_*). x, the quantized rows and their scales are copied in 16-byte
    vectors: each must start 16-byte aligned with a batch stride of whole
    16-byte vectors."""
    if x.ndim != 3 or not x.is_contiguous():
        raise ValueError(f"x must be a contiguous [B, T, d], got "
                         f"{tuple(x.shape)}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"x dtype {x.dtype} not in {list(_DTYPES)}")
    if activation not in _ACTS:
        raise ValueError(f"activation {activation!r} not in {list(_ACTS)}")
    B, T, d = x.shape
    nb, a_groups = check_rows(a_q, a_scale, scheme, "a_q")
    nd, b_groups = check_rows(b_q, b_scale, scheme, "b_q")
    if nd != d or b_q.ndim != 3 or a_q.ndim != 3 \
            or a_q.shape[1] != d or b_q.shape[1] != nb:
        raise ValueError(f"a_q {tuple(a_q.shape)} / b_q {tuple(b_q.shape)} "
                         f"do not hold Â [d, b] / B̂ [b, d] rows for d={d}")
    if not 1 <= nb <= MAX_B:
        raise ValueError(f"bottleneck {nb} outside [1, {MAX_B}]")
    if ln_scale.dtype != torch.float32 or ln_bias.dtype != torch.float32:
        raise TypeError("LN affines must be float32")
    for name, t in (("a_q", a_q), ("a_scale", a_scale), ("b_q", b_q),
                    ("b_scale", b_scale), ("ln_scale", ln_scale),
                    ("ln_bias", ln_bias)):
        if t.device != x.device:
            raise ValueError(f"{name} on {t.device}, x on {x.device}")
    aq_bs = _per_row(a_q, tuple(a_q.shape[1:]), B, "a_q")
    as_bs = _per_row(a_scale, tuple(a_scale.shape[1:]), B, "a_scale")
    bq_bs = _per_row(b_q, tuple(b_q.shape[1:]), B, "b_q")
    bs_bs = _per_row(b_scale, tuple(b_scale.shape[1:]), B, "b_scale")
    ln_bs = _per_row(ln_scale, (nb,), B, "ln_scale")
    if _per_row(ln_bias, (nb,), B, "ln_bias") != ln_bs:
        raise ValueError("ln_scale and ln_bias must share one layout")
    for name, t, bs in (("x", x, 0), ("a_q", a_q, aq_bs),
                        ("a_scale", a_scale, as_bs), ("b_q", b_q, bq_bs),
                        ("b_scale", b_scale, bs_bs)):
        if t.data_ptr() % 16 or (bs * t.element_size()) % 16:
            raise ValueError(f"{name} must start 16-byte aligned with a "
                             f"batch stride of whole 16-byte vectors, got "
                             f"{t.data_ptr():#x} / {bs}")
    return nb, (a_groups, b_groups), (aq_bs, as_bs, bq_bs, bs_bs, ln_bs)


fused_adapter_quant_batched.launches = 0
