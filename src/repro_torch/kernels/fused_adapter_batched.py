"""CUDA kernel wrapper: batched fused bottleneck adapter.

Replaces the Pallas TPU kernel
``src/repro/kernels/fused_adapter_batched.py:65``
(``fused_adapter_batched``): ``y = x + act(LN(x·Â))·B̂`` per batch row,
with per-row or shared Â/B̂/LN. The kernel (``csrc/fused_adapter.cu``) is
bound by bytes on the H100: at decode (T=1) it is a GEMV pair per batch
row that must read the row's 2·d·b Â/B̂ values; at prefill a small
grouped GEMM. Its design spreads each (T-tile, batch row) over a
thread-block cluster of ``plan`` blocks, each taking one d-slice: every
copy a block needs in flight at once, x·Â on tensor cores in bf16 at
T > 1, the partial h of each block summed in rank order through
distributed shared memory, LN and the activation in every block, then
that block's columns of h·B̂ and the residual. It takes
``kernels/ref.py``'s numerics (fp32 inside, h in fp32 into the
up-projection, one rounding to x's dtype); the source says where the
Pallas body rounds differently and why.

On a CPU tensor the wrapper computes the plain version; on a CUDA tensor
it launches the kernel or raises (a shape no cluster fits raises too).
``fused_adapter_batched.launches`` counts kernel launches,
``fused_adapter_batched.launches_by_t`` the same launches by x's T.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ref
from repro_torch.kernels._build import load_library
from repro_torch.utils import PLAIN_DEVICES

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ACTS = {"identity": 0, "gelu": 1}
MAX_B = 256
THREADS = 256                  # per block
TILE_T = 16                    # tokens per block at T > 1
CLUSTERS = (8, 16)             # blocks per cluster, in order of preference
MAX_SMEM = 232448              # shared memory one block may opt in to


def smem_bytes(ds, nb, tt, itemsize, mma):
    """Shared memory of one block (``csrc/fused_adapter.cu``'s ``layout``):
    x tile [tt, ds] and Â rows [ds, nb], each row padded by 16 bytes; B̂
    columns [nb, ds]; the partial and full h [tt, nb] and the LN affines
    [2, nb] fp32; on CUDA cores the sub-slice partials
    [THREADS // nb, tt, nb] fp32, at T = 1 at least THREADS vectors of
    fp32 (the up-projection's bottleneck-group partials)."""
    vec = 16 // itemsize
    red = (THREADS // nb) * tt * nb
    if tt == 1:
        red = max(red, THREADS * vec)
    return (tt * (ds + vec) * itemsize + ds * (nb + vec) * itemsize
            + nb * ds * itemsize + 2 * tt * nb * 4 + 2 * nb * 4
            + (0 if mma else 4 * red))


def plan(d, nb, T, itemsize):
    """Blocks per cluster (each takes d / cluster columns): the first of
    ``CLUSTERS`` whose d-slice is a whole number of 16-byte vectors (of 16
    values in bf16, the tensor-core depth) and whose shared memory fits
    in a block. Raises ValueError when none does, or when nb is not a
    whole number of 16-byte vectors."""
    vec = 16 // itemsize
    if nb % vec:
        raise ValueError(f"bottleneck {nb} is not a whole number of "
                         f"16-byte vectors ({vec} values)")
    step = 16 if itemsize == 2 else vec
    tt = 1 if T == 1 else TILE_T
    mma = itemsize == 2 and T > 1
    for cs in CLUSTERS:
        if d % (cs * step) == 0 \
                and smem_bytes(d // cs, nb, tt, itemsize, mma) <= MAX_SMEM:
            return cs
    raise ValueError(f"no cluster of {CLUSTERS} blocks fits d={d}, b={nb} "
                     f"at {itemsize}-byte values: "
                     f"the d-slice must be a multiple of {step} values and "
                     f"the block's shared memory at most {MAX_SMEM} bytes")


def _row_stride(t, inner, name):
    """Batch stride (elements) of a per-row [B, *inner] operand, or 0 for a
    shared [*inner] one; the inner dims must be dense (row slices of a
    larger buffer, e.g. one layer of [B, L, d, b], are fine)."""
    if t.ndim not in (len(inner), len(inner) + 1) \
            or tuple(t.shape[-len(inner):]) != tuple(inner):
        raise ValueError(f"{name} must end in {inner}, got {tuple(t.shape)}")
    expect = 1
    for dim in range(t.ndim - 1, t.ndim - 1 - len(inner), -1):
        if t.shape[dim] > 1 and t.stride(dim) != expect:
            raise ValueError(f"{name} inner dims must be contiguous")
        expect *= t.shape[dim]
    return t.stride(0) if t.ndim == len(inner) + 1 else 0


def _check_vectors(x, a_hat, b_hat, a_bs, b_bs):
    """The kernel copies x, Â and B̂ in 16-byte vectors: each must start
    16-byte aligned, with a batch stride of whole vectors."""
    vec = 16 // x.element_size()
    for name, t, bs in (("x", x, 0), ("a_hat", a_hat, a_bs),
                        ("b_hat", b_hat, b_bs)):
        if t.data_ptr() % 16 or bs % vec:
            raise ValueError(f"{name} must start 16-byte aligned with a "
                             f"batch stride of whole 16-byte vectors, got "
                             f"{t.data_ptr():#x} / {bs}")


def _ln_layout(ln_scale, ln_bias, nb, use_ln):
    """The LN affines to pass and their batch stride: ((ln_scale, ln_bias),
    stride), both fp32 [B, nb] or [nb] in one layout; or ((), 0) on the
    LoRA route (use_ln=False) given None for both -- the kernel reads them
    only under use_ln."""
    if not use_ln and ln_scale is None and ln_bias is None:
        return (), 0
    if ln_scale is None or ln_bias is None:
        raise ValueError("pass both LN affines, or neither with use_ln=False")
    if ln_scale.dtype != torch.float32 or ln_bias.dtype != torch.float32:
        raise TypeError("LN affines must be float32")
    ln_bs = _row_stride(ln_scale, (nb,), "ln_scale")
    if _row_stride(ln_bias, (nb,), "ln_bias") != ln_bs:
        raise ValueError("ln_scale and ln_bias must share one layout")
    return (ln_scale, ln_bias), ln_bs


def fused_adapter_batched(x, a_hat, b_hat, ln_scale, ln_bias, *,
                          activation: str = "gelu", use_ln: bool = True):
    """x [B, T, d]; a_hat [B, d, b] or [d, b]; b_hat [B, b, d] or [b, d]
    (x, a_hat and b_hat in one dtype, bf16 or fp32); ln_* [B, b] or [b]
    fp32, or None with ``use_ln=False`` -> [B, T, d] in x's dtype."""
    if x.device.type in PLAIN_DEVICES:
        return ref.fused_adapter_batched_ref(
            x, a_hat, b_hat, ln_scale, ln_bias, activation=activation,
            use_ln=use_ln)
    out = launch(x, a_hat, b_hat, ln_scale, ln_bias, activation=activation,
                 use_ln=use_ln)
    fused_adapter_batched.launches += 1
    by_t = fused_adapter_batched.launches_by_t
    by_t[x.shape[1]] = by_t.get(x.shape[1], 0) + 1
    return out


def launch(x, a_hat, b_hat, ln_scale, ln_bias, *, activation, use_ln):
    """Check the operands and launch the kernel on x's device (uncounted:
    each entry point counts its own launches), on ``plan``'s cluster
    size."""
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    if x.ndim != 3 or not x.is_contiguous():
        raise ValueError(f"x must be a contiguous [B, T, d], got "
                         f"{tuple(x.shape)}")
    B, T, d = x.shape
    nb = a_hat.shape[-1]
    if activation not in _ACTS:
        raise ValueError(f"activation {activation!r} not in {list(_ACTS)}")
    if x.dtype not in _DTYPES or not x.dtype == a_hat.dtype == b_hat.dtype:
        raise TypeError(f"x/a_hat/b_hat dtypes {x.dtype}/{a_hat.dtype}/"
                        f"{b_hat.dtype}: all three must be one of bfloat16 "
                        "or float32")
    if not 1 <= nb <= MAX_B:
        raise ValueError(f"bottleneck {nb} outside [1, {MAX_B}]")
    ln, ln_bs = _ln_layout(ln_scale, ln_bias, nb, use_ln)
    for name, t in (("a_hat", a_hat), ("b_hat", b_hat),
                    *zip(("ln_scale", "ln_bias"), ln)):
        if t.device != x.device:
            raise ValueError(f"{name} on {t.device}, x on {x.device}")
    a_bs = _row_stride(a_hat, (d, nb), "a_hat")
    b_bs = _row_stride(b_hat, (nb, d), "b_hat")
    for name, t, bs in (("a_hat", a_hat, a_bs), ("b_hat", b_hat, b_bs),
                        ("ln_scale", ln_scale, ln_bs)):
        if bs and t.shape[0] != B:
            raise ValueError(f"{name} has {t.shape[0]} rows for batch {B}")
    _check_vectors(x, a_hat, b_hat, a_bs, b_bs)
    cs = plan(d, nb, T, x.element_size())
    ls_ptr, lb_ptr = (t.data_ptr() for t in ln) if ln else (None, None)
    out = torch.empty_like(x)
    lib = load_library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.xpeft_fused_adapter_batched(
            x.data_ptr(), a_hat.data_ptr(), b_hat.data_ptr(),
            ls_ptr, lb_ptr, out.data_ptr(),
            B, T, d, nb, a_bs, b_bs, ln_bs, _DTYPES[x.dtype], int(use_ln),
            _ACTS[activation], cs, stream)
    if err:
        raise RuntimeError(f"fused_adapter launch failed: CUDA error {err}")
    return out


fused_adapter_batched.launches = 0
fused_adapter_batched.launches_by_t = {}
