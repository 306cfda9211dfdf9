"""CUDA kernel wrapper: batched fused adapter over quantized records.

Replaces the Pallas TPU kernel ``src/repro/kernels/fused_adapter_quant.py:53``
(``fused_adapter_quant_batched``, ``pallas_call`` at ``:78``):
``y = x + act(LN(x·Â))·B̂`` per batch row, with each row's Â/B̂ stored as
int8 or planar int4 with fp16 scales and widened in registers. The kernel
(``csrc/fused_adapter_quant.cu``) is bound by bytes on the H100: at decode
(T=1) a GEMV pair per slot over its quantized records, at prefill a small
grouped GEMM. Its design is the bf16 fused adapter's with a dequant
prologue on every weight read (the shared ``csrc/dequant.cuh``); fp32
inside and one rounding to x's dtype, as the plain version. Every
operand takes a batch stride, so one layer of the engine's [B, L, ...]
quantized slot buffers needs no copy.

On a CPU tensor the wrapper computes the plain version
(``kernels/ref.py``); on a CUDA tensor it launches the kernel or raises.
``fused_adapter_quant_batched.launches`` counts kernel launches.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ref
from repro_torch.kernels._build import load_library
from repro_torch.kernels.fused_adapter_batched import _row_stride
from repro_torch.kernels.mask_aggregate_quant import check_rows

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ACTS = {"identity": 0, "gelu": 1}
MAX_B = 256


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
    if x.device.type == "cpu":
        return ref.fused_adapter_quant_batched_ref(
            x, a_q, a_scale, b_q, b_scale, ln_scale, ln_bias, **kw)
    out = _launch(x, a_q, a_scale, b_q, b_scale, ln_scale, ln_bias, **kw)
    fused_adapter_quant_batched.launches += 1
    return out


def _launch(x, a_q, a_scale, b_q, b_scale, ln_scale, ln_bias, *, scheme,
            activation):
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    nb, groups, strides = _check(x, a_q, a_scale, b_q, b_scale, ln_scale,
                                 ln_bias, scheme, activation)
    B, T, d = x.shape
    out = torch.empty_like(x)
    lib = load_library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.xpeft_fused_adapter_quant_batched(
            x.data_ptr(), a_q.data_ptr(), a_scale.data_ptr(),
            b_q.data_ptr(), b_scale.data_ptr(), ln_scale.data_ptr(),
            ln_bias.data_ptr(), out.data_ptr(), B, T, d, nb, *groups,
            *strides, _DTYPES[x.dtype], int(scheme == "int4"),
            _ACTS[activation], stream)
    if err:
        raise RuntimeError(f"fused_adapter_quant launch failed: CUDA error "
                           f"{err}")
    return out


def _check(x, a_q, a_scale, b_q, b_scale, ln_scale, ln_bias, scheme,
           activation):
    """Raise on operands the kernel does not take; return (b, (scales
    per Â row, per B̂ row), batch strides of a_q, a_scale, b_q, b_scale,
    ln_*)."""
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
    return nb, (a_groups, b_groups), (aq_bs, as_bs, bq_bs, bs_bs, ln_bs)


fused_adapter_quant_batched.launches = 0
