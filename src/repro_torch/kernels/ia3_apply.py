"""CUDA kernel wrapper: batched IA3 scaling.

Replaces the Pallas TPU kernel ``src/repro/kernels/ia3_apply.py:45``
(``ia3_apply_batched``): ``y = x * (1 + s)`` per batch row, with ``s`` the
profile's aggregated scale deltas ([B, d] per row, or [d] shared). The
kernel (``csrc/ia3_apply.cu``) is bound by bytes on the H100 — x read
once, y written once, s once per row — and at the serving path's shapes
by its launch. Its design — a flat grid of 16-byte vectors of x, the
row's s values beside each, fp32 inside with one rounding to x's dtype —
is described in the source; it is bitwise equal to the plain version,
and s = 0 gives x bitwise.

On a CPU tensor the wrapper computes the plain version; on a CUDA tensor
it launches the kernel or raises. ``ia3_apply_batched.launches`` counts
kernel launches.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ref
from repro_torch.kernels._build import load_library
from repro_torch.utils import PLAIN_DEVICES

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def ia3_apply_batched(x, s):
    """x [B, T, d] (bf16/fp32); s [B, d] or shared [d] (bf16/fp32) ->
    x * (1 + s), [B, T, d] in x's dtype."""
    if x.device.type in PLAIN_DEVICES:
        return ref.ia3_apply_batched_ref(x, s)
    out = _launch(x, s)
    ia3_apply_batched.launches += 1
    return out


def _check(x, s):
    """The operand layout the kernel takes: returns s's batch stride in
    elements (0 for a shared s)."""
    if x.ndim != 3 or not x.is_contiguous():
        raise ValueError(f"x must be a contiguous [B, T, d], got "
                         f"{tuple(x.shape)}")
    B, T, d = x.shape
    if x.dtype not in _DTYPES or s.dtype not in _DTYPES:
        raise TypeError(f"x/s dtypes {x.dtype}/{s.dtype}: each must be one "
                        "of bfloat16 or float32")
    if s.ndim not in (1, 2) or s.shape[-1] != d \
            or (s.ndim == 2 and s.shape[0] != B):
        raise ValueError(f"s must be [B, d] or [d] for x {tuple(x.shape)}, "
                         f"got {tuple(s.shape)}")
    if s.device != x.device:
        raise ValueError(f"s on {s.device}, x on {x.device}")
    if d > 1 and s.stride(-1) != 1:
        raise ValueError("s rows must be contiguous")
    stride = s.stride(0) if s.ndim == 2 and B > 1 else 0
    vec = 16 // x.element_size()
    if d % vec or x.data_ptr() % 16 or s.data_ptr() % 16 \
            or (stride * s.element_size()) % 16:
        raise ValueError(
            f"rows must be whole 16-byte vectors ({vec} values of x) and "
            f"x and every row of s 16-byte aligned; got d={d}, x at "
            f"{x.data_ptr():#x}, s at {s.data_ptr():#x} stride {stride}")
    return stride


def _launch(x, s):
    """Check the operands and launch on x's device (uncounted)."""
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    stride = _check(x, s)
    B, T, d = x.shape
    out = torch.empty_like(x)
    lib = load_library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.xpeft_ia3_apply_batched(
            x.data_ptr(), s.data_ptr(), out.data_ptr(), B * T, T, d, stride,
            _DTYPES[x.dtype], _DTYPES[s.dtype], stream)
    if err:
        raise RuntimeError(f"ia3_apply launch failed: CUDA error {err}")
    return out


ia3_apply_batched.launches = 0
