"""CUDA kernel wrapper: k-sparse aggregation over a quantized adapter bank.

Replaces the Pallas TPU kernel
``src/repro/kernels/mask_aggregate_quant.py:48``
(``mask_aggregate_quant_batched``, ``pallas_call`` at ``:80``). The kernel
(``csrc/mask_aggregate_quant.cu``) is bound by bytes on the H100: it reads
the k selected quantized rows of every output row once (int8 bytes or
packed int4 nibbles, with their fp16 scales) and writes the fp32 output
once. Its design is the unquantized aggregation's (terms of weight 0
dropped, the kept ones compacted into shared memory in k order, ``unroll``
16-byte row loads in flight per thread, block size and loads in flight
from ``plan``) with the rows widened in registers by ``csrc/dequant.cuh``'s
exact conversion that needs no integer-to-float instruction, and 16-byte
stores; it equals its plain version bit for bit.

On a CPU tensor the wrapper computes the plain version
(``kernels/ref.py``); on a CUDA tensor it launches the kernel or raises.
``mask_aggregate_quant_batched.launches`` counts kernel launches.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ref
from repro_torch.kernels._build import load_library
from repro_torch.quant.schemes import check_scheme
from repro_torch.utils import PLAIN_DEVICES

MAX_K = 1024
Q_DTYPES = {"int8": torch.int8, "int4": torch.uint8}
SMS = 132                       # streaming multiprocessors of an H100 SXM
THREADS = (64, 128)             # block sizes the kernel is built for
UNROLLS = (1, 2, 8, 16)         # loads in flight per thread, likewise


def plan(P, row_bytes, scheme: str):
    """(threads per block, loads in flight per thread) for P output rows
    over bank rows of ``row_bytes`` quantized bytes (a thread owns 16 of
    them: 16 int8 or 32 int4 values): 128 threads where that still gives
    every SM a block, else 64. Loads in flight where the grid holds 256
    threads per SM or more: 1 (int8) or 2 (int4), the fastest in a sweep
    of 1-16 at admission's shapes on an NVIDIA H100 80GB HBM3 at 700 W
    (``tools/agg_quant_probe.py --sweep``: within 4%, memory-bound); below
    that, where latency needs them, #1's measured rule (16 under 64
    threads per SM, else 8). Always one of ``THREADS`` x ``UNROLLS``."""
    check_scheme(scheme)
    nvec = row_bytes // 16
    threads = 128 if P * -(-nvec // 128) >= SMS else 64
    total = P * nvec
    if total < 64 * SMS:
        return threads, 16
    if total < 256 * SMS:
        return threads, 8
    return threads, 2 if scheme == "int4" else 1


def check_rows(q, scale, scheme: str, name: str = "q"):
    """Validate quantized rows q [..., m] with their fp16 scales (int8:
    [...]; int4: [..., n/g]) and return (n values per row, scales per
    row). Raises on a dtype, an odd int4 row or a group that does not
    divide the row."""
    check_scheme(scheme)
    if scheme == "none":
        raise ValueError("scheme 'none' has no quantized rows")
    if q.dtype != Q_DTYPES[scheme] or scale.dtype != torch.float16:
        raise TypeError(f"{name} must be {Q_DTYPES[scheme]} with float16 "
                        f"scales for {scheme}, got {q.dtype} / "
                        f"{scale.dtype}")
    lead = tuple(q.shape[:-1])
    if scheme == "int8":
        if tuple(scale.shape) != lead:
            raise ValueError(f"{name} int8 scales must be {lead}, got "
                             f"{tuple(scale.shape)}")
        return q.shape[-1], 1
    n, groups = 2 * q.shape[-1], scale.shape[-1] if scale.ndim else 0
    if tuple(scale.shape[:-1]) != lead or n < 2 or groups < 1 \
            or n % groups:
        raise ValueError(f"{name} int4 scales {tuple(scale.shape)} do not "
                         f"divide rows of {n} values into groups")
    return n, groups


def mask_aggregate_quant_batched(q, scale, idx, w, *, scheme: str):
    """q [N, d, b] int8 with scale [N, d], or planar int4 q [N, d, b/2]
    uint8 with scale [N, d, b/g] (fp16); idx [P, k] int32, w [P, k] fp32
    -> [P, d, b] fp32: out[p] = Σ_j w[p, j] · dequant(bank[idx[p, j]])."""
    if q.device.type in PLAIN_DEVICES:
        return ref.mask_aggregate_quant_batched_ref(q, scale, idx, w,
                                                    scheme=scheme)
    if q.device.type != "cuda":
        raise ValueError(f"no kernel for device {q.device}")
    n, groups = _check(q, scale, idx, w, scheme)
    P, k = idx.shape
    N, d = q.shape[:2]
    threads, unroll = plan(P, q[0].numel(), scheme)
    out = torch.empty((P, d, n), dtype=torch.float32, device=q.device)
    lib = load_library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.xpeft_mask_aggregate_quant_batched(
            q.data_ptr(), scale.data_ptr(), idx.data_ptr(), w.data_ptr(),
            out.data_ptr(), d, n, groups, P, k, N, int(scheme == "int4"),
            threads, unroll, stream)
    if err:
        raise RuntimeError(f"mask_aggregate_quant launch failed: CUDA "
                           f"error {err}")
    mask_aggregate_quant_batched.launches += 1
    return out


def _check(q, scale, idx, w, scheme: str):
    """Raise on operands the kernel does not take; return (values per
    sub-row, scales per sub-row)."""
    if q.ndim != 3:
        raise ValueError(f"q must be [N, d, m], got {tuple(q.shape)}")
    n, groups = check_rows(q, scale, scheme)
    if idx.ndim != 2 or tuple(w.shape) != tuple(idx.shape):
        raise ValueError(f"idx/w must both be [P, k], got "
                         f"{tuple(idx.shape)} / {tuple(w.shape)}")
    if idx.dtype != torch.int32 or w.dtype != torch.float32:
        raise TypeError(f"idx must be int32 and w float32, got "
                        f"{idx.dtype} / {w.dtype}")
    for name, t in (("q", q), ("scale", scale), ("idx", idx), ("w", w)):
        if t.device != q.device:
            raise ValueError(f"{name} on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    P, k = idx.shape
    if P < 1 or k > MAX_K:
        raise ValueError(f"need 1 <= P and k <= {MAX_K}, got {(P, k)}")
    N, d = q.shape[:2]
    if (d * q.shape[2]) % 16 or q.data_ptr() % 16:
        raise ValueError(f"quantized bank rows must be whole 16-byte "
                         f"vectors from a 16-byte aligned base, got "
                         f"{tuple(q.shape[1:])} at {q.data_ptr():#x}")
    return n, groups


mask_aggregate_quant_batched.launches = 0
