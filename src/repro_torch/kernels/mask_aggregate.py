"""CUDA kernel wrappers: k-sparse adapter-bank aggregation, batched and
for one profile.

Replaces the Pallas TPU kernels ``src/repro/kernels/mask_aggregate.py:74``
(``mask_aggregate_batched``) and ``:47`` (``mask_aggregate``, the P=1
form, run on the same kernel). The kernel (``csrc/mask_aggregate.cu``) is
bound by bytes on the H100: it reads the selected bank rows of nonzero
weight once and writes the fp32 output once, for about half a flop per
byte. What keeps it from that bound is memory latency: the design drops
terms of weight 0 (no bit changes), compacts the block's own indices into
shared memory in k order, keeps ``unroll`` 16-byte loads in flight per
thread before folding them in k order (fp32, rounded multiply then
rounded add: bitwise equal to the plain version), and sizes its blocks
and its loads in flight (``plan``) so that small P or short rows still
spread over the SMs with enough bytes in flight. The source describes it
in full.

On a CPU tensor each wrapper computes the plain version
(``kernels/ref.py``); on a CUDA tensor it launches the kernel or raises.
``mask_aggregate_batched.launches`` and ``mask_aggregate.launches`` count
kernel launches, each of its own entry point.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ref
from repro_torch.kernels._build import load_library
from repro_torch.utils import PLAIN_DEVICES

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_K = 1024
SMS = 132                       # streaming multiprocessors of an H100 SXM
THREADS = (64, 128)             # block sizes the kernel is built for
UNROLLS = (8, 16, 32)           # loads in flight per thread, likewise


def plan(P, row, itemsize):
    """(threads per block, loads in flight per thread) for P output rows
    of ``row`` values of ``itemsize`` bytes, chosen by measurement on the
    H100: 128 threads where that still gives every SM a block, else 64;
    32 loads in flight per thread where the grid holds fewer than 64
    threads per SM, 16 where it holds fewer than 256, else 8. Always one
    of ``THREADS`` x ``UNROLLS``."""
    nvec = row // (16 // itemsize)
    threads = 128 if P * -(-nvec // 128) >= SMS else 64
    total = P * nvec
    unroll = 32 if total < 64 * SMS else 16 if total < 256 * SMS else 8
    return threads, unroll


def _check(bank, idx, w):
    if bank.ndim != 3:
        raise ValueError(f"bank must be [N, d, b], got {tuple(bank.shape)}")
    if idx.ndim != 2 or tuple(w.shape) != tuple(idx.shape):
        raise ValueError(f"idx/w must both be [P, k], got "
                         f"{tuple(idx.shape)} / {tuple(w.shape)}")
    if bank.dtype not in _DTYPES:
        raise TypeError(f"bank dtype {bank.dtype} not in {list(_DTYPES)}")
    if idx.dtype != torch.int32 or w.dtype != torch.float32:
        raise TypeError(f"idx must be int32 and w float32, got "
                        f"{idx.dtype} / {w.dtype}")
    for name, t in (("bank", bank), ("idx", idx), ("w", w)):
        if t.device != bank.device:
            raise ValueError(f"{name} on {t.device}, bank on {bank.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if idx.shape[0] < 1 or idx.shape[1] > MAX_K:
        raise ValueError(f"need 1 <= P and k <= {MAX_K}, got "
                         f"{tuple(idx.shape)}")
    vec = 16 // bank.element_size()
    if (bank.shape[1] * bank.shape[2]) % vec or bank.data_ptr() % 16:
        raise ValueError(f"bank rows must be whole 16-byte vectors ({vec} "
                         f"values) from a 16-byte aligned base, got "
                         f"{tuple(bank.shape[1:])} at {bank.data_ptr():#x}")


def mask_aggregate_batched(bank, idx, w):
    """bank [N, d, b] (bf16/fp32), idx [P, k] int32, w [P, k] fp32 ->
    [P, d, b] fp32: out[p] = Σ_j w[p, j] · bank[idx[p, j]]."""
    if bank.device.type in PLAIN_DEVICES:
        return ref.mask_aggregate_batched_ref(bank, idx, w)
    out = _launch(bank, idx, w)
    mask_aggregate_batched.launches += 1
    return out


def mask_aggregate(bank, idx, w):
    """The one-profile form (replaces the Pallas TPU kernel
    ``src/repro/kernels/mask_aggregate.py:47``, ``mask_aggregate``):
    bank [N, d, b], idx [k] int32, w [k] fp32 -> [d, b] fp32, the batched
    kernel at P=1 on views of idx/w (no copy).
    ``mask_aggregate.launches`` counts its launches."""
    if bank.device.type in PLAIN_DEVICES:
        return ref.mask_aggregate_ref(bank, idx, w)
    if idx.ndim != 1 or w.ndim != 1:
        raise ValueError(f"idx/w must both be [k], got {tuple(idx.shape)} "
                         f"/ {tuple(w.shape)}")
    out = _launch(bank, idx[None], w[None])[0]
    mask_aggregate.launches += 1
    return out


def _launch(bank, idx, w):
    """Check the operands and launch on bank's device (uncounted), with
    ``plan``'s block size and loads in flight."""
    if bank.device.type != "cuda":
        raise ValueError(f"no kernel for device {bank.device}")
    _check(bank, idx, w)
    N = bank.shape[0]
    row = bank.shape[1] * bank.shape[2]
    P, k = idx.shape
    threads, unroll = plan(P, row, bank.element_size())
    out = torch.empty((P,) + tuple(bank.shape[1:]), dtype=torch.float32,
                      device=bank.device)
    lib = load_library()
    with torch.cuda.device(bank.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.xpeft_mask_aggregate_batched(
            bank.data_ptr(), idx.data_ptr(), w.data_ptr(), out.data_ptr(),
            row, P, k, N, _DTYPES[bank.dtype], threads, unroll, stream)
    if err:
        raise RuntimeError(f"mask_aggregate launch failed: CUDA error {err}")
    return out


mask_aggregate_batched.launches = 0
mask_aggregate.launches = 0
