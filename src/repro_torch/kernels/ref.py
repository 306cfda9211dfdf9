"""Plain PyTorch versions of the port's kernels (the allclose targets).

Twins of ``repro.kernels.ref``'s ``mask_aggregate_batched_ref`` and
``fused_adapter_batched_ref``. The CPU path of every wrapper, the oracle
``chip_smoke.py`` holds each CUDA kernel to on the card, and, under
``kernel_impl="ref"``, the end-to-end reference run. Not a yardstick of
speed: they repeat the kernels' arithmetic op by op.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def mask_aggregate_batched_ref(bank, idx, w):
    """bank [N, d, b], idx [P, k], w [P, k] -> [P, d, b] fp32.

    Σ_j w[p, j] · bank[idx[p, j]] accumulated in fp32 in j order, each
    term a rounded multiply then a rounded add — the CUDA kernel's exact
    arithmetic (it never fuses them into an FMA)."""
    P, k = idx.shape
    out = torch.zeros((P,) + tuple(bank.shape[1:]), dtype=torch.float32,
                      device=bank.device)
    idx = idx.long()
    w = w.float()
    for j in range(k):
        out = out + w[:, j, None, None] * bank[idx[:, j]].float()
    return out


def fused_adapter_batched_ref(x, a_hat, b_hat, ln_scale, ln_bias, *,
                              activation: str = "gelu", eps: float = 1e-6,
                              use_ln: bool = True):
    """x [B, T, d]; a_hat [B, d, b] or shared [d, b]; b_hat [B, b, d] or
    [b, d]; ln_* [B, b] or [b] -> [B, T, d] in x's dtype.

    y = x + act(LN(x·Â))·B̂ in fp32 with one rounding at the end; LN over
    b with the population variance; gelu in its tanh form.
    ``use_ln=False`` with the identity is the LoRA route."""
    x32 = x.float()
    h = x32 @ a_hat.float()
    if use_ln:
        mu = h.mean(-1, keepdim=True)
        var = h.var(-1, keepdim=True, correction=0)
        h = (h - mu) * torch.rsqrt(var + eps)
        ls, lb = ln_scale.float(), ln_bias.float()
        if ls.ndim == 2:
            ls, lb = ls[:, None, :], lb[:, None, :]
        h = h * ls + lb
    if activation == "gelu":
        h = F.gelu(h, approximate="tanh")
    y = h @ b_hat.float()
    return (x32 + y).to(x.dtype)
