"""Shared model primitives: norms, RoPE, activations, initializers.

Numerics follow ``repro.models.common`` op for op: norms compute in fp32
and cast back once; RMSNorm multiplies by ``(1 + scale)`` with ``scale``
initialised to 0 (not HF's convention); variance is the population
variance; RoPE rotates halves (not interleaved pairs) with fp32 angles.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def dense_init(shape, in_axis_size, dtype=torch.bfloat16, *,
               generator: torch.Generator, device) -> torch.Tensor:
    """Fan-in normal init: N(0, 1) / sqrt(fan_in) drawn in fp32, cast once.

    The numbers differ from JAX's for the same seed (another generator);
    the tests carry JAX's weights across through ``repro_torch.bridge``."""
    w = torch.randn(shape, generator=generator, device=device,
                    dtype=torch.float32)
    return (w / math.sqrt(in_axis_size)).to(dtype)


def rmsnorm(x, scale, eps: float = 1e-6):
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * (1.0 + scale.float())).to(x.dtype)


def layernorm(x, scale, bias, eps: float = 1e-6):
    x32 = x.float()
    mu = torch.mean(x32, dim=-1, keepdim=True)
    var = torch.var(x32, dim=-1, keepdim=True, correction=0)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(x.dtype)


def norm_apply(x, params, kind: str):
    if kind == "rmsnorm":
        return rmsnorm(x, params["scale"])
    return layernorm(x, params["scale"], params["bias"])


def init_norm(kind: str, d: int, *, device, dtype=torch.float32) -> dict:
    if kind == "rmsnorm":
        return {"scale": torch.zeros((d,), dtype=dtype, device=device)}
    return {"scale": torch.ones((d,), dtype=dtype, device=device),
            "bias": torch.zeros((d,), dtype=dtype, device=device)}


def activation(name: str):
    """``gelu`` is the tanh form, as ``jax.nn.gelu``'s default."""
    return {"silu": F.silu,
            "gelu": lambda x: F.gelu(x, approximate="tanh"),
            "relu": F.relu,
            "sqrelu": lambda x: torch.square(F.relu(x)),
            "identity": lambda x: x}[name]


# ----------------------------------------------------------------------------
# RoPE
# ----------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, device) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (torch.tensor(theta, dtype=torch.float32,
                               device=device) ** exps)


def apply_rope(x, positions, theta: float = 10000.0):
    """x: [B, T, H, hd]; positions: [B, T] integer."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)                   # [hd/2]
    ang = positions[..., None].float() * freqs                # [B, T, hd/2]
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def softcap(logits, cap: float):
    if cap and cap > 0:
        return torch.tanh(logits / cap) * cap
    return logits
