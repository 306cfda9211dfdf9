"""Shared adapter bank: N Pfeiffer bottleneck adapters per PLM block.

The bank is ONE tensor per submodule, in ``repro.core.adapters``' layout:
``bank_a [L, N, d, b]`` (down-proj) and ``bank_b [L, N, b, d]`` (up-proj).
A heterogeneous ``bank_spec`` gets one leaf pair or vector per adapter
family instead (``init_hetero_bank``). Aggregation is a mask-bank
contraction (``aggregate_dense``, or ``aggregate_sparse`` over the k
selected rows); application is two products (``apply_adapter``; LoRA's
``apply_lora`` without the LN and activation) or IA3's elementwise scale
(``apply_ia3``). All are plain differentiable torch ops, as their JAX
twins are jnp einsums outside any Pallas kernel: training and per-step
serving run them.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def init_adapter_bank(num_layers: int, num_adapters: int, d: int, b: int,
                      dtype=torch.bfloat16, *, generator: torch.Generator,
                      device) -> dict:
    """Random adapter bank (the paper's LTH/supermask setting): down-proj
    N(0, 1/d), up-proj N(0, 0.02^2), drawn in fp32 on ``device`` one leaf
    at a time and cast once."""
    draw = _drawer(dtype, generator, device)
    return {"bank_a": draw((num_layers, num_adapters, d, b),
                           1.0 / math.sqrt(d)),
            "bank_b": draw((num_layers, num_adapters, b, d), 0.02)}


def _drawer(dtype, generator, device):
    def draw(shape, scale):
        w = torch.randn(shape, generator=generator, device=device,
                        dtype=torch.float32)
        return w.mul_(scale).to(dtype)
    return draw


def init_hetero_bank(num_layers: int, xp, d: int, kv_dim: int,
                     dtype=torch.bfloat16, *, generator: torch.Generator,
                     device) -> dict:
    """Typed-segment bank for a heterogeneous ``bank_spec`` (the twin of
    ``repro.core.adapters.init_hetero_bank``): one leaf pair or vector per
    family, each spanning only its segment's rows of the unified mask index
    space (``xp.segments()``), with the same shapes and init statistics:

    - bottleneck: ``bank_a [L, N_bn, d, b]`` / ``bank_b [L, N_bn, b, d]``;
    - lora: ``lora_a [L, N_lo, d, b]`` (N(0, 1/d)) / ``lora_b
      [L, N_lo, b, d]`` (N(0, 0.02^2)), rank b, no LN, no activation;
    - ia3: ``ia3_v [L, N_i3, d]`` scale DELTAS (N(0, 0.02^2)): applied as
      ``x * (1 + s)``, so an empty selection is exactly the identity;
    - prefix: ``prefix_k`` / ``prefix_v [L, N_pf, P, kv_dim]``
      (N(0, 0.02^2)), P = ``xp.prefix_tokens`` post-RoPE KV rows a slot.
    """
    b = xp.bottleneck
    kw = dict(generator=generator, device=device)
    draw = _drawer(dtype, generator, device)
    bank = {}
    for t, _, cnt in xp.segments():
        if t == "bottleneck":
            bank.update(init_adapter_bank(num_layers, cnt, d, b, dtype,
                                          **kw))
        elif t == "lora":
            bank["lora_a"] = draw((num_layers, cnt, d, b),
                                  1.0 / math.sqrt(d))
            bank["lora_b"] = draw((num_layers, cnt, b, d), 0.02)
        elif t == "ia3":
            bank["ia3_v"] = draw((num_layers, cnt, d), 0.02)
        elif t == "prefix":
            shape = (num_layers, cnt, xp.prefix_tokens, kv_dim)
            bank["prefix_k"] = draw(shape, 0.02)
            bank["prefix_v"] = draw(shape, 0.02)
    return bank


def aggregate_dense(bank_l: dict, w_a, w_b):
    """Dense aggregation for one layer.

    bank_l: {"bank_a": [N, d, b], "bank_b": [N, b, d]}; w_a, w_b: [..., N]
    mask weights (soft, or straight-through hard in training), cast to the
    bank's dtype first, as JAX's einsum takes them. Returns
    (A_hat [..., d, b], B_hat [..., b, d]) in the bank's dtype."""
    bank_a, bank_b = bank_l["bank_a"], bank_l["bank_b"]
    a_hat = torch.einsum("...n,ndb->...db", w_a.to(bank_a.dtype), bank_a)
    b_hat = torch.einsum("...n,nbd->...bd", w_b.to(bank_b.dtype), bank_b)
    return a_hat, b_hat


def aggregate_sparse(bank_l: dict, idx_a, w_a, idx_b, w_b):
    """k-sparse aggregation: gather only the k selected adapters.

    idx_*: [..., k] int, w_*: [..., k]. The plain twin of the aggregation
    kernel, reading N/k less of the bank than ``aggregate_dense``."""
    bank_a, bank_b = bank_l["bank_a"], bank_l["bank_b"]
    ga = bank_a[idx_a.long()]                           # [..., k, d, b]
    gb = bank_b[idx_b.long()]                           # [..., k, b, d]
    a_hat = torch.einsum("...k,...kdb->...db", w_a.to(bank_a.dtype), ga)
    b_hat = torch.einsum("...k,...kbd->...bd", w_b.to(bank_b.dtype), gb)
    return a_hat, b_hat


def _ln(x, scale, bias, eps: float = 1e-6):
    x32 = x.float()
    mu = x32.mean(-1, keepdim=True)
    var = x32.var(-1, keepdim=True, correction=0)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    return (y * scale + bias).to(x.dtype)


def apply_adapter(x, a_hat, b_hat, ln_scale, ln_bias,
                  activation: str = "gelu"):
    """Bottleneck adapter with the paper's LN after the down-projection:
    x [..., T, d]; a_hat [..., d, b] or [d, b]; returns
    x + B̂(act(LN(Â x))). ``activation='identity'`` is the literal paper
    formula; ``gelu`` is the tanh form, as ``jax.nn.gelu``'s default."""
    h = torch.matmul(x, a_hat)
    h = _ln(h, ln_scale, ln_bias)
    if activation == "gelu":
        h = F.gelu(h, approximate="tanh")
    y = torch.matmul(h, b_hat)
    return x + y.to(x.dtype)


def apply_lora(x, a_hat, b_hat):
    """LoRA delta: x + B̂(Â x), no LN and no inner activation. Â/B̂ have
    the bottleneck aggregate's shapes ([d, b]/[b, d], or batched)."""
    y = torch.matmul(torch.matmul(x, a_hat), b_hat)
    return x + y.to(x.dtype)


def apply_ia3(x, s):
    """IA3 scaling: x * (1 + s) in fp32, with s the mask-weighted sum of
    scale DELTAS ([d] or batched [..., d], broadcast over T); s == 0 (an
    empty selection, degraded serving) multiplies by exactly 1.0."""
    if s.ndim > 1:
        s = s[..., None, :]          # [..., 1, d] broadcast over T
    return (x.float() * (1.0 + s.float())).to(x.dtype)
