"""Plain PyTorch versions of the port's kernels (the allclose targets).

Twins of ``repro.kernels.ref``'s ``mask_aggregate_ref``,
``mask_aggregate_batched_ref``, ``fused_adapter_ref``,
``fused_adapter_batched_ref``, ``ia3_apply_batched_ref``,
``mask_aggregate_quant_batched_ref``,
``fused_adapter_quant_batched_ref`` and ``decode_block_ref`` (with the
per-slot math of ``repro.kernels.decode_fused.decode_block_row``), and
``hetero_adapter_batched_ref``, three of them composed as JAX's model
composes a heterogeneous entry's adapters. The quantized ones dequantize
through ``quant.schemes.dequant_block``. The CPU path of every wrapper,
the oracle ``chip_smoke.py`` holds each CUDA kernel to on the card, and,
under ``kernel_impl="ref"``, the end-to-end reference run.
Not a yardstick of speed: they repeat the kernels' arithmetic op by op.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.quant.schemes import dequant_block
from repro_torch.utils.cache_cast import to_cache_dtype

NEG_INF = -2.0e38

# adapter route -> the per-slot adapter leaves the decode block reads
ADAPTER_LEAVES = {
    "none": (),
    "bf16": ("a_hat", "b_hat", "ln_scale", "ln_bias"),
    "int8": ("a_q", "a_scale", "b_q", "b_scale", "ln_scale", "ln_bias"),
    "int4": ("a_q", "a_scale", "b_q", "b_scale", "ln_scale", "ln_bias"),
}

_ACTS = {
    "silu": F.silu,
    "gelu": lambda t: F.gelu(t, approximate="tanh"),
    "relu": F.relu,
    "sqrelu": lambda t: torch.square(F.relu(t)),
    "identity": lambda t: t,
}


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


def mask_aggregate_ref(bank, idx, w):
    """bank [N, d, b], idx [k], w [k] -> [d, b] fp32: the one-profile form
    of ``mask_aggregate_batched_ref``, with the same arithmetic."""
    return mask_aggregate_batched_ref(bank, idx[None], w[None])[0]


def fused_adapter_ref(x, a_hat, b_hat, ln_scale, ln_bias, *,
                      activation: str = "gelu", eps: float = 1e-6,
                      use_ln: bool = True):
    """x [T, d], a_hat [d, b], b_hat [b, d], ln_* [b] -> [T, d]: the
    unbatched form of ``fused_adapter_batched_ref``."""
    return fused_adapter_batched_ref(
        x[None], a_hat, b_hat, ln_scale, ln_bias, activation=activation,
        eps=eps, use_ln=use_ln)[0]


def ia3_apply_batched_ref(x, s):
    """x [B, T, d]; s [B, d] or shared [d] -> x * (1 + s) in x's dtype.

    fp32 inside: (1 + s) rounded once, times x rounded once, then one
    rounding to x's dtype — the CUDA kernel's exact arithmetic. s == 0 is
    bitwise x."""
    if s.ndim == 2:
        s = s[:, None, :]
    return (x.float() * (1.0 + s.float())).to(x.dtype)


def hetero_adapter_batched_ref(x, *, bottleneck=None, lora=None, ia3=None,
                               activation: str = "gelu"):
    """x [B, T, d] with any of ``bottleneck`` = (a_hat, b_hat, ln_scale,
    ln_bias), ``lora`` = (lora_a, lora_b) and ``ia3`` = s -> [B, T, d] in
    x's dtype: ``fused_adapter_batched_ref`` (with ``activation``), its
    LoRA route (no LN, identity) and ``ia3_apply_batched_ref``, composed
    in that order, each rounded to x's dtype — the hetero adapter
    launch's exact stages."""
    if bottleneck is not None:
        x = fused_adapter_batched_ref(x, *bottleneck, activation=activation)
    if lora is not None:
        x = fused_adapter_batched_ref(x, *lora, None, None,
                                      activation="identity", use_ln=False)
    if ia3 is not None:
        x = ia3_apply_batched_ref(x, ia3)
    return x


def mask_aggregate_quant_batched_ref(q, scale, idx, w, *, scheme: str):
    """Quantized bank rows q [N, d, b] int8 (or [N, d, b/2] packed int4)
    with scale [N, d] (or [N, d, b/g]) fp16, idx [P, k], w [P, k] ->
    [P, d, b] fp32.

    Each term is ``w · dequant_block(row)`` (exact products), summed in k
    order as a loop, not an einsum: a rounded multiply then a rounded add
    per term, the CUDA kernel's exact arithmetic."""
    P, k = idx.shape
    idx = idx.long()
    w = w.float()
    out = None
    for j in range(k):
        term = w[:, j, None, None] * dequant_block(q[idx[:, j]],
                                                   scale[idx[:, j]], scheme)
        out = term if out is None else out + term
    return out


def fused_adapter_quant_batched_ref(x, a_q, a_scale, b_q, b_scale, ln_scale,
                                    ln_bias, *, scheme: str,
                                    activation: str = "gelu",
                                    eps: float = 1e-6):
    """x [B, T, d]; per-row quantized a_q [B, d, b|b/2] with a_scale
    [B, d] / [B, d, b/g], b_q [B, b, d|d/2] with b_scale [B, b] /
    [B, b, d/g]; ln_* [B, b] -> [B, T, d] in x's dtype.

    y = x + act(LN(x·Â))·B̂ with Â/B̂ dequantized to fp32, LN over b
    (mean of squared deviations, eps 1e-6) always on, gelu in its tanh
    form; fp32 throughout and one rounding at the end."""
    x32 = x.float()
    h = x32 @ dequant_block(a_q, a_scale, scheme)
    mu = h.mean(-1, keepdim=True)
    var = torch.square(h - mu).mean(-1, keepdim=True)
    h = (h - mu) * torch.rsqrt(var + eps)
    h = h * ln_scale.float()[:, None, :] + ln_bias.float()[:, None, :]
    if activation == "gelu":
        h = F.gelu(h, approximate="tanh")
    y = h @ dequant_block(b_q, b_scale, scheme)
    return (x32 + y).to(x.dtype)


# ----------------------------------------------------------------------------
# decode block (the T=1 megakernel)
# ----------------------------------------------------------------------------

def _norm_row(t, scale, bias, kind: str, eps: float = 1e-6):
    """Row twin of ``models.common.norm_apply`` (same op order)."""
    t32 = t.float()
    if kind == "rmsnorm":
        var = torch.mean(t32 * t32, dim=-1, keepdim=True)
        y = t32 * torch.rsqrt(var + eps)
        return (y * (1.0 + scale.float())).to(t.dtype)
    mu = torch.mean(t32, dim=-1, keepdim=True)
    var = torch.var(t32, dim=-1, keepdim=True, correction=0)
    y = (t32 - mu) * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(t.dtype)


def rope_inv_freq(hd: int, theta: float, device):
    """RoPE frequencies 1/θ^(2i/hd), i < hd/2, in fp32 (JAX's op order;
    the CUDA kernel is handed this very table)."""
    exps = torch.arange(hd // 2, dtype=torch.float32, device=device) \
        * 2.0 / hd
    return 1.0 / torch.pow(theta, exps)


def attn_scale(hd: int) -> float:
    """1/sqrt(hd) computed in fp32, as JAX computes it."""
    return float(np.float32(1.0) / np.sqrt(np.float32(hd)))


def _dot(a, w):
    """a [..., K] · w [K, N] summed in fp32, rounded once to a's dtype."""
    return (a.float() @ w.float()).to(a.dtype)


def adapter_row(x, ad, adapter: str, adapter_act: str):
    """``decode_block_row``'s X-PEFT adapter on x2 [1, d] (route none
    returns x2): on route bf16 rounded at h and at y, on int8/int4 fp32
    from x2's bf16 value to one rounding of x2 + y."""
    dt = x.dtype
    if adapter == "bf16":
        hh = x.float() @ ad["a_hat"].float()
        mu = hh.mean(-1, keepdim=True)
        var = torch.square(hh - mu).mean(-1, keepdim=True)
        hh = (hh - mu) * torch.rsqrt(var + 1e-6)
        hh = hh * ad["ln_scale"].float() + ad["ln_bias"].float()
        if adapter_act == "gelu":
            hh = F.gelu(hh, approximate="tanh")
        y = hh.to(dt).float() @ ad["b_hat"].float()
        x = x + y.to(dt)
    elif adapter in ("int8", "int4"):
        x32 = x.float()
        hh = x32 @ dequant_block(ad["a_q"], ad["a_scale"], adapter)
        mu = hh.mean(-1, keepdim=True)
        var = torch.square(hh - mu).mean(-1, keepdim=True)
        hh = (hh - mu) * torch.rsqrt(var + 1e-6)
        hh = hh * ad["ln_scale"].float() + ad["ln_bias"].float()
        if adapter_act == "gelu":
            hh = F.gelu(hh, approximate="tanh")
        y = hh @ dequant_block(ad["b_q"], ad["b_scale"], adapter)
        x = (x32 + y).to(dt)
    return x


def decode_block_row(x, pos, n1, n2, attn, mlp, kc, vc, ad, *, norm: str,
                     qkv_bias: bool, use_rope: bool, theta: float,
                     cap: float, mlp_type: str, act_name: str,
                     adapter: str, adapter_act: str):
    """One slot's whole decode block: x [1, d], pos a 0-d integer tensor,
    kc/vc [S, KV, hd] cache rows, ad the slot's adapter leaves (or {}).

    Returns (y [1, d], k_row [KV, hd], v_row [KV, hd]), the K/V rows in
    the cache dtype. Rounds to x's dtype where the JAX row math does:
    after each norm, each projection, the bias add, RoPE, the softmax
    weights, w·V, the activation and the gate product, each residual add,
    and, on route bf16, in the adapter at h and at y. Sums are fp32.
    Routes int8/int4 dequantize Â/B̂ (``dequant_block``) and keep the
    adapter fp32 from the bf16 value of x to ONE rounding of x + y."""
    dt = x.dtype
    d = x.shape[-1]
    S, KV, hd = kc.shape
    H = attn["wq"].shape[1]
    G = H // KV
    act = _ACTS[act_name]
    dev = x.device

    # --- norm1 + QKV ------------------------------------------------------
    h = _norm_row(x, n1["scale"], n1.get("bias"), norm)
    q = _dot(h, attn["wq"].reshape(d, H * hd)).reshape(1, H, hd)
    k = _dot(h, attn["wk"].reshape(d, KV * hd)).reshape(1, KV, hd)
    v = _dot(h, attn["wv"].reshape(d, KV * hd)).reshape(1, KV, hd)
    if qkv_bias:
        q = q + attn["bq"].to(q.dtype)
        k = k + attn["bk"].to(k.dtype)
        v = v + attn["bv"].to(v.dtype)
    if use_rope:
        ang = pos.float() * rope_inv_freq(hd, theta, dev)  # [hd/2]
        cos, sin = torch.cos(ang), torch.sin(ang)

        def rope(t):
            t1, t2 = torch.chunk(t.float(), 2, dim=-1)
            return torch.cat([t1 * cos - t2 * sin, t1 * sin + t2 * cos],
                             dim=-1).to(t.dtype)

        q, k = rope(q), rope(k)

    # --- cached attention: the new row substituted at `pos`, after its
    # round trip through the cache dtype -----------------------------------
    k_row = to_cache_dtype(k[0], kc.dtype)                 # [KV, hd]
    v_row = to_cache_dtype(v[0], vc.dtype)
    at_pos = (torch.arange(S, device=dev) == pos)[:, None, None]
    keys = torch.where(at_pos, k_row.to(dt)[None], kc.to(dt))
    vals = torch.where(at_pos, v_row.to(dt)[None], vc.to(dt))
    keys = keys.permute(1, 0, 2)                           # [KV, S, hd]
    vals = vals.permute(1, 0, 2)
    qg = q.reshape(1, KV, G, hd).permute(1, 2, 0, 3)       # [KV, G, 1, hd]
    logits = torch.einsum("kgth,ksh->kgts", qg.float(), keys.float()) \
        * attn_scale(hd)
    if cap and cap > 0:
        logits = torch.tanh(logits / cap) * cap
    # causal + valid at T=1 collapse to k_pos <= pos
    logits = torch.where(torch.arange(S, device=dev) <= pos, logits,
                         NEG_INF)
    e = torch.exp(logits - logits.amax(-1, keepdim=True))
    w = e / e.sum(-1, keepdim=True)
    o = torch.einsum("kgts,ksh->kgth", w.to(dt).float(),
                     vals.float()).to(dt)
    o = o.permute(2, 0, 1, 3).reshape(1, H * hd)
    x = x + _dot(o, attn["wo"].reshape(H * hd, d))

    # --- norm2 + MLP ------------------------------------------------------
    h = _norm_row(x, n2["scale"], n2.get("bias"), norm)
    if mlp_type == "glu":
        g = _dot(h, mlp["wg"])
        u = _dot(h, mlp["wu"])
        x = x + _dot(act(g) * u, mlp["wd"])
    else:
        m = act(_dot(h, mlp["w1"]) + mlp["b1"].to(h.dtype))
        x = x + (_dot(m, mlp["w2"]) + mlp["b2"].to(h.dtype))

    # --- X-PEFT adapter ---------------------------------------------------
    x = adapter_row(x, ad, adapter, adapter_act)
    return x, k_row, v_row


def decode_block_ref(x, pos, block, k_cache, v_cache, masks_l, *, norm: str,
                     qkv_bias: bool, use_rope: bool, theta: float,
                     cap: float, mlp_type: str, act_name: str,
                     adapter: str, adapter_act: str):
    """x [B, 1, d], pos [B] int, block the layer's param dict, k/v_cache
    [B, S, KV, hd], masks_l the per-slot adapter leaves of route
    ``adapter`` -> (y [B, 1, d], k_rows [B, KV, hd], v_rows [B, KV, hd]).

    A loop over slots calling ``decode_block_row``, as the JAX oracle."""
    leaves = ADAPTER_LEAVES[adapter]
    ys, krs, vrs = [], [], []
    for i in range(x.shape[0]):
        ad_i = {nm: masks_l[nm][i] for nm in leaves}
        y, kr, vr = decode_block_row(
            x[i], pos[i], block["n1"], block["n2"], block["attn"],
            block["mlp"], k_cache[i], v_cache[i], ad_i, norm=norm,
            qkv_bias=qkv_bias, use_rope=use_rope, theta=theta, cap=cap,
            mlp_type=mlp_type, act_name=act_name, adapter=adapter,
            adapter_act=adapter_act)
        ys.append(y)
        krs.append(kr)
        vrs.append(vr)
    return torch.stack(ys), torch.stack(krs), torch.stack(vrs)
