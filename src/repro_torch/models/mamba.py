"""Mamba2 (SSD) block on the shared chunked-GLA engine.

The port of ``repro.models.mamba``: a fused in_proj -> (z, x, B, C, dt),
a causal depthwise conv over (x, B, C) summed tap by tap in x's dtype,
the per-head scalar decay a_t = -exp(A_log) * softplus(dt + dt_bias)
(fp32), the SSD recurrence through ``linear_attn`` (B and C broadcast
across heads, ngroups = 1), the D skip, the gated RMSNorm
norm(y * silu(z)) and out_proj.

Decode state per layer: ``conv`` [B, K-1, conv_dim] (the conv's tail, in
the cache dtype) and ``ssd`` [B, H, n, p] (fp32; n = ssm_state, p = the
head dim). ``mamba_block`` returns the new state as fresh tensors; the
model writes them into the cache leaves in place.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.common import dense_init, rmsnorm
from repro_torch.models.linear_attn import gla_chunked, gla_decode_step

CONV_K = 4


def dims(cfg):
    d_inner = 2 * cfg.d_model
    nheads = d_inner // cfg.mamba_headdim
    conv_dim = d_inner + 2 * cfg.ssm_state
    return d_inner, nheads, conv_dim


def init_mamba_block(cfg, dtype, *, generator: torch.Generator,
                     device) -> dict:
    """JAX's shapes, dtypes and distributions from the port's generator."""
    d = cfg.d_model
    d_inner, nheads, conv_dim = dims(cfg)
    n = cfg.ssm_state
    kw = dict(generator=generator, device=device)
    f32 = torch.float32
    in_dim = 2 * d_inner + 2 * n + nheads
    return {
        "in_proj": dense_init((d, in_dim), d, dtype, **kw),
        "conv_w": 0.1 * torch.randn((CONV_K, conv_dim), dtype=f32, **kw),
        "conv_b": torch.zeros((conv_dim,), dtype=f32, device=device),
        "A_log": torch.log(torch.linspace(1.0, 16.0, nheads, dtype=f32,
                                          device=device)),
        "dt_bias": torch.zeros((nheads,), dtype=f32, device=device),
        "D": torch.ones((nheads,), dtype=f32, device=device),
        "gn_scale": torch.ones((d_inner,), dtype=f32, device=device),
        "out_proj": dense_init((d_inner, d), d_inner, dtype, **kw),
    }


def init_mamba_state(batch, cfg, dtype=torch.float32, *, lead=(),
                     device) -> dict:
    """Zero state with leading dims ``lead`` (the model stacks L)."""
    _, nheads, conv_dim = dims(cfg)
    lead = tuple(lead)
    return {
        "conv": torch.zeros(lead + (batch, CONV_K - 1, conv_dim),
                            dtype=dtype, device=device),
        "ssd": torch.zeros(lead + (batch, nheads, cfg.ssm_state,
                                   cfg.mamba_headdim),
                           dtype=torch.float32, device=device),
    }


def _causal_conv(u, w, b, tail=None):
    """Depthwise causal conv. u [B,T,C], w [K,C]; tail [B,K-1,C] carried
    over. The taps sum in order, 0 + t0 + t1 + ..., in u's dtype, then the
    bias. Returns (out, new tail)."""
    B, T, C = u.shape
    K = w.shape[0]
    if tail is None:
        tail = torch.zeros((B, K - 1, C), dtype=u.dtype, device=u.device)
    ext = torch.cat([tail.to(u.dtype), u], dim=1)      # [B, T+K-1, C]
    out = sum(ext[:, i:i + T, :] * w[i].to(u.dtype) for i in range(K))
    out = out + b.to(u.dtype)
    return out, ext[:, -(K - 1):, :]


def mamba_block(p, x, cfg, norms, state=None):
    """The pre-norm Mamba2 block: x [B,T,d] -> (x', {"conv", "ssd"})."""
    B, T, d = x.shape
    d_inner, nheads, _ = dims(cfg)
    n, hp = cfg.ssm_state, cfg.mamba_headdim

    h = rmsnorm(x, norms["n1"]["scale"])
    zxbcdt = h @ p["in_proj"]
    z, xc, dt = torch.split(zxbcdt, [d_inner, d_inner + 2 * n, nheads],
                            dim=-1)

    tail = state["conv"] if state is not None else None
    xc, new_tail = _causal_conv(xc, p["conv_w"], p["conv_b"], tail)
    xc = F.silu(xc)
    xs, Bm, Cm = torch.split(xc, [d_inner, n, n], dim=-1)

    # softplus as jax.nn.softplus computes it: logaddexp(x, 0)
    dt = dt.float() + p["dt_bias"]
    dt = torch.logaddexp(dt, torch.zeros((), dtype=dt.dtype,
                                         device=dt.device))   # [B,T,H]
    lw_h = -torch.exp(p["A_log"]) * dt                        # [B,T,H] <= 0

    v = xs.reshape(B, T, nheads, hp) * dt[..., None].to(xs.dtype)
    v = v.transpose(1, 2)                                     # [B,H,T,p]
    q = Cm[:, None].expand(B, nheads, T, n)
    k = Bm[:, None].expand(B, nheads, T, n)
    lw = lw_h.transpose(1, 2)[..., None].expand(B, nheads, T, n)

    ssd0 = state["ssd"] if state is not None else None
    if T == 1 and state is not None:
        o, ssd = gla_decode_step(q[:, :, 0], k[:, :, 0], v[:, :, 0],
                                 lw[:, :, 0], ssd0)
        o = o[:, :, None, :]
    else:
        o, ssd = gla_chunked(q, k, v, lw, chunk=min(cfg.la_chunk, T),
                             state=ssd0)

    y = o + p["D"][None, :, None, None].to(o.dtype) * v
    y = y.transpose(1, 2).reshape(B, T, d_inner)
    # gated RMSNorm (Mamba2): norm(y * silu(z))
    y = y * F.silu(z)
    var = torch.mean(torch.square(y.float()), dim=-1, keepdim=True)
    y = (y * torch.rsqrt(var + 1e-6)).to(x.dtype) * p["gn_scale"].to(x.dtype)
    out = y @ p["out_proj"]
    return x + out, {"conv": new_tail, "ssd": ssd}
