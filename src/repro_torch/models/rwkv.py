"""RWKV6 (Finch) block: time-mix with data-dependent decay + channel-mix.

The port of ``repro.models.rwkv``: static token-shift mixing coefficients
(``mu``) per projection, a LoRA-parameterised data-dependent per-channel
decay (w = -exp(w0 + tanh(x @ dec_a) @ dec_b), in fp32), a per-head bonus
``u``, head-wise normalisation (fp32, cast back), a silu output gate and
the squared-ReLU channel-mix. The wkv engine is the shared chunked GLA
(``linear_attn.py``): T=1 with a state takes ``gla_decode_step``, every
other call ``gla_chunked``. Both norms of the block are RMSNorm whatever
``cfg.norm`` says, as in JAX.

Decode state per layer: ``tm_last`` and ``cm_last`` [B, d] (the NORMED
last row, the input of time-mix and channel-mix; the cache dtype) and
``wkv`` [B, H, hd, hd] (fp32). ``rwkv_block`` returns the new state as
fresh tensors; the model writes them into the cache leaves in place.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.common import dense_init, rmsnorm
from repro_torch.models.linear_attn import gla_chunked, gla_decode_step

DECAY_LORA = 64


def init_rwkv_block(cfg, dtype, *, generator: torch.Generator,
                    device) -> dict:
    """JAX's shapes, dtypes and distributions from the port's generator."""
    d, ff = cfg.d_model, cfg.d_ff
    H, hd = cfg.num_heads, cfg.head_dim
    kw = dict(generator=generator, device=device)
    f32 = torch.float32
    return {
        # time-mix
        "mu": 0.5 * torch.ones((5, d), dtype=f32, device=device),  # r,k,v,w,g
        "rwr": dense_init((d, H * hd), d, dtype, **kw),
        "rwk": dense_init((d, H * hd), d, dtype, **kw),
        "rwv": dense_init((d, H * hd), d, dtype, **kw),
        "rwg": dense_init((d, H * hd), d, dtype, **kw),
        "rwo": dense_init((H * hd, d), H * hd, dtype, **kw),
        "w0": torch.full((H, hd), -1.0, dtype=f32, device=device),
        "dec_a": dense_init((d, DECAY_LORA), d, f32, **kw),
        "dec_b": 0.01 * torch.randn((DECAY_LORA, H * hd), dtype=f32, **kw),
        "u": 0.5 * torch.randn((H, hd), dtype=f32, **kw),
        "ln_x_scale": torch.ones((H, hd), dtype=f32, device=device),
        # channel-mix
        "cmu": 0.5 * torch.ones((2, d), dtype=f32, device=device),  # k, r
        "cw_k": dense_init((d, ff), d, dtype, **kw),
        "cw_v": dense_init((ff, d), ff, dtype, **kw),
        "cw_r": dense_init((d, d), d, dtype, **kw),
    }


def init_rwkv_state(batch, cfg, dtype=torch.float32, *, lead=(),
                    device) -> dict:
    """Zero state with leading dims ``lead`` (the model stacks L)."""
    H, hd, d = cfg.num_heads, cfg.head_dim, cfg.d_model
    lead = tuple(lead)
    return {
        "tm_last": torch.zeros(lead + (batch, d), dtype=dtype, device=device),
        "cm_last": torch.zeros(lead + (batch, d), dtype=dtype, device=device),
        "wkv": torch.zeros(lead + (batch, H, hd, hd), dtype=torch.float32,
                           device=device),
    }


def _shift(x, last):
    """Token shift: x[t-1] with ``last`` at t=0. x [B,T,d], last [B,d]."""
    return torch.cat([last[:, None, :].to(x.dtype), x[:, :-1]], dim=1)


def _decay(p, xw):
    raw = p["w0"].reshape(-1) + torch.tanh(xw.float() @ p["dec_a"]) \
        @ p["dec_b"]
    return -torch.exp(raw)  # log-decay <= 0, data-dependent (Finch)


def _headwise_norm(o, scale):
    # per-head RMS norm over head_dim (stand-in for RWKV's GroupNorm)
    var = torch.mean(torch.square(o.float()), dim=-1, keepdim=True)
    return (o * torch.rsqrt(var + 1e-6) * scale).to(o.dtype)


def time_mix(p, x, cfg, state=None):
    """x [B,T,d] (normed) -> (y, {"tm_last", "wkv"})."""
    B, T, d = x.shape
    H, hd = cfg.num_heads, cfg.head_dim
    last = state["tm_last"] if state is not None else \
        torch.zeros((B, d), dtype=x.dtype, device=x.device)
    prev = _shift(x, last)
    mu = p["mu"].to(x.dtype)
    xr, xk, xv, xw, xg = (x + (prev - x) * mu[i] for i in range(5))

    def heads(t):
        return t.reshape(B, T, H, hd).transpose(1, 2)

    r, k, v = heads(xr @ p["rwr"]), heads(xk @ p["rwk"]), heads(xv @ p["rwv"])
    g = xg @ p["rwg"]
    lw = heads(_decay(p, xw))

    wkv0 = state["wkv"] if state is not None else None
    if T == 1 and state is not None:
        o, wkv = gla_decode_step(r[:, :, 0], k[:, :, 0], v[:, :, 0],
                                 lw[:, :, 0], wkv0, bonus=p["u"])
        o = o[:, :, None, :]
    else:
        o, wkv = gla_chunked(r, k, v, lw, chunk=min(cfg.la_chunk, T),
                             bonus=p["u"], state=wkv0)
    o = _headwise_norm(o, p["ln_x_scale"][:, None, :])
    o = o.transpose(1, 2).reshape(B, T, H * hd)
    y = (o * F.silu(g)) @ p["rwo"]
    return y, {"tm_last": x[:, -1, :], "wkv": wkv}


def channel_mix(p, x, state=None):
    B, T, d = x.shape
    last = state["cm_last"] if state is not None else \
        torch.zeros((B, d), dtype=x.dtype, device=x.device)
    prev = _shift(x, last)
    cmu = p["cmu"].to(x.dtype)
    xk = x + (prev - x) * cmu[0]
    xr = x + (prev - x) * cmu[1]
    kk = torch.square(F.relu(xk @ p["cw_k"]))
    y = torch.sigmoid(xr @ p["cw_r"]) * (kk @ p["cw_v"])
    return y, {"cm_last": x[:, -1, :]}


def rwkv_block(p, x, cfg, norms, state=None):
    """The pre-norm RWKV6 block. norms: {"n1", "n2"} RMSNorm params.
    Returns (x', new state {"tm_last", "wkv", "cm_last"})."""
    h, st_tm = time_mix(p, rmsnorm(x, norms["n1"]["scale"]), cfg, state)
    x = x + h
    h, st_cm = channel_mix(p, rmsnorm(x, norms["n2"]["scale"]), state)
    x = x + h
    return x, {**st_tm, **st_cm}
