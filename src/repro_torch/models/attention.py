"""Attention: MHA/GQA/MQA with RoPE, a sliding-window/global mix, a KV
cache and long-sequence chunking.

The counterpart of ``repro.models.attention.attention``, causal (decoders)
or bidirectional (the encoder), full or ``sliding_mix`` (gemma3: a local
layer masks keys ``window`` or more positions behind the query, a global
layer takes an effectively infinite window, ``2**30``): the
cacheless self-attention, the cache write at a scalar ``cache_pos`` and
at a per-slot vector ``cache_pos``, the dense softmax over the whole
``[T, S]`` logits, and, where JAX takes it (T > ``q_chunk``, T a multiple
of ``q_chunk`` and S of ``k_chunk``, no ``front_skip``), the chunked
online softmax ``_sdpa_chunked``: query chunks, each over key chunks with
a running max and an fp32 accumulator, so the ``[T, S]`` logits never
exist at once. Both are plain torch ops, as JAX computes them outside any
Pallas kernel. ``front_skip`` (serving over prefix KV rows hydrated into
the cache) and ``extra_kv`` (the prefix rows of the dense training path,
un-rotated in front of the example's own keys) are ported. The window
is a term of the positional mask on every path, the chunked one
included, as JAX applies it: hydrated prefix rows at key positions [0,
P) are windowed like any other key.

Unlike the functional JAX cache, the port writes the cache IN PLACE (one
KV cache per engine instead of a fresh copy per layer-step) and returns
the same dict.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.models.common import apply_rope, dense_init, softcap
from repro_torch.utils.cache_cast import to_cache_dtype

NEG_INF = -2.0e38


def init_attention(cfg, dtype, *, generator: torch.Generator, device) -> dict:
    d, H, KV, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    kw = dict(generator=generator, device=device)
    p = {
        "wq": dense_init((d, H, hd), d, dtype, **kw),
        "wk": dense_init((d, KV, hd), d, dtype, **kw),
        "wv": dense_init((d, KV, hd), d, dtype, **kw),
        "wo": dense_init((H, hd, d), H * hd, dtype, **kw),
    }
    if cfg.qkv_bias:
        p["bq"] = torch.zeros((H, hd), dtype=torch.float32, device=device)
        p["bk"] = torch.zeros((KV, hd), dtype=torch.float32, device=device)
        p["bv"] = torch.zeros((KV, hd), dtype=torch.float32, device=device)
    return p


def _mask(q_pos, k_pos, *, causal, kv_valid, window=None, front_skip=None,
          k_idx=None):
    """q_pos [B,Tq], k_pos [S] or [B,S], kv_valid [B] -> bool [B,Tq,S].

    ``window`` (None: no window) keeps the keys with ``q_pos - k_pos <
    window``.
    ``front_skip [B]`` masks the first ``front_skip[b]`` key buffer slots:
    the per-example gate of prefix KV rows at the front of the cache (an
    example whose profile selected no prefix slot at this layer attends
    exactly the bare sequence, not P zero rows diluting the softmax).
    Where k_pos is per example [B,S] (the prefix path: positions differ
    per example), ``k_idx [S]`` carries the buffer slot index that
    kv_valid and front_skip gate on; the causal mask uses k_pos."""
    qp = q_pos[:, :, None]
    kp = k_pos[None, None, :] if k_pos.ndim == 1 else k_pos[:, None, :]
    ki = kp if k_idx is None else k_idx[None, None, :]
    m = ki < kv_valid.reshape(-1, 1, 1)
    if front_skip is not None:
        m = m & (ki >= front_skip.reshape(-1, 1, 1))
    if causal:
        m = m & (kp <= qp)
    if window is not None:
        m = m & (qp - kp < window)
    return m


def _sdpa_dense(q, k, v, mask, scale, cap):
    """q [B,KV,G,Tq,hd], k/v [B,KV,S,hd], mask [B,Tq,S].

    Logits accumulate in fp32 (JAX's ``preferred_element_type``): the
    inputs are upcast first, so bf16 products are exact in fp32."""
    logits = torch.einsum("bkgth,bksh->bkgts", q.float(), k.float()) * scale
    logits = softcap(logits, cap)
    logits = torch.where(mask[:, None, None], logits,
                         torch.tensor(NEG_INF, dtype=torch.float32,
                                      device=logits.device))
    w = torch.softmax(logits, dim=-1)
    return torch.einsum("bkgts,bksh->bkgth", w.to(v.dtype), v)


def _sdpa_chunked(q, k, v, q_pos, k_pos, *, causal, kv_valid, scale, cap,
                  q_chunk, k_chunk, window=None):
    """Online softmax over key chunks, for each query chunk in turn (JAX's
    ``_sdpa_chunked``, the ``lax.scan`` pair as two loops): q [B,KV,G,Tq,
    hd], k/v [B,KV,S,hd], q_pos [B,Tq], k_pos [S]; Tq a multiple of
    ``q_chunk`` and S of ``k_chunk``. Logits and the accumulator in fp32,
    ``p`` cast to v's dtype before the AV product, the row sum floored at
    1e-30. The window masks inside each chunk pair; no chunk is skipped,
    as in JAX."""
    B, KV, G, Tq, _ = q.shape
    S, dv = k.shape[2], v.shape[-1]
    neg = torch.tensor(NEG_INF, dtype=torch.float32, device=q.device)
    outs = []
    for i in range(0, Tq, q_chunk):
        qi = q[:, :, :, i:i + q_chunk].float()
        qpi = q_pos[:, i:i + q_chunk]
        m_run = torch.full((B, KV, G, q_chunk), NEG_INF,
                           dtype=torch.float32, device=q.device)
        l_run = torch.zeros_like(m_run)
        acc = torch.zeros((B, KV, G, q_chunk, dv), dtype=torch.float32,
                          device=q.device)
        for j in range(0, S, k_chunk):
            ki, vi = k[:, :, j:j + k_chunk], v[:, :, j:j + k_chunk]
            logits = torch.einsum("bkgth,bksh->bkgts", qi, ki.float()) \
                * scale
            logits = softcap(logits, cap)
            msk = _mask(qpi, k_pos[j:j + k_chunk], causal=causal,
                        kv_valid=kv_valid, window=window)
            logits = torch.where(msk[:, None, None], logits, neg)
            m_new = torch.maximum(m_run, logits.amax(-1))
            p = torch.exp(logits - m_new[..., None])
            corr = torch.exp(m_run - m_new)
            l_run = l_run * corr + p.sum(-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bkgts,bksh->bkgth", p.to(vi.dtype), vi).float()
            m_run = m_new
        out = acc / torch.clamp_min(l_run, 1e-30)[..., None]
        outs.append(out.to(v.dtype))
    return torch.cat(outs, dim=3)


def write_cache(buf, new, cache_pos):
    """Write ``new [B,T,KV,hd]`` into ``buf [B,S,KV,hd]`` in place.

    Scalar ``cache_pos``: one slice, its start clamped so the slice fits
    (``lax.dynamic_update_slice`` semantics). Vector ``cache_pos [B]``:
    each slot writes at its own offset and positions past S are dropped
    (JAX's ``mode="drop"``) without a host sync: a dropped position is
    sent to ``pos % S`` carrying that row's current contents, which T <= S
    keeps clear of every position this call really writes."""
    B, T = new.shape[:2]
    S = buf.shape[1]
    new = to_cache_dtype(new, buf.dtype)
    if not torch.is_tensor(cache_pos) or cache_pos.ndim == 0:
        start = min(max(int(cache_pos), 0), S - T)
        buf[:, start:start + T] = new
        return
    pos = cache_pos[:, None].long() + torch.arange(T, device=buf.device)
    valid = (pos < S)[:, :, None, None]
    tgt = pos % S
    rows = torch.arange(B, device=buf.device)[:, None]
    buf[rows, tgt] = torch.where(valid, new, buf[rows, tgt])


def attention(params, x, *, positions, cfg, cache=None, cache_pos=None,
              is_global=True, front_skip=None, extra_kv=None, q_chunk=512,
              k_chunk=1024):
    """x [B,T,d] -> (y [B,T,d], cache).

    cache: {"k","v": [B, S, KV, hd]}, written in place at ``cache_pos``
    (scalar, or [B] per-slot offsets); the keys are then read back through
    the cache dtype and ``kv_valid = cache_pos + T`` bounds what each row
    attends. Without a cache, keys = queries (self-attention).
    front_skip: optional [B] int — key buffer slots ``< front_skip[b]`` are
    masked (a layer whose profile selected no prefix slot holds zero rows
    at [0, P) that must not be attended).
    extra_kv: optional ``(pk [B,P,KV,hd], pv, pvalid [B])`` without a
    cache, learned PREFIX KV rows (post-RoPE) concatenated un-rotated in
    front of the keys at positions [0, P); the caller passes
    ``positions`` already offset by P where the example selected a prefix
    slot. ``pvalid`` False masks the rows out (``front_skip`` P), so such
    an example attends exactly the bare sequence. This path always takes
    the dense softmax, as JAX's does.
    is_global: the layer's flag under ``sliding_mix`` (``layer_meta``);
    a local layer attends the keys less than ``cfg.sliding_window``
    positions behind each query.
    q_chunk / k_chunk: the chunk sizes of the online-softmax path, taken
    when T > q_chunk, T % q_chunk == 0, S % k_chunk == 0 and there is no
    ``front_skip`` (JAX's condition); the dense softmax otherwise."""
    B, T, d = x.shape
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    G = H // KV

    q = torch.einsum("btd,dhk->bthk", x, params["wq"])
    k = torch.einsum("btd,dhk->bthk", x, params["wk"])
    v = torch.einsum("btd,dhk->bthk", x, params["wv"])
    if cfg.qkv_bias:
        q = q + params["bq"].to(q.dtype)
        k = k + params["bk"].to(k.dtype)
        v = v + params["bv"].to(v.dtype)
    if cfg.pos == "rope":
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)

    k_idx = None
    if cache is not None:
        write_cache(cache["k"], k, cache_pos)
        write_cache(cache["v"], v, cache_pos)
        keys, vals = cache["k"].to(k.dtype), cache["v"].to(v.dtype)
        S = keys.shape[1]
        if torch.is_tensor(cache_pos) and cache_pos.ndim == 1:
            kv_valid = cache_pos.to(torch.int64) + T
        else:
            kv_valid = torch.full((B,), int(cache_pos) + T,
                                  dtype=torch.int64, device=x.device)
        k_pos = torch.arange(S, device=x.device)
    elif extra_kv is not None:
        pk, pv, pvalid = extra_kv
        P = pk.shape[1]
        keys = torch.cat([pk.to(k.dtype), k], dim=1)
        vals = torch.cat([pv.to(v.dtype), v], dim=1)
        S = P + T
        kv_valid = torch.full((B,), S, dtype=torch.int64, device=x.device)
        # per-example key positions: prefix rows at [0, P), the example's
        # own keys at its (possibly shifted) query positions
        k_pos = torch.cat([
            torch.arange(P, dtype=positions.dtype,
                         device=x.device)[None].expand(B, P),
            positions], dim=1)
        k_idx = torch.arange(S, device=x.device)
        front_skip = torch.where(pvalid, 0, P).to(torch.int32)
    else:
        keys, vals = k, v
        S = T
        kv_valid = torch.full((B,), T, dtype=torch.int64, device=x.device)
        k_pos = torch.arange(S, device=x.device)

    keys = keys.permute(0, 2, 1, 3)                    # [B, KV, S, hd]
    vals = vals.permute(0, 2, 1, 3)
    qg = q.reshape(B, T, KV, G, hd).permute(0, 2, 3, 1, 4)  # [B,KV,G,T,hd]

    window = None
    if cfg.attn_type == "sliding_mix":
        # global layers get an "infinite" window, as JAX's traced flag does
        window = 2 ** 30 if is_global else int(cfg.sliding_window)

    scale = float(np.float32(1.0) / np.sqrt(np.float32(hd)))
    use_chunked = T > q_chunk and T % q_chunk == 0 and S % k_chunk == 0
    if use_chunked and front_skip is None:
        out = _sdpa_chunked(qg, keys, vals, positions, k_pos,
                            causal=cfg.causal, kv_valid=kv_valid,
                            scale=scale, cap=cfg.logit_softcap,
                            q_chunk=q_chunk, k_chunk=k_chunk, window=window)
    else:
        msk = _mask(positions, k_pos, causal=cfg.causal, kv_valid=kv_valid,
                    window=window, front_skip=front_skip, k_idx=k_idx)
        out = _sdpa_dense(qg, keys, vals, msk, scale, cfg.logit_softcap)
    if extra_kv is not None:
        # an example whose rows are masked out takes the softmax over its
        # own T keys alone: the same value in exact arithmetic, and bitwise
        # the bare forward's (a reduction over P + T columns, P of them
        # masked, need not round as one over T does)
        own = _sdpa_dense(qg, k.permute(0, 2, 1, 3), v.permute(0, 2, 1, 3),
                          _mask(positions, positions, causal=cfg.causal,
                                kv_valid=torch.full((B,), T,
                                                    dtype=torch.int64,
                                                    device=x.device),
                                window=window,
                                k_idx=torch.arange(T, device=x.device)),
                          scale, cfg.logit_softcap)
        out = torch.where(extra_kv[2][:, None, None, None, None], out, own)

    out = out.permute(0, 3, 1, 2, 4).reshape(B, T, H, hd)
    y = torch.einsum("bthk,hkd->btd", out, params["wo"])
    return y, cache

