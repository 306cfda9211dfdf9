"""Chunked gated linear attention: the shared engine of RWKV6 (Finch,
per-channel data-dependent decay) and Mamba2 (SSD, per-head scalar decay).

The port of ``repro.models.linear_attn``, op for op. Recurrence per head
(state S in R^{dk x dv}):

    S_t = diag(exp(lw_t)) . S_{t-1} + k_t v_t^T
    o_t = q_t^T S_t                      (+ optional RWKV bonus-u diag term)

The chunked form runs intra-chunk attention as dense products and carries
the state across chunks in a Python loop (JAX's ``lax.scan``); everything
is fp32 and the output is cast to v's dtype. JAX computes it without a
Pallas kernel, in ``jnp`` einsums, and so does the port: plain torch ops.

Numerics (secondary chunking): the naive factoring of exp(cum_i - cum_j)
into exp(cum_i) * exp(-cum_j) overflows fp32 for strong decays (a chunk
of 128 at LW_MIN = -5 gives e^640), so intra-chunk scores are computed
over sub-tiles of SUBTILE tokens, where every factor is bounded by
exp(SUBTILE * |lw|_max) <= e^80:

    exp(cum_i - cum_j) = exp(cum_i - B_a) * exp(B_a - B_b) * exp(B_b - cum_j)

with B_x the exclusive cum at sub-tile x's start. All inter-chunk factors
are <= 1.

Domain: the chunk is the largest divisor of T at most ``chunk`` (ragged
serving prefills), and the sub-tiles are min(SUBTILE, chunk) tokens. A
chunk over SUBTILE that is not a multiple of it (T = 20, 100, 130, 200 or
1000 at a chunk of 128) does not split into sub-tiles: JAX's reshape
raises a TypeError there, and the port raises a ValueError that says so
rather than choosing another chunk.

One departure, in the backward only: the sub-tile pairs above the
diagonal (masked out) take a decay factor of 1 where JAX computes an
overflowing one, so a gradient through strong decays is finite where
JAX's is nan (zamba2-1.2b trains at full width; ``_intra_chunk``).
"""
from __future__ import annotations

from typing import Optional

import torch

LW_MIN = -5.0      # per-step log-decay clamp (decay >= e^-5 ~ 0.0067)
SUBTILE = 16


def clamp_lw(lw):
    return torch.clamp(lw, LW_MIN, -1e-6)


def chunk_for(T: int, chunk: int) -> int:
    """The chunk ``gla_chunked`` takes for T tokens: the largest divisor of
    T at most ``chunk``. Raises ValueError where it does not split into
    sub-tiles (JAX's domain)."""
    c = min(chunk, T)
    while T % c:
        c -= 1
    if c > SUBTILE and c % SUBTILE:
        raise ValueError(
            f"gla_chunked: T={T} at chunk {chunk} takes a chunk of {c}, "
            f"over {SUBTILE} and not a multiple of it, so it does not split "
            f"into {SUBTILE}-token sub-tiles (the JAX reference's reshape "
            "refuses the same lengths)")
    return c


def _intra_chunk(qc, kc, vc, cum, lwc, bonus):
    """Strictly-causal (bonus form) or inclusive intra-chunk attention
    with sub-tiling. qc, kc: [..., c, dk]; vc: [..., c, dv]; cum: the
    inclusive cumsum of lwc. Returns o_intra [..., c, dv]."""
    c, dk = qc.shape[-2], qc.shape[-1]
    dv = vc.shape[-1]
    s = min(SUBTILE, c)
    A = c // s
    lead = qc.shape[:-2]

    # query-side exponent: plain GLA includes the current token's decay
    # (prod_{j+1..i}); RWKV's bonus form excludes it (prod_{j+1..i-1})
    q_cum = cum - lwc if bonus is not None else cum
    # the exclusive cumsum, and B_a = its value at each sub-tile's start
    excl = cum - lwc
    Bt = excl.reshape(*lead, A, s, dk)[..., :, 0, :]          # [..., A, dk]

    q2 = qc.reshape(*lead, A, s, dk)
    k2 = kc.reshape(*lead, A, s, dk)
    v2 = vc.reshape(*lead, A, s, dv)
    qcum2 = q_cum.reshape(*lead, A, s, dk)
    cum2 = cum.reshape(*lead, A, s, dk)

    qloc = q2 * torch.exp(qcum2 - Bt[..., :, None, :])     # <= 1 (or e^|lw|)
    kloc = k2 * torch.exp(Bt[..., :, None, :] - cum2)      # <= e^{s*L}
    # D[a, b] = exp(B_a - B_b) <= 1 for a >= b. Above the diagonal the
    # sub-tile pair is masked out below, and the exponent, up to c * L,
    # overflows fp32 (e^240 at a chunk of 64 and LW_MIN): JAX computes
    # those inf factors and zeroes their scores, so its forward is finite
    # but its backward takes 0 * inf = nan there. The port takes exp(0)
    # above the diagonal: the same forward, a finite gradient.
    ab = torch.arange(A, device=qc.device)
    lower = (ab[:, None] >= ab[None, :])[:, :, None]           # [A, A, 1]
    D = torch.exp(torch.where(lower, Bt[..., :, None, :] - Bt[..., None, :, :],
                              torch.zeros((), dtype=Bt.dtype,
                                          device=Bt.device)))  # [.., A, A, dk]

    # scores[a, b, i, j] = sum_d qloc[a, i, d] D[a, b, d] kloc[b, j, d]
    qD = qloc[..., :, None, :, :] * D[..., :, :, None, :]  # [.., A, A, s, dk]
    scores = qD @ kloc[..., None, :, :, :].transpose(-1, -2)
    ii = torch.arange(c, device=qc.device)
    causal = (ii[:, None] > ii[None, :]) if bonus is not None \
        else (ii[:, None] >= ii[None, :])
    causal = causal.reshape(A, s, A, s).permute(0, 2, 1, 3)   # [A, A, s, s]
    scores = torch.where(causal, scores, torch.zeros((), dtype=scores.dtype,
                                                     device=scores.device))
    # o[a, i] = sum_{b, j} scores[a, b, i, j] v[b, j]
    o = scores.transpose(-3, -2).reshape(*lead, A, s, A * s) \
        @ v2.reshape(*lead, 1, A * s, dv)
    o = o.reshape(*lead, c, dv)
    if bonus is not None:
        coeff = (qc * bonus * kc).sum(-1)
        o = o + coeff[..., None] * vc
    return o


def gla_chunked(q, k, v, lw, *, chunk: int, bonus=None, state=None):
    """q, k: [B, H, T, dk]; v: [B, H, T, dv]; lw: [B, H, T, dk] log-decay
    (<= 0). bonus: [H, dk] RWKV "u", which replaces the current token's
    diagonal term. state: [B, H, dk, dv] or None (zeros).
    Returns (o [B, H, T, dv] in v's dtype, final state [B, H, dk, dv]
    fp32)."""
    B, H, T, dk = q.shape
    dv = v.shape[-1]
    chunk = chunk_for(T, chunk)
    G = T // chunk
    f32 = torch.float32

    lw = clamp_lw(lw.to(f32))
    q_, k_, v_ = (a.to(f32) for a in (q, k, v))

    def rs(a):
        return a.reshape(B, H, G, chunk, a.shape[-1])

    qc, kc, vc, lwc = rs(q_), rs(k_), rs(v_), rs(lw)
    cum = torch.cumsum(lwc, dim=-2)                       # [B,H,G,c,dk]
    total = cum[..., -1, :]                               # [B,H,G,dk]

    bonus_f = bonus.to(f32) if bonus is not None else None
    o_intra = _intra_chunk(
        qc, kc, vc, cum, lwc,
        bonus_f[None, :, None, None, :] if bonus_f is not None else None)

    # inter-chunk: queries decayed from the chunk's start (exclusive for
    # the bonus form)
    q_cum = cum - lwc if bonus is not None else cum
    qd = qc * torch.exp(q_cum)                            # <= 1
    kt = kc * torch.exp(total[..., None, :] - cum)        # <= 1

    s = torch.zeros((B, H, dk, dv), dtype=f32, device=q.device) \
        if state is None else state.to(f32)
    o_inter = []
    for g in range(G):
        o_inter.append(qd[:, :, g] @ s)
        s = s * torch.exp(total[:, :, g])[..., None] \
            + kt[:, :, g].transpose(-1, -2) @ vc[:, :, g]
    o_inter = torch.stack(o_inter, dim=2)                 # [B,H,G,c,dv]

    o = (o_intra + o_inter).reshape(B, H, T, dv)
    return o.to(v.dtype), s


def gla_decode_step(q, k, v, lw, state, *, bonus=None):
    """One recurrent step. q, k: [B, H, dk]; v: [B, H, dv]; lw: [B, H, dk];
    state: [B, H, dk, dv]. Returns (o [B, H, dv] in v's dtype, the new
    state fp32)."""
    f32 = torch.float32
    q_, k_, v_ = (a.to(f32) for a in (q, k, v))
    lw = clamp_lw(lw.to(f32))
    decay = torch.exp(lw)[..., None]                      # [B,H,dk,1]
    kv = k_[..., :, None] * v_[..., None, :]              # [B,H,dk,dv]
    if bonus is None:
        s_new = state * decay + kv
        o = (q_[..., None, :] @ s_new)[..., 0, :]
    else:
        o = (q_[..., None, :]
             @ (state + bonus.to(f32)[None, :, :, None] * kv))[..., 0, :]
        s_new = state * decay + kv
    return o.to(v.dtype), s_new
