"""X-PEFT admission aggregation + the multi-profile mask table.

Serving aggregates each admitted profile's k selected adapters into one
Â/B̂ pair per layer (``precompute_effective_adapters_sparse``, or
``precompute_effective_adapters_sparse_quant`` over a quantized bank, or
one typed aggregate per adapter family with
``precompute_effective_adapters_sparse_hetero`` over a heterogeneous
bank), through the kernel dispatch layer, and ``apply_precomputed_layer``
applies one layer of such a record to a [T, d] sequence. The dense /
soft-mask paths of ``repro.core.xpeft`` (the hetero ones included) wait
for ROADMAP queue 1, items 2 and 7.
"""
from __future__ import annotations

import torch

from repro_torch.core import masks as M


# Entry keys each adapter family contributes to a hydrated (aggregated)
# profile entry: the typed generalization of the {a_hat, b_hat, ln_*}
# record. The unified mask still selects over ONE [0, N) index space;
# these are the per-type AGGREGATES the selection produces.
HETERO_ENTRY_KEYS = {
    "bottleneck": ("a_hat", "b_hat", "ln_scale", "ln_bias"),
    "lora": ("lora_a", "lora_b"),
    "ia3": ("ia3_s",),
    "prefix": ("prefix_k", "prefix_v"),
}


def hetero_entry_keys(xp):
    """Ordered entry keys for the families present in ``xp.bank_spec``."""
    out = []
    for t, _, _ in xp.segments():
        for k in HETERO_ENTRY_KEYS[t]:
            if k not in out:
                out.append(k)
    return tuple(out)


def _safe_inv(wsum):
    """0/0-safe renorm factor: 1/wsum where wsum > 0, else 0."""
    safe = torch.where(wsum > 0, wsum, torch.ones_like(wsum))
    return torch.where(wsum > 0, 1.0 / safe, torch.zeros_like(wsum))


def init_profile_table(cfg, *, seed: int = 0, device="cpu") -> dict:
    """[max_profiles, ...] table of per-profile trainables, drawn from one
    ``torch.Generator`` seeded with ``seed``."""
    xp = cfg.xpeft
    gen = torch.Generator(device=device).manual_seed(seed)
    rows = [M.init_profile_params(cfg.num_layers, xp.num_adapters,
                                  xp.bottleneck, generator=gen,
                                  device=device)
            for _ in range(xp.max_profiles)]
    return {k: torch.stack([r[k] for r in rows]) for k in rows[0]}


def precompute_effective_adapters_sparse(bank: dict, idx_a, w_a, idx_b, w_b,
                                         xp):
    """k-sparse admission aggregation through the kernel dispatch layer.

    idx_*/w_*: [..., L, k] (one profile's top-k mask indices, or a leading
    request batch R). The layer axis folds into the bank's N axis — row
    (l, n) -> l*N + n — so ONE batched aggregation of P = R·L rows reads
    only the k·L·d·b selected bank values per profile. Returns
    (Â [..., L, d, b], B̂ [..., L, b, d]) in the bank dtype (the cast
    stays outside the kernel, which accumulates and returns fp32)."""
    from repro_torch.kernels import ops

    L, N, d, b = bank["bank_a"].shape
    batch = idx_a.shape[:-2]
    flat_a = bank["bank_a"].reshape(L * N, d, b)
    flat_b = bank["bank_b"].reshape(L * N, b, d)
    off = (torch.arange(L, dtype=torch.int32,
                        device=idx_a.device) * N)[:, None]     # [L, 1]

    def flatten(idx, w):
        k = idx.shape[-1]
        fi = (idx.to(torch.int32) + off).reshape(-1, k)
        return fi, w.to(torch.float32).reshape(-1, k)

    fia, fwa = flatten(idx_a, w_a)
    fib, fwb = flatten(idx_b, w_b)
    a_hat = ops.mask_aggregate_batched(flat_a, fia, fwa, impl=xp.kernel_impl)
    b_hat = ops.mask_aggregate_batched(flat_b, fib, fwb, impl=xp.kernel_impl)
    dt = bank["bank_a"].dtype
    return (a_hat.reshape(*batch, L, d, b).to(dt),
            b_hat.reshape(*batch, L, b, d).to(dt))


def precompute_effective_adapters_sparse_quant(qbank: dict, idx_a, w_a,
                                               idx_b, w_b, xp):
    """k-sparse admission aggregation over a QUANTIZED bank.

    qbank: {"bank_a_q", "bank_a_scale", "bank_b_q", "bank_b_scale"} with
    leading [L, N] dims (``quant.schemes.quantize_bank``). The layer axis
    folds into N as in ``precompute_effective_adapters_sparse``, so ONE
    launch per side aggregates P = R·L rows, reading the quantized rows
    only. Returns fp32 (Â [..., L, d, b], B̂ [..., L, b, d]); the engine
    re-quantizes them per row for its cache entries and slot buffers."""
    from repro_torch.kernels import ops

    L, N, d = qbank["bank_a_q"].shape[:3]
    b = qbank["bank_b_q"].shape[2]
    batch = idx_a.shape[:-2]
    flat = {k: v.reshape((L * N,) + tuple(v.shape[2:]))
            for k, v in qbank.items()}
    off = (torch.arange(L, dtype=torch.int32,
                        device=idx_a.device) * N)[:, None]     # [L, 1]

    def flatten(idx, w):
        k = idx.shape[-1]
        fi = (idx.to(torch.int32) + off).reshape(-1, k)
        return fi, w.to(torch.float32).reshape(-1, k)

    fia, fwa = flatten(idx_a, w_a)
    fib, fwb = flatten(idx_b, w_b)
    a_hat = ops.mask_aggregate_quant_batched(
        flat["bank_a_q"], flat["bank_a_scale"], fia, fwa,
        scheme=xp.bank_quant, impl=xp.kernel_impl)
    b_hat = ops.mask_aggregate_quant_batched(
        flat["bank_b_q"], flat["bank_b_scale"], fib, fwb,
        scheme=xp.bank_quant, impl=xp.kernel_impl)
    return (a_hat.reshape(*batch, L, d, a_hat.shape[-1]),
            b_hat.reshape(*batch, L, b, b_hat.shape[-1]))


def apply_precomputed_layer(x, eff_l: dict, xp):
    """Apply an admission-time-aggregated adapter slice (per layer)."""
    from repro_torch.kernels import ops

    return ops.fused_adapter(x, eff_l["a_hat"], eff_l["b_hat"],
                             eff_l["ln_scale"], eff_l["ln_bias"],
                             activation=xp.adapter_activation,
                             impl=xp.kernel_impl)


def _sparse_fold(leaf, idx, w, xp):
    """Layer-folded k-sparse aggregation of one typed leaf.

    leaf [L, C, p, q]; idx/w [..., L, k] with idx LOCAL to the segment
    (weights of out-of-segment selections already zeroed) -> [..., L, p, q]
    fp32, via ONE batched aggregation of R·L rows, the layer-folding of
    ``precompute_effective_adapters_sparse``."""
    from repro_torch.kernels import ops

    L, C, p, q = leaf.shape
    batch = idx.shape[:-2]
    k = idx.shape[-1]
    flat = leaf.reshape(L * C, p, q)
    off = (torch.arange(L, dtype=torch.int32, device=idx.device) * C)[:, None]
    fi = (idx.to(torch.int32) + off).reshape(-1, k)
    fw = w.to(torch.float32).reshape(-1, k)
    out = ops.mask_aggregate_batched(flat, fi, fw, impl=xp.kernel_impl)
    return out.reshape(*batch, L, p, q)


def _segment_bucket(idx, w, off, cnt):
    """Fixed-shape bucketing of unified-space indices into one segment:
    indices outside [off, off+cnt) clamp to a valid local row and their
    weights become zero (0 · a finite row is an exact 0 in the fp32 sum),
    so every segment runs at the full k width."""
    in_seg = (idx >= off) & (idx < off + cnt)
    local = torch.clamp(idx - off, 0, cnt - 1).to(torch.int32)
    return local, w.to(torch.float32) * in_seg


def precompute_effective_adapters_sparse_hetero(bank: dict, idx_a, w_a,
                                                idx_b, w_b, xp):
    """k-sparse admission aggregation for a heterogeneous bank (the twin
    of ``repro.core.xpeft.precompute_effective_adapters_sparse_hetero``).

    idx_*/w_*: [..., L, k] over the UNIFIED index space. Each typed
    segment buckets the k selections with ``_segment_bucket`` and runs the
    same batched aggregation at full k width. Returns the per-type
    aggregates keyed as ``HETERO_ENTRY_KEYS`` (no LN affines: the caller
    attaches the profile's own): bottleneck and LoRA sides follow their
    masks; IA3 and prefix take both masks; prefix rows are renormalized
    to a convex mixture, 0/0 giving zero rows."""
    out = {}
    for t, off, cnt in xp.segments():
        la, wa = _segment_bucket(idx_a, w_a, off, cnt)
        lb, wb = _segment_bucket(idx_b, w_b, off, cnt)
        if t in ("bottleneck", "lora"):
            names = ("bank_a", "bank_b") if t == "bottleneck" else \
                ("lora_a", "lora_b")
            sub = {"bank_a": bank[names[0]], "bank_b": bank[names[1]]}
            a_hat, b_hat = precompute_effective_adapters_sparse(
                sub, la, wa, lb, wb, xp)
            keys = ("a_hat", "b_hat") if t == "bottleneck" else \
                ("lora_a", "lora_b")
            out[keys[0]], out[keys[1]] = a_hat, b_hat
        elif t == "ia3":
            v = bank["ia3_v"][..., None]                    # [L, C, d, 1]
            s = _sparse_fold(v, la, wa, xp) + _sparse_fold(v, lb, wb, xp)
            out["ia3_s"] = s[..., 0].to(bank["ia3_v"].dtype)
        elif t == "prefix":
            num_k = _sparse_fold(bank["prefix_k"], la, wa, xp) + \
                _sparse_fold(bank["prefix_k"], lb, wb, xp)
            num_v = _sparse_fold(bank["prefix_v"], la, wa, xp) + \
                _sparse_fold(bank["prefix_v"], lb, wb, xp)
            wsum = wa.sum(-1) + wb.sum(-1)                  # [..., L]
            inv = _safe_inv(wsum)[..., None, None]
            dt = bank["prefix_k"].dtype
            out["prefix_k"] = (num_k * inv).to(dt)
            out["prefix_v"] = (num_v * inv).to(dt)
    return out
