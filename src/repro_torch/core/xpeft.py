"""X-PEFT admission aggregation + the multi-profile mask table.

Serving aggregates each admitted profile's k selected adapters into one
Â/B̂ pair per layer (``precompute_effective_adapters_sparse``, or
``precompute_effective_adapters_sparse_quant`` over a quantized bank),
through the kernel dispatch layer, and ``apply_precomputed_layer`` applies one
layer of such a record to a [T, d] sequence. The dense / soft-mask /
heterogeneous paths of ``repro.core.xpeft`` wait for ROADMAP queue 1,
items 2 and 7.
"""
from __future__ import annotations

import torch

from repro_torch.core import masks as M


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
