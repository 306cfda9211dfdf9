"""X-PEFT layer application, admission aggregation + the multi-profile
mask table.

The per-profile trainables live in a TABLE (leading dim = max_profiles):
each training example gathers its profile's row (``gather_profiles``),
its mask logits become weights (``profile_mask_weights``: straight-through
Gumbel top-k in training, k-hot or softmax otherwise), and a layer applies
them on the fly, densely (``apply_xpeft_layer``) or over the k selected
rows (``apply_xpeft_layer_sparse``). These are plain differentiable torch
ops, as their JAX twins are jnp einsums outside any Pallas kernel;
autograd scatters the gradient back into the table's rows.

Serving aggregates each admitted profile's k selected adapters into one
Â/B̂ pair per layer (``precompute_effective_adapters_sparse``, or
``precompute_effective_adapters_sparse_quant`` over a quantized bank, or
one typed aggregate per adapter family with
``precompute_effective_adapters_sparse_hetero`` over a heterogeneous
bank), through the kernel dispatch layer; soft masks aggregate densely
(``precompute_effective_adapters_dense_batched``). ``apply_precomputed_layer``
applies one layer of such a record to a [T, d] sequence.

A heterogeneous bank's dense forms (training, soft and per-step masks)
aggregate each typed segment from the unified-space weights
(``hetero_aggregate_dense_layer``), apply bottleneck -> LoRA -> IA3
(``apply_xpeft_layer_hetero``) and hand the prefix segment's KV rows to
attention (``prefix_rows_dense_layer``); ``precompute_effective_adapters_hetero``
is the one-profile dense admission.
"""
from __future__ import annotations

import torch

from repro_torch.core import adapters as A
from repro_torch.core import masks as M
from repro_torch.utils import generator, resolve_device


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


def _segment_slice(w, off, cnt):
    """Static slice of the unified-N weight axis for one segment."""
    return w[..., off:off + cnt]


def _safe_inv(wsum):
    """0/0-safe renorm factor: 1/wsum where wsum > 0, else 0.

    Double where, not ``1/clamp(wsum, eps)``: that form's derivative at
    wsum = 0 is -1/eps^2, which overflows float32 to inf, and the zero
    gradient the unselected branch receives turns 0·inf into NaN, which
    poisons the whole mask-logit gradient row of a training example whose
    masks select no prefix slot at some layer."""
    safe = torch.where(wsum > 0, wsum, torch.ones_like(wsum))
    return torch.where(wsum > 0, 1.0 / safe, torch.zeros_like(wsum))


def hetero_aggregate_dense_layer(bank_l: dict, w_a_l, w_b_l, xp) -> dict:
    """One layer's per-type aggregates from DENSE unified-space weights.

    bank_l holds the layer's slices of the typed bank leaves; w_*_l are
    [..., N] over the unified index space. Per family:

    - bottleneck/lora: Â from the A-mask, B̂ from the B-mask;
    - ia3: both masks contribute, s = Σ (w_a + w_b)[i] · v[i];
    - prefix: a renormalized convex mixture, rows = Σ (w_a+w_b)[i]·rows[i]
      / Σ (w_a+w_b)[i], 0/0 -> zero rows.

    Returns {type: aggregate(s)} for the segments present."""
    out = {}
    for t, off, cnt in xp.segments():
        wa = _segment_slice(w_a_l, off, cnt).float()
        wb = _segment_slice(w_b_l, off, cnt).float()
        if t in ("bottleneck", "lora"):
            names = ("bank_a", "bank_b") if t == "bottleneck" else \
                ("lora_a", "lora_b")
            out[t] = A.aggregate_dense(
                {"bank_a": bank_l[names[0]], "bank_b": bank_l[names[1]]},
                wa, wb)
        elif t == "ia3":
            out["ia3"] = torch.einsum("...n,nd->...d", wa + wb,
                                      bank_l["ia3_v"].float())
        elif t == "prefix":
            wab = wa + wb
            num_k = torch.einsum("...n,npq->...pq", wab,
                                 bank_l["prefix_k"].float())
            num_v = torch.einsum("...n,npq->...pq", wab,
                                 bank_l["prefix_v"].float())
            inv = _safe_inv(wab.sum(-1))[..., None, None]
            out["prefix"] = (num_k * inv, num_v * inv)
    return out


def precompute_effective_adapters_hetero(bank: dict, profile_params: dict,
                                         xp) -> dict:
    """Dense admission-time aggregation of ONE profile over a heterogeneous
    bank: the typed twin of ``precompute_effective_adapters``. Returns the
    ``hetero_entry_keys(xp)`` dict with [L, ...] leaves in the bank
    leaves' dtypes (sums in fp32)."""
    w_a, w_b = profile_mask_weights(profile_params, xp, training=False)
    out = {}
    for t, off, cnt in xp.segments():
        wa = _segment_slice(w_a, off, cnt).float()
        wb = _segment_slice(w_b, off, cnt).float()
        if t in ("bottleneck", "lora"):
            names = ("bank_a", "bank_b") if t == "bottleneck" else \
                ("lora_a", "lora_b")
            keys = ("a_hat", "b_hat") if t == "bottleneck" else names
            a, b = bank[names[0]], bank[names[1]]
            out[keys[0]] = torch.einsum("ln,lndb->ldb", wa,
                                        a.float()).to(a.dtype)
            out[keys[1]] = torch.einsum("ln,lnbd->lbd", wb,
                                        b.float()).to(b.dtype)
            if t == "bottleneck":
                out["ln_scale"] = profile_params["ln_scale"]
                out["ln_bias"] = profile_params["ln_bias"]
        elif t == "ia3":
            v = bank["ia3_v"]
            out["ia3_s"] = torch.einsum("ln,lnd->ld", wa + wb,
                                        v.float()).to(v.dtype)
        elif t == "prefix":
            wab = wa + wb
            pk, pv = bank["prefix_k"], bank["prefix_v"]
            num_k = torch.einsum("ln,lnpq->lpq", wab, pk.float())
            num_v = torch.einsum("ln,lnpq->lpq", wab, pv.float())
            inv = _safe_inv(wab.sum(-1))[:, None, None]
            out["prefix_k"] = (num_k * inv).to(pk.dtype)
            out["prefix_v"] = (num_v * inv).to(pv.dtype)
    return out


def init_xpeft_state(cfg, *, seed: int = 0, device=None) -> dict:
    """Frozen bank + per-profile trainable table for a config, each drawn
    from its own ``torch.Generator`` (the bank's seeded with ``seed``, the
    table's with ``seed + 1``). ``device=None`` means the card."""
    xp, dev = cfg.xpeft, resolve_device(device)
    kw = dict(generator=generator(dev, seed), device=dev)
    dtype = getattr(torch, cfg.dtype)
    if xp.is_hetero:
        bank = A.init_hetero_bank(cfg.num_layers, xp, cfg.d_model,
                                  cfg.kv_dim, dtype, **kw)
    else:
        bank = A.init_adapter_bank(cfg.num_layers, xp.num_adapters,
                                   cfg.d_model, xp.bottleneck, dtype, **kw)
    return {"bank": bank,
            "profiles": init_profile_table(cfg, seed=seed + 1, device=dev)}


def init_profile_table(cfg, *, seed: int = 0, device="cpu") -> dict:
    """[max_profiles, ...] table of per-profile trainables, drawn from one
    ``torch.Generator`` seeded with ``seed``."""
    xp = cfg.xpeft
    gen = generator(device, seed)
    n = 1 if gen is None else xp.max_profiles   # meta: one row's shapes
    rows = [M.init_profile_params(cfg.num_layers, xp.num_adapters,
                                  xp.bottleneck, generator=gen,
                                  device=device)
            for _ in range(n)]
    if gen is None:
        return {k: v.expand((xp.max_profiles,) + v.shape).contiguous()
                for k, v in rows[0].items()}
    return {k: torch.stack([r[k] for r in rows]) for k in rows[0]}


def gather_profiles(table: dict, profile_ids) -> dict:
    """Select rows of the profile table for a batch: [B, L, N] / [B, L, b]."""
    ids = torch.as_tensor(profile_ids).long()
    return {k: v[ids.to(v.device)] for k, v in table.items()}


def profile_mask_weights(profile_params: dict, xp, *, noise=None,
                         generator=None, training: bool = True):
    """Logits -> (w_a, w_b) mask weights, shape [..., L, N].

    ``noise``: a (noise_a, noise_b) pair of standard Gumbel draws, one per
    mask (JAX splits one key into ka, kb), or None; ``generator`` draws
    them instead, A's then B's."""
    na, nb = noise if noise is not None else (None, None)
    w_a = M.mask_weights(profile_params["mA"], xp, noise=na,
                         generator=generator, training=training)
    w_b = M.mask_weights(profile_params["mB"], xp, noise=nb,
                         generator=generator, training=training)
    return w_a, w_b


def apply_xpeft_layer(x, bank_l: dict, w_a_l, w_b_l, ln_scale_l, ln_bias_l,
                      xp):
    """Apply the layer-l X-PEFT adapter to activations x [..., T, d].

    w_*_l: [N] (one profile) or [B, N] (per-example profiles); bank_l:
    {"bank_a": [N, d, b], "bank_b": [N, b, d]}, the layer's slice."""
    a_hat, b_hat = A.aggregate_dense(bank_l, w_a_l, w_b_l)
    return A.apply_adapter(x, a_hat, b_hat, ln_scale_l, ln_bias_l,
                           activation=xp.adapter_activation)


def apply_xpeft_layer_sparse(x, bank_l: dict, idx_a_l, w_a_l, idx_b_l, w_b_l,
                             ln_scale_l, ln_bias_l, xp):
    """Hard-mask path over the k selected rows (N/k cheaper)."""
    a_hat, b_hat = A.aggregate_sparse(bank_l, idx_a_l, w_a_l, idx_b_l, w_b_l)
    return A.apply_adapter(x, a_hat, b_hat, ln_scale_l, ln_bias_l,
                           activation=xp.adapter_activation)


def apply_xpeft_layer_hetero(x, bank_l: dict, w_a_l, w_b_l, ln_scale_l,
                             ln_bias_l, xp):
    """Dense heterogeneous layer application (training, soft and per-step
    masks): aggregate each typed segment from the unified-space weights
    and apply in the fixed order bottleneck -> LoRA -> IA3. Prefix rows
    are not applied here: they are KV rows, which the model hands to
    attention (``prefix_rows_dense_layer``)."""
    agg = hetero_aggregate_dense_layer(bank_l, w_a_l, w_b_l, xp)
    if "bottleneck" in agg:
        a_hat, b_hat = agg["bottleneck"]
        x = A.apply_adapter(x, a_hat, b_hat, ln_scale_l, ln_bias_l,
                            activation=xp.adapter_activation)
    if "lora" in agg:
        la, lb = agg["lora"]
        x = A.apply_lora(x, la.to(x.dtype), lb.to(x.dtype))
    if "ia3" in agg:
        x = A.apply_ia3(x, agg["ia3"])
    return x


def prefix_rows_dense_layer(bank_l: dict, w_a_l, w_b_l, xp, kv_heads: int,
                            head_dim: int):
    """One layer's per-example prefix KV rows from dense unified-space
    weights: ``(pk [B, P, KV, hd], pv, pvalid [B])`` for attention's
    ``extra_kv``, or None when the spec has no prefix segment. pvalid is
    False where the example's masks select no prefix slot at this layer:
    attention then masks the rows out, so a no-prefix selection attends
    exactly the bare sequence."""
    seg = next(((off, cnt) for t, off, cnt in xp.segments()
                if t == "prefix"), None)
    if seg is None:
        return None
    off, cnt = seg
    wab = _segment_slice(w_a_l, off, cnt).float() \
        + _segment_slice(w_b_l, off, cnt).float()          # [B, cnt]
    num_k = torch.einsum("...n,npq->...pq", wab, bank_l["prefix_k"].float())
    num_v = torch.einsum("...n,npq->...pq", wab, bank_l["prefix_v"].float())
    wsum = wab.sum(-1)                                      # [B]
    inv = _safe_inv(wsum)[..., None, None]
    shape = tuple(num_k.shape[:-1]) + (kv_heads, head_dim)
    return ((num_k * inv).reshape(shape), (num_v * inv).reshape(shape),
            wsum > 0)


def precompute_effective_adapters(bank: dict, profile_params: dict, xp):
    """Admission-time dense aggregation of one profile: its eval-time mask
    weights against the whole bank in fp32, once -> {"a_hat" [L, d, b],
    "b_hat" [L, b, d] in the bank dtype, "ln_scale", "ln_bias"}."""
    w_a, w_b = profile_mask_weights(profile_params, xp, training=False)
    a_hat = torch.einsum("ln,lndb->ldb", w_a, bank["bank_a"].float())
    b_hat = torch.einsum("ln,lnbd->lbd", w_b, bank["bank_b"].float())
    return {"a_hat": a_hat.to(bank["bank_a"].dtype),
            "b_hat": b_hat.to(bank["bank_b"].dtype),
            "ln_scale": profile_params["ln_scale"],
            "ln_bias": profile_params["ln_bias"]}


def precompute_effective_adapters_dense_batched(bank: dict, w_a, w_b):
    """Dense admission aggregation for a batch of profiles (soft masks):
    w_* [R, L, N] -> (Â [R, L, d, b], B̂ [R, L, b, d]) in the bank dtype,
    summed in fp32. Soft masks are dense by construction: no sparse
    shortcut."""
    a_hat = torch.einsum("rln,lndb->rldb", w_a.float(), bank["bank_a"].float())
    b_hat = torch.einsum("rln,lnbd->rlbd", w_b.float(), bank["bank_b"].float())
    return a_hat.to(bank["bank_a"].dtype), b_hat.to(bank["bank_b"].dtype)


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
