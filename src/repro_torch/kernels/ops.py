"""Kernel dispatch layer: the port's counterpart of ``repro.kernels.ops``.

Every model/serve hot path that applies or aggregates adapters routes
through here (``models/model.py`` ``_xpeft_apply`` and
``_decode_fused_apply``, ``core/xpeft.py`` admission and
``apply_precomputed_layer``). Callers pass ``impl`` — normally
``cfg.xpeft.kernel_impl``:

- ``auto`` — the hand-written CUDA kernel on a CUDA tensor (launched or
  raising, never falling back), the plain PyTorch version on a CPU tensor.
- ``ref``  — the plain version (``kernels/ref.py``) wherever the tensor
  lies; on the card this is the end-to-end reference run.

The Pallas backends (``pallas``, ``interpret``) have no counterpart.

No hand-written kernel has a backward. With grad mode on, every entry
here refuses an input that requires grad on its way to a kernel (a CUDA
tensor under ``auto``), so training never loses a gradient through one
unseen; the plain versions (``ref``, or any CPU tensor) are plain torch
ops that autograd differentiates.

Heterogeneous banks (``XPeftConfig.bank_spec``) add three routes:
``lora_adapter`` (the fused adapter kernel with the LN skipped and the
identity), ``ia3_apply`` (``y = x * (1 + s)``) and ``hetero_adapter``
(an entry's bottleneck, LoRA and IA3 in that order, one launch).

The quantized-bank routes (``mask_aggregate_quant_batched``,
``fused_adapter_quant``; ``XPeftConfig.bank_quant``) take int8 / planar
int4 payloads with fp16 scales and dequantize inside the kernel (#5 in
registers, #6 from shared memory); their plain versions share the op
sequence ``quant.schemes.dequant_block``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.decode_fused import (
    decode_block_fused as _decode_cuda)
from repro_torch.kernels.fused_adapter import fused_adapter as _fused_cuda
from repro_torch.kernels.fused_adapter_batched import (
    fused_adapter_batched as _fused_cuda_batched)
from repro_torch.kernels.hetero_adapter import cluster_for as _hetero_cluster
from repro_torch.kernels.hetero_adapter import widths_ok as _hetero_widths_ok
from repro_torch.kernels.hetero_adapter import (
    hetero_adapter_batched as _hetero_cuda)
from repro_torch.kernels.ia3_apply import ia3_apply_batched as _ia3_cuda
from repro_torch.kernels.mask_aggregate import mask_aggregate as _agg_cuda
from repro_torch.kernels.fused_adapter_quant import (
    fused_adapter_quant_batched as _fused_cuda_quant)
from repro_torch.kernels.mask_aggregate import (
    mask_aggregate_batched as _agg_cuda_batched)
from repro_torch.kernels.mask_aggregate_quant import (
    mask_aggregate_quant_batched as _agg_cuda_quant)
from repro_torch.quant.schemes import check_scheme

IMPLS = ("auto", "ref")


def resolve_impl(impl: str) -> str:
    if impl not in IMPLS:
        raise ValueError(f"kernel_impl {impl!r}; expected one of {IMPLS}")
    return impl


def _no_grad_into_kernel(name, *tensors) -> None:
    """Raise when, with grad mode on, an input that requires grad would
    reach the hand-written kernel (any tensor off the CPU: the wrappers
    compute the plain version only on CPU tensors)."""
    if not torch.is_grad_enabled():
        return
    for t in tensors:
        if isinstance(t, dict):
            _no_grad_into_kernel(name, *t.values())
        elif torch.is_tensor(t) and t.requires_grad \
                and t.device.type != "cpu":
            raise RuntimeError(
                f"{name}: an input requires grad, and the hand-written "
                "kernel has no backward; run it under torch.no_grad(), or "
                "take the differentiable route (kernel_impl='ref', or the "
                "on-the-fly mask weights)")


def mask_aggregate(bank, idx, w, *, impl: str = "auto"):
    """k-sparse bank aggregation. bank [N,d,b], idx [k], w [k] -> [d,b]
    fp32."""
    if resolve_impl(impl) == "ref":
        return ref.mask_aggregate_ref(bank, idx, w)
    _no_grad_into_kernel("mask_aggregate", bank, w)
    return _agg_cuda(bank, idx, w)


def mask_aggregate_batched(bank, idx, w, *, impl: str = "auto"):
    """bank [N,d,b], idx [P,k], w [P,k] -> [P,d,b] fp32 (one launch)."""
    if resolve_impl(impl) == "ref":
        return ref.mask_aggregate_batched_ref(bank, idx, w)
    _no_grad_into_kernel("mask_aggregate_batched", bank, w)
    return _agg_cuda_batched(bank, idx, w)


def fused_adapter(x, a_hat, b_hat, ln_scale, ln_bias, *,
                  activation: str = "gelu", impl: str = "auto",
                  use_ln: bool = True):
    """Fused bottleneck adapter y = x + B̂(act(LN(Â x))).

    x [T,d] with a_hat [d,b], or x [B,T,d] with per-row a_hat [B,d,b]
    (b_hat / ln_* likewise; 2-D adapter args broadcast across the batch).
    ``use_ln=False`` with the identity is the LoRA route."""
    plain = resolve_impl(impl) == "ref"
    kw = dict(activation=activation, use_ln=use_ln)
    if not plain:
        _no_grad_into_kernel("fused_adapter", x, a_hat, b_hat, ln_scale,
                             ln_bias)
    if x.ndim == 3:
        if plain:
            return ref.fused_adapter_batched_ref(x, a_hat, b_hat, ln_scale,
                                                 ln_bias, **kw)
        return _fused_cuda_batched(x, a_hat, b_hat, ln_scale, ln_bias, **kw)
    if plain:
        return ref.fused_adapter_ref(x, a_hat, b_hat, ln_scale, ln_bias,
                                     **kw)
    return _fused_cuda(x, a_hat, b_hat, ln_scale, ln_bias, **kw)


def lora_adapter(x, a_hat, b_hat, *, impl: str = "auto"):
    """LoRA route: y = x + B̂Âx, the fused adapter with the LN skipped and
    the identity. Â/B̂ share the bottleneck aggregate's shapes (rank r =
    b). No LN affines are passed: nothing reads them on this route."""
    return fused_adapter(x, a_hat, b_hat, None, None,
                         activation="identity", impl=impl, use_ln=False)


def ia3_apply(x, s, *, impl: str = "auto"):
    """IA3 scaling: y = x * (1 + s), s the aggregated scale deltas ([d]
    shared or [B, d] per row); x [B, T, d] or [T, d]."""
    squeeze = x.ndim == 2
    if squeeze:
        x = x[None]
    if resolve_impl(impl) == "ref":
        out = ref.ia3_apply_batched_ref(x, s)
    else:
        _no_grad_into_kernel("ia3_apply", x, s)
        out = _ia3_cuda(x, s)
    return out[0] if squeeze else out


# a heterogeneous entry's leaves, by stage, in the order they apply
HETERO_STAGES = {"bottleneck": ("a_hat", "b_hat", "ln_scale", "ln_bias"),
                 "lora": ("lora_a", "lora_b"), "ia3": ("ia3_s",)}


def hetero_adapter(x, masks_l, *, activation: str = "gelu",
                   impl: str = "auto"):
    """A heterogeneous entry's adapters in one launch: x [B, T, d] through
    the bottleneck (``a_hat``/``b_hat``/``ln_*`` with ``activation``),
    LoRA (``lora_a``/``lora_b``) and IA3 (``ia3_s``), the stages whose
    leaves ``masks_l`` carries, in that order, each rounded to x's dtype:
    equal to ``fused_adapter`` -> ``lora_adapter`` -> ``ia3_apply``. Where
    no cluster holds every stage's tiles at once (``hetero_route``), the
    stages run as those three kernels in that order."""
    if x.ndim != 3:
        raise ValueError(f"hetero_adapter is batched-only: x must be "
                         f"[B, T, d], got ndim={x.ndim}")
    stages = {name: tuple(masks_l[k] for k in keys)
              for name, keys in HETERO_STAGES.items() if keys[0] in masks_l}
    if "ia3" in stages:
        stages["ia3"] = stages["ia3"][0]
    if resolve_impl(impl) == "ref":
        return ref.hetero_adapter_batched_ref(x, activation=activation,
                                              **stages)
    _no_grad_into_kernel("hetero_adapter", x, masks_l)
    if hetero_route(x, stages) == "one":
        return _hetero_cuda(x, activation=activation, **stages)
    if "bottleneck" in stages:
        x = _fused_cuda_batched(x, *stages["bottleneck"],
                                activation=activation, use_ln=True)
    if "lora" in stages:
        x = _fused_cuda_batched(x, *stages["lora"], None, None,
                                activation="identity", use_ln=False)
    if "ia3" in stages:
        x = _ia3_cuda(x, stages["ia3"])
    return x


def hetero_route(x, stages) -> str:
    """"separate" (#2, #2's LoRA route, #7: each its own launch) where no
    cluster of the hetero-adapter launch fits every stage of ``stages`` at
    x's shape [B, T, d] and dtype (``cluster_for``), else "one". Widths
    the launch cannot take at all (``widths_ok``) stay "one": on a CPU
    tensor the wrapper computes its plain version, which takes any width
    (the reduced test configs' b=4), and on the card its checks raise."""
    nbs = [stages[name][0].shape[-1] for name in ("bottleneck", "lora")
           if name in stages]
    if not _hetero_widths_ok(nbs, x.element_size()):
        return "one"
    s = stages.get("ia3")
    cs = _hetero_cluster(x.shape[-1], nbs, x.shape[1], x.element_size(),
                         0 if s is None else s.element_size())
    return "separate" if cs is None else "one"


def decode_block_fused(x, pos, block, k_cache, v_cache, masks_l, *,
                       norm: str, qkv_bias: bool, use_rope: bool,
                       theta: float, cap: float, mlp_type: str,
                       act_name: str, adapter: str, adapter_act: str,
                       impl: str = "auto"):
    """Decode megakernel (``ModelConfig.decode_fused``): one launch per
    layer applying norm/attention/MLP AND the X-PEFT adapter over the
    [B, 1, d] activations. ``adapter`` picks the fused route: "none",
    "bf16" (a_hat/b_hat leaves) or "int8"/"int4" (the quantized records
    a_q/a_scale/b_q/b_scale, dequantized in registers); returns (y,
    k_rows, v_rows) — the caller scatters the K/V rows into the cache."""
    kw = dict(norm=norm, qkv_bias=qkv_bias, use_rope=use_rope, theta=theta,
              cap=cap, mlp_type=mlp_type, act_name=act_name,
              adapter=adapter, adapter_act=adapter_act)
    if resolve_impl(impl) == "ref":
        return ref.decode_block_ref(x, pos, block, k_cache, v_cache,
                                    masks_l, **kw)
    _no_grad_into_kernel("decode_block_fused", x, block, k_cache, v_cache,
                         masks_l)
    return _decode_cuda(x, pos, block, k_cache, v_cache, masks_l, **kw)


# ----------------------------------------------------------------------------
# Quantized-bank routes (XPeftConfig.bank_quant != "none"). With bank_quant
# "none" nothing below is reached.
# ----------------------------------------------------------------------------

def mask_aggregate_quant_batched(q, scale, idx, w, *, scheme: str,
                                 impl: str = "auto"):
    """k-sparse aggregation over a quantized bank: q [N,d,b|b/2]
    int8/uint8, scale [N,d] / [N,d,b/g] fp16, idx [P,k], w [P,k] ->
    [P,d,b] fp32 (one launch; rows dequantized in registers)."""
    check_scheme(scheme)
    if resolve_impl(impl) == "ref":
        return ref.mask_aggregate_quant_batched_ref(q, scale, idx, w,
                                                    scheme=scheme)
    _no_grad_into_kernel("mask_aggregate_quant_batched", q, scale, w)
    return _agg_cuda_quant(q, scale, idx, w, scheme=scheme)


def fused_adapter_quant(x, a_q, a_scale, b_q, b_scale, ln_scale, ln_bias, *,
                        scheme: str, activation: str = "gelu",
                        impl: str = "auto"):
    """Dequantizing fused bottleneck adapter: x [B,T,d] with per-row
    quantized Â/B̂ records. Batched only: quantized records always arrive
    per slot, from the profile cache or the mask buffers."""
    check_scheme(scheme)
    if x.ndim != 3:
        raise ValueError("fused_adapter_quant is batched-only: x must be "
                         f"[B, T, d], got ndim={x.ndim}")
    kw = dict(scheme=scheme, activation=activation)
    if resolve_impl(impl) == "ref":
        return ref.fused_adapter_quant_batched_ref(
            x, a_q, a_scale, b_q, b_scale, ln_scale, ln_bias, **kw)
    _no_grad_into_kernel("fused_adapter_quant", x, a_scale, b_scale,
                         ln_scale, ln_bias)
    return _fused_cuda_quant(x, a_q, a_scale, b_q, b_scale, ln_scale,
                             ln_bias, **kw)
