"""Kernel dispatch layer: the port's counterpart of ``repro.kernels.ops``.

Every model/serve hot path that applies or aggregates adapters routes
through here (``models/model.py`` ``_xpeft_apply``, ``core/xpeft.py``
admission). Callers pass ``impl`` — normally ``cfg.xpeft.kernel_impl``:

- ``auto`` — the hand-written CUDA kernel on a CUDA tensor (launched or
  raising, never falling back), the plain PyTorch version on a CPU tensor.
- ``ref``  — the plain version (``kernels/ref.py``) wherever the tensor
  lies; on the card this is the end-to-end reference run.

The Pallas backends (``pallas``, ``interpret``) have no counterpart.
"""
from __future__ import annotations

from repro_torch.kernels import ref
from repro_torch.kernels.fused_adapter_batched import (
    fused_adapter_batched as _fused_cuda)
from repro_torch.kernels.mask_aggregate import (
    mask_aggregate_batched as _agg_cuda)

IMPLS = ("auto", "ref")


def resolve_impl(impl: str) -> str:
    if impl not in IMPLS:
        raise ValueError(f"kernel_impl {impl!r}; expected one of {IMPLS}")
    return impl


def mask_aggregate_batched(bank, idx, w, *, impl: str = "auto"):
    """bank [N,d,b], idx [P,k], w [P,k] -> [P,d,b] fp32 (one launch)."""
    if resolve_impl(impl) == "ref":
        return ref.mask_aggregate_batched_ref(bank, idx, w)
    return _agg_cuda(bank, idx, w)


def fused_adapter(x, a_hat, b_hat, ln_scale, ln_bias, *,
                  activation: str = "gelu", impl: str = "auto",
                  use_ln: bool = True):
    """Fused bottleneck adapter y = x + B̂(act(LN(Â x))) over a batch:
    x [B,T,d] with per-row a_hat [B,d,b] (b_hat / ln_* likewise) or
    shared 2-D ones. The unbatched [T,d] form is TPU kernel #3
    (``kernels/fused_adapter.py``), still to port (ROADMAP queue 2)."""
    if x.ndim != 3:
        raise NotImplementedError(
            "unbatched fused_adapter ([T, d] x) is not ported yet "
            "(ROADMAP queue 2, item 4); pass x as [1, T, d]")
    if resolve_impl(impl) == "ref":
        return ref.fused_adapter_batched_ref(
            x, a_hat, b_hat, ln_scale, ln_bias, activation=activation,
            use_ln=use_ln)
    return _fused_cuda(x, a_hat, b_hat, ln_scale, ln_bias,
                       activation=activation, use_ln=use_ln)
