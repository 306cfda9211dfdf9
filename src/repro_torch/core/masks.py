"""X-PEFT mask tensors: k-hot hard masks and byte-level bit packing.

A profile's trainable state is two mask-logit tensors ``M_A, M_B [L, N]``,
the adapter-LN affine ``[L, b]`` and optionally a task head. Hard masks
are stored packed: ``2 * ceil(N/8) * L`` bytes per profile.

Top-k ties: ``jax.lax.top_k`` breaks ties toward the lower index and
``torch.topk`` promises no order, so every selection here is a STABLE
descending sort, which keeps equal values in index order.
"""
from __future__ import annotations

import numpy as np
import torch


def init_profile_params(num_layers: int, num_adapters: int, bottleneck: int,
                        *, generator: torch.Generator, device,
                        dtype=torch.float32) -> dict:
    """Per-profile trainables: 2(N+b)*L params (paper §3)."""
    shape = (num_layers, num_adapters)
    kw = dict(generator=generator, device=device, dtype=dtype)
    return {
        "mA": 0.01 * torch.randn(shape, **kw),
        "mB": 0.01 * torch.randn(shape, **kw),
        "ln_scale": torch.ones((num_layers, bottleneck), dtype=dtype,
                               device=device),
        "ln_bias": torch.zeros((num_layers, bottleneck), dtype=dtype,
                               device=device),
    }


def _topk_stable(x: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the k largest along the last axis, ties to lower index."""
    return torch.sort(x, dim=-1, descending=True, stable=True).indices[..., :k]


def binarize(logits, k: int) -> torch.Tensor:
    """[..., N] logits -> boolean k-hot selection per row."""
    logits = torch.as_tensor(logits).float()
    idx = _topk_stable(logits, k)
    bits = torch.zeros(logits.shape, dtype=torch.bool, device=logits.device)
    return bits.scatter_(-1, idx, True)


def pack_mask(bits) -> np.ndarray:
    """Boolean [L, N] -> uint8 [L, ceil(N/8)] (host-side, byte-level)."""
    if torch.is_tensor(bits):
        bits = bits.cpu().numpy()
    return np.packbits(np.asarray(bits, dtype=bool), axis=-1)


def unpack_mask(packed: np.ndarray, n: int) -> np.ndarray:
    return np.unpackbits(packed, axis=-1, count=n).astype(bool)


def khot_weights_from_bits(bits, k: int) -> torch.Tensor:
    """Packed-bit k-hot back to float weights (1/k at selected positions)."""
    return torch.as_tensor(np.asarray(bits), dtype=torch.float32) / k


def mask_indices(bits, k: int) -> torch.Tensor:
    """[..., N] boolean -> [..., k] int32 selected indices, ascending (for
    sparse aggregation). With exactly k bits set these are the set bits;
    with fewer, the lowest unset indices fill up, as ``top_k`` does."""
    bits = torch.as_tensor(np.asarray(bits, dtype=np.float32))
    idx = _topk_stable(bits, k)
    return torch.sort(idx, dim=-1).values.to(torch.int32)


# ----------------------------------------------------------------------------
# Memory accounting (paper Table 1)
# ----------------------------------------------------------------------------

def bytes_per_profile(num_adapters: int, num_layers: int, mask_type: str) -> int:
    if mask_type == "hard":
        return 2 * ((num_adapters + 7) // 8) * num_layers
    return 2 * num_adapters * num_layers * 4
