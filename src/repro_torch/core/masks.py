"""X-PEFT mask tensors: soft masks, hard (k-hot) masks with straight-through
Gumbel top-k (paper Algorithm 1), and byte-level bit packing.

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


def gumbel(shape, *, generator: torch.Generator, device) -> torch.Tensor:
    """Standard Gumbel draws ``-log(-log(u))``, u uniform in [tiny, 1), as
    ``jax.random.gumbel`` forms them (other bits: another generator)."""
    u = torch.rand(shape, generator=generator, device=device,
                   dtype=torch.float32)
    u = torch.clamp(u, min=torch.finfo(torch.float32).tiny)
    return -torch.log(-torch.log(u))


def soft_mask_weights(logits):
    """Soft masks: each row is a softmax distribution over the N adapters."""
    return torch.softmax(torch.as_tensor(logits).float(), dim=-1)


def _khot(idx, n: int, k: int) -> torch.Tensor:
    out = torch.zeros(idx.shape[:-1] + (n,), dtype=torch.float32,
                      device=idx.device)
    return out.scatter_(-1, idx, 1.0) / k


def khot_from_topk(logits, k: int) -> torch.Tensor:
    """Deterministic k-hot (eval/serving path): top-k of the logits, /k."""
    logits = torch.as_tensor(logits).float()
    return _khot(_topk_stable(logits.detach(), k), logits.shape[-1], k)


def hard_mask_weights(logits, k: int, *, tau: float = 1.0, nu: float = 1.0,
                      noise=None, generator: torch.Generator = None,
                      training: bool = True):
    """Paper Algorithm 1: Gumbel top-k with straight-through estimation.

    logits: [..., N]. Returns weights [..., N] that are k-hot (/k) in the
    forward pass and carry d(softmax)/d(logits) in the backward pass.
    ``noise``: standard Gumbel draws of the logits' shape (JAX draws them
    from ``jax.random``; the tests inject those), else drawn from
    ``generator`` on the logits' device; with neither, or at eval time
    (training=False), no noise is added."""
    logits = logits.float()
    if training and nu > 0 and (noise is not None or generator is not None):
        if noise is None:
            noise = gumbel(logits.shape, generator=generator,
                           device=logits.device)
        logits = logits + nu * noise.to(logits.device, torch.float32)
    y_soft = torch.softmax(logits / tau, dim=-1)
    y_hard = _khot(_topk_stable(y_soft.detach(), k), logits.shape[-1], k)
    # straight-through, in JAX's order so the forward values round as its
    # do: forward = y_hard, backward = d y_soft
    return y_hard - y_soft.detach() + y_soft


def mask_weights(logits, cfg, *, noise=None, generator=None,
                 training: bool = True):
    """Dispatch on cfg.mask_type ('soft'|'hard')."""
    if cfg.mask_type == "soft":
        return soft_mask_weights(logits)
    if training:
        return hard_mask_weights(logits, cfg.k, tau=cfg.tau, nu=cfg.nu,
                                 noise=noise, generator=generator,
                                 training=True)
    return khot_from_topk(logits, cfg.k)


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


def adapter_bytes(d: int, b: int, num_layers: int, itemsize: int = 4) -> int:
    """Bytes of one profile's own adapter (down and up projections in
    every layer): what a profile costs without X-PEFT."""
    return 2 * (d * b) * num_layers * itemsize


def trainable_params_per_profile(num_adapters: int, bottleneck: int,
                                 num_layers: int) -> int:
    """A profile's trainables: two mask-logit rows of N and the LN affine
    pair of b, per layer."""
    return 2 * (num_adapters + bottleneck) * num_layers
