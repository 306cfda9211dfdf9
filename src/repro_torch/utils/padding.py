"""Power-of-two padding buckets, shared by the serve scheduler and engine.

Padding prompt lengths and request counts to pow2 buckets keeps the port's
prefill and admission shapes identical to the JAX engine's (which bounds
its retraces that way), at most 2x pad compute.
"""
from __future__ import annotations


def pow2_bucket(n: int, floor: int = 8) -> int:
    """Length bucket: next power of two >= n, floored at `floor` (pad tokens
    are cheap, so a floor trades a little compute for fewer jit variants)."""
    b = floor
    while b < n:
        b *= 2
    return b


def pow2_count(n: int) -> int:
    """Request-count bucket: next power of two from 1 (no floor — padding
    rows cost real aggregation/prefill work, unlike pad tokens)."""
    b = 1
    while b < n:
        b *= 2
    return b
