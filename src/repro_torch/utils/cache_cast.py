"""The cast into a KV cache's dtype, as JAX makes it.

JAX's ``astype(jnp.float8_e4m3fn)`` is ml_dtypes' cast: round to nearest
even, and NaN (the sign kept) where the magnitude rounds past 448, the
largest finite e4m3fn value (above 464, the midpoint to 480, which
e4m3fn spends on NaN). PyTorch's own ``.to(torch.float8_e4m3fn)`` follows
that rule in some versions (2.11, CPU and CUDA) and saturates to 448 in
others (2.13's CPU cast). ``to_cache_dtype`` asks each (device type,
source dtype) once which rule the installed PyTorch follows, and fixes the
overflowing values up only where it saturates, so the port writes JAX's
bytes whatever the version. The decode megakernel applies the same rule
itself (``csrc/decode_fused.cu`` ``f8_of``).
"""
from __future__ import annotations

import functools

import torch

F8 = torch.float8_e4m3fn
# a magnitude above this rounds past 448 (ties at 464 go to 448, the even)
E4M3_ROUNDS_TO_MAX = 464.0
# (value, the e4m3fn byte JAX's cast gives): past 464, at 480 and beyond,
# inf, a negative overflow, the tie at 464, NaN
_PROBE = ((464.25, 0x7F), (480.0, 0x7F), (float("inf"), 0x7F),
          (-1.0e4, 0xFF), (464.0, 0x7E), (float("nan"), 0x7F))


@functools.lru_cache(maxsize=None)
def _torch_casts_like_jax(device_type: str, dtype: torch.dtype) -> bool:
    """Whether PyTorch's own cast to float8_e4m3fn of ``dtype`` values on
    this device type gives JAX's bytes on the overflow probes."""
    vals = torch.tensor([v for v, _ in _PROBE], dtype=dtype,
                        device=device_type)
    got = vals.to(F8).view(torch.uint8).cpu().tolist()
    return got == [b for _, b in _PROBE]


def to_cache_dtype(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``t`` cast to the cache dtype ``dtype``; float8_e4m3fn by JAX's rule
    (NaN past 448, no saturation), every other dtype ``t.to(dtype)``."""
    out = t.to(dtype)
    if dtype != F8 or t.dtype == F8 or t.device.type == "meta" \
            or _torch_casts_like_jax(t.device.type, t.dtype):
        return out
    over = ~(t.abs() <= E4M3_ROUNDS_TO_MAX)   # NaN compares False: over
    nan = torch.where(torch.signbit(t), 0xFF, 0x7F).to(torch.uint8)
    return torch.where(over, nan, out.view(torch.uint8)).view(F8)
