"""Quantization schemes for the adapter bank and stored Â/B̂ rows.

The port's copy of ``repro.quant.schemes``, in plain PyTorch on any
device; for the same input it gives byte-equal ``q`` and scales. Selected
by ``XPeftConfig.bank_quant``:

- ``int8`` — symmetric per-row (last axis) int8, one fp16 scale per row:
  ``q = clip(round(x / s), ±127)`` with ``s = absmax/127``.
- ``int4`` — group-wise packed int4: the last axis is split into groups of
  ``group_for(n, group)`` values sharing one fp16 scale (``s = absmax/7``),
  two values per byte.

Packing is PLANAR: byte ``i`` of a row of ``n`` values carries element
``i`` in its low nibble and element ``i + n/2`` in its high nibble, so a
16-byte load of a row widens to 16 low-half and 16 high-half columns.

``dequant_block`` is the op sequence every plain version uses; its CUDA
twin is ``csrc/dequant.cuh``. Both products (a 7- or 4-bit integer times
an fp16 scale) are exact in fp32, so the two agree bit for bit. The
quantize side runs at engine construction, admission and graduation,
never on the decode hot path.
"""
from __future__ import annotations

import torch

SCHEMES = ("none", "int8", "int4")
INT4_BIAS = 8  # nibbles store q + 8 in [1, 15]; 0 never occurs


def check_scheme(scheme: str) -> str:
    if scheme not in SCHEMES:
        raise ValueError(f"bank_quant {scheme!r}; expected one of {SCHEMES}")
    return scheme


def group_for(n: int, group: int = 32) -> int:
    """Largest divisor of ``n`` that is <= ``group`` (int4 group size).

    The configured group is an upper bound: reduced smoke configs have
    b=4-wide rows where a 32-wide group cannot fit. ``n`` must be even
    (two nibbles per byte)."""
    if n % 2:
        raise ValueError(f"int4 needs an even last axis, got {n}")
    g = min(group, n)
    while n % g:
        g -= 1
    return max(g, 2)


def _grid(x, scale):
    """round(x / s) on the grid of the fp16 scale ``scale`` (rounded to
    fp16 BEFORE the divide, as the reference does); 0 where s == 0.
    ``torch.round`` rounds half to even, as ``jnp.round``."""
    s32 = scale.float()[..., None]
    pos = s32 > 0
    return torch.where(pos, torch.round(x / torch.where(pos, s32, 1.0)),
                       torch.zeros((), dtype=torch.float32,
                                   device=x.device))


def quantize_int8(x) -> dict:
    """x [..., n] float -> {"q": int8 [..., n], "scale": fp16 [...]}."""
    x = torch.as_tensor(x).float()
    scale = (x.abs().amax(-1) / 127.0).to(torch.float16)
    q = torch.clamp(_grid(x, scale), -127, 127)
    return {"q": q.to(torch.int8), "scale": scale}


def pack_int4(q):
    """int [..., n] in [-8, 7] -> uint8 [..., n/2], planar: low nibble =
    first half of the axis, high nibble = second half, biased +8."""
    n = q.shape[-1]
    b = (q + INT4_BIAS).to(torch.uint8)
    return b[..., : n // 2] | (b[..., n // 2:] << 4)


def unpack_int4(packed):
    """uint8 [..., n/2] -> int32 [..., n] in [-8, 7] (planar layout)."""
    lo = (packed & 0xF).to(torch.int32) - INT4_BIAS
    hi = (packed >> 4).to(torch.int32) - INT4_BIAS
    return torch.cat([lo, hi], dim=-1)


def quantize_int4(x, *, group: int = 32) -> dict:
    """x [..., n] float -> {"q": uint8 [..., n/2], "scale": fp16 [..., n/g]}
    with g = group_for(n, group); values in [-7, 7] (symmetric)."""
    x = torch.as_tensor(x).float()
    n = x.shape[-1]
    g = group_for(n, group)
    xg = x.reshape(tuple(x.shape[:-1]) + (n // g, g))
    scale = (xg.abs().amax(-1) / 7.0).to(torch.float16)
    q = torch.clamp(_grid(xg, scale), -7, 7).to(torch.int32)
    return {"q": pack_int4(q.reshape(x.shape)), "scale": scale}


def dequant_block(q, scale, scheme: str):
    """Dequantize to fp32. int8: q [..., n] with scale [...]; int4: packed
    q [..., n/2] with scale [..., n/g]. The op sequence of every plain
    version; ``csrc/dequant.cuh`` is its device twin."""
    if scheme == "int8":
        return q.float() * scale.float()[..., None]
    if scheme == "int4":
        vals = unpack_int4(q).float()
        groups = scale.shape[-1]
        n = vals.shape[-1]
        vg = vals.reshape(tuple(vals.shape[:-1]) + (groups, n // groups))
        vg = vg * scale.float()[..., None]
        return vg.reshape(vals.shape)
    raise ValueError(f"dequant_block: scheme {scheme!r}")


def quantize(x, scheme: str, *, group: int = 32) -> dict:
    check_scheme(scheme)
    if scheme == "int8":
        return quantize_int8(x)
    if scheme == "int4":
        return quantize_int4(x, group=group)
    raise ValueError("quantize: scheme 'none' has no quantized form")


def dequantize(rec: dict, scheme: str):
    return dequant_block(rec["q"], rec["scale"], scheme)


def quant_spec(shape, scheme: str, *, group: int = 32):
    """(q_shape, q_dtype, scale_shape) of a float tensor of ``shape``
    quantized along its last axis: how the engine sizes its per-slot
    quantized mask buffers."""
    check_scheme(scheme)
    shape = tuple(shape)
    n = shape[-1]
    if scheme == "int8":
        return shape, torch.int8, shape[:-1]
    if scheme == "int4":
        g = group_for(n, group)
        return shape[:-1] + (n // 2,), torch.uint8, shape[:-1] + (n // g,)
    raise ValueError("quant_spec: scheme 'none' has no quantized form")


def quantize_bank(bank: dict, scheme: str, *, group: int = 32) -> dict:
    """{"bank_a": [L,N,d,b], "bank_b": [L,N,b,d]} -> {"bank_a_q",
    "bank_a_scale", "bank_b_q", "bank_b_scale"} on the bank's device.

    Quantized one layer at a time into preallocated outputs: each row
    quantizes on its own, so the bytes equal a whole-bank quantization,
    while the fp32 temporaries stay one layer's size (a full-width bf16
    bank would otherwise need ~1.6 GB of them per side)."""
    check_scheme(scheme)
    out = {}
    for side in ("bank_a", "bank_b"):
        src = bank[side]
        q_shape, q_dtype, s_shape = quant_spec(src.shape, scheme,
                                               group=group)
        q = torch.empty(q_shape, dtype=q_dtype, device=src.device)
        s = torch.empty(s_shape, dtype=torch.float16, device=src.device)
        for l in range(src.shape[0]):
            rec = quantize(src[l], scheme, group=group)
            q[l] = rec["q"]
            s[l] = rec["scale"]
        out[f"{side}_q"] = q
        out[f"{side}_scale"] = s
    return out


def quantize_bank_hetero(bank: dict, scheme: str, *, group: int = 32) -> dict:
    """Heterogeneous-bank quantization, for storage: the matmul families
    (bottleneck ``bank_a``/``bank_b``, LoRA ``lora_a``/``lora_b``) go to
    int8/int4 as ``{name}_q``/``{name}_scale``, since their error averages
    out inside a d-wide contraction. IA3 scale deltas and prefix KV rows
    are stored fp16: both are consumed elementwise, with nothing to average
    quantization noise over. No engine serves the result (the engine
    refuses a quantized heterogeneous bank)."""
    check_scheme(scheme)
    out = {}
    for name in ("bank_a", "bank_b", "lora_a", "lora_b"):
        if name in bank:
            q = quantize(bank[name], scheme, group=group)
            out[f"{name}_q"] = q["q"]
            out[f"{name}_scale"] = q["scale"]
    for name in ("ia3_v", "prefix_k", "prefix_v"):
        if name in bank:
            out[name] = bank[name].to(torch.float16)
    return out
