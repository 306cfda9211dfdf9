"""CUDA kernel wrapper: the T=1 decode megakernel.

Replaces the Pallas TPU kernel ``src/repro/kernels/decode_fused.py:219``
(``decode_block_pallas``, ``pallas_call`` at ``:274``): one whole decoder
block (norm1, QKV with bias, RoPE, attention over the slot's cache with
the new K/V row substituted at ``pos``, out-projection, norm2, the GLU
MLP with a SiLU or a GELU gate, the latter in its tanh form) and the X-PEFT
adapter, for every slot, returning ``(y, k_rows, v_rows)``; the caller
scatters the rows into the cache.

The kernel (``csrc/decode_fused.cu``) is bound by bytes on the H100: a
layer-step must read the layer's weights once (25.7 MB at qwen1.5-0.5b)
plus the K/V rows the slots attend (rows ``s <= min(pos, S-1)``) and
their Â/B̂, ~8 µs at 3.35 TB/s. The TPU grid (one program per slot, each
streaming all the weights) would run 4 blocks on 132 SMs and read the
weights 4 times; the design is instead ONE cooperative launch per layer,
one block per SM (16 consumer warps and a producer warp that issues the
copies), whose phases (QKV, attention, out-projection,
gate|up, down with the adapter's down-projection folded in, adapter up)
deal tasks of 16 output columns over the whole depth round-robin, so that
no partial sum crosses blocks. Every block streams ONE sequence of weight
tiles and K/V rows across all phases through a ring of four 32 KB
shared-memory stages filled by TMA, so the next phase's tiles are in
flight while it waits at a barrier; the GEMVs run on tensor cores (bf16
in, fp32 sums in a fixed order). A phase's input rows sit in shared memory
beside the ring where B of them fit at the widest GEMV depth (qwen1.5-0.5b
at 1-8 slots); wider rows (gemma-2b's and llava-next-34b's d_ff at any slot
count, deepseek-7b's and musicgen-medium's at 5-8 slots) are read in
windows of ``in_width`` depth rows as the tasks reach them, each slot's
RMS factor taken first: the same tiles, order and sums. Attention reads
only the rows each slot attends; ``plan`` splits S over blocks
(flash-decoding) only where one stage cannot hold a slot's K and V rows.
Its numerics are ``decode_block_row``'s (the roundings the Pallas body
makes), not the fused-adapter kernel's. Routes int8/int4 read the slots' quantized Â/B̂
and dequantize each value once (the shared ``csrc/dequant.cuh``); their
adapter stays fp32 from x2 to one rounding of x2 + y, as
``decode_block_row``'s quantized branch does.

The cache holds bf16 or float8_e4m3fn values (JAX's ``cfg.cache_dtype``):
on float8 the kernel rounds the new K/V rows from their bf16 values by
JAX's cast rule (nearest even, NaN past 448, no saturation: the rule
``utils/cache_cast.py`` gives the plain version), returns
them as float8, and attends every cached row and the rounded new row at
their exact values, as ``decode_block_row`` does; its cache boxes are
bytes, so a stage holds twice the rows (``plan``).

The kernel is instantiated for 1 to ``MAX_SLOTS`` slots (one block holds
a phase's input rows of every slot). A call with more slots launches it
once per group of at most ``MAX_SLOTS`` consecutive slots
(``slot_groups``), each launch on views of x, pos, the caches and the
adapter operands (they take a batch stride) and writing its rows of y and
the K/V rows into outputs allocated once; each group reads the layer's
weights once. A group's launch is the launch a call on its slots alone
makes (the same instantiation, plan and grid, and a slot's sums do not
depend on the other slots), so a slot's outputs at B=16 are bitwise those
of the same slot in an 8-slot call on its group; against a call of
another width they may differ where ``in_width`` differs (4 against 8
rows: the wide-row builds window the inputs by the instantiation).

On a CPU tensor the wrapper computes the plain version
(``kernels/ref.py`` ``decode_block_ref``); on a CUDA tensor it launches
the kernel or raises. ``decode_block_fused.launches`` counts launches
(one per slot group).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import ref
from repro_torch.kernels._build import load_library
from repro_torch.kernels.fused_adapter_batched import _row_stride
from repro_torch.kernels.mask_aggregate_quant import check_rows
from repro_torch.utils import PLAIN_DEVICES

MAX_SLOTS = 8
# the cache types the kernel reads and writes, by bytes a value
_CACHE_BYTES = {torch.bfloat16: 2, torch.float8_e4m3fn: 1}
_ROUTES = {"none": 0, "bf16": 1, "int8": 2, "int4": 3}
_ADAPTER_ACTS = {"identity": 0, "gelu": 1}
_MLP_ACTS = {"silu": 0, "gelu": 1}


def slot_groups(B: int) -> list:
    """The consecutive slot ranges one call launches the kernel over: in
    order, each of at most ``MAX_SLOTS`` slots, covering 0..B-1 once."""
    if B < 1:
        raise ValueError(f"decode megakernel: {B} slots")
    return [slice(s, min(s + MAX_SLOTS, B)) for s in range(0, B, MAX_SLOTS)]


# the leaves of one layer's adapter entry that ``_adapter_operands`` reads,
# each per slot [B, ...]
_ADAPTER_LEAVES = ("a_hat", "b_hat", "ln_scale", "ln_bias", "a_q",
                   "a_scale", "b_q", "b_scale")


def _unsupported(norm, use_rope, mlp_type, act_name, adapter, adapter_act):
    """The variants the kernel does not build (nothing launches them yet):
    a reason naming the ROADMAP item, or None."""
    if adapter not in _ROUTES:
        return f"adapter route {adapter!r}"
    if adapter != "none" and adapter_act not in _ADAPTER_ACTS:
        return f"adapter activation {adapter_act!r}"
    if norm != "rmsnorm" or mlp_type != "glu" or act_name not in _MLP_ACTS \
            or not use_rope:
        return (f"norm {norm!r}, mlp {mlp_type!r}, act {act_name!r}, "
                f"rope {use_rope}: only RMSNorm, GLU-SiLU/GELU and RoPE are "
                "built (ROADMAP queue 2, item 1)")
    return None


def _unbuilt_dtypes(x_dtype, k_dtype, v_dtype):
    """A reason the kernel does not take these activation / cache dtypes
    (bf16 activations over two bf16 or two float8_e4m3fn caches), or
    None."""
    if x_dtype != torch.bfloat16:
        return (f"x dtype {x_dtype}; only bfloat16 activations are built "
                "(ROADMAP queue 2, item 1)")
    if k_dtype not in _CACHE_BYTES or v_dtype != k_dtype:
        return (f"k/v cache dtypes {k_dtype}/{v_dtype}; built for two "
                "bfloat16 or two float8_e4m3fn caches")
    return None


# the plain version's own RoPE table, made once per shape and device
_inv_freq = functools.lru_cache(maxsize=16)(ref.rope_inv_freq)


# The kernel's fixed geometry (csrc/decode_fused.cu): 512 consumer threads,
# tasks of 16 output columns, a ring of four 32 KB stages, weight tiles of
# 1024 depth rows, input rows padded by 8 values.
THREADS = 512
TASK_COLS = 16
STAGE_BYTES = 32768
STAGES = 4
CHUNK = 1024
ROW_PAD = 8
MAX_SMEM = 232448


def _smem(rows, kin) -> int:
    return (STAGES * STAGE_BYTES + 2 * rows * (kin + ROW_PAD)
            + 4 * ((THREADS // 32) * rows * TASK_COLS + 64))


def in_width(B, d, H, hd, ff) -> int:
    """Depth rows of an input row in shared memory for B slots (4 or 8
    rows) at these widths: the widest GEMV depth where its rows fit beside
    the ring, else the widest whole number of 1024-row weight tiles that
    fits (the rows then come in windows of that many)."""
    rows = 4 if B <= 4 else 8
    kmax = max(d, H * hd, ff)
    if _smem(rows, kmax) <= MAX_SMEM:
        return kmax
    room = MAX_SMEM - _smem(rows, 0) + 2 * rows * ROW_PAD
    return (room // (2 * rows) - ROW_PAD) // CHUNK * CHUNK


def smem_bytes(B, d, H, hd, ff) -> int:
    """Dynamic shared memory of the instantiation for B slots at these
    widths: the ring, the bf16 input rows (``in_width`` depth rows), the
    warps' partial sums and 64 words of per-block state."""
    return _smem(4 if B <= 4 else 8, in_width(B, d, H, hd, ff))


def plan(B, d, H, KV, hd, ff, S, nb, adapter, cache_dtype=torch.bfloat16):
    """Cache rows per attention split at these shapes and cache type. One
    split where a stage holds the K and V rows of the whole cache (S <= 128
    at hd 64 in bf16, S <= 256 in float8): the item then needs no exchange
    with other blocks. Otherwise splits of as many rows as a stage holds of
    K (256 at most), ceil(S / rows) of them, and at least two (a stage
    holds one split's K rows only: S=128 at hd 128 in bf16 takes two splits
    of 64). Raises ValueError on what the kernel does not build."""
    eb = _CACHE_BYTES.get(cache_dtype)
    if not 1 <= B <= MAX_SLOTS or H < 1 or KV < 1 or H % KV \
            or hd not in (16, 32, 64, 128, 256) \
            or any(n % 16 for n in (d, H * hd, KV * hd, ff)) or S < 1 \
            or eb is None:
        raise ValueError(f"decode megakernel shapes B={B} d={d} H={H} "
                         f"KV={KV} hd={hd} ff={ff} S={S} with a "
                         f"{cache_dtype} cache (built for "
                         "bfloat16 and float8_e4m3fn)")
    if adapter != "none" and (nb % 16 or not 0 < nb <= 256):
        raise ValueError(f"decode megakernel bottleneck {nb}")
    whole = -(-S // 16) * 16
    sc = whole if whole <= 256 and 2 * eb * whole * hd <= STAGE_BYTES \
        else min(256, STAGE_BYTES // (eb * hd), -(-S // 32) * 16)
    # the attention item's and the adapter's fp32 buffers use the input
    # rows' space
    kin = in_width(B, d, H, hd, ff)
    floats = (4 if B <= 4 else 8) * (kin + ROW_PAD) // 2
    if kin < CHUNK or floats < max(d, nb, 3 * hd + sc + THREADS):
        raise ValueError(f"decode megakernel: input rows of {kin} at d={d}"
                         f" ff={ff} with a {cache_dtype} cache")
    return sc


@functools.lru_cache(maxsize=16)
def _grid(device_index: int, B, d, H, hd, ff):
    """The co-resident block count a cooperative launch for B slots at
    these widths may use, asked of the CUDA runtime once."""
    grid = ctypes.c_int(0)
    with torch.cuda.device(device_index):
        err = load_library().xpeft_decode_block_config(
            B, d, H, hd, ff, ctypes.byref(grid))
    if err:
        raise RuntimeError(f"decode_block_fused: no cooperative launch "
                           f"configuration (CUDA error {err})")
    return grid.value


@functools.lru_cache(maxsize=64)
def _launch_plan(device_index: int, B, d, H, KV, hd, ff, S, nb, adapter,
                 groups, cache_dtype):
    """(grid, rows per attention split, scratch words) for one shape."""
    sc = plan(B, d, H, KV, hd, ff, S, nb, adapter, cache_dtype)
    grid = _grid(device_index, B, d, H, hd, ff)
    words = load_library().xpeft_decode_block_scratch(
        B, d, H, KV, hd, ff, S, nb, _ROUTES[adapter], *groups, sc,
        int(cache_dtype == torch.float8_e4m3fn))
    if words <= 0:
        raise NotImplementedError(f"decode megakernel refuses B={B} d={d} "
                                  f"H={H} KV={KV} hd={hd} ff={ff} S={S} "
                                  f"b={nb} {adapter} {cache_dtype} cache")
    return grid, sc, words


def _need(t, name, shape, dtype, device):
    if tuple(t.shape) != tuple(shape) or t.dtype != dtype:
        raise ValueError(f"{name} must be {tuple(shape)} {dtype}, got "
                         f"{tuple(t.shape)} {t.dtype}")
    if t.device != device or not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous on {device}")
    if t.data_ptr() % 16:
        raise ValueError(f"{name} must be 16-byte aligned")
    return t


def _adapter_operands(masks_l, adapter, x):
    """The route's adapter operands, checked: pointers and batch strides
    for the kernel's bf16 slots (a_hat, b_hat, ln_scale, ln_bias; the LN
    affines serve every route) and its quantized slots (a_q, a_scale,
    b_q, b_scale), scales per Â/B̂ row, and the bottleneck width. Unused
    slots get x, which the kernel never reads there."""
    f32, dev = torch.float32, x.device
    B, _, d = x.shape
    out = {"nb": 0, "bf16": [x] * 4, "bf16_strides": [0, 0, 0],
           "quant": [x] * 4, "quant_strides": [0, 0, 0, 0],
           "groups": [0, 0]}
    if adapter == "none":
        return out
    ls, lb = masks_l["ln_scale"], masks_l["ln_bias"]
    if adapter == "bf16":
        a, b = masks_l["a_hat"], masks_l["b_hat"]
        if a.dtype != torch.bfloat16 or b.dtype != torch.bfloat16:
            raise TypeError("a_hat/b_hat must be bfloat16")
        nb = a.shape[-1]
        quant, row = [x] * 4, 16
    else:
        a, b = masks_l["a_q"], masks_l["b_q"]
        a_s, b_s = masks_l["a_scale"], masks_l["b_scale"]
        nb, a_groups = check_rows(a, a_s, adapter, "a_q")
        nd, b_groups = check_rows(b, b_s, adapter, "b_q")
        if nd != d:
            raise ValueError(f"b_q rows hold {nd} values, d is {d}")
        quant, row = [a, a_s, b, b_s], 8
        out["groups"] = [a_groups, b_groups]
        if (nb // a_groups) % 8 or (d // b_groups) % 8:
            raise NotImplementedError(
                f"decode megakernel: scale groups of {nb // a_groups} / "
                f"{d // b_groups} columns; built for multiples of 8")
    if ls.dtype != f32 or lb.dtype != f32:
        raise TypeError("ln_scale/ln_bias must be float32")
    if nb % 16 or nb > 256:
        raise NotImplementedError(
            f"decode megakernel bottleneck {nb}: needs a multiple of 16 up "
            "to 256")
    strides = {}
    for name, t in (("a", a), ("b", b)):
        inner = tuple(t.shape[-2:])
        if t.ndim != 3 or t.shape[0] != B:
            raise ValueError(f"{name} must be per-slot [{B}, ...], got "
                             f"{tuple(t.shape)}")
        strides[name] = _row_stride(t, inner, name)
        if t.data_ptr() % row or (strides[name] * t.element_size()) % row:
            raise ValueError(f"{name} rows must be {row}-byte aligned")
    if tuple(a.shape[:2]) != (B, d) or b.shape[1] != nb:
        raise ValueError(f"adapter records {tuple(a.shape)} / "
                         f"{tuple(b.shape)} for d={d}, b={nb}")
    ln_bs = _row_stride(ls, (nb,), "ln_scale")
    if _row_stride(lb, (nb,), "ln_bias") != ln_bs or ln_bs == 0 \
            or ls.shape[0] != B:
        raise ValueError("ln_scale and ln_bias must be per-slot [B, b] in "
                         "one layout")
    if adapter == "bf16":
        out["bf16"] = [a, b, ls, lb]
        out["bf16_strides"] = [strides["a"], strides["b"], ln_bs]
    else:
        out["bf16"] = [x, x, ls, lb]
        out["bf16_strides"] = [0, 0, ln_bs]
        out["quant_strides"] = [strides["a"],
                                _row_stride(a_s, tuple(a_s.shape[1:]),
                                            "a_scale"),
                                strides["b"],
                                _row_stride(b_s, tuple(b_s.shape[1:]),
                                            "b_scale")]
    out["quant"] = quant
    for t in out["bf16"] + quant:
        if t.device != dev:
            raise ValueError(f"adapter operand on {t.device}, x on {dev}")
    out["nb"] = nb
    return out


def decode_block_fused(x, pos, block, k_cache, v_cache, masks_l, *,
                       norm: str, qkv_bias: bool, use_rope: bool,
                       theta: float, cap: float, mlp_type: str,
                       act_name: str, adapter: str, adapter_act: str):
    """x [B, 1, d] bf16, pos [B] int32, block one layer's params, k/v_cache
    [B, S, KV, hd] both bf16 or both float8_e4m3fn (read, not written),
    masks_l the slots' adapter leaves of route ``adapter`` ("none", "bf16",
    or "int8"/"int4": the quantized records a_q/a_scale/b_q/b_scale) ->
    (y [B, 1, d], k_rows [B, KV, hd], v_rows [B, KV, hd]), the rows in the
    cache's dtype."""
    kw = dict(norm=norm, qkv_bias=qkv_bias, use_rope=use_rope, theta=theta,
              cap=cap, mlp_type=mlp_type, act_name=act_name,
              adapter=adapter, adapter_act=adapter_act)
    if x.device.type in PLAIN_DEVICES:
        return ref.decode_block_ref(x, pos, block, k_cache, v_cache,
                                    masks_l, **kw)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    why = _unsupported(norm, use_rope, mlp_type, act_name, adapter,
                       adapter_act) \
        or _unbuilt_dtypes(x.dtype, k_cache.dtype, v_cache.dtype)
    if why:
        raise NotImplementedError(f"decode megakernel: {why}")
    bf16, f32, dev = torch.bfloat16, torch.float32, x.device
    kv_dt = k_cache.dtype
    if x.ndim != 3 or x.shape[1] != 1:
        raise ValueError(f"x must be [B, 1, d], got {tuple(x.shape)}")
    B, _, d = x.shape
    groups = slot_groups(B)
    _, S, KV, hd = k_cache.shape
    attn, mlp = block["attn"], block["mlp"]
    H = attn["wq"].shape[1]
    ff = mlp["wg"].shape[1]
    _need(x, "x", (B, 1, d), bf16, dev)
    _need(pos, "pos", (B,), torch.int32, dev)
    _need(k_cache, "k_cache", (B, S, KV, hd), kv_dt, dev)
    _need(v_cache, "v_cache", (B, S, KV, hd), kv_dt, dev)
    for name, shape in (("wq", (d, H, hd)), ("wk", (d, KV, hd)),
                        ("wv", (d, KV, hd)), ("wo", (H, hd, d))):
        _need(attn[name], name, shape, bf16, dev)
    for name, shape in (("wg", (d, ff)), ("wu", (d, ff)), ("wd", (ff, d))):
        _need(mlp[name], name, shape, bf16, dev)
    n1 = _need(block["n1"]["scale"], "n1.scale", (d,), f32, dev)
    n2 = _need(block["n2"]["scale"], "n2.scale", (d,), f32, dev)
    if qkv_bias:
        biases = [_need(attn[n], n, s, f32, dev) for n, s in
                  (("bq", (H, hd)), ("bk", (KV, hd)), ("bv", (KV, hd)))]
    else:
        biases = [n1, n1, n1]  # never read
    if H % KV or hd not in (16, 32, 64, 128, 256) \
            or any(n % 16 for n in (d, H * hd, KV * hd, ff)):
        raise NotImplementedError(
            f"decode megakernel shapes d={d} H={H} KV={KV} hd={hd} "
            f"ff={ff}: needs H % KV == 0, hd a power of two in [16, 256] "
            "and widths that are multiples of 16")

    # every group's operands checked before anything launches
    ads = [_adapter_operands({k: v[g] for k, v in (masks_l or {}).items()
                              if k in _ADAPTER_LEAVES}, adapter, x[g])
           for g in groups]
    y = torch.empty_like(x)
    k_rows = torch.empty((B, KV, hd), dtype=kv_dt, device=dev)
    v_rows = torch.empty((B, KV, hd), dtype=kv_dt, device=dev)
    freqs = _inv_freq(hd, float(theta), dev)
    lib = load_library()
    index = dev.index if dev.index is not None \
        else torch.cuda.current_device()
    for g, ad in zip(groups, ads):
        n = g.stop - g.start
        nb = ad["nb"]
        grid, sc, words = _launch_plan(index, n, d, H, KV, hd, ff, S, nb,
                                       adapter, tuple(ad["groups"]), kv_dt)
        scratch = torch.empty(words, dtype=f32, device=dev)
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream().cuda_stream
            err = lib.xpeft_decode_block(
                x[g].data_ptr(), pos[g].data_ptr(), n1.data_ptr(),
                n2.data_ptr(), attn["wq"].data_ptr(), attn["wk"].data_ptr(),
                attn["wv"].data_ptr(), attn["wo"].data_ptr(),
                *(t.data_ptr() for t in biases),
                mlp["wg"].data_ptr(), mlp["wu"].data_ptr(),
                mlp["wd"].data_ptr(), k_cache[g].data_ptr(),
                v_cache[g].data_ptr(),
                *(t.data_ptr() for t in ad["bf16"]), *ad["bf16_strides"],
                freqs.data_ptr(), y[g].data_ptr(), k_rows[g].data_ptr(),
                v_rows[g].data_ptr(), scratch.data_ptr(), n, d, H, KV, hd,
                ff, S, nb, int(qkv_bias), _ROUTES[adapter],
                _ADAPTER_ACTS.get(adapter_act, 0), _MLP_ACTS[act_name],
                float(cap or 0.0),
                ref.attn_scale(hd), *(t.data_ptr() for t in ad["quant"]),
                *ad["quant_strides"], *ad["groups"], sc,
                int(kv_dt == torch.float8_e4m3fn), grid, stream)
        if err:
            raise RuntimeError(f"decode_block_fused launch failed: CUDA "
                               f"error {err}")
        decode_block_fused.launches += 1
    return y, k_rows, v_rows


decode_block_fused.launches = 0
