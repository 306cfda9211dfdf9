"""The port's decode megakernel block against the JAX package, on the CPU.

On a CPU tensor ``ops.decode_block_fused`` computes the plain version
(``repro_torch/kernels/ref.py`` ``decode_block_ref``); these tests hold it
against JAX's ``ops.decode_block_fused`` under ``impl="ref"`` and under
``impl="interpret"`` (the Pallas kernel body), both jitted as the JAX
engine runs them, on the same inputs made from a seed with numpy. The
CUDA kernel is held against the same plain version on the card by
``chip_smoke.py``; the model and engine on the fused route are in
``test_torch_decode_fused_serve.py``.

Tolerances: float32 at rtol = atol = 1e-5 (the frameworks sum in other
orders; inputs are O(1)). bfloat16 at rtol = atol = 2**-6 (two bf16
steps): both sides round at the same points, but an fp32 sum taken in
another order can land a rounding one step apart, and XLA may keep
excess precision between fused bf16 ops. On a float8_e4m3fn cache y
takes the same tolerances and each new K/V row value is JAX's or one
e4m3 step from it (a value the frameworks compute within those bounds of
an e4m3 rounding midpoint may round to either neighbour); the cast into
the cache is held bitwise to ml_dtypes' (JAX's) on a table of edge values.
"""
import ml_dtypes
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.kernels import ops as jops
from repro.quant import schemes as JQS
from repro_torch.kernels import decode_fused as KD
from repro_torch.kernels import ops
from repro_torch.utils.cache_cast import to_cache_dtype

F32_TOL = dict(rtol=1e-5, atol=1e-5)
BF16_TOL = dict(rtol=2.0 ** -6, atol=2.0 ** -6)

# (name, block shape and variant); B=4 slots, S=16 cache rows, d=64
VARIANTS = {
    "qwen": dict(H=4, KV=4, norm="rmsnorm", qkv_bias=True, use_rope=True,
                 cap=0.0, mlp_type="glu", act_name="silu"),
    "gqa_bias": dict(H=4, KV=2, norm="rmsnorm", qkv_bias=True,
                     use_rope=True, cap=0.0, mlp_type="glu",
                     act_name="silu"),
    "layernorm_vanilla_cap": dict(H=4, KV=2, norm="layernorm",
                                  qkv_bias=False, use_rope=False, cap=5.0,
                                  mlp_type="vanilla", act_name="sqrelu"),
}


def _block_inputs(variant, adapter, seed, B=4, S=16, d=64, hd=16, ff=96,
                  nb=8, group=4):
    """numpy inputs for one layer: x, pos (slot 3 past the cache's end),
    the block's weights (biases and norm affines drawn at random), the
    cache rows and the slots' adapter leaves (routes int8/int4: Â/B̂
    quantized by JAX's ``quant.schemes``, int4 at ``group``)."""
    v = VARIANTS[variant]
    H, KV = v["H"], v["KV"]
    rng = np.random.default_rng(seed)

    def n(*shape, sc=1.0):
        return (rng.normal(size=shape) * sc).astype(np.float32)

    def norm():
        p = {"scale": n(d, sc=0.2)}
        if v["norm"] == "layernorm":
            p = {"scale": 1 + n(d, sc=0.2), "bias": n(d, sc=0.2)}
        return p

    attn = {"wq": n(d, H, hd, sc=d ** -0.5), "wk": n(d, KV, hd, sc=d ** -0.5),
            "wv": n(d, KV, hd, sc=d ** -0.5),
            "wo": n(H, hd, d, sc=(H * hd) ** -0.5)}
    if v["qkv_bias"]:
        attn.update(bq=n(H, hd, sc=0.2), bk=n(KV, hd, sc=0.2),
                    bv=n(KV, hd, sc=0.2))
    if v["mlp_type"] == "glu":
        mlp = {"wg": n(d, ff, sc=d ** -0.5), "wu": n(d, ff, sc=d ** -0.5),
               "wd": n(ff, d, sc=ff ** -0.5)}
    else:
        mlp = {"w1": n(d, ff, sc=d ** -0.5), "b1": n(ff, sc=0.2),
               "w2": n(ff, d, sc=ff ** -0.5), "b2": n(d, sc=0.2)}
    block = {"n1": norm(), "n2": norm(), "attn": attn, "mlp": mlp}
    masks_l = {}
    if adapter == "bf16":
        masks_l = {"a_hat": n(B, d, nb, sc=d ** -0.5),
                   "b_hat": n(B, nb, d, sc=0.3),
                   "ln_scale": 1 + n(B, nb, sc=0.2),
                   "ln_bias": n(B, nb, sc=0.2)}
    elif adapter in ("int8", "int4"):
        qa = JQS.quantize(n(B, d, nb, sc=d ** -0.5), adapter, group=group)
        qb = JQS.quantize(n(B, nb, d, sc=0.3), adapter, group=group)
        masks_l = {"a_q": np.array(qa["q"]),
                   "a_scale": np.array(qa["scale"]),
                   "b_q": np.array(qb["q"]),
                   "b_scale": np.array(qb["scale"]),
                   "ln_scale": 1 + n(B, nb, sc=0.2),
                   "ln_bias": n(B, nb, sc=0.2)}
    x = n(B, 1, d)
    kc, vc = n(B, S, KV, hd), n(B, S, KV, hd)
    pos = np.array([3, 0, S - 1, S + 4], np.int32)
    kw = dict(norm=v["norm"], qkv_bias=v["qkv_bias"],
              use_rope=v["use_rope"], theta=1e6, cap=v["cap"],
              mlp_type=v["mlp_type"], act_name=v["act_name"],
              adapter=adapter, adapter_act="gelu")
    return (x, pos, block, kc, vc, masks_l), kw


def _run_jax(args, kw, impls, dtype, cache_dtype=None):
    """JAX's decode block under each of ``impls``, jitted together; the
    caches in ``cache_dtype`` (cast from float32), else the working
    dtype."""
    def cast(a):
        a = jnp.asarray(a)
        return a.astype(dtype) if a.dtype == jnp.float32 and a.ndim > 1 \
            else a

    x, pos, block, kc, vc, masks_l = args
    # weights, activations, cache and Â/B̂ in the working dtype; biases,
    # norm and LN affines stay fp32, as the model keeps them
    jb = {g: {k: cast(w) if k.startswith("w") else jnp.asarray(w)
              for k, w in sub.items()} for g, sub in block.items()}
    jm = {k: cast(w) if k.endswith("_hat") else jnp.asarray(w)
          for k, w in masks_l.items()}
    fn = jax.jit(lambda *a: [jops.decode_block_fused(*a, impl=impl, **kw)
                             for impl in impls])
    kc, vc = ((jnp.asarray(c).astype(cache_dtype) if cache_dtype else
               cast(c)) for c in (kc, vc))
    return fn(cast(x), jnp.asarray(pos), jb, kc, vc, jm)


def _run_port(args, kw, dtype, impl="auto", cache_dtype=None):
    x, pos, block, kc, vc, masks_l = args

    def t(a, cast):
        a = torch.from_numpy(np.ascontiguousarray(a))
        return a.to(dtype) if cast else a

    tb = {g: {k: t(w, k.startswith("w")) for k, w in sub.items()}
          for g, sub in block.items()}
    tm = {k: t(w, k.endswith("_hat")) for k, w in masks_l.items()}
    kc, vc = ((to_cache_dtype(t(c, False), cache_dtype) if cache_dtype
               else t(c, True)) for c in (kc, vc))
    return ops.decode_block_fused(t(x, True), torch.from_numpy(pos), tb,
                                  kc, vc, tm, impl=impl, **kw)


def _f32(a):
    return a.float().numpy() if torch.is_tensor(a) else \
        np.asarray(jnp.asarray(a, jnp.float32))


@pytest.mark.parametrize("variant,adapter", [
    ("qwen", "none"), ("qwen", "bf16"), ("gqa_bias", "bf16"),
    ("layernorm_vanilla_cap", "bf16"), ("qwen", "int8"), ("qwen", "int4"),
    ("gqa_bias", "int4")])
def test_plain_decode_block_matches_jax_f32(variant, adapter):
    args, kw = _block_inputs(variant, adapter, seed=0)
    before = KD.decode_block_fused.launches
    got = _run_port(args, kw, torch.float32)
    assert KD.decode_block_fused.launches == before  # CPU: plain version
    want = _run_jax(args, kw, ("ref", "interpret"), jnp.float32)
    for i, name in enumerate(("y", "k_rows", "v_rows")):
        assert got[i].dtype == torch.float32
        assert tuple(got[i].shape) == tuple(want[0][i].shape), name
        for w in want:
            np.testing.assert_allclose(got[i].numpy(), _f32(w[i]),
                                       err_msg=name, **F32_TOL)


@pytest.mark.parametrize("adapter", ["none", "bf16", "int8", "int4"])
def test_plain_decode_block_matches_jax_bf16(adapter):
    args, kw = _block_inputs("gqa_bias", adapter, seed=1)
    got = _run_port(args, kw, torch.bfloat16)
    want, = _run_jax(args, kw, ("ref",), jnp.bfloat16)
    for g, w, name in zip(got, want, ("y", "k_rows", "v_rows")):
        assert g.dtype == torch.bfloat16, name
        np.testing.assert_allclose(_f32(g), _f32(w), err_msg=name,
                                   **BF16_TOL)


def _e4m3_ordinal(b):
    """float8_e4m3fn bytes (no NaN) as their place among the finite values
    in order, +0 and -0 at 0: neighbouring values differ by 1."""
    b = np.asarray(b).astype(np.int32)
    assert not ((b & 0x7F) == 0x7F).any()
    return np.where(b & 0x80, -(b & 0x7F), b & 0x7F)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("adapter", ["none", "bf16", "int8", "int4"])
def test_plain_decode_block_float8_cache_matches_jax(adapter, dtype,
                                                     monkeypatch):
    """The plain decode block over float8_e4m3fn caches (x, weights and Â/B̂
    in ``dtype``) against JAX's ``decode_block_ref``: the cached rows read
    back exactly, the new K/V rows returned in float8 and substituted at
    pos after their round trip through it. Each K/V row value is JAX's or
    one e4m3 step from it (the count is printed): in bf16 the two
    frameworks' k and v may lie a bf16 step apart (within BF16_TOL), and
    where that step straddles an e4m3 rounding midpoint the float8 values
    part by one e4m3 step (2^-3 of the value), which moves that slot's
    attention at pos by more than BF16_TOL. So y is held to the dtype's
    tolerance on a second run of the port with JAX's float8 rows in place
    of its own (``ref.to_cache_dtype`` fed them): every other operation of
    the block is checked there. At float32 the rows are equal and the
    port's own run is held to F32_TOL too. The inputs are
    ``test_plain_decode_block_matches_jax_bf16``'s (seed 1), only the cache
    dtype differs."""
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    f8 = torch.float8_e4m3fn
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    args, kw = _block_inputs("gqa_bias", adapter, seed=1)
    got = _run_port(args, kw, tdt, cache_dtype=f8)
    want, = _run_jax(args, kw, ("ref",), jdt, cache_dtype=jnp.float8_e4m3fn)
    assert got[0].dtype == tdt
    apart = 0
    for g, w, name in zip(got[1:], want[1:], ("k_rows", "v_rows")):
        assert g.dtype == f8 and w.dtype == jnp.float8_e4m3fn
        steps = np.abs(_e4m3_ordinal(g.view(torch.uint8).numpy())
                       - _e4m3_ordinal(np.asarray(w).view(np.uint8)))
        assert steps.max() <= 1, name
        apart += int(steps.sum())
    print(f"{adapter} {dtype}: {apart} K/V row values one e4m3 step apart")
    if dtype == "float32":
        assert apart == 0
        np.testing.assert_allclose(_f32(got[0]), _f32(want[0]),
                                   err_msg="y", **tol)
    # JAX's rows in the port's slot order: k then v of each slot
    jax_rows = iter([torch.from_numpy(np.array(w[i]).view(np.uint8))
                     .view(f8) for i in range(want[1].shape[0])
                     for w in want[1:]])
    monkeypatch.setattr(KD.ref, "to_cache_dtype",
                        lambda t, dtype: next(jax_rows))
    fed = _run_port(args, kw, tdt, cache_dtype=f8)
    np.testing.assert_allclose(_f32(fed[0]), _f32(want[0]), err_msg="y",
                               **tol)


# (value, why): the edges of float8_e4m3fn's cast
E4M3_EDGES = (
    (448.0, "the largest finite value"), (-448.0, "its negative"),
    (432.0, "the tie between 416 and 448: to 448, the even"),
    (440.0, "between 432 and 448"), (463.9, "just under 464: 448"),
    (464.0, "the tie between 448 and 480 (NaN's code): to 448"),
    (464.0625, "just past 464: NaN"), (-464.0625, "its negative: -NaN"),
    (479.0, "NaN"), (480.0, "NaN"), (1.0e6, "NaN"), (np.inf, "NaN"),
    (-np.inf, "-NaN"), (np.nan, "NaN"), (-np.nan, "-NaN"),
    (2.0 ** -9, "the least subnormal"), (-(2.0 ** -9), "its negative"),
    (2.0 ** -10, "the tie between 0 and 2^-9: to 0"),
    (3 * 2.0 ** -10, "the tie between 2^-9 and 2^-8: to 2^-8, the even"),
    (5 * 2.0 ** -10, "the tie between 2^-8 and 3 * 2^-9: to 2^-8"),
    (2.0 ** -6 - 2.0 ** -10, "rounds up to 2^-6, the least normal"),
    (2.0 ** -6, "the least normal"), (2.0 ** -11, "under half the least "
                                      "subnormal: 0"),
    (0.0, "+0"), (-0.0, "-0"), (1.0625, "the tie between 1 and 1.125: 1"),
    (1.1875, "the tie between 1.125 and 1.25: 1.25"),
    (3.0, "exact"), (-17.5, "the tie between -17 and -18: -18"),
    (240.0, "exact"), (248.0, "the tie between 240 and 256: 256"))


def _f8_of_twin(f):
    """numpy twin of the decode megakernel's ``f8_of``
    (csrc/decode_fused.cu): fp32 -> e4m3fn byte by bit arithmetic, the
    subnormals by one fp32 add."""
    f = np.asarray(f, np.float32)
    bits = f.view(np.uint32).astype(np.uint64)
    sign = bits & 0x80000000
    mag = bits ^ sign
    denorm = np.float32(2.0 ** 14)
    with np.errstate(invalid="ignore", over="ignore"):  # NaN, inf lanes
        sub = ((mag.astype(np.uint32).view(np.float32) + denorm)
               .view(np.uint32).astype(np.uint64) - (141 << 23))
    odd = (mag >> 20) & 1
    normal = ((mag - (120 << 23) + 0x7FFFF + odd) >> 20) & 0xFF
    r = np.where(mag >= (1087 << 20), 0x7F,
                 np.where(mag < (121 << 23), sub, normal))
    return (r | (sign >> 24)).astype(np.uint8)


@pytest.mark.parametrize("src", ["float32", "bfloat16"])
def test_cache_cast_edges_match_ml_dtypes(src):
    """The port's cast into a float8_e4m3fn cache (``to_cache_dtype``,
    which ``write_cache`` and the plain decode block use) is ml_dtypes'
    (JAX's ``astype``) bit for bit at every edge of E4M3_EDGES, from float32
    and from bfloat16 (the edges the bf16 grid holds), NaN with its sign
    included: no saturation, whatever the installed PyTorch's own ``.to``
    does. The megakernel's bit arithmetic (its numpy twin here, the
    source's constants checked) agrees too; on the card chip_smoke's phase
    18 holds the kernel's bytes to this cast."""
    vals = np.array([v for v, _ in E4M3_EDGES], np.float32)
    t = torch.from_numpy(vals).to(getattr(torch, src))
    exact = t.float().numpy()  # the values the source dtype holds
    with np.errstate(invalid="ignore", over="ignore"):
        want = exact.astype(ml_dtypes.float8_e4m3fn).view(np.uint8)
    got = to_cache_dtype(t, torch.float8_e4m3fn).view(torch.uint8).numpy()
    for (v, why), g, w in zip(E4M3_EDGES, got, want):
        assert g == w, (v, why, hex(g), hex(w))
    np.testing.assert_array_equal(_f8_of_twin(exact), want)


def test_kernel_cast_twin_matches_ml_dtypes_everywhere():
    """The twin of the kernel's ``f8_of`` against ml_dtypes over 2^20
    float32 values spread over every exponent the cast meets (both signs,
    subnormal inputs, past 480, NaN and inf), and the kernel source holds
    the twin's constants."""
    from repro_torch.kernels._build import CSRC
    src = (CSRC / "decode_fused.cu").read_text()
    for const in ("1087u << 20", "121u << 23", "141u << 23",
                  "static_cast<uint32_t>(7 - 127) << 23) + 0x7ffffu + odd"):
        assert const in src, const
    rng = np.random.default_rng(7)
    bits = rng.integers(0, 2 ** 32, size=2 ** 20, dtype=np.uint64)
    # exponents 100..140 (2^-27 .. 2^13) where the cast changes, and the
    # rest at random
    exp = rng.integers(100, 141, size=bits.size, dtype=np.uint64)
    near = (bits & 0x807FFFFF) | (exp << 23)
    vals = np.where(rng.random(bits.size) < 0.9, near, bits).astype(
        np.uint32).view(np.float32)
    vals = np.concatenate([vals, np.array([np.inf, -np.inf, np.nan],
                                          np.float32)])
    with np.errstate(invalid="ignore", over="ignore"):
        want = vals.astype(ml_dtypes.float8_e4m3fn).view(np.uint8)
    got = _f8_of_twin(vals)
    # NaN bytes: ml_dtypes keeps the input's sign, as the kernel does
    np.testing.assert_array_equal(got, want)


def test_plain_decode_block_dispatch_and_past_the_end():
    """``auto`` on a CPU tensor and ``ref`` give the same result; a slot at
    pos >= S substitutes no row and attends every cache row (the new row
    is returned for the caller to drop)."""
    args, kw = _block_inputs("qwen", "bf16", seed=2)
    auto = _run_port(args, kw, torch.float32)
    plain = _run_port(args, kw, torch.float32, impl="ref")
    for a, p in zip(auto, plain):
        assert torch.equal(a, p)
    x, pos, block, kc, vc, masks_l = args
    S = kc.shape[1]
    assert pos[2] == S - 1 and pos[3] >= S
    # cache row S-1 moved in slots 2 and 3: slot 2 (pos S-1) reads its new
    # row there instead, slot 3 (pos past the end) attends the cache row
    kc2 = kc.copy()
    kc2[2:, -1] += 1.0
    moved = _run_port((x, pos, block, kc2, vc, masks_l), kw, torch.float32)
    assert torch.equal(moved[0][:3], auto[0][:3])
    assert not torch.equal(moved[0][3], auto[0][3])


def test_kernel_refuses_unbuilt_variants():
    """The CUDA path builds RMSNorm, GLU-SiLU and GLU-GELU and RoPE with
    routes none, bf16, int8 and int4, bf16 activations over two bf16 or two
    float8_e4m3fn caches; the wrapper names everything else before
    touching the card."""
    base = dict(norm="rmsnorm", use_rope=True, mlp_type="glu",
                act_name="silu", adapter="bf16", adapter_act="gelu")
    assert KD._unsupported(**base) is None
    for accept in (dict(adapter="none"), dict(adapter_act="identity"),
                   dict(adapter="int8"), dict(adapter="int4"),
                   dict(adapter="int4", adapter_act="identity"),
                   dict(act_name="gelu")):
        assert KD._unsupported(**dict(base, **accept)) is None, accept
    for change in (dict(norm="layernorm"), dict(mlp_type="vanilla"),
                   dict(act_name="relu"), dict(use_rope=False),
                   dict(adapter="int2"), dict(adapter_act="relu"),
                   dict(adapter="int8", adapter_act="relu")):
        assert KD._unsupported(**dict(base, **change)), change
    bf16, f8 = torch.bfloat16, torch.float8_e4m3fn
    for x, k, v in ((bf16, bf16, bf16), (bf16, f8, f8)):
        assert KD._unbuilt_dtypes(x, k, v) is None, (x, k, v)
    for x, k, v in ((bf16, f8, bf16), (bf16, bf16, f8),
                    (bf16, torch.float8_e5m2, torch.float8_e5m2),
                    (bf16, torch.float16, torch.float16),
                    (torch.float16, bf16, bf16), (torch.float32, bf16, bf16),
                    (torch.float32, f8, f8)):
        why = KD._unbuilt_dtypes(x, k, v)
        assert why, (x, k, v)
        if x != bf16:
            assert "ROADMAP queue 2, item 1" in why


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("adapter", ["bf16", "int4"])
def test_rows_past_pos_are_not_read(adapter, dtype):
    """The CUDA kernel reads only cache rows s <= min(pos, S-1): those past
    it get a softmax weight of exactly 0. So cache rows past pos filled
    with large finite values (up to ~1e38, enough to overflow q.K to inf)
    leave y and the K/V rows bitwise equal to those from zero rows, in the
    port's plain version and in JAX's ``decode_block_row`` alike, in bf16
    and fp32; a slot at pos >= S has no such row. At fp32 the two packages
    also agree within F32_TOL (bf16 across packages:
    test_plain_decode_block_matches_jax_bf16)."""
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    args, kw = _block_inputs("gqa_bias", adapter, seed=4)
    x, pos, block, kc, vc, masks_l = args
    S = kc.shape[1]
    assert pos.max() >= S
    past = np.arange(S)[None, :] > np.minimum(pos, S - 1)[:, None]
    rng = np.random.default_rng(5)
    big = rng.choice([-1.0, 1.0], size=kc.shape) * 10.0 ** rng.uniform(
        20, 38, size=kc.shape)
    runs = {}
    for name, fill in (("zero", 0.0), ("big", big)):
        kc2 = np.where(past[..., None, None], fill, kc).astype(np.float32)
        vc2 = np.where(past[..., None, None], fill[::-1] if name == "big"
                       else fill, vc).astype(np.float32)
        a = (x, pos, block, kc2, vc2, masks_l)
        runs[name] = (_run_port(a, kw, tdt), _run_jax(a, kw, ("ref",), jdt)[0])
    for i, name in enumerate(("y", "k_rows", "v_rows")):
        assert torch.equal(runs["zero"][0][i], runs["big"][0][i]), name
        np.testing.assert_array_equal(_f32(runs["zero"][1][i]),
                                      _f32(runs["big"][1][i]), err_msg=name)
        assert torch.isfinite(runs["big"][0][i].float()).all(), name
        if dtype == "float32":
            np.testing.assert_allclose(_f32(runs["big"][0][i]),
                                       _f32(runs["big"][1][i]),
                                       err_msg=name, **F32_TOL)


QWEN_SHAPES = dict(d=1024, H=16, KV=16, hd=64, ff=2816, nb=64)


def _layer_bytes_by_block(B, d, H, KV, hd, ff, nb, grid):
    """The weight and adapter bytes each of ``grid`` blocks streams over
    one layer, tasks dealt as the kernel deals them (csrc/decode_fused.cu
    fill_layout / first_task): round-robin, each phase starting where the
    last one's tasks ended."""
    c = lambda n, r: -(-n // r)  # noqa: E731
    phases = [(c(H * hd, 16) + 2 * c(KV * hd, 16), d * 32),  # QKV
              (0, 0),                                         # attention
              (c(d, 16), H * hd * 32),                        # Wo
              (c(ff, 8), d * 32),                             # gate|up
              (c(d, 16), ff * 32),                            # down
              (B * c(nb, 16), d * 32),                        # A_hat
              (B * c(d, 16), nb * 32)]                        # B_hat
    load, start = [0] * grid, 0
    for n, nbytes in phases:
        for t in range(n):
            load[(start + t) % grid] += nbytes
        start += n
    return load


@pytest.mark.parametrize("S", [128, 2048])
def test_decode_plan(S):
    """The megakernel's attention split at qwen1.5-0.5b for 1 to 8 slots:
    the splits cover S exactly; S=128 is one split (a stage holds the
    cache's K and V rows, so no item waits on another block), S=2048 is
    split in stages of 256 K rows and its items outnumber an H100's 132
    blocks from 2 slots on; the block's shared memory fits the 232,448
    bytes the card allows; and the tasks, dealt round-robin, give no block
    more than 1.3x the mean weight bytes of a layer."""
    hd = QWEN_SHAPES["hd"]
    for B in range(1, KD.MAX_SLOTS + 1):
        for adapter in ("none", "bf16", "int8", "int4"):
            sc = KD.plan(B, S=S, adapter=adapter, **QWEN_SHAPES)
            splits = -(-S // sc)
            assert sc % 16 == 0 and (splits - 1) * sc < S <= splits * sc
            if splits == 1:
                assert 4 * sc * hd <= KD.STAGE_BYTES
            else:
                assert 2 * sc * hd <= KD.STAGE_BYTES
                assert 4 * (-(-S // 16) * 16) * hd > KD.STAGE_BYTES
                if B >= 2:
                    assert B * QWEN_SHAPES["H"] * splits >= 132
        assert KD.smem_bytes(B, QWEN_SHAPES["d"], QWEN_SHAPES["H"], hd,
                             QWEN_SHAPES["ff"]) <= KD.MAX_SMEM
        load = _layer_bytes_by_block(B, grid=132, **QWEN_SHAPES)
        assert max(load) <= 1.3 * sum(load) / len(load), B
    assert KD.plan(4, S=128, adapter="bf16", **QWEN_SHAPES) == 128
    assert KD.plan(4, S=2048, adapter="bf16", **QWEN_SHAPES) == 256
    assert KD.plan(4, S=100, adapter="bf16", **QWEN_SHAPES) == 112


@pytest.mark.parametrize("hd", [64, 128, 256])
def test_decode_plan_float8_cache(hd):
    """On a float8_e4m3fn cache a stage holds twice the rows of one head
    (1-byte values): one split where K and V of the whole cache fit (S <=
    256 at hd 64, 128 at hd 128), else splits of a stage's K rows, at most
    256; every split within one stage at the cache's bytes, as the kernel's
    ``valid`` requires. The bf16 plan is unchanged."""
    f8 = torch.float8_e4m3fn
    shapes = dict(QWEN_SHAPES, H=1024 // hd, KV=1024 // hd, hd=hd)
    for S in (1, 16, 100, 128, 200, 256, 300, 1000, 2048, 4096):
        for dt, eb in ((torch.bfloat16, 2), (f8, 1)):
            sc = KD.plan(4, S=S, adapter="bf16", cache_dtype=dt, **shapes)
            splits = -(-S // sc)
            assert sc % 16 == 0 and sc <= 256 and (splits - 1) * sc < S
            assert (2 if splits == 1 else 1) * eb * sc * hd <= KD.STAGE_BYTES
        if hd == 64:
            assert KD.plan(4, S=S, adapter="bf16", **shapes) == \
                KD.plan(4, S=S, adapter="bf16", cache_dtype=torch.bfloat16,
                        **shapes)
    at = lambda S: KD.plan(4, S=S, adapter="bf16",  # noqa: E731
                           cache_dtype=f8, **shapes)
    if hd == 64:
        assert (at(128), at(256), at(2048)) == (128, 256, 256)
        assert KD.plan(4, S=256, adapter="bf16", **shapes) == 128
    if hd == 128:
        assert (at(128), at(256)) == (128, 128)
        assert KD.plan(4, S=128, adapter="bf16", **shapes) == 64
    with pytest.raises(ValueError, match="float8_e5m2"):
        KD.plan(4, S=128, adapter="bf16", cache_dtype=torch.float8_e5m2,
                **shapes)


def test_decode_plan_refusals():
    """Shapes the kernel does not build raise before anything launches."""
    base = dict(B=4, S=128, adapter="bf16", **QWEN_SHAPES)
    for change in (dict(B=0), dict(B=9), dict(hd=48), dict(hd=512),
                   dict(H=16, KV=3), dict(d=1000), dict(ff=2820),
                   dict(nb=60), dict(nb=512), dict(S=0)):
        with pytest.raises(ValueError):
            KD.plan(**dict(base, **change))
    # route none takes no bottleneck; rows past shared memory come in
    # windows
    KD.plan(**dict(base, adapter="none", nb=0))
    KD.plan(**dict(base, B=8, ff=14336))


def test_decode_plan_matches_the_kernel():
    """The Python geometry is the C source's: the same threads, task
    columns, stage size, stages and row padding, and the same shared
    memory formula."""
    import re
    from repro_torch.kernels._build import CSRC
    src = (CSRC / "decode_fused.cu").read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src)[1])
    assert const("kThreads") == KD.THREADS
    assert const("kNT") == KD.TASK_COLS
    assert const("kStage") == KD.STAGE_BYTES
    assert const("kStages") == KD.STAGES
    assert const("kChunk") == KD.CHUNK
    assert const("kPad") == KD.ROW_PAD
    assert const("kMaxSmem") == KD.MAX_SMEM
    assert const("kMisc") == 64
    assert ("2LL * NB * (kin + kPad) + 4LL * (kWarps * NB * kNT + kMisc)"
            in src)
    assert "return static_cast<int>((room / (2 * NB) - kPad) / kChunk * " \
        "kChunk);" in src
    # an attention split's rows in one stage at the cache's bytes a value
    assert "(splits == 1 ? 2 : 1) * a.kvb * a.sc * a.hd > kStage" in src
    assert "a.f8 = f8, a.kvb = f8 ? 1 : 2;" in src
