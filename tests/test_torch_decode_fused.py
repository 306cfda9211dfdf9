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
excess precision between fused bf16 ops.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.kernels import ops as jops
from repro.quant import schemes as JQS
from repro_torch.kernels import decode_fused as KD
from repro_torch.kernels import ops

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


def _run_jax(args, kw, impls, dtype):
    """JAX's decode block under each of ``impls``, jitted together."""
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
    return fn(cast(x), jnp.asarray(pos), jb, cast(kc), cast(vc), jm)


def _run_port(args, kw, dtype, impl="auto"):
    x, pos, block, kc, vc, masks_l = args

    def t(a, cast):
        a = torch.from_numpy(np.ascontiguousarray(a))
        return a.to(dtype) if cast else a

    tb = {g: {k: t(w, k.startswith("w")) for k, w in sub.items()}
          for g, sub in block.items()}
    tm = {k: t(w, k.endswith("_hat")) for k, w in masks_l.items()}
    return ops.decode_block_fused(t(x, True), torch.from_numpy(pos), tb,
                                  t(kc, True), t(vc, True), tm, impl=impl,
                                  **kw)


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
    routes none, bf16, int8 and int4; the wrapper names everything else
    before touching the card."""
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
