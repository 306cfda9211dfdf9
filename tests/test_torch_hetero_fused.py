"""The hetero-adapter launch (bottleneck -> LoRA -> IA3 in one kernel)
against the JAX package, on the CPU.

On a CPU tensor ``hetero_adapter_batched`` computes its plain version, the
three existing plain versions composed; these tests hold it to JAX's
composition ``repro.kernels.ops.fused_adapter`` -> ``lora_adapter`` ->
``ia3_apply`` (``impl="ref"``) on the same inputs made from a seed with
numpy, check that the model routes an entry of two or three adapter types
through one ``ops.hetero_adapter`` call and one type through its own op,
and pin the planner's cluster size and shared memory. The CUDA kernel is
held to the CUDA sequence #2 -> #2 (LoRA) -> #7, bit for bit, on the card
by ``chip_smoke.py``.

Tolerances: fp32 at rtol = atol = 1e-5 (the two frameworks sum in other
orders); bf16 at rtol = atol = 2e-2, ``tests/test_torch_kernels.py``'s
bound for the fused adapter in bf16: each stage rounds to bf16 once in
both frameworks, and fp32 sums in another order may flip a rounding by one
bf16 step (2^-8 relative) per stage. Within the port, the route change is
BITWISE.
"""
import itertools

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.configs import get_config as tget_config
from repro_torch.configs import reduce_for_smoke as treduce
from repro_torch.kernels import fused_adapter_batched as KF
from repro_torch.kernels import hetero_adapter as KH
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref

F32_TOL = dict(rtol=1e-5, atol=1e-5)
BF16_TOL = dict(rtol=2e-2, atol=2e-2)
STAGES = ("bottleneck", "lora", "ia3")
SUBSETS = [s for n in (1, 2, 3) for s in itertools.combinations(STAGES, n)]


def _operands(seed, B=3, L=3, T=1, d=32, b=8, r=8, shared=False):
    """x [B, T, d] and one layer of each stage's operands: per-row slices
    of [B, L, ...] buffers (batch strides, as the model passes them), or
    shared ones; numpy fp32."""
    rng = np.random.default_rng(seed)
    lead = () if shared else (B, L)

    def rnd(shape, scale):
        return (scale * rng.normal(size=lead + shape)).astype(np.float32)
    return {"x": rng.normal(size=(B, T, d)).astype(np.float32),
            "a_hat": rnd((d, b), d ** -0.5), "b_hat": rnd((b, d), 0.3),
            "ln_scale": 1.0 + rnd((b,), 0.1), "ln_bias": rnd((b,), 0.1),
            "lora_a": rnd((d, r), d ** -0.5), "lora_b": rnd((r, d), 0.3),
            "ia3_s": rnd((d,), 0.3)}


KEYS = {"bottleneck": ("a_hat", "b_hat", "ln_scale", "ln_bias"),
        "lora": ("lora_a", "lora_b"), "ia3": ("ia3_s",)}


def _layer(v, shared, layer=1):
    return v if shared else v[:, layer]


def _jax(ops_np, subset, shared, dtype, activation):
    """JAX's composition, as its model applies a hetero entry."""
    def j(k):
        v = _layer(ops_np[k], shared)
        return jnp.asarray(v, jnp.float32 if k.startswith("ln") else dtype)
    x = jnp.asarray(ops_np["x"], dtype)
    if "bottleneck" in subset:
        x = jops.fused_adapter(x, *map(j, KEYS["bottleneck"]),
                               activation=activation, impl="ref")
    if "lora" in subset:
        x = jops.lora_adapter(x, j("lora_a"), j("lora_b"), impl="ref")
    if "ia3" in subset:
        x = jops.ia3_apply(x, j("ia3_s"), impl="ref")
    return np.asarray(jnp.asarray(x, jnp.float32))


def _torch_stages(ops_np, subset, shared, dtype):
    """x and the stage kwargs of ``hetero_adapter_batched``: operands as
    torch tensors (layer slices of the [B, L, ...] buffers, no copy)."""
    def t(k):
        full = torch.from_numpy(ops_np[k])
        return _layer(full.to(torch.float32 if k.startswith("ln")
                              else dtype), shared)
    x = torch.from_numpy(ops_np["x"]).to(dtype)
    kw = {name: tuple(t(k) for k in KEYS[name]) for name in subset}
    if "ia3" in kw:
        kw["ia3"] = kw["ia3"][0]
    return x, kw


@pytest.mark.parametrize("subset", SUBSETS, ids="+".join)
@pytest.mark.parametrize("shared", [False, True], ids=["slices", "shared"])
@pytest.mark.parametrize("T", [1, 16])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_hetero_plain_version_matches_jax(dtype, T, shared, subset):
    ops_np = _operands(7, T=T, shared=shared)
    want = _jax(ops_np, subset, shared, getattr(jnp, dtype), "gelu")
    x, kw = _torch_stages(ops_np, subset, shared, getattr(torch, dtype))
    got = KH.hetero_adapter_batched(x, **kw)
    assert got.dtype == x.dtype and got.shape == x.shape
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    np.testing.assert_allclose(got.float().numpy(), want, **tol)


@pytest.mark.parametrize("subset", SUBSETS, ids="+".join)
@pytest.mark.parametrize("activation", ["gelu", "identity"])
def test_hetero_plain_version_is_the_three_calls_bitwise(activation, subset):
    """The plain version is #2 -> #2's LoRA route -> #7's plain versions,
    bit for bit, in bf16 (a rounding between every two stages), through
    ``ops.hetero_adapter`` on both impls and the wrapper; the CPU path
    counts no launch."""
    ops_np = _operands(8, T=5)
    x, kw = _torch_stages(ops_np, subset, False, torch.bfloat16)
    want = x
    if "bottleneck" in kw:
        want = ops.fused_adapter(want, *kw["bottleneck"],
                                 activation=activation)
    if "lora" in kw:
        want = ops.lora_adapter(want, *kw["lora"])
    if "ia3" in kw:
        want = ops.ia3_apply(want, kw["ia3"])
    masks_l = {k: _layer(torch.from_numpy(ops_np[k]).to(
        torch.float32 if k.startswith("ln") else torch.bfloat16), False)
        for name in subset for k in KEYS[name]}
    before = KH.hetero_adapter_batched.launches
    for got in (KH.hetero_adapter_batched(x, activation=activation, **kw),
                ops.hetero_adapter(x, masks_l, activation=activation),
                ops.hetero_adapter(x, masks_l, activation=activation,
                                   impl="ref")):
        assert torch.equal(got, want)
    assert KH.hetero_adapter_batched.launches == before


def test_hetero_zero_adapters_give_x_bitwise():
    """Zero B̂s (bottleneck and LoRA) and s = 0 leave x bitwise."""
    ops_np = _operands(9, T=3)
    for k in ("b_hat", "lora_b", "ia3_s"):
        ops_np[k] = np.zeros_like(ops_np[k])
    for dtype in (torch.float32, torch.bfloat16):
        x, kw = _torch_stages(ops_np, STAGES, False, dtype)
        assert torch.equal(KH.hetero_adapter_batched(x, **kw), x)


# ----------------------------------------------------------------------------
# the model's routing
# ----------------------------------------------------------------------------

def _entry(cfg, B, types, seed=3):
    """Random admitted entries [B, L, ...] carrying the leaves of
    ``types``, in the model's dtype."""
    g = torch.Generator().manual_seed(seed)
    L, d, b = cfg.num_layers, cfg.d_model, cfg.xpeft.bottleneck
    dt = getattr(torch, cfg.dtype)

    def rnd(shape, scale, dtype=dt):
        return (scale * torch.randn((B, L) + shape, generator=g)).to(dtype)
    leaves = {"a_hat": rnd((d, b), d ** -0.5), "b_hat": rnd((b, d), 0.3),
              "ln_scale": 1.0 + rnd((b,), 0.1, torch.float32),
              "ln_bias": rnd((b,), 0.1, torch.float32),
              "lora_a": rnd((d, b), d ** -0.5), "lora_b": rnd((b, d), 0.3),
              "ia3_s": rnd((d,), 0.3)}
    return {k: leaves[k] for name in types for k in KEYS[name]}


@pytest.mark.parametrize("types", SUBSETS, ids="+".join)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_model_routes_hetero_entries(monkeypatch, dtype, types):
    """An entry with two or three adapter types goes through ONE
    ``ops.hetero_adapter`` call per layer and none of the single-type
    ops; an entry with one type through its own op and never the fused
    one. The reduced qwen1.5-0.5b's hidden states are bitwise those of
    the three-call path (``hetero_adapter`` replaced by fused_adapter ->
    lora_adapter -> ia3_apply)."""
    from repro_torch.models import forward, init_lm
    cfg = treduce(tget_config("qwen1.5-0.5b")).with_(dtype=dtype)
    params = init_lm(cfg, seed=0, device="cpu")
    B, T = 2, 5
    masks = _entry(cfg, B, types)
    tokens = torch.randint(0, cfg.vocab_size, (B, T),
                           generator=torch.Generator().manual_seed(4))
    calls = {}

    def counted(name, fn):
        def call(*a, **k):
            calls[name] = calls.get(name, 0) + 1
            return fn(*a, **k)
        return call
    for name in ("hetero_adapter", "fused_adapter", "lora_adapter",
                 "ia3_apply"):
        monkeypatch.setattr(ops, name, counted(name, getattr(ops, name)))
    got, _, _ = forward(params, tokens, cfg, profile_masks=masks)
    L = cfg.num_layers
    if len(types) >= 2:
        assert calls == {"hetero_adapter": L}, calls
    else:
        op = {"bottleneck": "fused_adapter", "lora": "lora_adapter",
              "ia3": "ia3_apply"}[types[0]]
        want_calls = {op: L}
        if op == "lora_adapter":  # the fused adapter op's LoRA route
            want_calls["fused_adapter"] = L
        assert calls == want_calls, calls

    def three_calls(x, masks_l, *, activation, impl):
        if "a_hat" in masks_l:
            x = ops.fused_adapter(x, masks_l["a_hat"], masks_l["b_hat"],
                                  masks_l["ln_scale"], masks_l["ln_bias"],
                                  activation=activation, impl=impl)
        if "lora_a" in masks_l:
            x = ops.lora_adapter(x, masks_l["lora_a"], masks_l["lora_b"],
                                 impl=impl)
        if "ia3_s" in masks_l:
            x = ops.ia3_apply(x, masks_l["ia3_s"], impl=impl)
        return x
    monkeypatch.setattr(ops, "hetero_adapter", three_calls)
    want, _, _ = forward(params, tokens, cfg, profile_masks=masks)
    assert torch.equal(got, want)


# ----------------------------------------------------------------------------
# the planner and the wrapper's checks
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("T", [1, 16, 128])
@pytest.mark.parametrize("itemsize", [2, 4])
def test_hetero_plan_equals_each_stage_plan_at_qwen_widths(itemsize, T):
    """At qwen1.5-0.5b's widths (d=1024, b=r=64) the fused planner picks
    the cluster each stage's own ``fused_adapter_batched.plan`` picks (8
    blocks), for every subset of stages, so the fused output is bitwise
    the separate launches'; with one stage and no IA3 its shared memory
    is #2's exactly."""
    d, b = 1024, 64
    own = KF.plan(d, b, T, itemsize)
    assert own == 8
    tt, mma = (1 if T == 1 else 16), itemsize == 2 and T > 1
    for subset in SUBSETS:
        nbs = [b for s in subset if s != "ia3"]
        for s_item in ((2, 4) if "ia3" in subset else (0,)):
            assert KH.plan(d, nbs, T, itemsize, s_item) == own, subset
            assert KH.smem_bytes(d // own, nbs, tt, itemsize, mma,
                                 s_item) <= KH.MAX_SMEM
    assert KH.smem_bytes(d // 8, [b], tt, itemsize, mma, 0) \
        == KF.smem_bytes(d // 8, b, tt, itemsize, mma)


def test_hetero_plan_refusals_and_layout():
    """Shapes no cluster takes raise (the wrapper never falls back), and
    the layout counts both stages' tiles: at T=1 in bf16, d=1024 over 8
    blocks (a 128-wide slice), b=r=64, a bf16 s."""
    for args in ((1024, [60], 1, 2),              # width not whole vectors
                 (1024, [64, 300], 1, 2),          # width over MAX_B
                 (1000, [64], 1, 2),               # d/cs never 16k
                 (8192, [256, 256], 16, 2),        # smem at 8 and 16
                 (7168, [64, 64], 1, 2),           # bf16: 2 stages overflow
                 (1056, [], 1, 4, 2)):             # bf16 s slice of 132
        with pytest.raises(ValueError):
            KH.plan(*args)
    # d=7168 in bf16 at T=1 (llava-next-34b's width) fits one stage and s
    # at 16 blocks, as #2 alone does, but not two stages' tiles
    assert KF.plan(7168, 64, 1, 2) == KH.plan(7168, [64], 1, 2, 2) == 16
    assert KH.plan(1056, [], 1, 4, 4) == 8  # an fp32 s slice of 132 fits
    # x [1, 136] bf16; per stage Â [128, 72] + B̂ [64, 128] bf16 and the
    # partial [64] fp32; h [64], LN [2, 64] and 256 vectors of 8 fp32
    # up-projection partials; s [128] bf16
    per_stage = 18432 + 16384 + 256
    assert KH.smem_bytes(128, [64, 64], 1, 2, False, 2) == \
        272 + 2 * per_stage + 256 + 512 + 4 * 2048 + 256


def test_hetero_wrapper_checks():
    """The operand checks ``launch`` runs before the kernel: stage dtypes
    one with x, per-row operands of the batch's rows, s 16-byte aligned
    with a stride of whole vectors; a CPU tensor never reaches them."""
    B, L, T, d, b = 2, 3, 1, 32, 8
    bf16 = torch.bfloat16
    x = torch.zeros((B, T, d), dtype=bf16)
    a = torch.zeros((B, L, d, b), dtype=bf16)
    bb = torch.zeros((B, L, b, d), dtype=bf16)
    assert KH._stage(x, a[:, 1], bb[:, 1], "lora") == (b, L * d * b,
                                                        L * b * d)
    assert KH._stage(x, a[0, 1], bb[0, 1], "lora") == (b, 0, 0)
    slot = torch.zeros((B, L, d), dtype=bf16)
    assert KH._ia3_layout(x, slot[:, 1]) == L * d
    assert KH._ia3_layout(x, torch.zeros((d,))) == 0
    for bad in ((x, a[:, 1].float(), bb[:, 1]),
                (x, torch.zeros((B + 1, d, b), dtype=bf16),
                 torch.zeros((B + 1, b, d), dtype=bf16))):
        with pytest.raises((TypeError, ValueError)):
            KH._stage(*bad, "bottleneck")
    for s in (slot[:, 1].half(), torch.zeros((B + 1, d)),
              torch.zeros(B * d + 1)[1:].view(B, d),
              torch.zeros((B, d + 1))[:, 1:]):
        with pytest.raises((TypeError, ValueError)):
            KH._ia3_layout(x, s)
    with pytest.raises(ValueError, match="no kernel"):
        KH.launch(x, bottleneck=None, lora=(a[:, 1], bb[:, 1]), ia3=None,
                  activation="gelu")
