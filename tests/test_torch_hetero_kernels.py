"""The port's heterogeneous-bank modules against the JAX package, on the CPU.

Covers what the heterogeneous serving path adds below the engine: the IA3
scaling (TPU kernel #7's plain version, its ``ops`` dispatch and the CUDA
wrapper's input checks), the LoRA route of the fused adapter, the typed
bank's layout, the typed k-sparse admission aggregation, and attention's
``front_skip`` gate with a per-request ``cache_pos``. Inputs are made from
a seed with numpy and handed to both frameworks; JAX's Pallas kernel runs
in interpret mode. The CUDA kernel is held to the same plain version on
the card by ``chip_smoke.py``.

Tolerances: IA3 is BITWISE (fp32 (1 + s), one multiply, one rounding, in
both frameworks); everything else rtol = atol = 1e-5 at float32 (the two
frameworks sum in other orders).
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs import get_config, reduce_for_smoke
from repro.core import adapters as JA
from repro.core import xpeft as JXP
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.ia3_apply import ia3_apply_batched as pallas_ia3
from repro.models import attention as JATT
from repro_torch import bridge
from repro_torch.configs import get_config as tget_config
from repro_torch.configs import reduce_for_smoke as treduce
from repro_torch.core import adapters as TA
from repro_torch.core import xpeft as TXP
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref
from repro_torch.kernels.ia3_apply import _check, ia3_apply_batched
from repro_torch.models import attention as TATT

SPEC = (("bottleneck", 4), ("lora", 4), ("ia3", 2), ("prefix", 2))
TOL = dict(rtol=1e-5, atol=1e-5)


def _cfgs():
    kw = dict(num_adapters=12, bottleneck=4, k=4, max_profiles=8,
              bank_spec=SPEC, prefix_tokens=2)
    return (reduce_for_smoke(get_config("qwen1.5-0.5b")).with_xpeft(**kw),
            treduce(tget_config("qwen1.5-0.5b")).with_xpeft(**kw))


def _jnp(a, dtype):
    return jnp.asarray(a, dtype)


def _torch(a, dtype):
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dtype)


def _bits(x):
    """Raw bytes of an array or tensor (bf16 through a 16-bit view)."""
    if torch.is_tensor(x):
        return bridge.to_numpy(x).tobytes()
    return np.asarray(x).tobytes()


# ----------------------------------------------------------------------------
# (a) IA3: plain version, dispatch, the CUDA wrapper's checks
# ----------------------------------------------------------------------------

def _ia3_inputs(seed, B=3, T=5, d=32, shared=False):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, T, d)).astype(np.float32)
    s = (0.3 * rng.normal(size=(d,) if shared else (B, d))).astype(
        np.float32)
    return x, s


@pytest.mark.parametrize("shared", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ia3_plain_version_bitwise_jax(dtype, shared):
    x, s = _ia3_inputs(0, shared=shared)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jx, js, tx, ts = _jnp(x, jdt), _jnp(s, jdt), _torch(x, tdt), \
        _torch(s, tdt)
    want = jref.ia3_apply_batched_ref(jx, js)
    want_pallas = pallas_ia3(jx, js, interpret=True)
    assert _bits(want) == _bits(want_pallas)
    for got in (tref.ia3_apply_batched_ref(tx, ts),
                ops.ia3_apply(tx, ts, impl="ref"),
                ops.ia3_apply(tx, ts, impl="auto"),
                ia3_apply_batched(tx, ts)):
        assert got.dtype == tdt and got.shape == tx.shape
        assert _bits(got) == _bits(want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ia3_two_d_form_and_mixed_dtypes(dtype):
    """x [T, d] squeezes through ops.ia3_apply as JAX's does; an fp32 s
    scales bf16 x (and the reverse) with one rounding to x's dtype."""
    x, s = _ia3_inputs(1, B=1, shared=True)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    other_j = jnp.bfloat16 if dtype == "float32" else jnp.float32
    other_t = torch.bfloat16 if dtype == "float32" else torch.float32
    want = jops.ia3_apply(_jnp(x[0], jdt), _jnp(s, other_j), impl="ref")
    got = ops.ia3_apply(_torch(x[0], tdt), _torch(s, other_t))
    assert got.shape == x[0].shape and got.dtype == tdt
    assert _bits(got) == _bits(want)
    want_i = jops.ia3_apply(_jnp(x[0], jdt), _jnp(s, other_j),
                            impl="interpret")
    assert _bits(got) == _bits(want_i)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ia3_zero_scale_is_bitwise_identity(dtype):
    x, _ = _ia3_inputs(2)
    tx = _torch(x, getattr(torch, dtype))
    for s in (torch.zeros((3, 32)), torch.zeros((32,)),
              torch.zeros((3, 32), dtype=torch.bfloat16)):
        assert torch.equal(ops.ia3_apply(tx, s), tx)
        assert torch.equal(ops.ia3_apply(tx, s, impl="ref"), tx)


def test_ia3_counter_moves_only_on_the_card():
    x, s = _ia3_inputs(3)
    before = ia3_apply_batched.launches
    ops.ia3_apply(_torch(x, torch.float32), _torch(s, torch.float32))
    assert ia3_apply_batched.launches == before


def test_ia3_input_checks():
    """The layouts the kernel takes: a layer slice of [B, L, d] (its batch
    stride), a shared [d] (stride 0); everything else raises."""
    B, L, T, d = 3, 4, 2, 32
    x = torch.zeros((B, T, d), dtype=torch.bfloat16)
    slot = torch.zeros((B, L, d), dtype=torch.bfloat16)
    assert _check(x, slot[:, 1]) == L * d
    assert _check(x, torch.zeros((d,))) == 0
    assert _check(x.float(), slot[:, 2]) == L * d
    for bad in ((x, slot[:, 1].half()), (x.double(), torch.zeros((d,))),
                (x.transpose(1, 2), torch.zeros((T,))),
                (x, torch.zeros((B + 1, d))), (x, torch.zeros((B, d + 8))),
                (x[0], torch.zeros((d,))),
                (x, torch.zeros((d, B)).t()),
                (torch.zeros((B, T, 12), dtype=torch.bfloat16),
                 torch.zeros((12,))),
                (x, torch.zeros((B, d + 1))[:, 1:])):
        with pytest.raises((TypeError, ValueError)):
            _check(*bad)


# ----------------------------------------------------------------------------
# (b) the LoRA route
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("shared", [False, True])
@pytest.mark.parametrize("T", [1, 6])
def test_lora_adapter_matches_jax(T, shared):
    rng = np.random.default_rng(4)
    B, d, b = 3, 32, 4
    lead = () if shared else (B,)
    x = rng.normal(size=(B, T, d)).astype(np.float32)
    a = (rng.normal(size=lead + (d, b)) / np.sqrt(d)).astype(np.float32)
    bb = (0.3 * rng.normal(size=lead + (b, d))).astype(np.float32)
    want = jops.lora_adapter(jnp.asarray(x), jnp.asarray(a),
                             jnp.asarray(bb), impl="ref")
    f32 = torch.float32
    for impl in ("auto", "ref"):
        got = ops.lora_adapter(_torch(x, f32), _torch(a, f32),
                               _torch(bb, f32), impl=impl)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    # the unbatched form
    want1 = jops.lora_adapter(jnp.asarray(x[0]), jnp.asarray(a if shared
                                                             else a[0]),
                              jnp.asarray(bb if shared else bb[0]),
                              impl="ref")
    got1 = ops.lora_adapter(_torch(x[0], f32),
                            _torch(a if shared else a[0], f32),
                            _torch(bb if shared else bb[0], f32))
    np.testing.assert_allclose(got1.numpy(), np.asarray(want1), **TOL)


def test_lora_route_passes_no_ln_affines():
    """The LoRA route hands #2 no LN affines (null pointers, stride 0);
    with use_ln, or given one affine only, the wrapper raises."""
    from repro_torch.kernels.fused_adapter_batched import _ln_layout
    B, b = 3, 4
    assert _ln_layout(None, None, b, False) == ((), 0)
    ls, lb = torch.ones((B, b)), torch.zeros((B, b))
    assert _ln_layout(ls, lb, b, True)[1] == b
    assert _ln_layout(ls[0], lb[0], b, False)[1] == 0
    for bad in ((None, None, b, True), (ls, None, b, False),
                (ls.double(), lb, b, True), (ls, lb[0], b, True),
                (ls, lb, b + 1, True)):
        with pytest.raises((TypeError, ValueError)):
            _ln_layout(*bad)


def test_lora_zero_b_is_bitwise_identity():
    x = torch.randn((2, 5, 16), generator=torch.Generator().manual_seed(0))
    a = torch.randn((2, 16, 4), generator=torch.Generator().manual_seed(1))
    assert torch.equal(ops.lora_adapter(x, a, torch.zeros((2, 4, 16))), x)


# ----------------------------------------------------------------------------
# (c) the typed bank
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_hetero_bank_layout_matches_jax(dtype):
    cfg, tcfg = _cfgs()
    L, d, kv = cfg.num_layers, cfg.d_model, cfg.kv_dim
    want = JA.init_hetero_bank(jax.random.key(0), L, cfg.xpeft, d, kv,
                               getattr(jnp, dtype))
    got = TA.init_hetero_bank(L, tcfg.xpeft, d, kv, getattr(torch, dtype),
                              generator=torch.Generator().manual_seed(0),
                              device="cpu")
    assert list(got) == list(want)
    for key, w in want.items():
        assert tuple(got[key].shape) == w.shape, key
        assert bridge.to_numpy(got[key]).dtype == w.dtype, key
        # same init statistics: std of each leaf within 10% of JAX's
        gs = got[key].float().std().item()
        ws = float(np.asarray(w, np.float32).std())
        assert abs(gs - ws) <= 0.1 * ws, (key, gs, ws)


def test_init_lm_builds_the_hetero_bank():
    from repro_torch.models import init_lm
    _, tcfg = _cfgs()
    params = init_lm(tcfg, seed=0, device="cpu")
    assert sorted(params["xpeft_bank"]) == sorted(
        ("bank_a", "bank_b", "lora_a", "lora_b", "ia3_v", "prefix_k",
         "prefix_v"))
    assert TXP.hetero_entry_keys(tcfg.xpeft) == JXP.hetero_entry_keys(
        _cfgs()[0].xpeft)
    assert TXP.HETERO_ENTRY_KEYS == JXP.HETERO_ENTRY_KEYS


# ----------------------------------------------------------------------------
# (d) typed k-sparse aggregation
# ----------------------------------------------------------------------------

def _typed_indices(rng, R, L, N, k, prefix_off):
    """[R, L, k] unified-space indices: row 0 random, row 1 never in the
    prefix segment, row 2 without a prefix selection at layer 0 only;
    the last row a pow2 pad row (idx 0, w 0)."""
    idx = np.stack([[np.sort(rng.choice(N, size=k, replace=False))
                     for _ in range(L)] for _ in range(R)])
    no_pfx = np.arange(prefix_off)
    idx[1] = [np.sort(rng.choice(no_pfx, size=k, replace=False))
              for _ in range(L)]
    idx[2, 0] = np.sort(rng.choice(no_pfx, size=k, replace=False))
    idx[2, 1, 0] = prefix_off                 # layer 1 selects one
    idx[2, 1] = np.sort(idx[2, 1])
    w = np.full((R, L, k), 1.0 / k, np.float32)
    idx[-1], w[-1] = 0, 0.0
    return idx.astype(np.int32), w


def test_typed_aggregation_matches_jax():
    cfg, tcfg = _cfgs()
    xp = cfg.xpeft
    L, N, k = cfg.num_layers, xp.num_adapters, xp.k
    off = next(o for t, o, _ in xp.segments() if t == "prefix")
    jbank = JA.init_hetero_bank(jax.random.key(1), L, xp, cfg.d_model,
                                cfg.kv_dim, jnp.float32)
    tbank = bridge.to_torch(jax.tree.map(np.asarray, jbank))
    rng = np.random.default_rng(5)
    ia, w = _typed_indices(rng, 4, L, N, k, off)
    ib, _ = _typed_indices(rng, 4, L, N, k, off)
    ib[1] = ia[1]          # row 1: no prefix selection on either side
    ib[2, 0] = ia[2, 0]    # row 2: none at layer 0 on either side
    want = JXP.precompute_effective_adapters_sparse_hetero(
        jbank, jnp.asarray(ia), jnp.asarray(w), jnp.asarray(ib),
        jnp.asarray(w), xp)
    got = TXP.precompute_effective_adapters_sparse_hetero(
        tbank, torch.from_numpy(ia), torch.from_numpy(w),
        torch.from_numpy(ib), torch.from_numpy(w), tcfg.xpeft)
    assert list(got) == list(want) == [
        "a_hat", "b_hat", "lora_a", "lora_b", "ia3_s", "prefix_k",
        "prefix_v"]
    for key, wv in want.items():
        assert tuple(got[key].shape) == wv.shape, key
        np.testing.assert_allclose(got[key].numpy(), np.asarray(wv),
                                   err_msg=key, **TOL)
    for key in ("prefix_k", "prefix_v"):
        # no prefix selection -> exact zero rows (0/0 renormalized to 0)
        assert not got[key][1].abs().max().item()
        assert not got[key][2, 0].abs().max().item()
        assert got[key][2, 1].abs().max().item() > 0
    for key in got:         # the pad row aggregates to zeros
        assert not got[key][-1].abs().max().item(), key


def test_dropping_zero_weight_terms_changes_no_bit():
    """The arithmetic the aggregation kernel's skip rests on: a k-order
    fp32 sum that leaves out the terms of weight 0 is bitwise the plain
    version, which sums every term, at the typed leaves' mix (~90% of the
    weights zero, -0.0 weights, terms that cancel exactly, a pad row).
    The kernel itself is held to the plain version on these inputs on the
    card by ``chip_smoke.py``."""
    rng = np.random.default_rng(11)
    N, p_, q_, P, k = 12, 8, 16, 6, 10
    bank = torch.from_numpy(rng.normal(size=(N, p_, q_)).astype(np.float32))
    bank[3] = -bank[2]
    idx = torch.from_numpy(rng.integers(0, N, (P, k)).astype(np.int32))
    w = torch.from_numpy((rng.uniform(0.1, 1, (P, k))
                          * (rng.uniform(size=(P, k)) < 0.1))
                         .astype(np.float32))
    w[0, :3] = torch.tensor([0.5, 0.5, -0.0])
    idx[0, :3] = torch.tensor([2, 3, 5], dtype=torch.int32)  # cancels to 0
    w[1] = 0.0                                              # a pad row
    want = tref.mask_aggregate_batched_ref(bank, idx, w)
    got = torch.zeros_like(want)
    for p in range(P):
        for j in range(k):
            if w[p, j] != 0:
                got[p] = got[p] + w[p, j] * bank[idx[p, j].long()]
    assert torch.equal(got, want)
    assert not want[1].abs().max().item()
    assert not torch.signbit(want[1]).any()


@pytest.mark.parametrize("p_,q_,want", [
    (1024, 1, (64, 16)),    # IA3 rows [24*26, 1024, 1], P=96
    (8, 1024, (128, 8)),    # prefix rows [24*26, 8, 1024], P=96
])
def test_typed_aggregation_plan(p_, q_, want):
    """The typed leaves' admission shapes (qwen1.5-0.5b, P = 4 profiles x
    24 layers): IA3 rows are short, so 64-thread blocks with 16 loads in
    flight; prefix rows fill the card at 128 threads and 8 in flight."""
    from repro_torch.kernels.mask_aggregate import plan
    assert plan(96, p_ * q_, 2) == want


def test_lora_route_plan_and_layer_slices():
    """The LoRA route shares the bottleneck kernel's plan (b = 64, clusters
    of 8 at d = 1024 in bf16) and takes layer slices of [B, L, d, b] as
    16-byte vectors."""
    from repro_torch.kernels.fused_adapter_batched import (
        _check_vectors, _row_stride, plan)
    B, L, d, b = 4, 24, 1024, 64
    a = torch.zeros((B, L, d, b), dtype=torch.bfloat16)
    bb = torch.zeros((B, L, b, d), dtype=torch.bfloat16)
    a_bs = _row_stride(a[:, 5], (d, b), "a_hat")
    b_bs = _row_stride(bb[:, 5], (b, d), "b_hat")
    _check_vectors(torch.zeros((B, 1, d), dtype=torch.bfloat16), a[:, 5],
                   bb[:, 5], a_bs, b_bs)
    assert [plan(d, b, T, 2) for T in (1, 16)] == [8, 8]


# ----------------------------------------------------------------------------
# (e) attention: per-request cache_pos and the front_skip gate
# ----------------------------------------------------------------------------

def test_attention_front_skip_matches_jax():
    from repro.models import init_lm as jinit_lm
    cfg, tcfg = _cfgs()
    params = jax.tree.map(np.asarray, jinit_lm(jax.random.key(2), cfg))
    attn = jax.tree.map(lambda t: t[0], params["blocks"]["attn"])
    tattn = bridge.to_torch(attn)
    rng = np.random.default_rng(6)
    B, T, S = 3, 5, 16
    KV, hd = cfg.num_kv_heads, cfg.head_dim
    x = rng.normal(size=(B, T, cfg.d_model)).astype(np.float32)
    ck = rng.normal(size=(B, S, KV, hd)).astype(np.float32)
    cv = rng.normal(size=(B, S, KV, hd)).astype(np.float32)
    cpos = np.array([2, 0, 2], np.int32)      # prefix-on, off, gated
    skip = np.array([0, 0, 2], np.int32)
    pos = cpos[:, None] + np.arange(T, dtype=np.int32)
    jy, jc = JATT.attention(attn, jnp.asarray(x), positions=jnp.asarray(pos),
                            cfg=cfg, cache={"k": jnp.asarray(ck),
                                            "v": jnp.asarray(cv)},
                            cache_pos=jnp.asarray(cpos),
                            front_skip=jnp.asarray(skip))
    tc = {"k": torch.from_numpy(ck.copy()), "v": torch.from_numpy(cv.copy())}
    ty, tc = TATT.attention(tattn, torch.from_numpy(x),
                            positions=torch.from_numpy(pos), cfg=tcfg,
                            cache=tc, cache_pos=torch.from_numpy(cpos),
                            front_skip=torch.from_numpy(skip))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
    for key in ("k", "v"):
        np.testing.assert_allclose(tc[key].numpy(), np.asarray(jc[key]),
                                   **TOL)
    # the gate matters: without it row 2 attends its two front rows
    ty2, _ = TATT.attention(tattn, torch.from_numpy(x),
                            positions=torch.from_numpy(pos), cfg=tcfg,
                            cache={"k": torch.from_numpy(ck.copy()),
                                   "v": torch.from_numpy(cv.copy())},
                            cache_pos=torch.from_numpy(cpos))
    assert torch.equal(ty2[:2], ty[:2]) and not torch.equal(ty2[2], ty[2])
