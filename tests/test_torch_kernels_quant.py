"""The port's quantized-bank kernel modules against the JAX package, on the
CPU: the k-sparse aggregation over quantized rows (TPU kernel #5,
``mask_aggregate_quant_batched``) and the dequantizing fused adapter (#6,
``fused_adapter_quant_batched``).

On a CPU tensor each port wrapper computes its plain PyTorch version
(``repro_torch/kernels/ref.py``); these tests hold it, the ``ops``
dispatch and the admission aggregation around it against JAX's ``ref``
and the Pallas kernels in interpret mode, on the same quantized inputs
(float32 values made from a seed with numpy, quantized by JAX's
``quant.schemes``). The CUDA kernels are held against the same plain
versions on the card by ``chip_smoke.py``.

Tolerances: the aggregation's dequantized terms are exact, so with
one-hot weights the result is bitwise equal; the k-term sums agree within
5e-7 absolute, the bound JAX's own tests/test_kernels_quant.py states
(XLA may contract w·deq + acc into an FMA). The fused adapter: float32 at
rtol = atol = 1e-5 (other summation orders); bfloat16 x within one bf16
step (both sides compute in fp32 and round once).
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.configs import XPeftConfig as JXPeftConfig
from repro.core import xpeft as JXP
from repro.kernels import ref as jref
from repro.kernels.fused_adapter_quant import (
    fused_adapter_quant_batched as pallas_fused_q)
from repro.kernels.mask_aggregate_quant import (
    mask_aggregate_quant_batched as pallas_agg_q)
from repro.quant import schemes as JQS
from repro_torch.configs import XPeftConfig
from repro_torch.core import xpeft as TXP
from repro_torch.kernels import decode_fused as KD
from repro_torch.kernels import fused_adapter_quant as KFQ
from repro_torch.kernels import mask_aggregate_quant as KAQ
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref
from repro_torch.quant import schemes as TQS

SUM_ATOL = 5e-7
F32_TOL = dict(rtol=1e-5, atol=1e-5)
BF16_STEP = dict(rtol=2.0 ** -7, atol=1e-6)   # one bf16 rounding step

# (scheme, int4 group upper bound)
SCHEMES = [("int8", 32), ("int4", 4), ("int4", 8)]
# (side, scheme, group) of the aggregation cases: both sides, both schemes
AGG_CASES = [("A", "int8", 32), ("B", "int8", 32), ("A", "int4", 4),
             ("B", "int4", 8)]


def _t(a):
    return torch.from_numpy(np.array(a))


def _q(x, scheme, group, jax_side=True):
    """x quantized as numpy (q, scale), by JAX's schemes or (for inputs
    only the port sees) by the port's, which give the same bytes."""
    if jax_side:
        rec = JQS.quantize(x, scheme, group=group)
        return np.array(rec["q"]), np.array(rec["scale"])
    rec = TQS.quantize(torch.from_numpy(x), scheme, group=group)
    return rec["q"].numpy(), rec["scale"].numpy()


def _np32(x):
    if torch.is_tensor(x):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


# ----------------------------------------------------------------------------
# #5: k-sparse aggregation over a quantized bank
# ----------------------------------------------------------------------------

def _agg_inputs(seed, side, scheme, group, N=24, d=16, b=8, P=6, k=3,
                one_hot=False):
    """A quantized bank of one side (A_hat rows [d, b], or B_hat rows
    [b, d]), P index rows of k distinct adapters (the last two padded:
    idx 0, w 0) and their weights."""
    rng = np.random.default_rng(seed)
    shape = (N, d, b) if side == "A" else (N, b, d)
    q, s = _q((rng.normal(size=shape) * 0.05).astype(np.float32), scheme,
              group)
    idx = np.stack([rng.choice(N, size=k, replace=False)
                    for _ in range(P)]).astype(np.int32)
    w = rng.uniform(0.1, 1.0, size=(P, k)).astype(np.float32)
    if one_hot:
        w *= np.eye(k, dtype=np.float32)[rng.integers(0, k, size=P)]
    idx[P - 2:] = 0
    w[P - 2:] = 0.0
    return q, s, idx, w


@pytest.mark.parametrize("side,scheme,group", AGG_CASES)
def test_mask_aggregate_quant_matches_jax(side, scheme, group):
    q, s, idx, w = _agg_inputs(0, side, scheme, group)
    jargs = [jnp.asarray(v) for v in (q, s, idx, w)]
    want_ref = jref.mask_aggregate_quant_batched_ref(*jargs, scheme=scheme)
    want_pallas = pallas_agg_q(*jargs, scheme=scheme, interpret=True)
    before = KAQ.mask_aggregate_quant_batched.launches
    got = KAQ.mask_aggregate_quant_batched(_t(q), _t(s), _t(idx), _t(w),
                                           scheme=scheme)
    assert KAQ.mask_aggregate_quant_batched.launches == before  # CPU: plain
    assert got.dtype == torch.float32
    assert tuple(got.shape) == tuple(want_ref.shape)
    for want in (want_ref, want_pallas):
        np.testing.assert_allclose(got.numpy(), _np32(want), rtol=0,
                                   atol=SUM_ATOL)
    assert not got[-2:].abs().max()   # padded rows are zeros


@pytest.mark.parametrize("side,scheme,group", AGG_CASES)
def test_mask_aggregate_quant_terms_bitwise(side, scheme, group):
    """One nonzero weight per row: the result is that weight times the
    dequantized row, bit for bit on every backend."""
    q, s, idx, w = _agg_inputs(1, side, scheme, group, one_hot=True)
    jargs = [jnp.asarray(v) for v in (q, s, idx, w)]
    got = KAQ.mask_aggregate_quant_batched(_t(q), _t(s), _t(idx), _t(w),
                                           scheme=scheme).numpy()
    for want in (jref.mask_aggregate_quant_batched_ref(*jargs,
                                                       scheme=scheme),
                 pallas_agg_q(*jargs, scheme=scheme, interpret=True)):
        np.testing.assert_array_equal(got, np.asarray(want))


@pytest.mark.parametrize("scheme,group", SCHEMES[:2])
def test_quant_admission_aggregation_matches_jax(scheme, group):
    """``precompute_effective_adapters_sparse_quant``: layers folded into
    N, one aggregation per side, fp32 out."""
    rng = np.random.default_rng(2)
    L, N, d, b, R, k = 3, 8, 16, 8, 2, 3
    bank = {"bank_a": (rng.normal(size=(L, N, d, b)) * 0.05).astype(
                np.float32),
            "bank_b": (rng.normal(size=(L, N, b, d)) * 0.05).astype(
                np.float32)}
    qbank = {key: np.array(v) for key, v in
             JQS.quantize_bank(bank, scheme, group=group).items()}
    idx = [np.stack([[rng.choice(N, k, replace=False) for _ in range(L)]
                     for _ in range(R)]).astype(np.int32) for _ in range(2)]
    w = [np.full((R, L, k), 1.0 / k, np.float32) for _ in range(2)]
    jxp = JXPeftConfig(bank_quant=scheme, quant_group=group,
                       kernel_impl="ref")
    txp = XPeftConfig(bank_quant=scheme, quant_group=group)
    want = JXP.precompute_effective_adapters_sparse_quant(
        {key: jnp.asarray(v) for key, v in qbank.items()},
        jnp.asarray(idx[0]), jnp.asarray(w[0]), jnp.asarray(idx[1]),
        jnp.asarray(w[1]), jxp)
    got = TXP.precompute_effective_adapters_sparse_quant(
        {key: _t(v) for key, v in qbank.items()}, _t(idx[0]), _t(w[0]),
        _t(idx[1]), _t(w[1]), txp)
    for g, wt in zip(got, want):
        assert g.dtype == torch.float32
        assert tuple(g.shape) == tuple(wt.shape)
        np.testing.assert_allclose(g.numpy(), _np32(wt), rtol=0,
                                   atol=SUM_ATOL)


# ----------------------------------------------------------------------------
# #6: dequantizing fused adapter
# ----------------------------------------------------------------------------

def _fa_inputs(seed, scheme, group, B=3, T=8, d=32, b=8, L=None,
               jax_side=True):
    """x [B, T, d] and per-row quantized Â/B̂ records; with L, the records
    are [B, L, ...] buffers as the engine holds them."""
    rng = np.random.default_rng(seed)
    lead = (B,) if L is None else (B, L)
    x = rng.normal(size=(B, T, d)).astype(np.float32)
    aq, as_ = _q((rng.normal(size=lead + (d, b)) / np.sqrt(d)).astype(
        np.float32), scheme, group, jax_side)
    bq, bs = _q((rng.normal(size=lead + (b, d)) * 0.3).astype(np.float32),
                scheme, group, jax_side)
    ls = (1 + 0.1 * rng.normal(size=lead + (b,))).astype(np.float32)
    lb = (0.1 * rng.normal(size=lead + (b,))).astype(np.float32)
    return x, aq, as_, bq, bs, ls, lb


@pytest.mark.parametrize("scheme,group,activation,T", [
    ("int8", 32, "gelu", 1), ("int4", 4, "identity", 8),
    ("int4", 8, "gelu", 1)])
def test_fused_adapter_quant_matches_jax_f32(scheme, group, activation, T):
    args = _fa_inputs(3, scheme, group, T=T)
    kw = dict(scheme=scheme, activation=activation)
    jargs = [jnp.asarray(v) for v in args]
    got = KFQ.fused_adapter_quant_batched(*[_t(v) for v in args], **kw)
    assert got.dtype == torch.float32 and got.shape == args[0].shape
    for want in (jref.fused_adapter_quant_batched_ref(*jargs, **kw),
                 pallas_fused_q(*jargs, interpret=True, **kw)):
        np.testing.assert_allclose(got.numpy(), _np32(want), **F32_TOL)


@pytest.mark.parametrize("scheme,group,T", [
    ("int8", 32, 1), ("int4", 4, 8), ("int4", 8, 1)])
def test_fused_adapter_quant_matches_jax_bf16(scheme, group, T):
    x, *rest = _fa_inputs(4, scheme, group, T=T)
    kw = dict(scheme=scheme)
    jx = jnp.asarray(x, jnp.bfloat16)
    jrest = [jnp.asarray(v) for v in rest]
    got = KFQ.fused_adapter_quant_batched(
        _t(x).to(torch.bfloat16), *[_t(v) for v in rest], **kw)
    assert got.dtype == torch.bfloat16
    for want in (jref.fused_adapter_quant_batched_ref(jx, *jrest, **kw),
                 pallas_fused_q(jx, *jrest, interpret=True, **kw)):
        np.testing.assert_allclose(_np32(got), _np32(want), **BF16_STEP)


@pytest.mark.parametrize("scheme,group", SCHEMES[:2])
def test_fused_adapter_quant_layer_slices_and_dispatch(scheme, group):
    """One layer of the engine's [B, L, ...] quantized buffers (strided row
    slices, as the model passes them) gives what a contiguous copy gives,
    and ``auto``/``ref`` agree on the CPU without counting a launch."""
    L = 3
    x, aq, as_, bq, bs, ls, lb = (_t(v) for v in _fa_inputs(
        5, scheme, group, L=L, jax_side=False))
    before = KFQ.fused_adapter_quant_batched.launches
    for layer in range(L):
        args = [t[:, layer] for t in (aq, as_, bq, bs, ls, lb)]
        auto = ops.fused_adapter_quant(x, *args, scheme=scheme, impl="auto")
        plain = ops.fused_adapter_quant(x, *args, scheme=scheme, impl="ref")
        dense = ops.fused_adapter_quant(
            x, *[t.contiguous() for t in args], scheme=scheme)
        assert torch.equal(auto, plain) and torch.equal(plain, dense)
        # the wrapper's checks take the strided slices and give their
        # batch strides (in elements)
        nb, groups, strides = KFQ._check(x, *args, scheme, "gelu")
        assert nb == ls.shape[-1]
        assert strides == tuple(t.stride(0) for t in args[:5])
    assert KFQ.fused_adapter_quant_batched.launches == before
    with pytest.raises(ValueError, match="batched-only"):
        ops.fused_adapter_quant(x[0], *[t[:, 0] for t in
                                        (aq, as_, bq, bs, ls, lb)],
                                scheme=scheme)


@pytest.mark.parametrize("scheme,group", [("int8", 32), ("int4", 32),
                                          ("int4", 16)])
def test_dropping_zero_weight_terms_changes_no_bit_quant(scheme, group):
    """The arithmetic #5's skip rests on, as
    ``test_dropping_zero_weight_terms_changes_no_bit`` holds it for #1: a
    k-order fp32 sum from +0 (the kernel's) over only the terms of nonzero
    weight and an index inside the bank is bitwise the same sum over every
    term, and equals the plain version (which starts from its first term;
    the two can differ only in the sign of a sum of -0 terms, which
    ``torch.equal`` counts equal), at ~90% zero weights with -0.0 weights,
    terms that cancel exactly, a pad row and an index past the bank (its
    weight zeroed and its index moved into the bank for the plain
    version, which cannot read outside it). The kernel itself is held to
    the plain version on the card by ``chip_smoke.py``."""
    rng = np.random.default_rng(12)
    N, d, b, P, k = 12, 8, 64, 6, 10
    x = (0.05 * rng.normal(size=(N, d, b))).astype(np.float32)
    x[3] = -x[2]
    q, sc = (torch.from_numpy(v) for v in _q(x, scheme, group,
                                              jax_side=False))
    idx = torch.from_numpy(rng.integers(0, N, (P, k)).astype(np.int32))
    w = torch.from_numpy((rng.uniform(0.1, 1, (P, k))
                          * (rng.uniform(size=(P, k)) < 0.1))
                         .astype(np.float32))
    w[0, :3] = torch.tensor([0.5, 0.5, -0.0])
    idx[0, :3] = torch.tensor([2, 3, 5], dtype=torch.int32)  # cancels to 0
    w[1] = 0.0                                              # a pad row
    idx[2, 4], w[2, 4] = N, 0.7                             # past the bank
    deq = TQS.dequant_block(q, sc, scheme)
    full = torch.zeros((P, d, b))
    kept = torch.zeros((P, d, b))
    for p in range(P):
        for j in range(k):
            r = int(idx[p, j])
            inside = 0 <= r < N
            term = w[p, j] * deq[r if inside else 0] * (1.0 if inside
                                                        else 0.0)
            full[p] = full[p] + term
            if w[p, j] != 0 and inside:
                kept[p] = kept[p] + w[p, j] * deq[r]
    assert kept.numpy().tobytes() == full.numpy().tobytes()
    idx_in, w_in = idx.clone(), w.clone()
    idx_in[2, 4], w_in[2, 4] = 0, 0.0
    want = tref.mask_aggregate_quant_batched_ref(q, sc, idx_in, w_in,
                                                 scheme=scheme)
    assert torch.equal(kept, want)
    assert not want[1].abs().max().item()


@pytest.mark.parametrize("P,row_bytes,scheme,want", [
    (96, 1024 * 64, "int8", (128, 1)),    # admission's A_hat / B_hat, P=96
    (96, 1024 * 32, "int4", (128, 2)),    # ... int4: half the threads
    (24, 1024 * 64, "int8", (128, 1)),    # one profile's 24 layers
    (1, 1024 * 64, "int8", (64, 16)),     # one profile-row: 4096 threads
    (1, 1024 * 32, "int4", (64, 16)),     # ... int4: 2048
])
def test_mask_aggregate_quant_plan(P, row_bytes, scheme, want):
    """#5's block size and loads in flight: 128 threads where every SM
    still gets a block, else 64; 1 (int8) or 2 (int4) loads in flight at
    256 threads per SM or more (admission), 8 below, 16 below 64 (one
    profile-row: 4096 or 2048 threads)."""
    assert KAQ.plan(P, row_bytes, scheme) == want
    assert want[0] in KAQ.THREADS and want[1] in KAQ.UNROLLS


def test_mask_aggregate_quant_plan_checks():
    """Every plan is one the kernel is built for: the C entry point takes
    exactly the block sizes ``THREADS`` and instantiates exactly the loads
    in flight ``UNROLLS``."""
    import re
    from repro_torch.kernels._build import CSRC
    src = (CSRC / "mask_aggregate_quant.cu").read_text()
    body = src[src.index("cudaError_t launch_u"):]
    body = body[:body.index("}  // namespace")]
    assert tuple(int(u) for u in re.findall(r"case (\d+):", body)) \
        == KAQ.UNROLLS
    entry = src[src.index(
        'extern "C" int xpeft_mask_aggregate_quant_batched'):]
    assert tuple(int(t) for t in re.findall(r"threads != (\d+)", entry)) \
        == KAQ.THREADS
    for P in (1, 2, 24, 96, 192, 1024):
        for row in (1024, 32 * 1024, 64 * 1024):
            for scheme in ("int8", "int4"):
                assert KAQ.plan(P, row, scheme)[0] in KAQ.THREADS
                assert KAQ.plan(P, row, scheme)[1] in KAQ.UNROLLS


@pytest.mark.parametrize("bias,shift", [(128, 0), (8, 0), (8, 4)])
def test_i2f_free_dequant_is_exact(bias, shift):
    """``csrc/dequant.cuh``'s conversion without I2F, emulated with its
    exact arithmetic: the byte permute's selector, then the stored value
    v = (q + bias) * 2^shift in bits
    8..15 of 2^23, then ONE rounding of M * m + c (an FFMA), with
    m = s * 2^-(8 + shift) and c = -(2^23 + bias * 2^(8 + shift)) * m
    each rounded to fp32 as the kernel rounds them, gives float(q) * s bit
    for bit for every stored integer (int8 -128..127 as byte ^ 0x80;
    int4 nibbles 0..15 in the low or the high half of a byte) and fp16
    scales from the smallest subnormal to the largest value."""
    rng = np.random.default_rng(13)
    # the byte permute as the kernel selects: result byte b is byte
    # (sel >> 4b) & 7 of (0x4B000000, word), so byte j of word lands in
    # bits 8..15 under 0x4B in bits 24..31
    words = rng.integers(0, 2 ** 32, 64, dtype=np.uint64)
    for j in range(4):
        sel = 0x3000 | ((4 + j) << 4)
        pool = (0x4B000000 | (words << 32)).astype(np.uint64)
        perm = sum(((pool >> np.uint64(8 * ((sel >> (4 * i)) & 7)))
                    & np.uint64(0xFF)) << np.uint64(8 * i) for i in range(4))
        want_bits = 0x4B000000 | (((words >> np.uint64(8 * j))
                                   & np.uint64(0xFF)) << np.uint64(8))
        assert np.array_equal(perm, want_bits)
    scales = np.concatenate([
        np.array([0.0, 2.0 ** -24, 2.0 ** -14, 6.1e-5, 1.0, 65504.0]),
        np.abs(rng.normal(size=200)) * 10.0 ** rng.uniform(-6, 4, 200)])
    s16 = scales.astype(np.float16).astype(np.float32)
    qs = np.arange(-128, 128) if bias == 128 else np.arange(-8, 8)
    v = ((qs + bias) << shift).astype(np.uint32)
    big = ((0x4B000000 | (v << 8)).astype(np.uint32)).view(np.float32)
    assert np.array_equal(big.astype(np.float64),
                          2.0 ** 23 + v.astype(np.float64) * 256)
    m = (s16 * np.float32(2.0 ** -(8 + shift))).astype(np.float32)
    c = (np.float32(-(2.0 ** 23 + bias * 2.0 ** (8 + shift))) * m).astype(
        np.float32)
    # both factors of c and m are exact in fp32, and so is M * m + c in
    # fp64 (at most 27 significant bits each): one rounding to fp32 is
    # the FFMA's
    assert np.array_equal(c.astype(np.float64),
                          -(2.0 ** 23 + bias * 2.0 ** (8 + shift))
                          * s16.astype(np.float64) * 2.0 ** -(8 + shift))
    got = (big[None, :].astype(np.float64) * m[:, None].astype(np.float64)
           + c[:, None].astype(np.float64)).astype(np.float32)
    want = qs[None, :].astype(np.float32) * s16[:, None]
    assert np.array_equal(got, want)


# ----------------------------------------------------------------------------
# the wrappers' checks (the Python half of the CUDA path)
# ----------------------------------------------------------------------------

def test_mask_aggregate_quant_input_checks():
    q, s, idx, w = (_t(v) for v in _agg_inputs(1, "A", "int4", 4))
    assert KAQ._check(q, s, idx, w, "int4") == (8, 2)
    qi8, si8 = (_t(v) for v in _agg_inputs(1, "A", "int8", 4)[:2])
    assert KAQ._check(qi8, si8, idx, w, "int8") == (8, 1)
    for bad, scheme in (
            ((q, s, idx, w), "int8"),                  # uint8 rows as int8
            ((qi8, si8, idx, w), "int4"),              # int8 rows as int4
            ((q, s.float(), idx, w), "int4"),          # fp32 scales
            ((q, s[..., :1].expand(-1, -1, 3).contiguous(), idx, w),
             "int4"),                                  # 3 groups of 8
            ((q, s, idx.long(), w), "int4"),
            ((q, s, idx, w.double()), "int4"),
            ((q[0], s[0], idx, w), "int4"),
            ((q, s, idx[:, :2], w), "int4"),
            ((q[:, :3].contiguous(), s[:, :3].contiguous(), idx, w),
             "int4"),                                  # 12-byte rows
            ((q, s, idx, w), "none")):
        with pytest.raises((TypeError, ValueError)):
            KAQ._check(*bad, scheme)


def test_fused_adapter_quant_input_checks():
    x, aq, as_, bq, bs, ls, lb = (_t(v) for v in _fa_inputs(
        7, "int4", 4, jax_side=False))
    good = (x, aq, as_, bq, bs, ls, lb)
    KFQ._check(*good, "int4", "gelu")
    for i, bad in ((0, x[0]), (0, x.double()), (1, aq.to(torch.int8)),
                   (2, as_[..., :1].expand(-1, -1, 3).contiguous()),
                   (3, bq[:, :4]), (5, ls[:2]), (5, ls.double()),
                   (1, aq.transpose(1, 2))):
        args = list(good)
        args[i] = bad
        with pytest.raises((TypeError, ValueError)):
            KFQ._check(*args, "int4", "gelu")
    with pytest.raises(ValueError):
        KFQ._check(*good, "int4", "relu")


def test_fused_adapter_quant_vector_checks():
    """x, the quantized rows and their scales are copied as 16-byte
    vectors: a base off a 16-byte boundary, or a batch stride that is not
    whole vectors, raises in the wrapper's checks."""
    x, aq, as_, bq, bs, ls, lb = (_t(v) for v in _fa_inputs(
        7, "int4", 4, jax_side=False))
    good = (x, aq, as_, bq, bs, ls, lb)
    KFQ._check(*good, "int4", "gelu")

    def shifted(t):
        # t's values one element past the start of a fresh buffer
        buf = torch.zeros(t.numel() + 1, dtype=t.dtype)
        out = buf[1:].view(t.shape)
        out.copy_(t)
        return out

    def padded(t):
        # t's rows one byte (or element) apart more than dense
        inner = t[0].numel()
        buf = torch.zeros((t.shape[0], inner + 1), dtype=t.dtype)
        buf[:, :inner] = t.reshape(t.shape[0], inner)
        return buf[:, :inner].view((t.shape[0],) + tuple(t.shape[1:]))

    for i, bad in ((0, shifted(x)), (1, shifted(aq)), (2, shifted(as_)),
                   (3, shifted(bq)), (4, shifted(bs)), (1, padded(aq)),
                   (2, padded(as_)), (3, padded(bq)), (4, padded(bs))):
        args = list(good)
        args[i] = bad
        assert torch.equal(bad, good[i])
        with pytest.raises(ValueError, match="16-byte"):
            KFQ._check(*args, "int4", "gelu")


@pytest.mark.parametrize("scheme,d,T,want", [
    ("int8", 1024, 1, 8), ("int8", 1024, 16, 8), ("int4", 1024, 1, 8),
    ("int4", 1024, 16, 8), ("int8", 7168, 1, 16), ("int8", 7168, 16, 16),
    ("int4", 7168, 1, 16), ("int4", 7168, 16, 16)])
def test_fused_adapter_quant_plan(scheme, d, T, want):
    """Blocks per cluster at b=64, group 32, bf16 x: 8 where 8 blocks'
    column ranges are whole 16-byte vectors and the block's shared memory
    fits, else 16 (qwen1.5-0.5b's d=1024 takes 8; llava-next-34b's 7168
    overflows at 8, its fp32 tile alone 224 KB)."""
    nb, g = 64, 32
    groups = (1, 1) if scheme == "int8" else (nb // g, d // g)
    int4 = scheme == "int4"
    tt = 1 if T == 1 else 16
    assert KFQ.plan(d, nb, T, 2, scheme, *groups) == want
    assert KFQ.smem_bytes(d // want, nb, tt, 2, int4, *groups) \
        <= KFQ.MAX_SMEM
    if want == 16:
        assert KFQ.smem_bytes(d // 8, nb, tt, 2, int4, *groups) \
            > KFQ.MAX_SMEM


def test_fused_adapter_quant_plan_refusals():
    """Shapes no cluster takes raise (the wrapper never falls back); a
    slice that is not whole scale groups is taken (B̂'s scale rows are
    copied whole); the layout matches the kernel's."""
    for args in ((1024, 60, 1, 2, "int8"),            # b not a multiple of 8
                 (1000, 64, 1, 2, "int8"),            # d/8, d/16 not whole
                 (1040, 64, 1, 2, "int4", 2, 65),     # pair-sets of 65, 32.5
                 (1024, 36, 1, 2, "int4", 1, 32),     # ... in int4 too
                 (16384, 64, 1, 2, "int8"),           # no slice fits smem
                 (7168, 256, 16, 4, "int8")):
        with pytest.raises(ValueError):
            KFQ.plan(*args)
    # gemma3-27b int4 (d=5376): at 16 blocks ranges of 168 columns are
    # not whole vectors of B̂ bytes, and 8 blocks overflow shared memory
    # with the whole fp32 tile, so 8 blocks hold it one pair-part at a
    # time
    for T, itemsize in ((1, 2), (16, 4)):
        assert KFQ.launch_plan(5376, 64, T, itemsize, "int4", 2, 168) \
            == (8, 2)
    # ... the two passes' tile [336, 64] fp32 in place of [672, 64]
    assert KFQ.smem_bytes(672, 64, 1, 2, True, 2, 168) \
        - KFQ.smem_bytes(672, 64, 1, 2, True, 2, 168, 2) == 4 * 336 * 64
    # musicgen-medium int4: ranges of 96 columns, three groups of 32 each
    # -- and bert-base's 48, one and a half groups
    assert KFQ.plan(1536, 64, 1, 2, "int4", 2, 48) == 8
    assert KFQ.plan(768, 48, 16, 2, "int4", 3, 48) == 8
    # T = 1, int8, bf16, 128 columns: x [1, 128] bf16, Â bytes [128, 64]
    # and scales [128], B̂ bytes [64, 128] and scales [64], the fp32 tile
    # [128, 64], h and partial [64] and LN affines [2, 64] fp32, 256
    # vectors of up-projection partials
    assert KFQ.smem_bytes(128, 64, 1, 2, False, 1, 1) == \
        256 + 8192 + 256 + 8192 + 128 + 32768 + 512 + 512 + 8192
    # T = 16, int4 at group 32, fp32: x [16, 128] fp32, Â bytes [128, 32]
    # and scales [128, 2], B̂ bytes [64, 64] and scales [64, 32], the
    # tile, h and partial [16, 64], LN, 4 sub-slice partials [16, 64]
    assert KFQ.smem_bytes(128, 64, 16, 4, True, 2, 32) == \
        8192 + 4096 + 512 + 4096 + 4096 + 32768 + 8192 + 512 + 16384


@pytest.mark.parametrize("scheme", ["int8", "int4"])
def test_decode_megakernel_quant_operands(scheme):
    """The megakernel wrapper's adapter operands on routes int8/int4: one
    layer of [B, L, ...] quantized slot buffers passes with its batch
    strides and scale counts; a bottleneck that is not a multiple of 16
    is refused before the card."""
    B, L, d, b, group = 4, 3, 64, 16, 8
    rng = np.random.default_rng(8)
    aq, as_ = _q((rng.normal(size=(B, L, d, b)) * 0.1).astype(np.float32),
                 scheme, group, jax_side=False)
    bq, bs = _q((rng.normal(size=(B, L, b, d)) * 0.1).astype(np.float32),
                scheme, group, jax_side=False)
    masks = {"a_q": _t(aq), "a_scale": _t(as_), "b_q": _t(bq),
             "b_scale": _t(bs), "ln_scale": torch.ones((B, L, b)),
             "ln_bias": torch.zeros((B, L, b))}
    x = torch.zeros((B, 1, d), dtype=torch.bfloat16)
    layer = {k: v[:, 1] for k, v in masks.items()}
    ops_ = KD._adapter_operands(layer, scheme, x)
    assert ops_["nb"] == b
    want_groups = [1, 1] if scheme == "int8" else [b // group, d // group]
    assert ops_["groups"] == want_groups
    assert ops_["quant_strides"] == [layer[k].stride(0) for k in
                                     ("a_q", "a_scale", "b_q", "b_scale")]
    assert ops_["bf16_strides"][2] == L * b
    narrow = {k: v[..., :8] if k.startswith("ln") else v
              for k, v in layer.items()}
    narrow["a_q"] = layer["a_q"][..., :(8 if scheme == "int8" else 4)]
    narrow["a_scale"] = layer["a_scale"] if scheme == "int8" \
        else layer["a_scale"][..., :1]
    with pytest.raises((NotImplementedError, ValueError)):
        KD._adapter_operands(narrow, scheme, x)
