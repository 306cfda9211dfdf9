"""The port's kernel modules against the JAX package, on the CPU.

On a CPU tensor each port wrapper computes its plain PyTorch version
(``repro_torch/kernels/ref.py``); these tests hold that version, and the
``ops`` dispatch around it, against the JAX oracle (``repro.kernels.ref``)
and against the Pallas kernel itself in interpret mode, on the same
inputs made from a seed with numpy. The CUDA kernels are held against the
same plain versions on the card by ``chip_smoke.py``.

Tolerances: fp32 at rtol = atol = 1e-5 (the two frameworks sum in other
orders; the inputs are O(1)). With bf16 x/Â/B̂ the output is rounded to
bf16 once (ref numerics) or, in the Pallas body, also at h and at the
residual add, so bf16 cases compare at 2e-2 — a few bf16 ulps at O(1).
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.configs import XPeftConfig as JXPeftConfig
from repro.core import xpeft as JXP
from repro.kernels import ref as jref
from repro.kernels.fused_adapter import fused_adapter as pallas_fused_1
from repro.kernels.fused_adapter_batched import (
    fused_adapter_batched as pallas_fused)
from repro.kernels.mask_aggregate import mask_aggregate as pallas_agg_1
from repro.kernels.mask_aggregate import (
    mask_aggregate_batched as pallas_agg)
from repro_torch.configs import XPeftConfig
from repro_torch.core import xpeft as TXP
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref
from repro_torch.kernels.fused_adapter import fused_adapter
from repro_torch.kernels.fused_adapter_batched import fused_adapter_batched
from repro_torch.kernels.mask_aggregate import (mask_aggregate,
                                                mask_aggregate_batched)

F32_TOL = dict(rtol=1e-5, atol=1e-5)
BF16_TOL = dict(rtol=2e-2, atol=2e-2)


def _t(a, dtype=None):
    t = torch.from_numpy(np.ascontiguousarray(a))
    return t if dtype is None else t.to(dtype)


def _np32(x):
    if torch.is_tensor(x):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


# ----------------------------------------------------------------------------
# mask_aggregate_batched
# ----------------------------------------------------------------------------

def _agg_inputs(seed, N=24, d=16, b=8, P=6, k=3, n_pad=2):
    rng = np.random.default_rng(seed)
    bank = rng.normal(size=(N, d, b)).astype(np.float32)
    idx = np.stack([rng.choice(N, size=k, replace=False)
                    for _ in range(P)]).astype(np.int32)
    w = rng.uniform(0.1, 1.0, size=(P, k)).astype(np.float32)
    idx[P - n_pad:] = 0          # padded profile-rows: idx 0, w 0
    w[P - n_pad:] = 0.0
    return bank, idx, w


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mask_aggregate_batched_matches_jax(dtype):
    bank, idx, w = _agg_inputs(0)
    jbank = jnp.asarray(bank, dtype)
    tbank = _t(bank, getattr(torch, dtype))
    want_ref = jref.mask_aggregate_batched_ref(jbank, jnp.asarray(idx),
                                               jnp.asarray(w))
    want_pallas = pallas_agg(jbank, jnp.asarray(idx), jnp.asarray(w),
                             interpret=True)
    got = mask_aggregate_batched(tbank, _t(idx), _t(w))
    assert got.dtype == torch.float32 and got.shape == (6, 16, 8)
    # bf16 bank values are exact in fp32 and the sum is fp32 either way
    np.testing.assert_allclose(got.numpy(), _np32(want_ref), **F32_TOL)
    np.testing.assert_allclose(got.numpy(), _np32(want_pallas), **F32_TOL)
    # padded rows come out as exact zeros
    assert not got[-2:].abs().max().item()


def test_mask_aggregate_dispatch_and_counter():
    """``auto`` on a CPU tensor and ``ref`` both take the plain version,
    bit for bit; neither moves the kernel's launch counter."""
    bank, idx, w = _agg_inputs(1)
    tb, ti, tw = _t(bank), _t(idx), _t(w)
    before = mask_aggregate_batched.launches
    auto = ops.mask_aggregate_batched(tb, ti, tw, impl="auto")
    plain = ops.mask_aggregate_batched(tb, ti, tw, impl="ref")
    assert torch.equal(auto, plain)
    assert torch.equal(plain, tref.mask_aggregate_batched_ref(tb, ti, tw))
    assert mask_aggregate_batched.launches == before


@pytest.mark.parametrize("impl", ["pallas", "interpret", "tpu"])
def test_pallas_impls_raise(impl):
    bank, idx, w = _agg_inputs(2)
    with pytest.raises(ValueError):
        ops.mask_aggregate_batched(_t(bank), _t(idx), _t(w), impl=impl)
    with pytest.raises(ValueError):
        XPeftConfig(kernel_impl=impl)


# ----------------------------------------------------------------------------
# fused_adapter_batched
# ----------------------------------------------------------------------------

def _fa_inputs(seed, B=3, T=8, d=32, b=8, shared=False):
    rng = np.random.default_rng(seed)
    lead = () if shared else (B,)
    x = rng.normal(size=(B, T, d)).astype(np.float32)
    a = (rng.normal(size=lead + (d, b)) / np.sqrt(d)).astype(np.float32)
    bb = (rng.normal(size=lead + (b, d)) * 0.3).astype(np.float32)
    ls = (1 + 0.1 * rng.normal(size=lead + (b,))).astype(np.float32)
    lb = (0.1 * rng.normal(size=lead + (b,))).astype(np.float32)
    return x, a, bb, ls, lb


@pytest.mark.parametrize("T", [1, 8])
@pytest.mark.parametrize("activation", ["gelu", "identity"])
@pytest.mark.parametrize("use_ln", [True, False])
@pytest.mark.parametrize("shared", [False, True])
def test_fused_adapter_batched_matches_jax_f32(shared, use_ln, activation, T):
    x, a, bb, ls, lb = _fa_inputs(3, T=T, shared=shared)
    kw = dict(activation=activation, use_ln=use_ln)
    jargs = [jnp.asarray(v) for v in (x, a, bb, ls, lb)]
    want_ref = jref.fused_adapter_batched_ref(*jargs, **kw)
    want_pallas = pallas_fused(*jargs, interpret=True, **kw)
    got = fused_adapter_batched(*[_t(v) for v in (x, a, bb, ls, lb)], **kw)
    assert got.dtype == torch.float32 and got.shape == x.shape
    np.testing.assert_allclose(got.numpy(), _np32(want_ref), **F32_TOL)
    np.testing.assert_allclose(got.numpy(), _np32(want_pallas), **F32_TOL)


@pytest.mark.parametrize("T", [1, 8])
@pytest.mark.parametrize("shared", [False, True])
def test_fused_adapter_batched_matches_jax_bf16(shared, T):
    x, a, bb, ls, lb = _fa_inputs(4, T=T, shared=shared)
    jargs = [jnp.asarray(v, jnp.bfloat16) for v in (x, a, bb)] + \
        [jnp.asarray(ls), jnp.asarray(lb)]
    targs = [_t(v, torch.bfloat16) for v in (x, a, bb)] + [_t(ls), _t(lb)]
    got = fused_adapter_batched(*targs)
    assert got.dtype == torch.bfloat16
    want_ref = jref.fused_adapter_batched_ref(*jargs)
    want_pallas = pallas_fused(*jargs, interpret=True)
    np.testing.assert_allclose(_np32(got), _np32(want_ref), **BF16_TOL)
    np.testing.assert_allclose(_np32(got), _np32(want_pallas), **BF16_TOL)


def test_fused_adapter_layer_slices_and_dispatch():
    """One layer of a stacked [B, L, d, b] buffer (a strided row slice, as
    the model passes it) gives the same result as a contiguous copy, and
    ``auto``/``ref`` agree on the CPU without counting a launch."""
    rng = np.random.default_rng(5)
    B, L, T, d, b = 2, 3, 8, 32, 8
    x = _t(rng.normal(size=(B, T, d)).astype(np.float32))
    a = _t((rng.normal(size=(B, L, d, b)) / np.sqrt(d)).astype(np.float32))
    bb = _t((rng.normal(size=(B, L, b, d)) * 0.3).astype(np.float32))
    ls = _t((1 + 0.1 * rng.normal(size=(B, L, b))).astype(np.float32))
    lb = _t((0.1 * rng.normal(size=(B, L, b))).astype(np.float32))
    before = fused_adapter_batched.launches
    by_t = dict(fused_adapter_batched.launches_by_t)
    for layer in range(L):
        args = (x, a[:, layer], bb[:, layer], ls[:, layer], lb[:, layer])
        auto = ops.fused_adapter(*args, impl="auto")
        plain = ops.fused_adapter(*args, impl="ref")
        dense = tref.fused_adapter_batched_ref(
            *[t.contiguous() for t in args])
        assert torch.equal(auto, plain) and torch.equal(plain, dense)
    assert fused_adapter_batched.launches == before
    assert fused_adapter_batched.launches_by_t == by_t
    # the unbatched [T, d] form is the batched one at B=1
    one = ops.fused_adapter(x[0], a[0, 0], bb[0, 0], ls[0, 0], lb[0, 0])
    assert torch.equal(one, ops.fused_adapter(
        x[:1], a[:1, 0], bb[:1, 0], ls[:1, 0], lb[:1, 0])[0])


# ----------------------------------------------------------------------------
# the one-profile aggregation and the unbatched adapter (B=1 / P=1 forms)
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mask_aggregate_matches_jax(dtype):
    bank, idx, w = _agg_inputs(7, d=256, b=8, k=5)
    jbank = jnp.asarray(bank, dtype)
    tbank = _t(bank, getattr(torch, dtype))
    before = mask_aggregate.launches
    for p in range(idx.shape[0]):
        ji, jw = jnp.asarray(idx[p]), jnp.asarray(w[p])
        got = ops.mask_aggregate(tbank, _t(idx[p]), _t(w[p]))
        assert got.dtype == torch.float32 and got.shape == (256, 8)
        np.testing.assert_allclose(
            got.numpy(), _np32(jref.mask_aggregate_ref(jbank, ji, jw)),
            **F32_TOL)
        np.testing.assert_allclose(
            got.numpy(), _np32(pallas_agg_1(jbank, ji, jw, interpret=True)),
            **F32_TOL)
        # bit for bit the batched form's row, the kernel's own arithmetic
        assert torch.equal(got, mask_aggregate(tbank, _t(idx[p]),
                                               _t(w[p])))
        assert torch.equal(got, tref.mask_aggregate_batched_ref(
            tbank, _t(idx), _t(w))[p])
    assert mask_aggregate.launches == before


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("activation,use_ln", [("gelu", True),
                                               ("identity", False)])
def test_fused_adapter_unbatched_matches_jax(dtype, activation, use_ln):
    x, a, bb, ls, lb = _fa_inputs(8, B=1, T=8, shared=True)
    x = x[0]
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    kw = dict(activation=activation, use_ln=use_ln)
    jargs = [jnp.asarray(v, dtype) for v in (x, a, bb)] + \
        [jnp.asarray(ls), jnp.asarray(lb)]
    targs = [_t(v, getattr(torch, dtype)) for v in (x, a, bb)] + \
        [_t(ls), _t(lb)]
    before = fused_adapter.launches
    got = ops.fused_adapter(*targs, **kw)
    assert got.dtype == getattr(torch, dtype) and got.shape == x.shape
    assert torch.equal(got, fused_adapter(*targs, **kw))
    assert fused_adapter.launches == before
    want_ref = jref.fused_adapter_ref(*jargs, **kw)
    want_pallas = pallas_fused_1(*jargs, interpret=True, **kw)
    np.testing.assert_allclose(_np32(got), _np32(want_ref), **tol)
    np.testing.assert_allclose(_np32(got), _np32(want_pallas), **tol)


def test_apply_precomputed_layer_matches_jax():
    """``core/xpeft.py`` ``apply_precomputed_layer``, the unbatched
    adapter's entry point, on one layer of an aggregated record."""
    x, a, bb, ls, lb = _fa_inputs(9, B=1, T=6, shared=True)
    entry = dict(a_hat=a, b_hat=bb, ln_scale=ls, ln_bias=lb)
    want = JXP.apply_precomputed_layer(
        jnp.asarray(x[0]), {k: jnp.asarray(v) for k, v in entry.items()},
        JXPeftConfig())
    got = TXP.apply_precomputed_layer(
        _t(x[0]), {k: _t(v) for k, v in entry.items()}, XPeftConfig())
    np.testing.assert_allclose(got.numpy(), _np32(want), **F32_TOL)


# ----------------------------------------------------------------------------
# the Python half of the CUDA path: layouts, validation, build identity
# ----------------------------------------------------------------------------

def test_row_stride_layouts():
    """What the wrapper hands the kernel as batch strides: the row stride
    of a per-row operand (a layer slice of [B, L, d, b] included), 0 for
    a shared one; inner dims that are not dense raise."""
    from repro_torch.kernels.fused_adapter_batched import _row_stride
    B, L, d, b = 3, 4, 16, 8
    stacked = torch.zeros((B, L, d, b))
    assert _row_stride(stacked[:, 2], (d, b), "a") == L * d * b
    assert _row_stride(torch.zeros((d, b)), (d, b), "a") == 0
    assert _row_stride(torch.zeros((B, b)), (b,), "ln") == b
    with pytest.raises(ValueError):
        _row_stride(torch.zeros((B, b, d)).transpose(1, 2), (d, b), "a")
    with pytest.raises(ValueError):
        _row_stride(torch.zeros((B, d, b + 1)), (d, b), "a")
    with pytest.raises(ValueError):
        _row_stride(torch.zeros((2, B, d, b)), (d, b), "a")


def test_mask_aggregate_input_checks():
    from repro_torch.kernels.mask_aggregate import _check
    bank, idx, w = (_t(a) for a in _agg_inputs(6))
    _check(bank, idx, w)
    for bad in ((bank, idx.long(), w), (bank, idx, w.double()),
                (bank.double(), idx, w), (bank, idx[:, :2], w),
                (bank[0], idx, w), (bank, idx.t(), w.t()),
                (bank[:, :3, :5].contiguous(), idx, w)):
        with pytest.raises((TypeError, ValueError)):
            _check(*bad)


@pytest.mark.parametrize("P,row,itemsize,want", [
    (96, 1024 * 64, 2, (128, 8)),   # admission's A_hat / B_hat, P=96
    (1, 1024 * 64, 2, (64, 32)),    # the one-profile entry point
    (1, 1024 * 64, 4, (64, 16)),    # ... from an fp32 bank
    (4, 1024 * 64, 2, (128, 16)),   # 4 layer-folded rows: 16 in flight
])
def test_mask_aggregate_plan(P, row, itemsize, want):
    """The aggregation's block size and loads in flight: 128 threads
    where every SM still gets a block, else 64; 32 loads in flight below
    64 threads per SM, 16 below 256, else 8."""
    from repro_torch.kernels.mask_aggregate import THREADS, UNROLLS, plan
    assert plan(P, row, itemsize) == want
    assert want[0] in THREADS and want[1] in UNROLLS


def test_mask_aggregate_plan_checks():
    """Every plan is one the kernel is built for: the C entry point takes
    exactly the block sizes ``THREADS`` and instantiates exactly the loads
    in flight ``UNROLLS``, and the planner returns nothing else over the
    shapes from one profile-row to a full admission wave."""
    import re
    from repro_torch.kernels._build import CSRC
    from repro_torch.kernels.mask_aggregate import THREADS, UNROLLS, plan
    src = (CSRC / "mask_aggregate.cu").read_text()
    body = src[src.index("cudaError_t launch_u"):]
    body = body[:body.index("}  // namespace")]
    assert tuple(int(u) for u in re.findall(r"case (\d+):", body)) \
        == UNROLLS
    entry = src[src.index('extern "C" int xpeft_mask_aggregate_batched'):]
    assert tuple(int(t) for t in re.findall(r"threads != (\d+)", entry)) \
        == THREADS
    for P in (1, 2, 4, 8, 24, 96, 192, 1024):
        for row in (1024, 8 * 1024, 64 * 1024, 256 * 1024):
            for itemsize in (2, 4):
                threads, unroll = plan(P, row, itemsize)
                assert threads in THREADS and unroll in UNROLLS


@pytest.mark.parametrize("d,nb,T,itemsize,want", [
    (1024, 64, 1, 2, 8),     # qwen1.5-0.5b decode
    (1024, 64, 16, 2, 8),    # ... prefill, tensor cores
    (1024, 64, 256, 2, 8),   # the unbatched adapter's x [256, 1024]
    (1024, 64, 16, 4, 8),    # fp32
    (1024, 256, 16, 4, 16),  # fp32 at b=256: 8 blocks' slices overflow
    (768, 48, 1, 2, 8),      # bert-base, b=48
    (7168, 64, 1, 2, 16),    # llava-next-34b decode: 8 blocks overflow
    (6144, 64, 16, 2, 16),   # dbrx-132b prefill, likewise
])
def test_fused_adapter_plan(d, nb, T, itemsize, want):
    """Blocks per cluster: 8 where d / 8 is a whole number of vectors (of
    16 values in bf16) and the block's shared memory fits, else 16."""
    from repro_torch.kernels.fused_adapter_batched import (
        MAX_SMEM, plan, smem_bytes)
    assert plan(d, nb, T, itemsize) == want
    tt = 1 if T == 1 else 16
    assert smem_bytes(d // want, nb, tt, itemsize,
                      itemsize == 2 and T > 1) <= MAX_SMEM


def test_fused_adapter_plan_refusals():
    """Shapes no cluster takes raise (the wrapper never falls back), and
    the layout matches the kernel's at decode and prefill."""
    from repro_torch.kernels.fused_adapter_batched import plan, smem_bytes
    for args in ((1024, 4, 1, 2),           # b not whole vectors
                 (1024, 60, 16, 2),
                 (8192, 256, 16, 2),        # no slice fits smem
                 (7168, 64, 1, 4),          # ... at 16 blocks either
                 (1000, 64, 1, 2),          # d/cs never 16k
                 (1040, 32, 1, 2)):         # d/8, d/16 not whole 16s
        with pytest.raises(ValueError):
            plan(*args)
    # x [1, 136] + A_hat [128, 72] + B_hat [64, 128] bf16, h and partial
    # [64] and the LN affines [2, 64] fp32, 256 vectors of up-projection
    # partials
    assert smem_bytes(128, 64, 1, 2, False) == \
        272 + 18432 + 16384 + 4 * 256 + 8192
    # x [16, 136] + A_hat + B_hat, h and partial [16, 64] fp32, LN affines
    assert smem_bytes(128, 64, 16, 2, True) == \
        4352 + 18432 + 16384 + 2 * 4096 + 512


def test_fused_adapter_vector_checks():
    """x, A_hat and B_hat are copied as 16-byte vectors: a base off a
    16-byte boundary, or a batch stride that is not whole vectors,
    raises; layer slices of [B, L, d, b] pass."""
    from repro_torch.kernels.fused_adapter_batched import _check_vectors
    B, L, T, d, b = 2, 3, 4, 32, 8
    bf16 = torch.bfloat16
    x = torch.zeros((B, T, d), dtype=bf16)
    a = torch.zeros((B, L, d, b), dtype=bf16)
    bb = torch.zeros((B, L, b, d), dtype=bf16)
    _check_vectors(x, a[:, 1], bb[:, 2], L * d * b, L * b * d)
    _check_vectors(x.float(), a[0, 1].float(), bb[0, 1].float(), 0, 0)
    shifted = torch.zeros(B * T * d + 1, dtype=bf16)[1:].view(B, T, d)
    for bad in ((shifted, a[:, 1], bb[:, 1], L * d * b, L * b * d),
                (x, a[:, 1], bb[:, 1], L * d * b + 4, L * b * d),
                (x, a[:, 1], bb[:, 1], L * d * b, 12)):
        with pytest.raises(ValueError):
            _check_vectors(*bad)


def test_build_signatures_match_c_entry_points():
    """Each C entry point's parameter list, read from its source, is the
    ctypes signature ``_build`` sets for it, and every entry point has
    one."""
    import ctypes
    import re
    from repro_torch.kernels import _build
    ctype = {"const void*": ctypes.c_void_p, "void*": ctypes.c_void_p,
             "int": ctypes.c_int, "long long": ctypes.c_longlong,
             "float": ctypes.c_float, "int*": ctypes.POINTER(ctypes.c_int)}
    found = {}
    for src in _build.sources():
        for m in re.finditer(r'extern "C" int (\w+)\(([^)]*)\)',
                             src.read_text()):
            found[m.group(1)] = [ctype[" ".join(p.split()[:-1])]
                                 for p in m.group(2).split(",")]
    assert found == _build.SIGNATURES


def test_build_identity_tracks_sources(tmp_path, monkeypatch):
    """The library's name hashes every source: editing one names a new
    library (rebuilt at first use); a missing nvcc raises, never falls
    back."""
    import shutil
    from repro_torch.kernels import _build
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    monkeypatch.setattr(_build, "CSRC", csrc)
    before = _build.library_path()
    assert before == _build.library_path()
    assert before.parent == _build.BUILD_DIR
    src = sorted(csrc.glob("*.cu"))[0]
    src.write_text(src.read_text() + "\n// edit\n")
    edited = _build.library_path()
    assert edited != before
    # a shared device header counts too (the .cu files include it)
    header = csrc / "dequant.cuh"
    header.write_text(header.read_text() + "\n// edit\n")
    assert _build.library_path() not in (before, edited)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.nvcc()
