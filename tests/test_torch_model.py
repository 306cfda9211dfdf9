"""The port's model, masks, aggregation and bridge against the JAX package.

Config: ``reduce_for_smoke(get_config("qwen1.5-0.5b"))`` — 2 layers,
d=64, GQA 4/2 heads, float32, N=8, b=4, k=2 — with JAX's own weights
carried across by ``repro_torch.bridge``. JAX runs on the CPU, where its
kernel dispatch takes ``repro.kernels.ref`` (the same path as
``impl="ref"``). Tolerance: rtol = atol = 1e-5 at float32 (matmuls sum in
other orders in the two frameworks; activations are O(1)).
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs import get_config, reduce_for_smoke
from repro.core import masks as JM
from repro.core import xpeft as JXP
from repro.models import model as JMDL
from repro_torch import bridge
from repro_torch.configs import get_config as tget_config
from repro_torch.configs import reduce_for_smoke as treduce
from repro_torch.core import masks as TM
from repro_torch.core import xpeft as TXP
from repro_torch.models import model as TMDL

TOL = dict(rtol=1e-5, atol=1e-5)
JINIT = jax.jit(JMDL.init_lm, static_argnums=1)
ARCH = "qwen1.5-0.5b"


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def model():
    cfg = reduce_for_smoke(get_config(ARCH))
    tcfg = treduce(tget_config(ARCH))
    params = JINIT(jax.random.key(0), cfg)
    # non-zero biases and norm scales so every parameter is exercised
    rng = np.random.default_rng(0)
    params = jax.tree_util.tree_map_with_path(
        lambda path, v: v + 0.1 * rng.normal(size=v.shape).astype(v.dtype)
        if jax.tree_util.keystr(path).endswith(("['bq']", "['bk']", "['bv']",
                                                 "['scale']"))
        else v, params)
    return cfg, tcfg, params, bridge.to_torch(_np(params))


def _masks(cfg, params, B, seed):
    """Admission-time aggregated masks for B random hard-mask profiles,
    built by JAX's sparse aggregation and carried across."""
    xp, L = cfg.xpeft, cfg.num_layers
    rng = np.random.default_rng(seed)
    idx = np.sort(np.stack([[rng.choice(xp.num_adapters, xp.k,
                                        replace=False) for _ in range(L)]
                            for _ in range(2 * B)]), -1).astype(np.int32)
    w = np.full(idx.shape, 1.0 / xp.k, np.float32)
    ia, ib = idx[:B], idx[B:]
    a_hat, b_hat = JXP.precompute_effective_adapters_sparse(
        params["xpeft_bank"], jnp.asarray(ia), jnp.asarray(w[:B]),
        jnp.asarray(ib), jnp.asarray(w[B:]), xp)
    ls = (1 + 0.2 * rng.normal(size=(B, L, xp.bottleneck))).astype(np.float32)
    lb = (0.2 * rng.normal(size=(B, L, xp.bottleneck))).astype(np.float32)
    jm = {"a_hat": a_hat, "b_hat": b_hat, "ln_scale": jnp.asarray(ls),
          "ln_bias": jnp.asarray(lb)}
    return jm, (ia, w[:B], ib, w[B:])


# ----------------------------------------------------------------------------
# bridge
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bridge_round_trip(dtype):
    cfg = reduce_for_smoke(get_config(ARCH)).with_(dtype=dtype)
    params = _np(JINIT(jax.random.key(1), cfg))
    tp = bridge.to_torch(params)
    assert tp["embed"].dtype == getattr(torch, dtype)
    back = bridge.to_numpy(tp)
    flat_a = jax.tree_util.tree_leaves_with_path(params)
    flat_b = jax.tree_util.tree_leaves_with_path(back)
    assert [p for p, _ in flat_a] == [p for p, _ in flat_b]
    for (path, a), (_, b) in zip(flat_a, flat_b):
        assert a.dtype == b.dtype and a.shape == b.shape, path
        # bit equality, bf16 included (compared through a uint16 view)
        assert a.tobytes() == b.tobytes(), path


# ----------------------------------------------------------------------------
# masks
# ----------------------------------------------------------------------------

def test_masks_match_jax_with_ties():
    rng = np.random.default_rng(2)
    L, N, k = 6, 40, 7
    logits = np.round(rng.normal(size=(L, N)), 1).astype(np.float32)
    logits[0] = 0.5                        # a row of all-tied values
    logits[1, :12] = logits[1].max() + 1   # a tie across the top-k boundary
    jbits = np.asarray(JM.binarize(jnp.asarray(logits), k))
    tbits = TM.binarize(torch.from_numpy(logits), k).numpy()
    np.testing.assert_array_equal(tbits, jbits)
    jpack, tpack = JM.pack_mask(jbits), TM.pack_mask(tbits)
    assert jpack.dtype == tpack.dtype and jpack.tobytes() == tpack.tobytes()
    np.testing.assert_array_equal(TM.unpack_mask(tpack, N),
                                  JM.unpack_mask(jpack, N))
    np.testing.assert_array_equal(
        TM.mask_indices(tbits, k).numpy(),
        np.asarray(JM.mask_indices(jbits, k)))
    np.testing.assert_array_equal(
        TM.khot_weights_from_bits(tbits, k).numpy(),
        np.asarray(JM.khot_weights_from_bits(jbits, k)))


def test_sparse_aggregation_matches_jax(model):
    cfg, tcfg, params, tparams = model
    jm, (ia, wa, ib, wb) = _masks(cfg, params, 3, seed=3)
    ta, tb = TXP.precompute_effective_adapters_sparse(
        tparams["xpeft_bank"], torch.from_numpy(ia), torch.from_numpy(wa),
        torch.from_numpy(ib), torch.from_numpy(wb), tcfg.xpeft)
    np.testing.assert_allclose(ta.numpy(), np.asarray(jm["a_hat"]), **TOL)
    np.testing.assert_allclose(tb.numpy(), np.asarray(jm["b_hat"]), **TOL)


# ----------------------------------------------------------------------------
# forward / logits
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("with_masks", [False, True])
def test_forward_and_logits_match_jax(model, with_masks):
    cfg, tcfg, params, tparams = model
    B, T = 2, 12
    toks = np.random.default_rng(4).integers(0, cfg.vocab_size, (B, T))
    jm = tm = None
    if with_masks:
        jm, _ = _masks(cfg, params, B, seed=5)
        tm = bridge.to_torch(_np(jm))
    jh, _, _ = JMDL.forward(params, jnp.asarray(toks, jnp.int32), cfg,
                            profile_masks=jm)
    th, _, aux = TMDL.forward(tparams, torch.from_numpy(toks), tcfg,
                              profile_masks=tm)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), **TOL)
    np.testing.assert_allclose(
        TMDL.lm_logits(tparams, th, tcfg).numpy(),
        np.asarray(JMDL.lm_logits(params, jh, cfg)), **TOL)
    assert float(aux) == 0.0


def test_cached_prefill_then_per_slot_decode(model):
    """Prefill into a cache at scalar cache_pos 0, then three T=1 decode
    steps at per-slot vector positions — one slot runs off the end of the
    cache, whose writes must be dropped — comparing cache contents and
    logits with JAX after every step."""
    cfg, tcfg, params, tparams = model
    B, P, S = 3, 8, 12
    rng = np.random.default_rng(6)
    toks = rng.integers(0, cfg.vocab_size, (B, P)).astype(np.int32)
    lens = np.array([5, 8, 11], np.int32)   # slot 2 hits S-1, then drops
    jm, _ = _masks(cfg, params, B, seed=7)
    tm = bridge.to_torch(_np(jm))
    jc = JMDL.init_cache(cfg, B, S)
    tc = TMDL.init_cache(tcfg, B, S, device="cpu")
    jh, jc, _ = JMDL.forward(params, jnp.asarray(toks), cfg,
                             profile_masks=jm, cache=jc, cache_pos=0)
    th, tc, _ = TMDL.forward(tparams, torch.from_numpy(toks), tcfg,
                             profile_masks=tm, cache=tc, cache_pos=0)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), **TOL)
    last = rng.integers(0, cfg.vocab_size, (B, 1)).astype(np.int32)
    for _ in range(3):
        jh, jc, _ = JMDL.forward(params, jnp.asarray(last), cfg,
                                 profile_masks=jm, cache=jc,
                                 cache_pos=jnp.asarray(lens))
        th, tc, _ = TMDL.forward(tparams, torch.from_numpy(last), tcfg,
                                 profile_masks=tm, cache=tc,
                                 cache_pos=torch.from_numpy(lens))
        for key in ("k", "v"):
            np.testing.assert_allclose(tc[key].numpy(), np.asarray(jc[key]),
                                       **TOL)
        jl = np.asarray(JMDL.lm_logits(params, jh, cfg))
        tl = TMDL.lm_logits(tparams, th, tcfg).numpy()
        np.testing.assert_allclose(tl, jl, **TOL)
        last = jl[:, -1].argmax(-1).astype(np.int32)[:, None]
        lens = lens + 1


def test_outside_the_slice_raises(model):
    """An unknown block pattern still raises; the recurrent ones (once
    refused as ROADMAP item 10) initialise; dense masks over a
    heterogeneous bank (once refused) now run and match JAX's forward."""
    cfg, tcfg, _, _ = model
    with pytest.raises(NotImplementedError, match="unknown block_pattern"):
        TMDL.init_lm(tcfg.with_(block_pattern="s4"), device="cpu")
    for arch in ("rwkv6-7b", "zamba2-1.2b"):
        assert TMDL.init_lm(treduce(tget_config(arch)), device="cpu")
    spec = (("bottleneck", 4), ("lora", 4))
    hcfg, htcfg = (c.with_xpeft(bank_spec=spec) for c in (cfg, tcfg))
    params = JINIT(jax.random.key(1), hcfg)
    rng = np.random.default_rng(3)
    L, N, b = hcfg.num_layers, 8, hcfg.xpeft.bottleneck
    masks = {"w_a": rng.random((2, L, N)).astype(np.float32),
             "w_b": rng.random((2, L, N)).astype(np.float32),
             "ln_scale": rng.normal(size=(2, L, b)).astype(np.float32),
             "ln_bias": rng.normal(size=(2, L, b)).astype(np.float32)}
    toks = rng.integers(0, hcfg.vocab_size, (2, 5)).astype(np.int32)
    jh, _, _ = JMDL.forward(params, jnp.asarray(toks), hcfg,
                            profile_masks=masks)
    th, _, _ = TMDL.forward(bridge.to_torch(_np(params)),
                            torch.from_numpy(toks), htcfg,
                            profile_masks=bridge.to_torch(masks))
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), **TOL)
