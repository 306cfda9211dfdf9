"""The port's encoder forward against the JAX package, on the CPU.

Config: reduced ``bert-base-xpeft`` as ``benchmarks/common.py``'s
``bench_config`` builds it: ``reduce_for_smoke`` (2 layers, d=64, 4 heads
x 16, d_ff 96, float32, learned positions over 256 rows, LayerNorm, the
vanilla GELU MLP, bidirectional attention) with 4 labels, vocab 256, N=16,
k=4, b=4, 8 profiles. JAX's weights and profile table (the LN affines
and the pooler and head biases drawn away from their init) come across
through ``repro_torch.bridge``; JAX's kernels run on ``kernel_impl="ref"``
and, once, on ``"interpret"`` (Pallas interpret mode: the aggregation and
the fused adapter of the aggregated entry).

Tolerances, stated before any run: hidden states, cache contents,
``cls_logits`` and attention outputs rtol = atol = 1e-5 at float32 (the
two frameworks sum in other orders); admission aggregates rtol = atol =
1e-6 (k fp32 terms per element).
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs import get_config, reduce_for_smoke
from repro.core import masks as JM
from repro.core import xpeft as JXP
from repro.models import attention as JATT
from repro.models import model as JMDL
from repro_torch import bridge
from repro_torch.configs import get_config as tget_config
from repro_torch.configs import reduce_for_smoke as treduce
from repro_torch.core import xpeft as TXP
from repro_torch.models import attention as TATT
from repro_torch.models import model as TMDL

ARCH = "bert-base-xpeft"
TOL = dict(rtol=1e-5, atol=1e-5)
B, T = 3, 6
PIDS = np.array([0, 5, 2])


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _bench(get, reduce):
    """``benchmarks/common.py:bench_config()``'s config, in either
    package."""
    return reduce(get(ARCH)).with_(num_labels=4, vocab_size=256).with_xpeft(
        num_adapters=16, k=4, max_profiles=8)


@pytest.fixture(scope="module")
def model():
    cfg = _bench(get_config, reduce_for_smoke)
    tcfg = _bench(tget_config, treduce)
    params = jax.jit(JMDL.init_lm, static_argnums=1)(jax.random.key(0), cfg)
    params = _np(params)
    rng = np.random.default_rng(0)
    # a pooler bias and head bias away from zero, so every leaf is used
    for k in ("pool_b", "head_b"):
        params["cls"][k] = (0.1 * rng.normal(size=params["cls"][k].shape)
                            ).astype(np.float32)
    table = _np(JXP.init_profile_table(jax.random.key(1), cfg))
    table["ln_scale"] = (1 + 0.2 * rng.normal(size=table["ln_scale"].shape)
                         ).astype(np.float32)
    table["ln_bias"] = (0.2 * rng.normal(size=table["ln_bias"].shape)
                        ).astype(np.float32)
    return cfg, tcfg, params, bridge.to_torch(params), table


def _tokens(seed, b=B, t=T, vocab=256):
    return np.random.default_rng(seed).integers(
        0, vocab, size=(b, t)).astype(np.int32)


def test_init_tree_matches_jax(model):
    """The port's init draws the same tree: ``pos_embed``, the untied LM
    head and the fp32 ``cls`` subtree included."""
    _, tcfg, params, _, _ = model
    got = bridge.to_numpy(TMDL.init_lm(tcfg, seed=0, device="cpu"))
    assert jax.tree.structure(got) == jax.tree.structure(params)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(params)):
        assert a.shape == b.shape and a.dtype == b.dtype
    assert got["pos_embed"].shape == (256, 64)
    assert sorted(got["cls"]) == ["head_b", "head_w", "pool_b", "pool_w"]
    assert got["cls"]["head_w"].shape == (64, 4)
    assert "lm_head" in got


def _forms(cfg, params, table):
    """Each mask form of JAX's ``profile_masks`` for the PIDS profiles; the
    aggregated entry through JAX's ``precompute_effective_adapters_sparse``
    under ``cfg``'s kernel_impl (with the k-sparse indices it came from)."""
    xp = cfg.xpeft
    prof = {k: jnp.asarray(v[PIDS]) for k, v in table.items()}
    ln = {"ln_scale": prof["ln_scale"], "ln_bias": prof["ln_bias"]}
    w_a, w_b = JXP.profile_mask_weights(prof, xp, training=False)
    bits_a = np.asarray(JM.binarize(prof["mA"], xp.k))
    bits_b = np.asarray(JM.binarize(prof["mB"], xp.k))
    ia, ib = JM.mask_indices(bits_a, xp.k), JM.mask_indices(bits_b, xp.k)
    wk = jnp.full(ia.shape, 1.0 / xp.k, jnp.float32)
    soft_a, soft_b = (JM.soft_mask_weights(prof[m]) for m in ("mA", "mB"))
    bank = jax.tree.map(jnp.asarray, params["xpeft_bank"])
    a_hat, b_hat = JXP.precompute_effective_adapters_sparse(
        bank, ia, wk, ib, wk, xp)
    return {"none": None,
            "dense": dict(ln, w_a=w_a, w_b=w_b),
            "soft": dict(ln, w_a=soft_a, w_b=soft_b),
            "sparse": dict(ln, idx_a=ia, w_a=wk, idx_b=ib, w_b=wk),
            "aggregated": dict(ln, a_hat=a_hat, b_hat=b_hat)}


@pytest.mark.parametrize("form,impl", [
    ("none", "ref"), ("dense", "ref"), ("soft", "ref"), ("sparse", "ref"),
    ("aggregated", "ref"), ("aggregated", "interpret")])
def test_hidden_states_match_jax_for_each_mask_form(model, form, impl):
    cfg, tcfg, params, tparams, table = model
    cfg = cfg.with_xpeft(kernel_impl=impl)
    forms = _forms(cfg, params, table)
    masks = forms[form]
    toks = _tokens(5)
    jh, _, _ = JMDL.forward(jax.tree.map(jnp.asarray, params),
                            jnp.asarray(toks), cfg, profile_masks=masks)
    tmasks = None if masks is None else bridge.to_torch(_np(masks))
    if form == "aggregated":
        # the port aggregates the same k-sparse indices itself
        sp = bridge.to_torch(_np(forms["sparse"]))
        a_hat, b_hat = TXP.precompute_effective_adapters_sparse(
            tparams["xpeft_bank"], sp["idx_a"], sp["w_a"], sp["idx_b"],
            sp["w_b"], tcfg.xpeft)
        np.testing.assert_allclose(a_hat.numpy(), np.asarray(masks["a_hat"]),
                                   rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(b_hat.numpy(), np.asarray(masks["b_hat"]),
                                   rtol=1e-6, atol=1e-6)
        tmasks.update(a_hat=a_hat, b_hat=b_hat)
    th, _, _ = TMDL.forward(tparams, torch.from_numpy(toks), tcfg,
                            profile_masks=tmasks)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), **TOL)
    np.testing.assert_allclose(
        TMDL.cls_logits(tparams, th, tcfg).numpy(),
        np.asarray(JMDL.cls_logits(params, jh, cfg)), **TOL)


def test_bidirectional_attention_sees_later_tokens(model):
    """The encoder's first position changes with the last token (a causal
    model's would not): attention follows ``cfg.causal``."""
    _, tcfg, _, tparams, _ = model
    toks = torch.from_numpy(_tokens(6))
    other = toks.clone()
    other[:, -1] = (other[:, -1] + 1) % 256
    h0 = TMDL.forward(tparams, toks, tcfg)[0]
    h1 = TMDL.forward(tparams, other, tcfg)[0]
    assert (h0[:, 0] - h1[:, 0]).abs().max() > 1e-4


@pytest.mark.parametrize("per_slot", [False, True])
def test_learned_positions_with_a_cache_match_jax(model, per_slot):
    """``pos_embed`` rows from a scalar ``cache_pos`` > 0 (a slice) and
    from per-slot positions (a gather), through the cached forward."""
    cfg, tcfg, params, tparams, _ = model
    S = 16
    toks = _tokens(7, t=4)
    cache_pos = np.array([0, 5, 9], np.int32) if per_slot else 3
    jcache = JMDL.init_cache(cfg, B, S)
    jh, jc, _ = JMDL.forward(jax.tree.map(jnp.asarray, params),
                             jnp.asarray(toks), cfg, cache=jcache,
                             cache_pos=jnp.asarray(cache_pos))
    tcache = TMDL.init_cache(tcfg, B, S, device="cpu")
    tpos = torch.from_numpy(cache_pos) if per_slot else cache_pos
    th, tc, _ = TMDL.forward(tparams, torch.from_numpy(toks), tcfg,
                             cache=tcache, cache_pos=tpos)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), **TOL)
    for k in ("k", "v"):
        np.testing.assert_allclose(tc[k].numpy(), np.asarray(jc[k]), **TOL)


def test_cls_logits_shared_and_per_example_heads_match_jax(model):
    cfg, tcfg, params, tparams, _ = model
    rng = np.random.default_rng(8)
    hidden = rng.normal(size=(B, T, 64)).astype(np.float32)
    want = JMDL.cls_logits(params, jnp.asarray(hidden), cfg)
    got = TMDL.cls_logits(tparams, torch.from_numpy(hidden), tcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    # the shared head passed as the override is still the shared head
    same = TMDL.cls_logits(tparams, torch.from_numpy(hidden), tcfg,
                           tparams["cls"])
    assert torch.equal(same, got)
    heads = {"head_w": (0.1 * rng.normal(size=(B, 64, 4))).astype(np.float32),
             "head_b": (0.1 * rng.normal(size=(B, 4))).astype(np.float32)}
    want = JMDL.cls_logits(params, jnp.asarray(hidden), cfg,
                           jax.tree.map(jnp.asarray, heads))
    got = TMDL.cls_logits(tparams, torch.from_numpy(hidden), tcfg,
                          bridge.to_torch(heads))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


# ----------------------------------------------------------------------------
# chunked attention
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("causal,cap", [(True, 0.0), (False, 0.0),
                                        (False, 20.0)])
def test_sdpa_chunked_matches_jax(causal, cap):
    """The online softmax over 4 query chunks x 3 key chunks, with the
    last 5 key slots past ``kv_valid``."""
    rng = np.random.default_rng(9)
    Bq, KV, G, Tq, S, hd = 2, 2, 2, 16, 24, 8
    q = rng.normal(size=(Bq, KV, G, Tq, hd)).astype(np.float32)
    k = rng.normal(size=(Bq, KV, S, hd)).astype(np.float32)
    v = rng.normal(size=(Bq, KV, S, hd)).astype(np.float32)
    q_pos = np.broadcast_to(np.arange(Tq, dtype=np.int32) + 3, (Bq, Tq))
    k_pos = np.arange(S, dtype=np.int32)
    kv_valid = np.array([S - 5, S], np.int32)
    kw = dict(causal=causal, kv_valid=kv_valid, scale=hd ** -0.5, cap=cap,
              q_chunk=4, k_chunk=8)
    want = JATT._sdpa_chunked(*(jnp.asarray(a) for a in (q, k, v, q_pos,
                                                          k_pos)),
                              window=None, **kw)
    tkw = dict(kw, kv_valid=torch.from_numpy(kv_valid))
    got = TATT._sdpa_chunked(*(torch.from_numpy(np.ascontiguousarray(a))
                               for a in (q, k, v, q_pos, k_pos)), **tkw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("arch", ["bert-base-xpeft", "qwen1.5-0.5b"])
@pytest.mark.parametrize("cached", [False, True])
def test_attention_takes_the_chunked_branch_and_matches_jax(monkeypatch,
                                                            arch, cached):
    """``attention`` at q_chunk 4 / k_chunk 8: T=16 uncached (S = T), or
    T=8 into a 16-slot cache at cache_pos 0 (kv_valid 8 < S); bidirectional
    (bert) and causal with RoPE (qwen). The port must take the chunked
    branch where JAX does, and agree with JAX and with its own dense
    softmax."""
    cfg = reduce_for_smoke(get_config(arch))
    tcfg = treduce(tget_config(arch))
    params = _np(jax.jit(JMDL.init_lm, static_argnums=1)(jax.random.key(3),
                                                         cfg))
    att = jax.tree.map(lambda a: a[0], params["blocks"]["attn"])
    tatt = bridge.to_torch(att)
    Tq = 8 if cached else 16
    x = np.random.default_rng(10).normal(size=(2, Tq, 64)).astype(
        np.float32)
    pos = np.broadcast_to(np.arange(Tq, dtype=np.int32), (2, Tq))
    jkw = dict(positions=jnp.asarray(pos), cfg=cfg, q_chunk=4, k_chunk=8)
    tkw = dict(positions=torch.from_numpy(np.ascontiguousarray(pos)),
               cfg=tcfg)
    if cached:
        shape = (2, 16, cfg.num_kv_heads, cfg.head_dim)
        jkw.update(cache={"k": jnp.zeros(shape), "v": jnp.zeros(shape)},
                   cache_pos=0)
        tkw.update(cache_pos=0)
    want, _ = JATT.attention(att, jnp.asarray(x), **jkw)
    calls = []
    chunked = TATT._sdpa_chunked

    def spy(*a, **kw):
        calls.append(kw["q_chunk"])
        return chunked(*a, **kw)
    monkeypatch.setattr(TATT, "_sdpa_chunked", spy)

    def cache():
        if not cached:
            return None
        return {"k": torch.zeros(shape), "v": torch.zeros(shape)}
    got, _ = TATT.attention(tatt, torch.from_numpy(x), cache=cache(),
                            q_chunk=4, k_chunk=8, **tkw)
    assert calls == [4]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    dense, _ = TATT.attention(tatt, torch.from_numpy(x), cache=cache(),
                              **tkw)
    assert calls == [4]
    np.testing.assert_allclose(got.numpy(), dense.numpy(), **TOL)
