"""The port's mixture-of-experts decoders, forward and serving engines,
against the JAX package on the CPU.

Configs: ``reduce_for_smoke`` of ``qwen3-moe-30b-a3b`` and ``dbrx-132b``
(2 layers, d=64, 8 experts, top-2, per-expert d_ff 32, capacity_factor
1.25, float32; bank N=8, b=4, k=2), JAX's weights and profile logits
carried across by ``repro_torch.bridge``.

Forward: hidden states, logits and the load-balance aux (the mean over
layers) for each mask form, aggregated ``a_hat``, dense ``w_a`` and
sparse ``idx_a``, uncached and prefill-then-decode through a cache, at
rtol = atol = 1e-5 (other summation orders at float32). A zero adapter
entry leaves the forward BITWISE the bare one.

Serving: ``benchmarks/cb_smoke.py``'s skewed workload (6 requests, 2
slots, max_seq 64, sync_every 4, page_size 16, long requests 20 new
tokens; ``tests/test_torch_serve_continuous.py``'s drain). Greedy tokens
EQUAL JAX's for the windowed, continuous, speculative (gamma 3, at
capacity_factor 1.25 and 64) and int8 engines. The engines run
``forward`` over the whole slot batch, padded prompt rows and idle slots
included: those rows route to experts and take capacity, so only JAX's
own batches give JAX's drops. Speculation's verify runs gamma + 1 tokens
a slot, which changes the capacity and so the drops: at 1.25 a spec
engine's tokens part from its plain run's (in JAX as in the port); at 64
nothing is dropped and spec equals plain bitwise. ``decode_fused=True``
keeps MoE blocks composed: the decode megakernel is never called and the
tokens are the composed run's.
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
from repro.serve.engine import Request as JRequest
from repro.serve.engine import ServeEngine as JEngine
from repro_torch import bridge
from repro_torch.configs import get_config as tget_config
from repro_torch.configs import reduce_for_smoke as treduce
from repro_torch.kernels import ops
from repro_torch.models import model as TMDL
from repro_torch.serve import Request as TRequest
from repro_torch.serve import ServeEngine as TEngine

from test_torch_serve_continuous import ENGINE, _stores, skewed_requests

TOL = dict(rtol=1e-5, atol=1e-5)
ARCHS = ["qwen3-moe-30b-a3b", "dbrx-132b"]
N_PROFILES = 3
SPEC = dict(spec_enable=True, spec_gamma=3)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module", params=ARCHS)
def setup(request):
    cfg = reduce_for_smoke(get_config(request.param))
    tcfg = treduce(tget_config(request.param))
    assert cfg.moe and tcfg.moe and cfg.capacity_factor == 1.25
    key = jax.random.key(0)
    params = jax.jit(JMDL.init_lm, static_argnums=1)(key, cfg)
    table = _np(JXP.init_profile_table(key, cfg))
    rows = [{k: np.array(v[pid]) for k, v in table.items()}
            for pid in range(N_PROFILES)]
    return dict(cfg=cfg, tcfg=tcfg, params=params, table=table, rows=rows,
                tparams=bridge.to_torch(_np(params)), runs={})


# ----------------------------------------------------------------------------
# forward
# ----------------------------------------------------------------------------

def _forms(s):
    """Each mask form of ``profile_masks`` for profiles [0, 2, 1], with LN
    affines away from identity."""
    cfg, params, xp = s["cfg"], s["params"], s["cfg"].xpeft
    rng = np.random.default_rng(0)
    prof = {k: jnp.asarray(v[[0, 2, 1]]) for k, v in s["table"].items()}
    prof["ln_scale"] = jnp.asarray(1 + 0.2 * rng.normal(
        size=prof["ln_scale"].shape), jnp.float32)
    prof["ln_bias"] = jnp.asarray(0.2 * rng.normal(
        size=prof["ln_bias"].shape), jnp.float32)
    ln = {"ln_scale": prof["ln_scale"], "ln_bias": prof["ln_bias"]}
    w_a, w_b = JXP.profile_mask_weights(prof, xp, training=False)
    ia = JM.mask_indices(np.asarray(JM.binarize(prof["mA"], xp.k)), xp.k)
    ib = JM.mask_indices(np.asarray(JM.binarize(prof["mB"], xp.k)), xp.k)
    wk = jnp.full(ia.shape, 1.0 / xp.k, jnp.float32)
    effs = [JXP.precompute_effective_adapters(
        params["xpeft_bank"], {k: v[i] for k, v in prof.items()}, xp)
        for i in range(3)]
    return {"a_hat": {k: jnp.stack([e[k] for e in effs]) for k in effs[0]},
            "dense": dict(ln, w_a=w_a, w_b=w_b),
            "sparse": dict(ln, idx_a=ia, w_a=wk, idx_b=ib, w_b=wk)}


def _check(th, taux, jh, jaux, s):
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), **TOL)
    np.testing.assert_allclose(float(taux), float(jaux), **TOL)
    np.testing.assert_allclose(
        TMDL.lm_logits(s["tparams"], th, s["tcfg"]).numpy(),
        np.asarray(JMDL.lm_logits(s["params"], jh, s["cfg"])), **TOL)


@pytest.mark.parametrize("form", ["a_hat", "dense", "sparse"])
def test_forward_and_aux_match_jax(setup, form):
    s = setup
    masks = _forms(s)[form]
    tmasks = bridge.to_torch(_np(masks))
    toks = np.random.default_rng(5).integers(
        0, s["cfg"].vocab_size, (3, 7)).astype(np.int32)
    jh, _, jaux = JMDL.forward(s["params"], jnp.asarray(toks), s["cfg"],
                               profile_masks=masks)
    th, _, taux = TMDL.forward(s["tparams"], torch.from_numpy(toks),
                               s["tcfg"], profile_masks=tmasks)
    _check(th, taux, jh, jaux, s)
    assert float(taux) > 0


@pytest.mark.parametrize("form", ["a_hat", "dense", "sparse"])
def test_prefill_then_decode_match_jax(setup, form):
    """Prefill 6 tokens into a cache at scalar cache_pos 0, then three
    T=1 steps at per-slot positions: hidden states, logits, aux and the
    cache against JAX's after every call."""
    s = setup
    cfg, tcfg = s["cfg"], s["tcfg"]
    masks = _forms(s)[form]
    tmasks = bridge.to_torch(_np(masks))
    B, P, S = 3, 6, 16
    rng = np.random.default_rng(6)
    toks = rng.integers(0, cfg.vocab_size, (B, P)).astype(np.int32)
    jc = JMDL.init_cache(cfg, B, S)
    tc = TMDL.init_cache(tcfg, B, S, device="cpu")
    jh, jc, jaux = JMDL.forward(s["params"], jnp.asarray(toks), cfg,
                                profile_masks=masks, cache=jc, cache_pos=0)
    th, tc, taux = TMDL.forward(s["tparams"], torch.from_numpy(toks), tcfg,
                                profile_masks=tmasks, cache=tc, cache_pos=0)
    _check(th, taux, jh, jaux, s)
    lens = np.array([6, 4, 5], np.int32)
    last = rng.integers(0, cfg.vocab_size, (B, 1)).astype(np.int32)
    for _ in range(3):
        jh, jc, jaux = JMDL.forward(s["params"], jnp.asarray(last), cfg,
                                    profile_masks=masks, cache=jc,
                                    cache_pos=jnp.asarray(lens))
        th, tc, taux = TMDL.forward(s["tparams"], torch.from_numpy(last),
                                    tcfg, profile_masks=tmasks, cache=tc,
                                    cache_pos=torch.from_numpy(lens))
        _check(th, taux, jh, jaux, s)
        for key in ("k", "v"):
            np.testing.assert_allclose(tc[key].numpy(), np.asarray(jc[key]),
                                       **TOL)
        last = np.asarray(JMDL.lm_logits(s["params"], jh, cfg))[:, -1] \
            .argmax(-1).astype(np.int32)[:, None]
        lens = lens + 1


def test_zero_mask_is_bitwise_bare(setup):
    """A zero entry (the engine's free-slot template: zero A/B, identity
    LN) adds exactly 0 in every layer: hidden states and aux bitwise the
    bare forward's, uncached and through a cache."""
    s = setup
    cfg, tcfg = s["cfg"], s["tcfg"]
    L, d, b = cfg.num_layers, cfg.d_model, cfg.xpeft.bottleneck
    B, T = 3, 7
    zero = {"a_hat": torch.zeros((B, L, d, b)),
            "b_hat": torch.zeros((B, L, b, d)),
            "ln_scale": torch.ones((B, L, b)),
            "ln_bias": torch.zeros((B, L, b))}
    toks = torch.from_numpy(np.random.default_rng(7).integers(
        0, cfg.vocab_size, (B, T)))
    for cached in (False, True):
        kw = [dict(cache=TMDL.init_cache(tcfg, B, 16, device="cpu"))
              if cached else {} for _ in range(2)]
        h0, _, a0 = TMDL.forward(s["tparams"], toks, tcfg, **kw[0])
        h1, _, a1 = TMDL.forward(s["tparams"], toks, tcfg,
                                 profile_masks=zero, **kw[1])
        assert torch.equal(h0, h1) and torch.equal(a0, a1)


# ----------------------------------------------------------------------------
# serving engines
# ----------------------------------------------------------------------------

def drain(s, *, port, continuous, cfg_kw=None, xpeft_kw=None,
          store_kw=None):
    """The skewed workload drained by one engine; memoized per setup."""
    key = (port, continuous, repr(cfg_kw), repr(xpeft_kw), repr(store_kw))
    if key in s["runs"]:
        return s["runs"][key]
    cfg = (s["tcfg"] if port else s["cfg"]).with_(**(cfg_kw or {})) \
        .with_xpeft(**(xpeft_kw or {}))
    store = _stores(cfg, s["rows"], **(store_kw or {}))[int(port)]
    eng = (TEngine if port else JEngine)(
        cfg, s["tparams"] if port else s["params"], store,
        continuous=continuous, **ENGINE)
    reqs = skewed_requests(TRequest if port else JRequest, cfg.vocab_size,
                           6, long_new=20)
    eng.run_until_drained(list(reqs))
    assert all(r.done for r in reqs)
    out = (eng, {r.uid: list(map(int, r.generated)) for r in reqs})
    s["runs"][key] = out
    return out


@pytest.mark.parametrize("continuous", [False, True])
def test_engine_tokens_equal_jax(setup, continuous):
    eng, toks = drain(setup, port=True, continuous=continuous)
    jeng, jtoks = drain(setup, port=False, continuous=continuous)
    assert toks == jtoks
    st, jst = eng.serve_stats(), jeng.serve_stats()
    for key in ("device_steps", "host_syncs", "decode_tokens",
                "prefill_batches", "stranded_slot_steps"):
        assert st[key] == jst[key], key
    if continuous:
        # this workload drops the same routes in both batchings
        assert toks == drain(setup, port=True, continuous=False)[1]
        eng.page_alloc.check()


@pytest.mark.parametrize("cf", [1.25, 64.0])
def test_spec_tokens_equal_jax(setup, cf):
    """Speculation at gamma 3 equals JAX's speculative engine, tokens and
    acceptance; against the plain continuous run it parts where JAX's
    does (capacity follows the verify's B x (gamma + 1) tokens) and
    equals it bitwise where nothing is dropped (64)."""
    # the configs' own factor is 1.25: its plain runs are memoized as such
    kw = dict(cfg_kw=dict(capacity_factor=cf)) if cf != 1.25 else {}
    skw = dict(cfg_kw=dict(SPEC, capacity_factor=cf))
    _, plain = drain(setup, port=True, continuous=True, **kw)
    _, jplain = drain(setup, port=False, continuous=True, **kw)
    eng, toks = drain(setup, port=True, continuous=True, **skw)
    jeng, jtoks = drain(setup, port=False, continuous=True, **skw)
    assert toks == jtoks
    assert plain == jplain
    assert eng.serve_stats()["spec"] == jeng.serve_stats()["spec"]
    assert eng.serve_stats()["spec"]["drafted"] > 0
    assert (toks == plain) == (jtoks == jplain)
    if cf == 64.0:
        assert toks == plain


def test_int8_engine_tokens_equal_jax(setup):
    kw = dict(xpeft_kw=dict(bank_quant="int8"), store_kw=dict(quant="int8"))
    eng, toks = drain(setup, port=True, continuous=False, **kw)
    _, jtoks = drain(setup, port=False, continuous=False, **kw)
    assert toks == jtoks
    # quantized records in the slots; the bf16 bank left the params
    assert "a_q" in eng.masks and "xpeft_bank" not in eng.params


def test_decode_fused_keeps_moe_composed(setup, monkeypatch):
    calls = []
    real = ops.decode_block_fused

    def spy(*args, **kwargs):
        calls.append(1)
        return real(*args, **kwargs)
    monkeypatch.setattr(ops, "decode_block_fused", spy)
    cfg = setup["tcfg"].with_(decode_fused=True)
    assert TMDL._decode_fused_route(cfg, None, True, 1) is None
    _, ref = drain(setup, port=True, continuous=False)
    eng = TEngine(cfg, setup["tparams"], _stores(cfg, setup["rows"])[1],
                  continuous=False, **ENGINE)
    reqs = skewed_requests(TRequest, cfg.vocab_size, 6, long_new=20)
    eng.run_until_drained(list(reqs))
    assert {r.uid: list(map(int, r.generated)) for r in reqs} == ref
    assert not calls
