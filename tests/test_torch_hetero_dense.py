"""The port's dense forms over a heterogeneous bank against the JAX package,
on the CPU.

Config: reduced qwen1.5-0.5b (2 layers, d=64, GQA 4/2 heads, float32) with
N=12 unified mask slots, b=4, k=4, P=2 prefix rows, under four spec mixes
(``SPECS``: all four families; no prefix; IA3 alone; prefix alone), JAX's
own weights carried across by ``repro_torch.bridge``. Mask weights are
drawn from a numpy seed; one example selects no prefix slot at all and
one selects none at layer 1 only.

Tolerances: rtol = atol = 1e-5 against JAX (fp32 sums in other orders);
``quantize_bank_hetero`` byte-equal; the port's zero-mask hetero forward
BITWISE the port's own bare forward (JAX's copy of that check is off by
~1.4e-6 inside the reference; the port holds it against itself).
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs import get_config, reduce_for_smoke
from repro.core import adapters as JA
from repro.core import xpeft as JXP
from repro.models import model as JMDL
from repro.quant import schemes as JQS
from repro_torch import bridge
from repro_torch.configs import get_config as tget_config
from repro_torch.configs import reduce_for_smoke as treduce
from repro_torch.core import adapters as TA
from repro_torch.core import xpeft as TXP
from repro_torch.models import attention as TATT
from repro_torch.models import model as TMDL
from repro_torch.quant import schemes as TQS

TOL = dict(rtol=1e-5, atol=1e-5)
ARCH = "qwen1.5-0.5b"
P = 2
SPECS = {
    "mixed": (("bottleneck", 4), ("lora", 4), ("ia3", 2), ("prefix", 2)),
    "no_prefix": (("bottleneck", 6), ("lora", 4), ("ia3", 2)),
    "ia3_only": (("ia3", 12),),
    "prefix_only": (("prefix", 12),),
}
JINIT = jax.jit(JMDL.init_lm, static_argnums=1)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _cfgs(spec):
    kw = dict(num_adapters=12, bottleneck=4, k=4, max_profiles=8,
              bank_spec=spec, prefix_tokens=P)
    return (reduce_for_smoke(get_config(ARCH)).with_xpeft(**kw),
            treduce(tget_config(ARCH)).with_xpeft(**kw))


@pytest.fixture(scope="module")
def models():
    out = {}
    for name, spec in SPECS.items():
        cfg, tcfg = _cfgs(spec)
        params = JINIT(jax.random.key(0), cfg)
        out[name] = (cfg, tcfg, params, bridge.to_torch(_np(params)))
    return out


def _prefix_seg(xp):
    return next(((o, c) for t, o, c in xp.segments() if t == "prefix"),
                None)


def _weights(xp, B, L, seed):
    """Dense unified-space weights [B, L, N] (A and B), with example 1
    selecting no prefix slot and example 2 none at layer 1 (B >= 3)."""
    rng = np.random.default_rng(seed)
    N = xp.num_adapters
    wa = rng.random((B, L, N)).astype(np.float32)
    wb = rng.random((B, L, N)).astype(np.float32)
    seg = _prefix_seg(xp)
    if seg is not None:
        off, cnt = seg
        for w in (wa, wb):
            w[1, :, off:off + cnt] = 0.0
            w[2, 1, off:off + cnt] = 0.0
    return wa, wb


def _masks(xp, B, L, seed):
    wa, wb = _weights(xp, B, L, seed)
    rng = np.random.default_rng(seed + 100)
    b = xp.bottleneck
    return {"w_a": wa, "w_b": wb,
            "ln_scale": (1 + 0.1 * rng.normal(size=(B, L, b))).astype(
                np.float32),
            "ln_bias": (0.1 * rng.normal(size=(B, L, b))).astype(
                np.float32)}


def _layer(bank, l):
    return {k: v[l] for k, v in bank.items()}


def _close(got, want):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               **TOL)


# ------------------------------------------------------- adapter primitives

@pytest.mark.parametrize("batched", [False, True])
def test_apply_lora_and_ia3(batched):
    rng = np.random.default_rng(0)
    B, T, d, b = 3, 5, 16, 4
    x = rng.normal(size=(B, T, d)).astype(np.float32)
    lead = (B,) if batched else ()
    la = rng.normal(size=lead + (d, b)).astype(np.float32)
    lb = rng.normal(size=lead + (b, d)).astype(np.float32)
    s = (0.1 * rng.normal(size=lead + (d,))).astype(np.float32)
    t = torch.from_numpy
    _close(TA.apply_lora(t(x), t(la), t(lb)),
           JA.apply_lora(jnp.asarray(x), jnp.asarray(la), jnp.asarray(lb)))
    _close(TA.apply_ia3(t(x), t(s)), JA.apply_ia3(jnp.asarray(x),
                                                  jnp.asarray(s)))
    # s == 0 (an empty selection) is bitwise the identity
    assert torch.equal(TA.apply_ia3(t(x), torch.zeros_like(t(s))), t(x))


# ---------------------------------------------------- core/xpeft functions

@pytest.mark.parametrize("name", sorted(SPECS))
def test_hetero_aggregate_dense_layer(models, name):
    cfg, tcfg, params, tparams = models[name]
    wa, wb = _weights(cfg.xpeft, 4, cfg.num_layers, seed=1)
    for l in range(cfg.num_layers):
        got = TXP.hetero_aggregate_dense_layer(
            _layer(tparams["xpeft_bank"], l), torch.from_numpy(wa[:, l]),
            torch.from_numpy(wb[:, l]), tcfg.xpeft)
        want = JXP.hetero_aggregate_dense_layer(
            _layer(params["xpeft_bank"], l), jnp.asarray(wa[:, l]),
            jnp.asarray(wb[:, l]), cfg.xpeft)
        assert sorted(got) == sorted(want)
        for key in want:
            g, w = got[key], want[key]
            for gi, wi in zip(*((g, w) if isinstance(w, tuple)
                                else ((g,), (w,)))):
                _close(gi, wi)


@pytest.mark.parametrize("name", sorted(SPECS))
def test_precompute_effective_adapters_hetero(models, name):
    cfg, tcfg, params, tparams = models[name]
    rng = np.random.default_rng(2)
    L, N, b = cfg.num_layers, cfg.xpeft.num_adapters, cfg.xpeft.bottleneck
    prof = {"mA": rng.normal(size=(L, N)).astype(np.float32),
            "mB": rng.normal(size=(L, N)).astype(np.float32),
            "ln_scale": np.ones((L, b), np.float32),
            "ln_bias": np.zeros((L, b), np.float32)}
    seg = _prefix_seg(cfg.xpeft)
    if seg is not None and name == "mixed":
        # layer 1 selects no prefix slot: its rows renormalize 0/0 -> 0
        off, cnt = seg
        for m in ("mA", "mB"):
            prof[m][1, off:off + cnt] = -30.0
    got = TXP.precompute_effective_adapters_hetero(
        tparams["xpeft_bank"], bridge.to_torch(prof), tcfg.xpeft)
    want = JXP.precompute_effective_adapters_hetero(
        params["xpeft_bank"], prof, cfg.xpeft)
    assert tuple(got) == tuple(want)
    assert set(got) == set(TXP.hetero_entry_keys(tcfg.xpeft))
    for key in want:
        _close(got[key], want[key])


@pytest.mark.parametrize("name", sorted(SPECS))
def test_apply_xpeft_layer_hetero_and_prefix_rows(models, name):
    cfg, tcfg, params, tparams = models[name]
    m = _masks(cfg.xpeft, 3, cfg.num_layers, seed=3)
    x = np.random.default_rng(4).normal(size=(3, 5, cfg.d_model)).astype(
        np.float32)
    KV, hd = cfg.num_kv_heads, cfg.head_dim
    for l in range(cfg.num_layers):
        tb, jb = _layer(tparams["xpeft_bank"], l), \
            _layer(params["xpeft_bank"], l)
        tm = {k: torch.from_numpy(v[:, l]) for k, v in m.items()}
        jm = {k: jnp.asarray(v[:, l]) for k, v in m.items()}
        got = TXP.apply_xpeft_layer_hetero(
            torch.from_numpy(x), tb, tm["w_a"], tm["w_b"],
            tm["ln_scale"][:, None], tm["ln_bias"][:, None], tcfg.xpeft)
        want = JXP.apply_xpeft_layer_hetero(
            jnp.asarray(x), jb, jm["w_a"], jm["w_b"],
            jm["ln_scale"][:, None], jm["ln_bias"][:, None], cfg.xpeft)
        _close(got, want)
        got = TXP.prefix_rows_dense_layer(tb, tm["w_a"], tm["w_b"],
                                          tcfg.xpeft, KV, hd)
        want = JXP.prefix_rows_dense_layer(jb, jm["w_a"], jm["w_b"],
                                           cfg.xpeft, KV, hd)
        if want is None:
            assert got is None
            continue
        _close(got[0], want[0])
        _close(got[1], want[1])
        assert got[2].tolist() == np.asarray(want[2]).tolist()
        # example 1 never selects a prefix slot; example 2 not at layer 1
        assert not got[2][1] and bool(got[2][2]) == (l == 0)


# ------------------------------------------------------------ the forward

@pytest.mark.parametrize("name", sorted(SPECS))
def test_dense_hetero_forward_hidden_and_logits(models, name):
    cfg, tcfg, params, tparams = models[name]
    B, T = 4, 7
    m = _masks(cfg.xpeft, B, cfg.num_layers, seed=5)
    toks = np.random.default_rng(6).integers(
        0, cfg.vocab_size, (B, T)).astype(np.int32)
    jh, _, _ = JMDL.forward(params, jnp.asarray(toks), cfg,
                            profile_masks=m)
    th, _, _ = TMDL.forward(tparams, torch.from_numpy(toks), tcfg,
                            profile_masks=bridge.to_torch(m))
    _close(th, jh)
    _close(TMDL.lm_logits(tparams, th, tcfg),
           JMDL.lm_logits(params, jh, cfg))


def test_prefix_position_offset_is_per_example(models, monkeypatch):
    """The prompt's RoPE positions start at P only for the examples that
    select a prefix slot at some layer; the others keep bare positions."""
    cfg, tcfg, params, tparams = models["mixed"]
    B, T = 3, 6
    m = _masks(cfg.xpeft, B, cfg.num_layers, seed=7)
    seen = []
    rope = TATT.apply_rope

    def spy(x, positions, theta):
        seen.append(positions.clone())
        return rope(x, positions, theta)
    monkeypatch.setattr(TATT, "apply_rope", spy)
    toks = np.arange(B * T, dtype=np.int32).reshape(B, T) % cfg.vocab_size
    th, _, _ = TMDL.forward(tparams, torch.from_numpy(toks), tcfg,
                            profile_masks=bridge.to_torch(m))
    want_pos = np.arange(T)[None] + np.array([P, 0, P])[:, None]
    assert seen and all(p.tolist() == want_pos.tolist() for p in seen)
    jh, _, _ = JMDL.forward(params, jnp.asarray(toks), cfg,
                            profile_masks=m)
    _close(th, jh)


@pytest.mark.parametrize("name", sorted(SPECS))
def test_zero_mask_hetero_forward_is_bitwise_bare(models, name):
    _, tcfg, _, tparams = models[name]
    B, T, L = 2, 10, tcfg.num_layers
    N, b = tcfg.xpeft.num_adapters, tcfg.xpeft.bottleneck
    toks = torch.arange(B * T).reshape(B, T) % tcfg.vocab_size
    zero = {"w_a": torch.zeros((B, L, N)), "w_b": torch.zeros((B, L, N)),
            "ln_scale": torch.ones((B, L, b)),
            "ln_bias": torch.zeros((B, L, b))}
    h0, _, _ = TMDL.forward(tparams, toks, tcfg)
    h1, _, _ = TMDL.forward(tparams, toks, tcfg, profile_masks=zero)
    assert torch.equal(h0, h1)


def test_mask_logit_grads_finite_without_prefix_selection(models):
    """Straight-through hard masks whose top-k selects no prefix slot at
    some layer: wsum is exactly 0 there, and the double-where renorm keeps
    every mask-logit gradient finite (a single where gives NaN)."""
    cfg, tcfg, _, tparams = models["mixed"]
    xp = tcfg.xpeft
    off, cnt = _prefix_seg(xp)
    rng = np.random.default_rng(8)
    B, L, N = 2, tcfg.num_layers, xp.num_adapters
    logits = rng.normal(size=(2, B, L, N)).astype(np.float32)
    logits[:, :, :, off:off + cnt] = -30.0       # never in the top-k
    mA, mB = (torch.from_numpy(v).requires_grad_(True) for v in logits)
    w_a, w_b = TXP.profile_mask_weights({"mA": mA, "mB": mB}, xp,
                                        training=True)
    prefix_w = (w_a + w_b)[..., off:off + cnt].detach()
    assert torch.equal(prefix_w, torch.zeros_like(prefix_w))
    b = xp.bottleneck
    masks = {"w_a": w_a, "w_b": w_b, "ln_scale": torch.ones((B, L, b)),
             "ln_bias": torch.zeros((B, L, b))}
    toks = torch.arange(B * 5).reshape(B, 5) % tcfg.vocab_size
    h, _, _ = TMDL.forward(tparams, toks, tcfg, profile_masks=masks)
    h.float().square().mean().backward()
    for g in (mA.grad, mB.grad):
        assert g is not None and torch.isfinite(g).all()
        assert g.abs().sum() > 0


# ---------------------------------------------------------------- storage

@pytest.mark.parametrize("scheme", ["int8", "int4"])
@pytest.mark.parametrize("name", ["mixed", "no_prefix"])
def test_quantize_bank_hetero_is_byte_equal(models, name, scheme):
    _, _, params, tparams = models[name]
    want = JQS.quantize_bank_hetero(params["xpeft_bank"], scheme, group=4)
    got = TQS.quantize_bank_hetero(tparams["xpeft_bank"], scheme, group=4)
    assert sorted(got) == sorted(want)
    for key, w in want.items():
        g = bridge.to_numpy(got[key])
        assert g.dtype == np.asarray(w).dtype and g.shape == w.shape, key
        assert g.tobytes() == np.asarray(w).tobytes(), key
