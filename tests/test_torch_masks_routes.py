"""The port's mask functions and on-the-fly mask routes against the JAX
package, on the CPU.

Config: ``reduce_for_smoke(get_config("qwen1.5-0.5b"))`` (2 layers, d=64,
N=8, b=4, k=2, float32) with JAX's weights and profile table carried
across by ``repro_torch.bridge``; JAX's Gumbel draws are injected into the
port as ``noise``. JAX's forward takes these routes in jnp, outside any
Pallas kernel (``models/model.py`` ``_xpeft_apply``).

Tolerances, stated before any run:
- mask weights: the k-hot selection bitwise; the straight-through forward
  values atol 1e-7 (y_hard - y_soft + y_soft rounds at y_soft's last
  bit); their vector-Jacobian product rtol 1e-5, atol 1e-7; soft masks
  rtol 1e-6 (softmax in fp32).
- hidden states and logits for each mask form (none, dense, sparse,
  aggregated): rtol = atol = 1e-5 at float32 (other summation orders).
- admission aggregates (``precompute_effective_adapters*``): rtol = atol
  = 1e-6 (one fp32 contraction over N).
- the forward's gradient in the mask logits: rtol 1e-4, atol 1e-6 x
  max |g|.
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

ARCH = "qwen1.5-0.5b"
TOL = dict(rtol=1e-5, atol=1e-5)
B, T = 3, 6


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def model():
    cfg = reduce_for_smoke(get_config(ARCH)).with_xpeft(max_profiles=4)
    tcfg = treduce(tget_config(ARCH)).with_xpeft(max_profiles=4)
    key = jax.random.key(0)
    params = jax.jit(JMDL.init_lm, static_argnums=1)(key, cfg)
    table = _np(JXP.init_profile_table(jax.random.key(1), cfg))
    # LN affines away from identity so every leaf is exercised
    rng = np.random.default_rng(0)
    table["ln_scale"] = (1 + 0.2 * rng.normal(size=table["ln_scale"].shape)
                         ).astype(np.float32)
    table["ln_bias"] = (0.2 * rng.normal(size=table["ln_bias"].shape)
                        ).astype(np.float32)
    return cfg, tcfg, params, bridge.to_torch(_np(params)), table


def _noise(key, shape):
    ka, kb = jax.random.split(key)
    return tuple(np.array(jax.random.gumbel(k, shape)) for k in (ka, kb))


# ----------------------------------------------------------------------------
# mask functions
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("tau,nu", [(1.0, 1.0), (0.7, 0.5)])
def test_hard_mask_forward_and_straight_through_vjp(tau, nu):
    rng = np.random.default_rng(3)
    logits = (0.5 * rng.normal(size=(3, 2, 8))).astype(np.float32)
    key = jax.random.key(9)
    g = np.array(jax.random.gumbel(key, logits.shape))
    cot = rng.normal(size=logits.shape).astype(np.float32)

    def jfn(x):
        return JM.hard_mask_weights(x, 3, tau=tau, nu=nu, key=key)
    jw, jvjp = jax.vjp(jfn, jnp.asarray(logits))
    tl = torch.from_numpy(logits).requires_grad_(True)
    tw = TM.hard_mask_weights(tl, 3, tau=tau, nu=nu,
                              noise=torch.from_numpy(g))
    np.testing.assert_array_equal(tw.detach().numpy() > 0.2,
                                  np.asarray(jw) > 0.2)
    np.testing.assert_allclose(tw.detach().numpy(), np.asarray(jw),
                               rtol=0, atol=1e-7)
    tw.backward(torch.from_numpy(cot))
    np.testing.assert_allclose(tl.grad.numpy(),
                               np.asarray(jvjp(jnp.asarray(cot))[0]),
                               rtol=1e-5, atol=1e-7)


def test_eval_forms_and_dispatch():
    cfg = reduce_for_smoke(get_config(ARCH))
    rng = np.random.default_rng(4)
    logits = (0.5 * rng.normal(size=(2, 8))).astype(np.float32)
    logits[0, 5] = logits[0, 2]                  # a tie: lower index wins
    np.testing.assert_array_equal(
        TM.khot_from_topk(torch.from_numpy(logits), 3).numpy(),
        np.asarray(JM.khot_from_topk(jnp.asarray(logits), 3)))
    np.testing.assert_allclose(
        TM.soft_mask_weights(torch.from_numpy(logits)).numpy(),
        np.asarray(JM.soft_mask_weights(jnp.asarray(logits))), rtol=1e-6)
    for mtype in ("hard", "soft"):
        xp = cfg.with_xpeft(mask_type=mtype).xpeft
        for training in (False, True):
            want = JM.mask_weights(jnp.asarray(logits), xp,
                                   training=training)
            got = TM.mask_weights(torch.from_numpy(logits), xp,
                                  training=training)
            np.testing.assert_allclose(got.detach().numpy(),
                                       np.asarray(want), rtol=1e-6,
                                       atol=1e-7)
    # a generator's draws: k-hot forward, exactly k selected per row
    gen = torch.Generator().manual_seed(0)
    w = TM.hard_mask_weights(torch.from_numpy(logits), 3, generator=gen)
    assert ((w > 0.2).sum(-1) == 3).all()


def test_profile_mask_weights_match_jax(model):
    cfg, _, _, _, table = model
    prof = {k: v[[0, 2, 1]] for k, v in table.items()}
    key = jax.random.key(7)
    ja, jb = JXP.profile_mask_weights(jax.tree.map(jnp.asarray, prof),
                                      cfg.xpeft, key=key)
    na, nb = _noise(key, prof["mA"].shape)
    ta, tb = TXP.profile_mask_weights(
        bridge.to_torch(prof), cfg.xpeft,
        noise=(torch.from_numpy(na), torch.from_numpy(nb)))
    for got, want in ((ta, ja), (tb, jb)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=1e-7)
    gathered = TXP.gather_profiles(bridge.to_torch(table), [0, 2, 1])
    for k, v in JXP.gather_profiles(jax.tree.map(jnp.asarray, table),
                                    jnp.asarray([0, 2, 1])).items():
        np.testing.assert_array_equal(gathered[k].numpy(), np.asarray(v))


# ----------------------------------------------------------------------------
# routes through the forward
# ----------------------------------------------------------------------------

def _forms(cfg, params, table):
    """Each mask form of JAX's ``profile_masks`` for B profiles."""
    xp = cfg.xpeft
    pids = np.array([0, 3, 1])
    prof = {k: jnp.asarray(v[pids]) for k, v in table.items()}
    ln = {"ln_scale": prof["ln_scale"], "ln_bias": prof["ln_bias"]}
    w_a, w_b = JXP.profile_mask_weights(prof, xp, training=False)
    bits_a = np.asarray(JM.binarize(prof["mA"], xp.k))
    bits_b = np.asarray(JM.binarize(prof["mB"], xp.k))
    ia, ib = JM.mask_indices(bits_a, xp.k), JM.mask_indices(bits_b, xp.k)
    wk = jnp.full(ia.shape, 1.0 / xp.k, jnp.float32)
    soft_a, soft_b = (JM.soft_mask_weights(prof[m]) for m in ("mA", "mB"))
    effs = [JXP.precompute_effective_adapters(
        params["xpeft_bank"], {k: v[i] for k, v in prof.items()}, xp)
        for i in range(len(pids))]
    agg = {k: jnp.stack([e[k] for e in effs]) for k in effs[0]}
    return {"none": None,
            "dense": dict(ln, w_a=w_a, w_b=w_b),
            "dense_soft": dict(ln, w_a=soft_a, w_b=soft_b),
            "sparse": dict(ln, idx_a=ia, w_a=wk, idx_b=ib, w_b=wk),
            "aggregated": agg}


@pytest.mark.parametrize("form", ["none", "dense", "dense_soft", "sparse",
                                  "aggregated"])
def test_hidden_states_match_jax_for_each_mask_form(model, form):
    cfg, tcfg, params, tparams, table = model
    masks = _forms(cfg, params, table)[form]
    toks = np.random.default_rng(5).integers(0, cfg.vocab_size,
                                             size=(B, T)).astype(np.int32)
    jh, _, _ = JMDL.forward(params, jnp.asarray(toks), cfg,
                            profile_masks=masks)
    tmasks = None if masks is None else bridge.to_torch(_np(masks))
    th, _, _ = TMDL.forward(tparams, torch.from_numpy(toks), tcfg,
                            profile_masks=tmasks)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), **TOL)
    np.testing.assert_allclose(
        TMDL.lm_logits(tparams, th, tcfg).numpy(),
        np.asarray(JMDL.lm_logits(params, jh, cfg)), **TOL)


def test_dense_and_sparse_hard_routes_agree_in_the_port(model):
    cfg, tcfg, params, tparams, table = model
    forms = _forms(cfg, params, table)
    toks = torch.from_numpy(np.random.default_rng(6).integers(
        0, cfg.vocab_size, size=(B, T)))
    out = {f: TMDL.forward(tparams, toks, tcfg, profile_masks=bridge.to_torch(
        _np(forms[f])))[0] for f in ("dense", "sparse", "aggregated")}
    for f in ("sparse", "aggregated"):
        np.testing.assert_allclose(out[f].numpy(), out["dense"].numpy(),
                                   **TOL)


def test_forward_grad_in_mask_logits_matches_jax(model):
    """The uncached forward is differentiable in ``profile_masks``: the
    gradient of a loss on the hidden states reaches the mask logits
    through the straight-through weights, as ``jax.grad`` finds it."""
    cfg, tcfg, params, tparams, table = model
    toks = np.random.default_rng(8).integers(0, cfg.vocab_size,
                                             size=(B, T)).astype(np.int32)
    prof = {k: v[[2, 0, 3]] for k, v in table.items()}
    key = jax.random.key(3)
    cot = np.random.default_rng(9).normal(
        size=(B, T, cfg.d_model)).astype(np.float32)

    def jloss(p):
        w_a, w_b = JXP.profile_mask_weights(p, cfg.xpeft, key=key)
        h, _, _ = JMDL.forward(params, jnp.asarray(toks), cfg,
                               profile_masks=dict(w_a=w_a, w_b=w_b,
                                                  ln_scale=p["ln_scale"],
                                                  ln_bias=p["ln_bias"]))
        return jnp.sum(h * cot)
    jg = jax.jit(jax.grad(jloss))(jax.tree.map(jnp.asarray, prof))
    tp = {k: torch.tensor(v, requires_grad=True) for k, v in prof.items()}
    na, nb = _noise(key, prof["mA"].shape)
    w_a, w_b = TXP.profile_mask_weights(
        tp, tcfg.xpeft, noise=(torch.from_numpy(na), torch.from_numpy(nb)))
    th, _, _ = TMDL.forward(tparams, torch.from_numpy(toks), tcfg,
                            profile_masks=dict(w_a=w_a, w_b=w_b,
                                               ln_scale=tp["ln_scale"],
                                               ln_bias=tp["ln_bias"]))
    torch.sum(th * torch.from_numpy(cot)).backward()
    for k in prof:
        want = np.asarray(jg[k])
        assert np.abs(want).max() > 0, k
        np.testing.assert_allclose(tp[k].grad.numpy(), want, rtol=1e-4,
                                   atol=1e-6 * np.abs(want).max(),
                                   err_msg=k)
    # frozen weights stay out of autograd
    assert not any(v.requires_grad for v in tparams["blocks"]["mlp"].values())


# ----------------------------------------------------------------------------
# admission aggregates
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("mask_type", ["hard", "soft"])
def test_precompute_effective_adapters_match_jax(model, mask_type):
    cfg, tcfg, params, tparams, table = model
    xp = cfg.with_xpeft(mask_type=mask_type).xpeft
    bank = params["xpeft_bank"]
    tbank = tparams["xpeft_bank"]
    for pid in range(2):
        row = {k: v[pid] for k, v in table.items()}
        want = JXP.precompute_effective_adapters(
            bank, jax.tree.map(jnp.asarray, row), xp)
        got = TXP.precompute_effective_adapters(tbank, bridge.to_torch(row),
                                                xp)
        for k in want:
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                       rtol=1e-6, atol=1e-6, err_msg=k)
    w_a, w_b = (JM.soft_mask_weights(jnp.asarray(table[m]))
                for m in ("mA", "mB"))
    ja, jb = JXP.precompute_effective_adapters_dense_batched(bank, w_a, w_b)
    ta, tb = TXP.precompute_effective_adapters_dense_batched(
        tbank, torch.from_numpy(np.asarray(w_a)),
        torch.from_numpy(np.asarray(w_b)))
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(tb.numpy(), np.asarray(jb), rtol=1e-6,
                               atol=1e-6)


# ----------------------------------------------------------------------------
# no silent loss of a gradient through a hand-written kernel
# ----------------------------------------------------------------------------

def _op_calls(dev):
    """Each entry of ``kernels/ops.py`` with small operands on ``dev``, the
    float ones requiring grad."""
    from repro_torch.kernels import ops

    def t(*shape, dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype, device=dev,
                           requires_grad=dtype.is_floating_point)
    i = torch.zeros((2, 2), dtype=torch.int32, device=dev)
    x, a, b, s = t(2, 3, 16), t(2, 16, 4), t(2, 4, 16), t(2, 4)
    blk = {"attn": {"wq": t(16, 1, 16)}}
    return {
        "mask_aggregate": lambda: ops.mask_aggregate(t(4, 16, 4), i[0],
                                                     t(2)),
        "mask_aggregate_batched": lambda: ops.mask_aggregate_batched(
            t(4, 16, 4), i, t(2, 2)),
        "fused_adapter": lambda: ops.fused_adapter(x, a, b, s, s),
        "lora_adapter": lambda: ops.lora_adapter(x, a, b),
        "ia3_apply": lambda: ops.ia3_apply(x, t(2, 16)),
        "hetero_adapter": lambda: ops.hetero_adapter(
            x, {"a_hat": a, "b_hat": b, "ln_scale": s, "ln_bias": s,
                "ia3_s": t(2, 16)}),
        "decode_block_fused": lambda: ops.decode_block_fused(
            t(2, 1, 16), i[:, 0], blk, t(2, 8, 1, 16), t(2, 8, 1, 16),
            None, norm="rmsnorm", qkv_bias=False, use_rope=True,
            theta=1e4, cap=0.0, mlp_type="glu", act_name="silu",
            adapter="none", adapter_act="gelu"),
        "mask_aggregate_quant_batched": lambda:
            ops.mask_aggregate_quant_batched(
                t(4, 16, 4, dtype=torch.int8), t(4, 16), i, t(2, 2),
                scheme="int8"),
        "fused_adapter_quant": lambda: ops.fused_adapter_quant(
            x, t(2, 16, 4, dtype=torch.int8), t(2, 16),
            t(2, 4, 16, dtype=torch.int8), t(2, 4), s, s, scheme="int8"),
    }


@pytest.mark.parametrize("name", sorted(_op_calls("meta")))
def test_kernel_wrappers_refuse_inputs_that_require_grad(name):
    """On a device tensor (``meta`` here, standing for the card) an input
    that requires grad never reaches a hand-written kernel, which has no
    backward."""
    with pytest.raises(RuntimeError, match="requires grad"):
        _op_calls("meta")[name]()


def test_plain_versions_keep_their_gradient_on_the_cpu():
    from repro_torch.kernels import ops
    rng = np.random.default_rng(1)
    x, a, b = (torch.tensor(rng.normal(size=s).astype(np.float32),
                            requires_grad=True)
               for s in ((2, 3, 16), (2, 16, 4), (2, 4, 16)))
    ones, zeros = torch.ones(2, 4), torch.zeros(2, 4)
    ops.fused_adapter(x, a, b, ones, zeros).sum().backward()
    assert all(t.grad is not None and t.grad.abs().max() > 0
               for t in (x, a, b))
