"""The port's recurrent block families (``models/rwkv.py``,
``models/mamba.py`` and zamba's groups with a shared attention block in
``models/model.py``) against the JAX package on the CPU.

Configs: ``reduce_for_smoke`` of ``rwkv6-7b`` (2 layers, d=64, 4 heads of
16, la_chunk 8) and ``zamba2-1.2b`` (4 layers, d=64, shared_attn_every 2,
ssm_state 8, head dim 8), float32, bank N=8, b=4, k=2; JAX's weights and
profile logits carried across by ``repro_torch.bridge``. Zamba runs at 5
layers: two groups, each followed by the shared block, and a remainder
layer that is not (JAX's 38 = 6 x 6 + 2); its cache holds two K/V
slices.

Forward: hidden states and logits for no adapter, admission-time
aggregated entries (``a_hat``, hard masks) and on-the-fly mask weights
(dense ``w_a``), uncached; with no adapter and ``a_hat``, a prefill of
11 tokens then a T=1 decode step through a cache (the new state in every
cache leaf against JAX's) equal to the full forward (JAX's
``test_decode_matches_full_forward``), all at rtol 1e-5 and atol 1e-4
(each recurrent layer feeds its float32 rounding into the next one's
state, and RWKV's head-wise norm of a small first-token output multiplies
it; ``TOL``'s comment has the reading). One
xpeft train step: the k-hot selection bitwise, the loss within rtol
1e-5 and every trainable gradient against ``jax.grad`` (``GRAD_ATOL_REL``
has the bound), JAX's Gumbel draws injected. In bf16, each block on the
same input within two bf16 steps of JAX's and the whole forward's logits
no further from JAX's bf16 run, or from JAX's float32 run, than twice
JAX's bf16 run lies from float32 (``BF16_STEPS`` has the reading). The
launchers run both archs.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs import get_config, reduce_for_smoke
from repro.core import xpeft as JXP
from repro.data import MarkovLM as JMarkov
from repro.models import model as JMDL
from repro.train import steps as JST
from repro_torch import bridge
from repro_torch.configs import get_config as tget_config
from repro_torch.configs import reduce_for_smoke as treduce
from repro_torch.core import xpeft as TXP
from repro_torch.models import model as TMDL
from repro_torch.train import steps as TST

# the forwards' hidden states, logits and cache leaves: each recurrent
# layer feeds its float32 rounding (other summation orders) into the next
# one's state and the residual stream, and RWKV's head-wise norm at the
# first token (zero state, a small wkv output) multiplies it ~20-50x: one
# element lies 7.4e-5 from a float64 JAX run there while JAX's float32 lies
# 5e-6 from it, the rest within 4e-6
TOL = dict(rtol=1e-5, atol=1e-4)
ARCHS = ["rwkv6-7b", "zamba2-1.2b"]


def _np(tree):
    return jax.tree.map(np.asarray, tree)


# JAX's forward compiled once per shape (its eager scans compile op by op)
_jforward = jax.jit(JMDL.forward, static_argnums=2)


def _setup(arch, layers=None):
    cfg = reduce_for_smoke(get_config(arch))
    tcfg = treduce(tget_config(arch))
    if layers:
        cfg, tcfg = (c.with_(num_layers=layers) for c in (cfg, tcfg))
    key = jax.random.key(0)
    params = jax.jit(JMDL.init_lm, static_argnums=1)(key, cfg)
    table = _np(JXP.init_profile_table(key, cfg))
    return dict(cfg=cfg, tcfg=tcfg, params=params, table=table,
                tparams=bridge.to_torch(_np(params)))


@pytest.fixture(scope="module", params=ARCHS)
def setup(request):
    # zamba at 5 layers: two groups of 2, each followed by the shared
    # block, and a remainder layer that is not
    return _setup(request.param,
                  layers=5 if request.param == "zamba2-1.2b" else None)


def _shapes(tree, pre=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_shapes(v, f"{pre}{k}/"))
        else:
            out[pre + k] = (tuple(v.shape), str(v.dtype).split(".")[-1])
    return out


def test_init_tree_and_bridge_match_jax(setup):
    """The port's own init has JAX's tree, shapes and dtypes (zamba's
    unstacked ``shared_attn`` included); the bridge carries every leaf,
    the fp32 recurrent ones (mu, w0, dec_a, u, A_log, conv_w, ...) too,
    and back byte-equal."""
    s = setup
    own = TMDL.init_lm(s["tcfg"], seed=0, device="cpu")
    assert _shapes(own) == _shapes(s["tparams"]) == \
        {k: (tuple(v[0]), v[1]) for k, v in _shapes(_np(s["params"])).items()}
    assert ("shared_attn" in own) == (s["cfg"].block_pattern == "zamba")
    if "shared_attn" in own:
        assert own["shared_attn"]["attn"]["wq"].ndim == 3  # not stacked
    back = bridge.to_numpy(s["tparams"])
    for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(
            _np(s["params"])), jax.tree_util.tree_leaves(back)):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), path
    jc = JMDL.init_cache(s["cfg"], 3, 16)
    tc = TMDL.init_cache(s["tcfg"], 3, 16, device="cpu")
    if "attn_k" in tc:
        assert tc["attn_k"].shape[0] == 2    # 5 // shared_attn_every
    assert {k: (tuple(v.shape), str(v.dtype)) for k, v in jc.items()} == \
        {k: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
         for k, v in tc.items()}


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
    effs = [JXP.precompute_effective_adapters(
        params["xpeft_bank"], {k: v[i] for k, v in prof.items()}, xp)
        for i in range(3)]
    return {"none": None,
            "a_hat": {k: jnp.stack([e[k] for e in effs]) for k in effs[0]},
            "dense": dict(ln, w_a=w_a, w_b=w_b)}


def _check(th, jh, s):
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), **TOL)
    np.testing.assert_allclose(
        TMDL.lm_logits(s["tparams"], th, s["tcfg"]).numpy(),
        np.asarray(JMDL.lm_logits(s["params"], jh, s["cfg"])), **TOL)


@pytest.mark.parametrize("form", ["none", "a_hat", "dense"])
def test_forward_matches_jax(setup, form):
    s = setup
    masks = _forms(s)[form]
    tmasks = None if masks is None else bridge.to_torch(_np(masks))
    toks = np.random.default_rng(5).integers(
        0, s["cfg"].vocab_size, (3, 12)).astype(np.int32)
    jh, _, jaux = _jforward(s["params"], jnp.asarray(toks), s["cfg"],
                               profile_masks=masks)
    th, _, taux = TMDL.forward(s["tparams"], torch.from_numpy(toks),
                               s["tcfg"], profile_masks=tmasks)
    _check(th, jh, s)
    assert float(taux) == float(jaux) == 0.0


# bf16: the two packages round the blocks' bf16 ops in other places (XLA
# fuses elementwise chains; JAX's own jitted and eager runs of one block
# part by one bf16 step of its largest output), so one block on the same
# input is held within BF16_STEPS steps of its largest output (the port
# read 1 step on both archs). Through the whole model each package's
# rounding grows with depth (its chip witness, ``fp32_witness``): the
# port's logits are held within twice W, JAX's bf16 run's own max |d
# logit| from its float32 run, of JAX's bf16 run and of that float32 run
# (read: rwkv 0.159 and 0.230 against W = 0.209; zamba 0.164 and 0.152
# against W = 0.139)
BF16_STEPS = 2


def _bf16_step(a):
    return 2.0 ** (np.floor(np.log2(np.abs(a).max())) - 7)


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_forward_matches_jax_to_its_own_noise(arch):
    from repro.models import mamba as JMB
    from repro.models import rwkv as JRK
    from repro_torch.models import mamba as TMB
    from repro_torch.models import rwkv as TRK
    cfg32 = reduce_for_smoke(get_config(arch))
    tcfg = treduce(tget_config(arch))
    if arch == "zamba2-1.2b":
        cfg32, tcfg = (c.with_(num_layers=5) for c in (cfg32, tcfg))
    cfg, tcfg = cfg32.with_(dtype="bfloat16"), tcfg.with_(dtype="bfloat16")
    params = jax.jit(JMDL.init_lm, static_argnums=1)(jax.random.key(0), cfg)
    tparams = bridge.to_torch(_np(params))
    # one block, layer 0, on the same bf16 input
    blk = jax.tree.map(lambda a: a[0], params["blocks"])
    tblk = jax.tree.map(lambda a: a[0], tparams["blocks"])
    x = np.random.default_rng(3).normal(size=(3, 12, cfg.d_model))
    jx = jnp.asarray(x, jnp.bfloat16)
    tx = torch.from_numpy(x.astype(np.float32)).to(torch.bfloat16)
    if cfg.block_pattern == "rwkv":
        jo = jax.jit(lambda p, x: JRK.rwkv_block(
            p["rwkv"], x, cfg, {"n1": p["n1"], "n2": p["n2"]})[0])(blk, jx)
        to = TRK.rwkv_block(tblk["rwkv"], tx, tcfg,
                            {"n1": tblk["n1"], "n2": tblk["n2"]})[0]
    else:
        jo = jax.jit(lambda p, x: JMB.mamba_block(
            p["mamba"], x, cfg, {"n1": p["n1"]})[0])(blk, jx)
        to = TMB.mamba_block(tblk["mamba"], tx, tcfg, {"n1": tblk["n1"]})[0]
    jo = np.asarray(jo, np.float32)
    assert to.dtype == torch.bfloat16
    assert np.abs(to.float().numpy() - jo).max() <= \
        BF16_STEPS * _bf16_step(jo)
    # the whole forward's logits, and JAX's own distance from float32
    toks = np.random.default_rng(5).integers(
        0, cfg.vocab_size, (3, 12)).astype(np.int32)
    p32 = jax.tree.map(lambda a: a.astype(jnp.float32)
                       if a.dtype == jnp.bfloat16 else a, params)
    logits = {}
    for name, c, p in (("bf16", cfg, params), ("f32", cfg32, p32)):
        h, _, _ = _jforward(p, jnp.asarray(toks), c)
        logits[name] = np.asarray(JMDL.lm_logits(p, h, c), np.float32)
    th, _, _ = TMDL.forward(tparams, torch.from_numpy(toks), tcfg)
    assert th.dtype == torch.bfloat16
    tl = TMDL.lm_logits(tparams, th, tcfg).float().numpy()
    w = np.abs(logits["bf16"] - logits["f32"]).max()
    assert w > 0
    print(f"{arch} bf16 logits: port vs JAX bf16 "
          f"{np.abs(tl - logits['bf16']).max():.4f}, vs JAX float32 "
          f"{np.abs(tl - logits['f32']).max():.4f}; W {w:.4f}")
    assert np.abs(tl - logits["bf16"]).max() <= 2 * w
    assert np.abs(tl - logits["f32"]).max() <= 2 * w


def _prefill_decode(s, masks, tmasks, toks):
    """Prefill toks[:, :-1] into a cache, then one T=1 step at per-slot
    positions, in both packages: the step's hidden states, and every
    cache leaf after each call, against JAX's."""
    cfg, tcfg = s["cfg"], s["tcfg"]
    B, T = toks.shape
    jc = JMDL.init_cache(cfg, B, 32)
    tc = TMDL.init_cache(tcfg, B, 32, device="cpu")
    jh, jc, _ = _jforward(s["params"], jnp.asarray(toks[:, :-1]), cfg,
                             profile_masks=masks, cache=jc, cache_pos=0)
    th, tc, _ = TMDL.forward(s["tparams"], torch.from_numpy(toks[:, :-1]),
                             tcfg, profile_masks=tmasks, cache=tc,
                             cache_pos=0)
    _check(th, jh, s)
    pos = np.full((B,), T - 1, np.int32)
    jh, jc, _ = _jforward(s["params"], jnp.asarray(toks[:, -1:]), cfg,
                             profile_masks=masks, cache=jc,
                             cache_pos=jnp.asarray(pos))
    th, tc, _ = TMDL.forward(s["tparams"], torch.from_numpy(toks[:, -1:]),
                             tcfg, profile_masks=tmasks, cache=tc,
                             cache_pos=torch.from_numpy(pos))
    _check(th, jh, s)
    assert set(tc) == set(jc)
    for key in jc:
        np.testing.assert_allclose(tc[key].numpy(), np.asarray(jc[key]),
                                   **TOL, err_msg=key)
    return th


@pytest.mark.parametrize("form", ["none", "a_hat"])
def test_prefill_then_decode_equals_full_forward(setup, form):
    """JAX's ``test_decode_matches_full_forward`` twin, held to JAX's
    step by step: the decode step's logits equal the full forward's last
    row, and the written state equals JAX's in every leaf."""
    s = setup
    masks = _forms(s)[form]
    tmasks = None if masks is None else bridge.to_torch(_np(masks))
    toks = np.random.default_rng(6).integers(
        0, s["cfg"].vocab_size, (3, 12)).astype(np.int32)
    th = _prefill_decode(s, masks, tmasks, toks)
    full, _, _ = TMDL.forward(s["tparams"], torch.from_numpy(toks),
                              s["tcfg"], profile_masks=tmasks)
    np.testing.assert_allclose(
        TMDL.lm_logits(s["tparams"], th, s["tcfg"]).numpy(),
        TMDL.lm_logits(s["tparams"], full[:, -1:], s["tcfg"]).numpy(),
        **TOL)


# the train step's gradients: test_torch_train's bound (rtol 1e-4, atol
# 1e-6 x the leaf's max |g|) for zamba. RWKV's head-wise norm amplifies
# float32 rounding at a few elements (``TOL``'s comment), so each
# package's float32 gradient lies up to 2.2e-5 x max |g| from JAX's float64
# gradient on this step (the port's mA; JAX's 8.5e-6), and its forward up
# to 2.5e-5 from float64 over 8 token draws, either package the further
# in turn: rwkv's atol is twice that, 5e-5 x max |g|
GRAD_ATOL_REL = {"rwkv6-7b": 5e-5, "zamba2-1.2b": 1e-6}


@pytest.mark.parametrize("arch", ARCHS)
def test_one_train_step_matches_jax(arch):
    """One xpeft step over 4 x 16 tokens: the k-hot selection bitwise,
    the loss within rtol 1e-5 of JAX's, and every trainable leaf's
    gradient (autograd through the chunked GLA's Python loop, the decay
    LoRA, the head-wise norm, the conv taps and the softplus) against
    ``jax.grad`` within rtol 1e-4 and ``GRAD_ATOL_REL`` x that leaf's max
    |g|, non-zero."""
    P = 4
    cfg = reduce_for_smoke(get_config(arch)).with_xpeft(max_profiles=P)
    tcfg = treduce(tget_config(arch)).with_xpeft(max_profiles=P)
    jstate = jax.jit(JST.init_train_state, static_argnums=(1, 2))(
        jax.random.key(0), cfg, "xpeft")
    tstate = bridge.to_torch(_np(jstate))
    batch = JMarkov(cfg.vocab_size, P, seed=0).sample(0, 4, 16)
    key = jax.random.key(11)
    ka, kb = jax.random.split(key)
    shape = (4, cfg.num_layers, cfg.xpeft.num_adapters)
    noise = tuple(torch.tensor(np.asarray(jax.random.gumbel(k, shape)))
                  for k in (ka, kb))

    (jtotal, jm), jg = jax.jit(jax.value_and_grad(
        lambda tr: JST.loss_for_batch(
            jstate["frozen"], tr, jax.tree.map(jnp.asarray, batch), cfg,
            "xpeft", key), has_aux=True))(jstate["trainable"])
    leaves = jax.tree.map(lambda p: p.detach().requires_grad_(True),
                          tstate["trainable"])
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    ttotal, tm = TST.loss_for_batch(tstate["frozen"], leaves, tb, tcfg,
                                    "xpeft", noise)
    ttotal.backward()
    np.testing.assert_allclose(float(tm["loss"].detach()), float(jm["loss"]),
                               rtol=1e-5)
    # the k-hot selection the step trained through, both packages
    xp = cfg.xpeft
    jprof = JXP.gather_profiles(jstate["trainable"]["table"],
                                jnp.asarray(batch["profile_ids"]))
    jw = JXP.profile_mask_weights(jprof, xp, key=key)
    tprof = TXP.gather_profiles(tstate["trainable"]["table"],
                                tb["profile_ids"])
    tw = TXP.profile_mask_weights(tprof, tcfg.xpeft, noise=noise)
    for a, b in zip(tw, jw):
        assert np.array_equal(a.detach().numpy() > 0.5 / xp.k,
                              np.asarray(b) > 0.5 / xp.k)
    for path, want in jax.tree_util.tree_leaves_with_path(jg):
        leaf = leaves
        for p in path:
            leaf = leaf[p.key]
        want = np.asarray(want)
        got = leaf.grad.numpy() if leaf.grad is not None \
            else np.zeros_like(want)
        assert np.abs(want).max() > 0, path
        np.testing.assert_allclose(
            got, want, rtol=1e-4,
            atol=GRAD_ATOL_REL[arch] * np.abs(want).max(),
            err_msg=jax.tree_util.keystr(path))


def test_check_supported_and_launchers(capsys):
    """Both configs pass ``check_supported`` at full size (an unknown
    pattern still raises); ``--arch ... --smoke`` runs both launchers on
    the CPU with finite losses and in-range tokens, the per-step mask
    path (``--no-precompute``) serving the same tokens."""
    from repro_torch.launch import serve as LS
    from repro_torch.launch import train as LT
    for arch in ARCHS:
        TMDL.check_supported(tget_config(arch))
    with pytest.raises(NotImplementedError, match="unknown block_pattern"):
        TMDL.check_supported(tget_config("rwkv6-7b").with_(
            block_pattern="s4"))
    for arch in ARCHS:
        out = LT.run(LT.parse_args(["--arch", arch, "--smoke", "--device",
                                    "cpu", "--steps", "2", "--batch", "2",
                                    "--seq", "8"]))
        assert out["cfg"].name == arch and len(out["history"]) == 2
        assert all(np.isfinite(float(m["loss"])) for m in out["history"])
        toks = []
        for extra in ([], ["--no-precompute"]):
            LS.main(["--arch", arch, "--smoke", "--device", "cpu",
                     "--requests", "3", "--max-new", "4"] + extra)
            lines = [ln for ln in capsys.readouterr().out.splitlines()
                     if ln.lstrip().startswith("req ")]
            assert len(lines) == 3
            toks.append(lines)
        assert toks[0] == toks[1]
