"""The port's attention forms against the JAX package, on the CPU: gemma's
embedding scale, gemma3's sliding-window/global mix and the frontends'
``prefix_embeds``, through the forward, the cached serving steps and one
train step; the decode megakernel's plain version with a GELU gate; and
its planner at every full-attention, non-MoE config's full width.

Configs: ``reduce_for_smoke`` of gemma-2b (MQA, GLU-GELU, embed_scale),
gemma3-27b (sliding_mix, window 8, a global layer every 2), llava-next-34b
and musicgen-medium (4 prefix rows), 2 layers, d=64, float32; JAX's
weights and profile logits carried across by ``repro_torch.bridge``.
Inputs are made from numpy seeds.

Tolerances, stated before any run: float32 at rtol = atol = 1e-5 (the
frameworks sum in other orders); the bf16 embedding rows bitwise (one
product of two bf16 values, rounded once); the window's reach bitwise
(a masked key adds an exact 0); the plain decode block in bf16 at two
bf16 steps, as ``test_torch_decode_fused.py`` holds it; a train step's
loss rtol 1e-5 and gradients rtol 1e-4 with atol 1e-6 x each leaf's max,
as ``test_torch_train.py`` holds them.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs import get_config, reduce_for_smoke
from repro.core import xpeft as JXP
from repro.models import attention as JATT
from repro.models import model as JMDL
from repro.serve import steps as JSS
from repro.train import steps as JST
from repro_torch import bridge
from repro_torch.configs import get_config as tget_config
from repro_torch.configs import reduce_for_smoke as treduce
from repro_torch.kernels import decode_fused as KD
from repro_torch.models import attention as TATT
from repro_torch.models import model as TMDL
from repro_torch.serve import steps as TSS
from repro_torch.train import steps as TST

from test_torch_decode_fused import BF16_TOL, _block_inputs, _f32, \
    _run_jax, _run_port
from test_torch_train import _close_tree, _jax_grads, _noise

TOL = dict(rtol=1e-5, atol=1e-5)
ARCHS = ["gemma-2b", "gemma3-27b", "llava-next-34b", "musicgen-medium"]
B, T = 2, 12


def _np(tree):
    return jax.tree.map(np.asarray, tree)


_SETUPS = {}


def _setup(arch, **cfg_kw):
    """JAX's reduced config, its weights and profile table, the port's
    config and the weights carried across; memoized per arch and kw."""
    key = (arch, repr(sorted(cfg_kw.items())))
    if key not in _SETUPS:
        cfg = reduce_for_smoke(get_config(arch)).with_(**cfg_kw)
        tcfg = treduce(tget_config(arch)).with_(**cfg_kw)
        params = jax.jit(JMDL.init_lm, static_argnums=1)(jax.random.key(0),
                                                         cfg)
        table = JXP.init_profile_table(jax.random.key(1), cfg)
        _SETUPS[key] = dict(cfg=cfg, tcfg=tcfg, params=params, table=table,
                            tparams=bridge.to_torch(_np(params)))
    return _SETUPS[key]


def _inputs(s, seed, T=T):
    """tokens [B, T], prefix rows [B, P, d] (None without a frontend) and
    dense mask weights of profiles [0, 1] with LN affines off identity."""
    cfg = s["cfg"]
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, T)).astype(np.int32)
    P = cfg.num_prefix_tokens
    prefix = rng.normal(size=(B, P, cfg.d_model)).astype(np.float32) \
        if P else None
    prof = {k: jnp.asarray(np.asarray(v)[[0, 1]])
            for k, v in s["table"].items()}
    prof["ln_scale"] = jnp.asarray(1 + 0.2 * rng.normal(
        size=prof["ln_scale"].shape), jnp.float32)
    prof["ln_bias"] = jnp.asarray(0.2 * rng.normal(
        size=prof["ln_bias"].shape), jnp.float32)
    w_a, w_b = JXP.profile_mask_weights(prof, cfg.xpeft, training=False)
    masks = {"w_a": w_a, "w_b": w_b, "ln_scale": prof["ln_scale"],
             "ln_bias": prof["ln_bias"]}
    return toks, prefix, masks


def _t(a):
    return None if a is None else torch.from_numpy(np.array(a))


def _close(t, j, what=""):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j),
                               err_msg=what, **TOL)


def test_check_supported_accepts_the_attention_forms():
    for arch in ARCHS:
        TMDL.check_supported(tget_config(arch))
    # the recurrent families are accepted too (test_torch_recurrent*.py)
    for arch in ("rwkv6-7b", "zamba2-1.2b"):
        TMDL.check_supported(tget_config(arch))
    for arch in ARCHS + ["qwen1.5-0.5b"]:
        cfg = tget_config(arch)
        assert TMDL.layer_meta(cfg) == \
            JMDL.layer_meta(get_config(arch)).tolist()
    assert TMDL.layer_meta(tget_config("gemma3-27b"))[:12] == \
        [False] * 5 + [True] + [False] * 5 + [True]


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_jax(arch, masked):
    """Uncached: hidden states [B, P+T, d] and logits."""
    s = _setup(arch)
    toks, prefix, masks = _inputs(s, 0)
    masks = masks if masked else None
    jh, _, _ = JMDL.forward(s["params"], jnp.asarray(toks), s["cfg"],
                            prefix_embeds=prefix, profile_masks=masks)
    th, _, _ = TMDL.forward(s["tparams"], _t(toks), s["tcfg"],
                            prefix_embeds=_t(prefix),
                            profile_masks=bridge.to_torch(_np(masks)))
    assert th.shape == (B, T + s["cfg"].num_prefix_tokens, s["cfg"].d_model)
    _close(th, jh, "hidden")
    _close(TMDL.lm_logits(s["tparams"], th, s["tcfg"]),
           JMDL.lm_logits(s["params"], jh, s["cfg"]), "logits")


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_then_decode_matches_jax(arch, masked):
    """``make_prefill_step`` of T-1 tokens (behind the prefix rows) into a
    cache, then ``make_decode_step`` at cache_pos T-1+P and at per-slot
    positions: logits and the cache against JAX's after each call, as
    JAX's ``test_decode_matches_full_forward`` drives them. For gemma3
    the sequence crosses the window (8) in local layers."""
    s = _setup(arch)
    cfg, tcfg = s["cfg"], s["tcfg"]
    toks, prefix, masks = _inputs(s, 1)
    masks = masks if masked else None
    tmasks = bridge.to_torch(_np(masks))
    P = cfg.num_prefix_tokens
    jc, tc = JMDL.init_cache(cfg, B, 32), TMDL.init_cache(tcfg, B, 32,
                                                          device="cpu")
    jl, jc = JSS.make_prefill_step(cfg)(s["params"], jnp.asarray(
        toks[:, :-1]), jc, profile_masks=masks, prefix_embeds=prefix)
    tl, tc = TSS.make_prefill_step(tcfg)(s["tparams"], _t(toks[:, :-1]), tc,
                                         profile_masks=tmasks,
                                         prefix_embeds=_t(prefix))
    _close(tl, jl, "prefill logits")
    jdec, tdec = JSS.make_decode_step(cfg), TSS.make_decode_step(tcfg)
    last = toks[:, -1:]
    pos = T - 1 + P
    for step in range(3):
        cp = pos if step == 0 else np.array([pos, pos - 1], np.int32)
        jl, jc = jdec(s["params"], jnp.asarray(last), jc, jnp.asarray(cp),
                      profile_masks=masks)
        tl, tc = tdec(s["tparams"], _t(last), tc,
                      cp if step == 0 else _t(cp), profile_masks=tmasks)
        _close(tl, jl, f"decode {step} logits")
        for k in ("k", "v"):
            _close(tc[k], jc[k], f"decode {step} cache {k}")
        last = np.asarray(jl)[:, -1].argmax(-1).astype(np.int32)[:, None]
        pos += 1


def test_decode_equals_full_forward():
    """Within the port: prefill + decode at T-1+P gives the full
    uncached forward's last logits (JAX's own contract, at 1e-5)."""
    for arch in ("gemma3-27b", "musicgen-medium"):
        s = _setup(arch)
        toks, prefix, masks = _inputs(s, 2)
        tmasks = bridge.to_torch(_np(masks))
        tcfg, P = s["tcfg"], s["cfg"].num_prefix_tokens
        h, _, _ = TMDL.forward(s["tparams"], _t(toks), tcfg,
                               prefix_embeds=_t(prefix),
                               profile_masks=tmasks)
        full = TMDL.lm_logits(s["tparams"], h[:, -1:], tcfg)
        tc = TMDL.init_cache(tcfg, B, 32, device="cpu")
        _, tc = TSS.make_prefill_step(tcfg)(s["tparams"], _t(toks[:, :-1]),
                                            tc, profile_masks=tmasks,
                                            prefix_embeds=_t(prefix))
        dec, _ = TSS.make_decode_step(tcfg)(s["tparams"], _t(toks[:, -1:]),
                                            tc, T - 1 + P,
                                            profile_masks=tmasks)
        np.testing.assert_allclose(dec.numpy(), full.numpy(), **TOL)


# ----------------------------------------------------------------------------
# the sliding window
# ----------------------------------------------------------------------------

WINDOW_KW = dict(sliding_window=4, global_every=2)


@pytest.mark.parametrize("is_global", [False, True])
@pytest.mark.parametrize("chunked", [False, True])
def test_window_attention_matches_jax(chunked, is_global):
    """gemma3 at window 4 on a 16-token sequence, one layer's attention,
    on the dense path and the chunked online softmax (q_chunk 4, k_chunk
    8), local and global, uncached and through a cache of 16."""
    s = _setup("gemma3-27b", **WINDOW_KW)
    cfg, tcfg = s["cfg"], s["tcfg"]
    rng = np.random.default_rng(3)
    x = rng.normal(size=(B, 16, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(16, dtype=np.int32), (B, 16))
    lp = jax.tree.map(lambda a: a[0], s["params"]["blocks"]["attn"])
    tlp = {k: v[0] for k, v in s["tparams"]["blocks"]["attn"].items()}
    ck = dict(q_chunk=4, k_chunk=8) if chunked else {}
    for cached in (False, True):
        kw = {}
        tkw = {}
        if cached:
            shape = (B, 16, cfg.num_kv_heads, cfg.head_dim)
            kw = dict(cache={"k": jnp.zeros(shape), "v": jnp.zeros(shape)},
                      cache_pos=0)
            tkw = dict(cache={"k": torch.zeros(shape),
                              "v": torch.zeros(shape)}, cache_pos=0)
        jy, _ = JATT.attention(lp, jnp.asarray(x), positions=jnp.asarray(pos),
                               cfg=cfg, is_global=is_global, **ck, **kw)
        ty, _ = TATT.attention(tlp, _t(x), positions=_t(pos), cfg=tcfg,
                               is_global=is_global, **ck, **tkw)
        _close(ty, jy, f"cached={cached}")
        if chunked:
            dense, _ = TATT.attention(tlp, _t(x), positions=_t(pos),
                                      cfg=tcfg, is_global=is_global)
            _close(ty, dense.numpy(), "chunked vs dense")


def test_window_forward_matches_jax_and_masks():
    """The whole forward at window 4 on 16 tokens, against JAX's; the
    window makes local layers differ from full attention."""
    s = _setup("gemma3-27b", **WINDOW_KW)
    toks, _, masks = _inputs(s, 4, T=16)
    jh, _, _ = JMDL.forward(s["params"], jnp.asarray(toks), s["cfg"],
                            profile_masks=masks)
    th, _, _ = TMDL.forward(s["tparams"], _t(toks), s["tcfg"],
                            profile_masks=bridge.to_torch(_np(masks)))
    _close(th, jh)
    full, _, _ = TMDL.forward(s["tparams"], _t(toks),
                              s["tcfg"].with_(attn_type="full"),
                              profile_masks=bridge.to_torch(_np(masks)))
    assert not torch.allclose(full[:, -1], th[:, -1])


def test_window_reach_is_bitwise():
    """All-local layers (global_every past the depth): a token further
    back than layers x (window - 1) positions leaves the last position
    bitwise unchanged; one within reach moves it."""
    s = _setup("gemma3-27b", sliding_window=4, global_every=100)
    tcfg = s["tcfg"]
    assert not any(TMDL.layer_meta(tcfg))
    L, w = tcfg.num_layers, tcfg.sliding_window
    toks, _, _ = _inputs(s, 5, T=16)
    last = 15
    far = last - L * (w - 1) - 1
    near = last - L * (w - 1)
    h0, _, _ = TMDL.forward(s["tparams"], _t(toks), tcfg)
    for at, same in ((far, True), (0, True), (near, False)):
        t2 = toks.copy()
        t2[:, at] = (t2[:, at] + 1) % tcfg.vocab_size
        h2, _, _ = TMDL.forward(s["tparams"], _t(t2), tcfg)
        assert torch.equal(h0[:, last], h2[:, last]) == same, at


# ----------------------------------------------------------------------------
# gemma's embedding scale in bf16
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("d", [2048, 5376, 1536])
def test_embed_scale_bf16_is_bitwise(d):
    """bf16 token rows scaled by the port equal JAX's ``x *
    jnp.sqrt(d).astype(x.dtype)`` bitwise (a Python-float scale would not:
    torch multiplies in fp32 by the unrounded sqrt(d))."""
    cfg = get_config("gemma-2b").with_(d_model=d, vocab_size=64,
                                       dtype="bfloat16")
    tcfg = tget_config("gemma-2b").with_(d_model=d, vocab_size=64,
                                         dtype="bfloat16")
    rng = np.random.default_rng(d)
    emb = jnp.asarray(rng.normal(size=(64, d)), jnp.bfloat16)
    toks = rng.integers(0, 64, (2, 32)).astype(np.int32)
    want = jnp.take(emb, jnp.asarray(toks), axis=0) \
        * jnp.sqrt(cfg.d_model).astype(jnp.bfloat16)
    got = TMDL.embed_tokens({"embed": bridge.to_torch(_np(emb))}, _t(toks),
                            tcfg)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(bridge.to_numpy(got).view(np.uint16),
                                  np.asarray(want).view(np.uint16))


# ----------------------------------------------------------------------------
# #8's plain version with a GELU gate; the planner at full width
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("adapter", ["none", "bf16", "int8", "int4"])
def test_plain_decode_block_gelu_matches_jax(adapter):
    """``decode_block_ref`` with ``act_name="gelu"`` against JAX's
    ``decode_block_row`` route (``impl="ref"``), in bf16 and in fp32."""
    args, kw = _block_inputs("gqa_bias", adapter, seed=6)
    kw = dict(kw, act_name="gelu")
    got = _run_port(args, kw, torch.bfloat16)
    want, = _run_jax(args, kw, ("ref",), jnp.bfloat16)
    for g, w, name in zip(got, want, ("y", "k_rows", "v_rows")):
        np.testing.assert_allclose(_f32(g), _f32(w), err_msg=name,
                                   **BF16_TOL)
    got = _run_port(args, kw, torch.float32)
    want, = _run_jax(args, kw, ("ref",), jnp.float32)
    for g, w, name in zip(got, want, ("y", "k_rows", "v_rows")):
        np.testing.assert_allclose(g.numpy(), _f32(w), err_msg=name, **TOL)


def _fused_configs():
    """Every config whose T=1 decode JAX sends to its megakernel: full
    attention, causal, attention blocks, no MoE."""
    from repro_torch.configs import ASSIGNED_ARCHS
    out = []
    for name in ASSIGNED_ARCHS:
        cfg = tget_config(name)
        if cfg.block_pattern == "attn" and not cfg.moe \
                and cfg.attn_type == "full" and cfg.causal:
            out.append(cfg)
    return out


def test_decode_plan_accepts_every_fused_config():
    """``plan`` and ``smem_bytes`` accept every full-attention, non-MoE
    config at full width for 1 to 8 slots on every adapter route, at the
    serving caches (S=128) and a 2048-row one; their variants are built;
    qwen1.5-0.5b keeps its rows whole (no window)."""
    cfgs = _fused_configs()
    assert sorted(c.name for c in cfgs) == sorted(
        ["qwen1.5-0.5b", "deepseek-7b", "gemma-2b", "llava-next-34b",
         "musicgen-medium"])
    for cfg in cfgs:
        assert KD._unsupported(cfg.norm, cfg.pos == "rope", cfg.mlp_type,
                               cfg.act, "bf16", "gelu") is None, cfg.name
        w = dict(d=cfg.d_model, H=cfg.num_heads, hd=cfg.head_dim,
                 ff=cfg.d_ff)
        for B in range(1, KD.MAX_SLOTS + 1):
            assert KD.smem_bytes(B, **w) <= KD.MAX_SMEM
            kin = KD.in_width(B, **w)
            assert kin % KD.CHUNK == 0 or kin == max(
                w["d"], w["H"] * w["hd"], w["ff"])
            for S in (1, 32, 128, 2048):
                for adapter in ("none", "bf16", "int8", "int4"):
                    sc = KD.plan(B, KV=cfg.num_kv_heads, S=S, nb=64,
                                 adapter=adapter, **w)
                    # the C entry's rule: one split holds K and V in a
                    # stage, several their K rows each
                    splits = -(-S // sc)
                    assert sc % 16 == 0 and 16 <= sc <= 256
                    assert (4 if splits == 1 else 2) * sc * \
                        cfg.head_dim <= KD.STAGE_BYTES, (cfg.name, S)
        if cfg.name == "gemma-2b":
            # MQA at head_dim 256: one split holds S <= 32 rows
            assert KD.plan(4, KV=1, S=32, nb=64, adapter="bf16", **w) == 32
            assert KD.plan(4, KV=1, S=128, nb=64, adapter="bf16", **w) == 64
        if cfg.head_dim == 128:
            # a stage holds 128 K rows at hd 128 but not their V rows too
            assert KD.plan(4, KV=cfg.num_kv_heads, S=128, nb=64,
                           adapter="bf16", **w) == 64
    q = tget_config("qwen1.5-0.5b")
    for B in (1, 4, 8):
        assert KD.in_width(B, q.d_model, q.num_heads, q.head_dim,
                           q.d_ff) == q.d_ff


# ----------------------------------------------------------------------------
# one train step
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["musicgen-medium", "gemma-2b"])
def test_train_step_matches_jax(arch):
    """One xpeft step with ``prefix_embeds`` (musicgen-medium; the LM loss
    over hidden[:, P:]) and with ``embed_scale`` (gemma-2b): loss and
    gradients against JAX's ``make_train_step`` with its Gumbel draws
    injected."""
    cfg = reduce_for_smoke(get_config(arch)).with_xpeft(max_profiles=4)
    tcfg = treduce(tget_config(arch)).with_xpeft(max_profiles=4)
    jstate = jax.jit(JST.init_train_state, static_argnums=(1, 2))(
        jax.random.key(0), cfg, "xpeft")
    tstate = bridge.to_torch(_np(jstate))
    rng = np.random.default_rng(7)
    Bt, Tt = 4, 8
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (Bt, Tt)).astype(
                 np.int32),
             "labels": rng.integers(0, cfg.vocab_size, (Bt, Tt)).astype(
                 np.int32),
             "profile_ids": np.array([0, 1, 2, 3], np.int32)}
    if cfg.num_prefix_tokens:
        batch["prefix_embeds"] = rng.normal(
            size=(Bt, cfg.num_prefix_tokens, cfg.d_model)).astype(np.float32)
    key = jax.random.key(11)
    jnew, jm = jax.jit(JST.make_train_step(cfg, "xpeft", lr=1e-3))(
        jstate, jax.tree.map(jnp.asarray, batch), key)
    jg = _jax_grads(jnew, jm)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    grads, tm = TST.grads_for_batch(tstate["frozen"], tstate["trainable"],
                                    tb, tcfg, "xpeft", _noise(key, cfg, Bt))
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                               rtol=1e-5)
    _close_tree(grads, jg, rtol=1e-4, atol_rel=1e-6, what=f"{arch} grad ")
    assert float(np.abs(jg["table"]["mA"]).max()) > 0


@pytest.mark.parametrize("arch", ARCHS)
def test_launchers_take_the_forms_archs(arch, capsys):
    """``--arch <arch> --smoke`` through both launchers on the CPU: the
    training loop's losses finite, the server's tokens in range."""
    from repro_torch.launch import serve as LS
    from repro_torch.launch import train as LT
    out = LT.run(LT.parse_args(["--arch", arch, "--smoke", "--device", "cpu",
                                "--steps", "1", "--batch", "2", "--seq",
                                "8"]))
    assert out["cfg"].name == arch
    assert np.isfinite(float(out["history"][0]["loss"]))
    reqs, _ = LS.main(["--arch", arch, "--smoke", "--device", "cpu",
                       "--requests", "2", "--max-new", "3"])
    assert all(len(r.generated) == 3 and max(r.generated) < 512
               for r in reqs)


def test_c_signatures_match_their_argtypes():
    """Every C entry point's parameters, type by type, are the ctypes
    argument list the library is bound with (a parameter added on one
    side only would reach the card as a ctypes or launch error)."""
    import ctypes
    import re
    from repro_torch.kernels import _build
    kinds = {"int": ctypes.c_int, "long long": ctypes.c_longlong,
             "float": ctypes.c_float, "int*": ctypes.POINTER(ctypes.c_int)}
    src = "".join(p.read_text() for p in _build.sources())
    for name, types in _build.SIGNATURES.items():
        m = re.search(rf'extern "C" int {name}\(([^)]*)\)', src)
        assert m, name
        got = []
        for param in m[1].split(","):
            decl = " ".join(param.split()[:-1])
            ptr = param.split()[-1].startswith("*") or decl.endswith("*")
            if decl.startswith("int") and ptr:
                got.append(kinds["int*"])
            elif ptr:
                got.append(ctypes.c_void_p)
            else:
                got.append(kinds[decl.replace("const ", "")])
        assert got == types, name
