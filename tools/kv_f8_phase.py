"""``chip_smoke.py``'s phase 18: the float8_e4m3fn KV cache on the card.

    python3 tools/kv_f8_phase.py [PARTS]     (PARTS letters of "abc")

qwen1.5-0.5b at full width, bf16 activations, ``cache_dtype=
"float8_e4m3fn"``, random weights from seed 0 (bank N=256, b=64, k=50):

(a) #8 with float8 caches against its plain version at B=4: routes none,
    bf16, int8 and int4 at S=128 (``chip_smoke.DEC_POS``) and bf16 at
    S=2,048 (``DEC_LONG_POS``). y within check_dec's DEC_STEPS bf16
    steps; the float8 K/V rows each within one e4m3 step of the plain
    version's (a K/V value DEC_STEPS bf16 steps apart upstream may round
    to the neighbouring e4m3 value). Exact: the kernel's float8 rows
    byte-equal to ``.to(torch.float8_e4m3fn)`` of its own rows on a bf16
    cache of the same x and weights (the new row does not read the
    cache), also on one set with Wk/Wv scaled by OVERFLOW_SCALE so that
    some values pass 448 and cast to NaN. Two calls bitwise equal. Timed
    (cold CUDA-graph replays over 24 layers) beside the same sets on bf16
    caches, in turns, and the plain version.
(b) windowed drains at F8_LAYERS layers, 8 requests x 16 new tokens on 4
    slots (``chip_smoke.drive_path``): composed and ``decode_fused`` at
    float8 (a decode step of ``decode_fused`` profiled), each held to its
    own ``kernel_impl="ref"`` float8 run under
    chip_smoke's rules (logits within E2E_STEPS bf16 steps and
    E2E_SHARE_REL of the adapters' share; every greedy flip on a ref
    top-2 gap), #8 launched layers x decode steps on the ``decode_fused``
    drain, the engines' K/V bytes exactly half the bf16-cache engine's.
    The tokens' agreement with the bf16-cache runs is reported, not
    asserted: it is the cache format's own rounding.
(c) continuous drains at ``chip_smoke.CUT_LAYERS`` on C_REQUESTS of
    phase 9's skewed requests: a pool of C_PAGES pages that preempts, its
    tokens bitwise
    the windowed float8 run's; spec gamma CB_GAMMA on the same pool, held
    to the plain continuous run under phase 9's spec rule (flips
    explained, more than one token committed a device step, fewer steps).

Without a card it exits non-zero. Its numbers are one JSON line last.
"""
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(HERE, "src"))
sys.path.insert(0, HERE)
sys.path.insert(0, os.path.join(HERE, "tools"))

import chip_smoke as cs  # noqa: E402
import forms_phase as FP  # noqa: E402

F8 = "float8_e4m3fn"
ARCH = "qwen1.5-0.5b"
# (route, S) of (a); the first is the decode_fused path's own shape
F8_SHAPES = (("bf16", 128), ("none", 128), ("int8", 128), ("int4", 128),
             ("bf16", cs.DEC_LONG_S))
# Wk and Wv of (a)'s overflow set: k and v of ~N(0, 1) scaled past 448
OVERFLOW_SCALE = 200.0
# (b)'s depth: CUT_LAYERS of qwen1.5-0.5b's 24 (full width), for the
# call's time (at 24 layers (b) took 45.7 s of a 62 s phase on an H100
# host, most of it the decode_fused path's plain-version runs)
F8_LAYERS = cs.CUT_LAYERS
# (c): the first C_REQUESTS of phase 9's skewed requests (1 in 3 with 40
# new tokens; 8 of its 12 for the call's time) on a pool of C_PAGES pages
# of 16 rows, which preempts (a request may need max_seq / 16 = 8)
C_PAGES = 8
C_REQUESTS = 8


def cut(params, L):
    """The first L layers' blocks and bank (views) of full-depth params."""
    from repro_torch.utils.tree import tree_map
    return dict(params, **{k: tree_map(lambda t: t[:L], params[k])
                           for k in ("blocks", "xpeft_bank")})


def e4m3_step(torch, v):
    """Spacing of float8_e4m3fn values at magnitude |v| (elementwise): 2^-9
    below 2^-6 (the subnormals), else 2^(floor(log2 |v|) - 3)."""
    a = v.abs().clamp_min(2.0 ** -6)
    return torch.exp2(torch.floor(torch.log2(a)) - 3)


def f8_sets(torch, sets):
    """The same argument sets with the caches cast to float8_e4m3fn."""
    f8 = torch.float8_e4m3fn
    return [(x, pos, blk, kc.to(f8), vc.to(f8), m)
            for x, pos, blk, kc, vc, m in sets]


def check_f8(torch, KD, ref, args, kw, label):
    """The float8-cache kernel against its plain version: y within
    DEC_STEPS bf16 steps at its largest |value|, each float8 K/V row value
    within one e4m3 step of the plain version's. Returns (max |d y|, max
    |d row|, float8 row bytes apart)."""
    got = KD.decode_block_fused(*args, **kw)
    want = ref.decode_block_ref(*args, **kw)
    torch.cuda.synchronize()
    assert got[0].dtype == want[0].dtype == torch.bfloat16
    y, yw = got[0].float(), want[0].float()
    assert torch.isfinite(y).all(), label
    err_y = (y - yw).abs().max().item()
    tol = cs.DEC_STEPS * cs.bf16_step(yw.abs().max().item())
    assert err_y <= tol, (label, err_y, tol)
    err_row, apart = 0.0, 0
    for g, w, name in zip(got[1:], want[1:], ("k_rows", "v_rows")):
        assert g.dtype == w.dtype == torch.float8_e4m3fn, (label, name)
        assert g.shape == w.shape, (label, name)
        gf, wf = g.float(), w.float()
        assert torch.isfinite(gf).all(), (label, name)
        d = (gf - wf).abs()
        steps = (d / e4m3_step(torch, torch.maximum(gf.abs(), wf.abs())))
        assert steps.max().item() <= 1.0, (label, name, steps.max().item())
        apart += int((g.view(torch.uint8) != w.view(torch.uint8)).sum())
        err_row = max(err_row, d.max().item())
    cs.log(f"  check {label} float8 cache: y max_abs_err {err_y:.3e} (tol "
           f"{tol:.3e}); K/V rows max_abs_err {err_row:.3e}, {apart} of "
           f"{2 * got[1].numel()} bytes apart, each within one e4m3 step")
    return err_y, err_row, apart


def check_cast(torch, KD, f8_args, bf_args, kw, label):
    """The kernel's float8 K/V rows byte-equal to the cast of its own rows
    on a bf16 cache (the same x and weights): PyTorch's ``.to`` on the
    card and the port's ``to_cache_dtype`` (JAX's rule; the two agree on
    the card's PyTorch). Returns the NaN bytes (0x7f / 0xff) among them."""
    from repro_torch.utils.cache_cast import to_cache_dtype
    f8 = torch.float8_e4m3fn
    got = KD.decode_block_fused(*f8_args, **kw)
    bf = KD.decode_block_fused(*bf_args, **kw)
    torch.cuda.synchronize()
    nan = 0
    for g, b, name in zip(got[1:], bf[1:], ("k_rows", "v_rows")):
        assert b.dtype == torch.bfloat16 and g.dtype == f8
        gb = g.view(torch.uint8)
        for rule, want in ((".to", b.to(f8)),
                           ("to_cache_dtype", to_cache_dtype(b, f8))):
            want = want.view(torch.uint8)
            assert torch.equal(gb, want), (label, name, rule,
                                           int((gb != want).sum()))
        nan += int(((gb & 0x7f) == 0x7f).sum())
    cs.log(f"  check {label}: float8 K/V rows byte-equal to .to("
           f"float8_e4m3fn) and to_cache_dtype of the bf16-cache rows "
           f"({nan} NaN bytes)")
    return nan


def overflow_set(torch, args):
    """``args`` with the layer's Wk and Wv scaled by OVERFLOW_SCALE."""
    x, pos, blk, kc, vc, m = args
    attn = dict(blk["attn"])
    for w in ("wk", "wv"):
        attn[w] = (attn[w].float() * OVERFLOW_SCALE).to(attn[w].dtype)
    return (x, pos, dict(blk, attn=attn), kc, vc, m)


def kernel_rows(torch, KD, ref, cfg, QS):
    """(a): one row per shape of F8_SHAPES, as phase 3 logs and returns
    them, with the bf16-cache kernel's time on the same inputs beside."""
    gen = torch.Generator(device="cuda").manual_seed(18)
    kw = dict(norm=cfg.norm, qkv_bias=cfg.qkv_bias,
              use_rope=cfg.pos == "rope", theta=cfg.rope_theta,
              cap=cfg.logit_softcap, mlp_type=cfg.mlp_type, act_name=cfg.act,
              adapter_act=cfg.xpeft.adapter_activation)
    rows = []
    for route, S in F8_SHAPES:
        quant = (QS, route, cfg.xpeft.quant_group) \
            if route in ("int8", "int4") else None
        long = S == cs.DEC_LONG_S
        sets = cs.dec_inputs(torch, gen, cfg, cfg.num_kv_heads, quant=quant,
                             S=S, pos=cs.DEC_LONG_POS if long else None)
        fsets = f8_sets(torch, sets)
        rkw = dict(kw, adapter=route)
        label = f"KV={cfg.num_kv_heads} route={route} S={S}"
        err_y, err_row, apart = check_f8(torch, KD, ref, fsets[0], rkw,
                                         label)
        check_f8(torch, KD, ref, fsets[7], rkw, label + " layer 7")
        check_cast(torch, KD, fsets[0], sets[0], rkw, label)
        nan = None
        if route == "bf16" and not long:
            nan = check_cast(torch, KD, overflow_set(torch, fsets[0]),
                             overflow_set(torch, sets[0]), rkw,
                             label + f" Wk/Wv x{OVERFLOW_SCALE:g}")
            assert nan > 0, nan
        again = KD.decode_block_fused(*fsets[0], **rkw)
        first = KD.decode_block_fused(*fsets[0], **rkw)
        assert all(torch.equal(a.view(torch.uint8), b.view(torch.uint8))
                   for a, b in zip(again, first))
        # cold: the calls rotate over the 24 layers; bf16 and float8
        # caches in turns (bf16, float8, float8, bf16) on one card
        kern = lambda s: cs.device_ms(torch, cs.rotating(  # noqa: E731
            lambda *a: KD.decode_block_fused(*a, **rkw), s), calls=len(s))
        bf_ms = [kern(sets)]
        ms = [kern(fsets), kern(fsets)]
        bf_ms.append(kern(sets))
        plain_ms = cs.device_ms(torch, cs.rotating(
            lambda *a: ref.decode_block_ref(*a, **rkw), fsets),
            calls=len(fsets))
        nbytes = cs.dec_bytes(fsets[0], route)
        bound_ms, bound_by = cs.bound(nbytes, cs.dec_flops(fsets[0], route),
                                      "bfloat16")
        row = dict(shape=label + " float8 cache", max_abs_err=max(
            err_y, err_row), y_max_abs_err=err_y, row_max_abs_err=err_row,
            row_bytes_apart=apart, ms=sum(ms) / 2, plain_ms=plain_ms,
            bound_ms=bound_ms, bound_by=bound_by, library_ms=None,
            bf16_cache_ms=sum(bf_ms) / 2, turns_ms=[bf_ms[0], ms[0], ms[1],
                                                    bf_ms[1]],
            overflow_nan_bytes=nan, bytes=nbytes)
        cs.log(f"decode_block_fused B=4 S={S} d={cfg.d_model} route={route}"
               f" float8 cache: ms {row['ms']:.5f} (cold; turns bf16 / f8 / "
               f"f8 / bf16 {' / '.join(f'{t:.5f}' for t in row['turns_ms'])})"
               f" | plain {plain_ms:.5f} | bound {bound_ms:.5f} ({bound_by}: "
               f"{nbytes / 1e6:.2f} MB)")
        rows.append(row)
        del sets, fsets
        torch.cuda.empty_cache()
    # S=256: one split of 256 float8 rows a stage (two of 128 on bf16);
    # checked, not timed: the serving paths here run S=128
    assert KD.plan(4, cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                   cfg.head_dim, cfg.d_ff, 256, cfg.xpeft.bottleneck, "bf16",
                   torch.float8_e4m3fn) == 256
    sets = cs.dec_inputs(torch, gen, cfg, cfg.num_kv_heads, L=8, S=256,
                         pos=[255, 0, 130, 256])
    fsets = f8_sets(torch, sets)
    rkw = dict(kw, adapter="bf16")
    for i in (0, 7):
        check_f8(torch, KD, ref, fsets[i], rkw, f"route=bf16 S=256 layer {i}")
    check_cast(torch, KD, fsets[0], sets[0], rkw, "route=bf16 S=256")
    return rows


def windowed(torch, params, counters):
    """(b): composed and decode_fused at float8 on F8_LAYERS layers, each
    through ``chip_smoke.drive_path``, and each beside the same requests
    drained on a bf16 cache."""
    from repro_torch.configs import get_config
    from repro_torch.serve import Request

    cfg = get_config(ARCH).with_(num_layers=F8_LAYERS)
    params = cut(params, F8_LAYERS)
    store = FP.store_for(cfg)
    fcfg = cfg.with_(cache_dtype=F8)
    L = cfg.num_layers
    out = {}
    for path, extra in (("composed", {}), ("decode_fused",
                                            dict(decode_fused=True))):
        fused = bool(extra)

        def check(n, st, waves, fused=fused):
            if fused:
                assert n["decode_block_fused"] == L * st["device_steps"] > 0
                assert n["fused_adapter_batched"] == \
                    L * st["prefill_batches"], n
            else:
                assert n["decode_block_fused"] == 0, n
                assert n["fused_adapter_batched"] == \
                    L * (st["device_steps"] + st["prefill_batches"]) > 0, n
            assert n["mask_aggregate_batched"] > 0, n

        t = time.perf_counter()
        eng, reqs, n, stats = cs.drive_path(
            torch, f"{path} float8 cache", fcfg.with_(**extra), params,
            store, tuple(counters.items()), check, profile=fused)
        b_reqs = cs.make_requests(Request, cfg.vocab_size)
        b_eng, _, _, _ = cs.serve_once(torch, cfg.with_(**extra), params,
                                       store, b_reqs)
        b_bytes = b_eng.kv_pool_bytes()
        kv = eng.kv_pool_bytes()
        assert eng.cache["k"].dtype == eng.cache["v"].dtype == \
            torch.float8_e4m3fn
        assert 2 * kv == b_bytes, (kv, b_bytes)
        agree = cs.tokens_equal(reqs, b_reqs)
        cs.log(f"  {path} float8 cache: K/V {kv / 1e6:.3f} MB, half the "
               f"bf16-cache engine's {b_bytes / 1e6:.3f} MB; tokens equal "
               f"to the bf16-cache run {agree:.3f} (reported: the cache "
               f"format's own rounding)")
        stats.update(launches=n, kv_bytes=kv, bf16_kv_bytes=b_bytes,
                     tokens_equal_bf16_cache=agree,
                     seconds=time.perf_counter() - t)
        out[path] = stats
    return out


def continuous(torch, params, counters):
    """(c): C_REQUESTS of phase 9's requests at CUT_LAYERS, float8:
    windowed, continuous on C_PAGES pages (preempting) bitwise windowed,
    spec on the same pool held to the continuous run."""
    from repro_torch.configs import get_config

    L = cs.CUT_LAYERS
    cfg = get_config(ARCH).with_(num_layers=L, cache_dtype=F8)
    params = cut(params, L)
    store = FP.store_for(cfg)
    s_cfg = cfg.with_(spec_enable=True, spec_gamma=cs.CB_GAMMA)

    def run(c, cont, **kw):
        return dict(cfg=c, params=params, store=store, continuous=cont,
                    long_new=40, n=C_REQUESTS, kw=kw)
    runs = {"windowed": run(cfg, False),
            "continuous": run(cfg, True, max_pages=C_PAGES),
            "spec": run(s_cfg, True, max_pages=C_PAGES)}
    # no warm-up drains (for the call's time): (c)'s tok/s include first
    # use
    done = {name: cs.cb_drain(torch, r, counters)
            for name, r in runs.items()}
    w, c, s = done["windowed"], done["continuous"], done["spec"]
    for d in (w, c):
        FP.launch_check(L)(d["launches"], d["stats"], d["waves"])
    st, sst = c["stats"], s["stats"]
    assert c["eng"].cache["data"]["k"].dtype == torch.float8_e4m3fn
    assert st["preemptions"] > 0 and st["resumes"] > 0, st
    ct = cs.cb_explain(torch, c, w)
    assert FP.tokens_bitwise(c, w), ct
    stt = cs.cb_explain(torch, s, c)
    assert sst["committed_per_device_step"] > 1.0, sst
    assert sst["device_steps"] < st["device_steps"], (sst, st)
    n = s["launches"]
    assert n["fused_adapter_batched"] > 0 and n["decode_block_fused"] == 0, n
    for d in (c, s):
        d["eng"].page_alloc.check()
        d["eng"].mask_alloc.check()
    cs.log(f"float8 (c) at {L} layers: continuous on {C_PAGES} pages, "
           f"{st['preemptions']} preemptions, {st['resumes']} resumes, "
           f"tokens bitwise the windowed run's, {st['device_steps']} device "
           f"steps (windowed {w['stats']['device_steps']}), "
           f"{c['tok_s']:.1f} tok/s (windowed {w['tok_s']:.1f}); spec gamma "
           f"{cs.CB_GAMMA}: acceptance {sst['spec']['acceptance_rate']}, "
           f"tokens agree {stt['agree']}/{stt['total']} "
           f"({len(stt['flips'])} requests part, each flip explained), "
           f"{sst['device_steps']} rounds, {s['tok_s']:.1f} tok/s")
    keep = ("device_steps", "preemptions", "resumes", "pages",
            "stranded_slot_steps", "committed_per_device_step")
    return dict(
        windowed=dict(tok_s=w["tok_s"], launches=w["launches"],
                      **{k: w["stats"][k] for k in ("device_steps",)}),
        continuous=dict(tok_s=c["tok_s"], launches=c["launches"],
                        tokens_bitwise_windowed=True,
                        kv_bytes=c["eng"].kv_pool_bytes(),
                        **{k: st[k] for k in keep}),
        spec=dict(tok_s=s["tok_s"], launches=s["launches"],
                  spec=sst["spec"], agree=stt["agree"], total=stt["total"],
                  flips=stt["flips"], **{k: sst[k] for k in keep}))


def phase_kv_f8(torch, parts="abc", params=None):
    """Phase 18: (a)-(c) above; ``params`` may carry phase 4's full-depth
    weights (``init_lm(seed=0)``, cut to each part's depth as views), else
    they are drawn."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import decode_fused as KD
    from repro_torch.kernels import ref
    from repro_torch.models import init_lm
    from repro_torch.quant import schemes as QS

    t0 = time.perf_counter()
    out, secs = {}, {}
    counters = cs.kernel_counters()
    cfg = get_config(ARCH)
    if "a" in parts:
        t = time.perf_counter()
        out["kernel_rows"] = kernel_rows(torch, KD, ref, cfg, QS)
        secs["a"] = time.perf_counter() - t
    params = None
    if "b" in parts or "c" in parts:
        params = params or init_lm(cfg, seed=0, device="cuda")
    if "b" in parts:
        t = time.perf_counter()
        out["windowed"] = windowed(torch, params, counters)
        secs["b"] = time.perf_counter() - t
    if "c" in parts:
        t = time.perf_counter()
        out["continuous"] = continuous(torch, params, counters)
        secs["c"] = time.perf_counter() - t
    # each run's launches, by kernel
    out["runs"] = {f"{part}_{k}": v["launches"]
                   for part, key in (("b", "windowed"), ("c", "continuous"))
                   for k, v in out.get(key, {}).items()}
    out["seconds"] = time.perf_counter() - t0
    out["part_seconds"] = secs
    cs.log(f"phase 18 (float8 cache): {out['seconds']:.1f}s ("
           + ", ".join(f"({k}) {v:.1f}s" for k, v in secs.items()) + ")")
    return out


def main():
    import torch
    if not torch.cuda.is_available():
        print("kv_f8_phase: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 2
    from repro_torch.kernels import _build

    parts = next((a for a in sys.argv[1:] if not a.startswith("-")),
                 "abc")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cs.log(f"device: {cs.nvidia_smi()} | torch {torch.__version__} cuda "
           f"{torch.version.cuda}")
    t = time.perf_counter()
    _build.build(verbose="-v" in sys.argv)
    _build.load_library()
    cs.log(f"build: {time.perf_counter() - t:.2f}s")
    out = phase_kv_f8(torch, parts)
    cs.log(json.dumps({"kv_f8": out}, default=str))
    return 0


if __name__ == "__main__":
    sys.exit(main())
