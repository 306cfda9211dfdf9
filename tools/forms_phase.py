"""``chip_smoke.py``'s phase 13 (the attention forms: gemma's embedding
scale, gemma3's sliding-window/global mix, the frontends' prefix rows, and
the decode megakernel's GLU-GELU and wide-row builds) on the card; run
alone:

    python3 tools/forms_phase.py

Builds the kernels, turns TF32 off as ``chip_smoke.py`` does and runs
``phase_forms``: bf16, random weights from seed 0, bank N=256, b=64,
k=50, in this order (each model freed before the next).

(d) #8 alone against its plain version at each new instantiation: one
    full-width layer from a seed, S=128 and S=2,048, routes none, bf16,
    int8 and int4, under phase 3's DEC_STEPS bound, at gemma-2b (4 and 8
    slots), musicgen-medium (8), deepseek-7b (8) and llava-next-34b (4);
    bf16 and none timed (CUDA-graph replays) beside the byte bound (the
    layer's weights, the K/V rows read, the adapter) and the plain
    version.
(a) gemma-2b at full width and depth (18 layers, d=2048, 8 x 256 heads,
    MQA, GLU-GELU d_ff 16,384, vocab 256,000 tied, embed_scale): one xpeft
    step on the card against the CPU (2 layers, float32) under phase 7's
    bounds; ten full-depth steps at B=8, T=64 through ``launch/train.py``'s
    loop; its frozen weights then serve phase 4's workload (8 requests of
    4-16 prompt tokens, 16 new, 4 slots) composed and with
    ``decode_fused`` (#8 18 times a decode step), and, on the first
    GEMMA_CUT = 9 layers (the call's time), from int8 (composed) and int4
    (``decode_fused``) banks, each held to its ``kernel_impl="ref"`` run
    by ``chip_smoke.drive_path`` (phase 4's E2E bounds); then continuous
    (pages of 16) against the windowed run, bitwise, and spec gamma 3
    against continuous, every flip explained.
(b) gemma3-27b at full width and GEMMA3_LAYERS = 12 of its 62 layers (two
    periods of 5 local : 1 global; the full 62 layers and their 21.8 GB
    bank do not fit beside the run's other memory; at one period the
    adapters' share of the prefill logits falls under twice the kernel's
    distance from its ref run): #1 at its bank, #2 at d=5376, T=1
    and 16, and #6 from int4 records there (the two-pass tile), timed; 8
    requests of 1,000-1,100 prompt tokens, LONG_NEW = 16 new, 4 slots,
    max_seq 2,048, so decode positions pass 1,024 and the window masks
    keys, and
    the prefills (T 1,024 or 2,048, S 2,048) take the chunked online
    softmax. Composed, int8 and int4 (#5 and #6) each held to its ref run
    (recorded logits: prefill and teacher-forced decode logits under
    phase 4's bounds, every flip explained); continuous bitwise the
    windowed run; ``decode_fused=True`` launches #8 0 times (sliding
    layers keep the composed route, as JAX decides it) with tokens
    bitwise the composed run's.
(c) musicgen-medium at full width and MUSIC_LAYERS = 12 of its 48 layers
    (d=1536, 24 x 64 heads, d_ff 6,144, vocab 2,048; the call's time)
    with 64 conditioning frames:
    ``make_prefill_step`` with random ``prefix_embeds`` [B, 64, 1536],
    then 16 greedy tokens through ``make_decode_step`` at cache_pos = T +
    P, composed (4 slots) and with ``decode_fused`` at 8 slots (the
    wide-row build), each held to its ref run (prefill and teacher-forced
    decode logits, flips explained); one xpeft step with
    ``prefix_embeds`` card against CPU (2 layers, float32).

Every failed check raises. Prints one JSON line of its numbers last.
Without a card it exits non-zero.
"""
import gc
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if HERE not in sys.path:
    sys.path.insert(0, HERE)
if os.path.join(HERE, "tools") not in sys.path:
    sys.path.insert(0, os.path.join(HERE, "tools"))

import chip_smoke as cs  # noqa: E402
import moe_phase  # noqa: E402

GEMMA, GEMMA3, MUSICGEN = "gemma-2b", "gemma3-27b", "musicgen-medium"
# gemma3-27b's depth here: two periods of its 5 local : 1 global layers
# (at one, the composed prefill logits part from the ref run by 1.3x the
# adapters' share, over phase 4's 0.5)
GEMMA3_LAYERS = 12
# the depth of gemma-2b's int8, int4, continuous and spec runs (composed
# and decode_fused run all 18 layers): the call's time
GEMMA_CUT = 9
TRAIN_ARGV = ["--arch", GEMMA, "--mode", "xpeft", "--steps", "10",
              "--batch", "8", "--seq", "64", "--profiles", "8", "--seed",
              "0", "--device", "cuda"]
# engine shapes over phase 9's (4 slots, max_seq 128, sync_every 8)
SHORT, LONG = {}, dict(max_seq=2048)
# new tokens of (b)'s drained requests (the call's time: 16 of the 32
# they had; every prompt of 1,025 tokens or more still decodes past the
# window); the profiled engine's requests keep 32, as it steps 15 times
LONG_NEW = 16
DEC_SHAPES = ((GEMMA, 4), (GEMMA, 8), (MUSICGEN, 8), ("deepseek-7b", 8),
              ("llava-next-34b", 4), ("llava-next-34b", 8))
DEC_LONG_POS = [2047, 0, 1000, 1500, 77, 1, 2048, 512]
MUSIC_T, MUSIC_NEW = 16, 16
# musicgen-medium's depth in (c): 12 of its 48 layers (full width), for
# the call's time
MUSIC_LAYERS = 12
# the device the models of (a)-(c) live on (a CPU rehearsal sets "cpu")
DEV = "cuda"


tree_bytes = moe_phase.tree_bytes


def store_for(cfg, n=4, **kw):
    """A store of ``n`` random profiles (the profile table from seed 0)."""
    from repro_torch.core import xpeft as XP
    from repro_torch.core.profiles import ProfileStore
    xp = cfg.xpeft
    table = XP.init_profile_table(cfg.with_xpeft(max_profiles=n), seed=0)
    store = ProfileStore(cfg.num_layers, xp.num_adapters, xp.bottleneck,
                         xp.mask_type, xp.k, **kw)
    for pid in range(n):
        store.add_profile(pid, {k: v[pid] for k, v in table.items()})
    return store


# ----------------------------------------------------------------------------
# (d) the decode megakernel's new instantiations
# ----------------------------------------------------------------------------

def dec_rows(torch, KD, ref, QS):
    from repro_torch.configs import get_config
    gen = torch.Generator(device="cuda").manual_seed(13)
    rows = []
    for arch, B in DEC_SHAPES:
        cfg = get_config(arch)
        d, H, hd, ff = cfg.d_model, cfg.num_heads, cfg.head_dim, cfg.d_ff
        kin = KD.in_width(B, d, H, hd, ff)
        kw = dict(norm=cfg.norm, qkv_bias=cfg.qkv_bias,
                  use_rope=cfg.pos == "rope", theta=cfg.rope_theta,
                  cap=cfg.logit_softcap, mlp_type=cfg.mlp_type,
                  act_name=cfg.act, adapter_act=cfg.xpeft.adapter_activation)
        for S in (128, 2048):
            pos = cs.DEC_POS[:B] if S == 128 else DEC_LONG_POS[:B]
            for route in ("none", "bf16", "int8", "int4"):
                quant = (QS, route, cfg.xpeft.quant_group) \
                    if route in ("int8", "int4") else None
                args = cs.dec_inputs(torch, gen, cfg, cfg.num_kv_heads, L=1,
                                     B=B, S=S, quant=quant, pos=pos)[0]
                rkw = dict(kw, adapter=route)
                label = (f"{arch} B={B} S={S} route={route} act={cfg.act} "
                         f"rows in shared memory {kin}")
                err = cs.check_dec(torch, KD, ref, args, rkw, label)
                first = KD.decode_block_fused(*args, **rkw)
                again = KD.decode_block_fused(*args, **rkw)
                assert all(torch.equal(a, b) for a, b in zip(first, again))
                row = dict(shape=label, max_abs_err=err, library_ms=None)
                if route in ("none", "bf16"):
                    ms = cs.device_ms(torch, lambda: KD.decode_block_fused(
                        *args, **rkw), calls=4, reps=5)
                    plain_ms = cs.device_ms(torch, lambda: ref.
                                            decode_block_ref(*args, **rkw),
                                            calls=1, reps=3)
                    nbytes = cs.dec_bytes(args, route)
                    bound_ms, bound_by = cs.bound(
                        nbytes, cs.dec_flops(args, route), "bfloat16")
                    cs.log(f"decode_block_fused {label}: ms {ms:.5f} | "
                           f"plain {plain_ms:.5f} | bound {bound_ms:.5f} "
                           f"({bound_by}: {nbytes / 1e6:.2f} MB) | "
                           f"{nbytes / (ms * 1e-3) / 1e9:.0f} GB/s")
                    row.update(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                               bound_by=bound_by, bytes=nbytes)
                rows.append(row)
                del args, first, again
            torch.cuda.empty_cache()
    return rows


# ----------------------------------------------------------------------------
# recorded drains, and a path held to its ref run
# ----------------------------------------------------------------------------

def drain(torch, cfg, params, store, counters, reqs, kw, continuous=False):
    """``chip_smoke.cb_drain`` of ``reqs`` on a fresh engine of phase 9's
    shape overridden by ``kw``."""
    return cs.cb_drain(torch, dict(cfg=cfg, params=params, store=store,
                                   continuous=continuous, kw=kw),
                       counters, reqs=reqs)


def long_requests(Request, vocab, n=8, new=LONG_NEW):
    """n requests of 1,000-1,100 prompt tokens from seed 0, ``new`` new
    each, profiles i % 4."""
    import numpy as np
    rng = np.random.default_rng(0)
    return [Request(uid=i, prompt=rng.integers(
        0, vocab, size=int(rng.integers(1000, 1101))), profile_id=i % 4,
        max_new_tokens=new) for i in range(n)]


def held(torch, label, cfg, params, store, counters, make, eng_kw,
         check_launches, report_share=False):
    """One serving path held to its kernel_impl="ref" run: both drains
    recorded, every flip explained (``cb_explain``); the kernel route
    teacher-forced on the ref run's tokens and the ref route with the
    adapter left out (the adapters' share), so prefill and decode-step
    logits meet phase 4's E2E bounds. Returns (numbers, the kernel
    run)."""
    run = drain(torch, cfg, params, store, counters, make(), eng_kw)
    check_launches(run["launches"], run["stats"], run["waves"])
    st = run["stats"]
    toks = sum(len(r.generated) for r in run["reqs"])
    cs.log(f"forms {label} (kernels): {len(run['reqs'])} requests / {toks} "
           f"tokens in {st['device_steps']} device steps + "
           f"{st['prefill_batches']} prefill batches, {run['dt']:.3f}s = "
           f"{run['tok_s']:.1f} tok/s; launches {run['launches']}; peak "
           f"memory {run['peak_bytes'] / 2**30:.2f} GiB; admissions "
           f"{[w['path'] for w in run['waves']]}")
    ref_cfg = cfg.with_xpeft(kernel_impl="ref")
    ref = drain(torch, ref_cfg, params, store, counters, make(), eng_kw)
    assert not any(ref["launches"].values()), ref["launches"]
    tokens = cs.cb_explain(torch, run, ref)
    forced = {q.uid: q.generated for q in ref["reqs"]}
    reqs = run["reqs"]
    n = len(forced[reqs[0].uid])
    dec_k, _ = moe_phase.forced_run(torch, cfg, params, store, reqs, forced,
                                    eng_kw=eng_kw)
    dec_b, pre_b = moe_phase.forced_run(torch, ref_cfg, params, store, reqs,
                                        forced, bare=True, eng_kw=eng_kw)
    lk, lr = run["rec"]["logits"], ref["rec"]["logits"]
    dev = dec_k.device
    pre = [torch.stack([lg[(r.uid, 0)] for r in reqs]).to(dev)
           for lg in (lk, lr)]
    pre.append(torch.stack([pre_b[r.uid] for r in reqs]).float())
    dec_r = torch.stack([torch.stack([lr[(r.uid, j)] for j in range(1, n)])
                         for r in reqs]).to(dev)
    assert torch.isfinite(dec_k).all() and torch.isfinite(pre[0]).all()
    assert dec_k.shape == (len(reqs), n - 1, cfg.vocab_size)
    e2e = dict(prefill=cs.e2e_check(f"{label} prefill logits", *pre),
               decode=cs.e2e_check(
                   f"{label} decode-step logits, teacher-forced "
                   f"({len(reqs)} requests x {n - 1} steps)", dec_k, dec_r,
                   dec_b, report_share=report_share))
    cs.log(f"  greedy tokens agree {tokens['agree']}/{tokens['total']}")
    out = dict(tok_s=run["tok_s"], ref_tok_s=ref["tok_s"],
               launches=run["launches"],
               admissions=[w["path"] for w in run["waves"]],
               device_steps=st["device_steps"],
               prefill_batches=st["prefill_batches"],
               peak_bytes=run["peak_bytes"],
               greedy_agree_ref=tokens["agree"] / tokens["total"],
               flips=tokens["flips"], e2e=e2e)
    return out, run


def tokens_bitwise(a, b):
    return all(r.generated == q.generated for r, q in zip(a["reqs"],
                                                          b["reqs"]))


def launch_check(L, *, fused=False, quant=False, share_fused=False):
    """What a windowed drain must launch: admission's aggregation (#1, or
    #5 from a quantized bank) twice per aggregating wave; the adapter (#2,
    or #6) L times per prefill batch and, composed, per decode step; with
    ``fused`` #8 L times per decode step."""
    agg, fa = ("mask_aggregate_quant_batched", "fused_adapter_quant_batched") \
        if quant else ("mask_aggregate_batched", "fused_adapter_batched")

    def check(n, st, waves):
        steps, batches = st["device_steps"], st["prefill_batches"]
        aggregating = sum(w["path"] in ("sparse", "quant_sparse",
                                        "quant_mixed") for w in waves)
        assert n[agg] == 2 * aggregating > 0, n
        assert n["decode_block_fused"] == (L * steps if fused else 0), n
        assert n[fa] == L * (batches + (0 if fused else steps)) > 0, n
        others = set(n) - {agg, fa, "decode_block_fused"}
        assert not any(n[k] for k in others), n
    return check


# ----------------------------------------------------------------------------
# (a) gemma-2b
# ----------------------------------------------------------------------------

def phase_gemma(torch, counters):
    from repro_torch.configs import get_config
    from repro_torch.serve import Request
    from repro_torch.utils.tree import tree_map

    step = cs.phase_train_step_vs_cpu(
        torch, cfg=get_config(GEMMA).with_(num_layers=2, dtype="float32")
        .with_xpeft(max_profiles=8), label="forms (a) train")
    gc.collect()
    torch.cuda.empty_cache()
    trained, train = cs.phase_train_full(torch, TRAIN_ARGV)
    cfg, params = trained["cfg"], trained["state"]["frozen"]
    del trained
    gc.collect()
    torch.cuda.empty_cache()
    L, xp = cfg.num_layers, cfg.xpeft
    n_w = tree_bytes({k: v for k, v in params.items() if k != "xpeft_bank"})
    n_bank = tree_bytes(params["xpeft_bank"])
    cs.log(f"forms (a): {cfg.name} L={L} d={cfg.d_model} H={cfg.num_heads} "
           f"KV={cfg.num_kv_heads} hd={cfg.head_dim} ff={cfg.d_ff} "
           f"V={cfg.vocab_size} act={cfg.act} embed_scale={cfg.embed_scale}"
           f" {cfg.dtype}: {n_w / 1e9:.2f} GB of weights + "
           f"{n_bank / 1e9:.2f} GB of bank")
    store = store_for(cfg)
    out = dict(weights_bytes=n_w, bank_bytes=n_bank,
               train=dict(train, step_vs_cpu=step), runs={})
    # the cut runs: the first GEMMA_CUT layers' weights and bank (views)
    full = dict(cfg=cfg, params=params, store=store)
    cfg = cfg.with_(num_layers=GEMMA_CUT)
    params = dict(params, **{k: tree_map(lambda t: t[:GEMMA_CUT], params[k])
                             for k in ("blocks", "xpeft_bank")})
    store, L = store_for(cfg), GEMMA_CUT
    for label, c, p_, st_, check, share in (
            ("composed", full["cfg"], full["params"], full["store"],
             launch_check(full["cfg"].num_layers), False),
            ("decode_fused", full["cfg"].with_(decode_fused=True),
             full["params"], full["store"],
             launch_check(full["cfg"].num_layers, fused=True), False),
            ("int8 composed", cfg.with_xpeft(bank_quant="int8"), params,
             store_for(cfg, quant="int8", quant_group=xp.quant_group),
             launch_check(L, quant=True), True),
            ("int4 decode_fused", cfg.with_xpeft(bank_quant="int4").with_(
                decode_fused=True), params,
             store_for(cfg, quant="int4", quant_group=xp.quant_group),
             launch_check(L, quant=True, fused=True), True)):
        t = time.perf_counter()
        _, _, n, stats = cs.drive_path(
            torch, f"gemma-2b {label}", c, p_, st_,
            tuple(counters.items()),
            check, report_share=share)
        stats["launches"] = n
        stats["seconds"] = time.perf_counter() - t
        out[label.replace(" ", "_")] = stats
        out["runs"][label] = n
        gc.collect()
        torch.cuda.empty_cache()
    # continuous against the windowed run, bitwise; spec against continuous
    make = lambda: cs.make_requests(Request, cfg.vocab_size)  # noqa: E731
    w = drain(torch, cfg, params, store, counters, make(), SHORT)
    c = drain(torch, cfg, params, store, counters, make(), SHORT,
              continuous=True)
    launch_check(L)(c["launches"], c["stats"], c["waves"])
    ct = cs.cb_explain(torch, c, w)
    assert tokens_bitwise(c, w), ct
    s_cfg = cfg.with_(spec_enable=True, spec_gamma=cs.CB_GAMMA)
    s = drain(torch, s_cfg, params, store, counters, make(), SHORT,
              continuous=True)
    stt = cs.cb_explain(torch, s, c)
    sst = s["stats"]
    assert sst["committed_per_device_step"] > 1.0
    cs.log(f"forms (a) continuous: tokens bitwise the windowed run's, "
           f"{c['stats']['device_steps']} device steps (windowed "
           f"{w['stats']['device_steps']}), {c['tok_s']:.1f} tok/s "
           f"(windowed {w['tok_s']:.1f}); spec gamma {cs.CB_GAMMA}: "
           f"acceptance {sst['spec']['acceptance_rate']}, tokens agree "
           f"{stt['agree']}/{stt['total']}, {sst['device_steps']} rounds, "
           f"{s['tok_s']:.1f} tok/s")
    prof_c = cs.cb_profile(torch, dict(cfg=cfg, params=params, store=store,
                                       continuous=True, kw={}),
                           "gemma-2b continuous")
    prof_s = cs.cb_profile(torch, dict(cfg=s_cfg, params=params, store=store,
                                       continuous=True, kw={}),
                           f"gemma-2b spec gamma {cs.CB_GAMMA}")
    out["continuous"] = dict(tok_s=c["tok_s"], windowed_tok_s=w["tok_s"],
                             device_steps=c["stats"]["device_steps"],
                             windowed_device_steps=w["stats"][
                                 "device_steps"],
                             peak_bytes=c["peak_bytes"],
                             launches=c["launches"], **prof_c)
    out["spec"] = dict(tok_s=s["tok_s"], spec=sst["spec"],
                       device_steps=sst["device_steps"],
                       committed_per_device_step=sst[
                           "committed_per_device_step"],
                       tokens_agree=stt["agree"], flips=stt["flips"],
                       peak_bytes=s["peak_bytes"], launches=s["launches"],
                       **prof_s)
    out["runs"]["continuous"] = c["launches"]
    out["runs"]["spec"] = s["launches"]
    del params, w, c, s
    return out


# ----------------------------------------------------------------------------
# (b) gemma3-27b
# ----------------------------------------------------------------------------

def gemma3_kernel_rows(torch):
    """#1 over the 12 layers' bank [12 x 256, 5376, 64] and its B side (P
    = 4 profiles x 12 layers, k=50); #2 on layer slices at d=5376, T=1
    and T=16, B=4; #6 from int4 records there (8 blocks a cluster, the
    fp32 tile in two passes), T=1 and 16, B=4."""
    import torch.nn.functional as F

    from repro_torch.kernels import fused_adapter_batched as KF
    from repro_torch.kernels import fused_adapter_quant as KFQ
    from repro_torch.kernels import mask_aggregate as KA
    from repro_torch.kernels import ref
    from repro_torch.quant import schemes as QS

    gen = torch.Generator(device="cuda").manual_seed(14)
    d, nb, L = 5376, 64, GEMMA3_LAYERS
    agg = []
    for label, (dd, bb) in (("A_hat", (d, nb)), ("B_hat", (nb, d))):
        sets = [cs.agg_inputs(torch, gen, dd, bb, L=L, P=4 * L)]
        agg.append(cs.agg_row(torch, KA, ref, F, f"gemma3 {label}", sets))
        del sets
        torch.cuda.empty_cache()
    fa = cs.fa_slice_rows(torch, KF, ref, gen, "gemma3", d, nb, L,
                          ((4, 1, torch.bfloat16), (4, 16, torch.bfloat16)))
    faq = cs.faq_slice_rows(torch, KFQ, ref, QS, gen, "gemma3", "int4", d,
                            nb, L, (1, 16))
    assert all((r["cluster"], r["passes"]) == (8, 2) for r in faq), faq
    return dict(agg=agg, fa=fa, faq=faq)


def phase_gemma3(torch, counters):
    from repro_torch.configs import get_config
    from repro_torch.models import init_lm
    from repro_torch.serve import Request, ServeEngine

    rows = gemma3_kernel_rows(torch)
    cfg = get_config(GEMMA3).with_(num_layers=GEMMA3_LAYERS)
    L, xp = cfg.num_layers, cfg.xpeft
    params = init_lm(cfg, seed=0, device=DEV)
    n_w = tree_bytes({k: v for k, v in params.items() if k != "xpeft_bank"})
    n_bank = tree_bytes(params["xpeft_bank"])
    from repro_torch.models.model import layer_meta
    cs.log(f"forms (b): {cfg.name} L={L} of 62 (global layers "
           f"{[l for l, g in enumerate(layer_meta(cfg)) if g]}) d="
           f"{cfg.d_model} H={cfg.num_heads} KV={cfg.num_kv_heads} hd="
           f"{cfg.head_dim} ff={cfg.d_ff} V={cfg.vocab_size} window "
           f"{cfg.sliding_window}: {n_w / 1e9:.2f} GB of weights + "
           f"{n_bank / 1e9:.2f} GB of bank")
    store = store_for(cfg)
    make = lambda: long_requests(Request, cfg.vocab_size)  # noqa: E731
    out = dict(weights_bytes=n_w, bank_bytes=n_bank, kernel_rows=rows,
               runs={})
    a, run_a = held(torch, "gemma3 composed", cfg, params, store, counters,
                    make, LONG, launch_check(L))
    shapes = set(run_a["rec"]["shapes"].values())
    chunked = [s for s in shapes if s[1] > 512 and s[1] % 512 == 0
               and LONG["max_seq"] % 1024 == 0]
    past = sum(max(0, len(r.prompt) + len(r.generated) - 1 - 1024)
               for r in run_a["reqs"])
    cs.log(f"  prefill batches {sorted(shapes)} (chunked: {chunked}); "
           f"{past} decode positions past 1,024")
    assert chunked and past > 0
    out["composed"] = dict(a, prefill_shapes=sorted(shapes),
                           decode_positions_past_1024=past,
                           **cs.profile_decode(
                               torch, ServeEngine, Request, cfg, params, store,
                               "gemma3 composed (~1,100 positions)", LONG,
                               reqs=long_requests(Request, cfg.vocab_size,
                                                  n=4, new=32)))
    out["runs"]["composed"] = a["launches"]
    c = drain(torch, cfg, params, store, counters, make(), LONG,
              continuous=True)
    launch_check(L)(c["launches"], c["stats"], c["waves"])
    assert tokens_bitwise(c, run_a)
    f = drain(torch, cfg.with_(decode_fused=True), params, store,
              counters, make(), LONG)
    assert f["launches"]["decode_block_fused"] == 0
    assert tokens_bitwise(f, run_a)
    cs.log(f"forms (b) continuous: tokens bitwise the windowed run's, "
           f"{c['stats']['device_steps']} device steps (windowed "
           f"{run_a['stats']['device_steps']}), {c['tok_s']:.1f} tok/s; "
           f"decode_fused=True: #8 launched 0 times, tokens bitwise "
           f"composed, {f['tok_s']:.1f} tok/s")
    out["continuous"] = dict(tok_s=c["tok_s"], launches=c["launches"],
                             device_steps=c["stats"]["device_steps"],
                             peak_bytes=c["peak_bytes"])
    out["decode_fused"] = dict(tok_s=f["tok_s"], launches=f["launches"])
    out["runs"]["continuous"] = c["launches"]
    out["runs"]["decode_fused"] = f["launches"]
    del c, f, run_a
    gc.collect()
    # the quantized banks, composed: #5 at admission, #6 in every layer
    for scheme in ("int8", "int4"):
        q, _ = held(torch, f"gemma3 {scheme} composed",
                    cfg.with_xpeft(bank_quant=scheme), params,
                    store_for(cfg, quant=scheme, quant_group=xp.quant_group),
                    counters, make, LONG, launch_check(L, quant=True),
                    report_share=True)
        out[scheme] = q
        out["runs"][scheme] = q["launches"]
        gc.collect()
    del params
    return out


# ----------------------------------------------------------------------------
# (c) musicgen-medium
# ----------------------------------------------------------------------------

def music_run(torch, cfg, params, store, counters, toks, prefix,
              forced=None, bare=False, profiled=False):
    """Prefill ``toks`` behind ``prefix`` rows through ``make_prefill_step``
    then MUSIC_NEW - 1 greedy steps through ``make_decode_step`` at
    cache_pos T + P + s (fed ``forced`` tokens instead where given), the
    requests' profiles aggregated through #1. -> (tokens [B, n], prefill
    logits [B, V], decode logits [B, n-1, V], launches, host ms a step,
    and with ``profiled`` (device ms, kernels) of 4 more decode steps under
    torch.profiler tracing the card only)."""
    from repro_torch.core import xpeft as XP
    from repro_torch.models import model as MDL
    from repro_torch.serve import steps as SS

    B, T = toks.shape
    P = prefix.shape[1]
    for fn in counters.values():
        fn.launches = 0
    masks = None
    if not bare:
        pids = [i % 4 for i in range(B)]
        ia, wa, ib, wb = (t.to(DEV) for t in
                          store.batch_sparse_indices(pids))
        a_hat, b_hat = XP.precompute_effective_adapters_sparse(
            params["xpeft_bank"], ia, wa, ib, wb, cfg.xpeft)
        ls, lb = (t.to(DEV) for t in store.ln_affines(pids))
        masks = dict(a_hat=a_hat, b_hat=b_hat, ln_scale=ls, ln_bias=lb)
    cache = MDL.init_cache(cfg, B, T + P + MUSIC_NEW + 8, device=DEV)
    prefill, decode = SS.make_prefill_step(cfg), SS.make_decode_step(cfg)
    logits, cache = prefill(params, toks, cache, masks, prefix)
    pre = logits[:, -1].float()
    tok = pre.argmax(-1)
    out, dec = [tok], []
    torch.cuda.synchronize()
    t = time.perf_counter()
    for s in range(MUSIC_NEW - 1):
        feed = forced[:, s] if forced is not None else tok
        logits, cache = decode(params, feed[:, None].to(torch.int32), cache,
                               T + P + s, masks)
        dec.append(logits[:, -1].float())
        tok = dec[-1].argmax(-1)
        out.append(tok)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t) / (MUSIC_NEW - 1) * 1e3
    launches = {name: fn.launches for name, fn in counters.items()}
    prof = None
    if profiled:
        feed = tok[:, None].to(torch.int32)
        decode(params, feed, cache, T + P + MUSIC_NEW - 1, masks)
        torch.cuda.synchronize()

        def steps():
            for s in range(4):
                decode(params, feed, cache, T + P + MUSIC_NEW + s, masks)

        rows = cs.trace_card(torch, steps, "musicgen decode step")
        prof = (sum(e.self_device_time_total for e in rows) / 1e3 / 4,
                sum(e.count for e in rows) / 4)
    return (torch.stack(out, 1), pre, torch.stack(dec, 1), launches, ms,
            prof)


class LayerCheck:
    """While installed, every plain-version call the model makes of #2
    (``ops.fused_adapter`` on [B, T, d], impl "ref") and #8
    (``ops.decode_block_fused``, impl "ref") also runs the kernel on the
    same inputs, the model's own activations at that layer, and holds it
    to the plain result with phase 3's bounds: #2 within FA_BF16 (one
    rounding step), #8 within DEC_STEPS bf16 steps. Per kernel: the worst
    |kernel - plain| and the largest share of its bound any call used
    (``share``); the inputs of #8's call nearest its bound are kept
    (``worst_call``) for ``dec_stages``. The kernel's launches here are
    comparisons and are taken off its counter again."""

    def __init__(self, torch):
        from repro_torch.kernels import decode_fused as KD
        from repro_torch.kernels import fused_adapter_batched as KF
        from repro_torch.kernels import ops
        self.ops, self.fa0, self.dec0 = ops, ops.fused_adapter, \
            ops.decode_block_fused
        self.calls = dict(fused_adapter_batched=0, decode_block_fused=0)
        self.worst = dict(fused_adapter_batched=0.0, decode_block_fused=0.0)
        self.share = dict(self.worst)
        self.worst_call = None

        def fa(x, a, b, ls, lb, *, impl="auto", **kw):
            out = self.fa0(x, a, b, ls, lb, impl=impl, **kw)
            if impl == "ref" and x.ndim == 3 and x.device.type == DEV:
                n = KF.fused_adapter_batched.launches
                got = KF.fused_adapter_batched(x, a, b, ls, lb, **kw)
                KF.fused_adapter_batched.launches = n
                gap = (got.float() - out.float()).abs()
                tol = cs.FA_BF16_RTOL * out.float().abs() + cs.FA_BF16_ATOL
                assert (gap <= tol).all(), ("#2 per layer", gap.max().item())
                self._note("fused_adapter_batched", gap.max().item(),
                           (gap / tol).max().item())
            return out

        def dec(*args, impl="auto", **kw):
            out = self.dec0(*args, impl=impl, **kw)
            if impl == "ref" and args[0].device.type == DEV:
                n = KD.decode_block_fused.launches
                got = KD.decode_block_fused(*args, **kw)
                KD.decode_block_fused.launches = n
                worst = share = 0.0
                for g, w in zip(got, out):
                    err = (g.float() - w.float()).abs().max().item()
                    tol = cs.DEC_STEPS * cs.bf16_step(
                        max(w.float().abs().max().item(), 1e-30))
                    assert err <= tol, ("#8 per layer", err, tol)
                    worst, share = max(worst, err), max(share, err / tol)
                if self.worst_call is None or \
                        share > self.share["decode_block_fused"]:
                    self.worst_call = (tuple(
                        a.clone() if torch.is_tensor(a) else a
                        for a in args), kw)
                self._note("decode_block_fused", worst, share)
            return out
        ops.fused_adapter, ops.decode_block_fused = fa, dec

    def _note(self, name, err, share):
        self.calls[name] += 1
        self.worst[name] = max(self.worst[name], err)
        self.share[name] = max(self.share[name], share)

    def close(self):
        self.ops.fused_adapter = self.fa0
        self.ops.decode_block_fused = self.dec0


def dec_stages(torch, args, kw):
    """#8's stages on one call's inputs (``LayerCheck.worst_call``), read
    from its scratch (x1, act(g) * u, x2: fp32 words holding bf16 values),
    each held to ``decode_block_row``'s stage fed the KERNEL's own input to
    it: x1 = x + attention (from x), act(g) * u (from the kernel's x1), x2
    = x1 + down projection (from the kernel's act and x1), y = the adapter
    (from the kernel's x2), within DEC_STEPS bf16 steps of the stage's
    largest |value| as phase 3 holds a call; and each beside the plain
    version run end to end. -> {stage: {differ (elements not bitwise
    equal), of, max_abs, steps (max_abs in bf16 steps of the largest
    |value|), end_to_end_differ, end_to_end_max_abs}, worst: the y element
    that differs most end to end, with x1, the down projection and x2
    there}."""
    from repro_torch.kernels import decode_fused as KD
    from repro_torch.kernels import ref

    x, pos, block, kc, vc, masks = args
    B, _, d = x.shape
    H, ff = block["attn"]["wq"].shape[1], block["mlp"]["wg"].shape[1]
    route = kw["adapter"]
    assert kw["mlp_type"] == "glu" and route != "none", kw
    # the kernel's scratch: the last fp32 torch.empty of the call
    grabbed, empty = [], torch.empty

    def spy(*a, **k):
        t = empty(*a, **k)
        if k.get("dtype") is torch.float32:
            grabbed.append(t)
        return t
    n = KD.decode_block_fused.launches
    torch.empty = spy
    try:
        y_k = KD.decode_block_fused(*args, **kw)[0][:, 0]
    finally:
        torch.empty = empty
        KD.decode_block_fused.launches = n
    scr, a4 = grabbed[-1], (lambda m: (m + 3) // 4 * 4)
    # csrc/decode_fused.cu fill_layout, from the end: ... x1 [B, d], act
    # [B, ff], x2 [B, d], the adapter's partials, the counters
    nb = KD._adapter_operands(masks, route, x)["nb"]
    end = scr.numel() - a4(2 * B * H) - a4(-(-d // 16) * B * nb)
    x2_k = scr[end - B * d:end].view(B, d)
    act_k = scr[end - B * d - B * ff:end - B * d].view(B, ff)
    x1_k = scr[end - 2 * B * d - B * ff:end - B * d - B * ff].view(B, d)
    # the plain version end to end, its dots recorded (per slot: q, k, v,
    # o, gate, up, down)
    dots, dot = [], ref._dot

    def rec(a, w):
        out = dot(a, w)
        dots.append((a, out))
        return out
    ref._dot = rec
    try:
        y_r = ref.decode_block_ref(*args, **kw)[0][:, 0]
    finally:
        ref._dot = dot
    assert len(dots) == 7 * B, len(dots)
    bf = torch.bfloat16
    n2, mlp = block["n2"], block["mlp"]
    act = ref._ACTS[kw["act_name"]]
    x1_r = torch.stack([x[b, 0] + dots[7 * b + 3][1][0] for b in range(B)])
    act_r = torch.stack([dots[7 * b + 6][0][0] for b in range(B)])
    down_r = torch.stack([dots[7 * b + 6][1][0] for b in range(B)])
    x2_r = x1_r + down_r
    # each stage from the kernel's own input, slot by slot as the plain
    # version runs it
    x1b, actb, x2b = (t.to(bf) for t in (x1_k, act_k, x2_k))
    leaves = ref.ADAPTER_LEAVES[route]
    act_f, x2_f, y_f = [], [], []
    for b in range(B):
        h2 = ref._norm_row(x1b[b:b + 1], n2["scale"], n2.get("bias"),
                           kw["norm"])
        act_f.append(act(ref._dot(h2, mlp["wg"])) *
                     ref._dot(h2, mlp["wu"]))
        x2_f.append(x1b[b:b + 1] + ref._dot(actb[b:b + 1], mlp["wd"]))
        y_f.append(ref.adapter_row(x2b[b:b + 1], {
            k: masks[k][b] for k in leaves}, route, kw["adapter_act"]))
    act_f, x2_f, y_f = (torch.cat(t) for t in (act_f, x2_f, y_f))
    out = {}
    for name, got, own, e2e in (("x1", x1b, x1_r, x1_r),
                                ("act", actb, act_f, act_r),
                                ("x2", x2b, x2_f, x2_r),
                                ("y", y_k, y_f, y_r)):
        gap, gap_e = ((got.float() - t.float()).abs() for t in (own, e2e))
        steps = gap.max().item() / cs.bf16_step(
            max(own.float().abs().max().item(), 1e-30))
        assert steps <= cs.DEC_STEPS, ("#8 stage", name, steps)
        out[name] = dict(differ=int((gap > 0).sum()), of=gap.numel(),
                         max_abs=gap.max().item(), steps=steps,
                         end_to_end_differ=int((gap_e > 0).sum()),
                         end_to_end_max_abs=gap_e.max().item())
    gap = (y_k.float() - y_r.float()).abs()
    i = int(gap.argmax())
    b, c = divmod(i, d)
    out["worst"] = dict(
        slot=b, column=c, y_gap=gap.max().item(),
        y=(y_k[b, c].item(), y_r[b, c].item()),
        x1=(x1b[b, c].item(), x1_r[b, c].item()),
        down=down_r[b, c].item(), x2=(x2b[b, c].item(), x2_r[b, c].item()),
        max_abs=dict(x1=x1_r.float().abs().max().item(),
                     down=down_r.float().abs().max().item(),
                     y=y_r.float().abs().max().item()))
    return out


def music_path(torch, label, cfg, params, store, counters, B, check):
    """One (c) path held to its ref run: prefill and teacher-forced decode
    logits under phase 4's bounds, the first flip of each request
    explained, and, in every layer of the ref run, the kernels on that
    layer's own inputs held to their plain versions (``LayerCheck``; #8's
    worst call taken apart stage by stage, ``dec_stages``). The witness:
    the ref run again in float32 (the same weights, prefix rows and
    tokens). The decode-step logits meet E2E_STEPS; the prefill logits
    meet twice the ref run's own distance from float32 (``e2e_check``'s
    ``witness``): musicgen's largest prefill logit, ~3.7 over a
    vocabulary of 2,048, makes four bf16 steps of it 0.0625, under the
    ~0.12 that 48 layers of bf16 roundings moved the ref run's own
    logits. A decode step profiled."""
    from types import SimpleNamespace

    from repro_torch.utils.tree import tree_map

    gen = torch.Generator(device=DEV).manual_seed(15)
    P, d = cfg.num_prefix_tokens, cfg.d_model
    toks = torch.randint(0, cfg.vocab_size, (B, MUSIC_T), generator=gen,
                         device=DEV, dtype=torch.int32)
    prefix = torch.randn((B, P, d), generator=gen, device=DEV).to(
        torch.bfloat16)
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    got, pre_k, _, launches, ms, _ = music_run(torch, cfg, params, store,
                                               counters, toks, prefix)
    dt = time.perf_counter() - t
    check(launches)
    peak = torch.cuda.max_memory_allocated()
    ref_cfg = cfg.with_xpeft(kernel_impl="ref")
    layers = LayerCheck(torch)
    try:
        want, pre_r, dec_r, ref_launches, _, _ = music_run(
            torch, ref_cfg, params, store, counters, toks, prefix)
    finally:
        layers.close()
    assert not any(ref_launches.values()), ref_launches
    assert all(layers.calls[k] == v for k, v in launches.items()
               if k in layers.calls), (layers.calls, launches)
    cs.log(f"  {label}: the kernels on every layer's own inputs of the ref "
           f"run: {layers.calls} calls, worst |kernel - plain| "
           f"{layers.worst}, largest share of the bound {layers.share} "
           "(within phase 3's bounds)")
    stages = None
    if layers.worst_call is not None:
        stages = dec_stages(torch, *layers.worst_call)
        cs.log(f"  {label}: #8's call nearest its bound, by stage (kernel "
               f"against the plain stage fed the kernel's own input; end "
               f"to end): " + json.dumps(stages))
    _, _, dec_k, _, _, (dev_ms, n_kernels) = music_run(
        torch, cfg, params, store, counters, toks, prefix, forced=want,
        profiled=True)
    _, pre_b, dec_b, _, _, _ = music_run(torch, ref_cfg, params, store,
                                         counters, toks, prefix,
                                         forced=want, bare=True)
    p32 = tree_map(lambda t: t.float() if t.is_floating_point() else t,
                   params)
    _, pre_w, dec_w, _, _, _ = music_run(
        torch, ref_cfg.with_(dtype="float32"), p32, store, counters, toks,
        prefix, forced=want)
    del p32
    witness = dict(prefill=(pre_r - pre_w).abs().max().item(),
                   decode=(dec_r - dec_w).abs().max().item(),
                   kernel_prefill=(pre_k - pre_w).abs().max().item(),
                   kernel_decode=(dec_k - dec_w).abs().max().item())
    cs.log(f"  {label}: float32 witness max|d logit|: ref run "
           f"{witness['prefill']:.4e} prefill, {witness['decode']:.4e} "
           f"decode; kernel run {witness['kernel_prefill']:.4e} / "
           f"{witness['kernel_decode']:.4e}")
    e2e = dict(prefill=cs.e2e_check(f"{label} prefill logits", pre_k, pre_r,
                                    pre_b, witness=witness["prefill"]),
               decode=cs.e2e_check(f"{label} decode-step logits, teacher-"
                                   f"forced ({B} x {MUSIC_NEW - 1})", dec_k,
                                   dec_r, dec_b),
               float32=witness,
               layers=dict(calls=layers.calls, worst=layers.worst,
                           share=layers.share, stages=stages))
    reqs = [SimpleNamespace(uid=i, generated=got[i].tolist())
            for i in range(B)]
    ref_reqs = [SimpleNamespace(uid=i, generated=want[i].tolist())
                for i in range(B)]
    agree, total = cs.explain_divergence(torch, reqs, ref_reqs,
                                         (pre_k, pre_r), (dec_k, dec_r))
    toks_out = B * MUSIC_NEW
    cs.log(f"forms (c) {label}: B={B} T={MUSIC_T} P={P}: {toks_out} tokens "
           f"in {dt:.3f}s = {toks_out / dt:.1f} tok/s; host {ms:.3f} ms a "
           f"decode step; launches {launches}; greedy agree {agree}/{total};"
           f" a decode step on the card {dev_ms:.4f} ms in "
           f"{n_kernels:.0f} kernels (busy share {dev_ms / ms:.4f}); peak "
           f"memory {peak / 2**30:.2f} GiB")
    return dict(tok_s=toks_out / dt, decode_wall_ms=ms, launches=launches,
                greedy_agree_ref=agree / total, e2e=e2e,
                decode_device_ms=dev_ms, decode_kernels=n_kernels,
                busy_share=dev_ms / ms, peak_bytes=peak)


def phase_music(torch, counters):
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.models import init_lm

    P, d = get_config(MUSICGEN).num_prefix_tokens, \
        get_config(MUSICGEN).d_model

    def with_prefix(state, batch):
        rng = np.random.default_rng(16)
        batch["prefix_embeds"] = rng.normal(size=(
            batch["tokens"].shape[0], P, d)).astype(np.float32)
    step = cs.phase_train_step_vs_cpu(
        torch, cfg=get_config(MUSICGEN).with_(num_layers=2, dtype="float32")
        .with_xpeft(max_profiles=8), prepare=with_prefix,
        label="forms (c) train, prefix_embeds")
    cfg = get_config(MUSICGEN).with_(num_layers=MUSIC_LAYERS)
    L = cfg.num_layers
    params = init_lm(cfg, seed=0, device=DEV)
    n_w = tree_bytes({k: v for k, v in params.items() if k != "xpeft_bank"})
    n_bank = tree_bytes(params["xpeft_bank"])
    cs.log(f"forms (c): {cfg.name} L={L} of 48 d={cfg.d_model} "
           f"H={cfg.num_heads} "
           f"hd={cfg.head_dim} ff={cfg.d_ff} V={cfg.vocab_size} P={P}: "
           f"{n_w / 1e9:.2f} GB of weights + {n_bank / 1e9:.2f} GB of bank")
    store = store_for(cfg)

    def composed(n):
        assert n["mask_aggregate_batched"] == 2, n
        assert n["fused_adapter_batched"] == L * MUSIC_NEW, n
        assert n["decode_block_fused"] == 0, n

    def fused(n):
        assert n["mask_aggregate_batched"] == 2, n
        assert n["fused_adapter_batched"] == L, n
        assert n["decode_block_fused"] == L * (MUSIC_NEW - 1), n
    out = dict(weights_bytes=n_w, bank_bytes=n_bank, train_step=step)
    out["composed"] = music_path(torch, "composed", cfg, params, store,
                                 counters, 4, composed)
    out["decode_fused"] = music_path(torch, "decode_fused B=8",
                                     cfg.with_(decode_fused=True), params,
                                     store, counters, 8, fused)
    out["runs"] = {"composed": out["composed"]["launches"],
                   "decode_fused": out["decode_fused"]["launches"]}
    del params
    return out


# ----------------------------------------------------------------------------
# phase 13
# ----------------------------------------------------------------------------

def phase_forms(torch, parts="dabc"):
    """Phase 13 (see the module doc), or only its ``parts`` (letters of
    "dabc", run in that order). Returns its numbers: per run the launches
    of every kernel (``runs``), #8's rows at the new instantiations and
    #1/#2's at gemma3-27b's shapes."""
    from repro_torch.kernels import decode_fused as KD
    from repro_torch.kernels import ref
    from repro_torch.quant import schemes as QS

    t0 = time.perf_counter()
    secs, lap = {}, [t0]

    def mark(name):
        now = time.perf_counter()
        secs[name] = now - lap[0]
        lap[0] = now
        gc.collect()
        torch.cuda.empty_cache()

    cs.log(f"phase 13 starts with {torch.cuda.memory_allocated() / 2**30:.3f}"
           " GiB allocated")
    counters = cs.kernel_counters()
    out = dict(runs={}, kernel_rows=dict(agg=[], fa=[], dec=[], faq=[]))
    for part, name, prefix, fn in (
            ("d", "decode_rows", None, lambda: dec_rows(torch, KD, ref, QS)),
            ("a", "gemma", "gemma-2b", lambda: phase_gemma(torch, counters)),
            ("b", "gemma3", "gemma3", lambda: phase_gemma3(torch, counters)),
            ("c", "music", "musicgen", lambda: phase_music(torch, counters))):
        if part not in parts:
            continue
        got = fn()
        mark(part)
        if part == "d":
            out[name] = out["kernel_rows"]["dec"] = got
            continue
        out["runs"].update({f"{prefix} {k}": v
                            for k, v in got.pop("runs").items()})
        out["kernel_rows"].update(got.pop("kernel_rows", {}))
        out[name] = got
    secs["all"] = time.perf_counter() - t0
    cs.log("phase 13: " + f"{secs['all']:.1f}s (" + ", ".join(
        f"({k}) {v:.1f}s" for k, v in secs.items() if k != "all") + ")")
    out["seconds"] = secs
    return out


def main():
    """``python3 tools/forms_phase.py [PARTS]``: PARTS letters of "dabc"
    (default all)."""
    import torch
    if not torch.cuda.is_available():
        print("forms_phase: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(HERE, "src"))
    from repro_torch.kernels import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = cs.nvidia_smi()
    cs.log(f"device: {smi} | torch {torch.__version__} cuda "
           f"{torch.version.cuda}")
    _build.build()
    _build.load_library()
    out = phase_forms(torch, sys.argv[1] if len(sys.argv) > 1 else "dabc")
    cs.log(json.dumps({"forms": out, "device": smi}, default=str))
    return 0


if __name__ == "__main__":
    sys.exit(main())
