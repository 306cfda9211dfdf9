"""``chip_smoke.py``'s phase 14 (the recurrent block families: rwkv6-7b's
RWKV6 and zamba2-1.2b's Mamba2 with a shared attention block, on the
shared chunked linear attention) on the card; run alone:

    python3 tools/recurrent_phase.py [PARTS]

(PARTS: letters of "dabc", default all.) Builds the kernels, turns TF32
off as ``chip_smoke.py`` does and runs
``phase_recurrent``: bf16, random weights from seed 0, bank N=256, b=64,
k=50, in this order (each model freed before the next).

(d) #1 at rwkv6-7b's bank [8192, 4096, 64] (A and B sides, P=128, k=50),
    #2 on layer slices at d=4096, b=64, B=4, T=1 and 16, #5/#6 int8 at
    d=4096, and the hetero launch (bottleneck -> LoRA -> IA3) at d=4096,
    T=1 and 16: each held to its plain version with phase 3's bounds (the
    hetero launch each stage alone, and all three bitwise the CUDA
    sequence #2 -> #2 -> #7 with #2 on the launch's cluster size of 16),
    timed beside its bound, its plain version and (#1) embedding_bag.
(a) the chunked linear attention (plain torch, as JAX computes it without
    a Pallas kernel) against the naive fp32 recurrence token by token:
    rwkv6-7b's shape (B=2, 64 heads, dk = dv = 64, T=1,024, chunk 128)
    with and without the bonus, the same at strong decay (lw at LW_MIN:
    nothing overflows), zamba2-1.2b's (64 heads, n=64, p=64, one decay per
    head), ``gla_decode_step`` continuing a 1,024-token chunked prefix,
    and the refusal at T=20; both timed.
(b) rwkv6-7b at full width (d=4096, d_ff 14,336, 64 heads, vocab 65,536;
    15.0 GB of weights and an 8.6 GB bank): one xpeft step card against
    CPU at 2 layers (float32) under phase 7's bounds, the gradients'
    under RWKV_GRAD_REL_L2 (the model's own float32 noise floor is above
    phase 7's), and the same step in float64 on both devices, the card's
    loss and gradients within chip_smoke's TRAIN_F64_REL of the CPU's;
    then on its first RWKV_LAYERS = 8 of 32 layers (the call's time)
    phase 4's workload composed through
    ``chip_smoke.drive_path`` (held to its ``kernel_impl="ref"`` run under
    phase 4's bounds, a decode step profiled and split by op class:
    projections, adapter kernels, the rest), one batch of four 1,024-token
    prompts at exact length (one prefill batch of occupancy 1.0, chunk
    128); then on its first RWKV_CUT = 8 layers (the call's time): int8
    (#5, #6) held to its ref run, a heterogeneous bank (115 bottleneck /
    115 LoRA / 26 IA3 slots: the hetero launch) held to its ref run,
    continuous tokens bitwise the windowed run's on prompts of distinct
    lengths (no page pool: rwkv has no sequence-axis cache leaf), and on
    phase 9's workload every parting request first differing at a prefill
    batched otherwise, ``decode_fused=True`` bitwise composed with #8
    launched 0 times. Every serving path is held to its ref run under
    twice a float32 witness (``fp32_witness``): at random init the bf16
    model's own rounding, amplified with depth, is far above E2E_STEPS.
(c) zamba2-1.2b at full width (d=2048) and ZAMBA_LAYERS = 14 of its 38
    layers (two groups with the shared block and a remainder of two that
    skips it; the call's time): one step card against
    CPU at 6 layers (one group and the shared block), composed held to
    its ref run (no int8 run, for the call's time: rwkv6-7b's covers #5
    and #6 on the recurrent path), continuous on max_pages=8 (preemptions > 0)
    bitwise windowed on (b)'s distinct prompt lengths, ``decode_fused=True``
    bitwise composed with #8 launched 0 times.

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
import forms_phase  # noqa: E402
import moe_phase  # noqa: E402

RWKV, ZAMBA = "rwkv6-7b", "zamba2-1.2b"
# rwkv6-7b's depth on the card (of 32): its composed run and 1,024-token
# batch; its int8, hetero, continuous and decode_fused runs take the first
# RWKV_CUT. zamba2-1.2b's serving depth (of 38). All for the call's time.
RWKV_LAYERS = 8
RWKV_CUT = 8
ZAMBA_LAYERS = 14
HETERO_SPEC = (("bottleneck", 115), ("lora", 115), ("ia3", 26))
# the chunked GLA against the naive fp32 recurrence: both fp32, other
# summation orders over 1,024 tokens of unit-normal q, k, v
GLA_RTOL = GLA_ATOL = 1e-3
LONG_T, LONG_N = 1024, 4
# rwkv6-7b's card-vs-CPU float32 gradient bound: at random init its
# float32 gradients lie up to 3.94e-3 relative L2 from its float64 ones
# (the card's or the CPU's, whichever the draw favours: ``tools/
# grad_floor.py`` over 5 draws at vocab 8,192 and 65,536, 2 layers at full
# width), so two float32 runs each within that lie within twice it of each
# other (phase 7's 1e-3 lies under the floor). The step also runs in
# float64 on both devices under chip_smoke's TRAIN_F64_REL, the check that
# binds. zamba2-1.2b keeps phase 7's bound.
RWKV_GRAD_REL_L2 = 8e-3
# zamba2-1.2b's continuous pool: one max-length request's 8 pages (max_seq
# 128, pages of 16), so two long requests (43-52 tokens) and two short
# ones overflow it and the youngest is preempted
ZAMBA_PAGES = 8
# the device the GLA checks and the models live on (a CPU rehearsal sets
# "cpu")
DEV = "cuda"
tree_bytes = moe_phase.tree_bytes
# the engines' profile cache: every profile's entry held (see ``drive``)
CACHE = dict(cache_bytes=1 << 30)


# ----------------------------------------------------------------------------
# (d) the kernels at rwkv6-7b's shapes
# ----------------------------------------------------------------------------

def hetero_rows(torch, d=4096, b=64, B=4):
    """The hetero launch, all three stages on layer slices in bf16, at
    T=1 and 16: bitwise the CUDA sequence #2 -> #2 -> #7 with #2 on the
    launch's cluster size, each stage of it within its bounds
    (``chip_smoke.check_hetero``), two calls bitwise; timed as cold graph
    replays beside the sequence on #2's own cluster size (the composed
    path without the launch), the plain composition and the bound."""
    from repro_torch.kernels import fused_adapter_batched as KF
    from repro_torch.kernels import hetero_adapter as KH
    from repro_torch.kernels import ia3_apply as KI
    from repro_torch.kernels import ref

    gen = torch.Generator(device="cuda").manual_seed(15)
    rows = []
    for T in (1, 16):
        sets = [cs.hetero_operands(torch, gen, B, T, d, b, torch.bfloat16,
                                   False) for _ in range(32)]
        x0, ops0 = sets[0]
        clusters = KH.plan(d, [b, b], T, x0.element_size(),
                           ops0["ia3"].element_size())
        label = f"rwkv B={B} T={T} d={d} b=r={b} bf16, all three stages"
        # #2 on the launch's cluster size (two matmul stages at d=4096 take
        # 16, #2 alone 8): the sequence then sums in the launch's order
        plan, KF.plan = KF.plan, lambda *args: clusters
        try:
            err = cs.check_hetero(torch, KH, KF, KI, ref, x0, ops0, label)
        finally:
            KF.plan = plan
        again = KH.hetero_adapter_batched(x0, **ops0)
        assert torch.equal(KH.hetero_adapter_batched(x0, **ops0), again)
        sets = [(x, o["bottleneck"], o["lora"], o["ia3"]) for x, o in sets]

        def fused(x, bn, lo, s):
            return KH.hetero_adapter_batched(x, bottleneck=bn, lora=lo,
                                             ia3=s)

        def sequence(x, bn, lo, s):
            return cs.hetero_sequence(KF, KI, x, bn, lo, s)

        def plain(x, bn, lo, s):
            return ref.hetero_adapter_batched_ref(x, bottleneck=bn, lora=lo,
                                                  ia3=s)
        ms = cs.device_ms(torch, cs.rotating(fused, sets), calls=len(sets))
        seq_ms = cs.device_ms(torch, cs.rotating(sequence, sets),
                              calls=len(sets))
        plain_ms = cs.device_ms(torch, cs.rotating(plain, sets),
                                calls=len(sets))
        x, bn, lo, s = sets[0]
        nbytes = 2 * x.numel() * x.element_size() \
            + sum(t.numel() * t.element_size() for t in (*bn, *lo, s))
        flops = 2 * 4 * B * T * d * b + 2 * B * T * d
        bound_ms, bound_by = cs.bound(nbytes, flops, "bfloat16")
        cs.log(f"hetero_adapter_batched {label} (clusters of {clusters}): "
               f"ms {ms:.5f} (cold) | the sequence {seq_ms:.5f} | plain "
               f"{plain_ms:.5f} | bound {bound_ms:.6f} ({bound_by}: "
               f"{nbytes / 1e6:.3f} MB)")
        rows.append(dict(shape=label, max_abs_err=err, ms=ms,
                         plain_ms=plain_ms, bound_ms=bound_ms,
                         bound_by=bound_by, library_ms=None,
                         sequence_ms=seq_ms, clusters=clusters))
        del sets
    return rows


def kernel_rows(torch):
    rows = moe_phase.kernel_rows(torch, name="rwkv", d=4096, L=32,
                                 fa_ts=(1, 16), seed=16)
    rows["hetero"] = hetero_rows(torch)
    gc.collect()
    torch.cuda.empty_cache()
    return rows


# ----------------------------------------------------------------------------
# (a) the chunked linear attention
# ----------------------------------------------------------------------------

def naive(torch, q, k, v, lw, bonus=None, state=None):
    """The recurrence token by token in fp32 (JAX's test's ``naive``)."""
    from repro_torch.models.linear_attn import clamp_lw
    B, H, T, dk = q.shape
    lw = clamp_lw(lw.float())
    S = torch.zeros((B, H, dk, v.shape[-1]), device=q.device) \
        if state is None else state
    outs = []
    for t in range(T):
        kv = k[:, :, t, :, None].float() * v[:, :, t, None, :].float()
        qt = q[:, :, t, None, :].float()
        if bonus is None:
            S = S * torch.exp(lw[:, :, t])[..., None] + kv
            outs.append((qt @ S)[:, :, 0])
        else:
            outs.append((qt @ (S + bonus[None, :, :, None] * kv))[:, :, 0])
            S = S * torch.exp(lw[:, :, t])[..., None] + kv
    return torch.stack(outs, 2), S


def gla_inputs(torch, gen, B, H, T, dk, dv, strong=False, per_head=False):
    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=DEV)
    q, k, v = rnd(B, H, T, dk), rnd(B, H, T, dk), rnd(B, H, T, dv)
    if per_head:  # mamba2: one decay per head and token, across n
        lw = (-0.3 * torch.exp(rnd(B, H, T, 1))).expand(B, H, T, dk)
    else:
        lw = -(3.0 if strong else 0.3) * torch.exp(rnd(B, H, T, dk))
    return q, k, v, lw, 0.5 * rnd(H, dk)


def gla_check(torch, label, got, want):
    (o, s), (no, ns) = got, want
    assert torch.isfinite(o).all() and torch.isfinite(s).all(), label
    err_o = (o - no).abs().max().item()
    err_s = (s - ns).abs().max().item()
    ok = bool(((o - no).abs() <= GLA_ATOL + GLA_RTOL * no.abs()).all()
              and ((s - ns).abs() <= GLA_ATOL + GLA_RTOL * ns.abs()).all())
    cs.log(f"  gla {label}: max|d o| {err_o:.3e} (max|o| "
           f"{no.abs().max().item():.3f}), max|d state| {err_s:.3e}; within "
           f"rtol/atol {GLA_RTOL} {ok}")
    assert ok, (label, err_o, err_s)
    return dict(max_abs_err=err_o, state_max_abs_err=err_s)


def phase_gla(torch):
    from repro_torch.models import linear_attn as LA
    gen = torch.Generator(device=DEV).manual_seed(17)
    out = {}
    B, H, T, d = 2, 64, LONG_T, 64
    for name, kw, bonus in (("rwkv bonus", {}, True),
                            ("rwkv no bonus", {}, False),
                            ("rwkv strong decay", dict(strong=True), True),
                            ("zamba", dict(per_head=True), False)):
        q, k, v, lw, u = gla_inputs(torch, gen, B, H, T, d, d, **kw)
        if kw.get("strong"):
            lw = torch.full_like(lw, 4 * LA.LW_MIN)  # clamped to LW_MIN
        u = u if bonus else None
        got = LA.gla_chunked(q, k, v, lw, chunk=128, bonus=u)
        out[name] = gla_check(torch, f"{name} B={B} H={H} T={T} d={d} chunk "
                              "128", got, naive(torch, q, k, v, lw, u))
        out[name]["ms"] = cs.device_ms(torch, lambda: LA.gla_chunked(
            q, k, v, lw, chunk=128, bonus=u), calls=2, reps=3)
        cs.log(f"    gla_chunked {name}: {out[name]['ms']:.4f} ms (device)")
    # the decode step continuing a chunked prefix of 1,024 tokens
    q, k, v, lw, u = gla_inputs(torch, gen, B, H, T + 1, d, d)
    _, pre = LA.gla_chunked(q[:, :, :T], k[:, :, :T], v[:, :, :T],
                            lw[:, :, :T], chunk=128, bonus=u)
    o, s = LA.gla_decode_step(q[:, :, T], k[:, :, T], v[:, :, T],
                              lw[:, :, T], pre, bonus=u)
    no, ns = naive(torch, q, k, v, lw, u)
    out["decode step"] = gla_check(torch, f"decode step after {T}",
                                   (o, s), (no[:, :, -1], ns))
    q4, k4, v4, lw4 = (t[:, :, 0] for t in
                       gla_inputs(torch, gen, 4, H, 1, d, d)[:4])
    st = torch.zeros((4, H, d, d), device=DEV)
    out["decode step"]["ms_b4"] = cs.device_ms(
        torch, lambda: LA.gla_decode_step(q4, k4, v4, lw4, st, bonus=u),
        calls=32, reps=5)
    cs.log(f"    gla_decode_step B=4 H={H} 64x64: "
           f"{out['decode step']['ms_b4']:.5f} ms (device)")
    try:
        LA.gla_chunked(*(t[:, :, :20] for t in (q, k, v, lw)), chunk=128)
    except ValueError as e:
        cs.log(f"  gla T=20 at chunk 128 refused: {e}")
        out["refuses_t20"] = True
    assert out.get("refuses_t20")
    return out


# ----------------------------------------------------------------------------
# serving helpers
# ----------------------------------------------------------------------------

def store_for(cfg, n=4, **kw):
    from repro_torch.core import xpeft as XP
    from repro_torch.core.profiles import ProfileStore
    xp = cfg.xpeft
    table = XP.init_profile_table(cfg.with_xpeft(max_profiles=n), seed=0)
    store = ProfileStore(cfg.num_layers, xp.num_adapters, xp.bottleneck,
                         xp.mask_type, xp.k, **kw)
    for pid in range(n):
        store.add_profile(pid, {k: v[pid] for k, v in table.items()})
    return store


def cut(cfg, params, L):
    """The first L layers' weights and bank (views) and their config."""
    from repro_torch.utils.tree import tree_map
    return cfg.with_(num_layers=L), dict(params, **{
        k: tree_map(lambda t: t[:L], params[k])
        for k in ("blocks", "xpeft_bank") if k in params})


OP_CLASSES = (("adapter kernels", ("fused_adapter", "mask_aggregate",
                                   "hetero_adapter", "ia3_apply",
                                   "decode_block")),
              ("projections (GEMM/GEMV)", ("gemm", "gemv", "xmma", "cutlass",
                                           "sm90", "splitk", "cublas",
                                           "nvjet")))


def step_split(torch, cfg, params, store, label, steps=8):
    """One decode step (4 slots, T=1) under torch.profiler tracing the
    card: device ms by op class (projections, adapter kernels, the rest:
    GLA, token shift, norms, gates and other elementwise work), host wall
    ms without the profiler, busy share and tok/s."""
    from repro_torch.serve import Request, ServeEngine
    eng = ServeEngine(cfg, params, store, **cs.CB_ENGINE)
    eng.submit(cs.make_requests(Request, cfg.vocab_size, n=4, max_new=64))
    eng.admit_many(eng.scheduler.next_batch(4))
    for _ in range(3):
        eng.step()
    eng.sync()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(steps):
        eng.step()
    eng.sync()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t) / steps * 1e3

    def run():
        for _ in range(steps):
            eng.step()
        eng.sync()

    rows = cs.trace_card(torch, run, f"decode step {label}")
    split = {}
    for e in rows:
        name = e.key.lower()
        cls = next((c for c, keys in OP_CLASSES
                    if any(k in name for k in keys)), "the rest")
        ms, n = split.get(cls, (0.0, 0.0))
        split[cls] = (ms + e.self_device_time_total / 1e3 / steps,
                      n + e.count / steps)
    dev = sum(ms for ms, _ in split.values())
    assert dev > 0, "the profiler traced no kernel"
    cs.log(f"decode step {label} (B=4, T=1): host wall {wall:.3f} ms "
           f"without the profiler, device {dev:.4f} ms (busy share "
           f"{dev / wall:.4f}, {4e3 / wall:.1f} tok/s): "
           + "; ".join(f"{c} {ms:.4f} ms in {n:.0f} kernels"
                       for c, (ms, n) in sorted(split.items())))
    for e in sorted(rows, key=lambda e: -e.self_device_time_total)[:6]:
        cs.log(f"  {e.self_device_time_total / 1e3 / steps:.4f} ms/step "
               f"{e.count / steps:5.0f} launches/step  {e.key[:72]}")
    return dict(wall_ms=wall, device_ms=dev, busy_share=dev / wall,
                tok_s=4e3 / wall,
                split={c: dict(ms=ms, kernels=n)
                       for c, (ms, n) in split.items()})


def fp32_witness(torch, cfg, params):
    """``chip_smoke.drive_path``'s witness: the ref run's own max |d logit|
    from the same run in float32 (the blocks, embedding and head upcast;
    the requests' admitted entries taken from the ref engine, bf16 leaves
    upcast), on the logits the path holds: each request prefilled at its
    own length into its slot (the prefill logits), then 15 teacher-forced
    decode steps of all 8 slots on the ref run's tokens. A bf16 recurrent
    model at random init amplifies rounding with depth (rwkv6-7b's ref
    run lies 0.05 from float32 at 1 layer, 2.2 at 16), far above
    E2E_STEPS."""
    from repro_torch.models import model as MDL
    from repro_torch.utils.tree import tree_map

    ref_cfg = cfg.with_xpeft(kernel_impl="ref")
    cfg32 = cfg.with_(dtype="float32").with_xpeft(kernel_impl="ref")

    def up(t):
        return t.float() if t.dtype == torch.bfloat16 else t

    def witness(ref_eng, reqs):
        p32 = {k: v if k == "xpeft_bank" else tree_map(lambda t: t.float(), v)
               for k, v in params.items()}
        rows = [ref_eng.profile_cache.peek(r.profile_id) for r in reqs]
        masks = {k: torch.stack([row[k] for row in rows])
                 for k in ref_eng._entry_keys}
        runs = ((ref_cfg, params, masks),
                (cfg32, p32, {k: up(v) for k, v in masks.items()}))
        dev, B = params["embed"].device, len(reqs)
        pre, dec = [], []
        with torch.no_grad():
            for c, p, m in runs:
                cache = MDL.init_cache(c, B, 64, device=dev)
                first = []
                for i, r in enumerate(reqs):
                    mini = MDL.init_cache(c, 1, 64, device=dev)
                    h, _, _ = MDL.forward(
                        p, torch.from_numpy(r.prompt).to(dev)[None], c,
                        profile_masks={k: v[i:i + 1] for k, v in m.items()},
                        cache=mini, cache_pos=0)
                    first.append(MDL.lm_logits(p, h[:, -1:], c)[0, -1]
                                 .float())
                    for k in cache:
                        cache[k][:, i] = mini[k][:, 0]
                pre.append(torch.stack(first))
                pos = torch.tensor([len(r.prompt) for r in reqs],
                                   dtype=torch.int32, device=dev)
                steps = []
                for t in range(len(reqs[0].generated) - 1):
                    feed = torch.tensor([[r.generated[t]] for r in reqs],
                                        dtype=torch.int32, device=dev)
                    h, cache, _ = MDL.forward(p, feed, c, profile_masks=m,
                                              cache=cache, cache_pos=pos)
                    steps.append(MDL.lm_logits(p, h, c)[:, -1].float())
                    pos = pos + 1
                dec.append(torch.stack(steps, 1))
                del cache
        w = tuple((a - b).abs().max().item() for a, b in (pre, dec))
        cs.log(f"  float32 witness: the ref run's own max|d logit| from "
               f"float32 {w[0]:.4e} (prefill), {w[1]:.4e} (decode)")
        del p32
        gc.collect()
        torch.cuda.empty_cache()
        return w
    return witness


def drive(torch, label, cfg, params, store, counters, check, out, runs):
    """``chip_smoke.drive_path`` with a profile cache that holds all 4
    profiles' entries (1.05 MB a layer each at rwkv6-7b's d=4096; the
    engine's default 64 MB holds one at 32 layers), as the path's checks
    read them; the prefill logits those of the runs' own exact-length
    admission waves (``own_prefill``: one padded bucket takes another
    chunk, whose rounding the model amplifies); the logits held under
    twice the float32 witness (``fp32_witness``); phase 4's
    adapters'-share bound asserted as it is."""
    t = time.perf_counter()
    _, _, n, stats = cs.drive_path(torch, label, cfg, params, store,
                                   tuple(counters.items()), check,
                                   eng_kw=CACHE,
                                   own_prefill=True,
                                   witness=fp32_witness(torch, cfg, params))
    stats["launches"] = n
    stats["seconds"] = time.perf_counter() - t
    out[label.split(" ", 1)[1].replace(" ", "_")] = stats
    runs[label] = n
    gc.collect()
    torch.cuda.empty_cache()
    return stats


def distinct_requests(Request, vocab, n=12, long_new=40):
    """Phase 9's skewed workload with every prompt length distinct (3 +
    i tokens): each exact-length prefill batch holds one request whichever
    wave admits it, so windowed and continuous prefill each request on the
    same shape."""
    import numpy as np
    rng = np.random.default_rng(5)
    return [Request(uid=i, prompt=rng.integers(0, vocab, 3 + i),
                    profile_id=i % 3,
                    max_new_tokens=long_new if i % 3 == 0 else 2)
            for i in range(n)]


def windowed_vs_continuous(torch, label, cfg, params, store, counters, kw,
                           long_new, out, runs, phase9=True):
    """Continuous against windowed, and windowed with ``decode_fused=True``
    against windowed (#8 launched 0 times), bitwise, on
    ``distinct_requests`` (the same prefill shape for each request in both
    modes). On phase 9's own workload (lengths repeat) the two modes batch
    some prefills differently, and the bf16 model amplifies a GEMM's
    other rounding at another batch size: there every request whose
    tokens part must first differ at a prefill of another batch shape,
    with the flip explained by ``chip_smoke.cb_explain``'s rule (with
    ``phase9``; zamba2-1.2b skips it, for the call's time)."""
    from repro_torch.serve import Request
    base = dict(cfg=cfg, params=params, store=store, long_new=long_new)
    reqs = lambda: distinct_requests(Request, cfg.vocab_size,  # noqa: E731
                                     long_new=long_new)
    w = cs.cb_drain(torch, dict(base, continuous=False, kw={}), counters,
                    reqs=reqs())
    c = cs.cb_drain(torch, dict(base, continuous=True, kw=kw), counters,
                    reqs=reqs())
    f = cs.cb_drain(torch, dict(base, cfg=cfg.with_(decode_fused=True),
                                continuous=False, kw={}), counters,
                    reqs=reqs())
    forms_phase.launch_check(cfg.num_layers)(c["launches"], c["stats"],
                                             c["waves"])
    st = c["stats"]
    assert forms_phase.tokens_bitwise(c, w), cs.cb_explain(torch, c, w)
    assert forms_phase.tokens_bitwise(f, w), cs.cb_explain(torch, f, w)
    assert f["launches"]["decode_block_fused"] == 0, f["launches"]
    cs.log(f"{label} continuous: tokens bitwise the windowed run's on "
           f"distinct prompt lengths, {st['device_steps']} device steps "
           f"(windowed {w['stats']['device_steps']}), preemptions "
           f"{st['preemptions']}, resumes {st['resumes']}, pages "
           f"{st.get('pages')}, {c['tok_s']:.1f} tok/s (windowed "
           f"{w['tok_s']:.1f}); decode_fused=True: #8 launched 0 times, "
           f"tokens bitwise, {f['tok_s']:.1f} tok/s")
    out["continuous"] = dict(
        tok_s=c["tok_s"], windowed_tok_s=w["tok_s"],
        device_steps=st["device_steps"],
        windowed_device_steps=w["stats"]["device_steps"],
        preemptions=st["preemptions"], resumes=st["resumes"],
        paged=c["eng"]._paged, launches=c["launches"])
    out["decode_fused"] = dict(tok_s=f["tok_s"], launches=f["launches"])
    runs[f"{label} continuous"] = c["launches"]
    runs[f"{label} decode_fused"] = f["launches"]
    del w, c, f
    if phase9:
        # phase 9's workload: flips only behind a prefill of another shape
        w9 = cs.cb_drain(torch, dict(base, continuous=False, kw={}),
                         counters)
        c9 = cs.cb_drain(torch, dict(base, continuous=True, kw=kw),
                         counters)
        x9 = cs.cb_explain(torch, c9, w9)
        shapes = (c9["rec"]["shapes"], w9["rec"]["shapes"])
        for flip in x9["flips"]:
            uid = flip["uid"]
            assert flip["first_diverging_token"] == 0 \
                and shapes[0][uid] != shapes[1][uid], (flip, shapes)
        cs.log(f"{label} continuous on phase 9's workload: "
               f"{x9['agree']}/{x9['total']} tokens agree, "
               f"{len(x9['flips'])} requests part, each first at a prefill "
               "of another batch shape")
        out["continuous"]["phase9_workload"] = dict(
            agree=x9["agree"], total=x9["total"], flips=x9["flips"])
        del w9, c9
    gc.collect()
    return st


# ----------------------------------------------------------------------------
# (b) rwkv6-7b
# ----------------------------------------------------------------------------

def long_batch(torch, cfg, params, store, counters):
    """Four 1,024-token prompts: one exact-length prefill batch (occupancy
    1.0, the GLA at chunk 128), then 8 tokens each; timed."""
    import numpy as np

    from repro_torch.models.linear_attn import chunk_for
    from repro_torch.serve import Request, ServeEngine
    assert chunk_for(LONG_T, cfg.la_chunk) == cfg.la_chunk
    rng = np.random.default_rng(1)
    reqs = [Request(uid=i, prompt=rng.integers(0, cfg.vocab_size, LONG_T),
                    profile_id=i, max_new_tokens=8) for i in range(LONG_N)]
    eng = ServeEngine(cfg, params, store, max_slots=4, max_seq=2048,
                      sync_every=8)
    for fn in counters.values():
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t = time.perf_counter()
    eng.run_until_drained(list(reqs))
    torch.cuda.synchronize()
    dt = time.perf_counter() - t
    st = eng.serve_stats()
    n = {name: fn.launches for name, fn in counters.items()}
    L = cfg.num_layers
    cs.log(f"rwkv6-7b {LONG_N} x {LONG_T}-token prompts: prefill batches "
           f"{st['prefill_batches']}, occupancy {st['prefill_occupancy']}; "
           f"{dt:.3f}s for the drain ({LONG_N * LONG_T / dt:.0f} prompt "
           f"tokens/s with decode); launches {n}; peak memory "
           f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    assert st["prefill_batches"] == 1 and st["prefill_occupancy"] == 1.0
    assert all(r.done and len(r.generated) == 8 for r in reqs)
    assert n["fused_adapter_batched"] == L * (1 + st["device_steps"])
    assert n["mask_aggregate_batched"] == 2
    return dict(seconds=dt, prefill_batches=st["prefill_batches"],
                prefill_occupancy=st["prefill_occupancy"], launches=n,
                peak_bytes=torch.cuda.max_memory_allocated())


def hetero_check(L):
    def check(n, st, waves):
        steps, batches = st["device_steps"], st["prefill_batches"]
        aggregating = sum(w["path"] == "sparse" for w in waves)
        assert aggregating > 0 and n["mask_aggregate_batched"] > 0, n
        assert n["hetero_adapter_batched"] == L * (steps + batches) > 0, n
        others = set(n) - {"mask_aggregate_batched", "hetero_adapter_batched"}
        assert not any(n[k] for k in others), n
    return check


def phase_rwkv(torch, counters):
    from repro_torch.configs import get_config
    from repro_torch.core.adapters import init_hetero_bank
    from repro_torch.models import init_lm

    out, runs = {}, {}
    out["train_step_vs_cpu"] = cs.phase_train_step_vs_cpu(
        torch, cfg=get_config(RWKV).with_(num_layers=2, dtype="float32")
        .with_xpeft(max_profiles=8), label="recurrent (b) train",
        grad_rel_l2=RWKV_GRAD_REL_L2, float64=True)
    gc.collect()
    torch.cuda.empty_cache()
    cfg = get_config(RWKV).with_(num_layers=RWKV_LAYERS)
    t = time.perf_counter()
    params = init_lm(cfg, seed=0, device=DEV)
    torch.cuda.synchronize()
    n_w = tree_bytes({k: v for k, v in params.items() if k != "xpeft_bank"})
    n_bank = tree_bytes(params["xpeft_bank"])
    cs.log(f"recurrent (b): {cfg.name} L={cfg.num_layers} d={cfg.d_model} "
           f"H={cfg.num_heads} hd={cfg.head_dim} ff={cfg.d_ff} V="
           f"{cfg.vocab_size} la_chunk {cfg.la_chunk} {cfg.dtype}: "
           f"{n_w / 1e9:.2f} GB of weights + {n_bank / 1e9:.2f} GB of bank,"
           f" init {time.perf_counter() - t:.2f}s")
    out.update(weights_bytes=n_w, bank_bytes=n_bank)
    store = store_for(cfg)
    L = cfg.num_layers
    drive(torch, "rwkv composed", cfg, params, store, counters,
          forms_phase.launch_check(L), out, runs)
    out["decode_step"] = step_split(torch, cfg, params, store,
                                    "rwkv6-7b composed")
    out["long_prompts"] = long_batch(torch, cfg, params, store, counters)
    runs["rwkv long prompts"] = out["long_prompts"]["launches"]
    gc.collect()
    torch.cuda.empty_cache()
    # the cut runs: the first RWKV_CUT layers
    ccfg, cparams = cut(cfg, params, RWKV_CUT)
    xp = ccfg.xpeft
    drive(torch, "rwkv int8_composed", ccfg.with_xpeft(bank_quant="int8"),
          cparams, store_for(ccfg, quant="int8", quant_group=xp.quant_group),
          counters, forms_phase.launch_check(RWKV_CUT, quant=True), out,
          runs)
    hcfg = ccfg.with_xpeft(bank_spec=HETERO_SPEC)
    gen = torch.Generator(device=DEV).manual_seed(18)
    hparams = dict(cparams, xpeft_bank=init_hetero_bank(
        RWKV_CUT, hcfg.xpeft, hcfg.d_model, hcfg.kv_dim,
        cparams["embed"].dtype, generator=gen, device=DEV))
    drive(torch, "rwkv hetero_composed", hcfg, hparams,
          store_for(hcfg, bank_spec=HETERO_SPEC), counters,
          hetero_check(RWKV_CUT), out, runs)
    del hparams
    windowed_vs_continuous(torch, "rwkv", ccfg, cparams, store_for(ccfg),
                           counters, {}, 40, out, runs)
    del params, cparams
    return out, runs


# ----------------------------------------------------------------------------
# (c) zamba2-1.2b
# ----------------------------------------------------------------------------

def phase_zamba(torch, counters):
    from repro_torch.configs import get_config
    from repro_torch.models import init_lm

    out, runs = {}, {}
    out["train_step_vs_cpu"] = cs.phase_train_step_vs_cpu(
        torch, cfg=get_config(ZAMBA).with_(num_layers=6, dtype="float32")
        .with_xpeft(max_profiles=8), label="recurrent (c) train")
    gc.collect()
    torch.cuda.empty_cache()
    cfg = get_config(ZAMBA).with_(num_layers=ZAMBA_LAYERS)
    params = init_lm(cfg, seed=0, device=DEV)
    n_w = tree_bytes({k: v for k, v in params.items() if k != "xpeft_bank"})
    n_bank = tree_bytes(params["xpeft_bank"])
    cs.log(f"recurrent (c): {cfg.name} L={cfg.num_layers} d={cfg.d_model} "
           f"H={cfg.num_heads} ssm_state {cfg.ssm_state} shared attention "
           f"every {cfg.shared_attn_every} "
           f"({cfg.num_layers // cfg.shared_attn_every} invocations): "
           f"{n_w / 1e9:.2f} GB of weights + "
           f"{n_bank / 1e9:.2f} GB of bank")
    out.update(weights_bytes=n_w, bank_bytes=n_bank)
    store, L = store_for(cfg), cfg.num_layers
    drive(torch, "zamba composed", cfg, params, store, counters,
          forms_phase.launch_check(L), out, runs)
    st = windowed_vs_continuous(torch, "zamba", cfg, params, store, counters,
                                dict(max_pages=ZAMBA_PAGES), 40, out, runs,
                                phase9=False)
    assert st["preemptions"] > 0 and st["resumes"] > 0, st
    del params
    return out, runs


def phase_recurrent(torch, parts="dabc"):
    """Phase 14 (see the module doc), its ``parts`` (letters of "dabc") in
    that order. Returns its numbers: per run the launches of every kernel
    (``runs``) and the kernel rows at d=4096."""
    t0 = time.perf_counter()
    secs, lap = {}, [t0]

    def mark(name):
        now = time.perf_counter()
        secs[name] = now - lap[0]
        lap[0] = now

    counters = cs.kernel_counters()
    out, runs = {}, {}
    if "d" in parts:
        out["kernel_rows"] = kernel_rows(torch)
        mark("d kernels")
    if "a" in parts:
        out["gla"] = phase_gla(torch)
        mark("a gla")
    for part, name, fn in (("b", "rwkv", phase_rwkv),
                           ("c", "zamba", phase_zamba)):
        if part in parts:
            gc.collect()
            torch.cuda.empty_cache()
            out[name], more = fn(torch, counters)
            runs.update(more)
            mark(f"{part} {name}")
    out["runs"] = runs
    out["seconds"] = time.perf_counter() - t0
    out["part_seconds"] = secs
    cs.log(f"phase 14: {out['seconds']:.1f}s ("
           + ", ".join(f"{k} {v:.1f}" for k, v in secs.items()) + ")")
    assert all(n.get("decode_block_fused", 0) == 0 for n in runs.values())
    return out


def main():
    import torch
    if not torch.cuda.is_available():
        print("recurrent_phase: needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(HERE, "src"))
    from repro_torch.kernels import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = cs.nvidia_smi()
    cs.log(f"device: {torch.cuda.get_device_name(0)} | {smi}")
    t = time.perf_counter()
    _build.build(verbose=False)
    _build.load_library()
    cs.log(f"build {time.perf_counter() - t:.1f}s")
    out = phase_recurrent(torch, *sys.argv[1:2])
    cs.log(smi)
    cs.log(json.dumps({k: v for k, v in out.items()
                       if k != "kernel_rows"}, default=str))
    return 0


if __name__ == "__main__":
    sys.exit(main())
