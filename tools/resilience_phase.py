"""``chip_smoke.py``'s phase 10 (heterogeneous training forms, per-step
heterogeneous serving, fault plans with degraded admission, and
observability) on the card; run alone:

    python3 tools/resilience_phase.py

Builds the kernels, turns TF32 off as ``chip_smoke.py`` does and runs
``phase_resilience`` on qwen1.5-0.5b at full width, bf16, random weights
from seed 0:

(a) heterogeneous training: one xpeft step on the card against the CPU (2
    layers, float32) over the typed bank bottleneck 102 / LoRA 102 / IA3 26
    / prefix 26, P=8, one batch example's masks selecting no prefix slot,
    under phase 7's bounds; ten full-depth bf16 steps (8 profiles, B=8,
    T=64) timed and profiled; the trained profiles packed into a hard
    store and served precomputed (#1 and the hetero-adapter launch), held
    to their ``kernel_impl="ref"`` run under ``e2e_check``'s bounds.
(b) per-step heterogeneous serving over the same spec without its prefix
    segment (bottleneck 115 / LoRA 115 / IA3 26), hard and soft profiles,
    windowed and continuous at the same admission wave: tokens equal, no
    hand-written kernel launched; a decode step profiled.
(c) on the first ``OPS_LAYERS`` layers (as (d)):
    ``FaultPlan(fail_pids=(1,), flaky_pids=(2,), corrupt_pids=(4,))`` over
    6 profiles on bf16 composed, ``decode_fused``, int8 composed, hetero
    composed (prefix rows) and continuous composed on 10 pages (a degraded
    request preempted and resumed): every request done, the degraded set
    the plan's, retries > 0, one quarantined profile, peers bitwise the
    no-fault run, degraded requests bitwise the X-PEFT-disabled engine.
(d) observability on bf16 composed continuous and ``decode_fused``: obs on
    against off (tokens bitwise, host syncs equal), the metrics JSON and
    a Chrome trace exported and validated; TTFT p50/p95, trace categories,
    kernels and device ms per decode step with the slot accumulator
    removed, obs off and obs on.

Every failed check raises. Prints one JSON line of its numbers last.
Without a card it exits non-zero.
"""
import json
import math
import os
import statistics
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if HERE not in sys.path:
    sys.path.insert(0, HERE)

import chip_smoke as cs  # noqa: E402

# ten full-depth training steps, as phase 7's launcher defaults
TRAIN_STEPS, TRAIN_B, TRAIN_T, TRAIN_PROFILES = 10, 8, 64, 8
# fault plan (c): persistent, transient and corrupt profiles out of 6
FAULTS = dict(fail_pids=(1,), flaky_pids=(2,), corrupt_pids=(4,))
FAULT_PROFILES = 6
FAULT_PAGES = 10
# (c) and (d) serve the first OPS_LAYERS layers of ``cfg`` (the call's
# time): their checks are bitwise between runs of the same shapes
OPS_LAYERS = 6


def specs(cfg):
    """(training spec with a prefix segment, per-step spec without one):
    README's 40/40/10/10 mix over N adapters, and the same with the
    prefix slots given to the two matmul families."""
    N = cfg.xpeft.num_adapters
    if N == 256:
        train = cs.HETERO_SPEC
    else:
        bn = lo = round(0.4 * N)
        ia = round(0.1 * N)
        train = (("bottleneck", bn), ("lora", lo), ("ia3", ia),
                 ("prefix", N - bn - lo - ia))
    ia = dict(train)["ia3"]
    bn = (N - ia) // 2
    return train, (("bottleneck", bn), ("lora", N - ia - bn), ("ia3", ia))


def _launches(counters):
    return {name: fn.launches for name, fn in counters.items()}


def _zero(counters):
    for fn in counters.values():
        fn.launches = 0


def _store(cfg, table, n, **kw):
    from repro_torch.core.profiles import ProfileStore
    xp = cfg.xpeft
    store = ProfileStore(cfg.num_layers, xp.num_adapters, xp.bottleneck,
                         kw.pop("mask_type", xp.mask_type), xp.k,
                         bank_spec=xp.bank_spec, **kw)
    for pid in range(n):
        store.add_profile(pid, {k: v[pid] for k, v in table.items()})
    return store


def _steps_timed(torch, step, state, src, gen, n, B, T):
    """``n`` steps timed with CUDA events around each (host wall too),
    then 3 more under torch.profiler tracing the card only."""
    ev, walls, hist = [], [], []
    for i in range(n):
        batch = src.sample(i, B, T)
        torch.cuda.synchronize()
        t = time.perf_counter()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        state, m = step(state, batch, gen)
        b.record()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t) * 1e3)
        ev.append(a.elapsed_time(b))
        hist.append({k: float(v) for k, v in m.items()})
    box = dict(state=state, i=n)

    def steps():
        for _ in range(3):
            box["state"], _ = step(box["state"], src.sample(box["i"], B, T),
                                   gen)
            box["i"] += 1

    rows = cs.trace_card(torch, steps, "phase 10 (a) train step")
    state = box["state"]
    dev = sum(e.self_device_time_total for e in rows) / 1e3 / 3
    kernels = sum(e.count for e in rows) / 3
    return state, hist, ev, walls, dev, kernels


def step_profile(torch, cfg, params, store, label, eng_kw):
    """A decode step of 4 live slots: 1 warm-up step, 2 on the host clock,
    4 under the profiler (``cs.profile_decode``, shortened)."""
    from repro_torch.serve import Request, ServeEngine
    return cs.profile_decode(torch, ServeEngine, Request, cfg, params,
                             store, label, eng_kw, steps=(1, 2, 4))


# ----------------------------------------------------------------------------
# (a) heterogeneous training
# ----------------------------------------------------------------------------

def hetero_train(torch, cfg, counters):
    """(a): the card-vs-CPU step, ten full-depth steps, pack and serve."""
    from repro_torch.core.profiles import ProfileStore
    from repro_torch.data import MarkovLM
    from repro_torch.train import steps as ST

    spec, _ = specs(cfg)
    P = cs.HETERO_P
    hkw = dict(bank_spec=spec, prefix_tokens=P)
    off, cnt = next((o, c) for t, o, c in
                    cfg.with_xpeft(**hkw).xpeft.segments() if t == "prefix")
    pinned = {}

    def prepare(state, batch):
        # the first example's profile selects no prefix slot: its prefix
        # logits far below any top-k (0/0 in the renormalization)
        pid = int(batch["profile_ids"][0])
        pinned["pid"] = pid
        for m in ("mA", "mB"):
            state["trainable"]["table"][m][pid, :, off:off + cnt] = -30.0

    def check_w(w):
        for x in w:
            assert not x[0, :, off:off + cnt].any(), "prefix slot selected"
            assert x[1:, :, off:off + cnt].any()

    step_cfg = cfg.with_(num_layers=2, dtype="float32").with_xpeft(
        max_profiles=TRAIN_PROFILES, **hkw)
    vs_cpu = cs.phase_train_step_vs_cpu(torch, step_cfg, prepare, check_w,
                                        label="phase 10 (a) hetero")
    vs_cpu["no_prefix_profile"] = pinned["pid"]

    hcfg = cfg.with_xpeft(max_profiles=TRAIN_PROFILES, **hkw)
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    state = ST.init_train_state(hcfg, "xpeft", seed=0, device="cuda")
    for m in ("mA", "mB"):
        state["trainable"]["table"][m][1, :, off:off + cnt] = -30.0
    m0 = state["trainable"]["table"]["mA"].clone()
    step = ST.make_train_step(hcfg, "xpeft", lr=1e-3)
    src = MarkovLM(hcfg.vocab_size, TRAIN_PROFILES, seed=0)
    gen = torch.Generator(device="cuda").manual_seed(1)
    _zero(counters)
    state, hist, ev, walls, dev, kernels = _steps_timed(
        torch, step, state, src, gen, TRAIN_STEPS, TRAIN_B, TRAIN_T)
    launched = _launches(counters)
    total_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() - held
    ms, wall = statistics.median(ev[2:]), statistics.median(walls[2:])
    table = state["trainable"]["table"]
    moved = (table["mA"] - m0).abs().max().item()
    losses = [h["loss"] for h in hist]
    gnorms = [h["grad_norm"] for h in hist]
    cs.log(f"phase 10 (a): {TRAIN_STEPS} hetero xpeft steps, bank_spec "
           f"{spec} P={P}, L={hcfg.num_layers} {hcfg.dtype}, "
           f"B={TRAIN_B} T={TRAIN_T}: {total_s:.2f}s in all; loss "
           + " ".join(f"{v:.4f}" for v in losses))
    cs.log(f"  median of steps 3-{TRAIN_STEPS}: {ms:.3f} ms/step (CUDA "
           f"events; host wall {wall:.3f}), "
           f"{TRAIN_B * TRAIN_T / ms * 1e3:.0f} tokens/s; profiled: device "
           f"{dev:.3f} ms/step in {kernels:.0f} kernels/step -> busy share "
           f"{dev / ms:.4f}; peak {peak / 2**30:.3f} GiB above "
           f"{held / 2**30:.3f}; hand-written kernel launches {launched}")
    assert all(math.isfinite(v) for v in losses + gnorms)
    assert all(v > 0 for v in gnorms) and moved > 0
    assert not any(launched.values()), launched
    train = dict(steps=TRAIN_STEPS, batch=TRAIN_B, seq=TRAIN_T, losses=losses,
                 grad_norms=gnorms, ms_per_step=ms, ms_per_step_all=ev,
                 host_wall_ms_per_step=wall,
                 tokens_per_s=TRAIN_B * TRAIN_T / ms * 1e3,
                 device_ms_per_step=dev, kernels_per_step=kernels,
                 busy_share=dev / ms, peak_memory_bytes=peak,
                 mask_logits_moved=moved)

    # the trained profiles, packed hard, saved and loaded back, served
    # precomputed through #1 and the hetero-adapter launch
    store = _store(hcfg, table, TRAIN_PROFILES, mask_type="hard")
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "hetero.npz")
        store.save(path)
        back = ProfileStore.load(path)
    assert cs.stores_equal(back, store) and back.bank_spec == spec
    params = state["frozen"]
    del state, step, m0
    L = hcfg.num_layers
    names = ("mask_aggregate_batched", "fused_adapter_batched",
             "ia3_apply_batched", "hetero_adapter_batched",
             "mask_aggregate_quant_batched", "fused_adapter_quant_batched",
             "decode_block_fused")

    def check_launches(n, st, waves):
        sparse = sum(w["path"] == "sparse" for w in waves)
        assert sparse > 0 and n["mask_aggregate_batched"] == 10 * sparse, n
        assert n["hetero_adapter_batched"] == \
            L * (st["device_steps"] + st["prefill_batches"]) > 0, n
        assert not any(n[k] for k in names[1:3] + names[4:]), n

    eng, reqs, launches, served = cs.drive_path(
        torch, "phase 10 (a) trained hetero store", hcfg, params, back,
        tuple((k, counters[k]) for k in names), check_launches)
    served["launches"] = launches
    served["prefix_len"] = {r.uid: r.prefix_len for r in reqs}
    cs.log(f"  prefix rows per request {served['prefix_len']}")
    assert served["prefix_len"][1] == 0
    del eng, params
    torch.cuda.empty_cache()
    return dict(step_vs_cpu=vs_cpu, train=train, served=served)


# ----------------------------------------------------------------------------
# (b) per-step heterogeneous serving
# ----------------------------------------------------------------------------

def per_step_hetero(torch, cfg, counters):
    """(b): hard and soft profiles over the prefix-free spec, windowed and
    continuous, one admission wave of 4 requests; no hand-written kernel
    launches (each layer aggregates in torch ops)."""
    from repro_torch.core import xpeft as XP
    from repro_torch.models import init_lm
    from repro_torch.serve import Request

    _, spec = specs(cfg)
    pcfg = cfg.with_xpeft(bank_spec=spec)
    params = init_lm(pcfg, seed=0, device="cuda")
    table = XP.init_profile_table(pcfg.with_xpeft(max_profiles=4), seed=0)
    out = {}
    for mtype in ("hard", "soft"):
        store = _store(pcfg, table, 4, mask_type=mtype)
        toks = {}
        for continuous in (False, True):
            kw = dict(precompute=False)
            if continuous:
                kw.update(continuous=True, page_size=cs.CB_PAGE)
            else:
                cs.serve_once(torch, pcfg, params, store, cs.make_requests(
                    Request, pcfg.vocab_size, n=4, max_new=4), kw)
            reqs = cs.make_requests(Request, pcfg.vocab_size, n=4)
            _zero(counters)
            eng, steps, dt, waves = cs.serve_once(torch, pcfg, params, store,
                                                  reqs, kw)
            n = _launches(counters)
            assert len(waves) == 1 and waves[0]["path"] == "per_step"
            assert all(r.done and len(r.generated) == 16 for r in reqs)
            assert not any(n.values()), n
            mode = "continuous" if continuous else "windowed"
            toks[mode] = [r.generated for r in reqs]
            out[f"{mtype}_{mode}_drain_s"] = dt
            out[f"{mtype}_{mode}_device_steps"] = \
                eng.serve_stats()["device_steps"]
        agree = sum(a == b for x, y in zip(toks["windowed"],
                                           toks["continuous"])
                    for a, b in zip(x, y))
        cs.log(f"phase 10 (b) per-step {mtype} over {spec}: windowed and "
               f"continuous tokens agree {agree}/64; drains "
               f"{out[f'{mtype}_windowed_drain_s']:.3f}s / "
               f"{out[f'{mtype}_continuous_drain_s']:.3f}s; no kernel "
               "launched")
        assert toks["windowed"] == toks["continuous"]
        step = step_profile(torch, pcfg, params, store,
                            f"phase 10 (b) per-step {mtype}",
                            dict(precompute=False))
        out[mtype] = dict(tokens_equal=True, **step)
    out["spec"] = spec
    del params
    torch.cuda.empty_cache()
    return out


# ----------------------------------------------------------------------------
# (c) fault plans and degraded admission
# ----------------------------------------------------------------------------

def fault_requests(Request, vocab, long):
    """8 requests, profiles uid % 6, prompts of 3-12 tokens (per-uid
    seeds); 8 new tokens each, or 32 on the continuous path (each then
    grows to 3 pages: 4 live need 12 of its 10 pages)."""
    import numpy as np
    reqs = []
    for i in range(8):
        r = np.random.default_rng(1000 + i)
        reqs.append(Request(uid=i, prompt=r.integers(0, vocab,
                                                     int(r.integers(3, 13))),
                            profile_id=i % FAULT_PROFILES,
                            max_new_tokens=32 if long else 8))
    return reqs


def faults(torch, cfg, base, counters):
    """(c): each path under the plan, without it, and with X-PEFT
    disabled."""
    from repro_torch.core import xpeft as XP
    from repro_torch.models import init_lm
    from repro_torch.resilience import FaultPlan
    from repro_torch.serve import Request, ServeEngine

    spec, _ = specs(cfg)
    table = XP.init_profile_table(
        cfg.with_xpeft(max_profiles=FAULT_PROFILES), seed=0)
    h_cfg = cfg.with_xpeft(bank_spec=spec, prefix_tokens=cs.HETERO_P)
    h_params = init_lm(h_cfg, seed=0, device="cuda")
    h_table = XP.init_profile_table(
        h_cfg.with_xpeft(max_profiles=FAULT_PROFILES), seed=0)
    params = base["params"]
    paths = {
        "bf16": (cfg, params, table, {}, {}),
        "decode_fused": (cfg.with_(decode_fused=True), params, table, {},
                         {}),
        "int8": (cfg.with_xpeft(bank_quant="int8"), params, table, {},
                 dict(quant="int8", quant_group=cfg.xpeft.quant_group)),
        "hetero": (h_cfg, h_params, h_table, {}, {}),
        "continuous": (cfg, params, table,
                       dict(continuous=True, page_size=cs.CB_PAGE,
                            max_pages=FAULT_PAGES), {}),
    }
    plan = FaultPlan(**FAULTS)
    pids = list(range(FAULT_PROFILES))
    expect = set(plan.persistent_fail_pids(pids)) | set(plan.corrupt_pids)
    out = {}
    for name, (pcfg, pparams, ptable, ekw, skw) in paths.items():
        long = name == "continuous"
        runs = {}
        for run in ("fault", "clean", "bare"):
            rcfg = pcfg.with_xpeft(enabled=False) if run == "bare" else pcfg
            store = _store(rcfg, ptable, FAULT_PROFILES, **skw)
            kw = dict(ekw)
            if run == "fault":
                kw["fault_plan"] = plan
                plan.corrupt_store(store)
            eng = ServeEngine(rcfg, pparams, store, max_slots=4,
                              max_seq=128, sync_every=8, **kw)
            reqs = fault_requests(Request, rcfg.vocab_size, long)
            _zero(counters)
            torch.cuda.synchronize()
            t = time.perf_counter()
            eng.run_until_drained(list(reqs))
            torch.cuda.synchronize()
            runs[run] = dict(eng=eng, reqs=reqs, st=eng.serve_stats(),
                             dt=time.perf_counter() - t,
                             launches=_launches(counters))
        f, c, b = runs["fault"], runs["clean"], runs["bare"]
        st = f["st"]
        degraded = {r.uid for r in f["reqs"] if r.degraded}
        want = {r.uid for r in f["reqs"] if r.profile_id in expect}
        peers = [r.uid for r in f["reqs"] if not r.degraded]
        peers_equal = all(r.generated == q.generated
                          for r, q in zip(f["reqs"], c["reqs"])
                          if not r.degraded)
        bare_equal = all(r.generated == q.generated
                         for r, q in zip(f["reqs"], b["reqs"]) if r.degraded)
        preempted = sorted(r.uid for r in f["reqs"]
                           if r.degraded and r.preemptions)
        toks = sum(len(r.generated) for r in f["reqs"])
        cs.log(f"phase 10 (c) {name}: degraded {sorted(degraded)} (plan: "
               f"{sorted(want)}), retries {st['hydration_retries']}, "
               f"quarantined {st['quarantined_profiles']}, peers {peers} "
               f"bitwise the no-fault run {peers_equal}, degraded bitwise "
               f"the X-PEFT-disabled engine {bare_equal}; {toks} tokens in "
               f"{f['dt']:.3f}s; preemptions {st.get('preemptions', 0)} "
               f"(degraded requests preempted {preempted}); launches "
               f"{f['launches']}")
        assert all(r.done for run in (f, c, b) for r in run["reqs"])
        assert degraded == want and st["degraded_requests"] == len(want)
        assert st["hydration_retries"] > 0
        assert st["quarantined_profiles"] == 1
        assert st["degraded_slots"] == 0
        assert peers_equal and bare_equal
        for pid in expect:
            assert f["eng"].profile_cache.peek(pid) is None
        if long:
            assert st["preemptions"] > 0 and st["resumes"] > 0
            assert preempted, "no degraded request was preempted"
            f["eng"].page_alloc.check()
            f["eng"].mask_alloc.check()
        out[name] = dict(
            degraded=sorted(degraded), expected=sorted(want),
            hydration_retries=st["hydration_retries"],
            quarantined_profiles=st["quarantined_profiles"],
            peers_bitwise=peers_equal, degraded_bitwise_bare=bare_equal,
            preemptions=st.get("preemptions", 0),
            degraded_preempted=preempted, drain_s=f["dt"],
            launches=f["launches"])
        del runs, f, c, b
    del h_params
    torch.cuda.empty_cache()
    return out


# ----------------------------------------------------------------------------
# (d) observability
# ----------------------------------------------------------------------------

def observability(torch, cfg, base, counters):
    """(d): obs on against off on two paths, exports validated, the
    accumulator's cost per decode step."""
    from repro_torch import obs as OBS
    from repro_torch.core import xpeft as XP
    from repro_torch.serve import Request
    from repro_torch.serve import slots as SL

    params = base["params"]
    table = XP.init_profile_table(cfg.with_xpeft(max_profiles=4), seed=0)
    store = _store(cfg, table, 4)
    paths = {"composed_continuous": (cfg, True),
             "decode_fused": (cfg.with_(decode_fused=True), False)}
    out = {}
    for name, (pcfg, continuous) in paths.items():
        kw = dict(continuous=True, page_size=cs.CB_PAGE) if continuous \
            else {}
        runs = {}
        for run in ("warm", "off", "on"):
            bundle = OBS.Observability() if run == "on" else None
            eng = cs.cb_engine(pcfg, params, store, continuous, obs=bundle)
            reqs = cs.skewed_requests(Request, pcfg.vocab_size,
                                      n=2 if run == "warm" else 8)
            _zero(counters)
            torch.cuda.synchronize()
            t = time.perf_counter()
            eng.submit(reqs)
            eng.run_until_drained()
            torch.cuda.synchronize()
            runs[run] = dict(eng=eng, reqs=reqs, bundle=bundle,
                             dt=time.perf_counter() - t,
                             launches=_launches(counters))
        on, off = runs["on"], runs["off"]
        equal = [r.generated for r in on["reqs"]] == \
            [r.generated for r in off["reqs"]]
        syncs = (on["eng"].serve_stats()["host_syncs"],
                 off["eng"].serve_stats()["host_syncs"])
        bundle = on["bundle"]
        with tempfile.TemporaryDirectory() as tmp:
            mpath, tpath = os.path.join(tmp, "m.json"), \
                os.path.join(tmp, "t.json")
            bundle.export(mpath, tpath)
            with open(tpath) as fh:
                problem = OBS.validate_chrome_trace(json.load(fh))
            with open(mpath) as fh:
                metrics = json.load(fh)
        ttft = metrics["histograms"]["serve.ttft_us"]
        cats = bundle.tracer.category_counts()
        counters_obs = metrics["counters"]
        # kernels and device ms per decode step: the slot accumulator
        # taken out (the step without it), obs off, obs on
        steps = {}
        acc = SL.device_acc_update
        try:
            SL.device_acc_update = lambda a, *_: a
            steps["no_accumulator"] = step_profile(
                torch, pcfg, params, store,
                f"phase 10 (d) {name}, accumulator removed", kw)
        finally:
            SL.device_acc_update = acc
        steps["obs_off"] = step_profile(
            torch, pcfg, params, store, f"phase 10 (d) {name}, obs off", kw)
        steps["obs_on"] = step_profile(
            torch, pcfg, params, store, f"phase 10 (d) {name}, obs on",
            dict(kw, obs=OBS.Observability()))
        cs.log(f"phase 10 (d) {name}: obs on vs off tokens bitwise {equal}, "
               f"host_syncs {syncs[0]} / {syncs[1]}; trace valid "
               f"{problem is None}, categories {cats}; TTFT p50 "
               f"{ttft['p50']:.1f} us p95 {ttft['p95']:.1f} us over "
               f"{ttft['count']} requests; drains {on['dt']:.3f}s / "
               f"{off['dt']:.3f}s; kernels/step "
               + ", ".join(f"{k} {v['decode_kernels']:.0f} "
                           f"({v['decode_device_ms']:.4f} ms)"
                           for k, v in steps.items()))
        assert equal and syncs[0] == syncs[1]
        assert problem is None, problem
        assert counters_obs["serve.decode_tokens"] == \
            on["eng"].decode_tokens > 0
        for cat in ("admission", "prefill", "decode-window"):
            assert cats.get(cat, 0) > 0, cats
        out[name] = dict(tokens_bitwise=equal, host_syncs=syncs[0],
                         trace_categories=cats, ttft_us=ttft,
                         admission_wait_us=metrics["histograms"].get(
                             "serve.admission_wait_us"),
                         drain_s_on=on["dt"], drain_s_off=off["dt"],
                         launches=on["launches"], steps=steps)
    return out


def phase_resilience(torch, cfg=None, base=None):
    """Phase 10: (a)-(d) above on ``cfg`` (default qwen1.5-0.5b), (c) and
    (d) on its first OPS_LAYERS layers; ``base`` carries phase 4's params
    to reuse (else drawn from seed 0)."""
    from repro_torch.configs import get_config
    from repro_torch.models import init_lm
    from repro_torch.utils.tree import tree_map

    t0 = time.perf_counter()
    cfg = cfg or get_config("qwen1.5-0.5b")
    counters = cs.kernel_counters()
    out, secs = {}, {}
    lap = [time.perf_counter()]

    def done(key):
        now = time.perf_counter()
        secs[key] = now - lap[0]
        lap[0] = now

    out["hetero_train"] = hetero_train(torch, cfg, counters)
    done("a")
    out["per_step_hetero"] = per_step_hetero(torch, cfg, counters)
    done("b")
    ocfg = cfg.with_(num_layers=min(cfg.num_layers, OPS_LAYERS))
    params = (base or {}).get("params") or init_lm(ocfg, seed=0,
                                                   device="cuda")
    base = dict(params=dict(params, **{
        k: tree_map(lambda t: t[:ocfg.num_layers], params[k])
        for k in ("blocks", "xpeft_bank")}))
    out["faults"] = faults(torch, ocfg, base, counters)
    done("c")
    out["obs"] = observability(torch, ocfg, base, counters)
    done("d")
    out["seconds"] = time.perf_counter() - t0
    out["part_seconds"] = secs
    cs.log(f"phase 10: {out['seconds']:.1f}s (" + ", ".join(
        f"({k}) {v:.1f}s" for k, v in secs.items()) + ")")
    return out


def main():
    import torch
    if not torch.cuda.is_available():
        print("resilience_phase: torch.cuda.is_available() is False",
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
    out = phase_resilience(torch)
    cs.log(json.dumps({"resilience": out, "device": smi}, default=str))
    return 0


if __name__ == "__main__":
    sys.exit(main())
