"""``chip_smoke.py``'s phase 12 (mixture-of-experts blocks) on the card;
run alone:

    python3 tools/moe_phase.py

Builds the kernels, turns TF32 off as ``chip_smoke.py`` does and runs
``phase_moe`` on qwen3-moe-30b-a3b at its published width and depth (48
layers, d=2048, 32 x 128 heads, 4 KV heads, 128 experts, top-8, per-expert
d_ff 768, vocab 151,936), bf16, random weights from seed 0, bank N=256,
b=64, k=50: about 61 GB of weights and 6.4 GB of bank on the card. Phase
4's workload (8 requests of 4-16 prompt tokens, 16 new tokens, 4 slots,
max_seq 128, sync_every 8) throughout.

(k) #1, #2, #5 and #6 at this model's shapes (d=2048, b=64, 48 layers):
    #1 over a [48 x 256, 2048, 64] bank and its B side (P = 4 profiles x
    48 layers, k=50), #2 on layer slices at T=1, the verify's T=4 and the
    prefill's T=16 (the planner's cluster of 8 asserted), #5 over the
    int8 bank, #6 at int8 T=1 and 16; each held to its plain version with
    phase 3's bounds and timed as phase 3 times it.
(e) training first, while the card holds nothing else: one xpeft step on
    the card against the same step on the CPU (2 layers, float32, TF32
    off, the same weights, batch and Gumbel draws) under phase 7's
    bounds, the aux loss under the loss's; ten full-depth bf16 steps
    through ``launch/train.py``'s loop (8 profiles, B=8, T=64), timed and
    profiled as phase 7's; the trained table packed into a hard store,
    saved and loaded back byte-equal. The run's frozen weights serve (a)
    to (d) and (f) at their first SERVE_LAYERS = 8 layers (the call's
    time).
(a) composed windowed serving of 4 random profiles: #1 twice per wave
    that aggregates, #2 8 times per decode step and prefill batch. Held
    to its ``kernel_impl="ref"`` run, with every layer's routing recorded
    in both (``Routing``). The routing rule (``routing_diff``): for each
    request whose routing parts before its tokens do, the first (layer,
    token) is named, and the reference's gap between the k-th and
    (k+1)-th router logit there must be at most twice that token's max
    |d router logit| (the counterpart of the greedy flip rule). A routing
    flip moves a token by a whole expert, not a rounding step, so the
    logits are held on a run teacher-forced on the ref run's tokens with
    its routing replayed in every layer: every request's prefill and
    decode-step logits meet phase 4's bounds, and every own selection of
    that run that parts from the ref's, in any layer, meets the routing
    rule (``replay_check``). A decode step timed and profiled, the
    expert GEMMs' share of its device time (their three batched GEMMs
    timed apart over the 8 layers' weights) and its byte bound.
(b) ``decode_fused=True``: MoE blocks stay composed, so #8 launches 0
    times and the tokens are (a)'s bitwise.
(c) continuous serving (pages of 16) against (a)'s windowed run, by the
    routing rule (their prefill batches differ, so their capacities and
    drops may: a drop that differs is reported, not asserted); then
    self-speculation (gamma 3) against the continuous run, reported with
    its acceptance and routing divergences, not asserted equal (the
    verify's gamma + 1 tokens a slot change the capacity, as in JAX).
(d) the int8 bank, composed: #5 twice per aggregating wave, #6 8 times
    per decode step and prefill batch, #1 and #2 never; held to its ref
    run as (a).
(f) (e)'s trained profiles, repacked as a hard store on the first
    SERVE_LAYERS layers, served and held to its ref run as (a).

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

import chip_smoke as cs  # noqa: E402

ARCH = "qwen3-moe-30b-a3b"
TRAIN_ARGV = ["--arch", ARCH, "--mode", "xpeft", "--steps", "10", "--batch",
              "8", "--seq", "64", "--profiles", "8", "--seed", "0",
              "--device", "cuda"]
# a routing flip at a token whose routing history agrees must lie on a
# reference gap (k-th minus (k+1)-th router logit) of at most this times
# the token's max |d router logit|: for an expert a the reference keeps
# and b it does not, g_a - g_b <= |d g_a| + |d g_b| once the run swaps them
ROUTE_GAP_FACTOR = 2.0
# the depth (a)-(d) and (f) serve at: the first 8 of the 48 trained
# layers (the call's time); (e) trains all 48
SERVE_LAYERS = 8


# ----------------------------------------------------------------------------
# routing records
# ----------------------------------------------------------------------------

class Routing:
    """Every MoE layer's routing while installed: wraps ``models.moe``'s
    ``route`` and ``ranks`` (module globals, so ``moe_apply`` calls the
    wrappers; nothing is added to the port). ``file(kind, rows)`` keeps
    the last forward's L layers as one call (gates [L, n, E] fp32 router
    logits, topi and keep [L, n, k]) with its row map: (row, (uid,
    position)) pairs, or a function returning them after the drain (a
    decode step's host counts are read then). Nothing is copied to the
    host before ``resolve``.

    With ``replay`` (a recorder of the same batches, filed call for
    call), every layer dispatches the replayed run's selection, weighted
    by this run's own renormalised probabilities, while this run's own
    selection and kept routes are what it records: the run differs from
    the replayed one by rounding alone, and each of its own flips is
    first-order."""

    def __init__(self, L, replay=None):
        import torch
        from repro_torch.models import moe as MOE
        self.MOE, self.L, self.replay = MOE, L, replay
        self.route0, self.ranks0 = MOE.route, MOE.ranks
        self.pending, self.calls, self.keyed = [], [], {}

        def route(router, x2, k):
            gates, probs, topw, topi = self.route0(router, x2, k)
            self.pending.append([gates, topi, None])
            if replay is None:
                return gates, probs, topw, topi
            topi = replay.calls[len(self.calls)]["dispatch"][
                len(self.pending) - 1]
            w = probs.gather(1, topi)
            return (gates, probs,
                    w / torch.clamp(w.sum(-1, keepdim=True), min=1e-9),
                    topi)

        def ranks(topi, C, E):
            pos, keep = self.ranks0(topi, C, E)
            own = self.pending[-1][1]
            self.pending[-1][2] = keep if replay is None \
                else self.ranks0(own, C, E)[1]
            return pos, keep
        MOE.route, MOE.ranks = route, ranks

    def close(self):
        self.MOE.route, self.MOE.ranks = self.route0, self.ranks0

    def file(self, kind, rows):
        import torch
        recs, self.pending = self.pending[-self.L:], []
        assert len(recs) == self.L and all(r[2] is not None for r in recs)
        topi = torch.stack([r[1] for r in recs])
        # the device copy a replaying run dispatches
        self.calls.append(dict(
            kind=kind, rows=rows, dispatch=topi,
            gates=torch.stack([r[0] for r in recs]), topi=topi,
            keep=torch.stack([r[2] for r in recs])))

    def resolve(self):
        """Host copies; ``keyed``: (uid, position) -> (call, row)."""
        for i, c in enumerate(self.calls):
            for key in ("gates", "topi", "keep"):
                c[key] = c[key].cpu()
            rows = c["rows"]() if callable(c["rows"]) else c["rows"]
            for row, key in rows:
                self.keyed[key] = (i, row)
        return self

    def sets(self, call, row=None):
        """(selected, kept) expert sets [L, (n,) k] sorted, dropped routes
        as -1 in ``kept``."""
        import torch
        c = self.calls[call]
        topi, keep = c["topi"], c["keep"]
        if row is not None:
            topi, keep = topi[:, row], keep[:, row]
        return (topi.sort(-1).values,
                torch.where(keep, topi, -1).sort(-1).values)


def routing_diff(a, b, prompt_len, k, same_batches, assert_rule=True,
                 limit=None):
    """Hold run ``a``'s routing to reference ``b``'s, token by token
    (``limit[uid]``: only positions below it, where both runs were fed
    the same tokens).

    For each request, its first routing event where the runs part: in
    prefill the earliest layer (then position) at which any prompt
    position's selected or kept set differs, else the earliest decode
    position (then layer). Before it, the request's every routed token
    agrees in every layer. A selected set that differs there must lie on
    a reference gap g_(k) - g_(k+1) of at most ROUTE_GAP_FACTOR x the
    token's max |d router logit| (every prompt position flipping at that
    layer is checked). A kept set that differs with the selected sets
    equal is a capacity drop: with ``same_batches`` (the two runs' calls
    are the same batches) some row of that call must flip its selection at
    that layer; across other batchings it is reported. Returns {uid:
    event or None} and counts."""
    if same_batches:
        assert len(a.calls) == len(b.calls)
        for ca, cb in zip(a.calls, b.calls):
            assert ca["topi"].shape == cb["topi"].shape
    first, per_key = {}, {}
    compared = diverged = 0
    for key, (ia, ra) in a.keyed.items():
        if key not in b.keyed or (limit and key[1] >= limit[key[0]]):
            continue
        ib, rb = b.keyed[key]
        compared += 1
        sa, ka = a.sets(ia, ra)
        sb, kb = b.sets(ib, rb)
        set_diff = (sa != sb).any(-1)
        div = set_diff | (ka != kb).any(-1)
        if not div.any():
            continue
        diverged += 1
        layer = int(div.nonzero()[0])
        uid, pos = key
        pre = pos < prompt_len[uid]
        ev = dict(uid=uid, position=pos, layer=layer, prefill=pre,
                  kind="set" if bool(set_diff[layer]) else "drop",
                  order=(0, layer, pos) if pre else (pos, layer, 0))
        per_key[key] = (ev, ia, ra, ib, rb)
        if uid not in first or ev["order"] < first[uid]["order"]:
            first[uid] = ev
    checked = []
    for uid, ev in first.items():
        layer = ev["layer"]
        if ev["prefill"]:
            # every prompt position whose first divergence is a selection
            # flip at this layer: their routing histories agree
            keys = [key for key, (e, *_) in per_key.items()
                    if key[0] == uid and e["prefill"]
                    and e["layer"] == layer]
        else:
            keys = [(uid, ev["position"])]
        ev["explained"] = True
        for key in keys:
            e, ia, ra, ib, rb = per_key[key]
            if e["kind"] != "set":
                continue
            ga = a.calls[ia]["gates"][layer, ra]
            gb = b.calls[ib]["gates"][layer, rb]
            top = gb.sort(descending=True).values
            gap = (top[k - 1] - top[k]).item()
            dg = (ga - gb).abs().max().item()
            ok = gap <= ROUTE_GAP_FACTOR * dg
            checked.append(dict(uid=uid, position=key[1], layer=layer,
                                gap=gap, max_d_gate=dg, ok=ok))
            ev["explained"] &= ok
            cs.log(f"    routing flip: request {uid} position {key[1]} "
                   f"layer {layer}: reference gap {gap:.4e}, max|d router "
                   f"logit| {dg:.4e}{'' if ok else ' -- UNEXPLAINED'}")
            assert ok or not assert_rule, (uid, key, gap, dg)
        if ev["kind"] == "drop":
            ia = per_key[(uid, ev["position"])][1]
            if same_batches:
                sa, _ = a.sets(ia)
                sb, _ = b.sets(ia)
                flip = bool((sa[layer] != sb[layer]).any())
                ev["explained"] &= flip
                assert flip or not assert_rule, ("drop without a flip", ev)
            ev["capacity"] = int(a.calls[ia]["topi"].shape[1])
            cs.log(f"    capacity drop: request {uid} position "
                   f"{ev['position']} layer {layer} (the call routes "
                   f"{ev['capacity']} tokens)")
    events = {uid: first.get(uid) for uid in prompt_len}
    for ev in first.values():
        ev.pop("order")
    return events, dict(tokens_compared=compared, tokens_diverged=diverged,
                        requests_diverged=len(first), flips_checked=checked)


def replay_check(a, b, k):
    """Run ``a`` replayed ``b``'s routing call for call: wherever a's own
    selection differs from b's (any call, layer and row), b's gap
    g_(k) - g_(k+1) there must be at most ROUTE_GAP_FACTOR x the row's max
    |d router logit|; a kept set that differs with the selections equal
    needs a selection flip in the same call and layer. Returns counts."""
    flips = drops = rows = 0
    worst = 0.0
    assert len(a.calls) == len(b.calls)
    for i, (ca, cb) in enumerate(zip(a.calls, b.calls)):
        assert ca["topi"].shape == cb["topi"].shape
        sa, ka = a.sets(i)
        sb, kb = b.sets(i)
        set_diff = (sa != sb).any(-1)                     # [L, n]
        drop_diff = (ka != kb).any(-1) & ~set_diff
        if ca["kind"] == "decode":
            # a decode step's live rows: a finished slot's row is fed
            # other tokens in a teacher-forced run (a prefill's rows,
            # padding included, are the same tokens in both)
            live = [row for row, _ in ca["rows"]]
            keep_rows = set_diff.new_zeros(set_diff.shape)
            keep_rows[:, live] = True
            set_diff &= keep_rows
            drop_diff &= keep_rows
        rows += int(keep_rows.sum()) if ca["kind"] == "decode" \
            else set_diff.numel()
        for l, r in set_diff.nonzero().tolist():
            top = cb["gates"][l, r].sort(descending=True).values
            gap = (top[k - 1] - top[k]).item()
            dg = (ca["gates"][l, r] - cb["gates"][l, r]).abs().max().item()
            assert gap <= ROUTE_GAP_FACTOR * dg, (i, l, r, gap, dg)
            worst = max(worst, gap / dg)
            flips += 1
        for l in drop_diff.any(-1).nonzero().flatten().tolist():
            assert set_diff[l].any(), ("drop without a flip", i, l)
            drops += int(drop_diff[l].sum())
    return dict(rows=rows, flips=flips, drops_following=drops,
                worst_gap_over_d_gate=worst)


def same_inputs(reqs, other):
    """{uid: the first position whose input token differs between two
    runs of the same requests (the prompt's length plus the index of the
    first differing generated token; past the end where none differs)}."""
    out = {}
    for r, q in zip(reqs, other):
        j = next((t for t, (x, y) in enumerate(zip(r.generated,
                                                    q.generated))
                  if x != y), len(r.generated))
        out[r.uid] = len(r.prompt) + j
    return out


# ----------------------------------------------------------------------------
# drains
# ----------------------------------------------------------------------------

def drain(torch, cfg, params, store, counters, continuous=False,
          record=True, n=8, max_new=16):
    """Phase 4's workload through one engine (4 slots, max_seq 128,
    sync_every 8; continuous on pages of 16), every kernel counter at 0
    just before and read just after; with ``record`` the logits behind
    every token (``cb_recorder``) and every layer's routing (``Routing``)
    are kept, neither adding a host sync. The engine itself is not kept."""
    from repro_torch.models import model as MDL
    from repro_torch.serve import Request

    eng = cs.cb_engine(cfg, params, store, continuous)
    reqs = cs.make_requests(Request, cfg.vocab_size, n=n, max_new=max_new)
    waves = []
    hydrate = eng._hydrate_stacked

    def spy(wave):
        out = hydrate(wave)
        waves.append(dict(eng.last_admission))
        return out
    eng._hydrate_stacked = spy
    lg = rt = None
    if record:
        lg = cs.cb_recorder(eng, MDL)
        rt = Routing(cfg.num_layers)
        groups, W = [], (cfg.spec_gamma + 1) if eng.spec else 1
        group_by_bucket = eng.scheduler.group_by_bucket
        prefill, decode = eng.prefill_logits, eng.slots.decode_fn

        def spy_groups(wave):
            out = group_by_bucket(wave)
            groups.extend(out[pad] for pad in sorted(out))
            return out

        def spy_prefill(tokens, *args, **kwargs):
            out = prefill(tokens, *args, **kwargs)
            pad = tokens.shape[1]
            rt.file("prefill", [(j * pad + p, (r.uid, p))
                                for j, r in enumerate(groups.pop(0))
                                for p in range(len(r.prompt))])
            return out

        def spy_decode(params_, cache, last_tok, lengths, masks, active):
            # the step's row i * W + t produces token g + base + t of slot
            # i's request (g its tokens at the last sync), from the input
            # at position P + that index - 1
            base = eng.slots.buf_len.clone() if eng.spec \
                else eng.slots.buf_fill
            slots = [None if r is None else
                     (r.uid, len(r.prompt), len(r.generated),
                      r.max_new_tokens) for r in eng.slot_req]
            out = decode(params_, cache, last_tok, lengths, masks, active)

            def rows():
                b = [base] * len(slots) if isinstance(base, int) \
                    else base.tolist()
                res = []
                for i, s in enumerate(slots):
                    if s is None:
                        continue
                    uid, P, g, most = s
                    for t in range(W):
                        j = g + b[i] + t
                        if 1 <= j < most:
                            res.append((i * W + t, (uid, P + j - 1)))
                return res
            rt.file("decode", rows)
            return out
        eng.scheduler.group_by_bucket = spy_groups
        eng.prefill_logits = spy_prefill
        eng.slots.decode_fn = spy_decode
    for fn in counters.values():
        fn.launches = 0
    by_t = counters["fused_adapter_batched"].launches_by_t
    by_t.clear()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t = time.perf_counter()
    try:
        eng.run_until_drained(list(reqs))
        torch.cuda.synchronize()
        dt = time.perf_counter() - t
    finally:
        if record:
            lg["finish"]()
            rt.close()
    launches = {name: fn.launches for name, fn in counters.items()}
    assert all(r.done and len(r.generated) == max_new for r in reqs)
    assert all(0 <= t < cfg.vocab_size for r in reqs for t in r.generated)
    st = eng.serve_stats()
    if continuous:
        eng.page_alloc.check()
        eng.mask_alloc.check()
    out = dict(reqs=reqs, dt=dt, launches=launches,
               launches_by_t=dict(by_t), waves=waves, stats=st,
               peak_bytes=torch.cuda.max_memory_allocated(),
               rec=lg, routing=rt.resolve() if record else None)
    del eng
    gc.collect()
    return out


def expect(kind, L, d, gamma=0):
    """What a drain ``d`` of path ``kind`` must launch (``gamma``: spec
    rounds run gamma zero-record drafts and the verify, each through #2 in
    every layer)."""
    n, st, by_t = d["launches"], d["stats"], d["launches_by_t"]
    steps, batches = st["device_steps"], st["prefill_batches"]
    zero = set(n)
    if kind == "int8":
        quant = sum(w["path"] == "quant_sparse" for w in d["waves"])
        assert n["mask_aggregate_quant_batched"] == 2 * quant > 0, n
        assert n["fused_adapter_quant_batched"] == L * (steps + batches), n
        zero -= {"mask_aggregate_quant_batched",
                 "fused_adapter_quant_batched"}
    else:
        sparse = sum(w["path"] == "sparse" for w in d["waves"])
        assert n["mask_aggregate_batched"] == 2 * sparse > 0, n
        assert n["fused_adapter_batched"] == \
            L * ((gamma + 1) * steps + batches) > 0, n
        # by x's T: decode steps and drafts at 1, verifies at gamma + 1
        # (prefill batches pad to 8 tokens or more)
        assert by_t.get(1, 0) == L * steps * max(gamma, 1), by_t
        if gamma:
            assert by_t.get(gamma + 1, 0) == L * steps, by_t
        zero -= {"mask_aggregate_batched", "fused_adapter_batched"}
    assert not any(n[k] for k in zero), n


def forced_run(torch, cfg, params, store, reqs, forced, bare=False,
               rec=None, eng_kw=None):
    """``chip_smoke.forced_decode`` with the routing kept: a fresh
    windowed engine (phase 4's shape, overridden by ``eng_kw``) serves
    ``reqs`` in the free run's admission waves,
    each slot's decode step fed ``forced[uid]``'s token (teacher forcing);
    ``bare`` leaves the adapter out of the prefills and decode steps (the
    adapters' share of the logits). Returns (decode-
    step logits [R, n-1, V], {uid: prefill logits [V]}); ``rec`` files
    each prefill and decode call's routing by (uid, position)."""
    from repro_torch.models import model as MDL
    from repro_torch.serve import Request, ServeEngine

    eng = ServeEngine(cfg, params, store,
                      **dict(cs.CB_ENGINE, **(eng_kw or {})))
    groups, pre = [], {}
    group_by_bucket = eng.scheduler.group_by_bucket
    prefill = eng.prefill_logits

    def spy_groups(wave):
        out = group_by_bucket(wave)
        groups.extend(out[pad] for pad in sorted(out))
        return out

    def spy_prefill(tokens, masks, *args, **kwargs):
        logits, mini = prefill(tokens, None if bare else masks, *args,
                               **kwargs)
        group, pad = groups.pop(0), tokens.shape[1]
        for j, r in enumerate(group):
            pre[r.uid] = logits[j]
        if rec is not None:
            rec.file("prefill", [(j * pad + p, (r.uid, p))
                                 for j, r in enumerate(group)
                                 for p in range(len(r.prompt))])
        return logits, mini
    eng.scheduler.group_by_bucket = spy_groups
    eng.prefill_logits = spy_prefill
    n = len(forced[reqs[0].uid]) - 1
    plen = {r.uid: len(r.prompt) for r in reqs}
    rows = {r.uid: [] for r in reqs}

    def decode_fn(params_, cache, last_tok, lengths, masks, active):
        live = [(i, r.uid) for i, r in enumerate(eng.slot_req)
                if r is not None and len(rows[r.uid]) < n]
        feed, nxt = last_tok.clone(), last_tok.clone()
        steps = {}
        for i, uid in live:
            s = steps[uid] = len(rows[uid])
            feed[i] = forced[uid][s]
            nxt[i] = forced[uid][s + 1]
        hidden, cache, _ = MDL.forward(
            params_, feed[:, None], cfg,
            profile_masks=None if bare else masks, cache=cache,
            cache_pos=lengths)
        logits = MDL.lm_logits(params_, hidden, cfg)[:, -1]
        for i, uid in live:
            rows[uid].append(logits[i])
        if rec is not None:
            rec.file("decode", [(i, (uid, plen[uid] + steps[uid]))
                                for i, uid in live])
        return nxt, cache
    eng.slots.decode_fn = decode_fn
    eng.run_until_drained([Request(uid=r.uid, prompt=r.prompt,
                                   profile_id=r.profile_id,
                                   max_new_tokens=r.max_new_tokens)
                           for r in reqs])
    assert all(len(v) == n for v in rows.values())
    dec = torch.stack([torch.stack(rows[r.uid]) for r in reqs])
    del eng
    gc.collect()
    return dec, pre


def serve_path(torch, label, cfg, params, store, counters, kind,
               warm=True, profile=True):
    """One composed windowed path held to its kernel_impl="ref" run.

    The kernel drain (counters at 0 just before; ``expect(kind)``; after
    a warm-up drain with ``warm``) and the ref drain (nothing launched)
    are recorded: their routing is held by ``routing_diff`` up to each
    request's first differing token, their tokens by ``cb_explain``. Then
    the kernel route and the adapter-less ref run, teacher-forced on the
    ref run's tokens with its routing replayed in every layer, give
    logits that differ from the ref run's by rounding alone: prefill and
    decode-step logits of every request meet phase 4's E2E bounds, and
    every own selection of the kernel run that parts from the ref's, in
    any layer, is held by ``replay_check``. With ``profile``, a decode
    step profiled."""
    from repro_torch.serve import Request, ServeEngine

    L, k = cfg.num_layers, cfg.top_k
    if warm:
        drain(torch, cfg, params, store, counters, record=False, n=4,
              max_new=4)
    run = drain(torch, cfg, params, store, counters)
    expect(kind, L, run)
    st = run["stats"]
    toks = sum(len(r.generated) for r in run["reqs"])
    cs.log(f"moe {label} (kernels): 8 requests / {toks} tokens in "
           f"{st['device_steps']} device steps + {st['prefill_batches']} "
           f"prefill batches, {run['dt']:.3f}s = {toks / run['dt']:.1f} "
           f"tok/s; launches {run['launches']}; peak memory "
           f"{run['peak_bytes'] / 2**30:.2f} GiB; admissions "
           f"{[w['path'] for w in run['waves']]}")
    ref_cfg = cfg.with_xpeft(kernel_impl="ref")
    ref = drain(torch, ref_cfg, params, store, counters)
    assert not any(ref["launches"].values()), ref["launches"]
    reqs, ref_reqs = run["reqs"], ref["reqs"]
    plen = {r.uid: len(r.prompt) for r in reqs}
    events, rstats = routing_diff(run["routing"], ref["routing"], plen, k,
                                  same_batches=True,
                                  limit=same_inputs(reqs, ref_reqs))
    tokens = cs.cb_explain(torch, run, ref)
    cs.log(f"  free runs: routing parts on {rstats['requests_diverged']} "
           f"of 8 requests before their tokens do "
           f"({rstats['tokens_diverged']}/{rstats['tokens_compared']} "
           f"routed tokens); tokens agree {tokens['agree']}/"
           f"{tokens['total']}")
    forced = {q.uid: q.generated for q in ref_reqs}
    dec, pre, own = [], [], None
    for c, bare in ((cfg, False), (ref_cfg, True)):
        rec = Routing(L, replay=ref["routing"])
        try:
            d, p = forced_run(torch, c, params, store, reqs, forced,
                              bare=bare, rec=rec)
        finally:
            rec.close()
        own = own or rec.resolve()
        dec.append(d)
        pre.append(torch.stack([p[r.uid] for r in reqs]))
    lg = ref["rec"]["logits"]
    dev = dec[0].device
    pre.insert(1, torch.stack([lg[(r.uid, 0)] for r in reqs]).to(dev))
    dec.insert(1, torch.stack([torch.stack([lg[(r.uid, j)]
                                            for j in range(1, 16)])
                               for r in reqs]).to(dev))
    assert torch.isfinite(dec[0]).all() and torch.isfinite(pre[0]).all()
    assert dec[0].shape == (8, 15, cfg.vocab_size)
    replay = replay_check(own, ref["routing"], k)
    cs.log(f"  kernel route with the ref run's routing replayed: "
           f"{replay['flips']} of {replay['rows']} (layer, routed token) "
           f"own selections part from the ref's, each within the rule "
           f"(largest gap / max|d router logit| "
           f"{replay['worst_gap_over_d_gate']:.3f}); "
           f"{replay['drops_following']} kept sets follow them")
    e2e = dict(prefill=cs.e2e_check(f"{label} prefill logits", *pre),
               decode=cs.e2e_check(f"{label} decode-step logits, teacher-"
                                   "forced (8 requests x 15 steps)", *dec))
    out = dict(tok_s=toks / run["dt"], launches=run["launches"],
               launches_by_t=run["launches_by_t"],
               admissions=[w["path"] for w in run["waves"]],
               device_steps=st["device_steps"],
               prefill_batches=st["prefill_batches"],
               peak_bytes=run["peak_bytes"],
               greedy_agree_ref=tokens["agree"] / tokens["total"],
               flips=tokens["flips"],
               routing=dict(rstats, events=[e for e in events.values()
                                            if e is not None]),
               replay=replay, e2e=e2e)
    if profile:
        out.update(cs.profile_decode(torch, ServeEngine, Request, cfg,
                                     params, store, f"moe {label}"))
    return out, run


def tree_bytes(tree):
    if isinstance(tree, dict):
        return sum(tree_bytes(v) for v in tree.values())
    return tree.numel() * tree.element_size()


# ----------------------------------------------------------------------------
# the decode step's expert GEMMs and byte bound
# ----------------------------------------------------------------------------

def step_budget(torch, cfg, params, step):
    """The three expert GEMMs of a decode step (4 slots: capacity 8 per
    expert, every expert's buffer computed) timed apart: CUDA-graph
    replays over the served layers' weights in order (each layer's 1.2 GB
    of experts read cold, as the step reads them), times L, against the
    step's profiled device time; and the step's byte bound: every weight
    it reads once (all blocks, the final norm, the LM head), the 4 slots'
    Â/B̂ and LN rows, the K/V cache, over the card's memory rate."""
    import torch.nn.functional as F

    from repro_torch.analysis.roofline import HBM_BW
    moe = params["blocks"]["moe"]
    E, d, L = cfg.num_experts, cfg.d_model, cfg.num_layers
    C = 8  # capacity(4 tokens): max(top_k, min(4, 4 * 8 * 1.25 / 128))
    dev = moe["ew_g"].device
    gen = torch.Generator(device=dev).manual_seed(3)
    buf = torch.randn((E, C, d), generator=gen, device=dev).to(
        moe["ew_g"].dtype)

    def experts(l):
        g = torch.bmm(buf, moe["ew_g"][l])
        u = torch.bmm(buf, moe["ew_u"][l])
        return torch.bmm(F.silu(g) * u, moe["ew_d"][l])
    ms_layer = cs.device_ms(torch, cs.rotating(experts, [(l,) for l in
                                                         range(L)]),
                            calls=L, reps=5)
    expert_bytes = tree_bytes({k: v for k, v in moe.items()
                               if k != "router"})
    block_bytes = tree_bytes(params["blocks"])
    head = params["embed"] if cfg.tie_embeddings else params["lm_head"]
    b, S = cfg.xpeft.bottleneck, 128
    adapter_bytes = 4 * L * (2 * d * b * 2 + 2 * b * 4)
    kv_bytes = 2 * L * 4 * S * cfg.num_kv_heads * cfg.head_dim * 2
    nbytes = block_bytes + tree_bytes(head) \
        + tree_bytes(params["final_norm"]) + adapter_bytes + kv_bytes
    bound_ms = nbytes / HBM_BW * 1e3
    expert_ms = ms_layer * L
    share = expert_ms / step["decode_device_ms"]
    cs.log(f"  decode step budget: expert GEMMs {ms_layer:.4f} ms/layer "
           f"x {L} = {expert_ms:.3f} ms ({expert_bytes / 1e9:.2f} GB, "
           f"bound {expert_bytes / HBM_BW * 1e3:.3f} ms) = "
           f"{share:.3f} of the step's {step['decode_device_ms']:.3f} ms of "
           f"device time; the step's byte bound {bound_ms:.3f} ms "
           f"({nbytes / 1e9:.3f} GB: blocks {block_bytes / 1e9:.3f}, head "
           f"{tree_bytes(head) / 1e9:.3f}, adapters "
           f"{adapter_bytes / 1e9:.4f}, K/V {kv_bytes / 1e9:.4f})")
    return dict(expert_ms_per_layer=ms_layer, expert_ms_per_step=expert_ms,
                expert_share=share, expert_bytes=expert_bytes,
                step_bytes=nbytes, step_bound_ms=bound_ms,
                step_device_over_bound=step["decode_device_ms"] / bound_ms)


# ----------------------------------------------------------------------------
# (k) the kernels at this model's shapes
# ----------------------------------------------------------------------------

def kernel_rows(torch, name="moe", d=2048, L=48, fa_ts=None, seed=12):
    """#1, #2, #5, #6 at d=2048, b=64, 48 layers (see the module doc), or
    another model's ``d`` and ``L`` (rows tagged ``name``; #2 at each T of
    ``fa_ts``, default 1, gamma + 1 and 16)."""
    import torch.nn.functional as F

    from repro_torch.kernels import fused_adapter_batched as KF
    from repro_torch.kernels import fused_adapter_quant as KFQ
    from repro_torch.kernels import mask_aggregate as KA
    from repro_torch.kernels import mask_aggregate_quant as KAQ
    from repro_torch.kernels import ref
    from repro_torch.quant import schemes as QS

    gen = torch.Generator(device="cuda").manual_seed(seed)
    bf16, nb, P = torch.bfloat16, 64, 4 * L
    fa_ts = fa_ts or (1, cs.CB_GAMMA + 1, 16)
    out = dict(agg=[], fa=[], aggq=[], faq=[])
    sides = (("A_hat", (d, nb)), ("B_hat", (nb, d)))
    for label, (dd, bb) in sides:
        sets = [cs.agg_inputs(torch, gen, dd, bb, L=L, P=P)]
        out["agg"].append(cs.agg_row(torch, KA, ref, F, f"{name} {label}",
                                     sets))
        del sets
        torch.cuda.empty_cache()
    for T in fa_ts:
        clusters = KF.plan(d, nb, T, 2)
        cs.log(f"fused_adapter_batched plan at d={d} b={nb} T={T}: "
               f"clusters of {clusters} (d-slices of {d // clusters})")
        assert clusters == 8, (T, clusters)
    out["fa"] = cs.fa_slice_rows(torch, KF, ref, gen, name, d, nb, L,
                                 tuple((4, T, bf16) for T in fa_ts))
    for label, (dd, bb) in sides:
        bank, idx, w = cs.agg_inputs(torch, gen, dd, bb, L=L, P=P)
        rec = QS.quantize(bank, "int8", group=32)
        q, sc = rec["q"], rec["scale"]
        del bank, rec
        torch.cuda.empty_cache()
        got = KAQ.mask_aggregate_quant_batched(q, sc, idx, w, scheme="int8")
        again = KAQ.mask_aggregate_quant_batched(q, sc, idx, w,
                                                 scheme="int8")
        want = ref.mask_aggregate_quant_batched_ref(q, sc, idx, w,
                                                    scheme="int8")
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        tag = f"{name} int8 {label}"
        cs.log(f"mask_aggregate_quant_batched[{tag}] P={P} k=50 q "
               f"{tuple(q.shape)}: max_abs_err {err:.3e} (bitwise "
               f"{torch.equal(got, want)}; atol {cs.AGG_ATOL}); two calls "
               f"bitwise {torch.equal(got, again)}")
        assert err <= cs.AGG_ATOL and torch.equal(got, again), (tag, err)
        del got, again, want
        ms = cs.device_ms(torch, lambda: KAQ.mask_aggregate_quant_batched(
            q, sc, idx, w, scheme="int8"), calls=4, reps=5)
        plain_ms = cs.eager_ms(
            torch, lambda: ref.mask_aggregate_quant_batched_ref(
                q, sc, idx, w, scheme="int8"), calls=1, reps=3)
        uniq = int(torch.unique(idx).numel())
        row = (q[0].numel() * q.element_size()
               + sc[0].numel() * sc.element_size())
        nbytes = uniq * row + idx.numel() * 8 + P * dd * bb * 4
        bound_ms, bound_by = cs.bound(nbytes, 2 * P * 50 * dd * bb,
                                      "float32")
        cs.log(f"  ms {ms:.5f} (cold graph replay) | plain {plain_ms:.4f} | "
               f"bound {bound_ms:.5f} ({bound_by}: {nbytes / 1e6:.1f} MB, "
               f"{uniq} distinct rows)")
        out["aggq"].append(dict(shape=tag, max_abs_err=err, ms=ms,
                                plain_ms=plain_ms, bound_ms=bound_ms,
                                bound_by=bound_by, library_ms=None))
        del q, sc
        torch.cuda.empty_cache()
    out["faq"] = cs.faq_slice_rows(torch, KFQ, ref, QS, gen, name, "int8",
                                   d, nb, L, (1, 16))
    return out


# ----------------------------------------------------------------------------
# phase 12
# ----------------------------------------------------------------------------

def train_step_vs_cpu(torch):
    """(e) one xpeft step, card against CPU, at 2 layers in float32."""
    from repro_torch.configs import get_config
    cfg = get_config(ARCH).with_(num_layers=2, dtype="float32") \
        .with_xpeft(max_profiles=8)
    return cs.phase_train_step_vs_cpu(torch, cfg=cfg, label="moe (e)")


def phase_moe(torch):
    """Phase 12 (see the module doc). Returns its numbers: per run the
    launches of every kernel (``runs``), and the kernel rows at d=2048."""
    from repro_torch.core import xpeft as XP
    from repro_torch.core.profiles import ProfileStore
    from repro_torch.utils.tree import tree_map

    t0 = time.perf_counter()
    secs, lap = {}, [t0]

    def mark(name):
        now = time.perf_counter()
        secs[name] = now - lap[0]
        lap[0] = now

    cs.log(f"phase 12 starts with {torch.cuda.memory_allocated() / 2**30:.3f}"
           " GiB allocated")
    counters = cs.kernel_counters()
    rows = kernel_rows(torch)
    torch.cuda.empty_cache()
    mark("k")
    step = train_step_vs_cpu(torch)
    gc.collect()
    torch.cuda.empty_cache()
    trained, train = cs.phase_train_full(torch, TRAIN_ARGV)
    stores = cs.phase_pack_reload(torch, trained)
    cfg, params = trained["cfg"], trained["state"]["frozen"]
    trained_table = trained["state"]["trainable"]["table"]
    L = cfg.num_layers
    n_w = tree_bytes({k: v for k, v in params.items()
                      if k != "xpeft_bank"})
    n_bank = tree_bytes(params["xpeft_bank"])
    cs.log(f"moe: {cfg.name} L={L} d={cfg.d_model} H={cfg.num_heads} "
           f"KV={cfg.num_kv_heads} hd={cfg.head_dim} E={cfg.num_experts} "
           f"top-{cfg.top_k} ff={cfg.d_ff} V={cfg.vocab_size} {cfg.dtype}: "
           f"{n_w / 1e9:.2f} GB of weights + {n_bank / 1e9:.2f} GB of bank "
           f"(N={cfg.xpeft.num_adapters} b={cfg.xpeft.bottleneck} "
           f"k={cfg.xpeft.k}); {torch.cuda.memory_allocated() / 2**30:.2f} "
           "GiB allocated")
    mark("e")
    cfg = cfg.with_(num_layers=SERVE_LAYERS)
    params = dict(params, **{k: tree_map(lambda t: t[:SERVE_LAYERS],
                                         params[k])
                             for k in ("blocks", "xpeft_bank")})
    L = SERVE_LAYERS
    xp = cfg.xpeft
    table = XP.init_profile_table(cfg.with_xpeft(max_profiles=4), seed=0)

    def store_for(c, **kw):
        s = ProfileStore(L, xp.num_adapters, xp.bottleneck, xp.mask_type,
                         xp.k, **kw)
        for pid in range(4):
            s.add_profile(pid, {k: v[pid] for k, v in table.items()})
        return s
    store = store_for(cfg)
    runs = {}

    # (a) composed windowed serving
    a, run_a = serve_path(torch, "(a) composed", cfg, params, store,
                          counters, "bf16")
    a.update(step_budget(torch, cfg, params, a))
    runs["a"] = a["launches"]
    mark("a")

    # (b) decode_fused keeps MoE composed
    b = drain(torch, cfg.with_(decode_fused=True), params, store, counters,
              record=False)
    expect("bf16", L, b)
    b_equal = cs.tokens_equal(b["reqs"], run_a["reqs"])
    cs.log(f"moe (b) decode_fused=True: launches {b['launches']}; tokens "
           f"equal to (a) {b_equal:.3f}; peak memory "
           f"{b['peak_bytes'] / 2**30:.2f} GiB")
    assert b["launches"]["decode_block_fused"] == 0 and b_equal == 1.0
    runs["b"] = b["launches"]
    mark("b")

    # (c) continuous against (a)'s windowed run; spec against continuous
    c = drain(torch, cfg, params, store, counters, continuous=True)
    expect("bf16", L, c)
    plen = {r.uid: len(r.prompt) for r in c["reqs"]}
    c_events, c_stats = routing_diff(c["routing"], run_a["routing"], plen,
                                     cfg.top_k, same_batches=False,
                                     limit=same_inputs(c["reqs"],
                                                       run_a["reqs"]))
    c_tokens = cs.cb_explain(torch, c, run_a)
    cst = c["stats"]
    cs.log(f"moe (c) continuous vs (a) windowed: tokens agree "
           f"{c_tokens['agree']}/{c_tokens['total']}; routing: "
           f"{c_stats['tokens_diverged']}/{c_stats['tokens_compared']} "
           f"routed tokens part, {c_stats['requests_diverged']} requests; "
           f"device steps {cst['device_steps']} (windowed "
           f"{run_a['stats']['device_steps']}), {c['dt']:.3f}s, peak memory "
           f"{c['peak_bytes'] / 2**30:.2f} GiB; launches {c['launches']}")
    runs["c"] = c["launches"]
    s_cfg = cfg.with_(spec_enable=True, spec_gamma=cs.CB_GAMMA)
    s = drain(torch, s_cfg, params, store, counters, continuous=True)
    expect("bf16", L, s, gamma=cs.CB_GAMMA)
    s_events, s_stats = routing_diff(s["routing"], c["routing"], plen,
                                     cfg.top_k, same_batches=False,
                                     assert_rule=False,
                                     limit=same_inputs(s["reqs"], c["reqs"]))
    s_agree = sum(a_ == b_ for r, q in zip(s["reqs"], c["reqs"])
                  for a_, b_ in zip(r.generated, q.generated))
    sst = s["stats"]
    cs.log(f"moe (c) spec gamma {cs.CB_GAMMA} vs continuous: tokens agree "
           f"{s_agree}/{c_tokens['total']}; acceptance "
           f"{sst['spec']['acceptance_rate']}, {sst['device_steps']} rounds "
           f"for {cst['device_steps']} steps, {s['dt']:.3f}s; routing: "
           f"{s_stats['tokens_diverged']}/{s_stats['tokens_compared']} "
           f"routed tokens part, {s_stats['requests_diverged']} requests; "
           f"peak memory {s['peak_bytes'] / 2**30:.2f} GiB; launches "
           f"{s['launches']}")
    assert sst["committed_per_device_step"] > 1.0
    runs["c_spec"] = s["launches"]
    cont = dict(
        continuous=dict(tok_s=sum(len(r.generated) for r in c["reqs"])
                        / c["dt"], peak_bytes=c["peak_bytes"],
                        device_steps=cst["device_steps"],
                        windowed_device_steps=run_a["stats"]["device_steps"],
                        stranded_slot_steps=cst["stranded_slot_steps"],
                        tokens=c_tokens, launches=c["launches"],
                        routing=dict(c_stats, events=[
                            e for e in c_events.values() if e])),
        spec=dict(tok_s=sum(len(r.generated) for r in s["reqs"]) / s["dt"],
                  peak_bytes=s["peak_bytes"],
                  device_steps=sst["device_steps"], spec=sst["spec"],
                  committed_per_device_step=sst[
                      "committed_per_device_step"],
                  tokens_agree=s_agree, launches=s["launches"],
                  verify_launches=s["launches_by_t"].get(cs.CB_GAMMA + 1),
                  routing=dict(s_stats, events=[
                      e for e in s_events.values() if e])))
    del c, s
    mark("c")

    # (d) the int8 bank, composed
    q_cfg = cfg.with_xpeft(bank_quant="int8")
    q_store = store_for(q_cfg, quant="int8", quant_group=xp.quant_group)
    d, _ = serve_path(torch, "(d) int8 composed", q_cfg, params, q_store,
                      counters, "int8", warm=False, profile=False)
    runs["d"] = d["launches"]
    gc.collect()
    torch.cuda.empty_cache()
    mark("d")

    # (f) the trained profiles, repacked on the first SERVE_LAYERS layers
    # (for the call's time)
    f_store = ProfileStore(L, xp.num_adapters, xp.bottleneck, "hard", xp.k)
    for pid in stores["hard"].profile_ids():
        f_store.add_profile(pid, {k: v[pid, :L]
                                  for k, v in trained_table.items()})
    f, _ = serve_path(torch, "(f) trained store", cfg, params, f_store,
                      counters, "bf16", warm=False, profile=False)
    runs["trained"] = f["launches"]
    mark("f")
    del run_a
    secs["all"] = time.perf_counter() - t0
    cs.log("phase 12: " + f"{secs['all']:.1f}s (" + ", ".join(
        f"({k}) {v:.1f}s" for k, v in secs.items() if k != "all") + ")")
    return dict(arch=ARCH, weights_bytes=n_w, bank_bytes=n_bank,
                kernel_rows=rows, train=dict(train, step_vs_cpu=step),
                serve=a, decode_fused=dict(launches=b["launches"],
                                           peak_bytes=b["peak_bytes"],
                                           tokens_equal_a=b_equal),
                serve_continuous=cont, serve_int8=d, serve_trained=f,
                runs=runs, seconds=secs)


def main():
    import torch
    if not torch.cuda.is_available():
        print("moe_phase: torch.cuda.is_available() is False",
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
    out = phase_moe(torch)
    cs.log(json.dumps({"moe": out, "device": smi}, default=str))
    return 0


if __name__ == "__main__":
    sys.exit(main())
