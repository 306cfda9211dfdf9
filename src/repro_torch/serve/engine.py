"""Serving engine orchestrator: scheduler + slot state + profile cache.

The port of ``repro.serve.engine.ServeEngine`` in windowed mode
(``continuous=False``). With admission-time aggregation
(``precompute=True``) it serves hard- or soft-mask profiles from a
type-pure bank (soft masks aggregate densely, one einsum per wave),
unquantized or quantized
(``XPeftConfig.bank_quant`` int8/int4: the bank is quantized once at
construction and dropped from the resident params; admission aggregates
the quantized rows and the slot buffers hold quantized records), or an
unquantized heterogeneous bank (``XPeftConfig.bank_spec``: typed entries
and slot buffers, one aggregate per adapter family; a prefix segment's KV
rows are written into the cache at prefill, in front of the prompt, for
the requests whose profile selects any prefix slot). With
``cfg.decode_fused`` each decode step runs the decode megakernel once per
layer (prefill keeps the composed path; hetero entries stay composed).
Admission of a wave:

1. hydrate: per-request profile-cache lookup; only MISSING profiles are
   aggregated against the bank — k-sparse, the top-k rows only — in ONE
   batched call padded to a pow2 profile count (pad rows carry idx 0 and
   w 0 and come out as zeros); a quantized engine first takes what the
   store already holds as quantized aggregated records (zero bank reads)
   and re-quantizes what it aggregates; results are cached and the wave's
   rows gathered;
2. ONE scatter of the stacked rows into the per-slot mask buffers;
3. batched bucketed prefill: every same-length-bucket group goes through
   ONE prefill call (stacked [B, pad] batch, per-request last-token argmax
   on the device), then one batched KV-cache insert per group.

With ``precompute=False`` (the paper's per-step path) admission only
hydrates each request's float mask weights and LN affines from the store
into the slot buffers, and every prefill and decode step aggregates them
against the bank in every layer (``models.model._xpeft_apply``'s ``w_a``
route; ``last_admission["path"] == "per_step"``). With X-PEFT disabled the
engine serves the bare PLM.

Decode then advances every slot one token per ``step()``; the host syncs
every ``sync_every`` steps, bounded by the tokens any live request can
still emit. Constructor options outside this slice raise
``NotImplementedError`` naming their ROADMAP item.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from repro_torch.core import xpeft as XP
from repro_torch.core.profiles import ProfileStore
from repro_torch.models import model as MDL
from repro_torch.quant import schemes as QS
from repro_torch.serve.profile_cache import ProfileCache
from repro_torch.serve.scheduler import Request, Scheduler
from repro_torch.serve.slots import SlotState
from repro_torch.serve.steps import greedy_next
from repro_torch.utils import pow2_count


def _rate(num, den, nd: int = 4) -> float:
    """Rate field for serve_stats(): 0.0 when the denominator never
    ticked."""
    return round(num / den, nd) if den else 0.0


def _check_hetero(cfg, store, *, precompute, max_seq) -> None:
    """The JAX engine's refusals for a heterogeneous bank (ValueError), and
    its per-step path, which waits for ROADMAP queue 1, item 7."""
    xp = cfg.xpeft
    if not (xp.enabled and xp.is_hetero):
        return
    if xp.bank_quant != "none":
        raise ValueError(
            "bank_quant engines do not serve heterogeneous bank_specs "
            "(quantize_bank_hetero covers storage; serve with "
            "bank_quant='none')")
    if precompute and store.mask_type != "hard":
        raise ValueError("heterogeneous precompute serving requires "
                         "hard-mask profiles (per-type k-sparse "
                         "aggregation)")
    if xp.has_prefix and not precompute:
        raise ValueError(
            "per-step mask serving cannot hydrate prefix KV rows; a "
            "prefix-bearing bank_spec requires precompute=True")
    if xp.has_prefix and xp.prefix_tokens >= max_seq - 1:
        raise ValueError("prefix_tokens must leave room for the prompt "
                         f"(max_seq={max_seq})")
    if not precompute:
        raise NotImplementedError(
            "per-step mask serving over a heterogeneous bank is not ported "
            "(ROADMAP queue 1, item 7)")


def _check_quant(cfg, store, *, precompute) -> None:
    """The JAX engine's refusals for a quantized bank (ValueError)."""
    xp = cfg.xpeft
    if not (xp.enabled and xp.bank_quant != "none"):
        return
    if not precompute:
        # the per-step mask path hydrates against the fp bank every step,
        # so none of bank_quant's byte/residency savings would exist
        raise ValueError("bank_quant serving requires precompute admission "
                         "(per-step mask hydration reads the unquantized "
                         "bank)")
    if store.mask_type != "hard":
        raise ValueError("bank_quant serving requires hard-mask profiles "
                         "(k-sparse quantized aggregation)")


def _check_slice(cfg, store, *, precompute, max_seq, continuous, mesh,
                 fault_plan, obs) -> None:
    _check_hetero(cfg, store, precompute=precompute, max_seq=max_seq)
    _check_quant(cfg, store, precompute=precompute)
    MDL.check_supported(cfg)
    if continuous:
        raise NotImplementedError("continuous batching is not ported "
                                  "(ROADMAP queue 1, item 5)")
    if cfg.spec_enable and cfg.decode_fused:
        raise ValueError(
            "spec_enable and decode_fused are exclusive per engine: "
            "verification runs a T=gamma+1 composed forward, which the T=1 "
            "megakernel cannot serve")
    if cfg.spec_enable:
        raise NotImplementedError("speculative decoding is not ported "
                                  "(ROADMAP queue 1, item 5)")
    if mesh is not None:
        raise NotImplementedError("multi-device serving is not ported "
                                  "(ROADMAP queue 1, item 11)")
    if fault_plan is not None or obs is not None:
        raise NotImplementedError("fault plans and observability are not "
                                  "ported (ROADMAP queue 1, item 9)")


class ServeEngine:
    def __init__(self, cfg, params, store: ProfileStore, *,
                 max_slots: int = 4, max_seq: int = 256,
                 precompute: bool = True, sync_every: int = 8,
                 cache_bytes: Optional[int] = 64 << 20,
                 continuous: bool = False, mesh=None, fault_plan=None,
                 obs=None):
        _check_slice(cfg, store, precompute=precompute, max_seq=max_seq,
                     continuous=continuous, mesh=mesh,
                     fault_plan=fault_plan, obs=obs)
        self.cfg = cfg
        self.store = store
        self.device = params["embed"].device
        xp = cfg.xpeft
        self.precompute = precompute and xp.enabled
        # quantized bank: quantized ONCE here and DROPPED from the resident
        # params; every admission reads the int8/int4 rows and every step
        # the quantized Â/B̂ records
        self.quant = xp.bank_quant if self.precompute else "none"
        self.qbank = None
        self._qrow_bytes = 0
        if self.quant != "none":
            self.qbank = QS.quantize_bank(params["xpeft_bank"], self.quant,
                                          group=xp.quant_group)
            params = {k: v for k, v in params.items() if k != "xpeft_bank"}
            # true quantized bytes of one (l, n) row across both banks and
            # scales: what one k-sparse selection reads
            L_, N_ = self.qbank["bank_a_q"].shape[:2]
            self._qrow_bytes = sum(
                v.numel() * v.element_size()
                for v in self.qbank.values()) // (L_ * N_)
        self.params = params
        # heterogeneous bank: typed entries and slot buffers; a prefix
        # segment's rows hydrate into the KV cache at prefill
        self.hetero = xp.enabled and xp.is_hetero
        self.prefix_len = int(xp.prefix_tokens) \
            if (self.hetero and xp.has_prefix) else 0
        self._prefix_seg = next(((off, cnt) for t, off, cnt
                                 in xp.segments() if t == "prefix"), None)
        self.S = max_seq
        self.n_slots = max_slots
        self.sync_every = sync_every
        self.cache = MDL.init_cache(cfg, max_slots, max_seq,
                                    device=self.device)
        self.slot_req: List[Optional[Request]] = [None] * max_slots
        self.scheduler = Scheduler(cfg.block_pattern, policy="fifo")
        self.profile_cache = ProfileCache(cache_bytes)
        # re-graduation hook: a re-added profile never serves a stale
        # cached aggregate (the store holds this bound method weakly)
        store.subscribe(self.invalidate_profile)
        L, b, d = cfg.num_layers, xp.bottleneck, cfg.d_model
        dt = MDL.torch_dtype(cfg.dtype)
        dev = self.device
        if not xp.enabled:
            self._entry_keys = ()
            self.masks = None
        elif not self.precompute:
            # per-step: each slot's float mask weights and LN affines, which
            # every prefill and decode step aggregates against the bank
            self._entry_keys = ("w_a", "w_b", "ln_scale", "ln_bias")
            N = xp.num_adapters
            self.masks = {
                "w_a": torch.zeros((max_slots, L, N), device=dev),
                "w_b": torch.zeros((max_slots, L, N), device=dev),
                "ln_scale": torch.ones((max_slots, L, b), device=dev),
                "ln_bias": torch.zeros((max_slots, L, b), device=dev)}
        elif self.quant != "none":
            # per-slot QUANTIZED Â/B̂ records + fp16 scales, read by the
            # decode step and widened in registers
            aq_s, aq_dt, as_s = QS.quant_spec((max_slots, L, d, b),
                                              self.quant,
                                              group=xp.quant_group)
            bq_s, bq_dt, bs_s = QS.quant_spec((max_slots, L, b, d),
                                              self.quant,
                                              group=xp.quant_group)
            adapter = {
                "a_q": torch.zeros(aq_s, dtype=aq_dt, device=dev),
                "a_scale": torch.zeros(as_s, dtype=torch.float16,
                                       device=dev),
                "b_q": torch.zeros(bq_s, dtype=bq_dt, device=dev),
                "b_scale": torch.zeros(bs_s, dtype=torch.float16,
                                       device=dev),
            }
            self.masks = dict(
                adapter,
                ln_scale=torch.ones((max_slots, L, b), dtype=torch.float32,
                                    device=dev),
                ln_bias=torch.zeros((max_slots, L, b), dtype=torch.float32,
                                    device=dev))
            self._entry_keys = tuple(self.masks)
        else:
            # what one hydrated entry carries; the slot buffers hold the
            # same leaves minus the prefix ROWS (they go into the KV cache
            # at prefill; only the per-layer skip gate rides with decode)
            self._entry_keys = ("a_hat", "b_hat", "ln_scale", "ln_bias")
            if self.hetero:
                self._entry_keys = XP.hetero_entry_keys(xp) + (
                    ("prefix_skip",) if self.prefix_len else ())
            shapes = {
                "a_hat": ((L, d, b), dt), "b_hat": ((L, b, d), dt),
                "ln_scale": ((L, b), torch.float32),
                "ln_bias": ((L, b), torch.float32),
                "lora_a": ((L, d, b), dt), "lora_b": ((L, b, d), dt),
                "ia3_s": ((L, d), dt), "prefix_skip": ((L,), torch.int32),
            }
            self.masks = {
                key: (torch.ones if key == "ln_scale" else torch.zeros)(
                    (max_slots,) + shapes[key][0], dtype=shapes[key][1],
                    device=dev)
                for key in self._entry_keys if key in shapes}

        def decode_fn(params, cache, last_tok, lengths, masks, active):
            hidden, cache, _ = MDL.forward(params, last_tok[:, None], cfg,
                                           profile_masks=masks, cache=cache,
                                           cache_pos=lengths)
            return greedy_next(MDL.lm_logits(params, hidden, cfg)), cache

        self.slots = SlotState(max_slots, max_seq, sync_every, decode_fn,
                               device=dev)
        # what the last admission did (path, cache hits, bank bytes,
        # prefill occupancy), as the JAX engine reports it
        self.last_admission: Optional[dict] = None
        self.decode_tokens = 0
        self.prefill_batches = 0
        self.prefill_rows = 0
        self.prefill_real = 0
        self._window = sync_every

    # --------------------------------------------------------------- prefill
    @torch.no_grad()
    def prefill_logits(self, tokens, masks, lengths, cache_pos=None,
                       prefix_rows=None):
        """Batched prefill of one length bucket: tokens [B, pad], per-row
        aggregated masks [B, ...], lengths [B] -> (logits [B, V] at each
        row's last prompt token, mini KV cache [L, B, S, ...]).

        A prefix-bearing heterogeneous bank passes ``cache_pos [B]`` (P for
        a request whose profile selects a prefix slot, else 0) and
        ``prefix_rows = (pk, pv) [B, L, P, kv_dim]``: the rows are written
        into the mini cache at buffer slots [0, P) before the forward, so
        the prompt attends them through the ordinary cached path."""
        B, P = tokens.shape
        mini = MDL.init_cache(self.cfg, B, self.S, device=self.device)
        if prefix_rows is not None:
            KV, hd = self.cfg.num_kv_heads, self.cfg.head_dim
            for key, rows in zip(("k", "v"), prefix_rows):
                n = rows.shape[2]
                mini[key][:, :, :n] = rows.reshape(
                    rows.shape[:3] + (KV, hd)).transpose(0, 1).to(
                        mini[key].dtype)
        hidden, mini, _ = MDL.forward(
            self.params, tokens, self.cfg, profile_masks=masks, cache=mini,
            cache_pos=0 if cache_pos is None else cache_pos)
        idx = torch.clamp(lengths.long() - 1, 0, P - 1)
        last_h = hidden[torch.arange(B, device=hidden.device), idx][:, None]
        return MDL.lm_logits(self.params, last_h, self.cfg)[:, -1], mini

    def _insert(self, mini, slots) -> None:
        """Copy the real rows of a prefill's mini cache into the slots
        (batch is axis 1 of the stacked cache; padded rows are dropped)."""
        B = slots.shape[0]
        for key, big in self.cache.items():
            big[:, slots] = mini[key][:, :B].to(big.dtype)

    # ------------------------------------------------------------- hydration
    def _lookup(self, pids: List[int]):
        """Profile-cache hits of a wave, and its unique uncached pids in
        admission order."""
        entries = {}
        hits = misses = 0
        missing: List[int] = []
        for pid in pids:
            entry = self.profile_cache.get(pid)
            if entry is not None:
                hits += 1
                entries[pid] = entry
            else:
                misses += 1
                if pid not in missing:
                    missing.append(pid)
        return entries, hits, misses, missing

    def _wave_indices(self, pids: List[int]):
        """The pids' top-k (idx, w) pairs for both masks, padded with zero
        rows to a pow2 profile count, on the host: (idx [2, Mp, L, k],
        w [2, Mp, L, k]); the caller moves them in one transfer each."""
        M = len(pids)
        Mp = pow2_count(M)
        ia, wa, ib, wb = self.store.batch_sparse_indices(pids)
        pad_i = torch.zeros((Mp - M,) + tuple(ia.shape[1:]), dtype=ia.dtype)
        pad_w = torch.zeros((Mp - M,) + tuple(wa.shape[1:]), dtype=wa.dtype)
        idx = torch.stack([torch.cat([ia, pad_i]), torch.cat([ib, pad_i])])
        w = torch.stack([torch.cat([wa, pad_w]), torch.cat([wb, pad_w])])
        return idx, w

    def _prefix_gate(self, idx, M):
        """Host-side per-layer prefix gate of the first M profiles of a
        wave, from the same top-k indices the aggregation consumes (a
        selected index carries weight 1/k > 0, so idx-in-segment is
        exactly wsum > 0): (prefix_on [M] bool, prefix_skip [M, L] int32
        — 0 where the layer selected a prefix slot or the profile none at
        all, else P)."""
        off, cnt = self._prefix_seg
        ih = idx[:, :M]
        valid = ((ih >= off) & (ih < off + cnt)).any(-1).any(0)   # [M, L]
        on = valid.any(-1)
        skip = torch.where(valid | ~on[:, None], 0, self.prefix_len)
        return on, skip.to(torch.int32)

    def _admission_stats(self, path, pids, hits, misses, aggregated,
                         bank_bytes, **extra) -> None:
        R = len(pids)
        self.last_admission = dict(
            path=path, requests=R, cache_hits=hits, cache_misses=misses,
            unique_profiles=len(set(pids)), aggregated_profiles=aggregated,
            **extra, degraded=0, bank_bytes_per_request=bank_bytes // R)

    @torch.no_grad()
    def _hydrate_stacked(self, reqs: List[Request]) -> dict:
        """Stacked [R, ...] mask rows for an admission wave, or None with
        X-PEFT disabled. Per-step (``precompute=False``): each request's
        float mask weights and LN affines, straight from the store, no
        cache. Otherwise aggregated rows: profile-cache hits first; every
        missing profile aggregates against the bank in ONE call padded to
        a pow2 count, k-sparse for hard masks (one call per typed leaf of
        a heterogeneous bank), dense for soft ones. A prefix-bearing bank
        also sets each request's ``prefix_len`` (P or 0)."""
        if self.masks is None:
            return None
        pids = [int(r.profile_id) for r in reqs]
        if not self.precompute:
            w_a, w_b, ln_s, ln_b = self.store.batch_mask_weights(pids)
            self.last_admission = dict(
                path="per_step", requests=len(pids), cache_hits=0,
                cache_misses=len(pids), degraded=0,
                bank_bytes_per_request=0)
            return {key: t.to(self.device) for key, t in zip(
                self._entry_keys, (w_a, w_b, ln_s, ln_b))}
        if self.quant != "none":
            return self._hydrate_stacked_quant(pids)
        entries, hits, misses, missing = self._lookup(pids)
        bank = self.params["xpeft_bank"]
        xp = self.cfg.xpeft
        L = self.cfg.num_layers
        if self.hetero:
            # average bytes of one unified-space (layer, slot) row across
            # the typed segments: what one k-sparse selection reads
            slice_bytes = sum(v.numel() * v.element_size()
                              for v in bank.values()) // (L * xp.num_adapters)
        else:
            d, b = bank["bank_a"].shape[2:]
            # Â + B̂ bytes of one (layer, adapter) row
            slice_bytes = 2 * d * b * bank["bank_a"].element_size()
        aggregated = bank_bytes = 0
        path = "cached"
        if missing and self.store.mask_type == "soft":
            # soft masks are dense by construction: one einsum over the
            # whole bank for the padded wave
            M, Mp = len(missing), pow2_count(len(missing))
            w_a, w_b, ln_s, ln_b = self.store.batch_mask_weights(missing)
            pad = torch.zeros((Mp - M,) + tuple(w_a.shape[1:]))
            a_hat, b_hat = XP.precompute_effective_adapters_dense_batched(
                bank, torch.cat([w_a, pad]).to(self.device),
                torch.cat([w_b, pad]).to(self.device))
            agg = {"a_hat": a_hat, "b_hat": b_hat,
                   "ln_scale": ln_s.to(self.device),
                   "ln_bias": ln_b.to(self.device)}
            path, aggregated = "dense", Mp
            bank_bytes = xp.num_adapters * L * slice_bytes
            for i, pid in enumerate(missing):
                entry = {key: agg[key][i].clone()
                         for key in self._entry_keys}
                self.profile_cache.put(pid, entry)
                entries[pid] = entry
        elif missing:
            idx_h, w_h = self._wave_indices(missing)
            idx, w = idx_h.to(self.device), w_h.to(self.device)
            aggregated = idx.shape[1]
            if self.hetero:
                agg = XP.precompute_effective_adapters_sparse_hetero(
                    bank, idx[0], w[0], idx[1], w[1], xp)
            else:
                agg = dict(zip(("a_hat", "b_hat"),
                               XP.precompute_effective_adapters_sparse(
                                   bank, idx[0], w[0], idx[1], w[1], xp)))
            path = "sparse"
            bank_bytes = aggregated * idx.shape[-1] * L * slice_bytes
            ln_s, ln_b = (t.to(self.device)
                          for t in self.store.ln_affines(missing))
            agg["ln_scale"], agg["ln_bias"] = ln_s, ln_b
            if self.prefix_len:
                on, skip = self._prefix_gate(idx_h, len(missing))
                agg["prefix_skip"] = skip.to(self.device)
            for i, pid in enumerate(missing):
                # own copies: a view would pin the whole padded batch and
                # the cache's byte budget would undercount it
                entry = {key: agg[key][i].clone()
                         for key in self._entry_keys}
                if self.prefix_len:
                    # host-side flag, a 0-d tensor so the cache's byte
                    # budget counts it as JAX counts its np.int32
                    entry["prefix_on"] = on[i].to(torch.int32)
                self.profile_cache.put(pid, entry)
                entries[pid] = entry
        if self.prefix_len:
            for pid, r in zip(pids, reqs):
                r.prefix_len = self.prefix_len * int(
                    entries[pid]["prefix_on"])
        self._admission_stats(path, pids, hits, misses, aggregated,
                              bank_bytes)
        return self._stack(entries, pids)

    def _stack(self, entries, pids) -> dict:
        """The wave's entries stacked [R, ...], one leaf per entry key."""
        return {key: torch.stack([entries[pid][key] for pid in pids])
                for key in self._entry_keys}

    def _aggregate_sparse_quant(self, idx, w):
        """fp32 (Â, B̂) of the padded wave, from the quantized bank."""
        return XP.precompute_effective_adapters_sparse_quant(
            self.qbank, idx[0], w[0], idx[1], w[1], self.cfg.xpeft)

    def _requantize(self, a_hat, b_hat) -> dict:
        """Freshly aggregated fp32 rows into the cache/slot record layout
        (per row over the last axis, like the bank)."""
        group = self.cfg.xpeft.quant_group
        qa = QS.quantize(a_hat, self.quant, group=group)
        qb = QS.quantize(b_hat, self.quant, group=group)
        return {"a_q": qa["q"], "a_scale": qa["scale"],
                "b_q": qb["q"], "b_scale": qb["scale"]}

    @torch.no_grad()
    def _hydrate_stacked_quant(self, pids: List[int]) -> dict:
        """Quantized-bank hydration: cache hits first; missing profiles
        take the store's quantized aggregated records where it holds them
        (ZERO bank reads), the rest aggregate k-sparse against the
        quantized bank and re-quantize. Entries and slot buffers hold the
        quantized record layout (a_q, a_scale, b_q, b_scale and the LN
        affines)."""
        entries, hits, misses, missing = self._lookup(pids)
        L = self.cfg.num_layers
        aggregated = bank_bytes = store_hydrated = 0
        path = "cached"
        if missing:
            # persisted records fit only a store of the engine's layout
            rec_ok = (self.store.quant == self.quant
                      and self.store.quant_group == self.cfg.xpeft.quant_group)
            rec_pids = [p for p in missing
                        if rec_ok and self.store.has_quant_record(p)]
            agg_pids = [p for p in missing if p not in rec_pids]
            fresh = {}
            if agg_pids:
                idx, w = (t.to(self.device)
                          for t in self._wave_indices(agg_pids))
                aggregated = idx.shape[1]
                q = self._requantize(*self._aggregate_sparse_quant(idx, w))
                # true quantized row bytes read from the bank
                bank_bytes = aggregated * idx.shape[-1] * L \
                    * self._qrow_bytes
                for i, pid in enumerate(agg_pids):
                    fresh[pid] = {k: v[i].clone() for k, v in q.items()}
            if rec_pids:
                store_hydrated = len(rec_pids)
                recs = self.store.quant_records(rec_pids)
                for i, pid in enumerate(rec_pids):
                    fresh[pid] = {k: v[i].to(self.device, copy=True)
                                  for k, v in recs.items()}
            order = agg_pids + rec_pids  # the JAX engine's cache order
            ln_s, ln_b = (t.to(self.device)
                          for t in self.store.ln_affines(order))
            for i, pid in enumerate(order):
                entry = dict(fresh[pid], ln_scale=ln_s[i].clone(),
                             ln_bias=ln_b[i].clone())
                self.profile_cache.put(pid, entry)
                entries[pid] = entry
            path = ("quant_mixed" if agg_pids and rec_pids
                    else "quant_sparse" if agg_pids else "quant_store")
        self._admission_stats(path, pids, hits, misses, aggregated,
                              bank_bytes,
                              store_hydrated_profiles=store_hydrated,
                              scheme=self.quant)
        return self._stack(entries, pids)

    # ---------------------------------------------------------------- public
    def free_slots(self) -> List[int]:
        return [i for i, r in enumerate(self.slot_req) if r is None]

    def active_count(self) -> int:
        """Host-visible count of occupied slots (refreshed at syncs)."""
        return sum(r is not None for r in self.slot_req)

    @torch.no_grad()
    def admit_many(self, reqs: List[Request]) -> int:
        """Admit up to len(free_slots()) requests: one cache-aware batched
        hydration, one mask scatter, one prefill per length bucket, one
        slot-state scatter. Returns #admitted."""
        if self.slots.buf_fill:
            self.sync()  # flush the window before touching slot state
        free = self.free_slots()
        if len(reqs) > len(free):
            self.scheduler.requeue_front(reqs[len(free):])
            reqs = reqs[:len(free)]
        if not reqs:
            return 0
        assigned = free[:len(reqs)]
        stacked = self._hydrate_stacked(reqs)
        prefix_rows = None
        if self.prefix_len:
            # prefix KV rows go into the cache at prefill, not into the
            # slot buffers
            prefix_rows = (stacked.pop("prefix_k"), stacked.pop("prefix_v"))
        if stacked is not None:
            # ONE scatter into the per-slot buffers for the whole wave
            slot_t = torch.tensor(assigned, dtype=torch.long,
                                  device=self.device)
            for key, buf in self.masks.items():
                buf[slot_t] = stacked[key].to(buf.dtype)

        slot_of = {id(r): s for r, s in zip(reqs, assigned)}
        idx_of = {id(r): i for i, r in enumerate(reqs)}
        groups = self.scheduler.group_by_bucket(reqs)
        next_toks = {}
        for pad, group in sorted(groups.items()):
            B = len(group)
            Bp = pow2_count(B)
            toks = np.zeros((Bp, pad), np.int32)
            lens = np.ones((Bp,), np.int32)  # pad rows prefill at length 1
            for j, r in enumerate(group):
                toks[j, :len(r.prompt)] = r.prompt
                lens[j] = len(r.prompt)
            sel = torch.tensor([idx_of[id(r)] for r in group]
                               + [0] * (Bp - B), device=self.device)
            rows = None if stacked is None else \
                {key: t[sel] for key, t in stacked.items()}
            cpos = prows = None
            if prefix_rows is not None:
                # the prompt lands at buffer slot P for prefix-on requests,
                # 0 otherwise (pad rows at 0; dropped at insert)
                cpos = torch.tensor([r.prefix_len for r in group]
                                    + [0] * (Bp - B), dtype=torch.int32,
                                    device=self.device)
                prows = tuple(t[sel] for t in prefix_rows)
            logits, mini = self.prefill_logits(
                torch.from_numpy(toks).to(self.device), rows,
                torch.from_numpy(lens).to(self.device), cpos, prows)
            self._insert(mini, torch.tensor(
                [slot_of[id(r)] for r in group], device=self.device))
            nxt_h = torch.argmax(logits, dim=-1)[:B].cpu().numpy()
            for j, r in enumerate(group):
                next_toks[id(r)] = int(nxt_h[j])
            self.prefill_batches += 1
            self.prefill_rows += Bp
            self.prefill_real += B
        if self.last_admission is not None:
            self.last_admission["prefill_batches"] = len(groups)
            self.last_admission["prefill_occupancy"] = round(
                len(reqs) / max(sum(pow2_count(len(g))
                                    for g in groups.values()), 1), 3)

        # slot lengths include the hydrated prefix rows: the length is the
        # KV write position and the decode RoPE position, so a prefix-on
        # request continues at P + prompt
        toks_all = [next_toks[id(r)] for r in reqs]
        self.slots.admit(assigned, toks_all, [self._rlen(r) for r in reqs],
                         [r.max_new_tokens for r in reqs])
        for r, slot in zip(reqs, assigned):
            r.generated.append(next_toks[id(r)])
            if r.max_new_tokens <= 1 or self._rlen(r) >= self.S - 1:
                r.done = True  # budget spent by the prefill token
            else:
                self.slot_req[slot] = r
        self._refresh_window()
        return len(reqs)

    def _rlen(self, r) -> int:
        """Cache length of a request's prompt region: its hydrated prefix
        rows plus its prompt tokens."""
        return getattr(r, "prefix_len", 0) + len(r.prompt)

    def step(self) -> int:
        """One device decode step for all slots. Host state refreshes only
        at the window's sync; returns the host-visible active count as of
        the last sync (an upper bound on live slots)."""
        active = self.active_count()
        if not active:
            return 0
        self.cache = self.slots.step(self.params, self.cache, self.masks)
        if self.slots.buf_fill >= self._window:
            self.sync()
        return active

    def sync(self) -> int:
        """Device→host sync: hand the window's tokens to their requests,
        mark finished requests done and free their slots. Returns the
        number of still-active slots."""
        s = self.slots.sync()
        for i, req in enumerate(self.slot_req):
            if req is None:
                continue
            c = int(s.counts[i])
            if c:
                toks = s.tokens[i, :c]
                if (toks < 0).any():
                    raise RuntimeError("non-contiguous slot activity")
                req.generated.extend(int(t) for t in toks)
                self.decode_tokens += c
            if not s.active[i]:
                req.done = True
                self.slot_req[i] = None
        self._refresh_window()
        return self.active_count()

    def _refresh_window(self) -> None:
        # device capacity stop is lengths >= S-1 post-increment with
        # lengths = prefix + prompt + generated - 1, so a slot can still
        # emit S - prefix - prompt - generated tokens; the window is
        # bounded by the MAX remaining, so slots never dead-step after
        # everyone finished
        remaining = [min(r.max_new_tokens - len(r.generated),
                         self.S - self._rlen(r) - len(r.generated))
                     for r in self.slot_req if r is not None]
        bound = max(remaining) if remaining else self.sync_every
        self._window = max(1, min(self.sync_every, bound))

    def submit(self, reqs) -> None:
        """Queue requests with the scheduler (admitted as slots free up)."""
        self.scheduler.submit(reqs)

    def invalidate_profile(self, pid: int) -> bool:
        """Drop a profile's cached Â/B̂ (called by the store whenever the
        profile's record is added or replaced)."""
        return self.profile_cache.invalidate(pid)

    def run_until_drained(self, queue: Optional[List[Request]] = None,
                          max_steps: int = 10_000) -> int:
        """Serve until the queue and all slots are empty. Admission happens
        whenever the host view shows free slots (i.e. after syncs)."""
        if queue:
            self.scheduler.submit(list(queue))
        steps = 0
        while steps < max_steps:
            free = self.free_slots()
            if free and self.scheduler.pending():
                self.admit_many(self.scheduler.next_batch(len(free)))
            if not self.active_count():
                if not self.scheduler.pending():
                    break
                continue
            self.step()
            steps += 1
        if self.slots.buf_fill:
            self.sync()
        return steps

    def serve_stats(self) -> dict:
        """Counters the launcher prints (a subset of the JAX engine's)."""
        return {
            "bank_quant": self.quant,
            "host_syncs": self.slots.host_syncs,
            "device_steps": self.slots.device_steps,
            "decode_tokens": self.decode_tokens,
            "syncs_per_token": _rate(self.slots.host_syncs,
                                     self.decode_tokens),
            "sync_every": self.sync_every,
            "prefill_batches": self.prefill_batches,
            "prefill_occupancy": _rate(self.prefill_real,
                                       self.prefill_rows),
            "profile_cache": self.profile_cache.stats(),
        }
