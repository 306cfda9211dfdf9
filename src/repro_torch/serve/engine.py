"""Serving engine orchestrator: scheduler + slot state + profile cache.

The port of ``repro.serve.engine.ServeEngine``, windowed
(``continuous=False``) and continuous. With admission-time aggregation
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
every ``sync_every`` steps. Windowed, the window is bounded by the MOST
tokens any live request can still emit, and the slots decode in lockstep
waves. Continuous (``continuous=True``), the KV cache lives in a pool of
``page_size``-row pages addressed through a per-slot page table
(``serve/pages.py``), and the mask records in a pool of entries addressed
through a per-slot entry table; the window is bounded by the FEWEST
tokens any live request can still emit, so the sync lands when the first
slot frees, and every sync retires finished requests, frees their pages
and entries and admits or resumes into the freed slots. When the page
pool runs dry the youngest live request is swapped out to the host
(pages, mask record and slot scalars copied out byte for byte) and
resumed in order once pages free. Each decode step gathers a dense view
of the pages, runs the forward on it, and writes the one new position
back. With ``cfg.spec_enable`` each step is a self-speculation round:
``spec_gamma`` bare-PLM drafts under a zero-adapter view, one adapted
verify at T = gamma+1, and a commit of the accepted prefix plus one token
(greedy output equal to plain decoding).

Resilience: each wave's profiles are probed first (``fault_plan``'s
injected hydration faults retried under ``retry_policy``, then the
store's checksums); a request whose profile fails persistently, is
quarantined or unknown is served by the bare PLM (a zero-adapter entry,
``degraded``), never cached, while its peers decode as without the fault.
Observability (``obs``): spans, instants, counters and histograms at the
host boundaries the engine already has, fed at each sync by the slot
state's device accumulator, which comes back in the sync's one transfer.

Multi-device (``mesh=``, a ``torch.distributed`` ``DeviceMesh`` with a
"data" and/or "model" axis, one process per device, see
``launch/mesh.py``): every rank runs the same host loop on the same
requests, so the scheduler, allocators, profile cache and host mirrors
stay identical, and the device state is laid out as follows.

- Params and a quantized bank take JAX's ``param_specs(fsdp=False)``,
  the experts' ff dim kept off "data" (JAX pins it there; each data rank
  runs its own forwards, so a layer's gathers span "model" alone), and
  are held as this rank's blocks at rest (``distributed.sharding.place``);
  the model gathers a layer's whole weights before it runs the layer
  (JAX instead lets GSPMD split its matmuls over "model"), so every
  kernel runs its one-device code and the tokens equal the one-device
  engine's bitwise. Every forward runs under the mesh's
  ``mesh_context``: a MoE layer on a "model" axis dividing its experts
  then takes the expert-parallel path (``models/moe.py``), its experts
  kept as this rank's blocks. Where this differs from JAX's specs: an
  int4 bank's ``bank_b_q``/``bank_b_scale`` stay whole on every rank
  (planar packing pairs element i with i + d/2, so a byte slice is no
  d-slice).
- Admission aggregates each missing profile on the rank's d-slice of the
  bank (aggregation is elementwise in d, so each slice is bitwise the
  whole bank's) and gathers the aggregated entries over "model"; a
  quantized engine re-quantizes the gathered rows. Soft masks gather the
  bank and aggregate it whole.
- Slot-packed state (slot arrays, mask buffers, the entry pool and the
  tables) takes ``leading_axis_specs``: each data rank holds and steps
  only its own slots. The dense cache shards its slot axis over "data"
  and keeps the K/V heads whole (JAX: heads over "model"; no
  sequence-parallel fallback: a slot count "data" does not divide keeps
  the slots whole on every rank). The page pool shards its page axis
  over "data" when the data axis divides the pool and each shard holds
  one max-length request, else it stays whole; sharded, each shard's
  pool carries its own scratch page and a slot's pages come from its
  shard only (JAX's page colours, kept strictly).
- Each data rank prefills its own slots' rows of a wave and steps its
  own slots, so its GEMMs run at its share of the rows (the tokens stay
  the one-device engine's while a row's result does not depend on how
  many rows share the call); the ranks ``all_gather`` the wave's first
  tokens, and at each sync their slots' tokens and flags, over "data".
  A preempted slot's swapped rows come from the rank that held it, so
  it may resume on any shard.

``resident_bytes_per_device`` counts the layout it applies.
"""
from __future__ import annotations

import contextlib
import time
from typing import List, Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import obs as OBS
from repro_torch.analysis.bytes import bank_slice_bytes
from repro_torch.core import xpeft as XP
from repro_torch.core.profiles import ProfileStore
from repro_torch.distributed import ctx as CTX
from repro_torch.distributed import sharding as SH
from repro_torch.models import model as MDL
from repro_torch.obs import trace as TR
from repro_torch.quant import schemes as QS
from repro_torch.resilience import (InjectedHydrationError,
                                    RecordIntegrityError, RetryPolicy,
                                    retry_with_backoff)
from repro_torch.serve import pages as PG
from repro_torch.serve.profile_cache import ProfileCache
from repro_torch.serve.scheduler import Request, Scheduler
from repro_torch.serve.slots import SlotState
from repro_torch.serve.steps import greedy_next
from repro_torch.utils import pow2_count
from repro_torch.utils.tree import tree_leaves, tree_map


def _rate(num, den, nd: int = 4) -> float:
    """Rate field for serve_stats(): 0.0 when the denominator never
    ticked."""
    return round(num / den, nd) if den else 0.0


def _check_spec(cfg, *, continuous) -> None:
    """The JAX engine's refusals of speculation (ValueError). The
    megakernel's exclusivity is checked first: spec with decode_fused
    is refused whatever the mode."""
    if not cfg.spec_enable:
        return
    if cfg.decode_fused:
        raise ValueError(
            "spec_enable and decode_fused are exclusive per engine: "
            "verification runs a T=gamma+1 composed forward, which the T=1 "
            "megakernel cannot serve")
    if not continuous:
        raise ValueError("spec_enable requires continuous=True (drafting "
                         "rides the paged decode path)")
    if cfg.block_pattern != "attn":
        raise ValueError("spec_enable requires pure-attention blocks "
                         "(recurrent state cannot rewind rejected drafts)")
    if cfg.spec_gamma < 1:
        raise ValueError("spec_gamma must be >= 1")


def _check_hetero(cfg, store, *, precompute, max_seq) -> None:
    """The JAX engine's refusals for a heterogeneous bank (ValueError)."""
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
    if xp.has_prefix and cfg.spec_enable:
        raise ValueError(
            "spec_enable cannot serve a prefix-bearing bank_spec: bare-PLM "
            "drafts would attend the adapted prefix KV rows resident in the "
            "shared cache")
    if xp.has_prefix and cfg.block_pattern != "attn":
        raise ValueError("prefix segments require pure-attention blocks "
                         "(KV-row hydration)")
    if xp.has_prefix and not precompute:
        raise ValueError(
            "per-step mask serving cannot hydrate prefix KV rows; a "
            "prefix-bearing bank_spec requires precompute=True")
    if xp.has_prefix and xp.prefix_tokens >= max_seq - 1:
        raise ValueError("prefix_tokens must leave room for the prompt "
                         f"(max_seq={max_seq})")


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


def _check_slice(cfg, store, *, precompute, max_seq, continuous) -> None:
    _check_spec(cfg, continuous=continuous)
    _check_hetero(cfg, store, precompute=precompute, max_seq=max_seq)
    _check_quant(cfg, store, precompute=precompute)
    MDL.check_supported(cfg)


def _local(tree):
    """The blocks this rank holds of a placed tree."""
    return tree_map(lambda v: v.local if isinstance(v, SH.Sharded) else v,
                    tree)


# the bank leaf each aggregated entry leaf is a d-slice of, with the same
# dims split (bank [L, N, d, b] -> entry [P, L, d, b])
_ENTRY_SOURCE = {"a_hat": "bank_a", "b_hat": "bank_b", "lora_a": "lora_a",
                 "lora_b": "lora_b"}
_ENTRY_SOURCE_QUANT = {"a_hat": "bank_a_q", "b_hat": "bank_b_q"}



def serving_param_specs(params, mesh):
    """The specs a serving mesh holds the params under: JAX's
    ``param_specs(fsdp=False)``, with no leaf over "data" (JAX pins the
    experts' ff dim there): data ranks run their own forwards, out of
    step, so a forward's gathers may span "model" alone."""
    return SH.param_specs(params, mesh, fsdp=False,
                          logical_map={"mlp_fsdp": None})

class ServeEngine:
    def __init__(self, cfg, params, store: ProfileStore, *,
                 max_slots: int = 4, max_seq: int = 256,
                 precompute: bool = True, sync_every: int = 8,
                 cache_bytes: Optional[int] = 64 << 20,
                 continuous: bool = False, page_size: int = 16,
                 max_pages: Optional[int] = None,
                 mask_pages: Optional[int] = None,
                 max_wait_waves: Optional[int] = None, mesh=None,
                 fault_plan=None,
                 retry_policy: Optional[RetryPolicy] = None,
                 obs: Optional[OBS.Observability] = None):
        _check_slice(cfg, store, precompute=precompute, max_seq=max_seq,
                     continuous=continuous)
        self.cfg = cfg
        self.store = store
        # observability: the slot state's device accumulator exists either
        # way (the steps launch the same kernels); a bundle only turns on
        # the host-side spans, counters and histograms at the boundaries
        # the engine already has. The port compiles no decode step yet, so
        # no retrace watch is registered (JAX watches its jitted step,
        # admit scatter and prefill).
        self.obs = OBS.get(obs)
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
        self._mesh_setup(mesh, max_slots)
        if mesh is not None:
            self._specs["params"] = serving_param_specs(params, mesh)
            params = SH.place(params, self._specs["params"], mesh)
            if self.qbank is not None:
                specs = SH.param_specs(self.qbank, mesh, fsdp=False)
                if self.quant == "int4":
                    # planar int4 pairs element i with i + d/2 in a byte:
                    # a byte slice of bank_b's rows is no d-slice
                    for key in ("bank_b_q", "bank_b_scale"):
                        specs[key] = SH.P(*[None] * self.qbank[key].ndim)
                self._specs["qbank"] = specs
                self.qbank = SH.place(self.qbank, specs, mesh)
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
        self.continuous = continuous
        self.page_size = page_size
        # self-speculation: the zero-adapter view (bitwise the bare PLM)
        # drafts spec_gamma tokens per slot per round, the adapted model
        # verifies them in one T=gamma+1 forward
        self.spec = bool(cfg.spec_enable)
        self.spec_gamma = int(cfg.spec_gamma)
        dev = self.device
        # the cache: a dense [lead, n_slots, S, ...] block (windowed), or
        # page pools + a per-slot page table (continuous). A pure-recurrent
        # arch has no sequence-axis leaf: the pool degenerates away (no
        # allocator, no page growth or preemption) and the continuous
        # engine still admits mid-stream into pooled mask entries.
        self._paged = False
        self.page_alloc = None
        self.n_pages = 0
        if continuous:
            # the host mirror of the page table is the allocator's view
            template = MDL.init_cache(cfg, max_slots, max_seq, device="meta")
            self._paged = PG.paged_seq_len(template) > 0
            if self._paged:
                if max_seq % page_size:
                    raise ValueError(f"max_seq {max_seq} must be a multiple "
                                     f"of page_size {page_size}")
                per_req = PG.pages_needed(max_seq, page_size)
                self.n_pages = (max_pages if max_pages is not None
                                else max_slots * per_req)
                if self.n_pages < per_req:
                    raise ValueError(
                        f"max_pages={self.n_pages} cannot hold one "
                        f"max-length request ({per_req} pages) — the engine "
                        "could deadlock instead of preempting")
                # a slot's pages live on its data shard when the pool
                # splits into shards that each hold one max-length request
                self._page_shard = self._slot_shard \
                    and self.n_pages % self._D == 0 \
                    and self.n_pages // self._D >= per_req
                self.page_alloc = PG.PageAllocator(
                    self.n_pages,
                    n_colors=self._D if self._page_shard else 1)
            self._pages_local = self.n_pages // self._D \
                if self._page_shard else self.n_pages
            template = MDL.init_cache(cfg, self._n_local, max_seq,
                                      device="meta")
            self.cache = PG.make_paged_cache(
                template, max(self._pages_local, 1), page_size,
                self._n_local, device=dev)
            self._mp = int(self.cache["table"].shape[1])
            self._sentinel = max(self.n_pages, 1)
            self._page_table_h = np.full((max_slots, self._mp),
                                         self._sentinel, np.int32)
        else:
            self.cache = MDL.init_cache(cfg, self._n_local, max_seq,
                                        device=dev)
        self.slot_req: List[Optional[Request]] = [None] * max_slots
        # resilience: admission probes each profile (with retry) before
        # hydration; a request whose profile can't be served degrades to
        # the bare PLM (a zero-adapter entry) instead of failing its wave
        self.fault_plan = fault_plan
        self.retry_policy = retry_policy or RetryPolicy()
        self.degraded_requests = 0
        self.hydration_retries = 0
        self.slot_degraded: List[bool] = [False] * max_slots
        # continuous mode admits in small increments (1-2 freed slots), so
        # largest-bucket-first keeps prefill launches full; max_wait_waves
        # (default 4 there) stops that from starving rare lengths. The
        # windowed engine keeps strict head-first FIFO (no promotion
        # unless asked).
        if max_wait_waves is None and continuous:
            max_wait_waves = 4
        self.scheduler = Scheduler(
            cfg.block_pattern, policy="efficiency" if continuous else "fifo",
            max_wait_waves=max_wait_waves)
        self.profile_cache = ProfileCache(cache_bytes)
        # re-graduation hook: a re-added profile never serves a stale
        # cached aggregate (the store holds this bound method weakly)
        store.subscribe(self.invalidate_profile)
        # continuous mode: the mask records live in an ENTRY POOL of
        # ``mask_pages`` entries (one entry = one admitted request's
        # record, the adapter-state analogue of a KV page; default one per
        # slot) addressed through a per-slot table. On a mesh a pool of one
        # entry per slot splits over "data" as the slots do; any other
        # size is held whole on every rank, so its allocator decides as
        # one device's does.
        self.n_mask_entries = max_slots
        if continuous:
            self.n_mask_entries = (mask_pages if mask_pages is not None
                                   else max_slots)
            if self.n_mask_entries < 1:
                raise ValueError("mask_pages must be >= 1")
        self._entry_shard = self._slot_shard \
            and self.n_mask_entries == max_slots
        self._entries_local = self._n_local if self._entry_shard \
            else self.n_mask_entries
        self._entry_keys = self._entry_key_set()
        self.masks = self._mask_buffers(self._entries_local)
        self.mask_alloc = None
        self._masks_view = self._zero_view = None
        if continuous and self.masks is not None:
            self.mask_alloc = PG.PageAllocator(
                self.n_mask_entries,
                n_colors=self._D if self._entry_shard else 1)
            self._mask_table_h = np.full((max_slots,), self.n_mask_entries,
                                         np.int32)
            self.masks = {"pool": self.masks,
                          "table": torch.from_numpy(
                              self._local_entries(self._mask_table_h)).to(
                                  dev)}
            # the step reads a slot-indexed VIEW of the pool, gathered
            # again only when an entry table moves (at host syncs)
            self._masks_view = self._mask_buffers(self._n_local)
            if self.spec:
                # the drafts' constant zero-adapter view (identity LN): the
                # draft model IS the bare PLM
                self._zero_view = self._mask_buffers(self._n_local)
        self.slots = SlotState(
            max_slots, max_seq, sync_every, self._decode_fn(), device=dev,
            spec_width=self.spec_gamma + 1 if self.spec else 1,
            local=(self._lo, self._lo + self._n_local),
            gather=self._gather_slots if self._slot_shard else None)
        if mesh is not None:
            self._state_specs()
        # what the last admission did (path, cache hits, bank bytes,
        # prefill occupancy), as the JAX engine reports it
        self.last_admission: Optional[dict] = None
        self.decode_tokens = 0
        self.prefill_batches = 0
        self.prefill_rows = 0
        self.prefill_real = 0
        # speculation accounting: drafts offered vs accepted, totals and
        # per request (uid-keyed, so it survives preempt/resume)
        self.spec_drafted = 0
        self.spec_accepted = 0
        self._spec_by_uid: dict = {}
        self._window = sync_every
        # continuous-batching state: admission-order stamps (preempt the
        # youngest), the preempted-request resume queue (oldest first),
        # and the capacity accounting serve_stats reports
        self._slot_seq = [0] * max_slots
        self._admit_seq = 0
        self._resume_q: List[dict] = []
        self._backlog = False
        self._tables_dirty = True
        self._view_dirty = True
        self.preemptions = 0
        self.resumes = 0
        self.useful_slot_steps = 0
        self.stranded_slot_steps = 0
        self._win_t0 = time.perf_counter()  # host time the window opened

    # ------------------------------------------------------------------ mesh
    def _mesh_setup(self, mesh, max_slots: int) -> None:
        """The mesh's axis sizes and this rank's slots: [lo, lo +
        n_local) of the data axis's even split when it divides the slot
        count, else every slot."""
        self.mesh = mesh
        sizes = SH.axis_sizes(mesh) if mesh is not None else {}
        self._n_devices = int(np.prod(list(sizes.values()) or [1]))
        self._D = sizes.get("data", 1)
        self._slot_shard = self._D > 1 and max_slots % self._D == 0
        self._dr = mesh.get_local_rank("data") if self._slot_shard else 0
        self._n_local = max_slots // self._D if self._slot_shard \
            else max_slots
        self._lo = self._dr * self._n_local
        self._page_shard = False
        self._specs = {}

    def _mine(self, i: int) -> Optional[int]:
        """This rank's row of slot (or mask entry) ``i``, or None where
        another data rank holds it."""
        j = i - self._lo
        return j if 0 <= j < self._n_local else None

    def _mine_entry(self, e: int) -> Optional[int]:
        """This rank's row of mask entry ``e`` (a windowed engine's entries
        are its slots): every entry of a pool held whole, else the entries
        of this rank's slots."""
        return self._mine(e) if self._entry_shard else e

    def _color(self, slot: int) -> int:
        """The data shard of a slot: its pages' and entry's colour."""
        return slot // self._n_local if self._slot_shard else 0

    def _local_entries(self, table_h):
        """This rank's rows of the host entry table, as indices into its
        entry pool (the sentinel as the pool's size)."""
        t = table_h[self._lo:self._lo + self._n_local]
        off = self._lo if self._entry_shard else 0
        return np.where(t >= self.n_mask_entries, self._entries_local,
                        t - off).astype(np.int32)

    def _local_pages(self, table_h):
        """Rows of the host page table as indices into this rank's pool
        (a sharded pool: the shard's own pages, the sentinel as its
        scratch page)."""
        if not self._page_shard:
            return table_h
        off = self._dr * self._pages_local
        return np.where(table_h >= self.n_pages, self._pages_local,
                        table_h - off).astype(np.int32)

    def _gather_slots(self, packed):
        """Every data rank's packed slot rows, in slot order."""
        return torch.cat(SH.all_gather(packed, self.mesh.get_group("data")))

    def _gather_first_tokens(self, reqs, next_toks: dict) -> dict:
        """Every request's prefill token, each from the data rank that
        prefilled it (one ``all_gather`` over "data" per wave)."""
        mine = torch.tensor([next_toks.get(id(r), -1) for r in reqs],
                            dtype=torch.long, device=self.device)
        got = torch.stack(SH.all_gather(mine, self.mesh.get_group("data")))
        return dict(zip(map(id, reqs), got.max(0).values.tolist()))

    def _from_owner(self, tree, owner: int):
        """``tree`` as the data rank ``owner`` holds it (every rank passes
        a tree of the same shapes)."""
        group = self.mesh.get_group("data")
        return tree_map(lambda x: SH.all_gather(x, group)[owner], tree)

    def _gather_entry(self, agg: dict, bank: dict, source: dict) -> dict:
        """Aggregated entry leaves computed on this rank's d-slice of the
        bank, gathered whole over the dims their bank leaf is split on."""
        for key, name in source.items():
            leaf = bank.get(name)
            if key in agg and isinstance(leaf, SH.Sharded):
                agg[key] = SH.gather(agg[key], leaf.spec, self.mesh)
        return agg

    def _state_specs(self) -> None:
        """The specs of the slot-packed device state as this engine lays
        it out, for ``resident_bytes_per_device``."""
        data = "data" if self._slot_shard else None

        def lead(x, axis=data):
            return SH.P(axis, *[None] * (x.ndim - 1))

        def dim1(x, axis=data):
            return SH.P(None, axis, *[None] * (x.ndim - 2))

        if self.continuous:
            page = "data" if self._page_shard else None
            self._specs["cache"] = {
                "data": PG._map(lambda p, x: dim1(
                    x, page if PG.leaf_is_paged(p) else data),
                    self.cache["data"]),
                "table": lead(self.cache["table"])}
        else:
            self._specs["cache"] = tree_map(dim1, self.cache)
        if self.continuous and self.masks is not None:
            pool = data if self._entry_shard else None
            self._specs["masks"] = {
                "pool": tree_map(lambda x: lead(x, pool),
                                 self.masks["pool"]),
                "table": lead(self.masks["table"])}
        elif self.masks is not None:
            self._specs["masks"] = tree_map(lead, self.masks)

    def _entry_key_set(self) -> tuple:
        """The leaves one hydrated entry carries. The mask buffers hold
        the same leaves minus a prefix bank's ROWS (they go into the KV
        cache at prefill; only the per-layer skip gate rides with
        decode)."""
        xp = self.cfg.xpeft
        if not xp.enabled:
            return ()
        if not self.precompute:
            return ("w_a", "w_b", "ln_scale", "ln_bias")
        if self.quant != "none":
            return ("a_q", "a_scale", "b_q", "b_scale", "ln_scale",
                    "ln_bias")
        if self.hetero:
            return XP.hetero_entry_keys(xp) + (
                ("prefix_skip",) if self.prefix_len else ())
        return ("a_hat", "b_hat", "ln_scale", "ln_bias")

    def _mask_buffers(self, lead: int):
        """Zeroed mask buffers with ``lead`` rows (identity LN): the
        windowed engine's per-slot buffers, or the continuous engine's
        entry pool and its slot views. None with X-PEFT disabled. A
        zeroed row is the bare PLM's record: the adapter adds exactly 0."""
        cfg, xp, dev = self.cfg, self.cfg.xpeft, self.device
        L, b, d = cfg.num_layers, xp.bottleneck, cfg.d_model
        dt = MDL.torch_dtype(cfg.dtype)
        if not xp.enabled:
            return None
        if not self.precompute:
            # per-step: each slot's float mask weights and LN affines, which
            # every prefill and decode step aggregates against the bank
            N = xp.num_adapters
            return {"w_a": torch.zeros((lead, L, N), device=dev),
                    "w_b": torch.zeros((lead, L, N), device=dev),
                    "ln_scale": torch.ones((lead, L, b), device=dev),
                    "ln_bias": torch.zeros((lead, L, b), device=dev)}
        if self.quant != "none":
            # QUANTIZED Â/B̂ records + fp16 scales, read by the decode
            # step and widened in registers
            aq_s, aq_dt, as_s = QS.quant_spec((lead, L, d, b), self.quant,
                                              group=xp.quant_group)
            bq_s, bq_dt, bs_s = QS.quant_spec((lead, L, b, d), self.quant,
                                              group=xp.quant_group)
            f16, f32 = torch.float16, torch.float32
            return {
                "a_q": torch.zeros(aq_s, dtype=aq_dt, device=dev),
                "a_scale": torch.zeros(as_s, dtype=f16, device=dev),
                "b_q": torch.zeros(bq_s, dtype=bq_dt, device=dev),
                "b_scale": torch.zeros(bs_s, dtype=f16, device=dev),
                "ln_scale": torch.ones((lead, L, b), dtype=f32, device=dev),
                "ln_bias": torch.zeros((lead, L, b), dtype=f32, device=dev)}
        shapes = {
            "a_hat": ((L, d, b), dt), "b_hat": ((L, b, d), dt),
            "ln_scale": ((L, b), torch.float32),
            "ln_bias": ((L, b), torch.float32),
            "lora_a": ((L, d, b), dt), "lora_b": ((L, b, d), dt),
            "ia3_s": ((L, d), dt), "prefix_skip": ((L,), torch.int32),
        }
        return {key: (torch.ones if key == "ln_scale" else torch.zeros)(
                    (lead,) + shapes[key][0], dtype=shapes[key][1],
                    device=dev)
                for key in self._entry_keys if key in shapes}

    def _mesh_ctx(self):
        """The mesh context every forward of a mesh engine runs under (a
        MoE layer then takes the expert-parallel path, as JAX's does under
        ``mesh_context``)."""
        return CTX.mesh_context(self.mesh) if self.mesh is not None \
            else contextlib.nullcontext()

    def _decode_fn(self):
        """The model half of the slot step, for this engine's mode (see
        ``SlotState``), under the engine's mesh context."""
        fn = self._mode_decode_fn()

        def decode_fn(*args):
            with self._mesh_ctx():
                return fn(*args)
        return decode_fn if self.mesh is not None else fn

    def _mode_decode_fn(self):
        cfg, ps = self.cfg, self.page_size
        if not self.continuous:
            def decode_fn(params, cache, last_tok, lengths, masks, active):
                hidden, cache, _ = MDL.forward(
                    params, last_tok[:, None], cfg, profile_masks=masks,
                    cache=cache, cache_pos=lengths)
                return greedy_next(MDL.lm_logits(params, hidden, cfg)), cache
            return decode_fn
        if not self.spec:
            # paged decode: gather the pages back to the dense layout the
            # forward takes (junk pages cover only masked positions), run
            # the step on it, scatter the one written position back. Masks
            # arrive as the slot-indexed view of the entry pool.
            def decode_fn(params, cache, last_tok, lengths, masks, active):
                dense = PG.dense_view(cache["data"], cache["table"], ps)
                hidden, dense, _ = MDL.forward(
                    params, last_tok[:, None], cfg, profile_masks=masks,
                    cache=dense, cache_pos=lengths)
                PG.writeback(cache["data"], dense, cache["table"], lengths,
                             active, ps)
                return greedy_next(MDL.lm_logits(params, hidden, cfg)), cache
            return decode_fn
        gamma, W = self.spec_gamma, self.spec_gamma + 1

        # a speculation round: gamma bare-PLM draft steps over the paged
        # T=1 decode, then ONE adapted T=gamma+1 verify at each slot's own
        # offset. The verify rewrites the drafts' bare KV with adapted KV
        # before attending (write-then-read inside forward), and
        # writeback_span commits the whole span to pages: positions past
        # the accepted prefix hold stale KV that the causal mask hides and
        # the next round overwrites.
        def decode_fn(params, cache, last_tok, lengths, masks, active):
            adapted = None if masks is None else masks["adapted"]
            zero = None if masks is None else masks["zero"]
            data, table = cache["data"], cache["table"]
            tok, pos, drafts = last_tok, lengths, []
            for _ in range(gamma):
                dense = PG.dense_view(data, table, ps)
                hidden, dense, _ = MDL.forward(
                    params, tok[:, None], cfg, profile_masks=zero,
                    cache=dense, cache_pos=pos)
                # near capacity a draft can point past S-1: its KV write is
                # dropped (such positions are never committed)
                PG.writeback(data, dense, table, pos, active & (pos < self.S),
                             ps)
                tok = greedy_next(MDL.lm_logits(params, hidden, cfg))
                drafts.append(tok)
                pos = pos + 1
            drafts = torch.stack(drafts, dim=1)               # [n, gamma]
            seq = torch.cat([last_tok[:, None], drafts], dim=1)
            dense = PG.dense_view(data, table, ps)
            hidden, dense, _ = MDL.forward(
                params, seq, cfg, profile_masks=adapted, cache=dense,
                cache_pos=lengths)
            PG.writeback_span(data, dense, table, lengths, W, active, ps)
            logits = MDL.lm_logits(params, hidden, cfg)
            # the same argmax as greedy_next, one per position
            toks = torch.argmax(logits, dim=-1).to(torch.int32)
            match = (drafts == toks[:, :gamma]).to(torch.int32)
            n_acc = torch.cumprod(match, dim=1).sum(dim=1)
            return toks, n_acc, cache
        return decode_fn

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
        with self._mesh_ctx():
            hidden, mini, _ = MDL.forward(
                self.params, tokens, self.cfg, profile_masks=masks,
                cache=mini, cache_pos=0 if cache_pos is None else cache_pos)
        idx = torch.clamp(lengths.long() - 1, 0, P - 1)
        last_h = hidden[torch.arange(B, device=hidden.device), idx][:, None]
        return MDL.lm_logits(self.params, last_h, self.cfg)[:, -1], mini

    def _insert(self, mini, slots) -> None:
        """Copy the real rows of a prefill's mini cache into the slots
        (batch is axis 1 of the stacked cache; padded rows are dropped)."""
        B = slots.shape[0]
        for key, big in self.cache.items():
            big[:, slots] = mini[key][:, :B].to(big.dtype)

    # ------------------------------------------------------------ resilience
    def _zero_entry(self) -> dict:
        """One request's bare-PLM entry: the free-slot buffer template (all
        zero, identity LN). A zero adapter adds exactly 0 to the residual,
        so a degraded request decodes as with X-PEFT disabled. A prefix
        bank's zero ROWS complete the layout; a degraded request admits with
        prefix_len 0 (prompt at slot 0), so they are never attended."""
        pool = self.masks["pool"] if self.continuous else self.masks
        zero = {k: torch.zeros_like(v[0]) for k, v in pool.items()}
        if "ln_scale" in zero:
            zero["ln_scale"] = torch.ones_like(zero["ln_scale"])
        if self.prefix_len:
            shape = (self.cfg.num_layers, self.prefix_len, self.cfg.kv_dim)
            dt = MDL.torch_dtype(self.cfg.dtype)
            zero["prefix_k"] = torch.zeros(shape, dtype=dt,
                                           device=self.device)
            zero["prefix_v"] = torch.zeros(shape, dtype=dt,
                                           device=self.device)
        return zero

    def _probe_profile(self, pid: int) -> bool:
        """Health probe of one profile before hydration, with retry: an
        injected transient hydration failure is retried under the
        engine's deadline-bounded backoff; a persistent failure, a
        quarantined or corrupt record or an unknown pid returns False (the
        caller degrades those requests). ``check_record`` may shed a
        corrupt quantized agg payload and still pass (the masks re-hydrate
        the profile from the bank)."""
        attempt = [0]

        def probe():
            i, attempt[0] = attempt[0], attempt[0] + 1
            if self.fault_plan is not None:
                self.fault_plan.on_hydration(pid, i)
            self.store.check_record(pid)

        def on_retry(exc, a, delay):
            self.hydration_retries += 1
            self.obs.metrics.inc("serve.hydration_retries")
            self.obs.metrics.observe("serve.hydration_retry_delay_us",
                                     delay * 1e6, "us")
            self.obs.tracer.instant(TR.CAT_RESILIENCE, "hydration_retry",
                                    profile=pid, attempt=a)

        try:
            retry_with_backoff(probe, policy=self.retry_policy,
                               retry_on=(InjectedHydrationError,),
                               seed=pid, on_retry=on_retry)
            return True
        except (InjectedHydrationError, RecordIntegrityError, KeyError):
            return False

    def _probe_wave(self, reqs: List[Request]) -> None:
        """Mark the requests whose profile cannot be served as degraded
        (each unique pid probed once a wave)."""
        verdict = {}
        for r in reqs:
            pid = int(r.profile_id)
            if pid not in verdict:
                verdict[pid] = self._probe_profile(pid)
        if self.mesh is not None and self.fault_plan is not None \
                and verdict:
            # retries end on a wall-clock deadline: the ranks agree (a
            # profile any rank failed degrades on all), so their host
            # loops stay one
            t = torch.tensor(list(verdict.values()), dtype=torch.int32,
                             device=self.device)
            dist.all_reduce(t, op=dist.ReduceOp.MIN)
            verdict = dict(zip(verdict, map(bool, t.tolist())))
        for r in reqs:
            pid = int(r.profile_id)
            if not verdict[pid] and not r.degraded:
                r.degraded = True
                self.degraded_requests += 1
                self.obs.metrics.inc("serve.degraded_requests")
                self.obs.tracer.instant(TR.CAT_RESILIENCE, "degraded",
                                        profile=pid, uid=r.uid)

    # ------------------------------------------------------------- hydration
    def _lookup(self, reqs: List[Request]):
        """Profile-cache hits of a wave, and its unique uncached pids in
        admission order; degraded requests are never looked up."""
        entries = {}
        hits = misses = 0
        missing: List[int] = []
        for r in reqs:
            if r.degraded:
                continue  # bare-PLM entry; never cached, never aggregated
            pid = int(r.profile_id)
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

    def _admission_stats(self, path, reqs, hits, misses, aggregated,
                         bank_bytes, **extra) -> None:
        R = len(reqs)
        self.last_admission = dict(
            path=path, requests=R, cache_hits=hits, cache_misses=misses,
            unique_profiles=len({int(r.profile_id) for r in reqs}),
            aggregated_profiles=aggregated, **extra,
            degraded=sum(r.degraded for r in reqs),
            bank_bytes_per_request=bank_bytes // R)

    @torch.no_grad()
    def _hydrate_stacked(self, reqs: List[Request]) -> dict:
        """Stacked [R, ...] mask rows for an admission wave, or None with
        X-PEFT disabled. Per-step (``precompute=False``): each request's
        float mask weights and LN affines, straight from the store, no
        cache. Otherwise aggregated rows: profile-cache hits first; every
        missing profile aggregates against the bank in ONE call padded to
        a pow2 count, k-sparse for hard masks (one call per typed leaf of
        a heterogeneous bank), dense for soft ones. A prefix-bearing bank
        also sets each request's ``prefix_len`` (P or 0). A degraded
        request takes the zero entry (``_zero_entry``)."""
        if self.masks is None:
            return None
        pids = [int(r.profile_id) for r in reqs]
        if not self.precompute:
            ok = [i for i, r in enumerate(reqs) if not r.degraded]
            self.last_admission = dict(
                path="per_step", requests=len(pids), cache_hits=0,
                cache_misses=len(ok), degraded=len(pids) - len(ok),
                bank_bytes_per_request=0)
            got = dict(zip(self._entry_keys, (
                t.to(self.device) for t in self.store.batch_mask_weights(
                    [pids[i] for i in ok])))) if ok else {}
            if len(ok) == len(reqs):
                return got
            zero, row = self._zero_entry(), {i: j for j, i in enumerate(ok)}
            return {key: torch.stack([got[key][row[i]] if i in row
                                      else zero[key]
                                      for i in range(len(reqs))])
                    for key in self._entry_keys}
        if self.quant != "none":
            return self._hydrate_stacked_quant(reqs)
        entries, hits, misses, missing = self._lookup(reqs)
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
            slice_bytes = bank_slice_bytes(
                d, b, itemsize=bank["bank_a"].element_size())
        aggregated = bank_bytes = 0
        path = "cached"
        if missing and self.store.mask_type == "soft":
            # soft masks are dense by construction: one einsum over the
            # whole bank for the padded wave
            M, Mp = len(missing), pow2_count(len(missing))
            w_a, w_b, ln_s, ln_b = self.store.batch_mask_weights(missing)
            pad = torch.zeros((Mp - M,) + tuple(w_a.shape[1:]))
            a_hat, b_hat = XP.precompute_effective_adapters_dense_batched(
                SH.whole_tree(bank), torch.cat([w_a, pad]).to(self.device),
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
            # on a mesh: this rank's d-slice of the bank, then the entries
            # gathered whole
            if self.hetero:
                agg = XP.precompute_effective_adapters_sparse_hetero(
                    _local(bank), idx[0], w[0], idx[1], w[1], xp)
            else:
                agg = dict(zip(("a_hat", "b_hat"),
                               XP.precompute_effective_adapters_sparse(
                                   _local(bank), idx[0], w[0], idx[1], w[1],
                                   xp)))
            agg = self._gather_entry(agg, bank, _ENTRY_SOURCE)
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
                r.prefix_len = 0 if r.degraded else self.prefix_len * int(
                    entries[pid]["prefix_on"])
        self._admission_stats(path, reqs, hits, misses, aggregated,
                              bank_bytes)
        return self._stack(entries, reqs)

    def _stack(self, entries, reqs) -> dict:
        """The wave's entries stacked [R, ...], one leaf per entry key, a
        degraded request's the zero entry."""
        zero = self._zero_entry() if any(r.degraded for r in reqs) else None
        return {key: torch.stack([zero[key] if r.degraded
                                  else entries[int(r.profile_id)][key]
                                  for r in reqs])
                for key in self._entry_keys}

    def _aggregate_sparse_quant(self, idx, w):
        """fp32 (Â, B̂) of the padded wave, from the quantized bank (on a
        mesh: its d-slices, gathered whole before re-quantization)."""
        agg = dict(zip(("a_hat", "b_hat"),
                       XP.precompute_effective_adapters_sparse_quant(
                           _local(self.qbank), idx[0], w[0], idx[1], w[1],
                           self.cfg.xpeft)))
        agg = self._gather_entry(agg, self.qbank, _ENTRY_SOURCE_QUANT)
        return agg["a_hat"], agg["b_hat"]

    def _requantize(self, a_hat, b_hat) -> dict:
        """Freshly aggregated fp32 rows into the cache/slot record layout
        (per row over the last axis, like the bank)."""
        group = self.cfg.xpeft.quant_group
        qa = QS.quantize(a_hat, self.quant, group=group)
        qb = QS.quantize(b_hat, self.quant, group=group)
        return {"a_q": qa["q"], "a_scale": qa["scale"],
                "b_q": qb["q"], "b_scale": qb["scale"]}

    @torch.no_grad()
    def _hydrate_stacked_quant(self, reqs: List[Request]) -> dict:
        """Quantized-bank hydration: cache hits first; missing profiles
        take the store's quantized aggregated records where it holds them
        (ZERO bank reads), the rest aggregate k-sparse against the
        quantized bank and re-quantize. Entries and slot buffers hold the
        quantized record layout (a_q, a_scale, b_q, b_scale and the LN
        affines)."""
        entries, hits, misses, missing = self._lookup(reqs)
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
        self._admission_stats(path, reqs, hits, misses, aggregated,
                              bank_bytes,
                              store_hydrated_profiles=store_hydrated,
                              scheme=self.quant)
        return self._stack(entries, reqs)

    # ------------------------------------------------------- paged memory
    def _push_tables(self) -> None:
        """Copy the host page/entry table mirrors to the device, only when
        a mutator marked them dirty (a sync that retired nothing costs no
        transfer)."""
        if not self._tables_dirty:
            return
        self._tables_dirty = False
        rows = self._page_table_h[self._lo:self._lo + self._n_local]
        self.cache["table"] = torch.from_numpy(self._local_pages(rows)).to(
            self.device)
        if self.mask_alloc is not None:
            self.masks["table"] = torch.from_numpy(
                self._local_entries(self._mask_table_h)).to(self.device)

    def _reserve_resources(self, reqs: List[Request],
                           slots: List[int]) -> List[Request]:
        """Claim a mask entry + prompt-covering pages for each admission
        candidate (``reqs[k]`` goes to ``slots[k]``, whose shard they come
        from on a mesh); requests the pools can't hold yet go back to the
        FRONT of the scheduler queue (admission never preempts running
        requests — only page growth for already-running slots does)."""
        kept: List[Request] = []
        for k, r in enumerate(reqs):
            try:
                self._alloc_entry(r.uid, slots[k])
                # pages cover the hydrated prefix rows too, resolved from
                # the store before hydration
                self._alloc_pages(self._req_prefix_len(r) + len(r.prompt),
                                  r.uid, slots[k])
            except PG.PageOOM:
                self.scheduler.requeue_front(reqs[k:])
                break
            kept.append(r)
        return kept

    def _pages_for(self, length: int) -> int:
        return PG.pages_needed(length, self.page_size) if self._paged else 0

    def _alloc_entry(self, uid, slot: int) -> None:
        """Claim a mask entry for ``uid`` going to ``slot`` (of the slot's
        shard on a mesh), if the engine pools entries."""
        if self.mask_alloc is not None:
            self.mask_alloc.alloc(
                1, uid, color=self._color(slot) if self._entry_shard else 0,
                strict=self._entry_shard)

    def _alloc_pages(self, length: int, uid, slot: int) -> None:
        """Claim the pages covering ``length`` positions for ``uid`` going
        to ``slot`` (none without a paged leaf); on PageOOM the request's
        mask entry, if any, is given back before the error goes up."""
        need = self._pages_for(length)
        if not need:
            return
        try:
            self.page_alloc.alloc(need, uid, color=self._color(slot),
                                  strict=self._page_shard)
        except PG.PageOOM:
            if self.mask_alloc is not None:
                self.mask_alloc.free_owner(uid)
            raise

    def _assign_tables(self, slot: int, r: Request) -> None:
        """Point a slot's page-table row and entry-table entry at what its
        request holds (host mirrors; pushed by ``_push_tables``)."""
        if self._paged:
            pages = self.page_alloc.pages_of(r.uid)
            self._page_table_h[slot] = self._sentinel
            self._page_table_h[slot, :len(pages)] = pages
        if self.mask_alloc is not None:
            self._mask_table_h[slot] = self.mask_alloc.pages_of(r.uid)[0]
            self._view_dirty = True
        self._tables_dirty = True

    def _release_request(self, slot: int, req: Request) -> None:
        """Free a retired request's pages + mask entry and sentinel its
        table rows (the slot is already inactive on the device, so its
        writes go to the scratch page either way; its stale view row is
        never read)."""
        if self._paged:
            self.page_alloc.free_owner(req.uid)
            self._page_table_h[slot] = self._sentinel
        if self.mask_alloc is not None:
            self.mask_alloc.free_owner(req.uid)
            self._mask_table_h[slot] = self.n_mask_entries
        self._tables_dirty = True

    @torch.no_grad()
    def _preempt_slot(self, slot: int) -> None:
        """Swap a running request out to the host (its pages, its mask
        record and the host-reconstructible slot scalars), free its device
        resources, and queue it for resume. Swap, not recompute: the saved
        bytes come back unchanged, so a resumed request decodes as if it
        had never left."""
        r = self.slot_req[slot]
        # on a mesh the rank holding the slot extracts, the others take
        # rows of the same shapes, and every rank keeps the holder's
        mine = self._mine(slot)
        row = torch.from_numpy(self._local_pages(
            self._page_table_h[slot]) if mine is not None else np.full(
                (self._mp,), self._pages_local, np.int32)).to(self.device)
        rows = PG.extract_slot(self.cache["data"], row, mine or 0)
        mask_row = None
        if self.mask_alloc is not None:
            entry = self._mine_entry(self.mask_alloc.pages_of(r.uid)[0])
            mask_row = {k: v[entry or 0]
                        for k, v in self.masks["pool"].items()}
        if self._slot_shard:
            rows = self._from_owner(rows, self._color(slot))
            if mask_row is not None and self._entry_shard:
                mask_row = self._from_owner(mask_row, self._color(slot))
        # own host copies (on the CPU, .cpu() would hand back views of
        # pool rows the next owner overwrites)
        rows = tree_map(lambda v: v.to("cpu", copy=True), rows)
        if mask_row is not None:
            mask_row = {k: v.to("cpu", copy=True)
                        for k, v in mask_row.items()}
        self._resume_q.append({
            "req": r, "rows": rows, "mask": mask_row,
            "len": self._rlen(r) + len(r.generated) - 1,
            "seq": self._slot_seq[slot],
            "degraded": self.slot_degraded[slot]})
        self._release_request(slot, r)
        hot = np.zeros((self.n_slots,), bool)
        hot[slot] = True
        self.slots.deactivate(hot)
        self.slot_req[slot] = None
        self.slot_degraded[slot] = False
        r.preemptions += 1
        self.preemptions += 1
        self.obs.tracer.instant(TR.CAT_PREEMPT, "preempt", slot=slot,
                                uid=r.uid)
        self.obs.metrics.inc("serve.preemptions")

    def _youngest_live(self, but: int) -> Optional[int]:
        """Preemption victim: the most recently admitted live slot other
        than `but` (LIFO preemption keeps the oldest work finishing); of
        `but`'s shard where a shard's pages serve its slots alone."""
        live = [(self._slot_seq[i], i)
                for i, r in enumerate(self.slot_req)
                if r is not None and i != but and (
                    not self._page_shard
                    or self._color(i) == self._color(but))]
        return max(live)[1] if live else None

    @torch.no_grad()
    def _try_resume(self) -> int:
        """Restore preempted requests (oldest first) into free slots while
        pages + entries allow. A blocked head blocks the queue — resumes
        never leapfrog, so preemption stays starvation-free."""
        n = 0
        while self._resume_q and self.free_slots():
            snap = self._resume_q[0]
            r = snap["req"]
            slot = self.free_slots()[0]
            try:
                self._alloc_entry(r.uid, slot)
                self._alloc_pages(snap["len"], r.uid, slot)
            except PG.PageOOM:
                break
            self._resume_q.pop(0)
            self._assign_tables(slot, r)
            self._push_tables()
            mine = self._mine(slot)
            if mine is not None:
                row = torch.from_numpy(self._local_pages(
                    self._page_table_h[slot])).to(self.device)
                PG.restore_slot(self.cache["data"], snap["rows"], row, mine)
            entry = self._mine_entry(int(self._mask_table_h[slot])) \
                if snap["mask"] is not None else None
            if entry is not None:
                for k, v in self.masks["pool"].items():
                    v[entry] = snap["mask"][k].to(self.device)
            self.slots.restore([slot], [r.generated[-1]], [snap["len"]],
                               [len(r.generated)], [r.max_new_tokens])
            self.slot_req[slot] = r
            self.slot_degraded[slot] = snap["degraded"]
            self._slot_seq[slot] = snap["seq"]
            self.resumes += 1
            self.obs.tracer.instant(TR.CAT_PREEMPT, "resume", slot=slot,
                                    uid=r.uid)
            self.obs.metrics.inc("serve.resumes")
            n += 1
        return n

    def _ensure_window_pages(self, window: int) -> None:
        """Grow every live slot's allocation to cover the next `window`
        decode writes, oldest slot first; on pool exhaustion the YOUNGEST
        live slot is preempted and its pages reused. The pool holds one
        max-length request (checked at construction), so the oldest slot
        always makes progress — no deadlock, no starvation."""
        if not self._paged:
            return
        for _, i in sorted((self._slot_seq[i], i)
                           for i, r in enumerate(self.slot_req)
                           if r is not None):
            r = self.slot_req[i]
            if r is None:
                continue  # preempted by an earlier iteration
            cur = self._rlen(r) + len(r.generated) - 1
            need = PG.pages_needed(min(cur + window, self.S - 1),
                                   self.page_size)
            while need > len(self.page_alloc.pages_of(r.uid)):
                have = len(self.page_alloc.pages_of(r.uid))
                try:
                    new = self.page_alloc.alloc(need - have, r.uid,
                                                color=self._color(i),
                                                strict=self._page_shard)
                    self._page_table_h[i, have:need] = new
                    self._tables_dirty = True
                except PG.PageOOM:
                    victim = self._youngest_live(but=i)
                    if victim is None:
                        raise  # can't happen: pool >= one full request
                    self._preempt_slot(victim)

    def _req_prefix_len(self, r) -> int:
        """Host-side prefix length of a request before hydration: P when
        its profile's hard masks select any prefix-segment slot, else 0
        (and 0 for a missing or corrupt record: the probe degrades it)."""
        if not self.prefix_len or r.degraded:
            return 0
        off, cnt = self._prefix_seg
        try:
            ia, _, ib, _ = self.store.sparse_indices(int(r.profile_id))
        except (KeyError, RecordIntegrityError):
            return 0
        return self.prefix_len if any(
            ((i >= off) & (i < off + cnt)).any() for i in (ia, ib)) else 0

    # ---------------------------------------------------------------- public
    def free_slots(self) -> List[int]:
        return [i for i, r in enumerate(self.slot_req) if r is None]

    def active_count(self) -> int:
        """Host-visible count of occupied slots (refreshed at syncs)."""
        return sum(r is not None for r in self.slot_req)

    def admit_many(self, reqs: List[Request]) -> int:
        """Admit up to len(free_slots()) requests: one health probe per
        profile, one cache-aware batched hydration, one mask scatter, one
        prefill per length bucket, one slot-state scatter. Continuous,
        preempted work is resumed first, and a request the pools can't
        hold yet goes back to the queue's head. Returns #admitted."""
        with self.obs.tracer.span(TR.CAT_ADMISSION, "admit_wave",
                                  offered=len(reqs)) as sp:
            n = self._admit_wave(reqs)
            sp["admitted"] = n
        return n

    @torch.no_grad()
    def _admit_wave(self, reqs: List[Request]) -> int:
        t_wave = time.perf_counter()
        if self.slots.buf_fill:
            self.sync()  # flush the window before touching slot state
        resumed = 0
        if self._resume_q:
            resumed = self._try_resume()  # preempted work outranks fresh
        free = self.free_slots()
        if len(reqs) > len(free):
            # the wave was sized to the free count before the sync/resume
            # above; the overflow goes back to the head, never dropped
            self.scheduler.requeue_front(reqs[len(free):])
            reqs = reqs[:len(free)]
        if self.continuous and reqs:
            reqs = self._reserve_resources(reqs, free)
        if not reqs:
            if resumed:
                self._refresh_window()  # resumed slots need window + view
            return 0
        assigned = free[:len(reqs)]
        if self.continuous:
            # commit page/entry tables BEFORE the prefill insert and mask
            # scatter: both address device memory through them
            for r, s in zip(reqs, assigned):
                self._assign_tables(s, r)
                self._slot_seq[s] = self._admit_seq
                self._admit_seq += 1
            self._push_tables()
        if self.masks is not None:
            # probe every profile first (with retry): requests whose
            # profile can't be hydrated degrade to the bare PLM below,
            # never failing the wave for their healthy peers
            self._probe_wave(reqs)
        stacked = self._hydrate_stacked(reqs)
        prefix_rows = None
        if self.prefix_len:
            # prefix KV rows go into the cache at prefill, not into the
            # mask buffers
            prefix_rows = (stacked.pop("prefix_k"), stacked.pop("prefix_v"))
        if stacked is not None:
            # ONE scatter into the per-slot buffers (windowed) or the
            # requests' pool entries (continuous) for the whole wave
            if self.continuous:
                bufs = self.masks["pool"]
                dest = [self.mask_alloc.pages_of(r.uid)[0] for r in reqs]
            else:
                bufs, dest = self.masks, assigned
            # this rank's rows (all of them off a mesh)
            sel = [i for i, e in enumerate(dest)
                   if self._mine_entry(e) is not None]
            if sel:
                dest = torch.tensor([self._mine_entry(dest[i]) for i in sel],
                                    dtype=torch.long, device=self.device)
                src = None if len(sel) == len(reqs) else torch.tensor(
                    sel, device=self.device)
                for key, buf in bufs.items():
                    rows = stacked[key] if src is None else stacked[key][src]
                    buf[dest] = rows.to(buf.dtype)

        slot_of = {id(r): s for r, s in zip(reqs, assigned)}
        idx_of = {id(r): i for i, r in enumerate(reqs)}
        groups = self.scheduler.group_by_bucket(reqs)
        next_toks = {}
        for pad, group in sorted(groups.items()):
            B = len(group)
            self.prefill_batches += 1
            self.prefill_rows += pow2_count(B)
            self.prefill_real += B
            # this rank prefills its own slots' rows (all of them off a
            # mesh); the first tokens are gathered after the wave
            group = [r for r in group
                     if self._mine(slot_of[id(r)]) is not None]
            if not group:
                continue
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
            with self.obs.tracer.span(TR.CAT_PREFILL, f"prefill[{pad}]",
                                      bucket=pad, rows=Bp, real=B):
                logits, mini = self.prefill_logits(
                    torch.from_numpy(toks).to(self.device), rows,
                    torch.from_numpy(lens).to(self.device), cpos, prows)
                gslots = torch.tensor([self._mine(slot_of[id(r)])
                                       for r in group], dtype=torch.long,
                                      device=self.device)
                if self.continuous:
                    PG.insert_group(self.cache["data"], mini, gslots,
                                    self.cache["table"], self.page_size)
                else:
                    self._insert(mini, gslots)
                nxt_h = torch.argmax(logits, dim=-1)[:B].cpu().numpy()
            for j, r in enumerate(group):
                next_toks[id(r)] = int(nxt_h[j])
        if self._slot_shard:
            next_toks = self._gather_first_tokens(reqs, next_toks)
        if self.last_admission is not None:
            self.last_admission["prefill_batches"] = len(groups)
            self.last_admission["prefill_occupancy"] = round(
                len(reqs) / max(sum(pow2_count(len(g))
                                    for g in groups.values()), 1), 3)
        if self.obs.enabled:
            # the first token exists as of the prefill above (its argmax
            # came to the host): TTFT and admission wait of every request
            # that went through submit()
            now = time.perf_counter()
            for r in reqs:
                if r.t_submit:
                    self.obs.metrics.observe("serve.ttft_us",
                                             (now - r.t_submit) * 1e6, "us")
                    self.obs.metrics.observe(
                        "serve.admission_wait_us",
                        (t_wave - r.t_submit) * 1e6, "us")

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
                if self.continuous:
                    self._release_request(slot, r)
            else:
                self.slot_req[slot] = r
                self.slot_degraded[slot] = r.degraded
        self._refresh_window()
        return len(reqs)

    def _rlen(self, r) -> int:
        """Cache length of a request's prompt region: its hydrated prefix
        rows plus its prompt tokens."""
        return getattr(r, "prefix_len", 0) + len(r.prompt)

    def step(self) -> int:
        """One device decode step (a speculation round with spec) for all
        slots. Host state refreshes only at the window's sync; returns the
        host-visible active count as of the last sync (an upper bound on
        live slots)."""
        active = self.active_count()
        if not active:
            return 0
        masks = self._masks_view if self.continuous else self.masks
        if self.spec and masks is not None:
            masks = {"adapted": masks, "zero": self._zero_view}
        self.cache = self.slots.step(self.params, self.cache, masks)
        if self.slots.buf_fill >= self._window:
            self.sync()
        return active

    def sync(self) -> int:
        """Device→host sync: hand the window's tokens to their requests,
        mark finished requests done and free their slots (continuous: and
        their pages and entries, then resume preempted work into the freed
        capacity). Returns the number of still-active slots."""
        s = self.slots.sync()
        if s.fill:
            # capacity accounting: an occupied slot that emitted fewer
            # tokens than the window stepped idled the difference (spec
            # rounds commit up to W tokens a step, so only wholly idle
            # rounds count); an EMPTY slot strands the whole window
            # whenever work was waiting for it
            for i, req in enumerate(self.slot_req):
                c = int(s.counts[i])
                self.useful_slot_steps += c
                if req is not None:
                    self.stranded_slot_steps += max(s.fill - c, 0)
                elif self._backlog:
                    self.stranded_slot_steps += s.fill
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
            if s.drafted is not None and int(s.drafted[i]):
                d, a = int(s.drafted[i]), int(s.accepted[i])
                self.spec_drafted += d
                self.spec_accepted += a
                rec = self._spec_by_uid.setdefault(req.uid, [0, 0])
                rec[0] += d
                rec[1] += a
            if not s.active[i]:
                req.done = True
                self.slot_req[i] = None
                self.slot_degraded[i] = False
                if self.continuous:
                    self._release_request(i, req)
        self._flush_obs(s)
        if self._resume_q:
            self._try_resume()
        self._refresh_window()
        return self.active_count()

    def _flush_obs(self, s) -> None:
        """Observability at the sync: the only place decode metrics reach
        the host, and only with what the sync's one transfer already
        brought (``s.obs``, the device accumulator's window deltas). No
        extra sync per token."""
        now = time.perf_counter()
        if s.fill and self.obs.enabled:
            acc = s.obs
            toks = int(acc[:, OBS.OBS_TOKENS].sum())
            m = self.obs.metrics
            m.inc("serve.decode_tokens", toks)
            m.inc("serve.device_steps", s.fill)
            m.inc("serve.active_slot_steps",
                  int(acc[:, OBS.OBS_ACTIVE_STEPS].sum()))
            m.inc("serve.stranded_slot_steps",
                  int(acc[:, OBS.OBS_STRANDED_STEPS].sum()))
            elapsed = now - self._win_t0
            if toks:
                # mean host-side per-token latency over the window (the
                # finest granularity visible without a sync per token)
                m.observe("serve.decode_token_us", elapsed / toks * 1e6,
                          "us")
            m.observe("serve.queue_depth", self.scheduler.pending(), "reqs")
            m.set_gauge("serve.queue_depth_now", self.scheduler.pending())
            self.obs.tracer.complete(TR.CAT_DECODE_WINDOW, "decode_window",
                                     self._win_t0, now, steps=s.fill,
                                     tokens=toks)
            if s.drafted is not None:
                d, a = int(s.drafted.sum()), int(s.accepted.sum())
                if d:
                    m.inc("serve.spec_drafted", d)
                    m.inc("serve.spec_accepted", a)
                    m.observe("serve.spec_accept_rate", a / d, "ratio")
                    self.obs.tracer.instant(TR.CAT_SPEC, "spec_window",
                                            drafted=d, accepted=a,
                                            rounds=s.fill)
        self.obs.sentinel.check()
        self._win_t0 = now

    def _refresh_window(self) -> None:
        # device capacity stop is lengths >= S-1 post-increment with
        # lengths = prefix + prompt + generated - 1, so a slot can still
        # emit S - prefix - prompt - generated tokens. Windowed, the window
        # is bounded by the MAX remaining (slots never dead-step after
        # everyone finished); continuous by the MIN remaining: greedy
        # decode retires deterministically, so the sync lands when the
        # first slot frees and its capacity turns over at once
        remaining = [min(r.max_new_tokens - len(r.generated),
                         self.S - self._rlen(r) - len(r.generated))
                     for r in self.slot_req if r is not None]
        pick = min if self.continuous else max
        bound = pick(remaining) if remaining else self.sync_every
        # spec windows count ROUNDS of up to W tokens: the first
        # retirement can land after ceil(bound / W) rounds
        W = self.spec_gamma + 1 if self.spec else 1
        self._window = max(1, min(self.sync_every, -(-bound // W)))
        if self.continuous:
            # page growth covers every position the window can WRITE:
            # rounds x W (draft and verify spans)
            self._ensure_window_pages(self._window * W)
            self._push_tables()
            if self.masks is not None and self._view_dirty:
                self._view_dirty = False
                idx = self.masks["table"].long().clamp(
                    0, self._entries_local - 1)
                for k, v in self.masks["pool"].items():
                    self._masks_view[k] = v[idx]
        self._backlog = bool(self.scheduler.pending() or self._resume_q)

    def submit(self, reqs) -> None:
        """Queue requests with the scheduler (admitted as slots free up)."""
        self.scheduler.submit(reqs)

    def invalidate_profile(self, pid: int) -> bool:
        """Drop a profile's cached Â/B̂ (called by the store whenever the
        profile's record is added or replaced)."""
        return self.profile_cache.invalidate(pid)

    def abort_all(self) -> None:
        """Abort every in-flight request (tokens already decoded are kept,
        preempted ones too); slots become free, caches and pools are left
        to be overwritten."""
        if self.slots.buf_fill:
            self.sync()
        self.slots.deactivate_all()
        for i, req in enumerate(self.slot_req):
            if req is not None:
                req.done = True
                self.slot_req[i] = None
                if self.continuous:
                    self._release_request(i, req)
            self.slot_degraded[i] = False
        for snap in self._resume_q:
            snap["req"].done = True
        self._resume_q.clear()
        self._refresh_window()

    def run_until_drained(self, queue: Optional[List[Request]] = None,
                          max_steps: int = 10_000) -> int:
        """Serve until the queue, the resume queue and all slots are empty.
        Admission (and resumption) happens whenever the host view shows
        free slots, i.e. after syncs."""
        if queue:
            self.scheduler.submit(list(queue))
        steps = 0
        while steps < max_steps:
            if self._resume_q and self.free_slots() \
                    and self.slots.buf_fill == 0:
                # window boundary only: slot restore needs a synced window
                if self._try_resume():
                    self._refresh_window()
            free = self.free_slots()
            if free and self.scheduler.pending():
                self.admit_many(self.scheduler.next_batch(len(free)))
            if not self.active_count():
                if not self.scheduler.pending() and not self._resume_q:
                    break
                continue  # admission freed nothing; the next wave will
            self.step()
            steps += 1
        if self.slots.buf_fill:
            self.sync()
        return steps

    def kv_pool_bytes(self) -> int:
        """Bytes of the K/V cache: the page pools (scratch page included)
        continuous, the dense slot block windowed."""
        data = self.cache["data"] if self.continuous else self.cache
        return sum(v.numel() * v.element_size() for v in data.values())

    def resident_bytes_per_device(self) -> dict:
        """Resident bytes of the engine's device state (params, KV cache,
        quantized bank, mask buffers and their tables) and their total,
        per device: on a mesh ``sharded_bytes_per_device`` of the whole
        trees under the specs this engine applied."""
        trees = {"params": self.params, "cache": self.cache}
        if self.qbank is not None:
            trees["qbank"] = self.qbank
        if self.masks is not None:
            trees["masks"] = self.masks
        out = {}
        for name, tree in trees.items():
            if self.mesh is None:
                out[name] = sum(t.numel() * t.element_size()
                                for t in tree_leaves(tree))
                continue
            specs = self._specs[name]
            if name in ("cache", "masks"):
                # rank-local tensors: their whole shapes under the specs
                tree = tree_map(lambda x, sp: SH.global_meta(
                    x, sp, self.mesh), tree, specs)
            out[name] = SH.sharded_bytes_per_device(tree, specs, self.mesh)
        out["total"] = sum(out.values())
        return out

    def reset_stats(self) -> None:
        """Zero every accounting counter (decode, prefill, speculation,
        preemption, resilience, the scheduler's, the profile cache's, the
        allocators', host syncs and the obs registry) in one call, e.g. to
        measure steady state after warm-up. In-flight requests, caches and
        pools are left as they are."""
        self.decode_tokens = 0
        self.spec_drafted = 0
        self.spec_accepted = 0
        self._spec_by_uid.clear()
        self.prefill_batches = 0
        self.prefill_rows = 0
        self.prefill_real = 0
        self.preemptions = 0
        self.resumes = 0
        self.useful_slot_steps = 0
        self.stranded_slot_steps = 0
        self.degraded_requests = 0
        self.hydration_retries = 0
        self.last_admission = None
        self.slots.reset_counters()
        self.scheduler.reset_stats()
        self.profile_cache.reset_stats()
        if self.page_alloc is not None:
            self.page_alloc.reset_stats()
        if self.mask_alloc is not None:
            self.mask_alloc.reset_stats()
        self.obs.metrics.reset()

    def serve_stats(self) -> dict:
        """Counters the launcher prints: the JAX engine's, but
        ``step_traces`` (it counts compilations of the decode step; the
        port compiles none until the step is a CUDA graph)."""
        out = {
            "mode": "continuous" if self.continuous else "windowed",
            "devices": self._n_devices,
            "bank_quant": self.quant,
            # slot_occupancy: share of slot-steps that emitted a token;
            # stranded_slot_steps: slot-steps idled between a finish and
            # the refill (what continuous batching drives to ~0)
            "useful_slot_steps": self.useful_slot_steps,
            "stranded_slot_steps": self.stranded_slot_steps,
            "slot_occupancy": _rate(self.useful_slot_steps,
                                    self.n_slots * self.slots.device_steps),
            "resident_bytes_per_device": self.resident_bytes_per_device(),
            "host_syncs": self.slots.host_syncs,
            "device_steps": self.slots.device_steps,
            "decode_tokens": self.decode_tokens,
            # committed tokens vs device steps: equal for plain decode,
            # larger with speculation
            "committed_tokens": self.decode_tokens,
            "committed_per_device_step": _rate(self.decode_tokens,
                                               self.slots.device_steps),
            "syncs_per_token": _rate(self.slots.host_syncs,
                                     self.decode_tokens),
            "sync_every": self.sync_every,
            "prefill_batches": self.prefill_batches,
            "prefill_occupancy": _rate(self.prefill_real,
                                       self.prefill_rows),
            "profile_cache": self.profile_cache.stats(),
            "scheduler": self.scheduler.stats(),
            # resilience: how often serving fell back to the bare PLM, how
            # hard hydration retried, and what the store has quarantined
            "degraded_requests": self.degraded_requests,
            "degraded_slots": sum(self.slot_degraded),
            "hydration_retries": self.hydration_retries,
            "quarantined_profiles": len(self.store.quarantined_ids()),
            "store_integrity": self.store.integrity_stats(),
        }
        if self.spec:
            out["spec"] = {
                "gamma": self.spec_gamma,
                "drafted": self.spec_drafted,
                "accepted": self.spec_accepted,
                "acceptance_rate": _rate(self.spec_accepted,
                                         self.spec_drafted),
                "committed_per_device_step": _rate(
                    self.decode_tokens, self.slots.device_steps),
                # per request (uid-keyed; survives preemption)
                "per_request_acceptance": {
                    uid: _rate(a, d)
                    for uid, (d, a) in sorted(self._spec_by_uid.items())},
            }
        if self.continuous:
            out["preemptions"] = self.preemptions
            out["resumes"] = self.resumes
            out["resume_pending"] = len(self._resume_q)
            out["page_size"] = self.page_size
            if self.page_alloc is not None:
                out["pages"] = self.page_alloc.stats()
            if self.mask_alloc is not None:
                out["mask_entries"] = self.mask_alloc.stats()
        return out
