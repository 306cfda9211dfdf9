"""Device-resident decode state for the serving slot batch.

`SlotState` owns everything the per-token loop touches — ``last_tok``,
``lengths``, ``active``, ``n_gen``, ``max_new`` and a token buffer — as
tensors on the engine's device, and advances all of it in one step that
also decides per-slot termination on the device. The host sees the state
only at ``sync()``: ONE device→host transfer every ``sync_every`` steps
instead of a round trip per token.

Invariants the engine relies on (as in ``repro.serve.slots``):
- activity is contiguous within a sync window: a slot admitted at window
  position 0 emits tokens at buffer positions 0..c-1 and then stays
  inactive, so the sync hands exactly ``n_gen`` deltas to the request;
- admission, restore and deactivation must be preceded by a sync, so
  buffers start a window clean.

With ``spec_width`` W > 1 each step is a SPECULATION ROUND: the decode
function drafts W-1 tokens and verifies them, and the step commits 1..W
tokens per slot, packed densely into a buffer of ``sync_every * W``
columns, counting drafted and accepted drafts per slot.

Every step, plain or speculative, also adds to ONE [n_slots, OBS_COLS]
int32 observability accumulator (``repro_torch.obs.metrics``: tokens
committed, active and stranded steps per slot). It is unconditional, so
the steps launch the same kernels whether the engine has an obs bundle
or not, and it comes back in the sync's one transfer, reset per window.

On a serving mesh each data rank holds and steps only its own slots
``local = (lo, hi)`` of the ``n_slots``: the device tensors are that
rank's rows, the host mirrors and every call's slot indices stay global
(a call touching another rank's slots changes only the mirrors), and at
the sync ``gather`` (an ``all_gather`` over the data axis) puts the
ranks' packed rows together, so every rank hands the same tokens and
flags to the same requests.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.obs.metrics import OBS_COLS, device_acc_init, \
    device_acc_update


class SlotSync(NamedTuple):
    """Host view of slot state at a sync point."""
    tokens: np.ndarray       # [n_slots, <= fill*W] int32, -1 padded
    counts: np.ndarray       # [n_slots] tokens emitted since last sync
    lengths: np.ndarray      # [n_slots] int32
    active: np.ndarray       # [n_slots] bool
    fill: int                # device steps this window took
    drafted: Optional[np.ndarray] = None   # [n_slots] spec drafts this window
    accepted: Optional[np.ndarray] = None  # [n_slots] accepted drafts
    obs: Optional[np.ndarray] = None       # [n_slots, OBS_COLS] window deltas


class SlotState:
    """Slot decode state + the step advancing it.

    decode_fn(params, cache, last_tok [S], lengths [S], masks, active [S])
    -> (next_tok [S], cache) is the model half the engine provides
    (``active`` lets a paged cache drop the writes of slots whose pages
    were re-owned; the dense engine ignores it). With ``spec_width`` W > 1
    it returns (toks [S, W] — the adapted model's token at every verified
    position — n_acc [S], the accepted-draft prefix length, cache)."""

    def __init__(self, n_slots: int, max_seq: int, sync_every: int,
                 decode_fn: Callable, *, device, spec_width: int = 1,
                 local=None, gather: Optional[Callable] = None):
        if sync_every < 1:
            raise ValueError("sync_every must be >= 1")
        if spec_width < 1:
            raise ValueError("spec_width must be >= 1")
        self.n_slots = n_slots
        self.S = max_seq
        self.sync_every = sync_every
        self.spec_width = spec_width  # gamma+1 (speculative), 1 = plain
        self.decode_fn = decode_fn
        self.device = device
        # this rank's slots [lo, hi) and the gather of packed rows
        self.lo, self.hi = local if local is not None else (0, n_slots)
        self.gather = gather
        n_dev = self.hi - self.lo

        def zeros(dtype):
            return torch.zeros((n_dev,), dtype=dtype, device=device)

        self.last_tok = zeros(torch.int32)
        self.lengths = zeros(torch.int32)
        self.active = zeros(torch.bool)
        self.n_gen = zeros(torch.int32)
        self.max_new = zeros(torch.int32)
        spec = spec_width > 1
        # a spec round commits 1..W tokens per slot: the buffer holds the
        # worst case, tokens pack densely from buf_len, and the uncommitted
        # tail of a round goes to one scratch column past the end
        self.tok_buf = torch.full(
            (n_dev, sync_every * spec_width + int(spec)), -1,
            dtype=torch.int32, device=device)
        self.buf_len = zeros(torch.int32) if spec else None
        self.drafted = zeros(torch.int32) if spec else None
        self.accepted = zeros(torch.int32) if spec else None
        self.obs_acc = device_acc_init(n_dev, device=device)
        self.buf_fill = 0            # host: steps since last sync
        self._prev_n_gen = np.zeros((n_slots,), np.int32)  # host mirror
        self._prev_drafted = np.zeros((n_slots,), np.int32)
        self._prev_accepted = np.zeros((n_slots,), np.int32)
        self.host_syncs = 0
        self.device_steps = 0

    # ----------------------------------------------------------------- device
    @torch.no_grad()
    def step(self, params, cache, masks):
        """One decode step (a speculation round with W > 1) for ALL slots
        (inactive ones pad-compute); returns the model cache. No host
        transfer happens here."""
        if self.buf_fill >= self.sync_every:
            raise RuntimeError("sync() before stepping more")
        if self.spec_width > 1:
            cache = self._spec_round(params, cache, masks)
        else:
            nxt, cache = self.decode_fn(params, cache, self.last_tok,
                                        self.lengths, masks, self.active)
            was_active = self.active
            inc = was_active.to(torch.int32)
            self.lengths = self.lengths + inc
            self.n_gen = self.n_gen + inc
            self.last_tok = torch.where(was_active, nxt, self.last_tok)
            self.tok_buf[:, self.buf_fill] = torch.where(
                was_active, nxt, torch.full_like(nxt, -1))
            # one token per active slot: ``inc`` is that count
            device_acc_update(self.obs_acc, was_active, inc)
            self._finish(was_active)
        self.buf_fill += 1
        self.device_steps += 1
        return cache

    def _finish(self, was_active) -> None:
        # on-device termination: token budget or sequence capacity
        done = (self.n_gen >= self.max_new) | (self.lengths >= self.S - 1)
        self.active = was_active & ~done

    def _spec_round(self, params, cache, masks):
        """Commit c = min(n_acc+1, budget/capacity) tokens per live slot:
        the accepted prefix plus either the correction token at the first
        mismatch or the verify's bonus token, so greedy output is bitwise
        the non-speculative sequence."""
        W = self.spec_width
        toks, n_acc, cache = self.decode_fn(params, cache, self.last_tok,
                                            self.lengths, masks, self.active)
        was_active = self.active
        cap = torch.minimum(self.max_new - self.n_gen,
                            (self.S - 1) - self.lengths)
        c = torch.where(was_active,
                        torch.clamp(torch.minimum(n_acc.to(torch.int32) + 1,
                                                  cap), 1, W),
                        torch.zeros_like(cap))
        self.lengths = self.lengths + c
        self.n_gen = self.n_gen + c
        sel = torch.clamp(c - 1, 0, W - 1).long()
        new_last = torch.gather(toks, 1, sel[:, None])[:, 0]
        self.last_tok = torch.where(was_active, new_last, self.last_tok)
        # packed scatter: row i gets toks[i, :c] at buf_len[i]...; the
        # uncommitted tail goes to the scratch column
        j = torch.arange(W, device=toks.device)
        col = self.buf_len[:, None].long() + j
        ok = was_active[:, None] & (j[None, :] < c[:, None])
        col = torch.where(ok, col, self.sync_every * W)
        rows = torch.arange(toks.shape[0], device=toks.device)[:, None]
        self.tok_buf[rows, col] = toks.to(torch.int32)
        self.buf_len = self.buf_len + c
        # every live round drafts W-1; committed drafts are c-1 (the last
        # commit is the correction/bonus token)
        self.drafted = self.drafted + (W - 1) * was_active.to(torch.int32)
        self.accepted = self.accepted + torch.clamp(c - 1, min=0)
        device_acc_update(self.obs_acc, was_active, c)
        self._finish(was_active)
        return cache

    def restore(self, slots, last_toks, lengths, n_gens, max_news) -> None:
        """Scatter requests into the slot arrays in one host→device
        transfer, with explicit generation counters: fresh admissions
        (n_gen 1, the prefill token) and preempt-resumes (n_gen = tokens
        already emitted) share it. A request whose budget or sequence
        capacity is already spent never becomes active."""
        if self.buf_fill:
            raise RuntimeError("the engine must sync() before admission")
        slots_h = np.asarray(slots, np.int64)
        lengths_h = np.asarray(lengths, np.int32)
        n_gens_h = np.asarray(n_gens, np.int32)
        max_news_h = np.asarray(max_news, np.int32)
        actives_h = (n_gens_h < max_news_h) & (lengths_h < self.S - 1)
        self._prev_n_gen[slots_h] = n_gens_h
        if self.spec_width > 1:
            self._prev_drafted[slots_h] = 0
            self._prev_accepted[slots_h] = 0
        mine = (slots_h >= self.lo) & (slots_h < self.hi)
        if not mine.any():
            return
        packed = torch.from_numpy(np.stack([
            np.asarray(last_toks, np.int32), lengths_h, n_gens_h, max_news_h,
            actives_h.astype(np.int32)])[:, mine]).to(self.device)
        sl = torch.from_numpy(slots_h[mine] - self.lo).to(self.device)
        self.last_tok[sl] = packed[0]
        self.lengths[sl] = packed[1]
        self.n_gen[sl] = packed[2]
        self.max_new[sl] = packed[3]
        self.active[sl] = packed[4].bool()
        if self.spec_width > 1:
            self.drafted[sl] = 0
            self.accepted[sl] = 0

    def admit(self, slots, last_toks, lengths, max_news) -> None:
        """Scatter freshly prefilled requests into the slot arrays. The
        prefill token counts toward ``max_new`` (n_gen starts at 1); a
        request whose budget is spent by that token, or whose prompt
        already fills the sequence, never becomes active."""
        self.restore(slots, last_toks, lengths,
                     np.ones((len(np.asarray(slots)),), np.int32), max_news)

    def deactivate(self, mask) -> None:
        """Mark the masked slots inactive on the device (preemption; the
        engine syncs first so no window tokens are in flight)."""
        if self.buf_fill:
            raise RuntimeError("sync() before deactivating")
        mask = np.asarray(mask, bool)[self.lo:self.hi]
        self.active = self.active & ~torch.as_tensor(mask,
                                                     device=self.device)

    def deactivate_all(self) -> None:
        """Mark every slot inactive on the device (abort; engine syncs
        first)."""
        if self.buf_fill:
            raise RuntimeError("sync() before deactivating")
        self.active = torch.zeros_like(self.active)

    # ------------------------------------------------------------------- host
    def reset_counters(self) -> None:
        """Zero the host-side rate counters (``engine.reset_stats()``)."""
        self.host_syncs = 0
        self.device_steps = 0

    def sync(self) -> SlotSync:
        """ONE device→host transfer of the window's tokens + slot status;
        resets the window. With W > 1 the window holds up to fill*W packed
        tokens per slot and the acceptance counters come back as
        per-window deltas."""
        fill = self.buf_fill
        width = fill * self.spec_width
        cols = [self.tok_buf[:, :width], self.lengths[:, None],
                self.n_gen[:, None], self.active[:, None].to(torch.int32)]
        if self.spec_width > 1:
            cols += [self.drafted[:, None], self.accepted[:, None]]
        cols.append(self.obs_acc)
        packed = torch.cat(cols, dim=1)
        if self.gather is not None:
            packed = self.gather(packed)
        packed = packed.cpu().numpy()
        tok_buf = packed[:, :width]
        obs = packed[:, -OBS_COLS:]
        lengths, n_gen = packed[:, width], packed[:, width + 1]
        active = packed[:, width + 2].astype(bool)
        counts = n_gen - self._prev_n_gen
        self._prev_n_gen = n_gen.copy()
        d_drafted = d_accepted = None
        if self.spec_width > 1:
            drafted, accepted = packed[:, width + 3], packed[:, width + 4]
            d_drafted = drafted - self._prev_drafted
            d_accepted = accepted - self._prev_accepted
            self._prev_drafted = drafted.copy()
            self._prev_accepted = accepted.copy()
            if fill:
                self.buf_len.zero_()
        if fill:
            self.tok_buf.fill_(-1)
            # the accumulator restarts each window: what came back IS the
            # window's deltas
            self.obs_acc.zero_()
        self.buf_fill = 0
        self.host_syncs += 1
        return SlotSync(tok_buf, counts, lengths, active, fill, d_drafted,
                        d_accepted, obs)
