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
- admission must be preceded by a sync, so buffers start a window clean.

Speculation (``spec_width``) and the observability accumulator wait for
ROADMAP queue 1, items 5 and 9.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch


class SlotSync(NamedTuple):
    """Host view of slot state at a sync point."""
    tokens: np.ndarray       # [n_slots, fill] int32, -1 padded
    counts: np.ndarray       # [n_slots] tokens emitted since last sync
    lengths: np.ndarray      # [n_slots] int32
    active: np.ndarray       # [n_slots] bool
    fill: int                # device steps this window took


class SlotState:
    """Slot decode state + the step advancing it.

    decode_fn(params, cache, last_tok [S], lengths [S], masks, active [S])
    -> (next_tok [S], cache) is the model half the engine provides."""

    def __init__(self, n_slots: int, max_seq: int, sync_every: int,
                 decode_fn: Callable, *, device):
        if sync_every < 1:
            raise ValueError("sync_every must be >= 1")
        self.n_slots = n_slots
        self.S = max_seq
        self.sync_every = sync_every
        self.decode_fn = decode_fn
        self.device = device

        def zeros(dtype):
            return torch.zeros((n_slots,), dtype=dtype, device=device)

        self.last_tok = zeros(torch.int32)
        self.lengths = zeros(torch.int32)
        self.active = zeros(torch.bool)
        self.n_gen = zeros(torch.int32)
        self.max_new = zeros(torch.int32)
        self.tok_buf = torch.full((n_slots, sync_every), -1,
                                  dtype=torch.int32, device=device)
        self.buf_fill = 0            # host: steps since last sync
        self._prev_n_gen = np.zeros((n_slots,), np.int32)  # host mirror
        self.host_syncs = 0
        self.device_steps = 0

    # ----------------------------------------------------------------- device
    @torch.no_grad()
    def step(self, params, cache, masks):
        """One decode step for ALL slots (inactive ones pad-compute);
        returns the model cache. No host transfer happens here."""
        if self.buf_fill >= self.sync_every:
            raise RuntimeError("sync() before stepping more")
        nxt, cache = self.decode_fn(params, cache, self.last_tok,
                                    self.lengths, masks, self.active)
        was_active = self.active
        inc = was_active.to(torch.int32)
        self.lengths = self.lengths + inc
        self.n_gen = self.n_gen + inc
        self.last_tok = torch.where(was_active, nxt, self.last_tok)
        # on-device termination: token budget or sequence capacity
        done = (self.n_gen >= self.max_new) | (self.lengths >= self.S - 1)
        self.tok_buf[:, self.buf_fill] = torch.where(
            was_active, nxt, torch.full_like(nxt, -1))
        self.active = was_active & ~done
        self.buf_fill += 1
        self.device_steps += 1
        return cache

    def admit(self, slots, last_toks, lengths, max_news) -> None:
        """Scatter freshly prefilled requests into the slot arrays in one
        host→device transfer. The prefill token counts toward ``max_new``
        (n_gen starts at 1); a request whose budget is spent by that token,
        or whose prompt already fills the sequence, never becomes active."""
        if self.buf_fill:
            raise RuntimeError("the engine must sync() before admission")
        slots_h = np.asarray(slots, np.int64)
        lengths_h = np.asarray(lengths, np.int32)
        max_news_h = np.asarray(max_news, np.int32)
        n_gens_h = np.ones_like(lengths_h)
        actives_h = (n_gens_h < max_news_h) & (lengths_h < self.S - 1)
        packed = torch.from_numpy(np.stack([
            np.asarray(last_toks, np.int32), lengths_h, n_gens_h, max_news_h,
            actives_h.astype(np.int32)])).to(self.device)
        sl = torch.from_numpy(slots_h).to(self.device)
        self.last_tok[sl] = packed[0]
        self.lengths[sl] = packed[1]
        self.n_gen[sl] = packed[2]
        self.max_new[sl] = packed[3]
        self.active[sl] = packed[4].bool()
        self._prev_n_gen[slots_h] = n_gens_h

    # ------------------------------------------------------------------- host
    def sync(self) -> SlotSync:
        """ONE device→host transfer of the window's tokens + slot status;
        resets the window."""
        fill = self.buf_fill
        packed = torch.cat([self.tok_buf[:, :fill],
                            self.lengths[:, None], self.n_gen[:, None],
                            self.active[:, None].to(torch.int32)],
                           dim=1).cpu().numpy()
        tok_buf = packed[:, :fill]
        lengths, n_gen = packed[:, fill], packed[:, fill + 1]
        active = packed[:, fill + 2].astype(bool)
        counts = n_gen - self._prev_n_gen
        self._prev_n_gen = n_gen.copy()
        if fill:
            self.tok_buf.fill_(-1)
        self.buf_fill = 0
        self.host_syncs += 1
        return SlotSync(tok_buf, counts, lengths, active, fill)
