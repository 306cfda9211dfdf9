"""Request queue + admission policy for the serving engine.

The scheduler decides WHICH queued requests enter the engine when slots
free up; the engine then prefills each same-bucket group in ONE batched
call. Two policies:

- ``fifo`` (default, the windowed engine's behavior): the oldest request
  always leads the wave, and the rest of the wave is filled with other
  requests from the SAME length bucket first — same-bucket requests share
  a prefill launch, so grouping maximizes prefill-batch occupancy without
  reordering past the head (a request can only be overtaken by same-wave
  peers, never delayed past the wave its bucket leads).
- ``efficiency`` (the continuous engine's default): the LARGEST bucket in
  the look-ahead window leads, so the small incremental admissions of
  continuous batching (often 1-2 freed slots at a time) still fill their
  prefill launches. Pure largest-first can starve a rare-length request
  indefinitely under a steady flood of a common length — ``max_wait_waves``
  is the age-based promotion valve: any request passed over that many
  waves preempts the policy and leads the next wave unconditionally.

Length buckets: attention archs pad prompts to pow2 buckets (pad tokens
are masked out of the KV range); recurrent-state archs (rwkv/mamba/zamba)
cannot mask pad tokens out of their state, so their bucket is the EXACT
prompt length — only identical-length prompts share a prefill. Exact
buckets are also why promotion matters most there: a one-off prompt
length is a bucket of size 1 that largest-first never picks.
"""
from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

from repro_torch.utils import pow2_bucket


@dataclass
class Request:
    uid: int
    prompt: np.ndarray            # [T] int32
    profile_id: int
    max_new_tokens: int = 16
    generated: List[int] = field(default_factory=list)
    done: bool = False
    # Set by the engine when the profile could not be hydrated (persistent
    # failure / integrity quarantine): the request was served by the bare
    # PLM (zero-adapter masks) instead of failing the wave.
    degraded: bool = False
    # admission waves this request was eligible for but passed over
    # (drives max_wait_waves promotion)
    waits: int = 0
    # times the continuous engine swapped this request out to free pages
    preemptions: int = 0
    # host clock (time.perf_counter) at submit(); 0.0 until submitted.
    # Feeds the engine's TTFT / admission-wait histograms — requests
    # admitted without going through submit() simply aren't timed.
    t_submit: float = 0.0


class Scheduler:
    """Bounded-bucket admission queue.

    `window_mult` bounds how far past the head the bucket-grouping looks:
    an admission wave considers at most window_mult * n_free queued
    requests, so matching stays O(window), and a deep queue cannot starve
    its own head. `max_wait_waves=None` disables promotion (safe for
    "fifo", where head-first already bounds overtaking).
    """

    def __init__(self, block_pattern: str = "attn", *, floor: int = 8,
                 window_mult: int = 4, policy: str = "fifo",
                 max_wait_waves: Optional[int] = None):
        if policy not in ("fifo", "efficiency"):
            raise ValueError(f"unknown policy {policy!r}")
        self.exact_length = block_pattern != "attn"
        self.floor = floor
        self.window_mult = window_mult
        self.policy = policy
        self.max_wait_waves = max_wait_waves
        self._queue: "deque[Request]" = deque()
        self.n_submitted = 0
        self.n_admitted = 0
        self.n_promoted = 0
        self.n_requeued = 0

    def __len__(self) -> int:
        return len(self._queue)

    def pending(self) -> int:
        return len(self._queue)

    def submit(self, reqs) -> None:
        if isinstance(reqs, Request):
            reqs = [reqs]
        now = time.perf_counter()
        for r in reqs:
            if not r.t_submit:  # re-submits keep their original arrival
                r.t_submit = now
        self._queue.extend(reqs)
        self.n_submitted += len(reqs)

    def requeue_front(self, reqs: List[Request]) -> None:
        """Return already-popped requests to the HEAD of the queue in their
        original order (the continuous engine's page pool declined them;
        they must not lose their place)."""
        for r in reversed(list(reqs)):
            self._queue.appendleft(r)
        self.n_requeued += len(reqs)

    def bucket_of(self, req: Request) -> int:
        """Padded prompt length this request prefills at."""
        T = len(req.prompt)
        return T if self.exact_length else pow2_bucket(T, self.floor)

    def _pick_lead(self, window: List[Request]) -> Request:
        """The request whose bucket the next prefill group forms around.
        Overdue requests (waits >= max_wait_waves) override either policy,
        oldest first — the anti-starvation guarantee."""
        if self.max_wait_waves is not None:
            for r in window:
                if r.waits >= self.max_wait_waves:
                    self.n_promoted += 1
                    return r
        if self.policy == "fifo":
            return window[0]
        # efficiency: largest bucket in the window leads; ties go to the
        # bucket whose oldest member is oldest (stable — window is FIFO)
        counts: Dict[int, int] = {}
        for r in window:
            counts[self.bucket_of(r)] = counts.get(self.bucket_of(r), 0) + 1
        best = max(counts.values())
        for r in window:
            if counts[self.bucket_of(r)] == best:
                return r

    def next_batch(self, n_free: int) -> List[Request]:
        """Pop up to n_free requests for admission, bucket-grouped. Every
        window member passed over ages by one wait (fuel for promotion)."""
        if n_free <= 0 or not self._queue:
            return []
        window = list(self._queue)[:self.window_mult * n_free]
        picked: List[Request] = []
        remaining = window
        while remaining and len(picked) < n_free:
            lead_bucket = self.bucket_of(self._pick_lead(remaining))
            same = [r for r in remaining
                    if self.bucket_of(r) == lead_bucket]
            take = same[:n_free - len(picked)]
            picked.extend(take)
            taken = set(id(r) for r in take)
            remaining = [r for r in remaining if id(r) not in taken]
        picked_ids = set(id(r) for r in picked)
        for r in window:
            if id(r) not in picked_ids:
                r.waits += 1
        self._queue = deque(r for r in self._queue
                            if id(r) not in picked_ids)
        self.n_admitted += len(picked)
        return picked

    def group_by_bucket(self, reqs: List[Request]) -> Dict[int, List[Request]]:
        """Admission-wave requests -> {padded_len: [reqs]} prefill groups."""
        groups: Dict[int, List[Request]] = {}
        for r in reqs:
            groups.setdefault(self.bucket_of(r), []).append(r)
        return groups

    def reset_stats(self) -> None:
        """Zero the flow counters (engine.reset_stats()); queued requests
        keep their place and their submit timestamps."""
        self.n_submitted = 0
        self.n_admitted = 0
        self.n_promoted = 0
        self.n_requeued = 0

    def stats(self) -> dict:
        return {"pending": len(self._queue),
                "submitted": self.n_submitted,
                "admitted": self.n_admitted,
                "policy": self.policy,
                "promoted": self.n_promoted,
                "requeued": self.n_requeued}
