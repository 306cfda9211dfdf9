"""Metrics layer: host-side registry + the device-resident accumulator.

Two halves, one rule — the hot path never pays for observability:

- DEVICE half: every per-token quantity lives in ONE ``[n_slots, OBS_COLS]``
  int32 accumulator among ``SlotState``'s tensors, updated by every decode
  step and fetched in the SAME device→host transfer the window sync
  already performs. Zero extra host syncs per token; the accumulator is
  unconditional, so the steps launch the same kernels whether an
  :class:`Observability` bundle is attached or not, which is what makes
  obs-on bitwise obs-off.
- HOST half: :class:`MetricsRegistry` — counters, gauges, and
  exponential-bucket histograms (:class:`ExpHistogram`) with p50/p95/p99
  snapshots. Host metrics are only touched at window/sync/flush
  boundaries, never per token.

``StepWatchdog`` (straggler scoring) lives here too: window wall-time
attribution is a metric, not a fault mechanism.
"""
from __future__ import annotations

import json
import math
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

import numpy as np
import torch


# ----------------------------------------------------------------------------
# Device-resident accumulator: column layout shared by slots.py and the
# engine's sync-side flush. Append-only — renumbering columns would silently
# mis-label flushed metrics in any mixed-version replay.
# ----------------------------------------------------------------------------

OBS_TOKENS = 0          # tokens committed (1/step plain, c/round spec)
OBS_ACTIVE_STEPS = 1    # device steps this slot was active (occupancy num.)
OBS_STRANDED_STEPS = 2  # device steps this slot padded along inactive
OBS_COLS = 3


def device_acc_init(n_slots: int, *, device):
    """Fresh per-slot accumulator [n_slots, OBS_COLS] int32 on ``device``."""
    return torch.zeros((n_slots, OBS_COLS), dtype=torch.int32, device=device)


def device_acc_update(acc, was_active, committed):
    """One step's update, in place: a masked add per column.

    ``was_active``: [n_slots] bool, ``committed``: [n_slots] int32 tokens
    committed this step (the spec path commits a variable 1..W)."""
    act = was_active.to(torch.int32)
    acc += torch.stack([committed.to(torch.int32) * act, act, 1 - act],
                       dim=1)
    return acc


# ----------------------------------------------------------------------------
# Exponential histograms
# ----------------------------------------------------------------------------

class ExpHistogram:
    """Fixed-base exponential-bucket histogram: O(1) record, bounded error
    percentiles, sparse storage (a dict of bucket index -> count).

    Base 2**(1/8) bounds any percentile's relative error at ~9% while a
    12-decade range still fits in ~320 live buckets — safe to leave on for
    every request forever.
    """

    BASE = 2.0 ** (1.0 / 8.0)
    _LOG_BASE = math.log(BASE)

    def __init__(self, unit: str = ""):
        self.unit = unit
        self.count = 0
        self.total = 0.0
        self.vmin = math.inf
        self.vmax = -math.inf
        self._buckets: Dict[int, int] = {}

    def record(self, value: float) -> None:
        v = float(value)
        self.count += 1
        self.total += v
        self.vmin = min(self.vmin, v)
        self.vmax = max(self.vmax, v)
        # bucket i holds (BASE**(i-1), BASE**i]; non-positive values pool
        # in a single sentinel bucket below everything
        idx = (math.ceil(math.log(v) / self._LOG_BASE)
               if v > 0 else -(10 ** 6))
        self._buckets[idx] = self._buckets.get(idx, 0) + 1

    def percentile(self, q: float) -> float:
        """q in [0, 100]; returns a bucket upper bound clamped to the
        observed [min, max] (exact for the extremes)."""
        if not self.count:
            return 0.0
        target = max(1, math.ceil(self.count * q / 100.0))
        cum = 0
        for idx in sorted(self._buckets):
            cum += self._buckets[idx]
            if cum >= target:
                hi = 0.0 if idx <= -(10 ** 6) else self.BASE ** idx
                return float(min(max(hi, self.vmin), self.vmax))
        return float(self.vmax)

    def snapshot(self) -> dict:
        if not self.count:
            return {"count": 0, "unit": self.unit}
        return {"count": self.count, "unit": self.unit,
                "sum": round(self.total, 6),
                "min": round(self.vmin, 6), "max": round(self.vmax, 6),
                "mean": round(self.total / self.count, 6),
                "p50": round(self.percentile(50), 6),
                "p95": round(self.percentile(95), 6),
                "p99": round(self.percentile(99), 6)}


# ----------------------------------------------------------------------------
# Registry
# ----------------------------------------------------------------------------

class MetricsRegistry:
    """Named counters / gauges / histograms. Disabled registries keep every
    call a cheap early-return so call sites never need an `if obs:` guard
    (the engine's hot loop has none anyway — it only reports at syncs)."""

    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self.counters: Dict[str, float] = {}
        self.gauges: Dict[str, float] = {}
        self.histograms: Dict[str, ExpHistogram] = {}

    # -- write side ---------------------------------------------------------
    def inc(self, name: str, n: float = 1) -> None:
        if not self.enabled:
            return
        self.counters[name] = self.counters.get(name, 0) + n

    def set_gauge(self, name: str, value: float) -> None:
        if not self.enabled:
            return
        self.gauges[name] = float(value)

    def observe(self, name: str, value: float, unit: str = "") -> None:
        if not self.enabled:
            return
        h = self.histograms.get(name)
        if h is None:
            h = self.histograms[name] = ExpHistogram(unit)
        h.record(value)

    # -- read side ----------------------------------------------------------
    def snapshot(self) -> dict:
        return {"counters": dict(self.counters),
                "gauges": dict(self.gauges),
                "histograms": {k: h.snapshot()
                               for k, h in sorted(self.histograms.items())}}

    def export(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.snapshot(), f, indent=1, sort_keys=True)

    def reset(self) -> None:
        self.counters.clear()
        self.gauges.clear()
        self.histograms.clear()


# ----------------------------------------------------------------------------
# Straggler watchdog
# ----------------------------------------------------------------------------

@dataclass
class StepWatchdog:
    """Tracks per-step wall time; flags hosts whose steps exceed
    `deadline_factor` x the trailing-median. In a real deployment the flag
    feeds `rebalance_assignment`; here it is observable state + logs.

    An optional ``registry`` mirrors every scored step into a
    ``train.step_time_us`` histogram so the trainer gets p50/p99 gang-step
    time for free."""

    deadline_factor: float = 2.0
    window: int = 32
    clock: Callable[[], float] = time.monotonic
    registry: Optional[MetricsRegistry] = None
    _durations: List[float] = field(default_factory=list)
    _t0: Optional[float] = None
    slow_steps: int = 0

    def _observe(self, dt: float, n: int = 1) -> None:
        if self.registry is not None:
            for _ in range(n):
                self.registry.observe("train.step_time_us", dt * 1e6, "us")

    def step_start(self):
        self._t0 = self.clock()

    def step_end(self) -> bool:
        """Returns True if this step was a straggler."""
        if self._t0 is None:  # step_start never called: nothing to score
            return False
        dt = self.clock() - self._t0
        self._t0 = None
        hist = self._durations[-self.window:]
        slow = bool(hist) and dt > self.deadline_factor * float(np.median(hist))
        self._durations.append(dt)
        self._observe(dt)
        if slow:
            self.slow_steps += 1
        return slow

    def window_end(self, n_steps: int, elapsed: float) -> bool:
        """Attribute a flushed window's wall time evenly across its steps.

        With async dispatch the per-step device time is only observable at
        the sync boundary (the trainer buffers metrics between log /
        checkpoint flushes), so the watchdog scores the window's per-step
        AVERAGE against the trailing median. Returns True if the window
        straggled; `slow_steps` then counts the whole window."""
        if n_steps <= 0:
            return False
        per_step = elapsed / n_steps
        hist = self._durations[-self.window:]
        slow = bool(hist) and \
            per_step > self.deadline_factor * float(np.median(hist))
        self._durations.extend([per_step] * n_steps)
        self._observe(per_step, n_steps)
        if slow:
            self.slow_steps += n_steps
        return slow

    @property
    def median(self) -> float:
        return float(np.median(self._durations)) if self._durations else 0.0
