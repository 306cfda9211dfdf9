"""LRU cache of admission-time aggregated profile adapters.

The extreme multi-profile regime is R requests over P ≪ R profiles: most
admissions re-request a profile the engine has already aggregated. Caching
the aggregated Â/B̂ (plus the adapter-LN affine) keyed by ``profile_id``
makes the repeat admission a pure gather — ZERO bank bytes read — and the
entry is exactly the decode-hot-path representation, so a hit feeds the
slot-buffer scatter directly.

Capacity is budgeted in BYTES, not entries: an entry is 2·L·d·b values of
bank dtype plus the [L, b] affines, so the operator knob maps directly to
device memory (`ServeEngine(cache_bytes=...)`). Eviction is LRU.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Dict, Optional


def entry_nbytes(entry: dict) -> int:
    """TRUE bytes of an entry's arrays. Quantized entries ({a_q, a_scale,
    b_q, b_scale, ...} under bank_quant) are budgeted at their int8 /
    packed-int4 payload + fp16 scale widths — size x itemsize IS the
    quantized record size, so the same byte knob holds 2x (int8) / ~3.6x
    (int4) more resident profiles with no accounting change. Typed
    (heterogeneous-bank) entries count every family's aggregates, the
    prefix rows and gate, and the 0-d int32 ``prefix_on`` flag (4 bytes,
    as JAX counts its ``np.int32``)."""
    return sum(v.numel() * v.element_size() for v in entry.values())


class ProfileCache:
    """LRU of {"a_hat", "b_hat", "ln_scale", "ln_bias"} device-array trees.

    capacity_bytes=None means unbounded; capacity_bytes=0 disables caching
    (every get misses, puts are dropped) — the paper-faithful baseline.
    """

    def __init__(self, capacity_bytes: Optional[int] = 64 << 20):
        self.capacity = capacity_bytes
        self._entries: "OrderedDict[int, dict]" = OrderedDict()
        self._sizes: Dict[int, int] = {}
        self.bytes_used = 0
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.rejects = 0        # over-capacity puts dropped (never cached)
        self.invalidations = 0  # entries dropped by re-training/graduation

    def __len__(self) -> int:
        return len(self._entries)

    def __contains__(self, pid) -> bool:
        return int(pid) in self._entries

    def get(self, pid: int) -> Optional[dict]:
        entry = self._entries.get(int(pid))
        if entry is None:
            self.misses += 1
            return None
        self._entries.move_to_end(int(pid))
        self.hits += 1
        return entry

    def peek(self, pid: int) -> Optional[dict]:
        """get() without touching LRU order or hit/miss counters."""
        return self._entries.get(int(pid))

    def put(self, pid: int, entry: dict) -> None:
        pid = int(pid)
        size = entry_nbytes(entry)
        if self.capacity is not None and size > self.capacity:
            # larger than the whole budget; don't thrash the cache — but a
            # silent drop made hit-rates incomparable across runs, so count
            self.rejects += 1
            return
        if pid in self._entries:
            self.bytes_used -= self._sizes.pop(pid)
            del self._entries[pid]
        self._entries[pid] = entry
        self._sizes[pid] = size
        self.bytes_used += size
        while (self.capacity is not None and self.bytes_used > self.capacity
               and len(self._entries) > 1):
            old_pid, _ = self._entries.popitem(last=False)
            self.bytes_used -= self._sizes.pop(old_pid)
            self.evictions += 1

    def invalidate(self, pid: int) -> bool:
        """Drop a profile (e.g. after re-training updated its masks)."""
        pid = int(pid)
        if pid not in self._entries:
            return False
        del self._entries[pid]
        self.bytes_used -= self._sizes.pop(pid)
        self.invalidations += 1
        return True

    def clear(self) -> None:
        """Drop every entry AND reset all counters — a cleared cache starts
        a fresh, comparable measurement window (hit-rates in
        BENCH_serve.json used to drift across clear() boundaries)."""
        self._entries.clear()
        self._sizes.clear()
        self.bytes_used = 0
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.rejects = 0
        self.invalidations = 0

    def reset_stats(self) -> None:
        """Reset the flow counters ONLY (engine.reset_stats()): entries and
        resident bytes survive — a warm cache after a counter reset should
        report warm hit-rates, not lose its contents like clear() does."""
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.rejects = 0
        self.invalidations = 0

    @property
    def hit_rate(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 0.0

    def stats(self) -> dict:
        return {"entries": len(self._entries), "bytes": self.bytes_used,
                "capacity_bytes": self.capacity, "hits": self.hits,
                "misses": self.misses, "evictions": self.evictions,
                "rejects": self.rejects,
                "invalidations": self.invalidations,
                "hit_rate": round(self.hit_rate, 4)}
