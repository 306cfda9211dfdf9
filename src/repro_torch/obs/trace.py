"""Span tracer emitting Chrome-trace-event JSON (open in Perfetto /
``chrome://tracing``).

Spans cover the host-side orchestration the aggregate counters can't
explain: admission waves, prefill buckets, decode windows, preempt/resume,
spec draft/verify rounds, gang steps, graduation, degraded/quarantine
events. Nothing here ever touches the device — a span brackets work the
host was already doing, so tracing changes no compiled program and no
sync schedule.

The ring buffer is bounded (``deque(maxlen=capacity)``): leaving the
tracer on forever costs a fixed few MB and drops the OLDEST events, never
blocks. ``dropped`` counts evictions so an exported trace says whether it
is a suffix of the run.

Each category gets its own fake thread id so Perfetto renders one lane
per subsystem; "M" metadata events name the lanes.
"""
from __future__ import annotations

import json
import os
import time
from collections import deque
from contextlib import contextmanager
from typing import Dict, Optional

# Canonical categories. Emitters may use others, but these are the lanes
# the obs smoke asserts are present end-to-end.
CAT_ADMISSION = "admission"
CAT_PREFILL = "prefill"
CAT_DECODE_WINDOW = "decode-window"
CAT_PREEMPT = "preempt"
CAT_SPEC = "spec"
CAT_GANG_STEP = "gang-step"
CAT_GRADUATION = "graduation"
CAT_RESILIENCE = "resilience"


class SpanTracer:
    def __init__(self, capacity: int = 65536, enabled: bool = True,
                 clock=time.perf_counter):
        self.enabled = enabled
        self.capacity = capacity
        self.clock = clock
        self.dropped = 0
        self._events = deque(maxlen=capacity)
        self._tids: Dict[str, int] = {}
        self._pid = os.getpid()

    # ------------------------------------------------------------------ write
    def _tid(self, cat: str) -> int:
        tid = self._tids.get(cat)
        if tid is None:
            tid = self._tids[cat] = len(self._tids) + 1
        return tid

    def _emit(self, ev: dict) -> None:
        if len(self._events) == self.capacity:
            self.dropped += 1
        self._events.append(ev)

    @contextmanager
    def span(self, cat: str, name: str, **args):
        """Complete-event ("X") span around a host-side block. Yields the
        args dict so the body can attach results (e.g. admitted count)."""
        if not self.enabled:
            yield args
            return
        t0 = self.clock()
        try:
            yield args
        finally:
            t1 = self.clock()
            self._emit({"name": name, "cat": cat, "ph": "X",
                        "ts": t0 * 1e6, "dur": (t1 - t0) * 1e6,
                        "pid": self._pid, "tid": self._tid(cat),
                        "args": args})

    def complete(self, cat: str, name: str, t0: float, t1: float,
                 **args) -> None:
        """Retroactive "X" span over [t0, t1] (same clock as `span`) — for
        intervals whose start predates the emit site, e.g. a decode window
        opened by the previous sync."""
        if not self.enabled:
            return
        self._emit({"name": name, "cat": cat, "ph": "X", "ts": t0 * 1e6,
                    "dur": (t1 - t0) * 1e6, "pid": self._pid,
                    "tid": self._tid(cat), "args": args})

    def instant(self, cat: str, name: str, **args) -> None:
        """Zero-duration marker ("i") for point events (degraded request,
        quarantine, retry, graduation)."""
        if not self.enabled:
            return
        self._emit({"name": name, "cat": cat, "ph": "i", "s": "t",
                    "ts": self.clock() * 1e6, "pid": self._pid,
                    "tid": self._tid(cat), "args": args})

    # ------------------------------------------------------------------- read
    def events(self) -> list:
        return list(self._events)

    def category_counts(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for ev in self._events:
            out[ev["cat"]] = out.get(ev["cat"], 0) + 1
        return out

    def export(self, path: str) -> dict:
        """Write Chrome JSON trace format; returns the written object."""
        meta = [{"name": "thread_name", "ph": "M", "pid": self._pid,
                 "tid": tid, "args": {"name": cat}}
                for cat, tid in self._tids.items()]
        doc = {"traceEvents": meta + self.events(),
               "displayTimeUnit": "ms",
               "otherData": {"dropped_events": self.dropped}}
        with open(path, "w") as f:
            json.dump(doc, f)
        return doc

    def reset(self) -> None:
        self._events.clear()
        self.dropped = 0


def validate_chrome_trace(doc: dict) -> Optional[str]:
    """Return None if `doc` is a loadable Chrome trace, else the problem.
    Used by the obs smoke and tests; intentionally strict about the fields
    Perfetto's importer needs."""
    if not isinstance(doc, dict) or "traceEvents" not in doc:
        return "missing traceEvents"
    for i, ev in enumerate(doc["traceEvents"]):
        if not isinstance(ev, dict):
            return f"event {i} not an object"
        for k in ("name", "ph", "pid", "tid"):
            if k not in ev:
                return f"event {i} missing {k!r}"
        if ev["ph"] in ("X", "i") and "ts" not in ev:
            return f"event {i} ({ev['ph']}) missing ts"
        if ev["ph"] == "X" and "dur" not in ev:
            return f"event {i} (X) missing dur"
    return None
