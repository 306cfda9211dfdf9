"""Always-on retrace sentinel (the port of ``repro.obs.sentinel``).

A compiled hot-path function registers a watch on its compile counter,
and ``check()`` — called at the sync boundaries the engine already has —
raises (or logs) the moment it compiles more often than its contract
allows. The port compiles nothing on its serving path yet, so its engine
registers no watch; a captured CUDA graph of the decode step (re-capture
counted) is the first function to watch.

Two contracts, because hot-path fns come in two shapes:

- fixed-signature fns (engine slot step, gang step): ``budget=N`` — more
  than N traces is a bug, full stop.
- shape-polymorphic fns (admit scatter over variable wave sizes, prefill
  over bucket shapes): a new input shape legitimately compiles a new
  program, so the watch also tracks DISTINCT SHAPES seen; the invariant
  is ``traces <= distinct_shapes`` — a retrace WITHOUT a new shape means
  the inputs drifted.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional


class RetraceError(RuntimeError):
    pass


class _Watch:
    __slots__ = ("count_fn", "budget", "shapes_fn")

    def __init__(self, count_fn, budget, shapes_fn):
        self.count_fn = count_fn
        self.budget = budget
        self.shapes_fn = shapes_fn


class RetraceSentinel:
    """mode: "raise" (smokes/CI), "log" (production default), "off"."""

    def __init__(self, mode: str = "log", log=None):
        assert mode in ("raise", "log", "off")
        self.mode = mode
        self.log = log or (lambda msg: print(msg, flush=True))
        self._watches: Dict[str, _Watch] = {}
        self.violations_seen = 0

    def watch(self, name: str, count_fn: Callable[[], int],
              budget: Optional[int] = None,
              shapes_fn: Optional[Callable[[], int]] = None) -> None:
        """Register a trace counter. `budget`: max allowed traces (None =
        unbounded). `shapes_fn`: distinct input shapes seen — when given,
        traces exceeding shapes is a violation even under the budget.

        A count_fn returning None means its owner is gone (watchers hold
        engines WEAKLY — the sentinel must never pin a dead engine's
        device state); the watch is dropped at the next counts()/check().
        """
        self._watches[name] = _Watch(count_fn, budget, shapes_fn)

    def _live(self):
        dead = [n for n, w in self._watches.items() if w.count_fn() is None]
        for n in dead:
            del self._watches[n]
        return self._watches

    def counts(self) -> Dict[str, dict]:
        out = {}
        for name, w in self._live().items():
            row = {"traces": int(w.count_fn()), "budget": w.budget}
            if w.shapes_fn is not None:
                row["shapes"] = int(w.shapes_fn())
            out[name] = row
        return out

    def check(self) -> list:
        """Evaluate every watch; returns the violation strings (and raises
        in "raise" mode). Cheap — a few int compares — so callers run it
        at every sync/flush boundary."""
        if self.mode == "off":
            return []
        bad = []
        for name, w in self._live().items():
            traces = int(w.count_fn())
            if w.budget is not None and traces > w.budget:
                bad.append(f"{name}: {traces} traces > budget {w.budget}")
            elif w.shapes_fn is not None:
                shapes = int(w.shapes_fn())
                if traces > shapes:
                    bad.append(f"{name}: {traces} traces for {shapes} "
                               "distinct input shapes (placement drift?)")
        if bad:
            self.violations_seen += len(bad)
            msg = "retrace sentinel: " + "; ".join(bad)
            if self.mode == "raise":
                raise RetraceError(msg)
            self.log(msg)
        return bad
