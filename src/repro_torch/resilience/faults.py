"""`FaultPlan`: seeded, declarative fault injection for the chaos harness.

One plan object describes every fault a run injects; the hot paths carry
thin seams that consult it (`fault_plan=None` everywhere in production —
the seams cost nothing when no plan is installed):

- hydration faults  — `ServeEngine` admission probes call `on_hydration`
                      per (pid, attempt): persistent failures exhaust the
                      retry budget (the request degrades to the bare PLM),
                      flaky ones fail only the first attempt (the retry
                      succeeds), delays inject latency spikes.
- store corruption  — `corrupt_store` flips payload bytes of chosen
                      records WITHOUT updating their checksums, exactly
                      like disk/transfer corruption; the store's crc
                      verification must catch it at load/hydration.
- gang poisoning    — `gang_poison_mask` marks roster slots whose grads
                      the step overwrites with non-finite values
                      (on the device, deterministic per slot_step),
                      exercising the per-slot finite guard.
- checkpoint faults — `truncate_checkpoint(step)` truncates the written
                      payload after its manifest checksum was computed,
                      the torn-write case resume must survive.

Every stochastic decision hashes (seed, kind, id) through crc32, so the
SAME plan replayed gives the SAME faults — benches compute the expected
degraded set from the plan itself and gate equality.
"""
from __future__ import annotations

import zlib
from dataclasses import dataclass, field
from typing import Callable, Iterable, List, Optional, Tuple

import numpy as np


class InjectedFault(Exception):
    """Base class for faults raised by a FaultPlan."""


class InjectedHydrationError(InjectedFault):
    """A plan-injected profile hydration failure."""

    def __init__(self, pid: int, attempt: int, persistent: bool):
        self.pid = int(pid)
        self.attempt = int(attempt)
        self.persistent = persistent
        kind = "persistent" if persistent else "transient"
        super().__init__(f"injected {kind} hydration failure: "
                         f"profile {pid}, attempt {attempt}")


@dataclass
class FaultPlan:
    seed: int = 0
    # -- hydration (serve admission) --------------------------------------
    hydration_fail_rate: float = 0.0    # persistent: every attempt fails
    hydration_flaky_rate: float = 0.0   # transient: only attempt 0 fails
    hydration_delay_rate: float = 0.0   # latency spike, then success
    hydration_delay_s: float = 0.0
    fail_pids: Tuple[int, ...] = ()     # explicit persistent failures
    flaky_pids: Tuple[int, ...] = ()    # explicit transient failures
    # -- store record corruption ------------------------------------------
    corrupt_pids: Tuple[int, ...] = ()  # records whose payload bytes flip
    corrupt_agg_only: bool = False      # flip only agg_* (quantized) fields
    # -- gang-step grad poisoning -----------------------------------------
    poison_slots: Tuple[int, ...] = ()  # roster slots with non-finite grads
    poison_from_step: int = 0           # ...once slot_step reaches this
    poison_steps: Optional[int] = None  # ...for this many steps (None=always)
    # -- checkpoint truncation --------------------------------------------
    truncate_ckpt_steps: Tuple[int, ...] = ()
    sleep: Callable[[float], None] = field(default=None, repr=False)

    # ------------------------------------------------------------- decisions
    def _u(self, kind: str, ident: int) -> float:
        """Deterministic uniform in [0, 1) for one (kind, id) decision."""
        h = zlib.crc32(f"{self.seed}:{kind}:{int(ident)}".encode())
        return (h & 0xFFFFFFFF) / 2.0 ** 32

    def hydration_mode(self, pid: int) -> Optional[str]:
        """"fail" | "flaky" | "delay" | None for one profile — stable
        across attempts and waves (what makes failures persistent)."""
        pid = int(pid)
        if pid in self.fail_pids:
            return "fail"
        if pid in self.flaky_pids:
            return "flaky"
        u = self._u("hydration", pid)
        edge = self.hydration_fail_rate
        if u < edge:
            return "fail"
        edge += self.hydration_flaky_rate
        if u < edge:
            return "flaky"
        edge += self.hydration_delay_rate
        if u < edge:
            return "delay"
        return None

    def on_hydration(self, pid: int, attempt: int) -> None:
        """Seam called before each hydration attempt; raises or delays."""
        mode = self.hydration_mode(pid)
        if mode == "fail":
            raise InjectedHydrationError(pid, attempt, persistent=True)
        if mode == "flaky" and attempt == 0:
            raise InjectedHydrationError(pid, attempt, persistent=False)
        if mode == "delay" and attempt == 0 and self.hydration_delay_s > 0:
            (self.sleep or __import__("time").sleep)(self.hydration_delay_s)

    def persistent_fail_pids(self, pids: Iterable[int]) -> List[int]:
        """The subset of `pids` whose hydration can never succeed — the
        bench's expected-degraded set (corrupt records add to it)."""
        return [int(p) for p in pids
                if self.hydration_mode(p) == "fail"]

    def flaky_hydration_pids(self, pids: Iterable[int]) -> List[int]:
        return [int(p) for p in pids
                if self.hydration_mode(p) == "flaky"]

    # ------------------------------------------------------------ corruption
    def corrupt_store(self, store) -> List[dict]:
        """Flip payload bytes of each `corrupt_pids` record IN the store,
        leaving its recorded checksums stale — the disk-corruption model.
        Returns [{"pid", "key"}] of what was corrupted. Deterministic:
        the flipped offset comes from the plan seed."""
        events = []
        for pid in self.corrupt_pids:
            rec = store._rec.get(int(pid))
            if not rec:
                continue
            keys = [k for k in sorted(rec)
                    if not self.corrupt_agg_only or k.startswith("agg_")]
            if not keys:
                continue
            key = keys[int(self._u("corrupt_key", pid) * len(keys))
                       % len(keys)]
            arr = np.array(rec[key], copy=True)
            flat = arr.view(np.uint8).reshape(-1)
            off = int(self._u("corrupt_off", pid) * flat.size) % flat.size
            flat[off] ^= 0xFF
            rec[key] = arr
            events.append({"pid": int(pid), "key": key})
        return events

    # --------------------------------------------------------- gang poisoning
    def poisons_gang(self) -> bool:
        return bool(self.poison_slots)

    def gang_poison_mask(self, slot_step, capacity: int, first: int = 0):
        """Bool tensor of ``slot_step``'s shape: slots whose grads this step
        poisons, decided from the device-resident per-slot step counter
        ``slot_step`` (on its device, no host sync), so the injection is
        deterministic across resumes. ``slot_step`` covers the global
        slots ``[first, first + len)`` of a roster of ``capacity`` (a mesh
        rank's rows; all of them off a mesh)."""
        import torch

        # built on the device from scalars: a host -> device copy would
        # synchronize the stream every step
        n = slot_step.shape[0]
        ar = torch.arange(first, first + n, device=slot_step.device)
        sel = torch.zeros((n,), dtype=torch.bool, device=slot_step.device)
        for s in self.poison_slots:
            if 0 <= int(s) < capacity:
                sel = sel | (ar == int(s))
        window = slot_step >= self.poison_from_step
        if self.poison_steps is not None:
            window = window & (slot_step
                               < self.poison_from_step + self.poison_steps)
        return sel & window

    # ------------------------------------------------------------ checkpoints
    def truncate_checkpoint(self, step: int) -> bool:
        return int(step) in self.truncate_ckpt_steps
