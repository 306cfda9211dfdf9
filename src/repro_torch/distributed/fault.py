"""Fault tolerance of the training loop, the port of
``repro.distributed.fault``: the data re-balancer, preemption handling,
and the step watchdog (``StepWatchdog`` lives in
``repro_torch.obs.metrics`` and is re-exported here).

Every mechanism here is host-side. The elastic half of the JAX module,
``reshard_state`` and ``surviving_mesh`` (moving a sharded training state
onto the mesh that survives a node failure), belongs to the training half
of multi-device, which is not ported (ROADMAP queue 1, item 11; the port
serves on a mesh): those names raise ``NotImplementedError``.
"""
from __future__ import annotations

import signal
import threading
from typing import Callable, Dict, List

import numpy as np

from repro_torch.obs.metrics import StepWatchdog  # noqa: F401  (re-export)

_MESH = ("elastic resharding of a training state is the training half of "
         "multi-device, which is not ported (ROADMAP queue 1, item 11)")


def rebalance_assignment(num_examples: int, hosts: List[int],
                         slow_hosts: Dict[int, float]) -> Dict[int, range]:
    """Re-split the data range across hosts, down-weighting stragglers.

    slow_hosts: {host_id: relative_speed in (0,1]}; a host at 0.5 gets half
    a share. Deterministic: every host computes the same assignment.
    """
    if not hosts:
        raise ValueError("rebalance_assignment: hosts must be non-empty")
    weights = np.array([slow_hosts.get(h, 1.0) for h in hosts], np.float64)
    # a reported speed of 0 means "barely alive", not "assign nothing at
    # the cost of a 0/0 split": clamp to a positive floor
    weights = np.maximum(weights, 1e-6)
    weights = weights / weights.sum()
    counts = np.floor(weights * num_examples).astype(int)
    counts[-1] += num_examples - counts.sum()
    out, lo = {}, 0
    for h, c in zip(hosts, counts):
        out[h] = range(lo, lo + int(c))
        lo += int(c)
    return out


class PreemptionHandler:
    """SIGTERM / SIGINT -> set a flag; the trainer checkpoints and exits
    cleanly at the next step boundary.

    Chains to any previously installed Python handler instead of silently
    replacing it. SIG_DFL / SIG_IGN / the default KeyboardInterrupt
    handler are NOT chained: re-raising KeyboardInterrupt would defeat the
    graceful checkpoint this handler exists to allow.
    """

    def __init__(self, sigs=(signal.SIGTERM, signal.SIGINT)):
        self._flag = threading.Event()
        self._prev: Dict[int, Callable] = {}
        for sig in (sigs if isinstance(sigs, (tuple, list)) else (sigs,)):
            try:
                prev = signal.signal(sig, self._on)
            except ValueError:
                continue  # not the main thread
            if callable(prev) and prev is not signal.default_int_handler:
                self._prev[int(sig)] = prev

    def _on(self, signum=None, frame=None):
        self._flag.set()
        prev = self._prev.get(int(signum)) if signum is not None else None
        if prev is not None:
            prev(signum, frame)

    def preempted(self) -> bool:
        return self._flag.is_set()

    def trigger(self):
        """Set the flag as a signal would (tests, drills)."""
        self._flag.set()


def reshard_state(state, new_shardings):
    raise NotImplementedError(f"reshard_state: {_MESH}")


def surviving_mesh(axis_names, shape, failed_fraction_axis: str,
                   new_size: int):
    raise NotImplementedError(f"surviving_mesh: {_MESH}")
