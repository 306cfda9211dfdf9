"""Fault tolerance of the training loop, the port of
``repro.distributed.fault``: the data re-balancer, preemption handling,
the step watchdog (``StepWatchdog`` lives in ``repro_torch.obs.metrics``
and is re-exported here), and elastic resize: ``surviving_mesh`` builds
the mesh left after a node failure and ``reshard_state`` moves a training
state onto it.

The process set stays the world of ``torch.distributed`` (JAX's
``jax.devices()``): the surviving mesh is built over its first ranks,
every rank taking part in the build, and the ranks left out hold no
block of a state moved onto it.
"""
from __future__ import annotations

import signal
import threading
from typing import Callable, Dict, List

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.distributed import sharding as SH
from repro_torch.obs.metrics import StepWatchdog  # noqa: F401  (re-export)
from repro_torch.utils.tree import tree_map


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


# ----------------------------------------------------------------------------
# Elastic resize
# ----------------------------------------------------------------------------

def reshard_state(state, new_shardings):
    """Move a (possibly sharded) tree onto new shardings, the core of
    elastic shrink and grow after a node failure: each leaf is gathered
    whole from its old blocks (a collective over its old mesh, so every
    rank of that mesh calls this) and cut into its ``Sharding`` in
    ``new_shardings`` (a tree of the state's nesting; None keeps a leaf
    whole). Gathering moves bytes, so the move is bitwise; a rank outside
    a new mesh holds None for that leaf."""
    return tree_map(lambda x, sh: SH.put(SH.whole(x), sh), state,
                    new_shardings)


def surviving_mesh(axis_names, shape, failed_fraction_axis: str,
                   new_size: int, device_type: str = "cuda"):
    """The post-failure mesh: ``failed_fraction_axis`` shrinks to
    ``new_size`` and the mesh takes the world's first ranks, as JAX's
    takes ``jax.devices()[:n]``. Every rank of the world must call it
    (its groups are built collectively); ranks past the first n get a
    mesh they hold no position in. Without a process group it returns the
    ``{axis: size}`` mapping, which the spec functions read as a mesh."""
    from torch.distributed.device_mesh import DeviceMesh

    sizes = dict(zip(axis_names, shape))
    sizes[failed_fraction_axis] = new_size
    n = int(np.prod(list(sizes.values())))
    if not dist.is_initialized():
        return sizes
    if n > dist.get_world_size():
        raise ValueError(f"surviving mesh {sizes} needs {n} ranks, the "
                         f"world has {dist.get_world_size()}")
    ranks = torch.arange(n).reshape(*sizes.values())
    return DeviceMesh(device_type, ranks, mesh_dim_names=tuple(sizes))
