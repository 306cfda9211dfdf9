"""Trainer loop driver (the port of ``repro.train.trainer``): checkpoint
hooks, straggler watchdog, preemption, resume, and host syncs ONLY at log
and checkpoint cadence.

The loop is restartable at any step (the data position and the Gumbel
generator's state are part of the checkpoint manifest), a preemption
signal triggers checkpoint-and-exit, slow windows are recorded.

Metrics stay on the DEVICE per step: the loop buffers each step's metric
tensors and fetches a whole window in ONE device -> host transfer at each
sync boundary (``log_every``, checkpoint, end of run); ``host_syncs``
counts them. The watchdog scores each flushed WINDOW's per-step average
wall time (``StepWatchdog.window_end``), and each flushed window is a
``gang_window`` span (``CAT_GANG_STEP``) and a ``train.steps`` counter in
the obs bundle. The bundle's retrace sentinel is checked at each flush but
watches nothing: the port compiles no step function, and the first watch
will be a captured CUDA graph's re-capture count (ROADMAP queue 1, item
9). Subclasses hook the boundaries:

- ``next_batch()``      how a step's batch is assembled
- ``on_sync(recs)``     runs after every flush with the new host records
                        (onboarding admits/evicts/graduates here)
- ``should_stop()``     early-exit check (the onboarding queue drained)
- ``extra_state()`` / ``restore_extra()``  manifest payload for exact
  resume

On a mesh (``mesh=``) every rank runs this loop in lockstep on the same
host state: the same batches, the same generator state, the same sync
and checkpoint steps. Checkpoints go through the mesh's
``CheckpointManager`` (gathered whole, written by the mesh's rank 0);
``try_resume`` restores onto the state's own placement; only rank 0
prints (``self.lead``).
"""
from __future__ import annotations

import time
import zipfile
from typing import Callable, List, Optional

import torch

from repro_torch import obs as OBS
from repro_torch.checkpoint import CheckpointManager
from repro_torch.distributed import sharding as SH
from repro_torch.distributed.fault import PreemptionHandler, StepWatchdog
from repro_torch.obs import trace as TR
from repro_torch.resilience.integrity import CheckpointCorruptError
from repro_torch.utils.tree import tree_leaves


def to_device(batch: dict, device) -> dict:
    """A numpy batch on ``device``; on the card through pinned memory
    without blocking, so the copy does not wait for queued steps."""
    out = {}
    for k, v in batch.items():
        t = torch.as_tensor(v)
        if device.type == "cuda" and t.device.type == "cpu":
            t = t.pin_memory().to(device, non_blocking=True)
        out[k] = t.to(device)
    return out


class Trainer:
    def __init__(self, step_fn: Callable, state, loader, *,
                 ckpt_dir: Optional[str] = None, ckpt_every: int = 100,
                 keep_last: int = 3, watchdog: Optional[StepWatchdog] = None,
                 preemption: Optional[PreemptionHandler] = None,
                 log_every: int = 10, rng=None, fault_plan=None, obs=None,
                 mesh=None):
        self.step_fn = step_fn
        self.state = state
        self.loader = loader
        self.step = 0
        self.ckpt_every = ckpt_every
        # the rank that prints (and, through the manager, writes)
        self.lead = mesh is None or SH.is_lead(mesh)
        self.mgr = CheckpointManager(ckpt_dir, keep_last,
                                     fault_plan=fault_plan, mesh=mesh) \
            if ckpt_dir else None
        # the straggler watchdog is the train-side metric source: wired to
        # the bundle's registry it gives p50/p99 step time
        self.obs = OBS.get(obs)
        if watchdog is None:
            watchdog = StepWatchdog(
                registry=self.obs.metrics if self.obs.enabled else None)
        self.watchdog = watchdog
        self.preemption = preemption
        self.log_every = log_every
        self.device = tree_leaves(state)[0].device
        # the Gumbel noise's generator, consumed by the step function
        self.rng = rng if rng is not None else \
            torch.Generator(device=self.device).manual_seed(0)
        self.history = []
        # buffered (step, device-metric-dict) pairs since the last flush:
        # nothing here blocks on the device
        self._pending: List[tuple] = []
        self._window_t0: Optional[float] = None
        self.host_syncs = 0

    # ------------------------------------------------------------- recovery
    def try_resume(self) -> bool:
        """Resume from the newest checkpoint that verifies: a torn or
        corrupt latest checkpoint falls back to the one before it (and so
        on), never fails the run. On a mesh each rank keeps its block of
        every leaf the state holds as one (``SH.shardings_of``)."""
        if not self.mgr:
            return False
        for latest in reversed(self.mgr.all_steps()):
            try:
                state = self.mgr.restore(
                    latest, self.state,
                    shardings=SH.shardings_of(self.state))
            except (CheckpointCorruptError, OSError, ValueError,
                    zipfile.BadZipFile):
                continue  # torn/corrupt payload: walk back one checkpoint
            self.state = state
            man = self.mgr.manifest(latest)
            self.step = man["step"]
            self.restore_extra(man["extra"])
            return True
        return False

    def extra_state(self) -> dict:
        """Manifest payload for exact resume (subclasses extend): the
        loader position and the generator's state as a list of bytes."""
        return {"loader": self.loader.state_dict(),
                "rng": self.rng.get_state().tolist()}

    def restore_extra(self, extra: dict) -> None:
        self.loader.load_state_dict(extra["loader"])
        if "rng" in extra:
            self.rng.set_state(torch.tensor(extra["rng"], dtype=torch.uint8))

    def checkpoint(self, blocking=True):
        if self.mgr:
            self.flush()  # history/manifest must reflect all taken steps
            self.mgr.save(self.step, self.state, blocking=blocking,
                          extra=self.extra_state())

    # ----------------------------------------------------------------- hooks
    def next_batch(self) -> dict:
        return to_device(self.loader.next(), self.device)

    def on_sync(self, recs: list) -> None:
        """Called after each metric flush with the new host records."""

    def should_stop(self) -> bool:
        return False

    # ----------------------------------------------------------------- sync
    def flush(self) -> list:
        """ONE device -> host transfer for every buffered step's metrics;
        appends the float records to ``history`` and returns them. The
        transfer drains the window's queued device work, so the wall time
        elapsed here is the window's true step time, fed to the watchdog
        as the per-step average."""
        if not self._pending:
            return []
        steps, mets = zip(*self._pending)
        self._pending = []
        keys = [sorted(m) for m in mets]
        flat = [torch.as_tensor(m[k]).float().reshape(())
                for m, ks in zip(mets, keys) for k in ks]
        host = torch.stack(flat).cpu().tolist()
        self.host_syncs += 1
        slow = False
        if self._window_t0 is not None:
            now = time.perf_counter()
            slow = self.watchdog.window_end(
                len(steps), now - self._window_t0)
            # one span per flushed WINDOW: per-step device time is not
            # observable without a per-step block
            self.obs.tracer.complete(TR.CAT_GANG_STEP, "gang_window",
                                     self._window_t0, now,
                                     steps=len(steps), straggler=slow)
            self.obs.metrics.inc("train.steps", len(steps))
            self._window_t0 = None
        self.obs.sentinel.check()
        recs, i = [], 0
        for s, ks in zip(steps, keys):
            rec = dict(zip(ks, host[i:i + len(ks)]))
            i += len(ks)
            rec["step"] = s
            rec["straggler"] = slow
            recs.append(rec)
        self.history.extend(recs)
        return recs

    def sync(self) -> list:
        recs = self.flush()
        if recs:
            self.on_sync(recs)
        return recs

    # ----------------------------------------------------------------- loop
    def run(self, num_steps: int) -> list:
        for _ in range(num_steps):
            if self.preemption and self.preemption.preempted():
                self.sync()
                self.checkpoint(blocking=True)
                break
            if self.should_stop():
                break
            batch = self.next_batch()
            if self._window_t0 is None:
                self._window_t0 = time.perf_counter()
            self.state, metrics = self.step_fn(self.state, batch, self.rng)
            self.step += 1
            self._pending.append((self.step, metrics))
            if self.step % self.log_every == 0:
                recs = self.sync()
                if recs and self.lead:
                    rec = recs[-1]
                    print(f"step {self.step} " +
                          " ".join(f"{k}={v:.4f}" for k, v in rec.items()
                                   if isinstance(v, float)))
            if self.mgr and self.step % self.ckpt_every == 0:
                self.sync()
                self.checkpoint(blocking=False)
        self.sync()
        if self.mgr:
            self.mgr.wait()
        return self.history
