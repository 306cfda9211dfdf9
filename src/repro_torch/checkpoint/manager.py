"""Checkpointing: atomic, async, keep-last-k, exact resume (the port of
``repro.checkpoint.manager``).

Layout: ``<dir>/step_<n>/state.npz`` + ``MANIFEST.json``, written to a
``.tmp`` directory and ``os.replace``d into place, so a partially written
checkpoint is never visible. The manifest carries the payload's crc32 and
size (``verify_step``), the caller's ``extra`` (loader position, generator
state, lifecycle state) and each leaf's torch dtype. The state's leaves
are keyed by their ``tree_paths`` path, JAX's keys.

bf16 leaves travel as their 16 bits (an ``int16`` view) and are
re-labelled from the manifest's dtype record on restore: numpy has no
bf16 dtype without ``ml_dtypes``, which the port does not use.

An async save makes the blocking device -> host copy first, then writes
on a daemon thread that ``wait()`` joins.

On a mesh (``mesh=``) every rank calls ``save`` at the same steps: each
``Sharded`` leaf (a slot-packed roster's rows, a frozen tree's blocks) is
gathered whole, and the mesh's rank 0 writes the same ``state.npz`` and
``MANIFEST.json`` a one-device save writes; every rank meets at a barrier
after a blocking write and in ``wait()``, so none reads ``latest_step``
before the file is there. ``restore(shardings=)`` has each rank read the
payload and cut its own block for the mesh it names. The format never
changes, so a checkpoint written on any mesh restores on any other mesh,
or on none.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
from typing import Optional

import numpy as np
import torch

from repro_torch.distributed import sharding as SH
from repro_torch.resilience.integrity import CheckpointCorruptError, \
    file_crc
from repro_torch.utils.tree import map_with_path, tree_paths


def _jsonify(obj):
    """Manifest extras must survive a JSON round trip: lifecycle state
    arrives as numpy scalars/arrays from device fetches, which
    ``json.dump`` rejects; convert recursively to native Python types."""
    if isinstance(obj, dict):
        return {str(k): _jsonify(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_jsonify(v) for v in obj]
    if isinstance(obj, np.ndarray):
        return obj.tolist()
    if isinstance(obj, np.generic):
        return obj.item()
    return obj


def _to_host(leaf) -> np.ndarray:
    """A leaf as a host numpy array; bf16 as its bits in an int16 view."""
    if not torch.is_tensor(leaf):
        return np.asarray(leaf)
    t = leaf.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return t.numpy()


def _dtype_name(leaf) -> str:
    return str(leaf.dtype).removeprefix("torch.") if torch.is_tensor(leaf) \
        else np.asarray(leaf).dtype.name


class CheckpointManager:
    def __init__(self, directory: str, keep_last: int = 3,
                 fault_plan=None, mesh=None):
        self.dir = directory
        self.keep_last = keep_last
        # on a mesh every rank gathers, its rank 0 alone writes
        self.mesh = mesh
        self.writer = mesh is None or SH.is_lead(mesh)
        self._thread: Optional[threading.Thread] = None
        # chaos seam: a FaultPlan may truncate a payload AFTER its manifest
        # checksum was computed, the torn-write case verify_step catches
        self.fault_plan = fault_plan
        os.makedirs(directory, exist_ok=True)

    # ------------------------------------------------------------------ save
    def save(self, step: int, state, *, blocking: bool = True,
             extra: Optional[dict] = None):
        """Snapshot to host memory synchronously, write to disk (with
        ``blocking=False`` on a daemon thread). The device -> host copy is
        the only blocking part. On a mesh, every rank calls it: the
        ``Sharded`` leaves are gathered whole (collectives) and rank 0
        writes."""
        paths = tree_paths(SH.whole_tree(state))
        if not self.writer:
            if blocking:
                SH.barrier(self.mesh)
            return
        host_flat = {k: _to_host(v) for k, v in paths.items()}
        meta = {"step": int(step), "time": time.time(),
                "extra": _jsonify(extra or {}),
                "dtypes": {k: _dtype_name(v) for k, v in paths.items()}}
        if blocking:
            self._write(step, host_flat, meta)
            if self.mesh is not None:
                SH.barrier(self.mesh)
        else:
            self._join()
            self._thread = threading.Thread(
                target=self._write, args=(step, host_flat, meta), daemon=True)
            self._thread.start()

    def _write(self, step: int, host_flat: dict, meta: dict):
        final = os.path.join(self.dir, f"step_{step:010d}")
        tmp = final + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        state_path = os.path.join(tmp, "state.npz")
        np.savez(state_path,
                 **{k.replace("/", "__"): v for k, v in host_flat.items()})
        crc, nbytes = file_crc(state_path)
        meta = dict(meta, state_crc32=crc, state_nbytes=nbytes)
        if self.fault_plan is not None and \
                self.fault_plan.truncate_checkpoint(step):
            with open(state_path, "r+b") as f:  # torn write: drop the tail
                f.truncate(max(nbytes // 2, 1))
        with open(os.path.join(tmp, "MANIFEST.json"), "w") as f:
            json.dump(meta, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.replace(tmp, final)
        self._gc()

    def wait(self):
        """Join the async write; on a mesh every rank then meets, so the
        checkpoint is on disk for all of them."""
        self._join()
        if self.mesh is not None:
            SH.barrier(self.mesh)

    def _join(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _gc(self):
        steps = self.all_steps()
        for s in steps[:-self.keep_last] if self.keep_last else []:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:010d}"),
                          ignore_errors=True)

    # --------------------------------------------------------------- restore
    def all_steps(self):
        out = []
        for name in os.listdir(self.dir):
            if name.startswith("step_") and not name.endswith(".tmp"):
                if os.path.exists(os.path.join(self.dir, name,
                                               "MANIFEST.json")):
                    out.append(int(name.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def verify_step(self, step: int) -> None:
        """Check a checkpoint's payload against its manifest checksum;
        raises ``CheckpointCorruptError`` on a size or crc32 mismatch (torn
        write, disk corruption). A manifest without the checksum field
        passes: there is nothing to verify it against."""
        path = os.path.join(self.dir, f"step_{step:010d}", "state.npz")
        if not os.path.exists(path):
            raise CheckpointCorruptError(
                f"step {step}: state.npz missing")
        meta = self.manifest(step)
        if "state_crc32" not in meta:
            return
        crc, nbytes = file_crc(path)
        if nbytes != meta["state_nbytes"]:
            raise CheckpointCorruptError(
                f"step {step}: payload {nbytes}B != "
                f"manifest {meta['state_nbytes']}B (truncated write)")
        if crc != meta["state_crc32"]:
            raise CheckpointCorruptError(
                f"step {step}: payload crc32 {crc:#010x} != "
                f"manifest {meta['state_crc32']:#010x}")

    def latest_good_step(self) -> Optional[int]:
        """Newest step whose payload verifies: the resume fallback walks
        backward past torn or corrupt checkpoints to the last good one."""
        for step in reversed(self.all_steps()):
            try:
                self.verify_step(step)
                return step
            except CheckpointCorruptError:
                continue
        return None

    def restore(self, step: int, like_state, shardings=None):
        """Rebuild the state tree from disk in ``like_state``'s nesting:
        each leaf on the device of the matching leaf of ``like_state``,
        with its dtype. Verifies the payload checksum first.

        ``shardings``: a tree of ``like_state``'s nesting whose leaves are
        ``SH.Sharding`` (this rank keeps its block of the whole leaf) or
        None (whole); without it every leaf comes back whole."""
        self.verify_step(step)
        meta = self.manifest(step)
        dtypes = meta.get("dtypes", {})
        with np.load(os.path.join(self.dir, f"step_{step:010d}",
                                  "state.npz")) as z:
            flat = {k.replace("__", "/"): z[k] for k in z.files}
        paths = tree_paths(like_state)
        if set(paths) != set(flat):
            raise ValueError(f"checkpoint/state mismatch: "
                             f"{sorted(set(paths) ^ set(flat))}")
        where = tree_paths(shardings) if shardings is not None else {}

        def leaf(path, like):
            arr = flat[path]
            if dtypes.get(path) == "bfloat16":
                t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
            else:
                t = torch.from_numpy(arr)
            # this rank's block, cut on the host before the copy
            t = SH.put(t, where.get(path))
            if t is not None and (torch.is_tensor(like)
                                  or isinstance(like, SH.Sharded)):
                t = SH.to(t, device=like.device, dtype=like.dtype)
            return t
        return map_with_path(leaf, like_state)

    def manifest(self, step: int) -> dict:
        with open(os.path.join(self.dir, f"step_{step:010d}",
                               "MANIFEST.json")) as f:
            return json.load(f)
