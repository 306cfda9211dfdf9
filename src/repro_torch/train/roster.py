"""Device-resident roster of profile-training slots (the port of
``repro.train.roster``).

The training-side counterpart of ``serve/slots.py``: a fixed-capacity bank
of S slots, each holding one onboarding profile's trainables (mask-table
row + optional per-profile head row), its Adam moments and its
convergence EMAs, all packed along a leading slot axis as device tensors,
gated by an ``active`` mask. P >> S profiles stream through the S slots.

Invariants the onboarding layer relies on:
- admission and eviction write IN PLACE into the preallocated ``[S, ...]``
  tensors (index assignment), and so does the gang step, so no roster
  tensor changes storage, shape or dtype across admission waves (the torch
  counterpart of JAX's "the gang step traces exactly once", and what a
  captured CUDA graph of the step will need);
- a freshly admitted slot is bit-identical to a from-scratch init for that
  profile: the row is drawn from a generator seeded by
  ``(base_seed, profile_id)``, moments and EMAs are zeroed, the per-slot
  Adam step restarts at 0;
- eviction only clears ``active``; parked rows are dead weight the gang
  step masks out of both grads and optimizer updates, so neighbouring
  slots' trajectories are unaffected by any admit/evict sequence;
- convergence signals (loss/accuracy EMAs, per-slot step counts) live on
  the device and cross to the host in ONE transfer at ``metrics()``,
  called at the trainer's sync cadence, never per step.

With a ``mesh`` the state's leaves are ``distributed.sharding.Sharded``
rows over "data" (``SH.constrain_leading``): each rank holds its slots'
rows, and the host bookkeeping runs identically on every rank. ``admit``
and ``evict`` write the slot's row on the rank that holds it,
``metrics()`` gathers the six slot vectors once before its one transfer,
and ``slot_params`` broadcasts the slot's row from its rank, so every
rank packs the same record.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core import masks as M
from repro_torch.distributed import sharding as SH
from repro_torch.optim import adamw_init_rows
from repro_torch.utils import resolve_device
from repro_torch.utils.tree import tree_leaves, tree_map

# the six convergence vectors metrics() fetches, in one stacked transfer
_METRIC_KEYS = ("active", "slot_step", "ema_loss", "ema_acc", "ema_count",
                "nonfinite")


def init_slot_trainable(cfg, *, generator: torch.Generator,
                        device) -> dict:
    """One slot row (no slot axis): the mask-table row (mA, mB ~ 0.01 N(0,
    1), LN affine ones/zeros) and, with ``num_labels``, a head row
    (head_w ~ 0.02 N(0, 1) [d, C], head_b zeros), drawn from
    ``generator`` in that order."""
    xp = cfg.xpeft
    row = {"table": M.init_profile_params(cfg.num_layers, xp.num_adapters,
                                          xp.bottleneck, generator=generator,
                                          device=device)}
    if cfg.num_labels:
        row["heads"] = {
            "head_w": 0.02 * torch.randn(
                (cfg.d_model, cfg.num_labels), generator=generator,
                device=device, dtype=torch.float32),
            "head_b": torch.zeros((cfg.num_labels,), dtype=torch.float32,
                                  device=device)}
    return row


def init_roster_state(cfg, capacity: int, *, seed: int = 0,
                      device=None) -> dict:
    """Slot-packed roster state: every leaf has leading dim S = capacity;
    the rows drawn from one generator seeded ``seed``, every slot
    inactive."""
    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    rows = [init_slot_trainable(cfg, generator=gen, device=device)
            for _ in range(capacity)]
    trainable = tree_map(lambda *r: torch.stack(r), rows[0], *rows[1:])

    def zeros(dtype):
        return torch.zeros((capacity,), dtype=dtype, device=device)
    return {
        "trainable": trainable,
        "opt": adamw_init_rows(trainable, capacity),
        "active": zeros(torch.bool),
        "slot_step": zeros(torch.int32),
        "ema_loss": zeros(torch.float32),
        "ema_acc": zeros(torch.float32),
        "ema_count": zeros(torch.int32),
        # gang steps where this slot's loss/grads came back non-finite
        # (its update was skipped); the onboarding strike counter reads it
        # to quarantine the profile
        "nonfinite": zeros(torch.int32),
    }


def profile_seed(base_seed: int, pid: int) -> int:
    """The generator seed of profile ``pid``'s fresh row: a hash of
    (base_seed, pid), so re-admitting a profile reproduces its init."""
    ss = np.random.SeedSequence([int(base_seed), int(pid)])
    return int(ss.generate_state(1, np.uint64)[0] >> np.uint64(1))


class Roster:
    """Slot lifecycle ops over a roster state tree.

    The state itself is owned by the caller (the trainer checkpoints it as
    part of the train state); this class holds the config, the base seed
    fresh rows are drawn from, and the in-place admit/evict writes (on a
    ``mesh``, the writes of the rank holding the slot)."""

    def __init__(self, cfg, base_seed: int, capacity: int, *, device=None,
                 mesh=None):
        self.cfg = cfg
        self.capacity = capacity
        self.base_seed = int(base_seed)
        self.device = resolve_device(device)
        self.mesh = mesh

    def place(self, state: dict) -> dict:
        """The whole roster state held as each rank's slot rows over "data"
        (itself without a mesh)."""
        return SH.constrain_leading(state, self.mesh)

    @staticmethod
    def _own(state: dict, slot: int):
        """(the state's local tensors, ``slot``'s row in them) on the rank
        holding ``slot``, else (None, None)."""
        lo, n = SH.row_range(state["active"])
        if not lo <= slot < lo + n:
            return None, None
        return SH.local_tree(state), slot - lo

    # ------------------------------------------------------------- lifecycle
    def fresh(self, pid: int) -> dict:
        """Profile ``pid``'s from-scratch row, on the roster's device."""
        gen = torch.Generator(device=self.device).manual_seed(
            profile_seed(self.base_seed, pid))
        return init_slot_trainable(self.cfg, generator=gen,
                                   device=self.device)

    @torch.no_grad()
    def admit(self, state: dict, slot: int, pid: int, *,
              fresh: dict = None) -> dict:
        """Admit profile ``pid`` into ``slot``: its fresh row (``fresh``,
        else ``self.fresh(pid)``), zeroed moments, Adam step and EMAs,
        written in place. Returns ``state``."""
        loc, i = self._own(state, slot)
        if loc is None:
            return state
        row = self.fresh(pid) if fresh is None else fresh
        tree_map(lambda t, r: t[i].copy_(torch.as_tensor(r)),
                 loc["trainable"], row)
        for t in tree_leaves(loc["opt"]["m"]) + \
                tree_leaves(loc["opt"]["v"]):
            t[i].zero_()
        loc["opt"]["step"][i] = 0
        loc["active"][i] = True
        for key in ("slot_step", "ema_loss", "ema_acc", "ema_count",
                    "nonfinite"):
            loc[key][i] = 0
        return state

    @torch.no_grad()
    def evict(self, state: dict, slot: int) -> dict:
        """Deactivate ``slot``; parked rows stay in place until
        re-admission. Returns ``state``."""
        loc, i = self._own(state, slot)
        if loc is not None:
            loc["active"][i] = False
        return state

    # ------------------------------------------------------------ host views
    def metrics(self, state: dict, ema_decay: float) -> Dict[str, np.ndarray]:
        """ONE device -> host transfer of the convergence signals (the six
        [S] vectors stacked as fp32, exact for these counts). EMAs are
        debiased by their update count (an EMA starts at 0 on
        admission). On a mesh the [6, S / n] blocks are gathered first."""
        act = state["active"]
        host = torch.stack([SH.local(state[k]).float()
                            for k in _METRIC_KEYS])
        if isinstance(act, SH.Sharded):
            host = SH.gather(host, SH.P(None, act.spec[0]), act.mesh)
        host = host.cpu().numpy()
        v = dict(zip(_METRIC_KEYS, host))
        cnt = v["ema_count"].astype(np.int32)
        debias = 1.0 - np.power(ema_decay, np.maximum(cnt, 1))
        return {"active": v["active"].astype(bool),
                "slot_step": v["slot_step"].astype(np.int32),
                "ema_loss": v["ema_loss"] / debias,
                "ema_acc": v["ema_acc"] / debias,
                "ema_count": cnt,
                "nonfinite": v["nonfinite"].astype(np.int32)}

    def slot_params(self, state: dict, slot: int) -> dict:
        """Host copy of one slot's trainables in ONE transfer, flattened to
        the record ``ProfileStore.add_profile`` takes (mA/mB/ln_* [+
        head_w/head_b]). On a mesh the rank holding the slot broadcasts
        the row over "data" first."""
        row = state["trainable"]
        leaves = dict(row["table"])
        if "heads" in row:
            leaves.update(row["heads"])
        keys = sorted(leaves)
        shapes = [tuple(leaves[k].shape[1:]) for k in keys]
        sizes = [int(np.prod(sh)) for sh in shapes]
        loc, i = self._own(state, slot)
        if loc is not None:
            vec = torch.cat([SH.local(leaves[k])[i].reshape(-1).float()
                             for k in keys])
        else:
            vec = torch.empty(sum(sizes), dtype=torch.float32,
                              device=SH.local(state["active"]).device)
        act = state["active"]
        if isinstance(act, SH.Sharded):
            group = act.mesh.get_group(act.spec[0])
            owner = slot // SH.local(act).shape[0]
            dist.broadcast(vec, src=dist.get_global_rank(group, owner),
                           group=group)
        host = vec.cpu()
        return {k: part.reshape(sh).numpy()
                for k, sh, part in zip(keys, shapes,
                                       torch.split(host, sizes))}
