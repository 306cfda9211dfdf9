"""Profile onboarding (the port of ``repro.train.onboarding``): stream
P >> S profiles through the training roster and graduate converged ones
into the serving ``ProfileStore``.

- ``train/roster.py``      the device-resident slot bank
- ``RosterBatcher``        deterministic per-slot batch assembly from any
                           profile-conditioned data source
- ``OnboardingScheduler``  host-side lifecycle: pending queue, slot ->
                           profile assignment, convergence polling at sync
                           cadence, graduation (binarize masks -> byte-level
                           store record), eviction and quarantine
- ``OnboardingTrainer``    a Trainer driving the gang step; all lifecycle
                           work happens in ``on_sync``, so the hot loop
                           never blocks on the host

Graduation closes the train -> serve loop: the record is written through
``ProfileStore.add_profile`` (the binarize/pack path serving admission
hydrates from), so a graduated profile is immediately admittable by
``ServeEngine`` with bit-identical k-sparse masks, and an engine serving
from the same store drops its cached aggregate of a re-graduated profile
(the store's change notification).

On a mesh (``build_onboarding_run(mesh=)``) the roster's slots go over
"data" (each rank trains its slots), the frozen PLM is whole on every
rank, and the store is held identically on every rank (every rank
graduates the same broadcast rows) and written by the mesh's rank 0.
"""
from __future__ import annotations

import os
from collections import deque
from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch

from repro_torch import obs as OBS
from repro_torch.core import xpeft as XP
from repro_torch.core.profiles import ProfileStore
from repro_torch.obs import trace as TR
from repro_torch.train.roster import Roster
from repro_torch.train.trainer import Trainer


@dataclass
class GraduationPolicy:
    """When a slot's occupant is done training.

    A slot graduates once it has trained ``min_steps`` AND its debiased EMA
    crosses a target (``target_loss`` and/or ``target_acc``; either
    suffices). At ``max_steps`` an unconverged profile is force-graduated,
    or evicted (dropped, recorded) when ``evict_at_max`` is set. A profile
    whose slot took ``max_poison_strikes`` non-finite gang steps is
    quarantined: evicted without graduating.
    """
    min_steps: int = 30
    max_steps: int = 300
    ema_decay: float = 0.9
    target_loss: Optional[float] = None
    target_acc: Optional[float] = None
    evict_at_max: bool = False
    max_poison_strikes: int = 3


class RosterBatcher:
    """Assembles [S, m, ...] gang batches: row s carries slot s's profile.

    Each slot's rows are sampled with that slot's profile id; free slots get
    a placeholder id (their loss and grads are masked by the roster's
    ``active`` mask, and their rows occupy fixed example indices, so
    occupied slots' data streams are independent of admission activity
    elsewhere).
    """

    def __init__(self, source, capacity: int, per_slot: int, seq_len: int):
        self.source = source
        self.S = capacity
        self.m = per_slot
        self.seq_len = seq_len
        self.step = 0
        self.slot_pids: List[Optional[int]] = [None] * capacity

    def next(self) -> dict:
        pids = np.repeat([0 if p is None else int(p)
                          for p in self.slot_pids], self.m)
        b = self.source.sample(self.step, self.S * self.m, self.seq_len,
                               profile_ids=pids)
        self.step += 1
        return {k: np.asarray(v).reshape((self.S, self.m) + v.shape[1:])
                for k, v in b.items()}

    # -- checkpointable position ------------------------------------------
    def state_dict(self) -> dict:
        return {"step": self.step}

    def load_state_dict(self, s: dict) -> None:
        self.step = int(s["step"])


class OnboardingScheduler:
    """Host-side lifecycle over (roster state, store): admit pending
    profiles into free slots, poll convergence at sync cadence, graduate,
    evict or quarantine. Touches the device only through ``Roster``'s
    in-place writes, the single ``metrics()`` fetch per poll and one
    ``slot_params`` fetch per graduation."""

    def __init__(self, roster: Roster, store: ProfileStore,
                 policy: GraduationPolicy, pending_profiles, *,
                 bank=None, xp=None):
        self.roster = roster
        self.store = store
        self.policy = policy
        self.pending = deque(int(p) for p in pending_profiles)
        self.slot_pid: List[Optional[int]] = [None] * roster.capacity
        self.graduated: List[dict] = []
        self.evicted: List[dict] = []
        self.quarantined: List[dict] = []
        self.admission_waves = 0
        # quantized stores: graduation also freezes the profile's
        # aggregated Â/B̂ (its masks x the frozen bf16/fp32 bank, computed
        # here; training never quantizes) so serving admits it with zero
        # bank reads. `bank` is the frozen params' "xpeft_bank", `xp` the
        # XPeftConfig.
        self.bank = bank
        self.xp = xp
        # the OnboardingTrainer sets its own bundle here, so the scheduler
        # and the trainer share one tracer
        self.obs = OBS.NULL_OBS
        if store.quant != "none" and (bank is None or xp is None):
            raise ValueError("a quantized store needs the frozen bank and "
                             "XPeftConfig to aggregate Â/B̂ at graduation "
                             "(pass bank=/xp= or use build_onboarding_run)")

    # ------------------------------------------------------------ lifecycle
    def fill(self, rstate: dict, batcher: RosterBatcher) -> dict:
        """Admit pending profiles into every free slot (one wave)."""
        admitted = False
        for slot in range(self.roster.capacity):
            if self.slot_pid[slot] is None and self.pending:
                pid = self.pending.popleft()
                rstate = self.roster.admit(rstate, slot, pid)
                self.slot_pid[slot] = pid
                batcher.slot_pids[slot] = pid
                admitted = True
        if admitted:
            self.admission_waves += 1
        return rstate

    def poll(self, rstate: dict, batcher: RosterBatcher) -> dict:
        """Sync-cadence pass: ONE device fetch, then graduate / evict /
        quarantine, and refill."""
        met = self.roster.metrics(rstate, self.policy.ema_decay)
        pol = self.policy
        for slot, pid in enumerate(self.slot_pid):
            if pid is None:
                continue
            # the strike check FIRST: a poisoned slot's slot_step freezes
            # (the finite guard skips its updates), so it would otherwise
            # sit below min_steps forever, pinning the slot
            if int(met["nonfinite"][slot]) >= pol.max_poison_strikes:
                rstate = self.quarantine(rstate, slot, met)
                batcher.slot_pids[slot] = None
                continue
            steps = int(met["slot_step"][slot])
            if steps < pol.min_steps:
                continue
            converged = (
                (pol.target_loss is not None
                 and met["ema_loss"][slot] <= pol.target_loss) or
                (pol.target_acc is not None
                 and met["ema_acc"][slot] >= pol.target_acc))
            if converged or steps >= pol.max_steps:
                if converged or not pol.evict_at_max:
                    rstate = self.graduate(rstate, slot, met)
                else:
                    rstate = self.evict(rstate, slot, met)
                batcher.slot_pids[slot] = None
        return self.fill(rstate, batcher)

    def _record(self, slot: int, met: dict) -> dict:
        return {"pid": int(self.slot_pid[slot]), "slot": int(slot),
                "steps": int(met["slot_step"][slot]),
                "ema_loss": round(float(met["ema_loss"][slot]), 6),
                "ema_acc": round(float(met["ema_acc"][slot]), 6)}

    def graduate(self, rstate: dict, slot: int, met: dict) -> dict:
        """Freeze the slot's trained row into the serving store (binarized,
        byte-level) and free the slot. A quantized store also gets the
        profile's aggregated Â/B̂, quantized on write; a heterogeneous
        bank graduates its masks only (the aggregated record is the
        bottleneck pair, which has no single-tensor analogue across mixed
        families)."""
        pid = self.slot_pid[slot]
        prof = self.roster.slot_params(rstate, slot)
        agg = None
        if self.store.quant != "none" and not self.xp.is_hetero:
            dev = self.bank["bank_a"].device
            eff = XP.precompute_effective_adapters(
                self.bank, {k: torch.from_numpy(v).to(dev)
                            for k, v in prof.items()}, self.xp)
            agg = (eff["a_hat"], eff["b_hat"])
        self.store.add_profile(pid, prof, agg=agg)
        rec = self._record(slot, met)
        self.graduated.append(rec)
        self.obs.tracer.instant(TR.CAT_GRADUATION, "graduate",
                                profile=int(pid), slot=int(slot),
                                steps=rec["steps"])
        self.obs.metrics.inc("train.graduated")
        rstate = self.roster.evict(rstate, slot)
        self.slot_pid[slot] = None
        return rstate

    def evict(self, rstate: dict, slot: int, met: dict) -> dict:
        """Drop an unconverged occupant without graduating it."""
        rec = self._record(slot, met)
        self.evicted.append(rec)
        self.obs.tracer.instant(TR.CAT_GRADUATION, "evict",
                                profile=rec["pid"], slot=int(slot),
                                steps=rec["steps"])
        self.obs.metrics.inc("train.evicted")
        rstate = self.roster.evict(rstate, slot)
        self.slot_pid[slot] = None
        return rstate

    def quarantine(self, rstate: dict, slot: int, met: dict) -> dict:
        """Drop a repeatedly poisoned occupant: its slot took
        ``max_poison_strikes`` non-finite gang steps. Nothing of the
        profile reaches the store, and the freed slot is refilled like any
        other."""
        rec = self._record(slot, met)
        rec["nonfinite"] = int(met["nonfinite"][slot])
        self.quarantined.append(rec)
        self.obs.tracer.instant(TR.CAT_RESILIENCE, "quarantine",
                                profile=rec["pid"], slot=int(slot),
                                nonfinite=rec["nonfinite"])
        self.obs.metrics.inc("train.quarantined")
        rstate = self.roster.evict(rstate, slot)
        self.slot_pid[slot] = None
        return rstate

    def finished(self) -> bool:
        return not self.pending and all(p is None for p in self.slot_pid)

    def stats(self) -> dict:
        return {"pending": len(self.pending),
                "in_training": sum(p is not None for p in self.slot_pid),
                "graduated": len(self.graduated),
                "evicted": len(self.evicted),
                "quarantined": len(self.quarantined),
                "admission_waves": self.admission_waves}

    # -------------------------------------------------------------- persist
    def state_dict(self) -> dict:
        return {"pending": [int(p) for p in self.pending],
                "slot_pid": [None if p is None else int(p)
                             for p in self.slot_pid],
                "graduated": list(self.graduated),
                "evicted": list(self.evicted),
                "quarantined": list(self.quarantined),
                "admission_waves": int(self.admission_waves)}

    def load_state_dict(self, s: dict) -> None:
        self.pending = deque(int(p) for p in s["pending"])
        self.slot_pid = [None if p is None else int(p)
                         for p in s["slot_pid"]]
        self.graduated = list(s["graduated"])
        self.evicted = list(s["evicted"])
        self.quarantined = list(s.get("quarantined", []))
        self.admission_waves = int(s["admission_waves"])


class OnboardingTrainer(Trainer):
    """Drives the gang step; the lifecycle runs ONLY at host-sync
    boundaries.

    The state is {"frozen": ..., "roster": ...}; ``loader`` is a
    RosterBatcher. The scheduler's host state (pending queue, slot ->
    profile assignment) rides in the checkpoint manifest, the roster's
    device state in the checkpoint arrays, and graduated profiles in the
    store file at ``store_path``, so a resume restarts mid-onboarding
    without re-training anything already graduated.
    """

    def __init__(self, step_fn, state, batcher: RosterBatcher,
                 scheduler: OnboardingScheduler, *,
                 store_path: Optional[str] = None, **kw):
        super().__init__(step_fn, state, batcher, **kw)
        self.scheduler = scheduler
        self.scheduler.obs = self.obs  # one bundle across trainer+lifecycle
        self.store_path = store_path
        self.state["roster"] = scheduler.fill(self.state["roster"],
                                              self.loader)

    # ----------------------------------------------------------------- hooks
    def on_sync(self, recs: list) -> None:
        n_grad = len(self.scheduler.graduated)
        self.state["roster"] = self.scheduler.poll(self.state["roster"],
                                                   self.loader)
        # the poll's EMA fetch and each graduation's slot-row fetch are
        # device -> host transfers too: count them, so syncs/step reports
        # the subsystem's TOTAL host traffic
        self.host_syncs += 1 + (len(self.scheduler.graduated) - n_grad)

    def should_stop(self) -> bool:
        return self.scheduler.finished()

    # --------------------------------------------------------------- persist
    def extra_state(self) -> dict:
        extra = super().extra_state()
        extra["onboarding"] = self.scheduler.state_dict()
        return extra

    def restore_extra(self, extra: dict) -> None:
        super().restore_extra(extra)
        if "onboarding" in extra:
            self.scheduler.load_state_dict(extra["onboarding"])
            for slot in range(self.loader.S):
                self.loader.slot_pids[slot] = self.scheduler.slot_pid[slot]
        if self.store_path and os.path.exists(self.store_path):
            self.scheduler.store.merge_from(ProfileStore.load(self.store_path))

    def checkpoint(self, blocking=True):
        if self.mgr and self.store_path and self.lead:
            self.scheduler.store.save(self.store_path)
        super().checkpoint(blocking=blocking)

    def run_until_drained(self, max_steps: int = 100_000) -> list:
        """Train until every pending profile has graduated (or been
        evicted or quarantined); ``max_steps`` is the runaway backstop."""
        return self.run(max_steps)


def build_onboarding_run(cfg, source, pending, *, slots: int = 4,
                         per_slot: int = 4, seq_len: int = 16,
                         policy: Optional[GraduationPolicy] = None,
                         lr: float = 1e-3, ema_decay: float = 0.9,
                         seed: int = 0, frozen=None, store=None,
                         mesh=None, fault_plan=None, device=None,
                         **trainer_kw):
    """Wire the whole lifecycle stack (frozen PLM, roster, gang step,
    batcher, store, scheduler, trainer), the one assembly the launcher and
    ``chip_smoke.py`` share. Returns (trainer, gang_step_fn); reach the
    pieces via ``trainer.scheduler`` (store, roster) and ``trainer.state``
    (frozen, roster state).

    From ``seed``: the frozen PLM (``init_lm(seed=seed)``, unless
    ``frozen`` is given), the initial roster rows (``seed + 3``), each
    profile's fresh row (base seed ``seed + 2``) and the Gumbel generator
    (``seed + 1``, unless ``rng`` is given). Pass an existing ``store`` to
    graduate into it, the re-training flow: profiles already being served
    re-graduate in place, and every ServeEngine holding that store drops
    their cached aggregates. ``device``: the card unless "cpu".

    A ``mesh`` shards the gang step: the roster's slot axis (and each
    step's [S, m, ...] batch rows) over "data" while the frozen PLM stays
    whole on every rank, so per-slot training is rank-local and the
    graduated store is bit-identical to a one-device run."""
    from repro_torch.models import init_lm
    from repro_torch.train.roster import init_roster_state
    from repro_torch.train.steps import make_gang_step
    from repro_torch.utils import resolve_device

    device = resolve_device(device)
    if frozen is None:
        frozen = init_lm(cfg, seed=seed, device=device)
    roster = Roster(cfg, seed + 2, slots, device=device, mesh=mesh)
    rstate = roster.place(init_roster_state(cfg, slots, seed=seed + 3,
                                            device=device))
    state = {"frozen": frozen, "roster": rstate}
    # the step's EMA decay and the policy's debias decay must agree
    policy = policy or GraduationPolicy(ema_decay=ema_decay)
    # one FaultPlan governs the whole run: gradient poisoning here,
    # checkpoint truncation through the trainer's CheckpointManager
    gang = make_gang_step(cfg, lr=lr, ema_decay=policy.ema_decay,
                          mesh=mesh, fault_plan=fault_plan)
    batcher = RosterBatcher(source, slots, per_slot, seq_len)
    xp = cfg.xpeft
    if store is None:
        store = ProfileStore(cfg.num_layers, xp.num_adapters, xp.bottleneck,
                             xp.mask_type, xp.k, quant=xp.bank_quant,
                             quant_group=xp.quant_group,
                             bank_spec=xp.bank_spec)
    quant = store.quant != "none"
    scheduler = OnboardingScheduler(
        roster, store, policy, pending,
        bank=frozen["xpeft_bank"] if quant else None,
        xp=xp if quant else None)
    trainer_kw.setdefault(
        "rng", torch.Generator(device=device).manual_seed(seed + 1))
    if fault_plan is not None:
        trainer_kw.setdefault("fault_plan", fault_plan)
    trainer = OnboardingTrainer(gang, state, batcher, scheduler, mesh=mesh,
                                **trainer_kw)
    return trainer, gang
