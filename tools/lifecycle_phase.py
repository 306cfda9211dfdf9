"""``chip_smoke.py``'s phase 11 (the profile lifecycle) on the card; run
alone:

    python3 tools/lifecycle_phase.py

Builds the kernels, turns TF32 off as ``chip_smoke.py`` does and runs
``phase_lifecycle`` on qwen1.5-0.5b at full depth and width (24 layers,
d=1024, bank N=256, b=64, k=50; ``chip_smoke.py`` runs it on CUT_LAYERS
of them), bf16, random weights from seed 0, on ``MarkovLM`` over 8
profiles:

(a) onboarding through ``build_onboarding_run``: 4 roster slots, 4
    examples per slot, T=32, lr 1e-3, ``GraduationPolicy(min_steps=10,
    max_steps=20)``, ``log_every=5``, a ``FaultPlan`` poisoning slot 3
    from its first step. Every profile slot 3 holds is quarantined (its
    slot_step freezes, 3 strikes at the first poll), every other one
    graduates at max_steps: the graduated, quarantined and evicted sets
    must equal those of the same plan and policy on the CPU at 2 layers
    (reduced widths), with at least 4 graduated. No roster tensor changes
    its storage, shape or dtype across waves; host syncs per step < 1; no
    index_add / scatter_add kernel in the gang step. Measured: ms per gang
    step (CUDA events around each step, median after the first wave's
    first 3), host wall ms per step, device ms and kernels per step and
    the busy share (profiler, card only, 3 steps), peak memory,
    graduation ms per profile, the scheduler's stats, the trace's spans
    and counters.
(b) the same run checkpointed (``ckpt_every=10``, ``keep_last=2``, the
    store file set): preempted at step 15, resumed by a fresh trainer
    (``try_resume``), which finishes with its step-40 checkpoint truncated
    by the plan; a third trainer resumes past the torn checkpoint (it
    falls back to step 30). Both resumed runs' store files byte-equal to
    (a)'s, their roster tensors bitwise (a)'s. Save ms (the blocking host
    copy, the background write), restore ms, checkpoint bytes.
(c) one gang step on the card against the CPU (2 layers, float32, TF32
    off, the same weights, batch, fresh rows and Gumbel draws; slots 0
    and 1 training, 2 parked, 3 poisoned) under phase 7's bounds: k-hot
    bitwise, each slot's loss within TRAIN_LOSS_RTOL, gradients and the
    new roster params within TRAIN_GRAD_REL_L2 relative L2, the parked
    and poisoned rows' params and moments bitwise unchanged.
(d) (a)'s graduated store, loaded from disk, served by the windowed
    composed engine (8 requests over the graduated profiles, 16 new
    tokens, 4 slots) through #1 (twice per aggregating wave) and #2 (once
    per layer a decode step and prefill batch), held to its
    ``kernel_impl="ref"`` run under phase 4's ``e2e_check`` bounds.

Every failed check raises. Prints one JSON line of its numbers last.
Without a card it exits non-zero.
"""
import json
import os
import shutil
import statistics
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if HERE not in sys.path:
    sys.path.insert(0, HERE)

import chip_smoke as cs  # noqa: E402

PROFILES, SLOTS, PER_SLOT, SEQ, LR = 8, 4, 4, 32, 1e-3
MIN_STEPS, MAX_STEPS, LOG_EVERY = 10, 20, 5
POISON_SLOTS = (3,)
CKPT_EVERY, KEEP_LAST, PREEMPT_AT, TORN_AT = 10, 2, 15, 40
# kernel names the gang step's backward must not run: an index gather's
# backward scatter-adds with float atomics, which is not deterministic
SCATTER_KERNELS = ("index_add", "scatter_add", "ReduceAdd", "index_put",
                   "indexFunc")


def _storage(rstate):
    from repro_torch.utils.tree import tree_paths
    return {p: (t.data_ptr(), tuple(t.shape), t.dtype)
            for p, t in tree_paths(rstate).items()}


def _records(sched):
    keys = ("pid", "slot", "steps", "nonfinite")
    return {name: [{k: r[k] for k in keys if k in r}
                   for r in getattr(sched, name)]
            for name in ("graduated", "quarantined", "evicted")}


def build(cfg, device, frozen=None, plan_kw=None, **kw):
    """The phase's onboarding run: (trainer, gang step)."""
    from repro_torch.data import MarkovLM
    from repro_torch.resilience import FaultPlan
    from repro_torch.train import GraduationPolicy
    from repro_torch.train.onboarding import build_onboarding_run

    return build_onboarding_run(
        cfg, MarkovLM(cfg.vocab_size, PROFILES, seed=0), range(PROFILES),
        slots=SLOTS, per_slot=PER_SLOT, seq_len=SEQ,
        policy=GraduationPolicy(min_steps=MIN_STEPS, max_steps=MAX_STEPS),
        lr=LR, seed=0, frozen=frozen, device=device, log_every=LOG_EVERY,
        fault_plan=FaultPlan(poison_slots=POISON_SLOTS, **(plan_kw or {})),
        **kw)


def expected_sets():
    """The lifecycle's records for the same plan and policy on the CPU, 2
    layers at reduced widths: they follow from the scheduler's rules
    alone (no target loss)."""
    from repro_torch.configs import get_config, reduce_for_smoke

    cfg = reduce_for_smoke(get_config("qwen1.5-0.5b"))
    trainer, _ = build(cfg, "cpu")
    trainer.run_until_drained(max_steps=500)
    return _records(trainer.scheduler), trainer.step


# ----------------------------------------------------------------------------
# (a) onboarding
# ----------------------------------------------------------------------------

def onboard(torch, cfg, frozen, device="cuda"):
    from repro_torch import obs as OBS
    from repro_torch.utils.tree import tree_map

    want, cpu_steps = expected_sets()
    bundle = OBS.Observability()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    trainer, gang = build(cfg, device, frozen=frozen, obs=bundle)
    sched = trainer.scheduler
    storage = _storage(trainer.state["roster"])
    events, grads_ms, polls = [], [], [0]

    def timed(state, batch, rng):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        out = gang(state, batch, rng)
        b.record()
        events.append((a, b))
        return out
    trainer.step_fn = timed
    on_sync = trainer.on_sync

    def checked_sync(recs):
        on_sync(recs)
        polls[0] += 1
        assert _storage(trainer.state["roster"]) == storage, \
            "a roster tensor was reallocated across a wave"
    trainer.on_sync = checked_sync
    graduate = sched.graduate

    def timed_graduate(rstate, slot, met):
        t = time.perf_counter()
        out = graduate(rstate, slot, met)
        grads_ms.append((time.perf_counter() - t) * 1e3)
        return out
    sched.graduate = timed_graduate
    t0 = time.perf_counter()
    trainer.run_until_drained(max_steps=500)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() - held
    steps = trainer.step
    ev = [a.elapsed_time(b) for a, b in events]
    # the first wave's first 3 steps carry first-call costs
    ms = statistics.median(ev[3:])
    got = _records(sched)
    st = sched.stats()
    syncs = trainer.host_syncs / steps
    cs.log(f"lifecycle (a): {cfg.name} L={cfg.num_layers} d={cfg.d_model} "
           f"V={cfg.vocab_size} {cfg.dtype}, N={cfg.xpeft.num_adapters} "
           f"b={cfg.xpeft.bottleneck} k={cfg.xpeft.k}; {PROFILES} profiles "
           f"through {SLOTS} slots x {PER_SLOT} examples, T={SEQ}, slot "
           f"{POISON_SLOTS} poisoned: {steps} gang steps in {wall_s:.2f}s "
           f"(init and first-call costs included); stats {st}")
    cs.log(f"  graduated {[r['pid'] for r in got['graduated']]}, "
           f"quarantined {[r['pid'] for r in got['quarantined']]}, evicted "
           f"{[r['pid'] for r in got['evicted']]}; the CPU run at 2 layers "
           f"({cpu_steps} steps): equal {got == want}")
    cs.log(f"  ms/gang step (CUDA events) median {ms:.3f} (all: "
           + " ".join(f"{v:.1f}" for v in ev) + f"); host wall "
           f"{wall_s / steps * 1e3:.3f} ms/step; host syncs "
           f"{trainer.host_syncs} = {syncs:.3f}/step; peak memory {peak / 2**30:.3f} GiB above "
           f"{held / 2**30:.3f} GiB held; graduation ms/profile "
           + " ".join(f"{v:.2f}" for v in grads_ms))
    assert got == want, (got, want)
    assert st["graduated"] >= 4 and st["pending"] == 0 \
        and st["in_training"] == 0, st
    assert steps == cpu_steps
    assert syncs < 1, syncs
    assert polls[0] > 0
    counters = bundle.metrics.snapshot()["counters"]
    spans = bundle.tracer.category_counts()
    assert counters["train.graduated"] == st["graduated"]
    assert counters["train.quarantined"] == st["quarantined"]
    assert counters["train.steps"] == steps
    assert _trace_valid(bundle) is None
    # 3 more gang steps with 4 fresh profiles admitted, under the profiler
    roster = tree_map(lambda t: t.clone(), trainer.state["roster"])
    for slot in range(SLOTS):
        sched.roster.admit(roster, slot, slot)
    state = {"frozen": trainer.state["frozen"], "roster": roster}
    batches = [trainer.loader.next() for _ in range(3)]
    gen = torch.Generator(device=device).manual_seed(5)
    prof = profile_gang(torch, gang, state, batches, gen)
    dev_ms, n_kernels = prof["device_ms"], prof["kernels"]
    cs.log(f"  profiled gang steps (4 slots active): device {dev_ms:.3f} "
           f"ms/step in {n_kernels:.0f} kernels/step, host wall "
           f"{prof['wall_ms']:.3f} ms/step under the profiler -> busy "
           f"share {dev_ms / (wall_s / steps * 1e3):.4f} of the run's "
           f"wall; scatter/index-add kernels {prof['scatter_kernels']}")
    out = dict(steps=steps, wall_s=wall_s, ms_per_step=ms,
               ms_per_step_all=ev, host_wall_ms_per_step=wall_s / steps * 1e3,
               host_syncs=trainer.host_syncs, host_syncs_per_step=syncs,
               peak_memory_bytes=peak, memory_held_before_bytes=held,
               graduation_ms=grads_ms, stats=st, records=got,
               cpu_records_equal=got == want, device_ms_per_step=dev_ms,
               kernels_per_step=n_kernels,
               busy_share=dev_ms / (wall_s / steps * 1e3),
               profiled_wall_ms_per_step=prof["wall_ms"],
               obs_counters=counters, obs_spans=spans,
               scatter_kernels=prof["scatter_kernels"])
    return trainer, out


def profile_gang(torch, gang, state, batches, gen):
    """One warm step, then ``batches`` through the gang step under
    torch.profiler tracing the card only: device ms and kernels per step,
    and no scatter-add / index-add kernel (the kernel list goes to
    ``chiprun_out/gang_step_kernels.txt``)."""
    n = len(batches)
    state, _ = gang(state, batches[0], gen)
    torch.cuda.synchronize()
    box = dict(state=state)

    def steps():
        box["t"] = time.perf_counter()
        for b in batches:
            box["state"], box["met"] = gang(box["state"], b, gen)
        torch.cuda.synchronize()
        box["wall"] = (time.perf_counter() - box["t"]) / n * 1e3

    rows = sorted(cs.trace_card(torch, steps, "phase 11 gang step"),
                  key=lambda e: -e.self_device_time_total)
    wall, met = box["wall"], box["met"]
    dev_ms = sum(e.self_device_time_total for e in rows) / 1e3 / n
    n_kernels = sum(e.count for e in rows) / n
    bad = sorted({e.key for e in rows
                  if any(s in e.key for s in SCATTER_KERNELS)})
    os.makedirs(os.path.join(HERE, "chiprun_out"), exist_ok=True)
    with open(os.path.join(HERE, "chiprun_out", "gang_step_kernels.txt"),
              "w") as f:
        for e in rows:
            f.write(f"{e.self_device_time_total / 1e3 / n:.4f} ms/step "
                    f"{e.count / n:5.0f}/step  {e.key}\n")
    for e in rows[:6]:
        cs.log(f"  {e.self_device_time_total / 1e3 / n:.4f} ms/step "
               f"{e.count / n:5.0f}/step  {e.key[:72]}")
    assert dev_ms > 0 and not bad, bad
    assert torch.isfinite(torch.stack([met["loss"], met["grad_norm"]])).all()
    return dict(device_ms=dev_ms, kernels=n_kernels, wall_ms=wall,
                scatter_kernels=bad)


def _trace_valid(bundle):
    from repro_torch import obs as OBS
    return OBS.validate_chrome_trace({"traceEvents": bundle.tracer.events()})


# ----------------------------------------------------------------------------
# (b) checkpoint and resume
# ----------------------------------------------------------------------------

def _ckpt_timers(trainer, log):
    """Time the manager's blocking save (the host copy) and its writes."""
    mgr = trainer.mgr
    save, write = mgr.save, mgr._write

    def timed_save(step, state, **kw):
        t = time.perf_counter()
        save(step, state, **kw)
        log.append(("save", step, kw.get("blocking", True),
                    (time.perf_counter() - t) * 1e3))

    def timed_write(step, host_flat, meta):
        t = time.perf_counter()
        write(step, host_flat, meta)
        log.append(("write", step, None, (time.perf_counter() - t) * 1e3))
    mgr.save, mgr._write = timed_save, timed_write


def resume(torch, cfg, frozen, ref, device="cuda"):
    from repro_torch.core.profiles import ProfileStore
    from repro_torch.distributed.fault import PreemptionHandler
    from repro_torch.utils.tree import tree_paths

    tmp = tempfile.mkdtemp(prefix="lifecycle_")
    ck, sp = os.path.join(tmp, "ck"), os.path.join(tmp, "store.npz")
    ref_path = os.path.join(tmp, "uninterrupted.npz")
    ref.scheduler.store.save(ref_path)
    ref_bytes = open(ref_path, "rb").read()
    ref_roster = tree_paths(ref.state["roster"])
    log, restores, out = [], [], {}

    def make(plan_kw=None):
        pre = PreemptionHandler(sigs=())  # no signal handler: trigger()
        t, gang = build(cfg, device, frozen=frozen, plan_kw=plan_kw,
                        ckpt_dir=ck, ckpt_every=CKPT_EVERY,
                        keep_last=KEEP_LAST, store_path=sp, preemption=pre)
        _ckpt_timers(t, log)
        return t, gang, pre

    def finish(t, label):
        path = os.path.join(tmp, f"{label}.npz")
        t.scheduler.store.save(path)
        same_file = open(path, "rb").read() == ref_bytes
        same_roster = all(torch.equal(a, ref_roster[p]) for p, a in
                          tree_paths(t.state["roster"]).items())
        cs.log(f"  {label}: ended at step {t.step}, store file byte-equal "
               f"to the uninterrupted run's {same_file}, roster bitwise "
               f"{same_roster}; stats {t.scheduler.stats()}")
        assert same_file and same_roster and t.step == ref.step
        assert ProfileStore.load(path).profile_ids() == \
            ref.scheduler.store.profile_ids()
        return dict(step=t.step, store_byte_equal=same_file,
                    roster_bitwise=same_roster)

    def restored(t):
        torch.cuda.synchronize()
        s = time.perf_counter()
        ok = t.try_resume()
        torch.cuda.synchronize()
        restores.append((time.perf_counter() - s) * 1e3)
        assert ok
        return t.step

    # preempted at PREEMPT_AT
    t1, gang1, pre = make()

    def preempting(state, batch, rng):
        res = gang1(state, batch, rng)
        if t1.step + 1 == PREEMPT_AT:
            pre.trigger()
        return res
    t1.step_fn = preempting
    t1.run_until_drained(max_steps=500)
    t1.mgr.wait()
    assert t1.step == PREEMPT_AT and t1.mgr.all_steps() == [CKPT_EVERY,
                                                           PREEMPT_AT]
    nbytes = t1.mgr.manifest(PREEMPT_AT)["state_nbytes"]
    # resumed; its last checkpoint (TORN_AT) torn by the plan
    t2, _, _ = make(plan_kw=dict(truncate_ckpt_steps=(TORN_AT,)))
    out["resumed_at"] = restored(t2)
    assert out["resumed_at"] == PREEMPT_AT
    t2.run_until_drained(max_steps=500)
    out["resumed"] = finish(t2, "resumed")
    steps_on_disk = t2.mgr.all_steps()
    assert t2.mgr.latest_good_step() == steps_on_disk[-2], steps_on_disk
    # past the torn checkpoint: falls back one
    t3, _, _ = make()
    out["fallback_at"] = restored(t3)
    assert out["fallback_at"] == steps_on_disk[-2] < TORN_AT
    t3.run_until_drained(max_steps=500)
    out["fallback"] = finish(t3, "after the torn checkpoint")
    shutil.rmtree(tmp, ignore_errors=True)
    copies = [ms for kind, _, blocking, ms in log
              if kind == "save" and blocking is False]
    writes = [ms for kind, _, _, ms in log if kind == "write"]
    blocking = [ms for kind, _, b, ms in log if kind == "save" and b]
    cs.log(f"lifecycle (b): checkpoints of {nbytes} B ({nbytes / 2**30:.3f} "
           f"GiB, the frozen PLM and bank included); async save's blocking "
           f"host copy ms " + " ".join(f"{v:.0f}" for v in copies)
           + "; background writes ms " + " ".join(f"{v:.0f}" for v in writes)
           + "; the preemption's blocking save ms "
           + " ".join(f"{v:.0f}" for v in blocking)
           + "; restore ms " + " ".join(f"{v:.0f}" for v in restores))
    out.update(checkpoint_bytes=nbytes, save_host_copy_ms=copies,
               write_ms=writes, blocking_save_ms=blocking,
               restore_ms=restores)
    return out


# ----------------------------------------------------------------------------
# (c) one gang step, card against CPU
# ----------------------------------------------------------------------------

def step_vs_cpu(torch, cfg=None, device="cuda"):
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.core import masks as M
    from repro_torch.core import xpeft as XP
    from repro_torch.data import MarkovLM
    from repro_torch.models import init_lm
    from repro_torch.resilience import FaultPlan
    from repro_torch.train import steps as ST
    from repro_torch.train.roster import Roster, init_roster_state
    from repro_torch.train.steps import _rows_per_example
    from repro_torch.utils.tree import tree_map, tree_paths

    cfg = cfg or get_config("qwen1.5-0.5b").with_(num_layers=2,
                                                  dtype="float32")
    xp = cfg.xpeft
    frozen = init_lm(cfg, seed=0, device=device)
    rstate = init_roster_state(cfg, SLOTS, seed=3, device=device)
    roster = Roster(cfg, 2, SLOTS, device=device)
    pids = [0, 1, None, 2]     # slot 2 parked, slot 3 poisoned
    for slot, pid in enumerate(pids):
        if pid is not None:
            roster.admit(rstate, slot, pid)
    batch = MarkovLM(cfg.vocab_size, PROFILES, seed=0).sample(
        0, SLOTS * PER_SLOT, SEQ,
        profile_ids=np.repeat([p or 0 for p in pids], PER_SLOT))
    batch = {k: torch.from_numpy(np.asarray(v).reshape(
        (SLOTS, PER_SLOT) + v.shape[1:])) for k, v in batch.items()}
    gen = torch.Generator(device=device).manual_seed(1)
    shape = (SLOTS * PER_SLOT, cfg.num_layers, xp.num_adapters)
    noise = tuple(M.gumbel(shape, generator=gen, device=device)
                  for _ in range(2))
    plan = FaultPlan(poison_slots=POISON_SLOTS)
    runs = {}
    for name, dev in (("card", device), ("cpu", "cpu")):
        fz = cs._tree_to(frozen, dev)
        rs = tree_map(lambda t: t.to(dev).clone(), rstate)
        tb = {k: v.to(dev) for k, v in batch.items()}
        nz = tuple(n.to(dev) for n in noise)
        rows = {k: _rows_per_example(v, PER_SLOT)
                for k, v in rs["trainable"]["table"].items()}
        w = XP.profile_mask_weights(rows, xp, noise=nz)
        t = time.perf_counter()
        grads, slot_loss, _ = ST.gang_loss_and_grads(fz, rs, tb, cfg, nz)
        before = tree_map(torch.clone, rs)
        step = ST.make_gang_step(cfg, lr=LR, fault_plan=plan)
        step({"frozen": fz, "roster": rs}, tb, nz)
        torch.cuda.synchronize()
        runs[name] = dict(w=[x.detach().cpu() for x in w],
                         grads=cs._tree_to(grads, "cpu"),
                         loss=slot_loss.cpu(),
                         before=cs._tree_to(before, "cpu"),
                         after=cs._tree_to(rs, "cpu"),
                         s=time.perf_counter() - t)
    gpu, cpu = runs["card"], runs["cpu"]
    khot = all(torch.equal(a > 0.5 / xp.k, b > 0.5 / xp.k)
               for a, b in zip(gpu["w"], cpu["w"]))
    active = [s for s, p in enumerate(pids) if p is not None]
    loss_rel = ((gpu["loss"] - cpu["loss"]).abs()
                / cpu["loss"].abs())[active].max().item()

    def rel_l2(a, b):
        return ((a - b).norm() / b.norm()).item() if b.norm() > 0 \
            else (a - b).norm().item()
    grad_rel = {p: rel_l2(a, tree_paths(cpu["grads"])[p])
                for p, a in tree_paths(gpu["grads"]).items()}
    param_rel = {p: rel_l2(a, tree_paths(cpu["after"]["trainable"])[p])
                 for p, a in tree_paths(gpu["after"]["trainable"]).items()}
    frozen_rows = True
    for run in (gpu, cpu):
        b, a = tree_paths(run["before"]), tree_paths(run["after"])
        for p in b:
            if p.startswith(("trainable", "opt/m", "opt/v")):
                for s in (2, 3):
                    frozen_rows &= torch.equal(b[p][s], a[p][s])
    nonfinite = gpu["after"]["nonfinite"].tolist()
    cs.log(f"lifecycle (c): one gang step, {cfg.name} L=2 d={cfg.d_model} "
           f"V={cfg.vocab_size} float32, {SLOTS} slots x {PER_SLOT} x "
           f"T={SEQ} (slot 2 parked, slot 3 poisoned): card {gpu['s']:.3f}s"
           f", CPU {cpu['s']:.3f}s; k-hot bitwise {khot}; slot loss max "
           f"relative |d| {loss_rel:.3e} (tol {cs.TRAIN_LOSS_RTOL}); grad "
           f"relative L2 " + ", ".join(f"{k} {v:.3e}"
                                       for k, v in grad_rel.items())
           + "; new params relative L2 " + ", ".join(
               f"{k} {v:.3e}" for k, v in param_rel.items())
           + f" (tol {cs.TRAIN_GRAD_REL_L2}); parked and poisoned rows "
           f"bitwise unchanged {frozen_rows}; nonfinite {nonfinite}")
    assert khot and loss_rel <= cs.TRAIN_LOSS_RTOL, loss_rel
    assert all(v <= cs.TRAIN_GRAD_REL_L2 for v in grad_rel.values())
    assert all(v <= cs.TRAIN_GRAD_REL_L2 for v in param_rel.values())
    assert frozen_rows and nonfinite == [0, 0, 0, 1]
    assert cpu["after"]["nonfinite"].tolist() == nonfinite
    return dict(khot_bitwise=khot, slot_loss_rel_err=loss_rel,
                grad_rel_l2=grad_rel, param_rel_l2=param_rel,
                parked_poisoned_bitwise=frozen_rows, card_s=gpu["s"],
                cpu_s=cpu["s"])


# ----------------------------------------------------------------------------
# (d) serving the graduated store
# ----------------------------------------------------------------------------

def serve_graduated(torch, cfg, frozen, trainer):
    from repro_torch.core.profiles import ProfileStore
    from repro_torch.kernels import fused_adapter_batched as KF
    from repro_torch.kernels import mask_aggregate as KA

    tmp = tempfile.mkdtemp(prefix="lifecycle_store_")
    path = os.path.join(tmp, "graduated.npz")
    trainer.scheduler.store.save(path)
    store = ProfileStore.load(path)
    shutil.rmtree(tmp, ignore_errors=True)
    pids = store.profile_ids()
    assert pids == sorted(r["pid"] for r in trainer.scheduler.graduated)
    assert not store.quarantined_ids()
    L = cfg.num_layers

    def check_launches(launches, st, waves):
        sparse = sum(w["path"] == "sparse" for w in waves)
        assert sparse > 0
        assert launches["mask_aggregate_batched"] == 2 * sparse, launches
        assert launches["fused_adapter_batched"] == \
            L * (st["device_steps"] + st["prefill_batches"]) > 0, launches

    _, _, launches, stats = cs.drive_path(
        torch, "graduated store", cfg, frozen, store,
        (("mask_aggregate_batched", KA.mask_aggregate_batched),
         ("fused_adapter_batched", KF.fused_adapter_batched)),
        check_launches, profiles=pids)
    stats["launches"] = launches
    stats["profiles"] = pids
    return stats


def phase_lifecycle(torch, base=None, cfg=None, device="cuda", layers=None):
    """Phase 11: (a)-(d) above; ``base`` may carry phase 4's weights
    (``init_lm(seed=0)`` of the same config), else they are drawn.
    ``layers`` runs the first that many layers (full width; ``base``'s
    blocks and bank cut to them). ``cfg`` (default qwen1.5-0.5b) and
    ``device`` serve a rehearsal at a small size."""
    from repro_torch.configs import get_config
    from repro_torch.models import init_lm
    from repro_torch.utils.tree import tree_map

    t0 = time.perf_counter()
    secs, lap = {}, [t0]

    def done(part):
        now = time.perf_counter()
        secs[part] = now - lap[0]
        lap[0] = now

    small = cfg is not None
    cfg = cfg or get_config("qwen1.5-0.5b")
    frozen = (base or {}).get("params")
    if layers is not None:
        cfg = cfg.with_(num_layers=layers)
        if frozen is not None:
            frozen = dict(frozen, **{
                k: tree_map(lambda t: t[:layers], frozen[k])
                for k in ("blocks", "xpeft_bank")})
    frozen = frozen or init_lm(cfg, seed=0, device=device)
    out = {}
    trainer, out["onboard"] = onboard(torch, cfg, frozen, device)
    done("a")
    out["resume"] = resume(torch, cfg, frozen, trainer, device)
    done("b")
    out["step_vs_cpu"] = step_vs_cpu(
        torch, cfg.with_(dtype="float32") if small else None, device)
    done("c")
    out["served"] = serve_graduated(torch, cfg, frozen, trainer)
    done("d")
    out["seconds"] = time.perf_counter() - t0
    out["part_seconds"] = secs
    cs.log(f"phase 11: {out['seconds']:.1f}s (" + ", ".join(
        f"({k}) {v:.1f}s" for k, v in secs.items()) + ")")
    return out


def main():
    import torch
    if not torch.cuda.is_available():
        print("lifecycle_phase: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(HERE, "src"))
    from repro_torch.kernels import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = cs.nvidia_smi()
    cs.log(f"device: {smi} | torch {torch.__version__} cuda "
           f"{torch.version.cuda}")
    _build.build()
    _build.load_library()
    out = phase_lifecycle(torch)
    cs.log(json.dumps({"lifecycle": out, "device": smi}, default=str))
    return 0


if __name__ == "__main__":
    sys.exit(main())
