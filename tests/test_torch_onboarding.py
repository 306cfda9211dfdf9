"""The port's profile lifecycle against the JAX package, on the CPU:
streaming P >> S profiles through the roster, graduation into the store
(byte-equal to JAX's over the same profiles, Gumbel draws and policy),
train -> serve parity, resume mid-onboarding, quarantine of a poisoned
slot, the lifecycle's trace events, and the serving engine's invalidation
of re-graduated profiles (JAX's ``test_onboarding.py``,
``test_serve_invalidation.py`` and the quarantine case of
``test_resilience.py``).

Configs: ``reduce_for_smoke(get_config("qwen1.5-0.5b"))`` (2 layers, d=64,
vocab 512, N=8, b=4, k=2, float32) and JAX's classification config,
``reduce_for_smoke(get_config("bert-base-xpeft"))`` with 4 labels, vocab
64, N=8, k=2. JAX's frozen weights, initial roster, fresh rows and Gumbel
draws (its trainer's key sequence) come across through
``repro_torch.bridge``.

Tolerances: the graduated records byte-equal to JAX's (the hard masks are
top-k selections and the LN affines fp16, so the port's gang steps,
within 1e-5 of JAX's, must not move a selection or an fp16 rounding);
within the port, resume and parity bitwise.
"""
import gc

import numpy as np
import jax
import pytest
import torch

from repro.configs import get_config, reduce_for_smoke
from repro.data import MarkovLM as JMarkov
from repro.data import ProfileClassification as JCls
from repro.resilience.faults import FaultPlan as JPlan
from repro.train import GraduationPolicy as JPolicy
from repro.train import roster as JR
from repro.train.onboarding import build_onboarding_run as jbuild
from repro_torch import bridge
from repro_torch import obs as OBS
from repro_torch.configs import get_config as tget_config
from repro_torch.configs import reduce_for_smoke as treduce
from repro_torch.core import masks as M
from repro_torch.core import xpeft as XP
from repro_torch.core.profiles import ProfileStore
from repro_torch.data import MarkovLM, ProfileClassification
from repro_torch.models import init_lm
from repro_torch.models import model as MDL
from repro_torch.quant import schemes as QS
from repro_torch.resilience import FaultPlan
from repro_torch.serve import Request, ServeEngine
from repro_torch.train import (GraduationPolicy, OnboardingScheduler,
                               OnboardingTrainer, RosterBatcher)
from repro_torch.train import roster as TR
from repro_torch.train import steps as TST
from repro_torch.train.onboarding import build_onboarding_run
from repro_torch.utils.tree import tree_paths


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _cls_cfg(vocab=64, tcfg=True):
    r, g = (treduce, tget_config) if tcfg else (reduce_for_smoke, get_config)
    return r(g("bert-base-xpeft")).with_(
        num_labels=4, vocab_size=vocab).with_xpeft(num_adapters=8, k=2)


def _qwen(tcfg=True):
    return treduce(tget_config("qwen1.5-0.5b")) if tcfg else \
        reduce_for_smoke(get_config("qwen1.5-0.5b"))


def _policy(**kw):
    kw.setdefault("min_steps", 4)
    kw.setdefault("max_steps", 8)
    kw.setdefault("target_acc", 2.0)  # unreachable: graduate at max_steps
    return GraduationPolicy(**kw)


def _build(cfg, source, n_profiles, *, S=2, m=2, seq=12, policy=None,
           log_every=5, **kw):
    trainer, gang = build_onboarding_run(
        cfg, source, range(n_profiles), slots=S, per_slot=m, seq_len=seq,
        policy=policy or _policy(), lr=5e-2, log_every=log_every,
        device="cpu", **kw)
    return (trainer, trainer.scheduler.roster, trainer.scheduler.store,
            trainer.state["frozen"])


def _storage(rstate):
    return {p: (t.data_ptr(), t.shape, t.dtype)
            for p, t in tree_paths(rstate).items()}


# ----------------------------------------------------------- streaming P>>S

def test_stream_profiles_through_roster():
    cfg = _cls_cfg()
    data = ProfileClassification(cfg.vocab_size, cfg.num_labels,
                                 num_profiles=5, seed=5)
    trainer, _, store, _ = _build(cfg, data, 5)
    before = _storage(trainer.state["roster"])
    trainer.run_until_drained(max_steps=500)
    st = trainer.scheduler.stats()
    assert st["graduated"] == 5 and st["evicted"] == 0
    assert store.profile_ids() == [0, 1, 2, 3, 4]
    assert st["admission_waves"] >= 3          # 5 profiles through 2 slots
    # no roster tensor reallocated across the waves
    assert _storage(trainer.state["roster"]) == before
    assert trainer.host_syncs < trainer.step   # metrics buffered on device


def test_evict_at_max_drops_unconverged_profiles():
    cfg = _cls_cfg()
    data = ProfileClassification(cfg.vocab_size, cfg.num_labels,
                                 num_profiles=3, seed=5)
    policy = _policy(max_steps=6, evict_at_max=True)
    trainer, _, store, _ = _build(cfg, data, 3, policy=policy)
    trainer.run_until_drained(max_steps=300)
    st = trainer.scheduler.stats()
    assert st["graduated"] == 0 and st["evicted"] == 3
    assert store.profile_ids() == []
    assert {e["pid"] for e in trainer.scheduler.evicted} == {0, 1, 2}


# ------------------------------------------------ the store against JAX's

def _jax_noise(cfg, S, m, steps, seed=1):
    """The Gumbel draws of JAX's trainer (rng key(seed), split per step)
    through its gang step (the step key split into A's and B's)."""
    rng, out = jax.random.key(seed), []
    shape = (S * m, cfg.num_layers, cfg.xpeft.num_adapters)
    for _ in range(steps):
        rng, sub = jax.random.split(rng)
        ka, kb = jax.random.split(sub)
        out.append(tuple(torch.tensor(np.asarray(jax.random.gumbel(k, shape)))
                         for k in (ka, kb)))
    return out


def _port_like_jax(cfg, tcfg, jt, tsrc, P, S, m, seq, policy, plan=None,
                   steps=60, log_every=5):
    """The port's onboarding over JAX's frozen weights, initial roster
    (build_onboarding_run's split of key(0)), fresh rows (fold_in of
    key(2)) and Gumbel draws."""
    jroster = jt.scheduler.roster
    _, kr = jax.random.split(jax.random.key(0))
    r0 = _np(JR.init_roster_state(kr, cfg, S))
    roster = TR.Roster(tcfg, 2, S, device="cpu")
    roster.fresh = lambda pid: bridge.to_torch(
        _np(jroster._fresh(jroster.profile_key(pid))))
    xp = tcfg.xpeft
    store = ProfileStore(tcfg.num_layers, xp.num_adapters, xp.bottleneck,
                         xp.mask_type, xp.k)
    sched = OnboardingScheduler(roster, store, policy, range(P))
    gang = TST.make_gang_step(tcfg, lr=5e-2, ema_decay=policy.ema_decay,
                              fault_plan=plan)
    noise = _jax_noise(cfg, S, m, steps)
    holder = {}
    trainer = OnboardingTrainer(
        lambda st, b, rng: gang(st, b, noise[holder["t"].step]),
        {"frozen": bridge.to_torch(_np(jt.state["frozen"])),
         "roster": bridge.to_torch(r0)},
        RosterBatcher(tsrc, S, m, seq), sched, log_every=log_every)
    holder["t"] = trainer
    trainer.run_until_drained(max_steps=steps)
    return trainer


def test_streamed_store_byte_equal_to_jax():
    """5 LM profiles through 2 slots (graduating at max_steps): the port's
    graduated records (packed masks, fp16 LN affines) and their checksums
    byte-equal to JAX's, the lifecycle records equal."""
    cfg, tcfg = _qwen(False), _qwen()
    P, S, m, seq = 5, 2, 2, 12
    jpol = JPolicy(min_steps=4, max_steps=8, target_acc=2.0)
    jt, _ = jbuild(cfg, JMarkov(cfg.vocab_size, P, seed=1), range(P),
                   slots=S, per_slot=m, seq_len=seq, policy=jpol, lr=5e-2,
                   log_every=5, rng=jax.random.key(1))
    jt.run_until_drained(max_steps=60)
    tt = _port_like_jax(cfg, tcfg, jt, MarkovLM(cfg.vocab_size, P, seed=1),
                        P, S, m, seq, _policy())
    js, ts = jt.scheduler.store, tt.scheduler.store
    assert ts.profile_ids() == js.profile_ids() == list(range(P))
    for pid in js.profile_ids():
        assert sorted(ts._rec[pid]) == sorted(js._rec[pid])
        for key, want in js._rec[pid].items():
            assert ts._rec[pid][key].tobytes() == want.tobytes(), (pid, key)
        assert ts._crc[pid] == js._crc[pid]
    strip = [{k: r[k] for k in ("pid", "slot", "steps")}
             for r in jt.scheduler.graduated]
    assert [{k: r[k] for k in ("pid", "slot", "steps")}
            for r in tt.scheduler.graduated] == strip
    assert tt.step == jt.step


def test_poisoned_slot_quarantined_as_jax():
    """A plan poisoning slot 0 (4 classification profiles, 2 slots, 2
    strikes): the quarantined and graduated profiles (pid, slot, steps,
    strikes) are JAX's, and nothing of a quarantined profile reaches the
    store."""
    cfg, tcfg = _cls_cfg(tcfg=False), _cls_cfg()
    P, S, m, seq = 4, 2, 2, 12
    jpol = JPolicy(min_steps=3, max_steps=5, target_acc=2.0,
                   max_poison_strikes=2)
    jt, _ = jbuild(cfg, JCls(cfg.vocab_size, cfg.num_labels,
                             num_profiles=P, seed=5), range(P), slots=S,
                   per_slot=m, seq_len=seq, policy=jpol, lr=5e-2,
                   log_every=3, rng=jax.random.key(1),
                   fault_plan=JPlan(poison_slots=(0,)))
    jt.run_until_drained(max_steps=60)
    pol = _policy(min_steps=3, max_steps=5, max_poison_strikes=2)
    tt = _port_like_jax(cfg, tcfg, jt, ProfileClassification(
        cfg.vocab_size, cfg.num_labels, num_profiles=P, seed=5), P, S, m,
        seq, pol, plan=FaultPlan(poison_slots=(0,)), log_every=3)
    keys = ("pid", "slot", "steps", "nonfinite")
    for name in ("quarantined", "graduated", "evicted"):
        want = [{k: r[k] for k in keys if k in r}
                for r in getattr(jt.scheduler, name)]
        got = [{k: r[k] for k in keys if k in r}
               for r in getattr(tt.scheduler, name)]
        assert got == want, name
    st = tt.scheduler.stats()
    assert st["quarantined"] >= 1
    assert st["graduated"] + st["evicted"] + st["quarantined"] == P
    q = {r["pid"] for r in tt.scheduler.quarantined}
    assert not q & set(tt.scheduler.store.profile_ids())
    assert tt.scheduler.store.profile_ids() == \
        jt.scheduler.store.profile_ids()


# --------------------------------------------------- train -> serve parity

@pytest.fixture(scope="module")
def lm_graduated():
    cfg = _qwen()
    data = MarkovLM(cfg.vocab_size, 2, seed=1)
    trainer, roster, store, frozen = _build(cfg, data, 2, seq=16)
    trainer.run_until_drained(max_steps=100)
    assert len(trainer.scheduler.graduated) == 2
    return cfg, frozen, roster, trainer, store


def test_graduated_masks_roundtrip_bit_for_bit(lm_graduated, tmp_path):
    cfg, frozen, roster, trainer, store = lm_graduated
    store.save(str(tmp_path / "store.npz"))
    loaded = ProfileStore.load(str(tmp_path / "store.npz"))
    k = cfg.xpeft.k
    for g in trainer.scheduler.graduated:
        row = roster.slot_params(trainer.state["roster"], g["slot"])
        bits_a = M.binarize(torch.from_numpy(row["mA"]), k).numpy()
        ia_t = M.mask_indices(bits_a, k)
        for st in (store, loaded):
            ia, wa, ib, wb = st.sparse_indices(g["pid"])
            assert torch.equal(ia, ia_t)
            assert torch.equal(ib, M.mask_indices(M.binarize(
                torch.from_numpy(row["mB"]), k).numpy(), k))
            assert bool((wa == 1.0 / k).all())
        wa_t, _ = store.mask_weights(g["pid"])
        assert torch.equal(wa_t, M.khot_weights_from_bits(bits_a, k))


def test_graduated_profile_admits_through_serve_engine(lm_graduated,
                                                       tmp_path):
    """Persisted store -> ServeEngine admission: the engine's aggregated
    Â/B̂ equal the aggregation of the IN-TRAINING masks, and its LN
    affines the trained row's at the store's fp16 precision."""
    cfg, frozen, roster, trainer, store = lm_graduated
    store.save(str(tmp_path / "store.npz"))
    loaded = ProfileStore.load(str(tmp_path / "store.npz"))
    eng = ServeEngine(cfg, frozen, loaded, max_slots=2, max_seq=32,
                      sync_every=2)
    k = cfg.xpeft.k
    for g in trainer.scheduler.graduated:
        pid = g["pid"]
        req = Request(uid=pid, prompt=np.arange(5, dtype=np.int64) % 31,
                      profile_id=pid, max_new_tokens=2)
        assert eng.admit_many([req]) == 1
        entry = eng.profile_cache.peek(pid)
        row = roster.slot_params(trainer.state["roster"], g["slot"])
        ia, ib = (M.mask_indices(M.binarize(torch.from_numpy(row[m]),
                                            k).numpy(), k)[None]
                  for m in ("mA", "mB"))
        w = torch.full(ia.shape, 1.0 / k)
        a_hat, b_hat = XP.precompute_effective_adapters_sparse(
            frozen["xpeft_bank"], ia, w, ib, w, cfg.xpeft)
        assert torch.equal(entry["a_hat"], a_hat[0])
        assert torch.equal(entry["b_hat"], b_hat[0])
        assert np.array_equal(entry["ln_scale"].numpy(),
                              row["ln_scale"].astype(np.float16)
                              .astype(np.float32))
        eng.run_until_drained()


def test_graduated_classifier_logits_parity(tmp_path):
    """Logits from the PERSISTED store (masks, LN and per-profile head,
    fp16 records) equal the in-training eval forward bit for bit."""
    cfg = _cls_cfg()
    data = ProfileClassification(cfg.vocab_size, cfg.num_labels,
                                 num_profiles=2, seed=5)
    trainer, roster, store, frozen = _build(cfg, data, 2)
    trainer.run_until_drained(max_steps=100)
    store.save(str(tmp_path / "store.npz"))
    loaded = ProfileStore.load(str(tmp_path / "store.npz"))
    k, B = cfg.xpeft.k, 8

    def logits_with(masks, head_w, head_b, toks):
        hidden, _, _ = MDL.forward(frozen, toks, cfg, profile_masks=masks)
        head = {"head_w": head_w.expand((B,) + tuple(head_w.shape)),
                "head_b": head_b.expand((B,) + tuple(head_b.shape))}
        return MDL.cls_logits(frozen, hidden, cfg, head)

    def f16(x):
        return torch.from_numpy(x.astype(np.float16).astype(np.float32))

    for g in trainer.scheduler.graduated:
        pid = g["pid"]
        toks = torch.from_numpy(data.sample(777, B, 12,
                                            profile_ids=[pid] * B)["tokens"])
        row = roster.slot_params(trainer.state["roster"], g["slot"])
        wa, wb = (M.khot_weights_from_bits(M.binarize(
            torch.from_numpy(row[m]), k).numpy(), k) for m in ("mA", "mB"))
        exp = lambda t: t.expand((B,) + tuple(t.shape))  # noqa: E731
        lt = logits_with({"w_a": exp(wa), "w_b": exp(wb),
                          "ln_scale": exp(f16(row["ln_scale"])),
                          "ln_bias": exp(f16(row["ln_bias"]))},
                         f16(row["head_w"]), f16(row["head_b"]), toks)
        swa, swb, sls, slb = loaded.batch_mask_weights([pid] * B)
        hw, hb = loaded.head(pid)
        ls = logits_with({"w_a": swa, "w_b": swb, "ln_scale": sls,
                          "ln_bias": slb}, hw, hb, toks)
        assert torch.equal(lt, ls)


def test_quantized_store_graduates_aggregated_records():
    """Into an int8 store graduation also writes the profile's aggregated
    Â/B̂ (its masks x the frozen bank), quantized on write."""
    cfg = _qwen().with_xpeft(bank_quant="int8")
    data = MarkovLM(cfg.vocab_size, 2, seed=1)
    trainer, roster, store, frozen = _build(cfg, data, 2, seq=16)
    trainer.run_until_drained(max_steps=100)
    assert store.quant == "int8" and store.profile_ids() == [0, 1]
    for pid in (0, 1):
        assert store.has_quant_record(pid)
    # re-derive profile 1's aggregate from its trained row: it graduated
    # last, from slot 1, whose row the roster still holds
    g = trainer.scheduler.graduated[-1]
    row = roster.slot_params(trainer.state["roster"], g["slot"])
    eff = XP.precompute_effective_adapters(
        frozen["xpeft_bank"], {k: torch.from_numpy(v) for k, v in
                               row.items()}, cfg.xpeft)
    q = QS.quantize(eff["a_hat"], "int8", group=cfg.xpeft.quant_group)
    rec = store._rec[g["pid"]]
    assert rec["agg_a_q"].tobytes() == q["q"].numpy().tobytes()


# ------------------------------------------------------------------- resume

def test_resume_mid_onboarding_matches_uninterrupted(tmp_path):
    """Checkpoint mid-onboarding, resume a fresh trainer: the final store
    (and its file) and roster are bitwise the uninterrupted run's, and
    graduated profiles are not re-trained."""
    cfg = _cls_cfg()

    def make(ckpt_dir=None, store_path=None):
        data = ProfileClassification(cfg.vocab_size, cfg.num_labels,
                                     num_profiles=4, seed=5)
        return _build(cfg, data, 4, ckpt_dir=ckpt_dir, ckpt_every=5,
                      store_path=store_path)

    t1, _, store1, _ = make()
    t1.run_until_drained(max_steps=500)
    ck, sp = str(tmp_path / "ck"), str(tmp_path / "store.npz")
    t2, _, _, _ = make(ckpt_dir=ck, store_path=sp)
    t2.run(10)
    graduated_at_ckpt = [g["pid"] for g in t2.scheduler.graduated]
    t3, _, store3, _ = make(ckpt_dir=ck, store_path=sp)
    assert t3.try_resume()
    assert t3.step == 10
    assert [g["pid"] for g in t3.scheduler.graduated] == graduated_at_ckpt
    t3.run_until_drained(max_steps=500)
    assert t3.step == t1.step
    assert store3.profile_ids() == store1.profile_ids() == [0, 1, 2, 3]
    assert t3.scheduler.graduated == t1.scheduler.graduated
    for pid in store1.profile_ids():
        for key, v in store1._rec[pid].items():
            assert store3._rec[pid][key].tobytes() == v.tobytes()
    for a, b in zip(tree_paths(t1.state["roster"]).values(),
                    tree_paths(t3.state["roster"]).values()):
        assert torch.equal(a, b)
    p1, p3 = tmp_path / "s1.npz", tmp_path / "s3.npz"
    store1.save(str(p1))
    store3.save(str(p3))
    assert p1.read_bytes() == p3.read_bytes()


# ---------------------------------------------------------- observability

def test_lifecycle_trace_events_and_counters():
    """Graduation, eviction and quarantine each emit an instant and a
    counter; every flushed window is a gang_window span and adds its steps
    to train.steps; the trace validates."""
    cfg = _cls_cfg()
    data = ProfileClassification(cfg.vocab_size, cfg.num_labels,
                                 num_profiles=4, seed=5)
    bundle = OBS.Observability()
    trainer, _, _, _ = _build(
        cfg, data, 4, policy=_policy(max_steps=5, max_poison_strikes=2,
                                     evict_at_max=False),
        log_every=3, obs=bundle, fault_plan=FaultPlan(poison_slots=(0,)))
    trainer.run_until_drained(max_steps=100)
    st = trainer.scheduler.stats()
    counters = bundle.metrics.snapshot()["counters"]
    assert counters["train.quarantined"] == st["quarantined"] >= 1
    assert counters["train.graduated"] == st["graduated"] >= 1
    assert counters["train.steps"] == trainer.step
    names = [(e["cat"], e["name"]) for e in bundle.tracer.events()]
    assert names.count(("graduation", "graduate")) == st["graduated"]
    assert names.count(("resilience", "quarantine")) == st["quarantined"]
    assert names.count(("gang-step", "gang_window")) >= 2
    assert OBS.validate_chrome_trace(
        {"traceEvents": bundle.tracer.events()}) is None


# ------------------------------------- serve invalidation (re-graduation)

def _onboard(cfg, store, seed, frozen=None):
    data = MarkovLM(cfg.vocab_size, 2, seed=seed)
    trainer, _ = build_onboarding_run(
        cfg, data, [0], slots=1, per_slot=2, seq_len=8,
        policy=_policy(min_steps=3, max_steps=5), lr=5e-2, seed=seed,
        log_every=50, frozen=frozen, store=store, device="cpu")
    trainer.run_until_drained(max_steps=100)
    assert len(trainer.scheduler.graduated) == 1
    return trainer


def _fresh_aggregate(eng, store, pid):
    ia, wa, ib, wb = store.batch_sparse_indices([pid])
    return XP.precompute_effective_adapters_sparse(
        eng.params["xpeft_bank"], ia, wa, ib, wb, eng.cfg.xpeft)


def _req(uid, pid, max_new=3):
    return Request(uid=uid, prompt=np.arange(5, dtype=np.int64) % 31,
                   profile_id=pid, max_new_tokens=max_new)


def _store(cfg):
    xp = cfg.xpeft
    return ProfileStore(cfg.num_layers, xp.num_adapters, xp.bottleneck,
                        xp.mask_type, xp.k)


def _table_store(cfg, n=2, seed=0):
    store = _store(cfg)
    table = XP.init_profile_table(cfg.with_xpeft(max_profiles=n), seed=seed)
    for pid in range(n):
        store.add_profile(pid, {k: v[pid] for k, v in table.items()})
    return store


def test_regraduation_invalidates_and_next_admission_reaggregates():
    cfg = _qwen()
    store = _store(cfg)
    frozen = _onboard(cfg, store, seed=0).state["frozen"]
    eng = ServeEngine(cfg, frozen, store, max_slots=1, max_seq=32,
                      sync_every=2)
    eng.run_until_drained([_req(0, 0)])
    stale = {k: v.clone() for k, v in eng.profile_cache.peek(0).items()}
    _onboard(cfg, store, seed=7, frozen=frozen)   # re-train profile 0
    fresh_a, fresh_b = _fresh_aggregate(eng, store, 0)
    assert not torch.equal(fresh_a[0], stale["a_hat"])
    assert eng.profile_cache.peek(0) is None
    eng.run_until_drained([_req(1, 0)])
    entry = eng.profile_cache.peek(0)
    assert torch.equal(entry["a_hat"], fresh_a[0])
    assert torch.equal(entry["b_hat"], fresh_b[0])
    assert torch.equal(entry["ln_scale"], store.ln_affines([0])[0][0])
    assert eng.profile_cache.stats()["invalidations"] == 1


def test_merge_from_invalidates_adopted_pids_only():
    cfg = _qwen()
    params = init_lm(cfg, seed=0, device="cpu")
    store = _table_store(cfg, n=2, seed=1)
    eng = ServeEngine(cfg, params, store, max_slots=2, max_seq=32,
                      sync_every=2)
    eng.run_until_drained([_req(0, 0), _req(1, 1)])
    assert eng.profile_cache.peek(0) is not None
    assert eng.profile_cache.peek(1) is not None
    store.merge_from(_table_store(cfg, n=1, seed=9))
    assert eng.profile_cache.peek(0) is None
    assert eng.profile_cache.peek(1) is not None


def test_store_does_not_pin_dead_engines():
    cfg = _qwen()
    params = init_lm(cfg, seed=0, device="cpu")
    store = _table_store(cfg, n=1, seed=1)
    eng = ServeEngine(cfg, params, store, max_slots=1, max_seq=32)
    assert len(store._listeners) == 1
    ref = store._listeners[0]
    del eng
    gc.collect()
    assert ref() is None
    other = _table_store(cfg, n=1, seed=9)
    store.add_profile(0, {k: v for k, v in zip(
        ("mA", "mB"), other.mask_weights(0))} | dict(zip(
            ("ln_scale", "ln_bias"), (t[0] for t in other.ln_affines([0])))))
    assert store._listeners == []


def test_inflight_slot_finishes_on_old_masks():
    cfg = _qwen()
    params = init_lm(cfg, seed=0, device="cpu")
    store = _table_store(cfg, n=1, seed=1)
    eng = ServeEngine(cfg, params, store, max_slots=1, max_seq=64,
                      sync_every=4)
    assert eng.admit_many([_req(0, 0, max_new=16)]) == 1
    old = {k: v.clone() for k, v in eng.profile_cache.peek(0).items()}
    eng.step()  # in flight, not drained
    table = XP.init_profile_table(cfg.with_xpeft(max_profiles=1), seed=9)
    store.add_profile(0, {k: v[0] for k, v in table.items()})
    assert eng.profile_cache.peek(0) is None
    # the slot buffer still carries the OLD aggregate
    assert torch.equal(eng.masks["a_hat"][0], old["a_hat"])
    eng.run_until_drained()
    fresh_a, _ = _fresh_aggregate(eng, store, 0)
    eng.run_until_drained([_req(1, 0)])
    assert torch.equal(eng.profile_cache.peek(0)["a_hat"], fresh_a[0])
