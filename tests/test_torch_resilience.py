"""The port's resilience layer against the JAX package, on the CPU: retry
and backoff, ``FaultPlan`` decisions, store record integrity and
quarantine, and degraded (bare-PLM) serving.

Serving workload: reduced qwen1.5-0.5b at float32 with JAX's weights and
profile logits carried across by the bridge, 4 hard-mask profiles, 8
requests of 4-6 prompt tokens and 5 new tokens on 2 slots (max_seq 64),
under ``FaultPlan(fail_pids=(1,), flaky_pids=(2,))``, on six paths: bf16
records, the same with ``decode_fused`` (a degraded row takes the decode
block's adapter route over zero records where the X-PEFT-disabled engine
takes route none), int8 records, a heterogeneous bank with prefix rows,
per-step mask weights, and continuous bf16 on a 5-page pool with 30 new
tokens a request (the degraded request is preempted and resumed).

Contracts: against JAX's engine the degraded request set, the tokens and
the counters (degraded requests, hydration retries, quarantined profiles,
preemptions) are EQUAL (float32, no greedy tie on this workload); within
the port, the peers of a degraded wave are BITWISE the no-fault run and a
degraded request's tokens BITWISE those of the engine built with
``xpeft.enabled=False``.
"""
import numpy as np
import jax
import pytest
import torch

from repro.configs import get_config, reduce_for_smoke
from repro.core import xpeft as JXP
from repro.core.profiles import ProfileStore as JStore
from repro.models import init_lm as jinit_lm
from repro.resilience import FaultPlan as JPlan
from repro.resilience import RetryPolicy as JRetry
from repro.serve.engine import Request as JRequest
from repro.serve.engine import ServeEngine as JEngine
from repro_torch import bridge
from repro_torch.configs import get_config as tget_config
from repro_torch.configs import reduce_for_smoke as treduce
from repro_torch.core.profiles import ProfileStore
from repro_torch.resilience import (CheckpointCorruptError, FaultPlan,
                                    InjectedHydrationError,
                                    RecordIntegrityError, RetryPolicy,
                                    array_crc, file_crc, retry_with_backoff)
from repro_torch.serve import Request, ServeEngine

FAST_RETRY = RetryPolicy(attempts=3, delay_s=1e-4, max_delay_s=1e-3,
                         deadline_s=5.0)
JFAST_RETRY = JRetry(attempts=3, delay_s=1e-4, max_delay_s=1e-3,
                     deadline_s=5.0)
ARCH = "qwen1.5-0.5b"


# ------------------------------------------------------------------- retry

def test_retry_succeeds_after_transient_failures():
    calls = []

    def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise RuntimeError("transient")
        return "ok"

    sleeps = []
    assert retry_with_backoff(flaky, policy=FAST_RETRY,
                              retry_on=(RuntimeError,),
                              sleep=sleeps.append) == "ok"
    assert len(calls) == 3 and len(sleeps) == 2
    assert sleeps[1] > sleeps[0]  # exponential backoff


def test_retry_raises_last_error_and_is_deterministic():
    def always():
        raise ValueError("nope")

    sleeps_a, sleeps_b = [], []
    for sleeps in (sleeps_a, sleeps_b):
        with pytest.raises(ValueError):
            retry_with_backoff(always, policy=FAST_RETRY, seed=7,
                               retry_on=(ValueError,), sleep=sleeps.append)
    assert sleeps_a == sleeps_b  # seeded jitter replays exactly


def test_retry_non_matching_exception_propagates_at_once():
    calls = []

    def boom():
        calls.append(1)
        raise KeyError("not retryable")

    with pytest.raises(KeyError):
        retry_with_backoff(boom, policy=FAST_RETRY, retry_on=(ValueError,))
    assert len(calls) == 1


def test_retry_respects_deadline():
    """A retry whose backoff would start past the deadline is abandoned."""
    t = [0.0]
    policy = RetryPolicy(attempts=10, delay_s=0.5, backoff=1.0,
                         max_delay_s=0.5, jitter=0.0, deadline_s=1.0)
    calls = []

    def always():
        calls.append(1)
        raise RuntimeError("down")

    def sleep(d):
        t[0] += d

    with pytest.raises(RuntimeError):
        retry_with_backoff(always, policy=policy, retry_on=(RuntimeError,),
                           sleep=sleep, clock=lambda: t[0])
    assert len(calls) == 3


# --------------------------------------------------------------- FaultPlan

@pytest.mark.parametrize("seed", [11, 12])
def test_fault_plan_selects_the_same_pids_as_jax(seed):
    kw = dict(seed=seed, hydration_fail_rate=0.25,
              hydration_flaky_rate=0.25, hydration_delay_rate=0.1)
    plan, jplan = FaultPlan(**kw), JPlan(**kw)
    pids = list(range(400))
    fails = plan.persistent_fail_pids(pids)
    assert fails == jplan.persistent_fail_pids(pids)
    assert plan.flaky_hydration_pids(pids) == \
        jplan.flaky_hydration_pids(pids)
    assert [plan.hydration_mode(p) for p in pids] == \
        [jplan.hydration_mode(p) for p in pids]
    assert 0.15 < len(fails) / len(pids) < 0.35


def test_fault_plan_hydration_modes():
    plan = FaultPlan(fail_pids=(1,), flaky_pids=(2,))
    with pytest.raises(InjectedHydrationError):
        plan.on_hydration(1, attempt=0)
    with pytest.raises(InjectedHydrationError):
        plan.on_hydration(1, attempt=5)   # persistent: every attempt
    with pytest.raises(InjectedHydrationError):
        plan.on_hydration(2, attempt=0)
    plan.on_hydration(2, attempt=1)       # flaky: retry succeeds
    plan.on_hydration(3, attempt=0)       # healthy pid: no-op


def test_gang_poison_mask():
    plan = FaultPlan(poison_slots=(1, 3, 9), poison_from_step=2,
                     poison_steps=2)
    step = torch.tensor([0, 2, 3, 4], dtype=torch.int32)
    assert plan.gang_poison_mask(step, 4).tolist() == \
        [False, True, False, False]
    assert plan.poisons_gang() and not FaultPlan().poisons_gang()
    ever = FaultPlan(poison_slots=(0,))
    assert ever.gang_poison_mask(torch.tensor([0, 9]), 2).tolist() == \
        [True, False]


# ------------------------------------------------------------ store records

def _store(cls, quant="none", n=4, L=2, N=16, b=4, k=4):
    st = cls(L, N, b, "hard", k, quant=quant)
    rng = np.random.default_rng(0)
    for pid in range(n):
        prof = dict(mA=rng.normal(size=(L, N)), mB=rng.normal(size=(L, N)),
                    ln_scale=np.ones((L, b)), ln_bias=np.zeros((L, b)))
        agg = None
        if quant != "none":
            agg = (rng.normal(size=(L, 8, b)).astype(np.float32),
                   rng.normal(size=(L, b, 8)).astype(np.float32))
        st.add_profile(pid, prof, agg=agg)
    return st


@pytest.mark.parametrize("agg_only", [False, True])
def test_corrupt_store_flips_the_same_bytes_as_jax(agg_only):
    quant = "int8" if agg_only else "none"
    st, jst = _store(ProfileStore, quant), _store(JStore, quant)
    kw = dict(seed=5, corrupt_pids=(1, 3), corrupt_agg_only=agg_only)
    ev, jev = FaultPlan(**kw).corrupt_store(st), \
        JPlan(**kw).corrupt_store(jst)
    assert ev == jev and len(ev) == 2
    for pid in (1, 3):
        for key in jst._rec[pid]:
            assert st._rec[pid][key].tobytes() == \
                jst._rec[pid][key].tobytes(), (pid, key)


def test_store_checksums_catch_corruption_and_quarantine():
    st = _store(ProfileStore)
    ev = FaultPlan(seed=5, corrupt_pids=(1,)).corrupt_store(st)
    assert len(ev) == 1 and ev[0]["pid"] == 1
    with pytest.raises(RecordIntegrityError):
        st.mask_weights(1)
    assert st.quarantined_ids() == [1]
    with pytest.raises(RecordIntegrityError):
        st.sparse_indices(1)
    st.mask_weights(0)
    assert st.integrity_stats()["corrupt_detected"] == 1


def test_store_heals_on_regraduation():
    st = _store(ProfileStore)
    FaultPlan(seed=5, corrupt_pids=(2,)).corrupt_store(st)
    with pytest.raises(RecordIntegrityError):
        st.mask_weights(2)
    rng = np.random.default_rng(9)
    st.add_profile(2, dict(mA=rng.normal(size=(2, 16)),
                           mB=rng.normal(size=(2, 16)),
                           ln_scale=np.ones((2, 4)),
                           ln_bias=np.zeros((2, 4))))
    st.mask_weights(2)
    assert st.quarantined_ids() == []


def test_store_quant_agg_corruption_sheds_payload_not_profile():
    st = _store(ProfileStore, quant="int8")
    assert st.has_quant_record(1)
    FaultPlan(seed=5, corrupt_pids=(1,),
              corrupt_agg_only=True).corrupt_store(st)
    assert not st.has_quant_record(1)
    assert st.quarantined_ids() == []
    st.mask_weights(1)
    assert st.integrity_stats()["agg_dropped"] == [1]
    assert "agg_a_q" not in st._rec[1]


def test_store_save_load_roundtrip_verifies_checksums(tmp_path):
    st = _store(ProfileStore)
    FaultPlan(seed=5, corrupt_pids=(3,)).corrupt_store(st)
    with pytest.raises(RecordIntegrityError):
        st.ln_affines([3])
    path = str(tmp_path / "store.npz")
    st.save(path)
    st2 = ProfileStore.load(path)
    assert st2.profile_ids() == [0, 1, 2]
    assert st2.quarantined_ids() == []
    for pid in st2.profile_ids():
        st2.check_record(pid)
    st2._rec[0]["mB"] = st2._rec[0]["mB"].copy()
    st2._rec[0]["mB"][-1] ^= 0x55
    with pytest.raises(RecordIntegrityError):
        st2.batch_mask_weights([0])


def test_array_and_file_crc(tmp_path):
    from repro.resilience import file_crc as jfile_crc
    a = np.arange(8, dtype=np.int32)
    assert array_crc(a) != array_crc(a.astype(np.int64))
    assert array_crc(a) != array_crc(a.reshape(2, 4))
    assert array_crc(a) == array_crc(a.copy())
    p = tmp_path / "blob"
    p.write_bytes(bytes(range(256)) * 5000)
    assert file_crc(str(p), chunk=4096) == jfile_crc(str(p)) \
        and file_crc(str(p))[1] == 256 * 5000
    assert issubclass(CheckpointCorruptError, Exception)


# -------------------------------------------------------- degraded serving

HETERO = dict(num_adapters=12, bottleneck=4, k=4, max_profiles=8,
              bank_spec=(("bottleneck", 4), ("lora", 4), ("ia3", 2),
                         ("prefix", 2)), prefix_tokens=2)
# path -> (X-PEFT overrides, config overrides, engine options, store
# options, new tokens)
PATHS = {
    "bf16": ({}, {}, {}, {}, 5),
    "decode_fused": ({}, {"decode_fused": True}, {}, {}, 5),
    "int8": ({"bank_quant": "int8"}, {}, {}, {"quant": "int8"}, 5),
    "hetero_prefix": (HETERO, {}, {}, {}, 5),
    "per_step": ({}, {}, {"precompute": False}, {}, 5),
    "continuous": ({}, {}, {"continuous": True, "max_pages": 5,
                            "page_size": 16}, {}, 30),
}


@pytest.fixture(scope="module")
def serve_setup():
    out = {}
    for label, xkw in (("base", {}), ("hetero", HETERO)):
        cfg = reduce_for_smoke(get_config(ARCH)).with_xpeft(**xkw)
        tcfg = treduce(tget_config(ARCH)).with_xpeft(**xkw)
        key = jax.random.key(0)
        params = jax.jit(jinit_lm, static_argnums=1)(key, cfg)
        table = jax.tree.map(np.asarray, JXP.init_profile_table(key, cfg))
        rows = [{k: np.array(v[pid]) for k, v in table.items()}
                for pid in range(4)]
        if xkw:
            # profile 0 selects a prefix slot at every layer, so its
            # degraded twin would be seen to drop P rows
            off = next(o for t, o, c in cfg.xpeft.segments()
                       if t == "prefix")
            for m in ("mA", "mB"):
                rows[0][m][:, off] = 30.0
        out[label] = dict(cfg=cfg, tcfg=tcfg, params=params, rows=rows,
                          tparams=bridge.to_torch(
                              jax.tree.map(np.asarray, params)))
    return out


def _requests(cls, vocab, max_new):
    return [cls(uid=i, prompt=(np.arange(4 + i % 3) + 7 * i) % vocab,
                profile_id=i % 4, max_new_tokens=max_new)
            for i in range(8)]


def _serve(setup, path, *, port, plan=None, enabled=True):
    """Drain the 8 requests on ``path`` (a ``PATHS`` key or such a
    tuple)."""
    xkw, ckw, ekw, skw, max_new = PATHS[path] if isinstance(path, str) \
        else path
    s = setup["hetero" if "bank_spec" in xkw else "base"]
    cfg = (s["tcfg"] if port else s["cfg"]).with_(**ckw).with_xpeft(
        **{k: v for k, v in xkw.items() if k == "bank_quant"},
        enabled=enabled)
    xp = cfg.xpeft
    store = (ProfileStore if port else JStore)(
        cfg.num_layers, xp.num_adapters, xp.bottleneck, "hard", xp.k,
        bank_spec=xp.bank_spec, **skw)
    for pid, row in enumerate(s["rows"]):
        store.add_profile(pid, row)
    eng = (ServeEngine if port else JEngine)(
        cfg, s["tparams"] if port else s["params"], store, max_slots=2,
        max_seq=64, fault_plan=plan,
        retry_policy=FAST_RETRY if port else JFAST_RETRY, **ekw)
    reqs = _requests(Request if port else JRequest, cfg.vocab_size, max_new)
    eng.run_until_drained(list(reqs))
    assert all(r.done for r in reqs)
    return eng, reqs


@pytest.mark.parametrize("path", sorted(PATHS))
def test_degraded_serving_matches_jax_and_bare(serve_setup, path):
    plan_kw = dict(fail_pids=(1,), flaky_pids=(2,))
    eng, reqs = _serve(serve_setup, path, port=True,
                       plan=FaultPlan(**plan_kw))
    jeng, jreqs = _serve(serve_setup, path, port=False,
                         plan=JPlan(**plan_kw))
    st, jst = eng.serve_stats(), jeng.serve_stats()
    # the degraded set is the plan's: every pid-1 request, nothing else
    assert [r.uid for r in reqs if r.degraded] == [1, 5] == \
        [r.uid for r in jreqs if r.degraded]
    assert [r.generated for r in reqs] == [r.generated for r in jreqs]
    for key in ("degraded_requests", "hydration_retries",
                "quarantined_profiles", "decode_tokens", "device_steps"):
        assert st[key] == jst[key], key
    assert st["degraded_requests"] == 2 and st["hydration_retries"] > 0
    assert st["degraded_slots"] == 0
    assert eng.profile_cache.peek(1) is None
    if path == "hetero_prefix":
        assert [r.prefix_len for r in reqs] == \
            [getattr(r, "prefix_len", 0) for r in jreqs]
        assert reqs[1].prefix_len == 0 and reqs[0].prefix_len == 2
    if path == "continuous":
        assert st["preemptions"] == jst["preemptions"] > 0
        assert reqs[1].preemptions > 0 or reqs[5].preemptions > 0
        eng.page_alloc.check()
        eng.mask_alloc.check()
    # within the port: peers bitwise the no-fault run, degraded requests
    # bitwise the X-PEFT-disabled engine
    _, clean = _serve(serve_setup, path, port=True)
    _, bare = _serve(serve_setup, path, port=True, enabled=False)
    for r, c, b in zip(reqs, clean, bare):
        assert r.generated == (b.generated if r.degraded else c.generated), \
            r.uid


def test_continuous_equals_windowed_under_the_fault_plan(serve_setup):
    """The same plan and requests, continuous on a starved pool against
    windowed: the same degraded set, tokens bitwise."""
    plan_kw = dict(fail_pids=(1,), flaky_pids=(2,))
    _, cont = _serve(serve_setup, "continuous", port=True,
                     plan=FaultPlan(**plan_kw))
    windowed = PATHS["continuous"][:2] + ({}, {}, PATHS["continuous"][4])
    _, win = _serve(serve_setup, windowed, port=True,
                    plan=FaultPlan(**plan_kw))
    assert [r.degraded for r in cont] == [r.degraded for r in win]
    assert [r.generated for r in cont] == [r.generated for r in win]
    assert any(r.preemptions for r in cont if r.degraded)


def test_corrupt_record_is_never_served(serve_setup):
    s = serve_setup["base"]
    cfg = s["tcfg"]
    xp = cfg.xpeft
    store = ProfileStore(cfg.num_layers, xp.num_adapters, xp.bottleneck,
                         "hard", xp.k)
    for pid, row in enumerate(s["rows"]):
        store.add_profile(pid, row)
    FaultPlan(seed=5, corrupt_pids=(3,)).corrupt_store(store)
    eng = ServeEngine(cfg, s["tparams"], store, max_slots=2, max_seq=64,
                      retry_policy=FAST_RETRY)
    reqs = _requests(Request, cfg.vocab_size, 5)
    eng.run_until_drained(list(reqs))
    assert all(r.done for r in reqs)
    assert [r.degraded for r in reqs] == [r.profile_id == 3 for r in reqs]
    assert eng.serve_stats()["quarantined_profiles"] == 1
    assert eng.serve_stats()["store_integrity"]["quarantined"] == [3]
    assert eng.profile_cache.peek(3) is None


def test_missing_profile_degrades_instead_of_crashing(serve_setup):
    s = serve_setup["hetero"]
    cfg = s["tcfg"]
    xp = cfg.xpeft
    store = ProfileStore(cfg.num_layers, xp.num_adapters, xp.bottleneck,
                         "hard", xp.k, bank_spec=xp.bank_spec)
    store.add_profile(0, s["rows"][0])
    eng = ServeEngine(cfg, s["tparams"], store, max_slots=2, max_seq=64,
                      retry_policy=FAST_RETRY)
    reqs = [Request(uid=0, prompt=np.arange(5), profile_id=0,
                    max_new_tokens=4),
            Request(uid=1, prompt=np.arange(5), profile_id=999,
                    max_new_tokens=4)]
    eng.run_until_drained(list(reqs))
    assert reqs[1].degraded and not reqs[0].degraded
    assert reqs[1].prefix_len == 0 and reqs[0].prefix_len == 2
    assert eng.serve_stats()["degraded_requests"] == 1
    assert eng.last_admission["degraded"] == 1
