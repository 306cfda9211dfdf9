"""The port's observability layer against the JAX package, on the CPU:
the host half (histograms, registry, span tracer, retrace sentinel,
watchdog mirroring, the bundle) under the JAX package's own unit checks,
the device accumulator against JAX's, ``serve_stats()`` key sets against
JAX's engine in every mode (minus ``step_traces``: the port compiles no
decode step), and obs on against off.

Serving workload: reduced qwen1.5-0.5b at float32 with JAX's weights and
profile logits carried across, 3 hard-mask profiles, 5-6 requests on 2
slots (max_seq 64). Contracts: with an obs bundle attached the tokens are
BITWISE and ``host_syncs`` EQUAL to the run without one; the bundle's
counters equal the engine's own and JAX's bundle's on the same workload.
"""
import json

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs import get_config, reduce_for_smoke
from repro.core import xpeft as JXP
from repro.core.profiles import ProfileStore as JStore
from repro.models import init_lm as jinit_lm
from repro.obs import Observability as JObservability
from repro.obs import metrics as JMET
from repro.resilience import FaultPlan as JPlan
from repro.serve.engine import Request as JRequest
from repro.serve.engine import ServeEngine as JEngine
from repro_torch import bridge
from repro_torch import obs as OBS
from repro_torch.configs import get_config as tget_config
from repro_torch.configs import reduce_for_smoke as treduce
from repro_torch.core.profiles import ProfileStore
from repro_torch.obs import metrics as MET
from repro_torch.obs import trace as TR
from repro_torch.obs.metrics import ExpHistogram, MetricsRegistry, \
    StepWatchdog
from repro_torch.obs.sentinel import RetraceError, RetraceSentinel
from repro_torch.resilience import FaultPlan
from repro_torch.serve import Request, ServeEngine
from repro_torch.serve.engine import _rate

ARCH = "qwen1.5-0.5b"


# ---------------------------------------------------------------- histograms

def test_exp_histogram_percentiles():
    h = ExpHistogram(unit="us")
    for v in range(1, 1001):
        h.record(float(v))
    s = h.snapshot()
    assert s["count"] == 1000 and s["min"] == 1.0 and s["max"] == 1000.0
    # base 2**(1/8) bounds relative error at ~9%
    assert abs(s["p50"] - 500) / 500 < 0.10
    assert abs(s["p99"] - 990) / 990 < 0.10
    assert s["p50"] <= s["p95"] <= s["p99"] <= s["max"]


def test_exp_histogram_nonpositive_and_empty():
    h = ExpHistogram()
    assert h.snapshot() == {"count": 0, "unit": ""}
    assert h.percentile(50) == 0.0
    h.record(0.0)
    h.record(-3.0)
    h.record(5.0)
    # non-positive values pool in a sentinel bucket that reports 0.0;
    # the exact extremes survive in the snapshot min/max
    assert h.percentile(1) == 0.0
    assert h.percentile(100) == 5.0
    s = h.snapshot()
    assert s["min"] == -3.0 and s["max"] == 5.0


def test_registry_snapshot_and_disabled():
    reg = MetricsRegistry()
    reg.inc("a")
    reg.inc("a", 2)
    reg.set_gauge("g", 7)
    reg.observe("h", 10.0, "us")
    s = reg.snapshot()
    assert s["counters"]["a"] == 3 and s["gauges"]["g"] == 7.0
    assert s["histograms"]["h"]["count"] == 1
    reg.reset()
    assert reg.snapshot() == {"counters": {}, "gauges": {},
                              "histograms": {}}
    off = MetricsRegistry(enabled=False)
    off.inc("a")
    off.set_gauge("g", 1)
    off.observe("h", 1.0)
    assert off.snapshot() == {"counters": {}, "gauges": {},
                              "histograms": {}}


def test_registry_export(tmp_path):
    reg = MetricsRegistry()
    reg.observe("lat", 3.0, "us")
    p = tmp_path / "m.json"
    reg.export(str(p))
    assert json.loads(p.read_text())["histograms"]["lat"]["count"] == 1


# -------------------------------------------------------------------- tracer

def test_tracer_spans_export_and_validate(tmp_path):
    tr = OBS.SpanTracer()
    with tr.span(TR.CAT_ADMISSION, "admit_wave", offered=3) as sp:
        sp["admitted"] = 2  # the yielded dict IS the event's args
    tr.instant(TR.CAT_RESILIENCE, "degraded", profile=1)
    tr.complete(TR.CAT_DECODE_WINDOW, "w", 0.0, 0.5, steps=4)
    p = tmp_path / "trace.json"
    doc = tr.export(str(p))
    assert OBS.validate_chrome_trace(doc) is None
    assert OBS.validate_chrome_trace(json.loads(p.read_text())) is None
    evs = {e["name"]: e for e in tr.events()}
    assert evs["admit_wave"]["args"] == {"offered": 3, "admitted": 2}
    assert evs["admit_wave"]["ph"] == "X" and evs["degraded"]["ph"] == "i"
    assert evs["w"]["dur"] == pytest.approx(0.5e6)
    assert tr.category_counts() == {"admission": 1, "resilience": 1,
                                    "decode-window": 1}
    assert OBS.validate_chrome_trace({"traceEvents": [{"name": "x"}]})


def test_tracer_ring_bound_and_disabled():
    tr = OBS.SpanTracer(capacity=4)
    for i in range(10):
        tr.instant(TR.CAT_SPEC, f"e{i}")
    assert len(tr.events()) == 4 and tr.dropped == 6
    off = OBS.SpanTracer(enabled=False)
    with off.span(TR.CAT_PREFILL, "p", rows=2) as sp:
        sp["extra"] = 1  # must not raise on the disabled path
    off.instant(TR.CAT_SPEC, "i")
    assert off.events() == [] and off.category_counts() == {}


# ------------------------------------------------------------------ sentinel

def test_sentinel_budget_modes():
    n = {"traces": 1}
    s = RetraceSentinel(mode="raise")
    s.watch("step", lambda: n["traces"], budget=1)
    assert s.check() == []
    n["traces"] = 2
    with pytest.raises(RetraceError, match="step"):
        s.check()
    logged = []
    s2 = RetraceSentinel(mode="log", log=logged.append)
    s2.watch("step", lambda: n["traces"], budget=1)
    assert len(s2.check()) == 1 and s2.violations_seen == 1 and logged
    s3 = RetraceSentinel(mode="off")
    s3.watch("step", lambda: n["traces"], budget=1)
    assert s3.check() == [] and s3.violations_seen == 0


def test_sentinel_shape_polymorphic_contract():
    st = {"traces": 2, "shapes": 2}
    s = RetraceSentinel(mode="raise")
    s.watch("prefill", lambda: st["traces"],
            shapes_fn=lambda: st["shapes"])
    s.check()  # one trace per distinct shape: fine
    st["traces"] = 3  # same shape compiled twice = placement drift
    with pytest.raises(RetraceError, match="placement drift"):
        s.check()
    assert s.counts()["prefill"] == {"traces": 3, "budget": None,
                                     "shapes": 2}


def test_sentinel_drops_dead_watches():
    """count_fn -> None means the watched owner was collected (engines are
    held weakly); the watch must vanish instead of pinning or raising."""
    s = RetraceSentinel(mode="raise")
    owner = {"traces": 5}
    box = [owner]
    s.watch("eng", lambda: box[0]["traces"] if box[0] else None, budget=1)
    with pytest.raises(RetraceError):
        s.check()
    box[0] = None  # owner dies
    assert s.check() == [] and "eng" not in s.counts()


# ------------------------------------------------------- watchdog mirroring

def test_watchdog_mirrors_into_registry():
    reg = MetricsRegistry()
    t = {"now": 0.0}
    wd = StepWatchdog(clock=lambda: t["now"], registry=reg)
    wd.step_start()
    t["now"] = 0.010
    wd.step_end()
    wd.window_end(4, 0.040)
    h = reg.snapshot()["histograms"]["train.step_time_us"]
    assert h["count"] == 5 and h["p50"] == pytest.approx(10000, rel=0.1)


# ------------------------------------------------------------ bundle / null

def test_null_obs_is_inert():
    assert OBS.get(None) is OBS.NULL_OBS
    bundle = OBS.Observability(sentinel_mode="raise")
    assert OBS.get(bundle) is bundle
    null = OBS.NULL_OBS
    null.metrics.inc("x")
    with null.tracer.span(TR.CAT_SPEC, "s") as sp:
        sp["a"] = 1
    null.sentinel.watch("w", lambda: 99, budget=1)
    assert null.sentinel.check() == []  # off mode: never raises
    assert null.metrics.snapshot()["counters"] == {}
    assert null.tracer.events() == []


def test_rate_zero_denominator():
    assert _rate(0, 0) == 0.0
    assert _rate(5, 0) == 0.0  # pre-fix this leaked a div-by-zero guard
    assert _rate(5, 2) == 2.5
    assert _rate(1, 3, nd=2) == 0.33


# ------------------------------------------------------- device accumulator

def test_device_accumulator_matches_jax():
    rng = np.random.default_rng(0)
    acc = MET.device_acc_init(4, device="cpu")
    jacc = JMET.device_acc_init(4)
    assert acc.dtype == torch.int32 and tuple(acc.shape) == (4, MET.OBS_COLS)
    for _ in range(5):
        act = rng.random(4) < 0.6
        com = rng.integers(1, 4, 4).astype(np.int32)
        MET.device_acc_update(acc, torch.from_numpy(act),
                              torch.from_numpy(com))
        jacc = JMET.device_acc_update(jacc, jnp.asarray(act),
                                      jnp.asarray(com))
    assert acc.tolist() == np.asarray(jacc).tolist()
    assert (MET.OBS_TOKENS, MET.OBS_ACTIVE_STEPS, MET.OBS_STRANDED_STEPS,
            MET.OBS_COLS) == (JMET.OBS_TOKENS, JMET.OBS_ACTIVE_STEPS,
                              JMET.OBS_STRANDED_STEPS, JMET.OBS_COLS)


# ------------------------------------------------------------ serving

@pytest.fixture(scope="module")
def setup():
    out = {}
    hetero = dict(num_adapters=12, bottleneck=4, k=4, max_profiles=8,
                  bank_spec=(("bottleneck", 4), ("lora", 4), ("ia3", 2),
                             ("prefix", 2)), prefix_tokens=2)
    for label, xkw in (("base", {}), ("hetero", hetero)):
        cfg = reduce_for_smoke(get_config(ARCH)).with_xpeft(**xkw)
        tcfg = treduce(tget_config(ARCH)).with_xpeft(**xkw)
        key = jax.random.key(0)
        params = jax.jit(jinit_lm, static_argnums=1)(key, cfg)
        table = jax.tree.map(np.asarray, JXP.init_profile_table(key, cfg))
        xp = cfg.xpeft
        shape = (cfg.num_layers, xp.num_adapters, xp.bottleneck, "hard",
                 xp.k)
        js = JStore(*shape, bank_spec=xp.bank_spec)
        ts = ProfileStore(*shape, bank_spec=xp.bank_spec)
        for pid in range(3):
            row = {k: v[pid] for k, v in table.items()}
            js.add_profile(pid, row)
            ts.add_profile(pid, row)
        out[label] = dict(cfg=cfg, tcfg=tcfg, params=params, js=js, ts=ts,
                          tparams=bridge.to_torch(
                              jax.tree.map(np.asarray, params)))
    return out


# engine label -> (setup, config overrides, engine options)
MODES = {
    "windowed": ("base", {}, {}),
    "continuous": ("base", {}, {"continuous": True}),
    "spec": ("base", {"spec_enable": True, "spec_gamma": 2},
             {"continuous": True}),
    "decode_fused": ("base", {"decode_fused": True}, {}),
    "per_step": ("base", {}, {"precompute": False}),
    "hetero": ("hetero", {}, {"continuous": True}),
}


def _engine(setup, mode, *, port, **kw):
    which, ckw, ekw = MODES[mode]
    s = setup[which]
    cfg = (s["tcfg"] if port else s["cfg"]).with_(**ckw)
    return (ServeEngine if port else JEngine)(
        cfg, s["tparams"] if port else s["params"],
        s["ts"] if port else s["js"], max_slots=2, max_seq=64,
        **dict(ekw, **kw))


def _requests(cls, vocab, n=5):
    rng = np.random.default_rng(0)
    return [cls(uid=i, prompt=rng.integers(0, vocab, 5 + i),
                profile_id=i % 3, max_new_tokens=4) for i in range(n)]


def _keyset(d, prefix=""):
    out = set()
    for k, v in d.items():
        out.add(prefix + k)
        if isinstance(v, dict) and k not in ("per_request_acceptance",):
            out |= _keyset(v, prefix + k + ".")
    return out


@pytest.mark.parametrize("mode", sorted(MODES))
def test_serve_stats_keys_equal_jax_minus_step_traces(setup, mode):
    """The same keys (nested ones too) as JAX's engine in the same mode,
    on a fresh engine (every rate 0.0 on a zero denominator) and after a
    drain; JAX's ``step_traces`` alone is absent."""
    eng = _engine(setup, mode, port=True)
    jeng = _engine(setup, mode, port=False)
    for drained in (False, True):
        if drained:
            vocab = setup[MODES[mode][0]]["cfg"].vocab_size
            eng.run_until_drained(_requests(Request, vocab))
            jeng.run_until_drained(_requests(JRequest, vocab))
        st, jst = eng.serve_stats(), jeng.serve_stats()
        assert _keyset(st) == _keyset(jst) - {"step_traces"}, mode
        for key, v in jst.items():
            if key != "step_traces":
                assert type(st[key]) is type(v), (mode, key)
        if not drained:
            for key in ("slot_occupancy", "committed_per_device_step",
                        "syncs_per_token", "prefill_occupancy"):
                assert st[key] == 0.0, (mode, key)
        else:
            for key in ("decode_tokens", "device_steps", "host_syncs",
                        "degraded_requests", "degraded_slots"):
                assert st[key] == jst[key], (mode, key)
    assert st["resident_bytes_per_device"]["total"] == sum(
        v for k, v in st["resident_bytes_per_device"].items()
        if k != "total")


@pytest.mark.parametrize("mode", sorted(MODES))
def test_obs_on_equals_off(setup, mode):
    """An attached bundle changes neither tokens nor host syncs; its
    counters agree with the engine's and with JAX's bundle."""
    vocab = setup[MODES[mode][0]]["cfg"].vocab_size
    runs = []
    for bundle in (None, OBS.Observability(sentinel_mode="raise")):
        eng = _engine(setup, mode, port=True, obs=bundle, sync_every=3)
        reqs = _requests(Request, vocab)
        eng.submit(reqs)
        eng.run_until_drained()
        runs.append(([r.generated for r in reqs],
                     eng.serve_stats()["host_syncs"], eng, bundle))
    assert runs[0][:2] == runs[1][:2]
    eng, bundle = runs[1][2], runs[1][3]
    counters = bundle.metrics.snapshot()["counters"]
    assert counters["serve.decode_tokens"] == eng.decode_tokens
    assert counters["serve.device_steps"] == eng.slots.device_steps
    jbundle = JObservability()
    jeng = _engine(setup, mode, port=False, obs=jbundle, sync_every=3)
    jreqs = _requests(JRequest, vocab)
    jeng.submit(jreqs)
    jeng.run_until_drained()
    jcounters = jbundle.metrics.snapshot()["counters"]
    assert counters == jcounters
    hists = bundle.metrics.snapshot()["histograms"]
    assert hists["serve.ttft_us"]["count"] == len(runs[1][0])
    assert bundle.tracer.category_counts().keys() == \
        jbundle.tracer.category_counts().keys()


def test_degraded_engine_stats_obs_and_reset(setup, tmp_path):
    """A drained engine with a fault plan and a bundle: the degraded path
    keeps the key set and counts its fallback requests; the bundle agrees
    with the engine and traced every category the workload exercised,
    with a valid Chrome trace; ``reset_stats()`` zeroes every counter in
    one call and keeps the profile cache warm."""
    s = setup["base"]
    bundle = OBS.Observability(sentinel_mode="raise")
    eng = ServeEngine(s["tcfg"], s["tparams"], s["ts"], max_slots=2,
                      max_seq=64, sync_every=4,
                      fault_plan=FaultPlan(fail_pids=(2,)), obs=bundle)
    jeng = JEngine(s["cfg"], s["params"], s["js"], max_slots=2,
                   max_seq=64, sync_every=4,
                   fault_plan=JPlan(fail_pids=(2,)))
    reqs = _requests(Request, s["cfg"].vocab_size)
    jreqs = _requests(JRequest, s["cfg"].vocab_size)
    eng.run_until_drained(list(reqs))
    jeng.run_until_drained(list(jreqs))
    assert all(r.done for r in reqs)
    assert [r.generated for r in reqs] == [r.generated for r in jreqs]
    st = eng.serve_stats()
    jst = jeng.serve_stats()
    assert _keyset(st) == _keyset(jst) - {"step_traces"}
    assert st["degraded_requests"] == jst["degraded_requests"] == 1
    assert all(r.degraded == (r.profile_id == 2) for r in reqs)
    counters = bundle.metrics.snapshot()["counters"]
    assert counters["serve.decode_tokens"] == eng.decode_tokens
    assert counters["serve.degraded_requests"] == st["degraded_requests"]
    cats = bundle.tracer.category_counts()
    for cat in (TR.CAT_ADMISSION, TR.CAT_PREFILL, TR.CAT_DECODE_WINDOW,
                TR.CAT_RESILIENCE):
        assert cats.get(cat, 0) > 0, f"no {cat} spans traced"
    hists = bundle.metrics.snapshot()["histograms"]
    assert "serve.decode_token_us" in hists
    assert bundle.sentinel.counts() == {}
    bundle.export(str(tmp_path / "m.json"), str(tmp_path / "t.json"))
    doc = json.loads((tmp_path / "t.json").read_text())
    assert OBS.validate_chrome_trace(doc) is None
    assert json.loads((tmp_path / "m.json").read_text())["counters"] == \
        counters
    eng.reset_stats()
    st2 = eng.serve_stats()
    for key in ("decode_tokens", "host_syncs", "device_steps",
                "prefill_batches", "useful_slot_steps",
                "stranded_slot_steps", "degraded_requests",
                "hydration_retries", "slot_occupancy", "syncs_per_token",
                "committed_per_device_step", "prefill_occupancy"):
        assert st2[key] == 0, f"reset_stats left {key} = {st2[key]}"
    assert st2["profile_cache"]["hits"] == 0
    assert st2["profile_cache"]["entries"] > 0
    assert st2["scheduler"]["submitted"] == 0
    assert bundle.metrics.snapshot()["counters"] == {}


def test_launchers_obs_flags(tmp_path):
    """Both launchers write the metrics JSON and a valid Chrome trace (the
    training launcher through its Trainer: one gang_window span per
    flushed window, the train.steps counter)."""
    from repro_torch.launch import serve as LS
    from repro_torch.launch import train as LT
    m, t = tmp_path / "m.json", tmp_path / "t.json"
    LS.main(["--smoke", "--device", "cpu", "--requests", "3",
             "--max-new", "3", "--metrics-json", str(m), "--trace", str(t)])
    assert json.loads(m.read_text())["counters"]["serve.decode_tokens"] > 0
    assert OBS.validate_chrome_trace(json.loads(t.read_text())) is None
    m2, t2 = tmp_path / "m2.json", tmp_path / "t2.json"
    import signal
    saved = {s: signal.getsignal(s) for s in (signal.SIGTERM, signal.SIGINT)}
    try:  # main installs a PreemptionHandler: restore the handlers after
        LT.main(["--smoke", "--device", "cpu", "--steps", "3", "--batch",
                 "2", "--seq", "8", "--metrics-json", str(m2), "--trace",
                 str(t2)])
    finally:
        for s, h in saved.items():
            signal.signal(s, h)
    assert json.loads(m2.read_text())["counters"]["train.steps"] == 3
    doc = json.loads(t2.read_text())
    assert OBS.validate_chrome_trace(doc) is None
    assert any(e.get("name") == "gang_window" for e in doc["traceEvents"])
