"""The port's continuous-batching engine (paged KV + pooled mask entries,
preempt/resume) against its windowed engine and the JAX package's
continuous engine, on the CPU.

Workload: ``benchmarks/cb_smoke.py``'s skewed requests (copied here, not
imported): per-uid seeded prompts of 3-12 tokens, 3 profiles, every third
request long, the rest 2 new tokens; reduced qwen1.5-0.5b at float32 with
JAX's weights and profile logits carried across by the bridge; 2 slots,
max_seq 64, sync_every 4, page_size 16.

Contracts (the JAX package's, kept within the port): per-request greedy
tokens EQUAL to the windowed engine's, to the last token, also under a
starved page pool that forces preempt/resume, for every mask form the
windowed engine serves (bf16 records, ``decode_fused``, int8/int4
records, typed heterogeneous entries with prefix rows, per-step mask
weights); strictly fewer stranded slot steps and device steps than
windowed; the allocators' audit passes after the drain. Against JAX's
continuous engine: tokens, preemptions, resumes and the step counts
EQUAL (at float32 the two frameworks agree to ~1e-6 and no greedy token
of this workload sits on a closer tie).
"""
import numpy as np
import jax
import pytest

from repro.configs import get_config, reduce_for_smoke
from repro.core import xpeft as JXP
from repro.core.profiles import ProfileStore as JStore
from repro.models import init_lm as jinit_lm
from repro.serve.engine import Request as JRequest
from repro.serve.engine import ServeEngine as JEngine
from repro_torch import bridge
from repro_torch.configs import get_config as tget_config
from repro_torch.configs import reduce_for_smoke as treduce
from repro_torch.core.profiles import ProfileStore as TStore
from repro_torch.serve import Request as TRequest
from repro_torch.serve import ServeEngine as TEngine

ARCH = "qwen1.5-0.5b"
N_PROFILES = 3
ENGINE = dict(max_slots=2, max_seq=64, sync_every=4, page_size=16)
HETERO = dict(num_adapters=12, bottleneck=4, k=4, max_profiles=8,
              bank_spec=(("bottleneck", 4), ("lora", 4), ("ia3", 2),
                         ("prefix", 2)),
              prefix_tokens=2)


def skewed_requests(cls, vocab, n, *, seed=0, long_every=3, short_new=2,
                    long_new=40):
    """Per-uid seeded prompts with a skewed token budget: 1 in
    ``long_every`` requests decodes long (``benchmarks/cb_smoke.py``)."""
    reqs = []
    for i in range(n):
        r = np.random.default_rng(seed * 7919 + i)
        T = int(r.integers(3, 13))
        reqs.append(cls(
            uid=i, prompt=r.integers(0, vocab, T), profile_id=i % 3,
            max_new_tokens=long_new if i % long_every == 0 else short_new))
    return reqs


def _stores(cfg, rows, **kw):
    xp = cfg.xpeft
    shape = (cfg.num_layers, xp.num_adapters, xp.bottleneck, "hard", xp.k)
    js, ts = JStore(*shape, **kw), TStore(*shape, **kw)
    for pid, row in enumerate(rows):
        js.add_profile(pid, row)
        ts.add_profile(pid, row)
    return js, ts


def _setup(xpeft_kw=None, craft=None):
    cfg = reduce_for_smoke(get_config(ARCH))
    tcfg = treduce(tget_config(ARCH))
    if xpeft_kw:
        cfg, tcfg = cfg.with_xpeft(**xpeft_kw), tcfg.with_xpeft(**xpeft_kw)
    key = jax.random.key(0)
    params = jax.jit(jinit_lm, static_argnums=1)(key, cfg)
    table = jax.tree.map(np.asarray, JXP.init_profile_table(key, cfg))
    rows = [{k: np.array(v[pid]) for k, v in table.items()}
            for pid in range(N_PROFILES)]
    if craft:
        craft(rows, cfg.xpeft)
    return dict(cfg=cfg, tcfg=tcfg, params=params, rows=rows,
                tparams=bridge.to_torch(jax.tree.map(np.asarray, params)),
                runs={})


@pytest.fixture(scope="module")
def setup():
    return _setup()


def _craft_prefix(rows, xp):
    """Profile 1 selects no prefix slot (its prompt at cache slot 0),
    profile 2 one on even layers only, profile 0 as drawn."""
    off, cnt = next((o, c) for t, o, c in xp.segments() if t == "prefix")
    for m in ("mA", "mB"):
        rows[1][m][:, off:off + cnt] = -30.0
        rows[2][m][1::2, off:off + cnt] = -30.0
        rows[2][m][0::2, off] = 30.0


@pytest.fixture(scope="module")
def hetero_setup():
    return _setup(HETERO, _craft_prefix)


def drain(s, *, port, continuous, n=6, long_new=20, cfg_kw=None,
          xpeft_kw=None, store_kw=None, **kw):
    """Drain the skewed workload; memoized per setup and options."""
    key = (port, continuous, n, long_new, repr(cfg_kw), repr(xpeft_kw),
           repr(store_kw), repr(sorted(kw.items())))
    if key in s["runs"]:
        return s["runs"][key]
    cfg = s["tcfg"] if port else s["cfg"]
    cfg = cfg.with_(**(cfg_kw or {})).with_xpeft(**(xpeft_kw or {}))
    store_kw = dict(store_kw or {})
    if cfg.xpeft.is_hetero:
        store_kw["bank_spec"] = cfg.xpeft.bank_spec
    store = _stores(cfg, s["rows"], **store_kw)[int(port)]
    eng = (TEngine if port else JEngine)(
        cfg, s["tparams"] if port else s["params"], store,
        continuous=continuous, **dict(ENGINE, **kw))
    reqs = skewed_requests(TRequest if port else JRequest, cfg.vocab_size,
                           n, long_new=long_new)
    eng.run_until_drained(list(reqs))
    assert all(r.done for r in reqs)
    out = (eng, {r.uid: list(map(int, r.generated)) for r in reqs}, reqs)
    s["runs"][key] = out
    return out


def test_cb_tokens_equal_windowed_and_jax(setup):
    weng, wtoks, _ = drain(setup, port=True, continuous=False)
    eng, toks, _ = drain(setup, port=True, continuous=True)
    jeng, jtoks, _ = drain(setup, port=False, continuous=True)
    assert toks == wtoks
    assert toks == jtoks
    st, jst, wst = eng.serve_stats(), jeng.serve_stats(), weng.serve_stats()
    # short requests stop waiting out the wave's straggler
    assert st["stranded_slot_steps"] < wst["stranded_slot_steps"]
    assert st["device_steps"] < wst["device_steps"]
    assert st["slot_occupancy"] > wst["slot_occupancy"]
    for key in ("mode", "useful_slot_steps", "stranded_slot_steps",
                "slot_occupancy", "device_steps", "host_syncs",
                "decode_tokens", "committed_tokens",
                "committed_per_device_step", "prefill_batches",
                "prefill_occupancy", "preemptions", "resumes",
                "resume_pending", "page_size", "pages", "mask_entries"):
        assert st[key] == jst[key], key
    assert wst["stranded_slot_steps"] == \
        drain(setup, port=False, continuous=False)[0].serve_stats()[
            "stranded_slot_steps"]
    assert eng.scheduler.policy == "efficiency"
    assert eng.scheduler.max_wait_waves == 4
    eng.page_alloc.check()
    eng.mask_alloc.check()
    assert eng.page_alloc.used() == eng.mask_alloc.used() == 0


def test_preempt_resume_bitwise(setup):
    """A starved pool (5 pages, where a long and a short request want up
    to 4 + 2) forces swaps to the host; resumed requests decode bitwise
    the windowed tokens, with JAX's counts."""
    _, ref, _ = drain(setup, port=True, continuous=False, long_new=50)
    eng, toks, _ = drain(setup, port=True, continuous=True, long_new=50,
                         max_pages=5)
    jeng, jtoks, _ = drain(setup, port=False, continuous=True, long_new=50,
                           max_pages=5)
    st, jst = eng.serve_stats(), jeng.serve_stats()
    assert st["preemptions"] > 0 and st["resumes"] > 0
    assert toks == ref == jtoks
    for key in ("preemptions", "resumes", "device_steps", "pages",
                "stranded_slot_steps"):
        assert st[key] == jst[key], key
    eng.page_alloc.check()
    assert st["pages"]["high_water"] <= 5


@pytest.mark.parametrize("form", ["decode_fused", "int8", "int4",
                                  "per_step", "disabled"])
def test_mask_forms_continuous_equal_windowed(setup, form):
    kw = dict(long_new=50, max_pages=5)
    if form == "decode_fused":
        kw["cfg_kw"] = dict(decode_fused=True)
    elif form in ("int8", "int4"):
        kw["xpeft_kw"] = dict(bank_quant=form)
        kw["store_kw"] = dict(quant=form)
    elif form == "per_step":
        kw["precompute"] = False
    else:
        kw["xpeft_kw"] = dict(enabled=False)
    eng, toks, _ = drain(setup, port=True, continuous=True, **kw)
    kw.pop("max_pages")
    _, ref, _ = drain(setup, port=True, continuous=False, **kw)
    assert toks == ref
    st = eng.serve_stats()
    assert st["preemptions"] > 0 and st["resumes"] > 0
    eng.page_alloc.check()
    if form == "disabled":
        assert eng.mask_alloc is None and "mask_entries" not in st
        return
    eng.mask_alloc.check()
    pool = eng.masks["pool"]
    if form in ("int8", "int4"):
        assert sorted(pool) == ["a_q", "a_scale", "b_q", "b_scale",
                                "ln_bias", "ln_scale"]
    elif form == "per_step":
        assert sorted(pool) == ["ln_bias", "ln_scale", "w_a", "w_b"]


def test_hetero_prefix_continuous_equal_windowed_and_jax(hetero_setup):
    """Typed entries with prefix rows: pages cover each request's prefix
    rows, and the tokens equal the windowed engine's and JAX's continuous
    engine's (``tests/test_hetero.py``'s continuous engine)."""
    s = hetero_setup
    eng, toks, reqs = drain(s, port=True, continuous=True, long_new=30,
                            max_pages=6)
    _, ref, wreqs = drain(s, port=True, continuous=False, long_new=30)
    _, jtoks, jreqs = drain(s, port=False, continuous=True, long_new=30,
                            max_pages=6)
    assert toks == ref == jtoks
    assert [r.prefix_len for r in reqs] == [r.prefix_len for r in wreqs] \
        == [r.prefix_len for r in jreqs]
    assert {r.prefix_len for r in reqs} == {0, 2}
    st = eng.serve_stats()
    assert st["preemptions"] == drain(s, port=False, continuous=True,
                                      long_new=30, max_pages=6)[0] \
        .serve_stats()["preemptions"]
    assert "prefix_skip" in eng.masks["pool"]
    eng.page_alloc.check()
    eng.mask_alloc.check()


def test_pages_cover_prefix_rows(hetero_setup):
    s = hetero_setup
    cfg = s["tcfg"]
    ts = _stores(cfg, s["rows"], bank_spec=cfg.xpeft.bank_spec)[1]
    eng = TEngine(cfg, s["tparams"], ts, continuous=True,
                  **dict(ENGINE, page_size=4))
    reqs = [TRequest(uid=i, prompt=np.arange(2, 6), profile_id=i,
                     max_new_tokens=8) for i in range(2)]
    eng.admit_many(reqs)
    for slot, r in enumerate(reqs):
        held = eng.page_alloc.pages_of(r.uid)
        # prefix + prompt + the window's writes, in pages of 4
        want = -(-(r.prefix_len + 4 + eng._window - 1) // 4)
        assert len(held) == max(want, -(-(r.prefix_len + 4) // 4))
        assert list(eng._page_table_h[slot, :len(held)]) == held
    assert [r.prefix_len for r in reqs] == [2, 0]


def test_abort_all_frees_everything(setup):
    eng = TEngine(setup["tcfg"], setup["tparams"],
                  _stores(setup["tcfg"], setup["rows"])[1], continuous=True,
                  **dict(ENGINE, max_pages=5))
    reqs = skewed_requests(TRequest, setup["tcfg"].vocab_size, 6,
                           long_new=50)
    eng.submit(reqs)
    for _ in range(40):
        if eng.free_slots() and eng.scheduler.pending():
            eng.admit_many(eng.scheduler.next_batch(len(eng.free_slots())))
        eng.step()
        if eng.serve_stats()["resume_pending"]:
            break
    assert eng.serve_stats()["resume_pending"] > 0
    eng.abort_all()
    assert eng.active_count() == 0
    assert eng.serve_stats()["resume_pending"] == 0
    assert eng.page_alloc.used() == eng.mask_alloc.used() == 0
    eng.page_alloc.check()
    eng.mask_alloc.check()
