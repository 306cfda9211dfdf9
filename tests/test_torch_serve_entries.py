"""The port's continuous engine with a mask-entry pool smaller (or larger)
than its slot count (``mask_pages``) and the scheduler's promotion bound
(``max_wait_waves``), against the JAX package's engine on the CPU.

Workload: ``tests/test_torch_serve_continuous.py``'s (the skewed requests
of ``benchmarks/cb_smoke.py``, reduced qwen1.5-0.5b at float32 with JAX's
weights carried across, 2 slots, max_seq 64, sync_every 4, page_size 16).

An entry is one admitted request's aggregated Â/B̂ record; a request that
gets none goes back to the head of the queue and ages there, and a resume
whose entry or pages do not fit blocks the resume queue. Contracts, each
option against JAX's engine at the same options: tokens, device steps,
prefill batches, stranded slot steps, the entry allocator's and the
scheduler's counters, and the wave sequence (the uids of every
``next_batch``) EQUAL; tokens equal to the windowed engine's for every
mask form, through preempt/resume where pages starve; JAX's ValueError.
"""
import pytest
import torch

from repro.serve.engine import Request as JRequest
from repro.serve.engine import ServeEngine as JEngine
from repro_torch.configs import get_config as tget_config
from repro_torch.configs import reduce_for_smoke as treduce
from repro_torch.core import xpeft as TXP
from repro_torch.models import init_lm as tinit_lm
from repro_torch.serve import Request as TRequest
from repro_torch.serve import ServeEngine as TEngine

from test_torch_serve_continuous import (ENGINE, HETERO, _craft_prefix,
                                         _setup, _stores, skewed_requests)

STATS = ("device_steps", "prefill_batches", "stranded_slot_steps",
         "mask_entries", "scheduler", "preemptions", "resumes")
# the engine options of each compared run, on 12 requests (long ones 20
# new tokens), and what JAX's engine does there: (device steps, prefill
# batches, promoted, requeued)
OPTIONS = {
    "defaults": ({}, (42, 8, 0, 0)),
    "max_wait_waves_2": ({"max_wait_waves": 2}, (42, 8, 6, 0)),
    "max_wait_waves_1": ({"max_wait_waves": 1}, (42, 9, 8, 0)),
    "mask_pages_1": ({"mask_pages": 1}, (84, 12, 81, 83)),
    "mask_pages_1_max_wait_waves_2": (
        {"mask_pages": 1, "max_wait_waves": 2}, (84, 12, 83, 83)),
    "windowed_max_wait_waves_1": (
        {"continuous": False, "max_wait_waves": 1}, (48, 9, 8, 0)),
    "mask_pages_3": ({"mask_pages": 3}, (42, 8, 0, 0)),
    "slots_4_mask_pages_2": ({"max_slots": 4, "mask_pages": 2},
                             (42, 8, 41, 82)),
}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The port's drains on one intra-op thread: the reduced model's ops
    are too small to gain from more, and idle workers spin on cores that
    parallel test processes share. Restored after the module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def setup():
    return dict(_setup(), jax_engines={})


def _port_setup(arch="qwen1.5-0.5b", xpeft_kw=None, craft=None):
    """A port-only setup (weights and profile rows from the port's own
    seeded init) for runs held to the port's windowed engine."""
    cfg = treduce(tget_config(arch)).with_xpeft(**(xpeft_kw or {}))
    table = TXP.init_profile_table(cfg, seed=0)
    rows = [{k: v[pid].numpy() for k, v in table.items()}
            for pid in range(3)]
    if craft:
        craft(rows, cfg.xpeft)
    return dict(tcfg=cfg, tparams=tinit_lm(cfg, seed=0, device="cpu"),
                rows=rows, runs={})


@pytest.fixture(scope="module")
def hetero_setup():
    return _port_setup(xpeft_kw=HETERO, craft=_craft_prefix)


def _jax_engine(s, cfg, continuous, store_kw, kw):
    """JAX's engine for ``kw``. Its steps compile per engine (~4 s each
    on the CPU), so runs that differ in ``max_wait_waves`` alone drain on
    one engine: its scheduler's bound set as JAX's constructor sets it,
    its counters reset, before each drain."""
    kw = dict(ENGINE, **kw)
    waves = kw.pop("max_wait_waves", None)
    key = (repr(cfg), continuous, repr(store_kw), repr(sorted(kw.items())))
    if key not in s["jax_engines"]:
        store = _stores(cfg, s["rows"], **store_kw)[0]
        s["jax_engines"][key] = JEngine(cfg, s["params"], store,
                                        continuous=continuous, **kw)
    eng = s["jax_engines"][key]
    eng.scheduler.max_wait_waves = 4 if waves is None and continuous \
        else waves
    eng.reset_stats()
    return eng


def drain(s, *, port, continuous=True, n=12, long_new=20, cfg_kw=None,
          xpeft_kw=None, store_kw=None, **kw):
    """Drain the skewed workload, recording each wave's uids; memoized
    per setup and options."""
    key = (port, continuous, n, long_new, repr(cfg_kw), repr(xpeft_kw),
           repr(store_kw), repr(sorted(kw.items())))
    if key in s["runs"]:
        return s["runs"][key]
    cfg = (s["tcfg"] if port else s["cfg"]).with_(**(cfg_kw or {}))
    cfg = cfg.with_xpeft(**(xpeft_kw or {}))
    store_kw = dict(store_kw or {})
    if cfg.xpeft.is_hetero:
        store_kw["bank_spec"] = cfg.xpeft.bank_spec
    if port:
        eng = TEngine(cfg, s["tparams"], _stores(cfg, s["rows"],
                                                 **store_kw)[1],
                      continuous=continuous, **dict(ENGINE, **kw))
    else:
        eng = _jax_engine(s, cfg, continuous, store_kw, kw)
    waves, next_batch = [], eng.scheduler.next_batch

    def record(k):
        out = next_batch(k)
        waves.append([r.uid for r in out])
        return out

    eng.scheduler.next_batch = record
    reqs = skewed_requests(TRequest if port else JRequest, cfg.vocab_size,
                           n, long_new=long_new)
    eng.run_until_drained(list(reqs))
    del eng.scheduler.next_batch
    assert all(r.done for r in reqs)
    st = eng.serve_stats()
    out = dict(eng=eng, waves=waves,
               tokens={r.uid: list(map(int, r.generated)) for r in reqs},
               stats={k: st.get(k) for k in STATS})
    s["runs"][key] = out
    return out


@pytest.mark.parametrize("name", list(OPTIONS))
def test_options_equal_jax(setup, name):
    kw, (steps, batches, promoted, requeued) = OPTIONS[name]
    got = drain(setup, port=True, **kw)
    ref = drain(setup, port=False, **kw)
    assert got["tokens"] == ref["tokens"]
    # the options move admissions, never a request's greedy tokens
    assert got["tokens"] == drain(setup, port=True,
                                  continuous=False)["tokens"]
    assert got["stats"] == ref["stats"]
    assert got["waves"] == ref["waves"]
    st = got["stats"]
    assert (st["device_steps"], st["prefill_batches"],
            st["scheduler"]["promoted"], st["scheduler"]["requeued"]) == \
        (steps, batches, promoted, requeued)
    eng = got["eng"]
    assert eng.scheduler.max_wait_waves == kw.get(
        "max_wait_waves", 4 if kw.get("continuous", True) else None)
    if not eng.continuous:
        assert eng.mask_alloc is None and st["mask_entries"] is None
        return
    entries = kw.get("mask_pages", kw.get("max_slots", 2))
    assert st["mask_entries"]["n_pages"] == entries
    assert st["mask_entries"]["high_water"] <= entries
    assert (st["mask_entries"]["oom_events"] > 0) == (requeued > 0)
    assert all(v.shape[0] == entries for v in eng.masks["pool"].values())
    assert all(v.shape[0] == eng.n_slots for v in eng._masks_view.values())
    eng.mask_alloc.check()
    eng.page_alloc.check()
    assert eng.mask_alloc.used() == eng.page_alloc.used() == 0


def test_mask_pages_below_one_raises(setup):
    for port in (True, False):
        cfg = setup["tcfg"] if port else setup["cfg"]
        store = _stores(cfg, setup["rows"])[int(port)]
        params = setup["tparams"] if port else setup["params"]
        Eng = TEngine if port else JEngine
        with pytest.raises(ValueError, match="mask_pages must be >= 1"):
            Eng(cfg, params, store, continuous=True, mask_pages=0, **ENGINE)
        # a windowed engine takes the option and ignores it
        Eng(cfg, params, store, continuous=False, mask_pages=0, **ENGINE)


FORMS = {
    "decode_fused": dict(cfg_kw=dict(decode_fused=True)),
    "int8": dict(xpeft_kw=dict(bank_quant="int8"),
                 store_kw=dict(quant="int8")),
    "int4": dict(xpeft_kw=dict(bank_quant="int4"),
                 store_kw=dict(quant="int4")),
    "per_step": dict(precompute=False),
    "hetero": {},
    "disabled": dict(xpeft_kw=dict(enabled=False)),
}


@pytest.mark.parametrize("form", list(FORMS))
def test_one_entry_on_a_starved_page_pool(setup, hetero_setup, form):
    """One entry for two slots on a 5-page pool: one request runs at a
    time (the other slot waits for the entry) with every mask form's
    record in the pool, and its tokens equal the windowed engine's.
    Without X-PEFT there is no entry to wait for, so both slots run and
    the pages starve (preempt/resume)."""
    s = hetero_setup if form == "hetero" else setup
    kw = dict(FORMS[form], n=6, long_new=50)
    got = drain(s, port=True, max_pages=5, mask_pages=1, **kw)
    assert got["tokens"] == drain(s, port=True, continuous=False,
                                  **kw)["tokens"]
    eng, st = got["eng"], got["stats"]
    eng.page_alloc.check()
    if form == "disabled":
        assert eng.mask_alloc is None and st["mask_entries"] is None
        assert st["preemptions"] > 0 and st["resumes"] > 0
        return
    eng.mask_alloc.check()
    assert st["mask_entries"]["high_water"] == 1
    assert st["mask_entries"]["oom_events"] > 0
    assert st["scheduler"]["requeued"] > 0
    assert all(v.shape[0] == 1 for v in eng.masks["pool"].values())
    if form == "hetero":
        assert "prefix_skip" in eng.masks["pool"]


def test_two_entries_for_three_slots_preempt_like_jax(setup):
    """Two entries for three slots on a 5-page pool: the two long
    requests that hold the entries outgrow the pages, the younger swaps
    out with its record, and its resume waits for both an entry and
    pages. Tokens, swaps and every counter equal JAX's."""
    kw = dict(n=6, long_new=50, max_pages=5, max_slots=3, mask_pages=2)
    got, ref = drain(setup, port=True, **kw), drain(setup, port=False, **kw)
    assert got["stats"]["preemptions"] > 0 and got["stats"]["resumes"] > 0
    assert got["stats"]["mask_entries"]["oom_events"] > 0
    assert got["tokens"] == ref["tokens"] == drain(
        setup, port=True, continuous=False, n=6, long_new=50)["tokens"]
    assert got["stats"] == ref["stats"]
    assert got["waves"] == ref["waves"]
    got["eng"].mask_alloc.check()
    got["eng"].page_alloc.check()


def test_spec_with_one_entry_equals_plain(setup):
    """Speculation at one entry: the drafts' zero view stays slot-sized,
    the verify reads the pooled record; tokens bitwise the plain engine's
    (the port's float32 contract)."""
    spec = dict(spec_enable=True, spec_gamma=3)
    got = drain(setup, port=True, mask_pages=1, cfg_kw=spec)
    assert got["tokens"] == drain(setup, port=True)["tokens"]
    eng = got["eng"]
    assert all(v.shape[0] == 1 for v in eng.masks["pool"].values())
    assert all(v.shape[0] == 2 for v in eng._zero_view.values())
    assert eng.serve_stats()["spec"]["drafted"] > 0
    eng.mask_alloc.check()


def test_rwkv_one_entry_equals_windowed():
    """Reduced rwkv6-7b: no paged cache leaf, so entries are the only pool
    the continuous engine waits on."""
    s = _port_setup("rwkv6-7b")
    toks = []
    for kw in (dict(continuous=False), dict(continuous=True, mask_pages=1)):
        eng = TEngine(s["tcfg"], s["tparams"],
                      _stores(s["tcfg"], s["rows"])[1], **dict(ENGINE, **kw))
        reqs = skewed_requests(TRequest, s["tcfg"].vocab_size, 5,
                               long_new=12)
        eng.run_until_drained(list(reqs))
        toks.append({r.uid: list(map(int, r.generated)) for r in reqs})
    assert toks[0] == toks[1]
    st = eng.serve_stats()
    assert eng.page_alloc is None
    assert st["mask_entries"]["high_water"] == 1
    assert st["mask_entries"]["oom_events"] > 0
    eng.mask_alloc.check()
