"""The port's self-speculative decoding against its own plain continuous
engine and the JAX package's speculative engine, on the CPU.

Workload: ``tests/test_torch_serve_continuous.py``'s (the skewed requests
of ``benchmarks/cb_smoke.py``, reduced qwen1.5-0.5b at float32 with JAX's
weights carried across, 2 slots, max_seq 64, sync_every 4, page_size 16).

Contracts: greedy tokens of a speculative engine (gamma 1 and 3, bf16
records; gamma 2 over int8/int4 records; gamma 3 through forced
preempt/resume) EQUAL the plain engine's per request, in fewer device
steps with more than one committed token per step; the drafted and
accepted counts, per request too, EQUAL JAX's; JAX's ValueErrors are the
port's.
"""
import numpy as np
import pytest

from repro_torch.configs import get_config as tget_config
from repro_torch.configs import reduce_for_smoke as treduce
from repro_torch.core.profiles import ProfileStore as TStore
from repro_torch.serve import ServeEngine as TEngine

from test_torch_serve_continuous import HETERO, _setup, drain


@pytest.fixture(scope="module")
def setup():
    return _setup()


def spec_kw(gamma):
    return dict(cfg_kw=dict(spec_enable=gamma > 0, spec_gamma=max(gamma, 1)))


@pytest.mark.parametrize("gamma", [1, 3])
def test_spec_tokens_equal_plain_and_counts_equal_jax(setup, gamma):
    plain, ref, _ = drain(setup, port=True, continuous=True)
    eng, toks, _ = drain(setup, port=True, continuous=True, **spec_kw(gamma))
    jeng, jtoks, _ = drain(setup, port=False, continuous=True,
                           **spec_kw(gamma))
    assert toks == ref == jtoks
    st, jst = eng.serve_stats(), jeng.serve_stats()
    # the same tokens in fewer device steps
    assert st["device_steps"] < plain.serve_stats()["device_steps"]
    assert st["committed_per_device_step"] > 1.0
    assert st["committed_tokens"] == st["decode_tokens"]
    assert st["spec"]["gamma"] == gamma and st["spec"]["drafted"] > 0
    assert 0.0 <= st["spec"]["acceptance_rate"] <= 1.0
    assert st["spec"] == jst["spec"]
    for key in ("device_steps", "host_syncs", "stranded_slot_steps",
                "useful_slot_steps", "committed_per_device_step"):
        assert st[key] == jst[key], key
    eng.page_alloc.check()


def test_spec_through_preempt_resume(setup):
    """A 5-page pool and long budgets force swaps mid-generation: stale
    speculative KV past the commit point must never survive a swap."""
    _, ref, _ = drain(setup, port=True, continuous=False, long_new=50)
    eng, toks, _ = drain(setup, port=True, continuous=True, long_new=50,
                         max_pages=5, **spec_kw(3))
    jeng, jtoks, _ = drain(setup, port=False, continuous=True, long_new=50,
                           max_pages=5, **spec_kw(3))
    st = eng.serve_stats()
    assert st["preemptions"] > 0 and st["resumes"] > 0
    assert toks == ref == jtoks
    for key in ("preemptions", "resumes", "spec", "device_steps"):
        assert st[key] == jeng.serve_stats()[key], key
    eng.page_alloc.check()
    eng.mask_alloc.check()


@pytest.mark.parametrize("quant", ["int8", "int4"])
def test_spec_quantized_records(setup, quant):
    """Drafts read the zero quantized record (the exact bare PLM), the
    verify the slot's int8/int4 record."""
    kw = dict(xpeft_kw=dict(bank_quant=quant), store_kw=dict(quant=quant))
    _, ref, _ = drain(setup, port=True, continuous=True, **kw)
    eng, toks, _ = drain(setup, port=True, continuous=True, **kw,
                         **spec_kw(2))
    jeng, _, _ = drain(setup, port=False, continuous=True, **kw,
                       **spec_kw(2))
    assert toks == ref
    assert eng.serve_stats()["spec"] == jeng.serve_stats()["spec"]
    assert not any(v.any() for k, v in eng._zero_view.items()
                   if k != "ln_scale")


@pytest.mark.parametrize("form", ["per_step", "disabled"])
def test_spec_per_step_and_disabled(setup, form):
    kw = dict(precompute=False) if form == "per_step" else \
        dict(xpeft_kw=dict(enabled=False))
    _, ref, _ = drain(setup, port=True, continuous=True, **kw)
    eng, toks, _ = drain(setup, port=True, continuous=True, **kw,
                         **spec_kw(3))
    jeng, _, _ = drain(setup, port=False, continuous=True, **kw,
                       **spec_kw(3))
    assert toks == ref
    assert eng.serve_stats()["spec"] == jeng.serve_stats()["spec"]


@pytest.mark.parametrize("case", ["windowed", "decode_fused", "gamma0",
                                  "recurrent", "prefix"])
def test_spec_refusals_match_jax(setup, case):
    from repro.configs import get_config, reduce_for_smoke
    from repro.core.profiles import ProfileStore as JStore
    from repro.serve.engine import ServeEngine as JEngine

    arch = "rwkv6-7b" if case == "recurrent" else "qwen1.5-0.5b"
    cfgs = [reduce_for_smoke(get_config(arch)), treduce(tget_config(arch))]
    kw = dict(spec_enable=True, spec_gamma=0 if case == "gamma0" else 2,
              decode_fused=case == "decode_fused")
    cfgs = [c.with_(**kw) for c in cfgs]
    if case == "prefix":
        cfgs = [c.with_xpeft(**HETERO) for c in cfgs]
    match = {"windowed": "continuous=True", "decode_fused": "exclusive",
             "gamma0": "spec_gamma", "recurrent": "attention",
             "prefix": "prefix-bearing"}[case]
    xp = cfgs[1].xpeft
    shape = (cfgs[1].num_layers, xp.num_adapters, xp.bottleneck, "hard",
             xp.k)
    extra = dict(bank_spec=xp.bank_spec) if case == "prefix" else {}
    # the refusal comes before any weight is read
    params = (setup["params"], setup["tparams"])
    for cls, store, cfg, p in ((JEngine, JStore(*shape, **extra), cfgs[0],
                                params[0]),
                               (TEngine, TStore(*shape, **extra), cfgs[1],
                                params[1])):
        with pytest.raises(ValueError, match=match):
            cls(cfg, p, store, continuous=case != "windowed")


def test_spec_rounds_pack_tokens(setup):
    """One round commits 1..gamma+1 tokens per slot, packed densely: the
    sync hands each request exactly its committed count."""
    eng, toks, reqs = drain(setup, port=True, continuous=True,
                            **spec_kw(3))
    assert all(len(toks[r.uid]) == r.max_new_tokens for r in reqs)
    assert eng.slots.tok_buf.shape[1] == eng.sync_every * 4 + 1
    assert (eng.slots.tok_buf == -1).all()
    assert np.isclose(eng.serve_stats()["committed_per_device_step"],
                      eng.decode_tokens / eng.slots.device_steps, atol=1e-4)
