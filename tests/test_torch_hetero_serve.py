"""The port's heterogeneous-bank serving against the JAX package, on the CPU.

Workload: reduced qwen1.5-0.5b at float32 with JAX's own weights carried
across by ``repro_torch.bridge``, the typed bank ``SPEC`` (bottleneck /
LoRA / IA3 / prefix, P = 2 prefix rows), 4 hard-mask profiles crafted as
``benchmarks/hetero_smoke.py`` crafts them: profile 1 selects no prefix
slot (its prompt sits at cache slot 0), profile 2 selects one on even
layers and none on odd ones (the per-layer ``prefix_skip`` gate), 0 and 3
random. 6 requests of 6-10 prompt tokens and 8 new tokens on 3 slots,
max_seq 64, through both frameworks' windowed engines.

Tolerances: greedy tokens, each request's prefix length, the admission
record and the serve counters EQUAL; the admitted typed aggregates
rtol = atol = 1e-5 (the two frameworks sum in other orders).
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs import get_config, reduce_for_smoke
from repro.core import xpeft as JXP
from repro.core.profiles import ProfileStore as JStore
from repro.models import forward as jforward
from repro.models import init_cache as jinit_cache
from repro.models import init_lm as jinit_lm
from repro.models import lm_logits as jlm_logits
from repro.serve.engine import Request as JRequest
from repro.serve.engine import ServeEngine as JEngine
from repro_torch import bridge
from repro_torch.configs import get_config as tget_config
from repro_torch.configs import reduce_for_smoke as treduce
from repro_torch.core.profiles import ProfileStore as TStore
from repro_torch.models import model as TMDL
from repro_torch.serve import Request as TRequest
from repro_torch.serve import ServeEngine as TEngine

SPEC = (("bottleneck", 4), ("lora", 4), ("ia3", 2), ("prefix", 2))
N_PROFILES = 4
TOL = dict(rtol=1e-5, atol=1e-5)


def _crafted_rows(table, xp):
    """Profile rows: 1 pinned off the prefix segment, 2 pinned on it at
    even layers and off it at odd ones, 0 and 3 as drawn."""
    off, cnt = next((o, c) for t, o, c in xp.segments() if t == "prefix")
    rows = [{k: np.array(v[pid]) for k, v in table.items()}
            for pid in range(N_PROFILES)]
    for m in ("mA", "mB"):
        rows[1][m][:, off:off + cnt] = -30.0
        rows[2][m][1::2, off:off + cnt] = -30.0
        rows[2][m][0::2, off] = 30.0
    return rows


def _requests(cls, prompts):
    return [cls(uid=i, prompt=p, profile_id=i % N_PROFILES,
                max_new_tokens=8) for i, p in enumerate(prompts)]


@pytest.fixture(scope="module")
def served():
    kw = dict(num_adapters=12, bottleneck=4, k=4, max_profiles=8,
              bank_spec=SPEC, prefix_tokens=2)
    cfg = reduce_for_smoke(get_config("qwen1.5-0.5b")).with_xpeft(**kw)
    tcfg = treduce(tget_config("qwen1.5-0.5b")).with_xpeft(**kw)
    key = jax.random.key(0)
    params = jax.jit(jinit_lm, static_argnums=1)(key, cfg)
    table = jax.tree.map(np.asarray, JXP.init_profile_table(key, cfg))
    xp = cfg.xpeft
    shape = (cfg.num_layers, xp.num_adapters, xp.bottleneck, "hard", xp.k)
    jstore = JStore(*shape, bank_spec=xp.bank_spec)
    tstore = TStore(*shape, bank_spec=xp.bank_spec)
    for pid, row in enumerate(_crafted_rows(table, xp)):
        jstore.add_profile(pid, row)
        tstore.add_profile(pid, row)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, size=6 + i % 5)
               for i in range(6)]
    jeng = JEngine(cfg, params, jstore, max_slots=3, max_seq=64,
                   precompute=True)
    jreqs = _requests(JRequest, prompts)
    jeng.run_until_drained(list(jreqs))
    return dict(cfg=cfg, tcfg=tcfg, params=params, jstore=jstore,
                tparams=bridge.to_torch(jax.tree.map(np.asarray, params)),
                tstore=tstore, prompts=prompts, jeng=jeng, jreqs=jreqs)


def _serve_port(s, cfg=None, sync_every=8):
    eng = TEngine(cfg or s["tcfg"], s["tparams"], s["tstore"], max_slots=3,
                  max_seq=64, sync_every=sync_every)
    cpos = []
    prefill = eng.prefill_logits

    def spy(tokens, masks, lengths, cache_pos=None, prefix_rows=None):
        cpos.append(cache_pos.tolist())
        return prefill(tokens, masks, lengths, cache_pos, prefix_rows)
    eng.prefill_logits = spy
    reqs = _requests(TRequest, s["prompts"])
    eng.run_until_drained(list(reqs))
    eng.prefill_cache_pos = cpos
    return eng, reqs


def test_store_keeps_the_bank_spec(served):
    assert served["tstore"].bank_spec == served["jstore"].bank_spec == SPEC
    assert TStore(2, 12, 4).bank_spec == ()


def test_engine_tokens_and_prefix_lengths_match_jax(served):
    eng, reqs = _serve_port(served)
    P = served["cfg"].xpeft.prefix_tokens
    for treq, jreq in zip(reqs, served["jreqs"]):
        assert treq.done and len(treq.generated) == 8
        assert treq.generated == jreq.generated, treq.uid
        assert treq.prefix_len == jreq.prefix_len, treq.uid
    # profile 1 never selects a prefix slot; 0 and 2 do
    assert [r.prefix_len for r in reqs[:3]] == [P, 0, P]
    # one prefill batch held prefix-on and prefix-off requests
    assert any(P in c and 0 in c[:2] for c in eng.prefill_cache_pos)
    assert eng.last_admission == served["jeng"].last_admission
    st, jst = eng.serve_stats(), served["jeng"].serve_stats()
    for key in ("decode_tokens", "prefill_batches", "prefill_occupancy",
                "host_syncs", "device_steps"):
        assert st[key] == jst[key], key
    assert st["profile_cache"]["bytes"] == jst["profile_cache"]["bytes"]
    assert st["profile_cache"]["hit_rate"] == jst["profile_cache"]["hit_rate"]


def test_admitted_typed_entries_match_jax(served):
    eng, _ = _serve_port(served)
    L = served["cfg"].num_layers
    P = served["cfg"].xpeft.prefix_tokens
    for pid in range(N_PROFILES):
        want = served["jeng"].profile_cache.peek(pid)
        got = eng.profile_cache.peek(pid)
        assert sorted(got) == sorted(want)
        for key in want:
            np.testing.assert_allclose(got[key].numpy(),
                                       np.asarray(want[key]), err_msg=key,
                                       **TOL)
    # the per-layer gate: profile 2 skips the prefix rows on odd layers
    skip = eng.profile_cache.peek(2)["prefix_skip"].tolist()
    assert skip == [0 if l % 2 == 0 else P for l in range(L)]
    assert eng.profile_cache.peek(1)["prefix_skip"].tolist() == [0] * L


def test_prefill_with_prefix_rows_matches_jax(served):
    """One prefill batch of profiles 0-2 (prefix on, off, layer-gated)
    through the port engine's prefill against JAX's forward over the same
    entries: the prefix rows written at cache slots [0, P) for prefix-on
    rows, the prompt at cache_pos P or 0. Logits at each row's last token
    and the whole mini cache (prefix rows, prompt K/V, every layer) within
    the tolerance: the composed bottleneck -> LoRA -> IA3 adapters move
    both."""
    cfg = served["cfg"]
    eng, reqs = _serve_port(served)
    group = reqs[:3]
    B, pad, S = 3, 16, 64
    toks = np.zeros((B, pad), np.int32)
    for i, r in enumerate(group):
        toks[i, :len(r.prompt)] = r.prompt
    lens = np.array([len(r.prompt) for r in group], np.int32)
    cpos = np.array([r.prefix_len for r in group], np.int32)
    jentries = [served["jeng"].profile_cache.peek(r.profile_id)
                for r in group]
    jm = {k: jnp.stack([e[k] for e in jentries]) for k in jentries[0]
          if k != "prefix_on"}
    pk, pv = jm.pop("prefix_k"), jm.pop("prefix_v")
    KV, hd, P = cfg.num_kv_heads, cfg.head_dim, pk.shape[2]
    jc = jinit_cache(cfg, B, S)
    for key, rows in (("k", pk), ("v", pv)):
        rows = jnp.moveaxis(rows.reshape(rows.shape[:3] + (KV, hd)), 0, 1)
        jc[key] = jc[key].at[:, :, :P].set(rows)
    jh, jc, _ = jforward(served["params"], jnp.asarray(toks), cfg,
                         profile_masks=jm, cache=jc,
                         cache_pos=jnp.asarray(cpos))
    last = jh[jnp.arange(B), jnp.asarray(lens - 1)][:, None]
    want = np.asarray(jlm_logits(served["params"], last, cfg)[:, -1])

    tentries = [eng.profile_cache.peek(r.profile_id) for r in group]
    tm = {k: torch.stack([e[k] for e in tentries]) for k in eng._entry_keys}
    prows = (tm.pop("prefix_k"), tm.pop("prefix_v"))
    logits, mini = eng.prefill_logits(
        torch.from_numpy(toks), tm, torch.from_numpy(lens),
        torch.from_numpy(cpos), prows)
    np.testing.assert_allclose(logits.numpy(), want, **TOL)
    for key in ("k", "v"):
        np.testing.assert_allclose(mini[key].numpy(), np.asarray(jc[key]),
                                   err_msg=key, **TOL)


def test_tokens_invariant_to_sync_every(served):
    _, a = _serve_port(served, sync_every=1)
    eng8, b = _serve_port(served, sync_every=8)
    assert [r.generated for r in a] == [r.generated for r in b]
    assert eng8.serve_stats()["syncs_per_token"] < 1


def test_decode_fused_keeps_hetero_entries_composed(served):
    cfg = served["tcfg"].with_(decode_fused=True)
    eng, reqs = _serve_port(served, cfg=cfg)
    assert TMDL._decode_fused_route(cfg, eng.masks, True, 1) is None
    assert [r.generated for r in reqs] == \
        [r.generated for r in served["jreqs"]]


@pytest.mark.parametrize("case", ["bank_quant", "spec", "no_precompute",
                                  "prefix_overflow"])
def test_constructor_refusals_match_jax(served, case):
    """JAX's ValueErrors for a hetero engine, raised by the port too
    (speculation over a prefix-bearing spec: on a continuous engine)."""
    cfg, tcfg = served["cfg"], served["tcfg"]
    kw = dict(max_slots=2, max_seq=64)
    if case == "bank_quant":
        cfg, tcfg = (c.with_xpeft(bank_quant="int8") for c in (cfg, tcfg))
    elif case == "spec":
        cfg, tcfg = (c.with_(spec_enable=True, spec_gamma=2)
                     for c in (cfg, tcfg))
        kw["continuous"] = True
    elif case == "no_precompute":
        kw["precompute"] = False
    else:
        cfg, tcfg = (c.with_xpeft(prefix_tokens=64) for c in (cfg, tcfg))
    match = {"bank_quant": "quant", "spec": "prefix-bearing",
             "no_precompute": "precompute", "prefix_overflow": "prefix"}[case]
    with pytest.raises(ValueError, match=match):
        JEngine(cfg, served["params"], served["jstore"], **kw)
    with pytest.raises(ValueError, match=match):
        TEngine(tcfg, served["tparams"], served["tstore"], **kw)
