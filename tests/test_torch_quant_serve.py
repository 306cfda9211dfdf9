"""The port's quantized-bank serving (``XPeftConfig.bank_quant`` int8 /
int4) against the JAX package, on the CPU.

Workload: the slice-1 serve one (``examples/serve_multiprofile.py``'s):
reduced qwen1.5-0.5b at float32 with JAX's own weights carried across by
``repro_torch.bridge``, 4 hard-mask profiles, 6 requests of 6-10 prompt
tokens and 8 new tokens on 3 slots, max_seq 64. Profiles 0 and 1
graduate with aggregated records (``add_profile(agg=...)``, the Â/B̂
JAX's admission aggregation computes for them), so admission mixes store
records with aggregation against the quantized bank. On the CPU every
kernel wrapper computes its plain version.

Tolerances: store records are byte-equal; last_admission and the serve
counters equal; greedy tokens equal, or differing only where JAX's top-2
logit gap is below 1e-4 (a float32 tie). int4 on the composed path and
both schemes on the decode_fused route are in
``test_torch_quant_serve_fused.py`` (split to keep each file short).
"""
import numpy as np
import jax
import pytest
import torch

from repro.configs import get_config, reduce_for_smoke
from repro.core import xpeft as JXP
from repro.core.profiles import ProfileStore as JStore
from repro.models import forward as jforward
from repro.models import init_lm as jinit_lm
from repro.models import lm_logits as jlm_logits
from repro.serve.engine import Request as JRequest
from repro.serve.engine import ServeEngine as JEngine
from repro_torch import bridge
from repro_torch.configs import get_config as tget_config
from repro_torch.configs import reduce_for_smoke as treduce
from repro_torch.core.profiles import ProfileStore as TStore
from repro_torch.resilience.integrity import RecordIntegrityError
from repro_torch.serve import Request as TRequest
from repro_torch.serve import ServeEngine as TEngine

ARCH = "qwen1.5-0.5b"
N_PROFILES = 4
AGG_PIDS = (0, 1)
TIE_GAP = 1e-4


@pytest.fixture(scope="module")
def base():
    cfg = reduce_for_smoke(get_config(ARCH))
    key = jax.random.key(0)
    params = jax.jit(jinit_lm, static_argnums=1)(key, cfg)
    table = jax.tree.map(np.asarray, JXP.init_profile_table(key, cfg))
    rows = [{k: v[pid] for k, v in table.items()}
            for pid in range(N_PROFILES)]
    xp = cfg.xpeft
    plain = JStore(cfg.num_layers, xp.num_adapters, xp.bottleneck, "hard",
                   xp.k)
    aggs = {}
    for pid in AGG_PIDS:
        plain.add_profile(pid, rows[pid])
        a, b = JXP.precompute_effective_adapters_sparse(
            params["xpeft_bank"], *plain.sparse_indices(pid), xp)
        aggs[pid] = (np.asarray(a), np.asarray(b))
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, size=6 + i % 5)
               for i in range(6)]
    return dict(cfg=cfg, tcfg=treduce(tget_config(ARCH)), params=params,
                tparams=bridge.to_torch(jax.tree.map(np.asarray, params)),
                rows=rows, aggs=aggs, prompts=prompts, runs={})


def _stores(base, scheme, with_agg=True):
    xp = base["cfg"].xpeft
    shape = (base["cfg"].num_layers, xp.num_adapters, xp.bottleneck,
             "hard", xp.k)
    js = JStore(*shape, quant=scheme, quant_group=xp.quant_group)
    ts = TStore(*shape, quant=scheme, quant_group=xp.quant_group)
    for pid, row in enumerate(base["rows"]):
        agg = base["aggs"].get(pid) if with_agg else None
        js.add_profile(pid, row, agg=agg)
        ts.add_profile(pid, row, agg=agg)
    return js, ts


def _requests(cls, prompts):
    return [cls(uid=i, prompt=p, profile_id=i % N_PROFILES,
                max_new_tokens=8) for i, p in enumerate(prompts)]


def jax_run(base, scheme, fused=False):
    """JAX's quantized windowed engine over the workload, run once per
    (scheme, route) and kept."""
    key = (scheme, fused)
    if key not in base["runs"]:
        cfg = base["cfg"].with_xpeft(bank_quant=scheme).with_(
            decode_fused=fused)
        js, _ = _stores(base, scheme)
        eng = JEngine(cfg, base["params"], js, max_slots=3, max_seq=64,
                      precompute=True)
        reqs = _requests(JRequest, base["prompts"])
        eng.run_until_drained(list(reqs))
        base["runs"][key] = (eng, reqs)
    return base["runs"][key]


def port_engine(base, scheme, store=None, fused=False, **kw):
    cfg = base["tcfg"].with_xpeft(bank_quant=scheme).with_(
        decode_fused=fused)
    store = store if store is not None else _stores(base, scheme)[1]
    return TEngine(cfg, base["tparams"], store, max_slots=3, max_seq=64,
                   **kw)


def _top2_gap(base, jeng, req, step, fused):
    """JAX's top-2 logit gap where token `step` of a request was made,
    recomputed uncached (composed) with its admitted quantized entry."""
    cfg = base["cfg"].with_xpeft(bank_quant=jeng.quant)
    entry = jeng.profile_cache.peek(req.profile_id)
    masks = jax.tree.map(lambda v: v[None], entry)
    seq = np.concatenate([req.prompt, req.generated[:step]])[None]
    h, _, _ = jforward(base["params"], seq.astype(np.int32), cfg,
                       profile_masks=masks)
    top = np.sort(np.asarray(jlm_logits(base["params"], h[:, -1:],
                                        cfg))[0, 0])
    return float(top[-1] - top[-2])


def assert_tokens_match(base, scheme, reqs, fused=False):
    jeng, jreqs = jax_run(base, scheme, fused)
    for got, want in zip(reqs, jreqs):
        assert got.done and len(got.generated) == len(want.generated) == 8
        diff = [i for i, (a, b) in enumerate(zip(got.generated,
                                                 want.generated)) if a != b]
        if diff:  # only a float32 near-tie may flip a greedy token
            assert _top2_gap(base, jeng, want, diff[0], fused) < TIE_GAP, \
                (got.uid, got.generated, want.generated)


# ----------------------------------------------------------------------------
# store records
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("scheme", ["int8", "int4"])
def test_store_records_with_agg_byte_equal(base, scheme):
    js, ts = _stores(base, scheme)
    for pid in range(N_PROFILES):
        jr, tr = js._rec[pid], ts._rec[pid]
        assert sorted(jr) == sorted(tr), pid
        for key in jr:
            assert jr[key].dtype == tr[key].dtype, key
            assert jr[key].tobytes() == tr[key].tobytes(), (pid, key)
        assert js._crc[pid] == ts._crc[pid]
        assert ts.has_quant_record(pid) == js.has_quant_record(pid) \
            == (pid in AGG_PIDS)
    recs = ts.quant_records(AGG_PIDS)
    for key, v in js.quant_records(AGG_PIDS).items():
        assert np.asarray(v).tobytes() == recs[key].numpy().tobytes(), key
    with pytest.raises(ValueError):
        TStore(2, 8, 4).add_profile(0, base["rows"][0],
                                    agg=base["aggs"][0])


def test_corrupt_agg_payload_heals_like_jax(base):
    """A record whose corruption is confined to its agg payload sheds it
    (agg_dropped) and keeps serving from its masks; a corrupt mask
    quarantines, in both frameworks."""
    js, ts = _stores(base, "int8")
    for store in (js, ts):
        bad = np.array(store._rec[0]["agg_b_q"])
        bad.flat[0] ^= 1
        store._rec[0]["agg_b_q"] = bad
        assert not store.has_quant_record(0)
        assert "agg_a_q" not in store._rec[0]
        store.check_record(0)   # healed: no raise
        bad = np.array(store._rec[1]["mA"])
        bad.flat[0] ^= 1
        store._rec[1]["mA"] = bad
        assert not store.has_quant_record(1)
    assert ts.agg_dropped == js.agg_dropped == [0]
    assert ts.corrupt_detected == js.corrupt_detected
    assert sorted(ts._quarantined) == js.quarantined_ids() == [1]
    with pytest.raises(RecordIntegrityError):
        ts.check_record(1)


# ----------------------------------------------------------------------------
# the engine
# ----------------------------------------------------------------------------

def check_engine_against_jax(base, scheme, fused):
    """Serve the workload on the port's quantized engine: its layout, its
    first wave's admission (store records mixed with aggregation:
    quant_mixed), the last admission, the tokens and the counters against
    JAX's engine on the same route."""
    eng = port_engine(base, scheme, fused=fused)
    assert "xpeft_bank" not in eng.params and "xpeft_bank" in base["tparams"]
    qdt = torch.int8 if scheme == "int8" else torch.uint8
    assert eng.masks["a_q"].dtype == eng.masks["b_q"].dtype == qdt
    assert eng.masks["a_scale"].dtype == torch.float16
    assert sorted(eng.masks) == ["a_q", "a_scale", "b_q", "b_scale",
                                 "ln_bias", "ln_scale"]
    jeng, _ = jax_run(base, scheme, fused)
    for key in ("a_q", "a_scale", "b_q", "b_scale"):
        assert tuple(eng.masks[key].shape) == tuple(jeng.masks[key].shape)
    admissions = []
    orig = eng._hydrate_stacked

    def spy(reqs):
        out = orig(reqs)
        admissions.append(dict(eng.last_admission))
        return out
    eng._hydrate_stacked = spy
    reqs = _requests(TRequest, base["prompts"])
    eng.run_until_drained(list(reqs))
    assert admissions[0]["path"] == "quant_mixed"
    assert admissions[0]["store_hydrated_profiles"] == len(AGG_PIDS)
    assert admissions[0]["scheme"] == scheme
    assert eng.last_admission == jeng.last_admission
    assert_tokens_match(base, scheme, reqs, fused)
    st, jst = eng.serve_stats(), jeng.serve_stats()
    assert st["bank_quant"] == jst["bank_quant"] == scheme
    for key in ("decode_tokens", "prefill_batches", "prefill_occupancy",
                "host_syncs", "device_steps"):
        assert st[key] == jst[key], key
    assert st["profile_cache"] == jst["profile_cache"]
    return eng


def test_quant_engine_tokens_and_admissions_match_jax(base):
    """int8 on the composed path (int4 and the decode_fused route are in
    ``test_torch_quant_serve_fused.py``)."""
    check_engine_against_jax(base, "int8", fused=False)


@pytest.mark.parametrize("scheme", ["int8", "int4"])
def test_quant_admission_paths(base, scheme):
    """Without agg records the wave aggregates (quant_sparse) and reads
    bank bytes; a wave of record-bearing profiles reads none
    (quant_store); re-graduation drops the cached entry, and the next
    admission hydrates again."""
    js, ts = _stores(base, scheme, with_agg=False)
    jcfg = base["cfg"].with_xpeft(bank_quant=scheme)
    jeng = JEngine(jcfg, base["params"], js, max_slots=3, max_seq=64)
    eng = port_engine(base, scheme, store=ts)
    for e, cls in ((jeng, JRequest), (eng, TRequest)):
        e.admit_many([cls(uid=0, prompt=base["prompts"][0], profile_id=2,
                          max_new_tokens=2)])
    assert eng.last_admission == jeng.last_admission
    assert eng.last_admission["path"] == "quant_sparse"
    assert eng.last_admission["bank_bytes_per_request"] > 0

    _, ts = _stores(base, scheme)
    eng = port_engine(base, scheme, store=ts)
    wave = [TRequest(uid=i, prompt=base["prompts"][i], profile_id=pid,
                     max_new_tokens=2) for i, pid in enumerate(AGG_PIDS)]
    eng.admit_many(wave)
    la = eng.last_admission
    assert la["path"] == "quant_store" and la["bank_bytes_per_request"] == 0
    assert la["store_hydrated_profiles"] == len(AGG_PIDS)
    entry = eng.profile_cache.peek(0)
    rec = ts.quant_records([0])
    for key in ("a_q", "a_scale", "b_q", "b_scale"):
        assert torch.equal(entry[key], rec[key][0])
    eng.run_until_drained()
    # re-graduation (without a record now) invalidates the cached entry
    ts.add_profile(0, base["rows"][0])
    assert eng.profile_cache.peek(0) is None
    eng.admit_many([TRequest(uid=9, prompt=base["prompts"][2],
                             profile_id=0, max_new_tokens=2)])
    assert eng.last_admission["path"] == "quant_sparse"
    assert eng.last_admission["aggregated_profiles"] == 1


@pytest.mark.parametrize("scheme", ["int8", "int4"])
def test_quant_engine_refusals_match_jax(base, scheme):
    """bank_quant with precompute=False raises ValueError, as JAX's."""
    js, ts = _stores(base, scheme, with_agg=False)
    with pytest.raises(ValueError, match="precompute"):
        JEngine(base["cfg"].with_xpeft(bank_quant=scheme), base["params"],
                js, precompute=False)
    with pytest.raises(ValueError, match="precompute"):
        port_engine(base, scheme, store=ts, precompute=False)


def test_unquantized_engine_unchanged(base):
    """bank_quant="none": the bf16/fp32 bank stays resident, the slot
    buffers hold Â/B̂, and admissions report JAX's sparse path."""
    xp = base["cfg"].xpeft
    shape = (base["cfg"].num_layers, xp.num_adapters, xp.bottleneck,
             "hard", xp.k)
    js, ts = JStore(*shape), TStore(*shape)
    for pid, row in enumerate(base["rows"]):
        js.add_profile(pid, row)
        ts.add_profile(pid, row)
    jeng = JEngine(base["cfg"], base["params"], js, max_slots=3,
                   max_seq=64)
    eng = port_engine(base, "none", store=ts)
    assert "xpeft_bank" in eng.params
    assert sorted(eng.masks) == ["a_hat", "b_hat", "ln_bias", "ln_scale"]
    for e, cls in ((jeng, JRequest), (eng, TRequest)):
        e.admit_many(_requests(cls, base["prompts"])[:3])
    assert eng.last_admission == jeng.last_admission
    assert eng.last_admission["path"] == "sparse"
    assert eng.serve_stats()["bank_quant"] == "none"


def test_quant_tokens_invariant_to_sync_every(base):
    out = []
    for sync_every in (1, 8):
        eng = port_engine(base, "int4", sync_every=sync_every)
        reqs = _requests(TRequest, base["prompts"])
        eng.run_until_drained(list(reqs))
        out.append([r.generated for r in reqs])
    assert out[0] == out[1]
