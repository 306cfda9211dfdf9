"""The port's per-step (``precompute=False``), soft-mask and X-PEFT-disabled
serving against the JAX package's engine, on the CPU.

Workload: ``tests/test_torch_serve.py``'s (reduced qwen1.5-0.5b, float32,
4 profiles, 6 requests of 6-10 prompt tokens and 8 new tokens on 3
slots, max_seq 64), with JAX's weights and profile logits carried across
by the bridge, from a hard-mask and a soft-mask store of the same logits.

Tolerances: greedy tokens EQUAL to JAX's engine on the same path, except
that a token may flip where JAX's top-2 logit gap is below 1e-4 (at
float32 the two frameworks agree to ~1e-6: checked, not skipped); within
the port, ``precompute=False`` tokens equal ``precompute=True`` tokens
(the JAX package's admission-parity contract); admission reports equal
JAX's.
"""
import numpy as np
import jax
import pytest

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
from repro_torch.serve import Request as TRequest
from repro_torch.serve import ServeEngine as TEngine

ARCH = "qwen1.5-0.5b"
N_PROFILES = 4
TIE_GAP = 1e-4
# (store mask type, precompute, X-PEFT enabled)
PATHS = {"hard_per_step": ("hard", False, True),
         "soft_per_step": ("soft", False, True),
         "soft_precompute": ("soft", True, True),
         "disabled": ("hard", True, False)}


@pytest.fixture(scope="module")
def base():
    cfg = reduce_for_smoke(get_config(ARCH))
    tcfg = treduce(tget_config(ARCH))
    key = jax.random.key(0)
    params = jax.jit(jinit_lm, static_argnums=1)(key, cfg)
    table = jax.tree.map(np.asarray, JXP.init_profile_table(key, cfg))
    rows = [{k: v[pid] for k, v in table.items()}
            for pid in range(N_PROFILES)]
    xp = cfg.xpeft
    stores = {}
    for mtype in ("hard", "soft"):
        shape = (cfg.num_layers, xp.num_adapters, xp.bottleneck, mtype,
                 xp.k)
        js, ts = JStore(*shape), TStore(*shape)
        for pid, row in enumerate(rows):
            js.add_profile(pid, row)
            ts.add_profile(pid, row)
        stores[mtype] = (js, ts)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, size=6 + i % 5)
               for i in range(6)]
    return dict(cfg=cfg, tcfg=tcfg, params=params,
                tparams=bridge.to_torch(jax.tree.map(np.asarray, params)),
                stores=stores, prompts=prompts, jax_runs={})


def _requests(cls, prompts):
    return [cls(uid=i, prompt=p, profile_id=i % N_PROFILES,
                max_new_tokens=8) for i, p in enumerate(prompts)]


def _cfgs(base, enabled):
    return tuple(c.with_xpeft(enabled=enabled)
                 for c in (base["cfg"], base["tcfg"]))


def _run(base, path, port):
    mtype, precompute, enabled = PATHS[path]
    cfg, tcfg = _cfgs(base, enabled)
    js, ts = base["stores"][mtype]
    if port:
        eng = TEngine(tcfg, base["tparams"], ts, max_slots=3, max_seq=64,
                      precompute=precompute)
        cls = TRequest
    else:
        if path in base["jax_runs"]:
            return base["jax_runs"][path]
        eng = JEngine(cfg, base["params"], js, max_slots=3, max_seq=64,
                      precompute=precompute)
        cls = JRequest
    waves = []
    hydrate = eng._hydrate_stacked

    def spy(reqs):
        out = hydrate(reqs)
        waves.append(None if eng.last_admission is None
                     else dict(eng.last_admission))
        return out
    eng._hydrate_stacked = spy
    reqs = _requests(cls, base["prompts"])
    eng.run_until_drained(list(reqs))
    if not port:
        base["jax_runs"][path] = (eng, reqs, waves)
    return eng, reqs, waves


def _top2_gap(base, path, req, step):
    """JAX's top-2 logit gap at the step that produced token ``step``,
    recomputed uncached with the request's masks on that path."""
    mtype, precompute, enabled = PATHS[path]
    cfg, _ = _cfgs(base, enabled)
    js = base["stores"][mtype][0]
    masks = None
    if enabled and precompute:
        eng = base["jax_runs"][path][0]
        masks = jax.tree.map(lambda v: v[None],
                             eng.profile_cache.peek(req.profile_id))
    elif enabled:
        w_a, w_b, ls, lb = js.batch_mask_weights([req.profile_id])
        masks = dict(w_a=w_a, w_b=w_b, ln_scale=ls, ln_bias=lb)
    seq = np.concatenate([req.prompt, req.generated[:step]])[None]
    h, _, _ = jforward(base["params"], seq.astype(np.int32), cfg,
                       profile_masks=masks)
    top = np.sort(np.asarray(jlm_logits(base["params"], h[:, -1:], cfg))
                  [0, 0])
    return float(top[-1] - top[-2])


@pytest.mark.parametrize("path", sorted(PATHS))
def test_tokens_and_admissions_match_jax(base, path):
    jeng, jreqs, jwaves = _run(base, path, port=False)
    eng, reqs, waves = _run(base, path, port=True)
    for treq, jreq in zip(reqs, jreqs):
        assert treq.done and len(treq.generated) == len(jreq.generated) == 8
        diff = [i for i, (a, b) in enumerate(zip(treq.generated,
                                                 jreq.generated)) if a != b]
        if diff:  # only a near-tie may flip a greedy token
            assert _top2_gap(base, path, jreq, diff[0]) < TIE_GAP, \
                (treq.uid, treq.generated, jreq.generated)
    assert len(waves) == len(jwaves)
    for got, want in zip(waves, jwaves):
        if want is None:
            assert got is None
            continue
        for key in ("path", "requests", "cache_hits", "cache_misses",
                    "bank_bytes_per_request", "degraded"):
            assert got[key] == want[key], (key, got, want)
    st, jst = eng.serve_stats(), jeng.serve_stats()
    for key in ("decode_tokens", "prefill_batches", "prefill_occupancy",
                "host_syncs", "device_steps"):
        assert st[key] == jst[key], key
    mtype, precompute, enabled = PATHS[path]
    if not enabled:
        assert eng.masks is None and waves[0] is None
    elif not precompute:
        assert {w["path"] for w in waves} == {"per_step"}
        assert sorted(eng.masks) == ["ln_bias", "ln_scale", "w_a", "w_b"]
        assert eng.profile_cache.stats()["entries"] == 0
    else:
        assert waves[0]["path"] == "dense"
        assert waves[0]["aggregated_profiles"] == \
            jwaves[0]["aggregated_profiles"]


@pytest.mark.parametrize("mtype", ["hard", "soft"])
def test_per_step_tokens_equal_precompute_in_the_port(base, mtype):
    """Admission parity: aggregating once at admission or in every step
    gives the same greedy tokens."""
    js, ts = base["stores"][mtype]
    out = []
    for precompute in (True, False):
        eng = TEngine(base["tcfg"], base["tparams"], ts, max_slots=3,
                      max_seq=64, precompute=precompute, sync_every=3)
        reqs = _requests(TRequest, base["prompts"])
        eng.run_until_drained(list(reqs))
        out.append([r.generated for r in reqs])
    assert out[0] == out[1]


def test_per_step_masks_hydrate_from_the_store(base):
    """The slot buffers hold each request's store weights, hard k-hot rows
    of k entries of 1/k."""
    _, ts = base["stores"]["hard"]
    xp = base["tcfg"].xpeft
    eng = TEngine(base["tcfg"], base["tparams"], ts, max_slots=3,
                  max_seq=64, precompute=False)
    reqs = _requests(TRequest, base["prompts"])[:3]
    eng.admit_many(reqs)
    wa, wb, ls, lb = ts.batch_mask_weights([r.profile_id for r in reqs])
    for key, want in zip(("w_a", "w_b", "ln_scale", "ln_bias"),
                         (wa, wb, ls, lb)):
        np.testing.assert_array_equal(eng.masks[key].numpy(),
                                      want.numpy())
    assert ((eng.masks["w_a"] > 0).sum(-1) == xp.k).all()
    assert eng.last_admission["path"] == "per_step"


def _hetero_per_step(base, mtype):
    """Per-step serving over a heterogeneous bank (bottleneck 4 / LoRA 4
    over the same N=8), the port's windowed and continuous engines against
    JAX's windowed one, from a store of ``mtype`` masks: returns the three
    runs' tokens."""
    spec = (("bottleneck", 4), ("lora", 4))
    cfg, tcfg = (c.with_xpeft(bank_spec=spec)
                 for c in (base["cfg"], base["tcfg"]))
    params = jax.jit(jinit_lm, static_argnums=1)(jax.random.key(1), cfg)
    tparams = bridge.to_torch(jax.tree.map(np.asarray, params))
    xp = cfg.xpeft
    shape = (cfg.num_layers, xp.num_adapters, xp.bottleneck, mtype, xp.k)
    js, ts = JStore(*shape, bank_spec=spec), TStore(*shape, bank_spec=spec)
    table = jax.tree.map(np.asarray,
                         JXP.init_profile_table(jax.random.key(0), cfg))
    for pid in range(N_PROFILES):
        row = {k: v[pid] for k, v in table.items()}
        js.add_profile(pid, row)
        ts.add_profile(pid, row)
    jeng = JEngine(cfg, params, js, max_slots=3, max_seq=64,
                   precompute=False)
    jreqs = _requests(JRequest, base["prompts"])
    jeng.run_until_drained(list(jreqs))
    out = [[r.generated for r in jreqs]]
    for cont in (False, True):
        eng = TEngine(tcfg, tparams, ts, max_slots=3, max_seq=64,
                      precompute=False, continuous=cont)
        reqs = _requests(TRequest, base["prompts"])
        eng.run_until_drained(list(reqs))
        assert all(r.done for r in reqs)
        assert eng.last_admission["path"] == "per_step"
        out.append([r.generated for r in reqs])
    if mtype == "soft":
        # JAX's refusal stays: hetero precompute needs hard masks
        with pytest.raises(ValueError, match="hard"):
            TEngine(tcfg, tparams, ts, max_slots=3, max_seq=64)
    return out


@pytest.mark.parametrize("case", ["hetero", "continuous", "spec", "mesh",
                                  "fault_plan", "obs", "quant_per_step",
                                  "quant_soft", "hetero_soft"])
def test_remaining_refusals_raise(base, case, tmp_path):
    """The options the port still refuses, each naming its ROADMAP item,
    and JAX's own refusals. The cases once refused now hold the ported
    behaviour: continuous per-step serving equals windowed token for
    token; per-step serving over a heterogeneous bank (hard and soft
    masks) equals JAX's engine, windowed and continuous; a fault plan
    degrades the same requests as JAX's engine with the same tokens; an
    obs bundle changes neither tokens nor host syncs; per-step serving on
    a world-1 mesh equals it off the mesh (tests/test_torch_mesh_serve.py
    holds four ranks)."""
    tcfg, tparams = base["tcfg"], base["tparams"]
    store = base["stores"]["hard"][1]
    kw = dict(max_slots=2, max_seq=64)
    err, match = NotImplementedError, None
    if case == "continuous":
        out = []
        for cont in (False, True):
            eng = TEngine(tcfg, tparams, store, precompute=False,
                          continuous=cont, **kw)
            reqs = _requests(TRequest, base["prompts"])
            eng.run_until_drained(list(reqs))
            assert all(r.done for r in reqs)
            out.append([r.generated for r in reqs])
        assert out[0] == out[1]
        eng.page_alloc.check()
        eng.mask_alloc.check()
        return
    if case in ("hetero", "hetero_soft"):
        jax_tokens, windowed, continuous = _hetero_per_step(
            base, "hard" if case == "hetero" else "soft")
        assert windowed == jax_tokens
        assert continuous == windowed
        return
    if case in ("fault_plan", "obs"):
        from repro.resilience import FaultPlan as JPlan
        from repro_torch.obs import Observability
        from repro_torch.resilience import FaultPlan
        runs = []
        for port, extra in ((False, {}), (True, {}),
                            (True, {"obs": Observability()})):
            if case == "fault_plan" and extra:
                continue
            if case == "fault_plan":
                extra = {"fault_plan": (FaultPlan if port else JPlan)(
                    fail_pids=(1,))}
            cls, eng_cls = (TRequest, TEngine) if port else \
                (JRequest, JEngine)
            eng = eng_cls(tcfg if port else base["cfg"],
                          tparams if port else base["params"],
                          base["stores"]["hard"][int(port)],
                          precompute=False, **kw, **extra)
            reqs = _requests(cls, base["prompts"])
            eng.run_until_drained(list(reqs))
            st = eng.serve_stats()
            runs.append(([r.generated for r in reqs],
                         [r.uid for r in reqs if r.degraded],
                         st["host_syncs"], st["degraded_requests"]))
        assert runs[1] == runs[0]
        if case == "fault_plan":
            assert runs[1][1] == [1, 5]
        else:
            assert not runs[1][1] and runs[2] == runs[1]
            counters = extra["obs"].metrics.snapshot()["counters"]
            assert counters["serve.decode_tokens"] == eng.decode_tokens
        return
    if case == "mesh":
        import torch.distributed as dist
        from repro_torch.launch.mesh import make_mesh
        dist.init_process_group("gloo", store=dist.FileStore(
            str(tmp_path / "store"), 1), rank=0, world_size=1)
        out = []
        try:
            for mesh in (None, make_mesh((1, 1), ("data", "model"), "cpu")):
                eng = TEngine(tcfg, tparams, store, precompute=False,
                              mesh=mesh, **kw)
                reqs = _requests(TRequest, base["prompts"])
                eng.run_until_drained(list(reqs))
                out.append([r.generated for r in reqs])
        finally:
            dist.destroy_process_group()
        assert out[0] == out[1]
        assert eng.serve_stats()["devices"] == 1
        return
    if case == "spec":
        tcfg = tcfg.with_(spec_enable=True)
        err, match = ValueError, "continuous=True"
    elif case == "quant_per_step":
        tcfg = tcfg.with_xpeft(bank_quant="int8")
        kw["precompute"], err, match = False, ValueError, "precompute"
    else:
        tcfg = tcfg.with_xpeft(bank_quant="int8")
        store, err, match = base["stores"]["soft"][1], ValueError, "hard"
    with pytest.raises(err, match=match):
        TEngine(tcfg, tparams, store, **kw)
