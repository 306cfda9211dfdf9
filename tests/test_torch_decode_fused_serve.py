"""The port's model and windowed engine on the decode megakernel route
(``ModelConfig.decode_fused``) against the port's composed path and the
JAX package, on the CPU.

Config: ``reduce_for_smoke(get_config("qwen1.5-0.5b"))`` at float32 with
JAX's own weights carried across by ``repro_torch.bridge``; workload the
slice-1 serve one (``examples/serve_multiprofile.py``'s: 4 hard-mask
profiles, 6 requests of 6-10 prompt tokens and 8 new tokens on 3 slots,
max_seq 64). On the CPU the fused route runs the plain decode block.

Tolerances: float32 at rtol = atol = 1e-5 (other summation orders).
Greedy tokens must be equal, or differ only where JAX's top-2 logit gap
is below 1e-4 (a float32 tie).
"""
import numpy as np
import jax
import pytest
import torch

from repro.configs import get_config, reduce_for_smoke
from repro.core import xpeft as JXP
from repro.core.profiles import ProfileStore as JStore
from repro.serve.engine import Request as JRequest
from repro.serve.engine import ServeEngine as JEngine
from repro_torch import bridge
from repro_torch.configs import get_config as tget_config
from repro_torch.configs import reduce_for_smoke as treduce
from repro_torch.core.profiles import ProfileStore as TStore
from repro_torch.models import model as TMDL
from repro_torch.serve import Request as TRequest
from repro_torch.serve import ServeEngine as TEngine

F32_TOL = dict(rtol=1e-5, atol=1e-5)
TIE_GAP = 1e-4
ARCH = "qwen1.5-0.5b"


def test_megakernel_ineligible_shapes_compose():
    """T>1 (prefill) and cacheless forwards must keep the composed path:
    the route resolver returns None for them."""
    cfg = treduce(tget_config(ARCH)).with_(decode_fused=True)
    masks = {"a_hat": None}
    assert TMDL._decode_fused_route(cfg, masks, True, 1) == "bf16"
    assert TMDL._decode_fused_route(cfg, masks, True, 4) is None
    assert TMDL._decode_fused_route(cfg, masks, False, 1) is None
    assert TMDL._decode_fused_route(cfg, None, True, 1) == "none"
    off = cfg.with_(decode_fused=False)
    assert TMDL._decode_fused_route(off, masks, True, 1) is None


# ----------------------------------------------------------------------------
# one decode step and the engine
# ----------------------------------------------------------------------------

@pytest.fixture(scope="module")
def served():
    """The slice-1 serve workload (``examples/serve_multiprofile.py``'s):
    reduced qwen1.5-0.5b at float32, 4 hard-mask profiles, 6 requests on 3
    slots; JAX's engine with ``decode_fused=True`` run once."""
    cfg = reduce_for_smoke(get_config(ARCH)).with_(decode_fused=True)
    tcfg = treduce(tget_config(ARCH)).with_(decode_fused=True)
    key = jax.random.key(0)
    from repro.models import init_lm as jinit_lm
    params = jax.jit(jinit_lm, static_argnums=1)(key, cfg)
    table = jax.tree.map(np.asarray, JXP.init_profile_table(key, cfg))
    xp = cfg.xpeft
    jstore = JStore(cfg.num_layers, xp.num_adapters, xp.bottleneck, "hard",
                    xp.k)
    tstore = TStore(cfg.num_layers, xp.num_adapters, xp.bottleneck, "hard",
                    xp.k)
    for pid in range(4):
        row = {k: v[pid] for k, v in table.items()}
        jstore.add_profile(pid, row)
        tstore.add_profile(pid, row)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, size=6 + i % 5)
               for i in range(6)]
    jeng = JEngine(cfg, params, jstore, max_slots=3, max_seq=64,
                   precompute=True, continuous=False)
    jreqs = _requests(JRequest, prompts)
    jeng.run_until_drained(list(jreqs))
    return dict(cfg=cfg, tcfg=tcfg, params=params, jeng=jeng, jreqs=jreqs,
                tparams=bridge.to_torch(jax.tree.map(np.asarray, params)),
                tstore=tstore, prompts=prompts)


def _requests(cls, prompts):
    return [cls(uid=i, prompt=p, profile_id=i % 4, max_new_tokens=8)
            for i, p in enumerate(prompts)]


def _serve_port(s, fused):
    eng = TEngine(s["tcfg"].with_(decode_fused=fused), s["tparams"],
                  s["tstore"], max_slots=3, max_seq=64, sync_every=8)
    reqs = _requests(TRequest, s["prompts"])
    eng.run_until_drained(list(reqs))
    return eng, reqs


def _top2_gap(s, req, step):
    """JAX's top-2 logit gap where token `step` of a request was made,
    recomputed uncached (composed) from the prompt and the tokens before."""
    from repro.models import forward as jforward
    from repro.models import lm_logits as jlm_logits
    cfg, params = s["cfg"].with_(decode_fused=False), s["params"]
    entry = s["jeng"].profile_cache.peek(req.profile_id)
    masks = jax.tree.map(lambda v: v[None], entry)
    seq = np.concatenate([req.prompt, req.generated[:step]])[None]
    h, _, _ = jforward(params, seq.astype(np.int32), cfg,
                       profile_masks=masks)
    top = np.sort(np.asarray(jlm_logits(params, h[:, -1:], cfg))[0, 0])
    return float(top[-1] - top[-2])


def _assert_same_tokens(s, got, want):
    for g, w in zip(got, want):
        assert g.done and len(g.generated) == len(w.generated) == 8
        diff = [i for i, (a, b) in enumerate(zip(g.generated, w.generated))
                if a != b]
        if diff:  # only a float32 near-tie may flip a greedy token
            assert _top2_gap(s, w, diff[0]) < TIE_GAP, \
                (g.uid, g.generated, w.generated)


def test_fused_decode_step_matches_composed_f32(served):
    """One cached decode step at per-slot positions (one slot past the
    cache's end) through the fused route and through the composed path,
    within the port: hidden states and both caches agree."""
    tcfg, tparams = served["tcfg"], served["tparams"]
    B, P, S = 3, 8, 12
    rng = np.random.default_rng(4)
    toks = torch.from_numpy(rng.integers(0, tcfg.vocab_size, (B, P)))
    entries = [served["jeng"].profile_cache.peek(pid) for pid in range(B)]
    masks = {k: torch.from_numpy(np.stack([np.asarray(e[k])
                                           for e in entries]))
             for k in entries[0]}
    composed = tcfg.with_(decode_fused=False)
    cache = TMDL.init_cache(tcfg, B, S, device="cpu")
    TMDL.forward(tparams, toks, tcfg, profile_masks=masks, cache=cache,
                 cache_pos=0)
    lens = torch.tensor([5, 8, S], dtype=torch.int32)
    last = torch.from_numpy(rng.integers(0, tcfg.vocab_size, (B, 1)))
    out = {}
    for name, cfg in (("fused", tcfg), ("composed", composed)):
        c = {k: v.clone() for k, v in cache.items()}
        h, c, _ = TMDL.forward(tparams, last, cfg, profile_masks=masks,
                               cache=c, cache_pos=lens)
        out[name] = (h, c)
    (hf, cf), (hc, cc) = out["fused"], out["composed"]
    np.testing.assert_allclose(hf.numpy(), hc.numpy(), **F32_TOL)
    for key in ("k", "v"):
        np.testing.assert_allclose(cf[key].numpy(), cc[key].numpy(),
                                   **F32_TOL)
        # the slot past the end wrote nothing
        assert torch.equal(cf[key][:, 2], cache[key][:, 2])


def test_fused_engine_tokens_match_jax_and_composed(served):
    _, fused = _serve_port(served, fused=True)
    _assert_same_tokens(served, fused, served["jreqs"])
    eng, composed = _serve_port(served, fused=False)
    _assert_same_tokens(served, fused, composed)
    assert eng.serve_stats()["decode_tokens"] == \
        served["jeng"].serve_stats()["decode_tokens"]


def test_spec_with_decode_fused_refused(served):
    cfg = served["tcfg"].with_(spec_enable=True)
    with pytest.raises(ValueError, match="exclusive"):
        TEngine(cfg, served["tparams"], served["tstore"])
