"""The float8_e4m3fn KV cache (``cache_dtype="float8_e4m3fn"``): the port's
engine and model against the JAX package's, on the CPU.

Workload: ``tests/test_torch_serve_continuous.py``'s (the skewed requests
of ``benchmarks/cb_smoke.py``, reduced qwen1.5-0.5b at float32 with JAX's
weights and profile logits carried across by the bridge, 2 slots, max_seq
64, sync_every 4, page_size 16), both packages' configs with
``cache_dtype="float8_e4m3fn"``; one JAX model build for the module.

Contracts:
- greedy tokens of the port's engine EQUAL JAX's engine's on five paths:
  windowed composed, windowed ``decode_fused`` (the plain decode block on
  the CPU), per-step mask weights (``precompute=False``), continuous on a
  5-page pool that preempts, and continuous self-speculation (gamma 3). A
  token that differs must sit on a JAX top-2 logit gap below TIE_GAP (as
  ``tests/test_torch_serve.py``): at float32 the two frameworks agree to
  ~1e-6 before the cache's rounding, which only a near-tie turns into a
  flip;
- the port's engine holds its K/V leaves in float8_e4m3fn, one byte a
  value;
- after one prefill the port's float8 cache equals JAX's as float8
  values. An element apart must be exactly one e4m3 step apart: the two
  frameworks compute K and V in float32 in other orders, and a value
  within ~1e-7 of an e4m3 rounding midpoint may round to either
  neighbour. The count is printed (0 of 49,152 when this was written).
"""
import numpy as np
import jax
import pytest
import torch

from repro.models import forward as jforward
from repro.models import lm_logits as jlm_logits
from repro.models.model import init_cache as jinit_cache
from repro_torch.models import model as MDL

from test_torch_decode_fused import _e4m3_ordinal
from test_torch_serve_continuous import _setup, drain

F8 = "float8_e4m3fn"
TIE_GAP = 1e-4
# the five paths: (continuous, drain options beyond cache_dtype)
PATHS = {
    "windowed": (False, {}),
    "decode_fused": (False, dict(cfg_kw=dict(decode_fused=True))),
    "per_step": (False, dict(precompute=False)),
    "continuous_preempting": (True, dict(long_new=50, max_pages=5)),
    "spec": (True, dict(cfg_kw=dict(spec_enable=True, spec_gamma=3))),
}


@pytest.fixture(scope="module")
def setup():
    torch.set_num_threads(1)  # idle intra-op threads spin under xdist
    return _setup()


def _drain(setup, port, continuous, opts):
    opts = dict(opts)
    cfg_kw = dict(opts.pop("cfg_kw", {}), cache_dtype=F8)
    return drain(setup, port=port, continuous=continuous, cfg_kw=cfg_kw,
                 **opts)


def _entry_masks(jeng, pids):
    """JAX's precomputed entries of ``pids``, stacked per row (numpy)."""
    rows = [jeng.profile_cache.peek(p) for p in pids]
    return {k: np.stack([np.asarray(r[k]) for r in rows]) for k in rows[0]}


def _top2_gap(setup, jeng, req, step):
    """JAX's top-2 logit gap at the step that produced token ``step`` of
    ``req``: the prompt and the tokens before it prefilled at once through
    a float8 cache (each K/V row written, then read back in float8, as the
    engine's steps read it), the profile's precomputed entry applied."""
    cfg = setup["cfg"].with_(cache_dtype=F8)
    masks = jax.tree.map(lambda v: v[None], jeng.profile_cache.peek(
        req.profile_id))
    seq = np.concatenate([req.prompt, req.generated[:step]])[None]
    h, _, _ = jforward(setup["params"], seq.astype(np.int32), cfg,
                       profile_masks=masks, cache=jinit_cache(cfg, 1, 64),
                       cache_pos=0)
    top = np.sort(np.asarray(jlm_logits(setup["params"], h[:, -1:], cfg))
                  [0, 0])
    return float(top[-1] - top[-2])


@pytest.mark.parametrize("path", list(PATHS))
def test_f8_tokens_equal_jax(setup, path):
    continuous, opts = PATHS[path]
    eng, toks, reqs = _drain(setup, True, continuous, opts)
    jeng, jtoks, jreqs = _drain(setup, False, continuous, opts)
    data = eng.cache["data"] if continuous else eng.cache
    assert {v.dtype for v in data.values()} == {torch.float8_e4m3fn}
    assert eng.kv_pool_bytes() == sum(v.numel() for v in data.values())
    wjeng = _drain(setup, False, False, {})[0]  # precomputed entries
    flips = 0
    for treq, jreq in zip(reqs, jreqs):
        assert treq.uid == jreq.uid and treq.done
        assert len(treq.generated) == len(jreq.generated)
        diff = [i for i, (a, b) in enumerate(zip(treq.generated,
                                                 jreq.generated)) if a != b]
        if diff:  # only a near-tie may flip a greedy token
            flips += 1
            assert _top2_gap(setup, wjeng, jreq, diff[0]) < TIE_GAP, \
                (path, treq.uid, treq.generated, jreq.generated)
    print(f"{path}: {flips} of {len(reqs)} requests part from JAX's")
    st, jst = eng.serve_stats(), jeng.serve_stats()
    for key in ("device_steps", "decode_tokens", "prefill_batches"):
        assert st[key] == jst[key], (path, key)
    if path == "continuous_preempting":
        assert st["preemptions"] > 0 and st["resumes"] > 0, st
        for key in ("preemptions", "resumes"):
            assert st[key] == jst[key], key
        eng.page_alloc.check()
        eng.mask_alloc.check()
    if path == "spec":
        assert st["spec"] == jst["spec"]
        assert st["committed_per_device_step"] > 1.0


def test_f8_prefill_cache_equals_jax(setup):
    """One prefill of three 8-token prompts through each package's model
    into a float8 cache, each prompt with its profile's precomputed entry
    (JAX's, carried across): the caches equal as float8 values, or one
    e4m3 step apart."""
    cfg = setup["cfg"].with_(cache_dtype=F8)
    tcfg = setup["tcfg"].with_(cache_dtype=F8)
    jeng = _drain(setup, False, False, {})[0]
    masks = _entry_masks(jeng, [0, 1, 2])
    tokens = np.random.default_rng(3).integers(
        0, cfg.vocab_size, size=(3, 8)).astype(np.int32)
    _, jcache, _ = jforward(setup["params"], tokens, cfg,
                            profile_masks=masks,
                            cache=jinit_cache(cfg, 3, 64), cache_pos=0)
    tcache = MDL.init_cache(tcfg, 3, 64, device="cpu")
    with torch.no_grad():
        MDL.forward(setup["tparams"], torch.from_numpy(tokens).long(), tcfg,
                    profile_masks={k: torch.from_numpy(v)
                                   for k, v in masks.items()},
                    cache=tcache, cache_pos=0)
    apart = total = 0
    for key in ("k", "v"):
        got = tcache[key]
        want = np.asarray(jcache[key])
        assert got.dtype == torch.float8_e4m3fn
        assert str(want.dtype) == F8 and want.shape == tuple(got.shape)
        steps = np.abs(_e4m3_ordinal(got.view(torch.uint8).numpy())
                       - _e4m3_ordinal(want.view(np.uint8)))
        assert steps.max() <= 1, (key, steps.max())
        apart += int((steps == 1).sum())
        total += steps.size
        # the prompts' rows were written; the rest stays zero in both
        assert got[:, :, :8].float().abs().sum() > 0
        assert not got[:, :, 8:].float().any()
    print(f"prefill cache: {apart} of {total} float8 values one e4m3 step "
          "apart from JAX's, the rest equal")
