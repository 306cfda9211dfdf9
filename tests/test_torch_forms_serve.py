"""The port's serving engines on gemma-2b (embed_scale, MQA, GLU-GELU) and
gemma3-27b (the sliding-window/global mix) against the JAX package's, on
the CPU.

Configs: ``reduce_for_smoke`` (2 layers, d=64, float32; gemma3's window 8
with a global layer every 2; bank N=8, b=4, k=2), JAX's weights and
profile logits carried across by ``repro_torch.bridge``. Workload:
``benchmarks/cb_smoke.py``'s skewed requests (6 requests, 2 slots,
max_seq 64, sync_every 4, page_size 16; prompts of 3-12 tokens, the long
ones 20 new tokens, so prompt and generation cross the window).

Greedy tokens EQUAL JAX's for the windowed, continuous and speculative
(gamma 3) engines; within the port continuous equals windowed and spec
equals plain (float32). With ``decode_fused=True`` the port's gemma-2b
engine (the decode megakernel's plain version on the CPU) gives JAX's
``decode_fused`` engine's tokens; gemma3's sliding layers keep the
composed route (as JAX decides it): the megakernel is never called and
the tokens are the composed run's.
"""
import numpy as np
import jax
import pytest

from repro.configs import get_config, reduce_for_smoke
from repro.core import xpeft as JXP
from repro.models import model as JMDL
from repro.serve.engine import Request as JRequest
from repro.serve.engine import ServeEngine as JEngine
from repro_torch import bridge
from repro_torch.configs import get_config as tget_config
from repro_torch.configs import reduce_for_smoke as treduce
from repro_torch.kernels import ops
from repro_torch.models import model as TMDL
from repro_torch.serve import Request as TRequest
from repro_torch.serve import ServeEngine as TEngine

from test_torch_serve_continuous import ENGINE, _stores, skewed_requests

ARCHS = ["gemma-2b", "gemma3-27b"]
N_PROFILES = 3
SPEC = dict(spec_enable=True, spec_gamma=3)


@pytest.fixture(scope="module", params=ARCHS)
def setup(request):
    cfg = reduce_for_smoke(get_config(request.param))
    tcfg = treduce(tget_config(request.param))
    key = jax.random.key(0)
    params = jax.jit(JMDL.init_lm, static_argnums=1)(key, cfg)
    table = jax.tree.map(np.asarray, JXP.init_profile_table(key, cfg))
    rows = [{k: np.array(v[pid]) for k, v in table.items()}
            for pid in range(N_PROFILES)]
    return dict(arch=request.param, cfg=cfg, tcfg=tcfg, params=params,
                rows=rows, runs={},
                tparams=bridge.to_torch(jax.tree.map(np.asarray, params)))


def drain(s, *, port, continuous, cfg_kw=None):
    """The skewed workload drained by one engine; memoized per setup."""
    key = (port, continuous, repr(cfg_kw))
    if key not in s["runs"]:
        cfg = (s["tcfg"] if port else s["cfg"]).with_(**(cfg_kw or {}))
        store = _stores(cfg, s["rows"])[int(port)]
        eng = (TEngine if port else JEngine)(
            cfg, s["tparams"] if port else s["params"], store,
            continuous=continuous, **ENGINE)
        reqs = skewed_requests(TRequest if port else JRequest,
                               cfg.vocab_size, 6, long_new=20)
        eng.run_until_drained(list(reqs))
        assert all(r.done for r in reqs)
        s["runs"][key] = (eng, {r.uid: list(map(int, r.generated))
                                for r in reqs})
    return s["runs"][key]


@pytest.mark.parametrize("continuous", [False, True])
def test_engine_tokens_equal_jax(setup, continuous):
    eng, toks = drain(setup, port=True, continuous=continuous)
    jeng, jtoks = drain(setup, port=False, continuous=continuous)
    assert toks == jtoks
    st, jst = eng.serve_stats(), jeng.serve_stats()
    for key in ("device_steps", "decode_tokens", "prefill_batches"):
        assert st[key] == jst[key], key
    assert max(len(t) for t in toks.values()) + 12 > \
        setup["cfg"].sliding_window
    if continuous:
        assert toks == drain(setup, port=True, continuous=False)[1]
        eng.page_alloc.check()


def test_spec_tokens_equal_jax(setup):
    _, plain = drain(setup, port=True, continuous=True)
    eng, toks = drain(setup, port=True, continuous=True, cfg_kw=SPEC)
    jeng, jtoks = drain(setup, port=False, continuous=True, cfg_kw=SPEC)
    assert toks == jtoks == plain
    assert eng.serve_stats()["spec"] == jeng.serve_stats()["spec"]
    assert eng.serve_stats()["spec"]["drafted"] > 0


def test_decode_fused_tokens(setup, monkeypatch):
    calls = []
    real = ops.decode_block_fused

    def spy(*args, **kwargs):
        calls.append(kwargs["act_name"])
        return real(*args, **kwargs)
    monkeypatch.setattr(ops, "decode_block_fused", spy)
    kw = dict(cfg_kw=dict(decode_fused=True))
    _, toks = drain(setup, port=True, continuous=False, **kw)
    if setup["arch"] == "gemma-2b":
        assert TMDL._decode_fused_route(setup["tcfg"].with_(
            decode_fused=True), None, True, 1) == "none"
        assert calls and set(calls) == {"gelu"}
        _, jtoks = drain(setup, port=False, continuous=False, **kw)
        assert toks == jtoks
    else:
        assert TMDL._decode_fused_route(setup["tcfg"].with_(
            decode_fused=True), None, True, 1) is None
        assert not calls
        assert toks == drain(setup, port=True, continuous=False)[1]
