"""The port's serving engines on the recurrent block families (rwkv6-7b's
RWKV6 layers, zamba2-1.2b's Mamba2 layers with a shared attention block)
against the JAX package's engines on the CPU.

Configs: ``reduce_for_smoke`` of both archs (float32, bank N=8, b=4,
k=2), JAX's weights and profile logits carried across by the bridge, 3
profiles of hard masks; 2 slots, max_seq 64, page_size 16.

Contracts, each the JAX package's and held token for token to JAX's
engine on the same requests:

- windowed: recurrent state cannot mask pad tokens, so prompts prefill at
  EXACT length (``prefill_occupancy`` 1.0; two length-5 prompts share one
  prefill batch); tokens invariant to ``sync_every`` (twins of
  ``tests/test_serve_layers.py``'s recurrent cases);
- continuous: rwkv has no sequence-axis cache leaf, so the engine makes
  no page pool and still admits mid-stream into pooled mask entries;
  zamba's shared block pages its K/V while its conv/ssd state stays
  resident per slot. Tokens equal the windowed run's bitwise, for zamba
  through preempt/resume (four requests of (prompt, new) = (5, 40),
  (7, 45), (5, 6), (9, 30) on max_pages=5: the two long ones need 7
  pages, so the younger is swapped out with its state and resumed);
- an int8 bank (``bank_quant``) on rwkv;
- a prefix-bearing heterogeneous bank is refused by both engines.
"""
import numpy as np
import jax
import pytest

from repro.configs import get_config, reduce_for_smoke
from repro.core import xpeft as JXP
from repro.models import init_lm as jinit_lm
from repro.serve.engine import Request as JRequest
from repro.serve.engine import ServeEngine as JEngine
from repro_torch import bridge
from repro_torch.configs import get_config as tget_config
from repro_torch.configs import reduce_for_smoke as treduce
from repro_torch.serve import Request as TRequest
from repro_torch.serve import ServeEngine as TEngine

from test_torch_serve_continuous import _stores

ARCHS = ["rwkv6-7b", "zamba2-1.2b"]
N_PROFILES = 3
ENGINE = dict(max_slots=2, max_seq=64, page_size=16)
# (prompt length, new tokens) per request
SKEWED = ((5, 40), (7, 45), (5, 6), (9, 30))
EXACT = ((5, 6), (5, 6), (7, 6))


@pytest.fixture(scope="module", params=ARCHS)
def setup(request):
    cfg = reduce_for_smoke(get_config(request.param))
    tcfg = treduce(tget_config(request.param))
    key = jax.random.key(0)
    params = jax.jit(jinit_lm, static_argnums=1)(key, cfg)
    table = jax.tree.map(np.asarray, JXP.init_profile_table(key, cfg))
    rows = [{k: np.array(v[pid]) for k, v in table.items()}
            for pid in range(N_PROFILES)]
    return dict(cfg=cfg, tcfg=tcfg, params=params, rows=rows,
                tparams=bridge.to_torch(jax.tree.map(np.asarray, params)),
                runs={})


def requests(cls, vocab, shapes):
    rng = np.random.default_rng(3)
    return [cls(uid=i, prompt=rng.integers(0, vocab, T),
                profile_id=i % N_PROFILES, max_new_tokens=n)
            for i, (T, n) in enumerate(shapes)]


def drain(s, *, port, continuous=False, shapes=SKEWED, sync_every=4,
          xpeft_kw=None, store_kw=None, **kw):
    """Drain ``shapes``' requests on one engine; memoized per setup."""
    key = (port, continuous, shapes, sync_every, repr(xpeft_kw),
           repr(store_kw), repr(sorted(kw.items())))
    if key in s["runs"]:
        return s["runs"][key]
    cfg = (s["tcfg"] if port else s["cfg"]).with_xpeft(**(xpeft_kw or {}))
    store = _stores(cfg, s["rows"], **(store_kw or {}))[int(port)]
    eng = (TEngine if port else JEngine)(
        cfg, s["tparams"] if port else s["params"], store,
        continuous=continuous, sync_every=sync_every, **dict(ENGINE, **kw))
    reqs = requests(TRequest if port else JRequest, cfg.vocab_size, shapes)
    eng.run_until_drained(list(reqs))
    assert all(r.done and len(r.generated) == r.max_new_tokens
               for r in reqs)
    out = (eng, {r.uid: list(map(int, r.generated)) for r in reqs})
    s["runs"][key] = out
    return out


def test_windowed_exact_length_prefill_equals_jax(setup):
    """Two length-5 prompts share one exact-length prefill batch, the
    length-7 one takes its own: no pad rows (occupancy 1.0)."""
    teng, ttoks = drain(setup, port=True, shapes=EXACT)
    _, jtoks = drain(setup, port=False, shapes=EXACT)
    assert ttoks == jtoks
    st = teng.serve_stats()
    assert st["prefill_occupancy"] == 1.0
    assert st["prefill_batches"] == 2
    assert st["syncs_per_token"] < 1.0


def test_tokens_invariant_to_sync_cadence(setup):
    toks = [drain(setup, port=True, shapes=EXACT, sync_every=e)[1]
            for e in (1, 4)]
    assert toks[0] == toks[1]


def test_continuous_equals_windowed_and_jax(setup):
    """Bitwise the windowed tokens and JAX's continuous engine's; rwkv
    makes no page pool; zamba preempts at max_pages=5 with its recurrent
    state swapped out and back."""
    pattern = setup["cfg"].block_pattern
    kw = dict(max_pages=5) if pattern == "zamba" else {}
    _, wtoks = drain(setup, port=True)
    ceng, ctoks = drain(setup, port=True, continuous=True, **kw)
    jeng, jtoks = drain(setup, port=False, continuous=True, **kw)
    assert ctoks == wtoks == jtoks
    st, jst = ceng.serve_stats(), jeng.serve_stats()
    for key in ("preemptions", "resumes", "device_steps"):
        assert st[key] == jst[key], key
    if pattern == "rwkv":
        assert not ceng._paged and ceng.page_alloc is None
        assert "pages" not in st and st["preemptions"] == 0
    else:
        assert ceng._paged and st["preemptions"] > 0 and st["resumes"] > 0
        assert set(ceng.cache["data"]) == {"conv", "ssd", "attn_k",
                                           "attn_v"}
        ceng.page_alloc.check()
    ceng.mask_alloc.check()


@pytest.mark.parametrize("setup", ["rwkv6-7b"], indirect=True)
def test_int8_bank_equals_jax(setup):
    q = dict(xpeft_kw=dict(bank_quant="int8"),
             store_kw=dict(quant="int8",
                           quant_group=setup["cfg"].xpeft.quant_group),
             shapes=EXACT)
    teng, ttoks = drain(setup, port=True, **q)
    _, jtoks = drain(setup, port=False, **q)
    assert ttoks == jtoks
    assert teng.serve_stats()["bank_quant"] == "int8"


def test_prefix_bank_refused_by_both(setup):
    spec = (("bottleneck", 4), ("prefix", 4))
    for port in (False, True):
        cfg = (setup["tcfg"] if port else setup["cfg"]).with_xpeft(
            bank_spec=spec, prefix_tokens=2)
        store = _stores(cfg, [], bank_spec=spec)[int(port)]
        with pytest.raises(ValueError, match="pure-attention"):
            (TEngine if port else JEngine)(
                cfg, setup["tparams"] if port else setup["params"], store,
                **ENGINE)
