"""The port's training over a heterogeneous bank, and its per-step serving,
against the JAX package, on the CPU.

Config: reduced qwen1.5-0.5b (2 layers, d=64, float32) with N=12 unified
mask slots tiled bottleneck 4 / LoRA 4 / IA3 2 / prefix 2 (P=2 rows), b=4,
k=4, 4 profiles, batches of 4 x 8 tokens from ``MarkovLM`` with profile
ids 0-3; profile 1's prefix logits are pinned at -30, so its hard masks
select no prefix slot (its renormalization divides 0 by 0). JAX's train
state comes across through ``repro_torch.bridge`` and JAX's Gumbel draws
are injected as ``noise``. Per-step serving uses the same spec without
its prefix segment (per-step serving cannot hydrate prefix rows), its
two slots given to the matmul families: bottleneck 5 / LoRA 5 / IA3 2.

Tolerances (as ``tests/test_torch_train.py``'s): loss rtol 1e-5; each
gradient leaf rtol 1e-4 with atol 1e-6 x its max |g|; packed hard
records byte-equal after 3 steps; greedy tokens equal to JAX's engine.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs import get_config, reduce_for_smoke
from repro.core import xpeft as JXP
from repro.core.profiles import ProfileStore as JStore
from repro.data import MarkovLM as JMarkov
from repro.serve.engine import Request as JRequest
from repro.serve.engine import ServeEngine as JEngine
from repro.train import steps as JST
from repro_torch import bridge
from repro_torch.configs import get_config as tget_config
from repro_torch.configs import reduce_for_smoke as treduce
from repro_torch.core.profiles import ProfileStore as TStore
from repro_torch.serve import Request as TRequest
from repro_torch.serve import ServeEngine as TEngine
from repro_torch.train import steps as TST
from repro_torch.utils.tree import tree_leaves

ARCH = "qwen1.5-0.5b"
B, T, NP = 4, 8, 4
LR = 1e-3
SPEC = (("bottleneck", 4), ("lora", 4), ("ia3", 2), ("prefix", 2))
SERVE_SPEC = (("bottleneck", 5), ("lora", 5), ("ia3", 2))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _cfgs(spec=SPEC, mask_type="hard"):
    kw = dict(num_adapters=12, bottleneck=4, k=4, max_profiles=NP,
              bank_spec=spec, prefix_tokens=2, mask_type=mask_type)
    return (reduce_for_smoke(get_config(ARCH)).with_xpeft(**kw),
            treduce(tget_config(ARCH)).with_xpeft(**kw))


def _batch(step=0):
    b = JMarkov(512, NP, seed=0).sample(step, B, T)
    b["profile_ids"] = np.arange(B, dtype=np.int32) % NP
    return b


def _noise(key, cfg):
    """JAX's Gumbel draws of a step's key, as its step takes them."""
    ka, kb = jax.random.split(key)
    shape = (B, cfg.num_layers, cfg.xpeft.num_adapters)
    return tuple(torch.tensor(np.asarray(jax.random.gumbel(k, shape)))
                 for k in (ka, kb))


def _pin_no_prefix(jstate, cfg):
    """Profile 1's prefix-segment logits at -30: never in its top-k."""
    off, cnt = next((o, c) for t, o, c in cfg.xpeft.segments()
                    if t == "prefix")
    table = dict(jstate["trainable"]["table"])
    for m in ("mA", "mB"):
        table[m] = table[m].at[1, :, off:off + cnt].set(-30.0)
    return dict(jstate, trainable=dict(jstate["trainable"], table=table))


def _init(mask_type):
    cfg, tcfg = _cfgs(mask_type=mask_type)
    jstate = jax.jit(JST.init_train_state, static_argnums=(1, 2))(
        jax.random.key(0), cfg, "xpeft")
    jstate = _pin_no_prefix(jstate, cfg)
    return cfg, tcfg, jstate, bridge.to_torch(_np(jstate))


@pytest.mark.parametrize("mask_type", ["hard", "soft"])
def test_one_step_loss_and_grads_match_jax_grad(mask_type):
    cfg, tcfg, jstate, tstate = _init(mask_type)
    batch = _batch()
    key = jax.random.key(11)

    def jloss(trainable):
        total, m = JST.loss_for_batch(
            jstate["frozen"], trainable, jax.tree.map(jnp.asarray, batch),
            cfg, "xpeft", key)
        return total, m
    (_, jm), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        jstate["trainable"])
    leaves = jax.tree.map(lambda p: p.detach().requires_grad_(True),
                          tstate["trainable"])
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    total, tm = TST.loss_for_batch(tstate["frozen"], leaves, tb, tcfg,
                                   "xpeft", _noise(key, cfg))
    total.backward()
    np.testing.assert_allclose(float(tm["loss"].detach()), float(jm["loss"]),
                               rtol=1e-5)
    jl = jax.tree_util.tree_leaves_with_path(jg)
    tl = tree_leaves(jax.tree.map(lambda p: p.grad, leaves))
    assert len(jl) == len(tl)
    for (path, w), g in zip(jl, tl):
        w = np.asarray(w, np.float32)
        assert torch.isfinite(g).all(), jax.tree_util.keystr(path)
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-4,
                                   atol=1e-6 * np.abs(w).max(),
                                   err_msg=jax.tree_util.keystr(path))
    assert float(np.abs(np.asarray(jg["table"]["mA"])).max()) > 0


@pytest.fixture(scope="module")
def trained():
    """Three hard-mask steps in both frameworks from the same state."""
    cfg, tcfg, jstate, tstate = _init("hard")
    m0 = tstate["trainable"]["table"]["mA"].clone()
    jstep = jax.jit(JST.make_train_step(cfg, "xpeft", lr=LR))
    tstep = TST.make_train_step(tcfg, "xpeft", lr=LR)
    for i in range(3):
        key = jax.random.key(100 + i)
        batch = _batch(i)
        jstate, _ = jstep(jstate, jax.tree.map(jnp.asarray, batch), key)
        tstate, tm = tstep(tstate, batch, _noise(key, cfg))
        assert np.isfinite(float(tm["loss"]))
    assert not torch.equal(tstate["trainable"]["table"]["mA"], m0)
    return cfg, tcfg, jstate, tstate


def _stores(cfg, jtab, ttab, mask_type="hard"):
    xp = cfg.xpeft
    shape = (cfg.num_layers, xp.num_adapters, xp.bottleneck, mask_type,
             xp.k)
    js = JStore(*shape, bank_spec=xp.bank_spec)
    ts = TStore(*shape, bank_spec=xp.bank_spec)
    for pid in range(NP):
        js.add_profile(pid, {k: np.asarray(v[pid]) for k, v in jtab.items()})
        ts.add_profile(pid, {k: v[pid] for k, v in ttab.items()})
    return js, ts


def test_three_steps_pack_byte_equal_records(trained):
    cfg, _, jstate, tstate = trained
    js, ts = _stores(cfg, _np(jstate["trainable"]["table"]),
                     tstate["trainable"]["table"])
    for pid in range(NP):
        assert sorted(ts._rec[pid]) == sorted(js._rec[pid])
        for key in js._rec[pid]:
            assert ts._rec[pid][key].tobytes() == \
                js._rec[pid][key].tobytes(), (pid, key)
        assert ts._crc[pid] == js._crc[pid]
    # profile 1 still selects no prefix slot
    off, cnt = next((o, c) for t, o, c in cfg.xpeft.segments()
                    if t == "prefix")
    sel = [np.isin(np.concatenate([np.asarray(ts.sparse_indices(p)[i])
                                   for i in (0, 2)]),
                   np.arange(off, off + cnt)).any() for p in range(NP)]
    assert not sel[1]


def _prompts(vocab, n=6):
    rng = np.random.default_rng(0)
    return [rng.integers(0, vocab, size=6 + i % 5) for i in range(n)]


def _serve(eng, cls, prompts):
    reqs = [cls(uid=i, prompt=p, profile_id=i % NP, max_new_tokens=8)
            for i, p in enumerate(prompts)]
    eng.run_until_drained(list(reqs))
    assert all(r.done for r in reqs)
    return reqs


def test_trained_store_served_precompute_matches_jax(trained):
    """The packed hetero store (prefix rows included) admitted k-sparse
    and served windowed: tokens and prefix lengths equal JAX's engine."""
    cfg, tcfg, jstate, tstate = trained
    js, ts = _stores(cfg, _np(jstate["trainable"]["table"]),
                     tstate["trainable"]["table"])
    prompts = _prompts(cfg.vocab_size)
    jreqs = _serve(JEngine(cfg, jstate["frozen"], js, max_slots=3,
                           max_seq=64), JRequest, prompts)
    treqs = _serve(TEngine(tcfg, tstate["frozen"], ts, max_slots=3,
                           max_seq=64), TRequest, prompts)
    for t, j in zip(treqs, jreqs):
        assert t.generated == j.generated, t.uid
        assert t.prefix_len == j.prefix_len, t.uid
    assert treqs[1].prefix_len == 0


@pytest.fixture(scope="module")
def serve_setup():
    out = {}
    for mask_type in ("hard", "soft"):
        cfg, tcfg = _cfgs(SERVE_SPEC, mask_type)
        params = jax.jit(JST.MDL.init_lm, static_argnums=1)(
            jax.random.key(0), cfg)
        table = _np(JXP.init_profile_table(jax.random.key(1), cfg))
        js, ts = _stores(cfg, table, bridge.to_torch(table), mask_type)
        out[mask_type] = (cfg, tcfg, params,
                          bridge.to_torch(_np(params)), js, ts)
    return out


@pytest.mark.parametrize("continuous", [False, True])
@pytest.mark.parametrize("mask_type", ["hard", "soft"])
def test_per_step_hetero_serving_matches_jax(serve_setup, mask_type,
                                             continuous):
    cfg, tcfg, params, tparams, js, ts = serve_setup[mask_type]
    prompts = _prompts(cfg.vocab_size)
    kw = dict(max_slots=3, max_seq=64, precompute=False,
              continuous=continuous)
    jeng = JEngine(cfg, params, js, **kw)
    jreqs = _serve(jeng, JRequest, prompts)
    eng = TEngine(tcfg, tparams, ts, **kw)
    treqs = _serve(eng, TRequest, prompts)
    assert [r.generated for r in treqs] == [r.generated for r in jreqs]
    st, jst = eng.serve_stats(), jeng.serve_stats()
    for key in ("decode_tokens", "device_steps", "host_syncs",
                "prefill_batches", "stranded_slot_steps"):
        assert st[key] == jst[key], key
    assert eng.last_admission["path"] == "per_step"
    assert sorted(eng._masks_view if continuous else eng.masks) == \
        ["ln_bias", "ln_scale", "w_a", "w_b"]
