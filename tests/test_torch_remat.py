"""``cfg.remat`` in the port's training forward, against the JAX package's
``jax.checkpoint`` of each layer, on the CPU.

Configs: ``reduce_for_smoke`` of qwen1.5-0.5b and qwen3-moe-30b-a3b (2
layers, d=64, float32; the MoE with 8 experts, top-2), max_profiles 4,
batches of 4 x 8 tokens from ``MarkovLM``; JAX's Gumbel draws injected
into the port's step as ``noise``. One gang step of the lm roster (3
slots, one parked).

Stated before any run:
- across ``remat`` none, full and dots the port's loss and every
  trainable gradient are BITWISE equal: the recompute replays the layer's
  forward on the same inputs (the noise is drawn before the layer loop;
  MoE capacity routing is deterministic);
- each mode's loss and gradients equal ``jax.value_and_grad`` of JAX's
  loss with the same ``cfg.remat`` within rtol = atol = 1e-5 (JAX's
  functions compiled with XLA's backend optimizations off, for the test's
  time: a change of rounding far below that tolerance);
- the op counter (``analysis/op_cost.py``) sees the recompute exactly:
  FLOPs(full) - FLOPs(none) equals the layers' forward FLOPs counted under
  ``no_grad`` (the forward's FLOPs less those of the same forward with no
  layer), and FLOPs(dots) - FLOPs(none) equals that less the FLOPs of the
  layers' products with no batch dims, whose outputs "dots" keeps.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs import get_config, reduce_for_smoke
from repro.data import MarkovLM as JMarkov
from repro.train import roster as JR
from repro.train import steps as JST
from repro_torch import bridge
from repro_torch.analysis import op_cost as OC
from repro_torch.configs import get_config as tget_config
from repro_torch.configs import reduce_for_smoke as treduce
from repro_torch.core import xpeft as TXP
from repro_torch.models import model as MDL
from repro_torch.train import roster as TR
from repro_torch.train import steps as TST
from repro_torch.utils.tree import tree_leaves

B, T, P = 4, 8, 4
MODES = ("none", "full", "dots")
M_PER_SLOT, SEQ = 2, 8


# XLA:CPU's backend optimizations off: compiles ~2x faster
_FAST = {"xla_backend_optimization_level": 0,
         "xla_llvm_disable_expensive_passes": True}


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _run(f, *args):
    """``jax.jit(f)(*args)``, compiled with ``_FAST``."""
    return jax.jit(f).lower(*args).compile(compiler_options=_FAST)(*args)


def _noise(key, cfg, rows):
    ka, kb = jax.random.split(key)
    shape = (rows, cfg.num_layers, cfg.xpeft.num_adapters)
    return tuple(torch.tensor(np.asarray(jax.random.gumbel(k, shape)))
                 for k in (ka, kb))


def _close(got, want, what):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=1e-5, atol=1e-5, err_msg=what)


@pytest.fixture(scope="module", params=["qwen1.5-0.5b", "qwen3-moe-30b-a3b"])
def setup(request):
    arch = request.param
    cfg = reduce_for_smoke(get_config(arch)).with_xpeft(max_profiles=P)
    tcfg = treduce(tget_config(arch)).with_xpeft(max_profiles=P)
    # the port's init, carried into JAX (no JAX compile for it)
    tstate = TST.init_train_state(tcfg, "xpeft", device="cpu")
    jstate = jax.tree.map(jnp.asarray, bridge.to_numpy(tstate))
    batch = JMarkov(512, P, seed=0).sample(0, B, T)
    return cfg, tcfg, jstate, tstate, batch


def _port_step(tcfg, tstate, batch, noise, remat):
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    return TST.grads_for_batch(tstate["frozen"], tstate["trainable"], tb,
                               tcfg.with_(remat=remat), "xpeft", noise)


def test_train_step_bitwise_across_remat_and_equal_jax(setup):
    cfg, tcfg, jstate, tstate, batch = setup
    key = jax.random.key(11)
    noise = _noise(key, cfg, B)
    got = {m: _port_step(tcfg, tstate, batch, noise, m) for m in MODES}
    g0, m0 = got["none"]
    for mode in ("full", "dots"):
        g, m = got[mode]
        for k in ("loss", "aux_loss"):
            assert torch.equal(m[k], m0[k]), (mode, k)
        for a, b in zip(tree_leaves(g), tree_leaves(g0)):
            assert torch.equal(a, b), mode
    jb = jax.tree.map(jnp.asarray, batch)

    def jgrads(trainable):
        """JAX's loss and gradients under each remat, in one compile."""
        out = {}
        for mode in MODES:
            jcfg = cfg.with_(remat=mode)
            out[mode] = jax.value_and_grad(
                lambda t: JST.loss_for_batch(jstate["frozen"], t, jb, jcfg,
                                             "xpeft", key),
                has_aux=True)(trainable)
        return out
    jall = _run(jgrads, jstate["trainable"])
    for mode in MODES:
        (_, jm), jg = jall[mode]
        g, m = got[mode]
        _close(m["loss"], jm["loss"], f"{mode} loss")
        _close(m["aux_loss"], jm["aux_loss"], f"{mode} aux")
        jl = jax.tree_util.tree_leaves_with_path(jg)
        assert len(jl) == len(tree_leaves(g))
        for (path, w), t in zip(jl, tree_leaves(g)):
            _close(t, w, f"{mode} grad {jax.tree_util.keystr(path)}")
        assert float(np.abs(np.asarray(jg["table"]["mA"])).max()) > 0


class _SavedDots(OC.OpCounter):
    """Also sums the FLOPs of the products "dots" keeps."""

    def __init__(self):
        super().__init__()
        self.saved = 0.0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = super().__torch_dispatch__(func, types, args, kwargs)
        if MDL.saves_dot(func, args):
            self.saved += OC.op_flops(func, args, out)
        return out


def test_op_counter_sees_the_recompute_exactly():
    tcfg = treduce(tget_config("qwen1.5-0.5b")).with_xpeft(max_profiles=P)
    tstate = TST.init_train_state(tcfg, "xpeft", device="cpu")
    batch = JMarkov(512, P, seed=0).sample(0, B, T)
    gen = torch.Generator().manual_seed(5)
    shape = (B, tcfg.num_layers, tcfg.xpeft.num_adapters)
    noise = tuple(-torch.log(torch.empty(shape).exponential_(generator=gen))
                  for _ in range(2))
    flops = {}
    for mode in MODES:
        with OC.OpCounter() as c:
            _port_step(tcfg, tstate, batch, noise, mode)
        flops[mode] = c.flops
    # the same forward under no_grad, with its layers and without
    ids = torch.from_numpy(batch["profile_ids"]).long()
    prof = {k: v[ids] for k, v in tstate["trainable"]["table"].items()}
    w_a, w_b = TXP.profile_mask_weights(prof, tcfg.xpeft, noise=noise)
    masks = {"w_a": w_a, "w_b": w_b, "ln_scale": prof["ln_scale"],
             "ln_bias": prof["ln_bias"]}
    tokens = torch.from_numpy(batch["tokens"])

    def forward(cfg):
        with torch.no_grad(), _SavedDots() as c:
            MDL.forward(tstate["frozen"], tokens, cfg, profile_masks=masks)
        return c
    full, bare = forward(tcfg), forward(tcfg.with_(num_layers=0))
    layers = full.flops - bare.flops
    kept = full.saved - bare.saved
    assert layers > 0 and 0 < kept < layers
    assert flops["full"] - flops["none"] == layers
    assert flops["dots"] - flops["none"] == layers - kept


def _gang_states(cfg, tcfg, S, pids):
    tfrozen = MDL.init_lm(tcfg, device="cpu")
    frozen = jax.tree.map(jnp.asarray, bridge.to_numpy(tfrozen))
    jroster = JR.Roster(cfg, jax.random.key(7), S)
    jr = JR.init_roster_state(jax.random.key(1), cfg, S)
    troster = TR.Roster(tcfg, 7, S, device="cpu")
    tr = bridge.to_torch(_np(jr))
    for slot, pid in enumerate(pids):
        if pid is None:
            continue
        jr = jroster.admit(jr, slot, pid)
        fresh = _np(jroster._fresh(jroster.profile_key(pid)))
        troster.admit(tr, slot, pid, fresh=bridge.to_torch(fresh))
    return frozen, jr, tfrozen, tr


def test_gang_step_bitwise_across_remat_and_equal_jax():
    cfg = reduce_for_smoke(get_config("qwen1.5-0.5b"))
    tcfg = treduce(tget_config("qwen1.5-0.5b"))
    S, pids = 3, [4, 1, None]
    frozen, jr, tfrozen, tr = _gang_states(cfg, tcfg, S, pids)
    rows = np.repeat([0 if p is None else p for p in pids], M_PER_SLOT)
    b = JMarkov(cfg.vocab_size, 8, seed=1).sample(0, S * M_PER_SLOT, SEQ,
                                                   profile_ids=rows)
    batch = {k: np.asarray(v).reshape((S, M_PER_SLOT) + v.shape[1:])
             for k, v in b.items()}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    key = jax.random.key(100)
    noise = _noise(key, cfg, S * M_PER_SLOT)
    got = {m: TST.gang_loss_and_grads(tfrozen, tr, tb, tcfg.with_(remat=m),
                                      noise) for m in MODES}
    for mode in ("full", "dots"):
        assert torch.equal(got[mode][1], got["none"][1]), mode
        for a, b in zip(tree_leaves(got[mode][0]),
                        tree_leaves(got["none"][0])):
            assert torch.equal(a, b), mode
    jb = jax.tree.map(jnp.asarray, batch)

    def jsteps(state):
        """JAX's gang step under each remat, clipping off (its first
        moment is then (1 - b1) x its gradient), in one compile."""
        return {m: JST.make_gang_step(cfg.with_(remat=m), lr=1e-3,
                                      clip_norm=1e9)(state, jb, key)[0]
                for m in MODES}
    jall = _run(jsteps, {"frozen": frozen, "roster": jr})
    for mode in MODES:
        jnew = jall[mode]
        want = jax.tree.map(lambda m: np.asarray(m) / np.float32(0.1),
                            jnew["roster"]["opt"]["m"])
        grads, slot_loss, _ = got[mode]
        jl = jax.tree_util.tree_leaves_with_path(want)
        assert len(jl) == len(tree_leaves(grads))
        for (path, w), t in zip(jl, tree_leaves(grads)):
            _close(t, w, f"{mode} gang grad {jax.tree_util.keystr(path)}")
        ema = np.asarray(jnew["roster"]["ema_loss"]) / np.float32(0.1)
        _close(slot_loss[:2], ema[:2], f"{mode} slot loss")
