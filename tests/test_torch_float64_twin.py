"""``chip_smoke.float64_everywhere``, the float64 twin of a float32 train
step (the reference of phase 14's rwkv6-7b card-vs-CPU step), against the
JAX package run wholly in float64, on the CPU.

Configs: ``reduce_for_smoke`` of rwkv6-7b and zamba2-1.2b, xpeft, 4
profiles, one ``MarkovLM`` batch of 4 x 16; JAX's weights through the
bridge and JAX's float32 Gumbel draws. JAX runs under ``jax.enable_x64``
with every float32 leaf cast to float64, ``jnp.float32`` made float64
(its float32 islands: the GLA, norms, softmax) and its Gumbel draws the
float32 ones cast up; the port runs the same step inside
``float64_everywhere`` on a float64 copy of the state. Both then compute
one step in float64 throughout: the loss within 1e-12 relative and each
gradient leaf within 1e-10 relative L2 (float64's 1.1e-16 times the
amplification this step shows in float32, ~1e2: its float32 gradients
lie up to 1.1e-5 from float64, over float32's 6e-8), and the float64
arithmetic of the twin is checked: no float32 leaf left, torch restored
on exit.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import chip_smoke as cs
from repro.configs import get_config, reduce_for_smoke
from repro.data import MarkovLM as JMarkov
from repro.train import steps as JST
from repro_torch import bridge
from repro_torch.configs import get_config as tget_config
from repro_torch.configs import reduce_for_smoke as treduce
from repro_torch.utils.tree import tree_map

P = 4


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.mark.parametrize("arch", ["rwkv6-7b", "zamba2-1.2b"])
def test_float64_twin_equals_jax_in_float64(arch, monkeypatch):
    cfg = reduce_for_smoke(get_config(arch)).with_xpeft(max_profiles=P)
    tcfg = treduce(tget_config(arch)).with_xpeft(max_profiles=P)
    jstate = _np(jax.jit(JST.init_train_state, static_argnums=(1, 2))(
        jax.random.key(0), cfg, "xpeft"))
    batch = JMarkov(cfg.vocab_size, P, seed=0).sample(0, 4, 16)
    key = jax.random.key(11)
    shape = (4, cfg.num_layers, cfg.xpeft.num_adapters)
    noise = tuple(torch.tensor(np.asarray(jax.random.gumbel(k, shape)))
                  for k in jax.random.split(key))

    f32, gumbel = jnp.float32, jax.random.gumbel
    with jax.enable_x64(True):
        monkeypatch.setattr(jnp, "float32", jnp.float64)
        monkeypatch.setattr(jax.random, "gumbel", lambda k, s, dtype=None:
                            gumbel(k, s, f32).astype(jnp.float64))
        st = jax.tree.map(lambda a: jnp.asarray(
            a, jnp.float64 if a.dtype == np.float32 else a.dtype), jstate)
        c64 = cfg.with_(dtype="float64")
        (jloss, jm), jg = jax.jit(jax.value_and_grad(
            lambda tr: JST.loss_for_batch(
                st["frozen"], tr, jax.tree.map(jnp.asarray, batch), c64,
                "xpeft", key), has_aux=True))(st["trainable"])
        monkeypatch.undo()
        jg = _np(jg["table"])
        jloss = float(jm["loss"])
    assert all(v.dtype == np.float64 for v in jg.values())

    tstate = bridge.to_torch(jstate)
    r32 = cs.train_step_grads(torch, tcfg, tstate, batch, noise, "cpu")
    with cs.float64_everywhere(torch):
        st64 = tree_map(lambda t: t.double() if t.is_floating_point()
                        else t, tstate)
        r64 = cs.train_step_grads(torch, tcfg, st64, batch,
                                  tuple(n.double() for n in noise), "cpu")
    assert torch.float32 is not torch.float64
    assert torch.ones(1).float().dtype == torch.float32
    assert abs(r64["loss"] - jloss) <= 1e-12 * abs(jloss)
    for k, want in jg.items():
        got, want = r64["grads"]["table"][k], torch.tensor(want)
        assert got.dtype == torch.float64, k
        assert float(want.abs().max()) > 0, k
        err = cs.rel_l2(got, want)
        print(f"{arch} {k}: float64 twin vs JAX float64 {err:.3e}; "
              "float32 vs float64 "
              f"{cs.rel_l2(r32['grads']['table'][k], got):.3e}")
        assert err <= 1e-10, k
