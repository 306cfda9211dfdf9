"""The port's training step on a mixture-of-experts decoder against the
JAX package, on the CPU.

Config: ``reduce_for_smoke(get_config("qwen3-moe-30b-a3b"))`` (2 layers,
d=64, 8 experts, top-2, capacity_factor 1.25, float32; N=8, b=4, k=2),
max_profiles 4, ``MarkovLM`` batches of 4 x 8 tokens (n=32 routed tokens
a layer: capacity 10, so routes are dropped), JAX's state carried across
by the bridge and JAX's Gumbel draws injected as ``noise``.

The load-balance aux reaches the objective as JAX's does (loss + 0.01 x
aux, the mean of the layers' aux): one step's total, ``loss`` and
``aux_loss`` within rtol 1e-5 of ``jax.value_and_grad``'s, the trainable
gradients (the xpeft table; with ``mode="full"`` every weight, the router
and the experts included) within rtol 1e-4 and atol 1e-6 x the leaf's
largest |gradient|, as ``tests/test_torch_train.py``. After 3 steps the
packed hard records and their checksums are byte-equal to JAX's.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs import get_config, reduce_for_smoke
from repro.core.profiles import ProfileStore as JStore
from repro.data import MarkovLM as JMarkov
from repro.train import steps as JST
from repro_torch import bridge
from repro_torch.configs import get_config as tget_config
from repro_torch.configs import reduce_for_smoke as treduce
from repro_torch.core.profiles import ProfileStore as TStore
from repro_torch.train import steps as TST
from repro_torch.utils.tree import tree_leaves

ARCH = "qwen3-moe-30b-a3b"
B, T, P = 4, 8, 4
LR = 1e-3


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _cfgs():
    return (reduce_for_smoke(get_config(ARCH)).with_xpeft(max_profiles=P),
            treduce(tget_config(ARCH)).with_xpeft(max_profiles=P))


def _batch(step=0):
    return JMarkov(512, P, seed=0).sample(step, B, T)


def _noise(key, cfg):
    """JAX's Gumbel draws of a step's key, as its step takes them."""
    ka, kb = jax.random.split(key)
    shape = (B, cfg.num_layers, cfg.xpeft.num_adapters)
    return tuple(torch.tensor(np.asarray(jax.random.gumbel(k, shape)))
                 for k in (ka, kb))


@pytest.fixture(scope="module", params=["xpeft", "full"])
def states(request):
    cfg, tcfg = _cfgs()
    jstate = jax.jit(JST.init_train_state, static_argnums=(1, 2))(
        jax.random.key(0), cfg, request.param)
    return request.param, cfg, tcfg, jstate, bridge.to_torch(_np(jstate))


def test_one_step_loss_aux_and_grads_match_jax(states):
    mode, cfg, tcfg, jstate, tstate = states
    batch = _batch()
    key = jax.random.key(11)

    def jloss(trainable):
        return JST.loss_for_batch(jstate["frozen"], trainable,
                                  jax.tree.map(jnp.asarray, batch), cfg,
                                  mode, key)
    (jtotal, jm), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        jstate["trainable"])
    leaves = jax.tree.map(lambda p: p.detach().requires_grad_(True),
                          tstate["trainable"])
    ttotal, tm = TST.loss_for_batch(
        tstate["frozen"], leaves,
        {k: torch.from_numpy(v) for k, v in batch.items()}, tcfg, mode,
        _noise(key, cfg))
    ttotal.backward()
    for got, want in ((ttotal, jtotal), (tm["loss"], jm["loss"]),
                      (tm["aux_loss"], jm["aux_loss"])):
        np.testing.assert_allclose(float(got.detach()), float(want),
                                   rtol=1e-5)
    assert float(tm["aux_loss"].detach()) > 0
    jl = jax.tree_util.tree_leaves_with_path(jg)
    # a leaf the loss does not reach (the bank in mode "full") has no
    # grad: JAX's is zeros
    tl = tree_leaves(jax.tree.map(
        lambda p: torch.zeros_like(p) if p.grad is None else p.grad, leaves))
    assert len(jl) == len(tl)
    for (path, w), g in zip(jl, tl):
        w = np.asarray(w, np.float32)
        np.testing.assert_allclose(
            g.numpy(), w, rtol=1e-4, atol=1e-6 * np.abs(w).max(),
            err_msg=jax.tree_util.keystr(path))
    if mode == "full":
        # the aux's gradient reaches the router; the experts train
        router = leaves["blocks"]["moe"]["router"].grad
        assert float(router.abs().max()) > 0
        assert float(leaves["blocks"]["moe"]["ew_g"].grad.abs().max()) > 0
    else:
        assert float(np.abs(np.asarray(jg["table"]["mA"])).max()) > 0


def test_three_steps_pack_byte_equal_records():
    cfg, tcfg = _cfgs()
    jstate = jax.jit(JST.init_train_state, static_argnums=(1, 2))(
        jax.random.key(0), cfg, "xpeft")
    tstate = bridge.to_torch(_np(jstate))
    m0 = tstate["trainable"]["table"]["mA"].clone()
    jstep = jax.jit(JST.make_train_step(cfg, "xpeft", lr=LR))
    tstep = TST.make_train_step(tcfg, "xpeft", lr=LR)
    for i in range(3):
        key = jax.random.key(100 + i)
        batch = _batch(i)
        jstate, jm = jstep(jstate, jax.tree.map(jnp.asarray, batch), key)
        tstate, tm = tstep(tstate, batch, _noise(key, cfg))
        np.testing.assert_allclose(float(tm["aux_loss"]),
                                   float(jm["aux_loss"]), rtol=1e-5)
    xp = cfg.xpeft
    jtab = _np(jstate["trainable"]["table"])
    ttab = tstate["trainable"]["table"]
    shape = (cfg.num_layers, xp.num_adapters, xp.bottleneck, "hard", xp.k)
    js, ts = JStore(*shape), TStore(*shape)
    for pid in range(P):
        js.add_profile(pid, {k: v[pid] for k, v in jtab.items()})
        ts.add_profile(pid, {k: v[pid] for k, v in ttab.items()})
        for key in js._rec[pid]:
            assert ts._rec[pid][key].tobytes() == \
                js._rec[pid][key].tobytes(), (pid, key)
        assert ts._crc[pid] == js._crc[pid]
    assert not torch.equal(ttab["mA"], m0)


def test_launchers_run_the_moe_arch(capsys):
    """``--arch qwen3-moe-30b-a3b --smoke`` through both launchers: the
    training loop's losses and aux finite, the server's tokens in range
    and those of the per-step mask path (``--no-precompute``) the same."""
    from repro_torch.launch import serve as LS
    from repro_torch.launch import train as LT
    out = LT.run(LT.parse_args(["--arch", ARCH, "--smoke", "--device",
                                "cpu", "--steps", "2", "--batch", "2",
                                "--seq", "8"]))
    assert out["cfg"].moe and len(out["history"]) == 2
    for m in out["history"]:
        assert np.isfinite(float(m["loss"])) and float(m["aux_loss"]) > 0
    toks = []
    for extra in ([], ["--no-precompute"]):
        LS.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--requests",
                 "3", "--max-new", "4"] + extra)
        lines = [ln for ln in capsys.readouterr().out.splitlines()
                 if ln.lstrip().startswith("req ")]
        assert len(lines) == 3
        toks.append(lines)
    assert toks[0] == toks[1]
