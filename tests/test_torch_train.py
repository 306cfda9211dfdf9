"""The port's train step and optimizer against the JAX package, on the CPU.

Config: ``reduce_for_smoke(get_config("qwen1.5-0.5b"))`` (2 layers, d=64,
vocab 512, N=8, b=4, k=2, float32), max_profiles 4, batches of 4 x 8
tokens from ``MarkovLM``. JAX's train state comes across through
``repro_torch.bridge``; JAX's own Gumbel draws (``jax.random.gumbel`` on
the two halves of the step's key, as ``profile_mask_weights`` splits it)
are injected into the port's step as ``noise``.

Tolerances, stated before any run:
- AdamW, the schedule and clipping: the same fp32 operations in the same
  order -> rtol 1e-6 (XLA's and ATen's pow/sqrt may differ in the last
  bit).
- one train step: loss rtol 1e-5; each gradient leaf rtol 1e-4 with atol
  1e-6 x that leaf's max |g| (the two frameworks sum in other orders, and
  the straight-through gradient passes through a softmax over the
  noise-shifted logits); the k-hot forward selection bitwise.
- new params: Adam's first update is p - lr x g / (|g| + eps) per
  element (g clipped), rtol 1e-5 and atol 1e-6 x lr. Where the gradient
  sits near Adam's eps, g / (|g| + eps) turns the gradient tolerance above
  into up to lr x dg x eps / (|g| - dg + eps)^2: such elements (the
  gradient at rounding level for the update) are counted and reported by
  the test and held to that propagated bound instead. Moments m, v: as the
  gradients (v, a square, rtol 2e-4 and atol 2e-6 x max v).
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs import get_config, reduce_for_smoke
from repro.data import MarkovLM as JMarkov
from repro.optim import adamw as JOPT
from repro.train import steps as JST
from repro_torch import bridge
from repro_torch.configs import get_config as tget_config
from repro_torch.configs import reduce_for_smoke as treduce
from repro_torch.data import MarkovLM as TMarkov
from repro_torch.optim import adamw as TOPT
from repro_torch.train import steps as TST
from repro_torch.utils.tree import tree_leaves

ARCH = "qwen1.5-0.5b"
B, T, P = 4, 8, 4
LR = 1e-3


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _cfgs():
    cfg = reduce_for_smoke(get_config(ARCH)).with_xpeft(max_profiles=P)
    tcfg = treduce(tget_config(ARCH)).with_xpeft(max_profiles=P)
    return cfg, tcfg


@pytest.fixture(scope="module", params=["xpeft", "adapter", "full"])
def states(request):
    cfg, tcfg = _cfgs()
    mode = request.param
    jstate = jax.jit(JST.init_train_state, static_argnums=(1, 2))(
        jax.random.key(0), cfg, mode)
    return mode, cfg, tcfg, jstate, bridge.to_torch(_np(jstate))


def _batch(step=0, batch=B):
    return JMarkov(512, P, seed=0).sample(step, batch, T)


def _noise(key, cfg, mb):
    """JAX's Gumbel draws of a step's key, as the step takes them."""
    ka, kb = jax.random.split(key)
    shape = (mb, cfg.num_layers, cfg.xpeft.num_adapters)
    return tuple(torch.tensor(np.asarray(jax.random.gumbel(k, shape)))
                 for k in (ka, kb))


def _close_tree(got, want, rtol, atol_rel=0.0, atol=0.0, what=""):
    jl = jax.tree_util.tree_leaves_with_path(want)
    tl = tree_leaves(got)
    assert len(jl) == len(tl)
    for (path, w), g in zip(jl, tl):
        w = np.asarray(w, np.float32)
        g = g.detach().float().numpy()
        tol = atol + atol_rel * np.abs(w).max()
        np.testing.assert_allclose(
            g, w, rtol=rtol, atol=tol,
            err_msg=f"{what}{jax.tree_util.keystr(path)}")


# ----------------------------------------------------------------------------
# data, optimizer
# ----------------------------------------------------------------------------

def test_markov_batches_equal_jax():
    for step in (0, 3):
        want = JMarkov(512, P, seed=7).sample(step, B, T)
        got = TMarkov(512, P, seed=7).sample(step, B, T)
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])


def _opt_trees(seed):
    rng = np.random.default_rng(seed)
    params = {"a": rng.normal(size=(3, 5)).astype(np.float32),
              "b": {"c": rng.normal(size=(7,)).astype(np.float32),
                    "d": rng.normal(size=(2, 4)).astype(np.float32)}}
    grads = jax.tree.map(lambda p: (rng.normal(size=p.shape) * 0.3)
                         .astype(np.float32), params)
    return params, grads


@pytest.mark.parametrize("total,warmup", [(10, 0), (10, 3)])
def test_linear_decay_schedule_matches_jax(total, warmup):
    js = JOPT.linear_decay_schedule(0.1, total, warmup)
    ts = TOPT.linear_decay_schedule(0.1, total, warmup)
    for step in range(0, total + 3):
        np.testing.assert_allclose(float(ts(step)), float(js(step)),
                                   rtol=1e-6)


@pytest.mark.parametrize("max_norm", [0.5, 100.0])
def test_clip_by_global_norm_matches_jax(max_norm):
    _, grads = _opt_trees(1)
    jg, jn = JOPT.clip_by_global_norm(jax.tree.map(jnp.asarray, grads),
                                      max_norm)
    tg, tn = TOPT.clip_by_global_norm(bridge.to_torch(grads), max_norm)
    np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
    _close_tree(tg, jg, rtol=1e-6)


@pytest.mark.parametrize("wd,sched", [(0.0, False), (0.01, True)])
def test_adamw_update_matches_jax(wd, sched):
    params, grads = _opt_trees(2)
    jp = jax.tree.map(jnp.asarray, params)
    tp = bridge.to_torch(params)
    jopt, topt = JOPT.adamw_init(jp), TOPT.adamw_init(tp)
    assert topt["step"].dtype == torch.int32 and topt["step"].ndim == 0
    jlr = JOPT.linear_decay_schedule(1e-2, 5, 1) if sched else 1e-2
    tlr = TOPT.linear_decay_schedule(1e-2, 5, 1) if sched else 1e-2
    for i in range(3):
        g = jax.tree.map(lambda x: x * (i + 1), grads)
        jp, jopt = JOPT.adamw_update(jax.tree.map(jnp.asarray, g), jopt, jp,
                                     lr=jlr, weight_decay=wd)
        tp, topt = TOPT.adamw_update(bridge.to_torch(g), topt, tp, lr=tlr,
                                     weight_decay=wd)
    _close_tree(tp, jp, rtol=1e-6, atol=1e-7)
    _close_tree(topt["m"], jopt["m"], rtol=1e-6, atol=1e-9)
    _close_tree(topt["v"], jopt["v"], rtol=1e-6, atol=1e-12)
    assert int(topt["step"]) == int(jopt["step"]) == 3


# ----------------------------------------------------------------------------
# one train step
# ----------------------------------------------------------------------------

def test_train_state_tree_and_bridge(states):
    mode, _, _, jstate, tstate = states
    assert sorted(tstate) == ["frozen", "opt", "trainable"]
    assert tstate["opt"]["step"].dtype == torch.int32
    assert tstate["opt"]["step"].ndim == 0
    back = bridge.to_numpy(tstate)
    assert jax.tree.structure(back) == jax.tree.structure(_np(jstate))
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(_np(jstate))):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes()


_JSTEPS = {}


def _jax_step(mode, accum, cfg):
    """JAX's jitted train step (one compile per mode and accum)."""
    if (mode, accum) not in _JSTEPS:
        _JSTEPS[mode, accum] = jax.jit(
            JST.make_train_step(cfg, mode, lr=LR, accum=accum))
    return _JSTEPS[mode, accum]


def _jax_grads(jnew, jm):
    """jax.grad's gradient inside JAX's first step, from its first moment
    m = (1 - b1) x g x min(1, 1 / |g|) (fp32: ~2e-7 relative)."""
    gn = float(jm["grad_norm"])
    return jax.tree.map(lambda m: np.asarray(m) / 0.1 * max(gn, 1.0),
                        jnew["opt"]["m"])


def test_one_step_loss_and_grads_match_jax_grad(states):
    mode, cfg, tcfg, jstate, tstate = states
    batch = _batch()
    key = jax.random.key(11)
    jnew, jm = _jax_step(mode, 1, cfg)(
        jstate, jax.tree.map(jnp.asarray, batch), key)
    jg = _jax_grads(jnew, jm)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    leaves = jax.tree.map(lambda p: p.detach().requires_grad_(True),
                          tstate["trainable"])
    total, tm = TST.loss_for_batch(tstate["frozen"], leaves, tb, tcfg, mode,
                                   _noise(key, cfg, B))
    total.backward()
    np.testing.assert_allclose(float(tm["loss"].detach()), float(jm["loss"]),
                               rtol=1e-5)
    tg = jax.tree.map(lambda p: p.grad if p.grad is not None
                      else torch.zeros_like(p), leaves)
    _close_tree(tg, jg, rtol=1e-4, atol_rel=1e-6, what=f"{mode} grad ")
    if mode == "xpeft":
        assert float(np.abs(jg["table"]["mA"]).max()) > 0


def _check_new_params(got, want, p0, jg, label):
    """New params within rtol 1e-5 / atol 1e-6 x lr, or, where the
    gradient sits at rounding level for Adam's eps, within the gradient
    tolerance propagated through g / (|g| + eps). Returns the count of
    elements outside the first bound (held to the second)."""
    eps, n_round = 1e-8, 0
    flat = zip(jax.tree_util.tree_leaves_with_path(want), tree_leaves(got),
               jax.tree.leaves(p0), jax.tree.leaves(jg))
    for (path, w), t, p, g in flat:
        w, t = np.asarray(w, np.float32), t.float().numpy()
        p, g = np.asarray(p, np.float32), np.abs(np.asarray(g, np.float32))
        dg = 1e-4 * g + 1e-6 * g.max()
        prop = LR * dg * eps / (np.maximum(g - dg, 0) + eps) ** 2
        base = 1e-6 * LR + 1e-5 * np.abs(w)
        err = np.abs(t - w)
        n_round += int((err > base).sum())
        bad = err > base + np.minimum(prop, 2 * LR)
        assert not bad.any(), (label, jax.tree_util.keystr(path),
                               np.abs(t - w)[bad].max())
    return n_round


@pytest.mark.parametrize("accum", [1, 2])
def test_make_train_step_matches_jax(states, accum):
    mode, cfg, tcfg, jstate, tstate = states
    batch = _batch()
    key = jax.random.key(11)
    jnew, jm = _jax_step(mode, accum, cfg)(
        jstate, jax.tree.map(jnp.asarray, batch), key)
    tstep = TST.make_train_step(tcfg, mode, lr=LR, accum=accum)
    tnew, tm = tstep(tstate, batch, _noise(key, cfg, B // accum))
    for k in ("loss", "aux_loss"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5,
                                   atol=1e-7)
    np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]),
                               rtol=1e-4)
    # JAX's clipped gradient, from its first moment m = (1 - b1) g
    jg = jax.tree.map(lambda m: np.asarray(m) / 0.1, jnew["opt"]["m"])
    n_round = _check_new_params(tnew["trainable"], jnew["trainable"],
                                jstate["trainable"], jg, mode)
    print(f"{mode} accum={accum}: {n_round} param elements outside rtol "
          "1e-5 / atol 1e-6 x lr, each with its gradient at rounding level "
          "for Adam's eps, held to the propagated bound")
    _close_tree(tnew["opt"]["m"], jnew["opt"]["m"], rtol=1e-4,
                atol_rel=1e-6, what=f"{mode} m ")
    _close_tree(tnew["opt"]["v"], jnew["opt"]["v"], rtol=2e-4,
                atol_rel=2e-6, what=f"{mode} v ")
    assert int(tnew["opt"]["step"]) == int(jnew["opt"]["step"]) == 1
    assert tnew["opt"]["step"].dtype == torch.int32


