"""The port's encoder training (the classification branch) against the
JAX package, on the CPU.

Config: reduced ``bert-base-xpeft`` as ``benchmarks/common.py``'s
``bench_config`` builds it (2 layers, d=64, float32, 4 labels, vocab 256,
N=16, k=4, b=4, 8 profiles), batches of 4 x 8 tokens from
``ProfileClassification``. JAX's train state comes across through
``repro_torch.bridge``; JAX's Gumbel draws (``jax.random.gumbel`` on the
two halves of the step's key) are injected into the port's hard-mask step
as ``noise``. Modes: xpeft with hard and with soft masks (the table plus
per-profile heads), adapter (one adapter, its LN and a head) and
head_only (a head on the bare PLM).

Tolerances, stated before any run (those of ``test_torch_train.py``):
- loss rtol 1e-5; accuracy equal; each gradient leaf rtol 1e-4 with atol
  1e-6 x that leaf's max |g| (other summation orders, and the
  straight-through softmax).
- new params rtol 1e-5 and atol 1e-6 x lr, or, where the gradient sits
  at rounding level for Adam's eps, the gradient tolerance propagated
  through g / (|g| + eps) (counted and printed); the moments m rtol 1e-4,
  v rtol 2e-4 (atol 1e-6 / 2e-6 x the leaf's max).
- after 3 xpeft steps: JAX's trained profiles packed by the port's store
  byte-equal to JAX's store (records with heads, checksums), ``head``
  equal; each package's own trained profiles with the k-hot bits
  byte-equal, and the fp16 fields equal but where the two fp32 values,
  ~1e-7 apart after three Adam steps at lr 3e-2, straddle an fp16
  rounding midpoint: there one fp16 step apart (counted and printed).
"""
import os
import subprocess
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs import get_config, reduce_for_smoke
from repro.core.profiles import ProfileStore as JStore
from repro.data import ProfileClassification as JData
from repro.train import steps as JST
from repro_torch import bridge
from repro_torch.configs import get_config as tget_config
from repro_torch.configs import reduce_for_smoke as treduce
from repro_torch.core.profiles import ProfileStore as TStore
from repro_torch.data import ProfileClassification as TData
from repro_torch.train import steps as TST
from repro_torch.utils.tree import tree_leaves

ROOT = os.path.join(os.path.dirname(__file__), "..")
ARCH = "bert-base-xpeft"
B, T, LABELS, P = 4, 8, 4, 8
LR = 3e-2
# (mode, mask type) of each train state
ARMS = [("xpeft", "hard"), ("xpeft", "soft"), ("adapter", "hard"),
        ("head_only", "hard")]


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _cfgs(mask_type="hard"):
    def build(get, reduce):
        return reduce(get(ARCH)).with_(num_labels=LABELS, vocab_size=256) \
            .with_xpeft(num_adapters=16, k=4, max_profiles=P,
                        mask_type=mask_type)
    return build(get_config, reduce_for_smoke), build(tget_config, treduce)


@pytest.fixture(scope="module", params=ARMS, ids=lambda a: "-".join(a))
def states(request):
    mode, mask_type = request.param
    cfg, tcfg = _cfgs(mask_type)
    jstate = jax.jit(JST.init_train_state, static_argnums=(1, 2))(
        jax.random.key(0), cfg, mode)
    return mode, cfg, tcfg, jstate, bridge.to_torch(_np(jstate))


def _batch(step=0):
    return JData(256, LABELS, P, seed=11).sample(step, B, T)


def _noise(key, cfg, mb):
    """JAX's Gumbel draws of a step's key, as its hard-mask step takes
    them."""
    ka, kb = jax.random.split(key)
    shape = (mb, cfg.num_layers, cfg.xpeft.num_adapters)
    return tuple(torch.tensor(np.asarray(jax.random.gumbel(k, shape)))
                 for k in (ka, kb))


def _rng(mode, cfg, key, mb):
    """The step's noise; None where the step draws none (soft masks, the
    other modes)."""
    hard = mode == "xpeft" and cfg.xpeft.mask_type == "hard"
    return _noise(key, cfg, mb) if hard else None


def _close_tree(got, want, rtol, atol_rel=0.0, what=""):
    jl = jax.tree_util.tree_leaves_with_path(want)
    tl = tree_leaves(got)
    assert len(jl) == len(tl)
    for (path, w), g in zip(jl, tl):
        w = np.asarray(w, np.float32)
        g = g.detach().float().numpy()
        tol = atol_rel * np.abs(w).max()
        np.testing.assert_allclose(
            g, w, rtol=rtol, atol=tol,
            err_msg=f"{what}{jax.tree_util.keystr(path)}")


_JSTEPS = {}


def _jax_step(mode, accum, cfg):
    """JAX's jitted train step (one compile per arm and accum)."""
    key = (mode, cfg.xpeft.mask_type, accum)
    if key not in _JSTEPS:
        _JSTEPS[key] = jax.jit(JST.make_train_step(cfg, mode, lr=LR,
                                                   accum=accum))
    return _JSTEPS[key]


def test_data_and_train_state_match_jax(states):
    mode, _, tcfg, jstate, tstate = states
    for step in (0, 2):
        want = JData(256, LABELS, P, seed=11).sample(step, B, T)
        got = TData(256, LABELS, P, seed=11).sample(step, B, T)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])
    back = bridge.to_numpy(tstate)
    assert jax.tree.structure(back) == jax.tree.structure(_np(jstate))
    # the port's own init draws the same tree
    own = bridge.to_numpy(TST.init_train_state(tcfg, mode, seed=0,
                                               device="cpu"))
    assert jax.tree.structure(own) == jax.tree.structure(back)
    for a, b in zip(jax.tree.leaves(own), jax.tree.leaves(back)):
        assert a.shape == b.shape and a.dtype == b.dtype
    heads = {"xpeft": "heads", "adapter": "head", "head_only": "head"}[mode]
    assert heads in tstate["trainable"]
    if mode == "head_only":
        assert sorted(tstate["trainable"]) == ["head"]


def test_one_step_loss_accuracy_and_grads_match_jax_grad(states):
    mode, cfg, tcfg, jstate, tstate = states
    batch = _batch()
    key = jax.random.key(11)
    jnew, jm = _jax_step(mode, 1, cfg)(
        jstate, jax.tree.map(jnp.asarray, batch), key)
    # jax.grad's gradient, from JAX's first moment m = (1 - b1) g clipped
    gn = float(jm["grad_norm"])
    jg = jax.tree.map(lambda m: np.asarray(m) / 0.1 * max(gn, 1.0),
                      jnew["opt"]["m"])
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    leaves = jax.tree.map(lambda p: p.detach().requires_grad_(True),
                          tstate["trainable"])
    total, tm = TST.loss_for_batch(tstate["frozen"], leaves, tb, tcfg, mode,
                                   _rng(mode, cfg, key, B))
    total.backward()
    np.testing.assert_allclose(float(tm["loss"].detach()), float(jm["loss"]),
                               rtol=1e-5)
    assert float(tm["accuracy"]) == float(jm["accuracy"])
    tg = jax.tree.map(lambda p: p.grad if p.grad is not None
                      else torch.zeros_like(p), leaves)
    _close_tree(tg, jg, rtol=1e-4, atol_rel=1e-6, what=f"{mode} grad ")
    head = jg["heads" if mode == "xpeft" else "head"]["head_w"]
    assert float(np.abs(head).max()) > 0


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
        g = np.abs(np.asarray(g, np.float32))
        dg = 1e-4 * g + 1e-6 * g.max()
        prop = LR * dg * eps / (np.maximum(g - dg, 0) + eps) ** 2
        base = 1e-6 * LR + 1e-5 * np.abs(w)
        err = np.abs(t - w)
        n_round += int((err > base).sum())
        bad = err > base + np.minimum(prop, 2 * LR)
        assert not bad.any(), (label, jax.tree_util.keystr(path),
                               err[bad].max())
    return n_round


@pytest.mark.parametrize("accum", [1, 2])
def test_make_train_step_matches_jax(states, accum):
    mode, cfg, tcfg, jstate, tstate = states
    batch = _batch(1)
    key = jax.random.key(12)
    jnew, jm = _jax_step(mode, accum, cfg)(
        jstate, jax.tree.map(jnp.asarray, batch), key)
    tstep = TST.make_train_step(tcfg, mode, lr=LR, accum=accum)
    tnew, tm = tstep(tstate, batch, _rng(mode, cfg, key, B // accum))
    assert sorted(tm) == sorted(jm)
    for k in ("loss", "aux_loss"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5,
                                   atol=1e-7)
    assert float(tm["accuracy"]) == float(jm["accuracy"])
    np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]),
                               rtol=1e-4)
    jg = jax.tree.map(lambda m: np.asarray(m) / 0.1, jnew["opt"]["m"])
    n_round = _check_new_params(tnew["trainable"], jnew["trainable"],
                                jstate["trainable"], jg, mode)
    print(f"{mode}/{cfg.xpeft.mask_type} accum={accum}: {n_round} param "
          "elements held to the propagated bound")
    _close_tree(tnew["opt"]["m"], jnew["opt"]["m"], rtol=1e-4,
                atol_rel=1e-6, what=f"{mode} m ")
    _close_tree(tnew["opt"]["v"], jnew["opt"]["v"], rtol=2e-4,
                atol_rel=2e-6, what=f"{mode} v ")
    assert int(tnew["opt"]["step"]) == int(jnew["opt"]["step"]) == 1


def _profile(tr, pid):
    return {**{k: v[pid] for k, v in tr["table"].items()},
            **{k: v[pid] for k, v in tr["heads"].items()}}


def test_three_steps_pack_byte_equal_records_with_heads():
    """Three xpeft steps, then the table and its heads packed into hard
    stores. The same trainables (JAX's) pack byte-equal in both stores:
    every field and checksum, ``head`` equal. Each package's own trained
    profiles: the k-hot mask bits byte-equal; an fp16 field (LN affines,
    head) may differ only where the two fp32 values (within the step's
    tolerance) straddle an fp16 rounding midpoint, by one fp16 step. A
    record stored without a head answers None in both."""
    cfg, tcfg = _cfgs()
    jstate = jax.jit(JST.init_train_state, static_argnums=(1, 2))(
        jax.random.key(0), cfg, "xpeft")
    tstate = bridge.to_torch(_np(jstate))
    h0 = tstate["trainable"]["heads"]["head_w"].clone()
    jstep = _jax_step("xpeft", 1, cfg)
    tstep = TST.make_train_step(tcfg, "xpeft", lr=LR)
    for i in range(3):
        key = jax.random.key(100 + i)
        batch = _batch(i)
        jstate, _ = jstep(jstate, jax.tree.map(jnp.asarray, batch), key)
        tstate, _ = tstep(tstate, batch, _noise(key, cfg, B))
    xp = cfg.xpeft
    jtr, ttr = _np(jstate["trainable"]), tstate["trainable"]
    assert not torch.equal(ttr["heads"]["head_w"], h0)
    shape = (cfg.num_layers, xp.num_adapters, xp.bottleneck, "hard", xp.k)
    js, ts, own = JStore(*shape), TStore(*shape), TStore(*shape)
    for pid in range(P):
        js.add_profile(pid, _profile(jtr, pid))
        ts.add_profile(pid, _profile(bridge.to_torch(jtr), pid))
        own.add_profile(pid, _profile(ttr, pid))
    n_fp16 = 0
    for pid in range(P):
        assert sorted(ts._rec[pid]) == sorted(js._rec[pid]) \
            == sorted(own._rec[pid])
        for k, want in js._rec[pid].items():
            assert ts._rec[pid][k].tobytes() == want.tobytes(), (pid, k)
            got = own._rec[pid][k]
            if k in ("mA", "mB"):
                assert got.tobytes() == want.tobytes(), (pid, k)
                continue
            diff = got != want
            n_fp16 += int(diff.sum())
            src = "table" if k.startswith("ln_") else "heads"
            jv, tv = jtr[src][k][pid], ttr[src][k][pid].numpy()
            np.testing.assert_allclose(tv, jv, rtol=1e-4,
                                       atol=1e-6 * np.abs(jv).max())
            steps = np.abs(got.view(np.int16).astype(np.int32)
                           - want.view(np.int16).astype(np.int32))
            assert (steps[diff] == 1).all() and (jv[diff] != tv[diff]).all()
        assert ts._crc[pid] == js._crc[pid]
        (tw, tb), (jw, jb) = ts.head(pid), js.head(pid)
        assert tw.dtype == tb.dtype == torch.float32
        np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
        np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    print(f"{n_fp16} fp16 values one step apart in each package's own "
          "trained records")
    js.add_profile(P, {k: v[0] for k, v in jtr["table"].items()})
    ts.add_profile(P, {k: v[0] for k, v in ttr["table"].items()})
    assert js.head(P) is None and ts.head(P) is None


def test_launcher_head_only_on_cpu():
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--smoke",
         "--device", "cpu", "--mode", "head_only", "--steps", "2"], env=env,
        cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "final loss" in out.stdout
