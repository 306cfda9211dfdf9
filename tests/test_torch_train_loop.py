"""The port's training loop against the JAX package, on the CPU: the
chunked LM loss, three train steps packed into the store, the step's own
Gumbel draws, head_only and a classification head on the decoder, the
gang step's refusal, and the launcher.

Config: ``reduce_for_smoke(get_config("qwen1.5-0.5b"))`` (2 layers, d=64,
vocab 512, N=8, b=4, k=2, float32), max_profiles 4, batches of 4 x 8
tokens from ``MarkovLM``, JAX's state carried across by the bridge and
JAX's Gumbel draws injected as ``noise``.

Tolerances, stated before any run: the chunked loss rtol 1e-5 and its
gradient rtol 1e-4 with atol 1e-6 x max |g| (as ``test_torch_train.py``'s
gradients), equal to the unchunked loss within rtol 1e-6; after 3 steps
the packed hard records (and their checksums) byte-equal to JAX's.
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
from repro.data import MarkovLM as JMarkov
from repro.train import steps as JST
from repro_torch import bridge
from repro_torch.configs import get_config as tget_config
from repro_torch.configs import reduce_for_smoke as treduce
from repro_torch.core.profiles import ProfileStore as TStore
from repro_torch.train import steps as TST
from repro_torch.utils.tree import tree_leaves

ROOT = os.path.join(os.path.dirname(__file__), "..")
ARCH = "qwen1.5-0.5b"
B, T, P = 4, 8, 4
LR = 1e-3


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _cfgs():
    cfg = reduce_for_smoke(get_config(ARCH)).with_xpeft(max_profiles=P)
    tcfg = treduce(tget_config(ARCH)).with_xpeft(max_profiles=P)
    return cfg, tcfg


def _batch(step=0):
    return JMarkov(512, P, seed=0).sample(step, B, T)


def _noise(key, cfg):
    """JAX's Gumbel draws of a step's key, as its step takes them."""
    ka, kb = jax.random.split(key)
    shape = (B, cfg.num_layers, cfg.xpeft.num_adapters)
    return tuple(torch.tensor(np.asarray(jax.random.gumbel(k, shape)))
                 for k in (ka, kb))


def test_lm_loss_chunked_with_t_over_chunk():
    cfg, tcfg = _cfgs()
    jparams = jax.jit(JST.MDL.init_lm, static_argnums=1)(jax.random.key(2),
                                                         cfg)
    tparams = bridge.to_torch(_np(jparams))
    rng = np.random.default_rng(4)
    hidden = rng.normal(size=(2, 16, cfg.d_model)).astype(np.float32)
    labels = rng.integers(0, cfg.vocab_size, size=(2, 16)).astype(np.int32)
    def jfn(h):
        return JST.lm_loss_chunked(jparams, h, jnp.asarray(labels), cfg,
                                   chunk=8)
    jl, jgrad = jax.jit(jax.value_and_grad(jfn))(jnp.asarray(hidden))
    th = torch.from_numpy(hidden).requires_grad_(True)
    tl = TST.lm_loss_chunked(tparams, th, torch.from_numpy(labels), tcfg,
                             chunk=8)
    tl.backward()
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    np.testing.assert_allclose(th.grad.numpy(), np.asarray(jgrad),
                               rtol=1e-4, atol=1e-6 * np.abs(jgrad).max())
    whole = TST.lm_loss(TST.MDL.lm_logits(tparams, th, tcfg),
                        torch.from_numpy(labels))
    np.testing.assert_allclose(float(tl), float(whole), rtol=1e-6)


def test_three_steps_pack_byte_equal_records():
    """ROADMAP queue 1, item 3, gate 2: after N steps the packed records
    are byte-equal."""
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
        jstate, _ = jstep(jstate, jax.tree.map(jnp.asarray, batch), key)
        tstate, _ = tstep(tstate, batch, _noise(key, cfg))
    xp = cfg.xpeft
    jtab = _np(jstate["trainable"]["table"])
    ttab = tstate["trainable"]["table"]
    for mask_type in ("hard", "soft"):
        shape = (cfg.num_layers, xp.num_adapters, xp.bottleneck, mask_type,
                 xp.k)
        js, ts = JStore(*shape), TStore(*shape)
        for pid in range(P):
            js.add_profile(pid, {k: v[pid] for k, v in jtab.items()})
            ts.add_profile(pid, {k: v[pid] for k, v in ttab.items()})
        for pid in range(P):
            if mask_type == "hard":
                for key in js._rec[pid]:
                    assert ts._rec[pid][key].tobytes() == \
                        js._rec[pid][key].tobytes(), (pid, key)
                assert ts._crc[pid] == js._crc[pid]
    assert not torch.equal(ttab["mA"], m0)


def test_generator_noise_and_refusals(tmp_path):
    _, tcfg = _cfgs()
    state = TST.init_train_state(tcfg, "xpeft", seed=0, device="cpu")
    step = TST.make_train_step(tcfg, "xpeft", accum=2)
    gen = torch.Generator().manual_seed(3)
    new, m = step(state, _batch(), gen)
    assert np.isfinite(float(m["loss"])) and float(m["grad_norm"]) > 0
    assert not torch.equal(new["trainable"]["table"]["mA"],
                           state["trainable"]["table"]["mA"])
    # head_only and a classification head build and step (the encoder's
    # branch): under the LM objective no trainable reaches the loss, so
    # head_only's gradient is zero, as jax.grad's is
    hstate = TST.init_train_state(tcfg, "head_only", device="cpu")
    _, hm = TST.make_train_step(tcfg, "head_only")(hstate, _batch(), None)
    assert np.isfinite(float(hm["loss"])) and float(hm["grad_norm"]) == 0
    ccfg = tcfg.with_(num_labels=3)
    cstate = TST.init_train_state(ccfg, "xpeft", seed=0, device="cpu")
    cbatch = dict(_batch(), labels=np.array([0, 2, 1, 2], np.int32))
    cnew, cm = TST.make_train_step(ccfg, "xpeft")(cstate, cbatch, gen)
    assert np.isfinite(float(cm["loss"])) and 0 <= float(cm["accuracy"]) <= 1
    assert not torch.equal(cnew["trainable"]["heads"]["head_w"],
                           cstate["trainable"]["heads"]["head_w"])
    # the gang step on a mesh: a world-1 gloo group's 1x1 mesh keeps the
    # roster whole and steps bitwise as with no mesh
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import init_lm
    from repro_torch.train.roster import Roster, init_roster_state

    dist.init_process_group("gloo", store=dist.FileStore(
        str(tmp_path / "pg"), 1), rank=0, world_size=1)
    try:
        mesh = make_mesh((1, 1), ("data", "model"), "cpu")
        frozen = init_lm(tcfg, seed=0, device="cpu")
        toks = np.random.default_rng(0).integers(0, tcfg.vocab_size,
                                                 (2, 2, 9))
        gbatch = {"tokens": toks[..., :-1], "labels": toks[..., 1:]}
        out = []
        for mm in (mesh, None):
            roster = Roster(tcfg, 2, 2, device="cpu", mesh=mm)
            rstate = roster.place(init_roster_state(tcfg, 2, device="cpu"))
            for slot in range(2):
                roster.admit(rstate, slot, slot)
            _, gm = TST.make_gang_step(tcfg, mesh=mm)(
                {"frozen": frozen, "roster": rstate}, gbatch,
                torch.Generator().manual_seed(5))
            out.append((rstate, float(gm["loss"])))
    finally:
        dist.destroy_process_group()
    (a, la), (b, lb) = out
    assert la == lb and all(
        torch.equal(x, y) for x, y in zip(tree_leaves(a), tree_leaves(b)))


def test_launcher_smoke_on_cpu():
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--smoke",
         "--device", "cpu", "--steps", "3"], env=env, cwd=ROOT,
        capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "final loss" in out.stdout
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--smoke",
         "--device", "cpu", "--steps", "1", "--mesh", "2x1:data,model"],
        env=env, cwd=ROOT, capture_output=True, text=True, timeout=120)
    # --mesh joins the process group torchrun describes: without torchrun
    # its environment is missing
    assert out.returncode != 0 and "RANK" in out.stderr


@pytest.fixture
def keep_signals():
    """The launcher's main installs a PreemptionHandler for SIGTERM and
    SIGINT; put the test process's handlers back afterwards."""
    import signal
    saved = {s: signal.getsignal(s) for s in (signal.SIGTERM, signal.SIGINT)}
    yield
    for s, h in saved.items():
        signal.signal(s, h)


def test_launcher_checkpoint_and_resume(tmp_path, capsys, keep_signals):
    """--ckpt-dir writes checkpoints; --resume continues from the last
    one, and the resumed run ends bitwise the uninterrupted one."""
    from repro_torch.launch import train as LT
    base = ["--smoke", "--device", "cpu", "--batch", "4", "--seq", "8"]
    whole = LT.main(base + ["--steps", "4"])
    ck = str(tmp_path / "ck")
    LT.main(base + ["--steps", "2", "--ckpt-dir", ck, "--ckpt-every", "2"])
    out = LT.main(base + ["--steps", "2", "--ckpt-dir", ck, "--resume"])
    assert "resumed from step 2" in capsys.readouterr().out
    assert out["trainer"].step == 4
    assert [r["step"] for r in out["history"]] == [3, 4]
    for k, v in whole["state"]["trainable"]["table"].items():
        assert torch.equal(out["state"]["trainable"]["table"][k], v)


def test_launcher_onboard_writes_loadable_store(tmp_path, keep_signals):
    """--onboard drains the stream into a store ProfileStore.load reads,
    with the obs exports (--metrics-json, --trace) valid."""
    from repro_torch import obs as OBS
    from repro_torch.launch import train as LT
    sp, m, t = (str(tmp_path / n) for n in ("s.npz", "m.json", "t.json"))
    trainer = LT.main(["--onboard", "--smoke", "--device", "cpu",
                       "--profiles", "3", "--roster-slots", "2",
                       "--per-slot-batch", "2", "--seq", "8",
                       "--graduate-min-steps", "2",
                       "--graduate-max-steps", "4", "--log-every", "2",
                       "--store-out", sp, "--ckpt-dir",
                       str(tmp_path / "ck"), "--ckpt-every", "4",
                       "--metrics-json", m, "--trace", t])
    assert trainer.scheduler.finished()
    loaded = TStore.load(sp)
    assert loaded.profile_ids() == [0, 1, 2]
    assert not loaded.quarantined_ids()
    import json
    counters = json.loads(open(m).read())["counters"]
    assert counters["train.graduated"] == 3
    assert counters["train.steps"] == trainer.step
    assert OBS.validate_chrome_trace(json.loads(open(t).read())) is None
