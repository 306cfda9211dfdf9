"""The port's checkpoint manager, Trainer, sharded loader and fault hooks,
on the CPU: JAX's ``test_checkpoint.py``, the loader and re-balance cases
of ``test_data.py`` / ``test_fault.py``, and the checkpoint cases of
``test_resilience.py``, on the port's modules.

Config: ``reduce_for_smoke(get_config("qwen1.5-0.5b"))`` (2 layers, d=64,
vocab 512, float32) for the Trainer; small seeded numpy trees for the
manager. The manifest layout and the checkpoint keys are held to JAX's
(``tree_paths``); every restore is held bitwise, and a resumed run
bitwise to the uninterrupted one (the same ops on the same shapes).
"""
import os
import signal
import sys
import threading

import numpy as np
import pytest
import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_config, reduce_for_smoke
from repro_torch.data import MarkovLM, ShardedLoader
from repro_torch.distributed import fault as FT
from repro_torch.distributed.fault import PreemptionHandler, \
    rebalance_assignment
from repro_torch.resilience import CheckpointCorruptError, FaultPlan
from repro_torch.train.steps import init_train_state, make_train_step
from repro_torch.train.trainer import Trainer
from repro_torch.utils.tree import tree_leaves, tree_map, tree_paths


def _state(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"params": {"w": torch.randn((8, 8), generator=g),
                       "b": torch.arange(4.0),
                       "e": torch.randn((3, 5), generator=g).to(
                           torch.bfloat16)},
            "opt": {"m": torch.zeros((8, 8)),
                    "step": torch.tensor(7, dtype=torch.int32),
                    "on": torch.tensor([True, False])}}


def _equal(a, b):
    return all(x.dtype == y.dtype and torch.equal(x, y)
               for x, y in zip(tree_leaves(a), tree_leaves(b)))


def test_save_restore_bitwise(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep_last=2)
    st = _state()
    mgr.save(3, st, extra={"loader": {"step": 3}})
    out = mgr.restore(3, tree_map(torch.zeros_like, st))
    assert _equal(out, st)
    man = mgr.manifest(3)
    assert man["extra"]["loader"]["step"] == 3
    assert man["dtypes"]["params/e"] == "bfloat16"
    with np.load(tmp_path / "step_0000000003" / "state.npz") as z:
        assert sorted(z.files) == sorted(
            k.replace("/", "__") for k in tree_paths(st))
    # explicit shardings, every leaf whole: the same tree
    assert _equal(mgr.restore(3, tree_map(torch.zeros_like, st),
                              shardings=tree_map(lambda _: None, st)), st)


def test_bf16_roundtrip_without_ml_dtypes(tmp_path, monkeypatch):
    """ml_dtypes (numpy's bf16, shipped with JAX) is hidden: bf16 leaves
    save through their bits and restore bitwise, onto the like-leaf's
    dtype."""
    monkeypatch.setitem(sys.modules, "ml_dtypes", None)
    with pytest.raises(ImportError):
        import ml_dtypes  # noqa: F401
    mgr = CheckpointManager(str(tmp_path))
    st = _state(1)
    st["params"]["e"][0, 0] = -0.0
    st["params"]["e"][1, 1] = float("inf")
    mgr.save(1, st, blocking=False)
    mgr.wait()
    out = mgr.restore(1, st)
    assert out["params"]["e"].dtype == torch.bfloat16
    assert torch.equal(out["params"]["e"].view(torch.int16),
                       st["params"]["e"].view(torch.int16))
    assert _equal(out, st)


def test_keep_last_k(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep_last=2)
    for s in (1, 2, 3, 4):
        mgr.save(s, _state())
    assert mgr.all_steps() == [3, 4]
    assert mgr.latest_step() == 4


def test_async_save(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep_last=3)
    mgr.save(1, _state(), blocking=False)
    mgr.wait()
    assert mgr.all_steps() == [1]


def test_manifest_roundtrips_lifecycle_state(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    extra = {"onboarding": {
        "pending": np.arange(3, dtype=np.int64),
        "slot_pid": [np.int32(7), None],
        "slot_steps": [np.int32(12), np.int32(0)],
        "waves": np.int64(2)}}
    mgr.save(5, _state(), extra=extra)
    man = mgr.manifest(5)["extra"]["onboarding"]
    assert man["pending"] == [0, 1, 2]
    assert man["slot_pid"] == [7, None]
    assert man["slot_steps"] == [12, 0]
    assert man["waves"] == 2


def test_partial_write_invisible(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    os.makedirs(os.path.join(str(tmp_path), "step_0000000009.tmp"))
    assert mgr.all_steps() == []


def test_checkpoint_truncation_falls_back_to_last_good(tmp_path):
    state = {"w": torch.arange(8.0), "b": torch.zeros((3,))}
    plan = FaultPlan(truncate_ckpt_steps=(20,))
    mgr = CheckpointManager(str(tmp_path), keep_last=5, fault_plan=plan)
    mgr.save(10, state)
    mgr.save(20, tree_map(lambda x: x + 1, state))  # torn write
    with pytest.raises(CheckpointCorruptError):
        mgr.verify_step(20)
    assert mgr.latest_step() == 20
    assert mgr.latest_good_step() == 10
    with pytest.raises(CheckpointCorruptError):
        mgr.restore(20, state)
    got = mgr.restore(10, state)
    assert torch.equal(got["w"], torch.arange(8.0))


# ----------------------------------------------------------------------------
# the Trainer
# ----------------------------------------------------------------------------

@pytest.fixture(scope="module")
def qwen():
    return reduce_for_smoke(get_config("qwen1.5-0.5b"))


def _trainer(cfg, ckpt_dir=None, gen_seed=42, **kw):
    loader = ShardedLoader(MarkovLM(cfg.vocab_size, 4, seed=1), 4, 16)
    state = init_train_state(cfg, "xpeft", seed=0, device="cpu")
    return Trainer(make_train_step(cfg, "xpeft", lr=1e-2), state, loader,
                   ckpt_dir=ckpt_dir, rng=torch.Generator().manual_seed(
                       gen_seed), **kw)


def test_trainer_resume_bitwise(tmp_path, qwen):
    """Train 6 steps with a checkpoint at 3; resume a fresh trainer (other
    generator seed): the state, the data position and the Gumbel
    generator come back, and the run ends bitwise the straight one."""
    t1 = _trainer(qwen, log_every=1000)
    t1.run(6)
    ck = str(tmp_path / "ck")
    t2 = _trainer(qwen, ck, ckpt_every=3, log_every=1000)
    t2.run(3)
    t2.checkpoint(blocking=True)
    t3 = _trainer(qwen, ck, gen_seed=0, log_every=1000)
    assert t3.try_resume()
    assert t3.step == 3 and t3.loader.step == 3
    t3.run(3)
    assert _equal(t3.state["trainable"], t1.state["trainable"])
    assert _equal(t3.state["opt"], t1.state["opt"])
    assert torch.equal(t3.rng.get_state(), t1.rng.get_state())


def test_trainer_buffers_metrics_until_log_boundary(qwen):
    tr = _trainer(qwen, log_every=5)
    hist = tr.run(7)
    assert [r["step"] for r in hist] == list(range(1, 8))
    for r in hist:
        assert {"loss", "aux_loss", "grad_norm", "step",
                "straggler"} <= set(r)
        assert isinstance(r["loss"], float)
    assert tr.host_syncs == 2  # the step-5 boundary + the end-of-run flush


def test_trainer_resume_skips_corrupt_checkpoint(tmp_path, qwen):
    t1 = _trainer(qwen, str(tmp_path), ckpt_every=2, log_every=1000,
                  fault_plan=FaultPlan(truncate_ckpt_steps=(4,)))
    t1.run(4)   # checkpoints at 2 (good) and 4 (truncated)
    t1.mgr.wait()
    assert t1.mgr.latest_step() == 4
    t2 = _trainer(qwen, str(tmp_path), ckpt_every=2, log_every=1000)
    assert t2.try_resume()
    assert t2.step == 2  # fell back past the torn step-4 checkpoint


def test_preemption_checkpoints_and_stops(tmp_path, qwen):
    pre = PreemptionHandler.__new__(PreemptionHandler)  # no signal handler
    pre._flag = threading.Event()
    tr = _trainer(qwen, str(tmp_path), preemption=pre, log_every=1000)
    tr.run(2)
    pre.trigger()
    tr.run(10)  # stops at once, after a checkpoint
    assert tr.step == 2
    assert tr.mgr.latest_step() == 2


# ----------------------------------------------------------------------------
# loader, re-balancing, preemption signals (JAX's test_data / test_fault)
# ----------------------------------------------------------------------------

def test_sharded_loader_partition_and_resume():
    src = MarkovLM(128, 4, seed=0)
    full = ShardedLoader(src, global_batch=8, seq_len=16)
    h0 = ShardedLoader(src, 8, 16, host_id=0, num_hosts=2)
    h1 = ShardedLoader(src, 8, 16, host_id=1, num_hosts=2)
    b_full, b0, b1 = full.next(), h0.next(), h1.next()
    np.testing.assert_array_equal(
        np.concatenate([b0["tokens"], b1["tokens"]]), b_full["tokens"])
    h0b = ShardedLoader(src, 8, 16, host_id=0, num_hosts=2)
    h0b.load_state_dict(h0.state_dict())
    np.testing.assert_array_equal(h0.next()["tokens"],
                                  h0b.next()["tokens"])


def test_sharded_loader_equals_jax():
    from repro.data import MarkovLM as JMarkov
    from repro.data.loader import ShardedLoader as JLoader
    jl = JLoader(JMarkov(128, 4, seed=3), 8, 16, host_id=1, num_hosts=3,
                 speed_map={0: 0.5})
    tl = ShardedLoader(MarkovLM(128, 4, seed=3), 8, 16, host_id=1,
                       num_hosts=3, speed_map={0: 0.5})
    for _ in range(2):
        a, b = jl.next(), tl.next()
        assert sorted(a) == sorted(b)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
    assert jl.state_dict() == tl.state_dict()


def test_rebalance_downweights_straggler():
    asg = rebalance_assignment(100, [0, 1, 2, 3], {2: 0.5})
    sizes = {h: len(r) for h, r in asg.items()}
    assert sum(sizes.values()) == 100
    assert sizes[2] < sizes[0]
    assert asg == rebalance_assignment(100, [0, 1, 2, 3], {2: 0.5})
    from repro.distributed.fault import rebalance_assignment as jrebalance
    assert asg == jrebalance(100, [0, 1, 2, 3], {2: 0.5})


def test_rebalance_zero_speeds_and_empty_hosts():
    asg = rebalance_assignment(90, [0, 1, 2], {0: 0.0, 1: 0.0, 2: 0.0})
    assert sum(len(r) for r in asg.values()) == 90
    assert all(len(r) == 30 for r in asg.values())
    asg = rebalance_assignment(100, [0, 1], {0: 0.0})
    assert sum(len(r) for r in asg.values()) == 100
    assert len(asg[0]) < len(asg[1])
    with pytest.raises(ValueError):
        rebalance_assignment(10, [], {})


def test_rebalance_total_preserved_and_monotone():
    for n in (7, 64, 100):
        asg = rebalance_assignment(n, [0, 1, 2], {1: 0.25})
        assert sum(len(r) for r in asg.values()) == n
        ranges = [asg[h] for h in (0, 1, 2)]
        assert ranges[0].start == 0
        assert ranges[0].stop == ranges[1].start
        assert ranges[1].stop == ranges[2].start
        assert ranges[2].stop == n


def test_preemption_chains_previous_handler():
    sig = signal.SIGUSR1
    calls = []
    original = signal.getsignal(sig)
    try:
        signal.signal(sig, lambda s, f: calls.append(s))
        pre = PreemptionHandler(sigs=(sig,))
        os.kill(os.getpid(), sig)
        assert pre.preempted()
        assert calls == [sig]
    finally:
        signal.signal(sig, original)


def test_elastic_names_refuse_naming_item_11(tmp_path):
    """The elastic names, ported: ``surviving_mesh``'s axes and sizes
    against JAX's (a ``{axis: size}`` mapping where no process group
    exists), then ``surviving_mesh`` and ``reshard_state`` on a world-1
    gloo group, the moved tree bitwise."""
    import jax  # noqa: F401
    import torch.distributed as dist

    from repro.distributed.fault import surviving_mesh as jsurviving
    from repro_torch.distributed import sharding as SH
    from repro_torch.launch.mesh import make_mesh

    assert FT.StepWatchdog is __import__(
        "repro_torch.obs.metrics", fromlist=["StepWatchdog"]).StepWatchdog
    for args in ((("data",), (4,), "data", 1),
                 (("data", "model"), (2, 1), "data", 1),
                 (("data", "model"), (1, 4), "model", 1)):
        got, want = FT.surviving_mesh(*args), jsurviving(*args)
        assert list(got.items()) == list(dict(want.shape).items())
        assert tuple(got) == tuple(want.axis_names)
    dist.init_process_group("gloo", store=dist.FileStore(
        str(tmp_path / "pg"), 1), rank=0, world_size=1)
    try:
        new = FT.surviving_mesh(("data", "model"), (2, 1), "data", 1, "cpu")
        assert new.mesh_dim_names == ("data", "model")
        assert tuple(new.shape) == (1, 1)
        with pytest.raises(ValueError, match="needs 2 ranks"):
            FT.surviving_mesh(("data",), (4,), "data", 2, "cpu")
        st = _state(2)
        old = make_mesh((1, 1), ("data", "model"), "cpu")
        held = SH.place(st, SH.leading_axis_specs(st, old), old)
        moved = FT.reshard_state(held, SH.to_shardings(
            SH.leading_axis_specs(st, new), new))
        assert _equal(moved, st)
    finally:
        dist.destroy_process_group()
