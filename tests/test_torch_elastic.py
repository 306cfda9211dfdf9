"""Elastic shrink of the port's onboarding on gloo ranks on the CPU: the
port of JAX's ``tests/test_fault.py::test_elastic_shrink_resumes_onboarding``
with its numbers (4 LM profiles through 4 slots, ``per_slot=2``,
``seq_len=8``, ``min_steps=3``, ``max_steps=5``, ``target_acc=2.0``,
``lr=5e-2``, a checkpoint every 4 steps, the failed run stopped at 6) on
reduced qwen1.5-0.5b at float32.

One spawn of four ranks on a 2x2 (data, model) mesh runs, over JAX's
frozen weights, initial roster, fresh rows and Gumbel draws (carried
across by ``repro_torch.bridge``, as ``tests/test_torch_onboarding.py``
does):

1. an unfailed onboarding on 2x2;
2. the failed run: 2x2, checkpointed at step 4, stopped at step 6;
3. half the data axis lost: ``surviving_mesh(("data", "model"), (2, 2),
   "data", 1)`` (ranks 0 and 1), the failed run's live state moved onto
   it by ``reshard_state`` (every rank takes part; ranks 2 and 3 keep no
   block), and a new trainer on it resumed from the checkpoint
   (``restore(shardings=)`` through ``Trainer.try_resume``), its state
   moved once more by ``reshard_state`` as JAX's test does, then run to
   the end;
4. the resumed run's store served by ``ServeEngine(mesh=)`` on the 1x2
   mesh and by the one-device engine.

Contracts, stated before any run. Within the port every comparison is
bitwise: the resumed store's records byte-equal to the unfailed 2x2
run's and to the port's one-device straight run's (rank 0 runs it); the
frozen tree restored from the checkpoint equal to the live state
resharded onto the surviving mesh; the served greedy tokens equal the
one-device engine's. Against JAX's one-device straight run (the parent
runs it): the same profiles graduate at the same steps, the packed masks
byte-equal, and each fp16 LN affine byte-equal or, where the port's fp32
row (its largest difference from JAX's final roster row within 1e-5 of
that row's largest element, the gang step's bound against JAX) rounds to
the neighbouring fp16 value, one fp16 ulp from JAX's.
"""
import os
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config, reduce_for_smoke
from repro.data import MarkovLM as JMarkov
from repro.train import GraduationPolicy as JPolicy
from repro.train import roster as JR
from repro.train.onboarding import build_onboarding_run as jbuild
from repro_torch import bridge

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
P, S, M, SEQ, STEPS = 4, 4, 2, 8, 24

WORKER = textwrap.dedent(r'''
    import os
    import sys
    import numpy as np
    import torch
    import torch.distributed as dist
    rank, world = int(sys.argv[1]), int(sys.argv[2])
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(sys.argv[3], world),
                            rank=rank, world_size=world)
    from repro_torch.configs import get_config, reduce_for_smoke
    from repro_torch.core.profiles import ProfileStore
    from repro_torch.data import MarkovLM
    from repro_torch.distributed import sharding as SH
    from repro_torch.distributed.fault import reshard_state, surviving_mesh
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.serve import Request, ServeEngine
    from repro_torch.train import (GraduationPolicy, OnboardingScheduler,
                                   OnboardingTrainer, RosterBatcher)
    from repro_torch.train import steps as TST
    from repro_torch.train.roster import Roster
    from repro_torch.utils.tree import tree_leaves, tree_paths

    data = torch.load(sys.argv[4], weights_only=False)
    tmp = sys.argv[6]
    cfg = reduce_for_smoke(get_config("qwen1.5-0.5b"))
    P, S, M, SEQ = data["dims"]
    mesh = make_test_mesh((2, 2), ("data", "model"))

    def build(mm, ckpt_dir=None):
        """JAX's drill on mesh ``mm`` over JAX's draws."""
        roster = Roster(cfg, 2, S, device="cpu", mesh=mm)
        roster.fresh = lambda pid: data["fresh"][pid]
        xp = cfg.xpeft
        store = ProfileStore(cfg.num_layers, xp.num_adapters, xp.bottleneck,
                             xp.mask_type, xp.k)
        policy = GraduationPolicy(min_steps=3, max_steps=5, target_acc=2.0)
        sched = OnboardingScheduler(roster, store, policy, range(P))
        gang = TST.make_gang_step(cfg, lr=5e-2, ema_decay=policy.ema_decay,
                                  mesh=mm)
        holder = {}
        state = {"frozen": data["frozen"],
                 "roster": roster.place(data["roster"])}
        trainer = OnboardingTrainer(
            lambda st, b, rng: gang(st, b, data["noise"][holder["t"].step]),
            state, RosterBatcher(MarkovLM(cfg.vocab_size, P, seed=1), S, M,
                                 SEQ),
            sched, log_every=2, mesh=mm, ckpt_dir=ckpt_dir, ckpt_every=4,
            store_path=(os.path.join(ckpt_dir, "store.npz")
                        if ckpt_dir else None))
        holder["t"] = trainer
        return trainer

    def records(store):
        return {pid: {k: v.tobytes() for k, v in store._rec[pid].items()}
                for pid in store.profile_ids()}

    def whole(tree):
        return {k: SH.whole(v) for k, v in tree_paths(tree).items()}

    out = {}
    ref = build(mesh)
    ref.run_until_drained(max_steps=200)
    out["ref"] = records(ref.scheduler.store)
    out["ref_sharded"] = isinstance(ref.state["roster"]["active"],
                                    SH.Sharded)
    out["ref_table"] = {k: SH.whole(v) for k, v in
                        ref.state["roster"]["trainable"]["table"].items()}
    out["ref_steps"] = [(g["pid"], g["steps"])
                        for g in ref.scheduler.graduated]
    if rank == 0:
        one = build(None)
        one.run_until_drained(max_steps=200)
        out["one"] = records(one.scheduler.store)

    ckpt = os.path.join(tmp, "ckpt")
    t1 = build(mesh, ckpt_dir=ckpt)
    t1.run(6)
    out["latest"] = t1.mgr.latest_step()

    mesh12 = surviving_mesh(("data", "model"), (2, 2), "data", 1, "cpu")

    def shardings(state, mm):
        return {"frozen": SH.to_shardings(SH.param_specs(
                    state["frozen"], mm, fsdp=False), mm),
                "roster": SH.to_shardings(SH.leading_axis_specs(
                    state["roster"], mm), mm)}

    # the live state at step 6 moved onto the survivors: every rank of the
    # old mesh gathers, the ranks left out hold nothing
    live = reshard_state(t1.state, shardings(t1.state, mesh12))
    out["in_survivors"] = SH.in_mesh(mesh12)
    if not SH.in_mesh(mesh12):
        out["left_out_empty"] = all(v is None for v in tree_leaves(live))
    else:
        t2 = build(mesh12, ckpt_dir=ckpt)
        assert t2.try_resume()
        out["resumed_at"] = t2.step
        # the checkpoint (step 4) and the live state (step 6) hold the
        # same frozen tree; the roster moved on by two steps
        out["frozen_equal_live"] = all(
            torch.equal(a, b) for a, b in zip(
                whole(t2.state["frozen"]).values(),
                whole(live["frozen"]).values()))
        t2.state = reshard_state(t2.state, shardings(t2.state, mesh12))
        t2.run_until_drained(max_steps=200)
        out["resumed"] = records(t2.scheduler.store)
        store = t2.scheduler.store

        def serve(mm):
            eng = ServeEngine(cfg, data["frozen"], store, max_slots=4,
                              max_seq=32, mesh=mm)
            reqs = [Request(uid=i, prompt=np.random.default_rng(i).integers(
                        0, cfg.vocab_size, 5 + i), profile_id=i % P,
                            max_new_tokens=6) for i in range(6)]
            eng.run_until_drained(list(reqs))
            return {r.uid: list(map(int, r.generated)) for r in reqs}
        out["served_mesh"] = serve(mesh12)
        if rank == 0:
            out["served_one"] = serve(None)
    dist.barrier()
    dist.destroy_process_group()
    torch.save(out, sys.argv[5] % rank)
''')


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def drill(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("elastic")
    cfg = reduce_for_smoke(get_config("qwen1.5-0.5b"))
    jt, _ = jbuild(cfg, JMarkov(cfg.vocab_size, P, seed=1), range(P),
                   slots=S, per_slot=M, seq_len=SEQ,
                   policy=JPolicy(min_steps=3, max_steps=5, target_acc=2.0),
                   lr=5e-2, seed=0, log_every=2, rng=jax.random.key(1))
    jt.run_until_drained(max_steps=200)
    jroster = jt.scheduler.roster
    _, kr = jax.random.split(jax.random.key(0))
    # the Gumbel draws of JAX's trainer: key(1) split per step, the step
    # key split into A's and B's
    rng, noise = jax.random.key(1), []
    shape = (S * M, cfg.num_layers, cfg.xpeft.num_adapters)
    for _ in range(STEPS):
        rng, sub = jax.random.split(rng)
        noise.append(tuple(torch.tensor(np.asarray(jax.random.gumbel(
            k, shape))) for k in jax.random.split(sub)))
    data = dict(
        dims=(P, S, M, SEQ), noise=noise,
        frozen=bridge.to_torch(_np(jt.state["frozen"])),
        roster=bridge.to_torch(_np(JR.init_roster_state(kr, cfg, S))),
        fresh={pid: bridge.to_torch(_np(jroster._fresh(
            jroster.profile_key(pid)))) for pid in range(P)})
    torch.save(data, tmp / "data.pt")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    procs = [subprocess.Popen(
        [sys.executable, "-c", WORKER, str(r), "4", str(tmp / "store"),
         str(tmp / "data.pt"), str(tmp / "out%d.pt"), str(tmp)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(4)]
    for rank, p in enumerate(procs):
        _, err = p.communicate(timeout=300)
        if p.returncode:
            pytest.fail(f"rank {rank} exited {p.returncode}:\n{err[-6000:]}")
    ranks = [torch.load(tmp / f"out{r}.pt", weights_only=False)
             for r in range(4)]
    js = jt.scheduler.store
    return dict(ranks=ranks, jax={pid: dict(js._rec[pid])
                                  for pid in js.profile_ids()},
                jax_table=_np(jt.state["roster"]["trainable"]["table"]),
                jax_steps=[(g["pid"], g["steps"])
                           for g in jt.scheduler.graduated])


def test_unfailed_mesh_store_equals_one_device_and_jax(drill):
    ranks = drill["ranks"]
    assert ranks[0]["one"] == ranks[0]["ref"]
    jrec, jtab = drill["jax"], drill["jax_table"]
    for out in ranks:
        assert out["ref_sharded"]
        assert out["ref"] == ranks[0]["ref"]
        assert out["ref_steps"] == drill["jax_steps"]
    # P == S: each graduated profile's fp32 row stays parked in its slot
    slot = dict(ranks[0]["ref_steps"])
    assert sorted(slot) == list(range(P))
    for g, (pid, _) in enumerate(ranks[0]["ref_steps"]):
        got = ranks[0]["ref"][pid]
        assert sorted(got) == sorted(jrec[pid])
        for key in ("mA", "mB"):
            assert got[key] == jrec[pid][key].tobytes(), (pid, key)
    for key in ("ln_scale", "ln_bias"):
        t, j = ranks[0]["ref_table"][key].numpy(), jtab[key]
        assert np.abs(t - j).max() <= 1e-5 * np.abs(j).max(), key
        for pid in range(P):
            a = np.frombuffer(ranks[0]["ref"][pid][key], np.float16)
            b = jrec[pid][key].reshape(-1)
            ulps = np.abs(a.view(np.int16).astype(np.int32)
                          - b.view(np.int16).astype(np.int32))
            assert ulps.max() <= 1, (pid, key)


def test_resumed_store_byte_identical(drill):
    ranks = drill["ranks"]
    assert [out["in_survivors"] for out in ranks] == [True, True, False,
                                                      False]
    for out in ranks[:2]:
        assert out["latest"] == 4 and out["resumed_at"] == 4
        assert out["frozen_equal_live"]
        assert out["resumed"] == out["ref"] == ranks[0]["one"]
    for out in ranks[2:]:
        assert out["left_out_empty"]


def test_resumed_store_serves_on_the_surviving_mesh(drill):
    ranks = drill["ranks"]
    assert ranks[0]["served_mesh"] == ranks[0]["served_one"]
    assert ranks[1]["served_mesh"] == ranks[0]["served_one"]
    assert all(len(t) == 6 for t in ranks[0]["served_one"].values())
