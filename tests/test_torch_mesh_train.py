"""The port's training on a 2x2 (data, model) mesh of four gloo ranks on
the CPU, against its own one-device steps and JAX's ``make_train_step``.

One spawn of four ranks (``python -c``, a ``FileStore`` under the test's
tmp dir) runs, on reduced qwen1.5-0.5b at float32 (2 layers, d=64, vocab
512, N=8, k=2):

- the gang step over 3 admission waves (4 slots of 2 examples, T=8:
  admit 4 profiles; evict slot 1, re-admit a new profile there and evict
  slot 2; poison slot 3 through a ``FaultPlan``), two steps a wave, the
  roster's slots over "data", beside the one-device gang step on the
  same rows and generator seed in the same process;
- the plain xpeft step (B=8, T=16, accum 1 and 2) with JAX's weights and
  JAX's Gumbel draws of the step's key, the frozen tree at rest as
  "model" blocks, each rank given its "data" rows of the batch;
- a checkpoint of the gang roster and the frozen tree written on the
  mesh and one written by rank 0 with no mesh, restored onto 1x2 and 1x1
  ``surviving_mesh`` meshes and with no mesh;
- ``reshard_state`` of the roster and the frozen tree from 2x2 onto 4x1
  and onto the 1x2 surviving mesh.

Tolerances, stated before any run:
- gang step: every roster leaf BITWISE the one-device step's, on every
  rank (each rank's GEMMs run at >= 2 rows, where the CPU's GEMMs give
  the same row bits as at 4); metrics within 1e-6 relative (the metric
  sums add in another order).
- plain step: loss and the clipped gradient (read from the first Adam
  moment, m = (1 - b1) g) within 1e-6 relative of the port's one-device
  step (the mean of the ranks' means rounds otherwise), and within 1e-5
  relative of JAX's, each gradient leaf relative to its largest element.
- checkpoints: the payload's arrays byte-equal to the one-device save's,
  the manifest's dtypes equal; restores and reshards gathered BITWISE.
- the frozen tree's resident bytes per rank below one device's.

``torch.distributed.run`` with 2 processes drives ``launch/train.py
--mesh 2x1:data,model`` for both flows: rank 0's final loss line, and its
graduated store file, equal the one-process launcher's.
"""
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config, reduce_for_smoke
from repro.data import MarkovLM as JMarkov
from repro.train import steps as JST
from repro_torch import bridge

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
B, T, P, LR = 8, 16, 4, 5e-2

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
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs import get_config, reduce_for_smoke
    from repro_torch.distributed import sharding as SH
    from repro_torch.distributed.fault import reshard_state, surviving_mesh
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models import init_lm
    from repro_torch.resilience import FaultPlan
    from repro_torch.train import steps as TST
    from repro_torch.train.roster import Roster, init_roster_state
    from repro_torch.utils.tree import tree_leaves, tree_paths

    data = torch.load(sys.argv[4], weights_only=False)
    tmp = sys.argv[6]
    mesh = make_test_mesh((2, 2), ("data", "model"))
    dr = mesh.get_local_rank("data")
    cfg = reduce_for_smoke(get_config("qwen1.5-0.5b"))
    out = {}

    def bitwise(a, b):
        return a.dtype == b.dtype and a.shape == b.shape and torch.equal(
            a.reshape(-1).view(torch.uint8), b.reshape(-1).view(torch.uint8))

    def tree_bitwise(a, b):
        pa, pb = tree_paths(a), tree_paths(b)
        return sorted(pa) == sorted(pb) and all(
            bitwise(SH.whole(pa[k]), SH.whole(pb[k])) for k in pa)

    # ---------------------------------------------------------- gang step
    S, m, Tg = 4, 2, 8
    frozen = init_lm(cfg, seed=0, device="cpu")
    plan = FaultPlan(poison_slots=(3,))
    rosters = {}
    for name, mm in (("mesh", mesh), ("one", None)):
        roster = Roster(cfg, 5, S, device="cpu", mesh=mm)
        rstate = roster.place(init_roster_state(cfg, S, seed=3,
                                                device="cpu"))
        gen = torch.Generator().manual_seed(11)
        clean = TST.make_gang_step(cfg, lr=5e-2, mesh=mm)
        poisoned = TST.make_gang_step(cfg, lr=5e-2, mesh=mm,
                                      fault_plan=plan)
        mets = []
        for wave in range(3):
            if wave == 0:
                for slot in range(S):
                    rstate = roster.admit(rstate, slot, slot)
            elif wave == 1:
                rstate = roster.evict(rstate, 1)
                rstate = roster.admit(rstate, 1, 7)
                rstate = roster.evict(rstate, 2)
            for i in range(2):
                r = np.random.default_rng(100 + 2 * wave + i)
                toks = r.integers(0, cfg.vocab_size, (S, m, Tg + 1))
                batch = {"tokens": toks[..., :-1], "labels": toks[..., 1:]}
                step = poisoned if wave == 2 else clean
                _, met = step({"frozen": frozen, "roster": rstate}, batch,
                              gen)
                mets.append({k: float(v) for k, v in met.items()})
        rosters[name] = (roster, rstate, mets)
    mr, one = rosters["mesh"][1], rosters["one"][1]
    out["gang_sharded"] = isinstance(mr["active"], SH.Sharded)
    out["gang_bitwise"] = tree_bitwise(mr, one)
    out["gang_metrics"] = (rosters["mesh"][2], rosters["one"][2])
    out["gang_host"] = (rosters["mesh"][0].metrics(mr, 0.9),
                        rosters["one"][0].metrics(one, 0.9))
    out["gang_params"] = all(
        np.array_equal(a, b) for s in range(S)
        for a, b in zip(*(list(rosters[k][0].slot_params(
            rosters[k][1], s).values()) for k in ("mesh", "one"))))

    # --------------------------------------------------------- plain step
    state0 = data["state"]
    rows = slice(dr * (data["B"] // 2), (dr + 1) * (data["B"] // 2))
    out["plain"] = {}
    for accum in (1, 2):
        noise = data["noise"][accum]
        sstate = TST.shard_train_state(state0, mesh)
        step = TST.make_train_step(cfg, "xpeft", lr=data["lr"], accum=accum,
                                   mesh=mesh)
        new, met = step(sstate, {k: v[rows] for k, v in data["batch"].items()},
                        noise)
        got = dict(loss=float(met["loss"]),
                   grad_norm=float(met["grad_norm"]),
                   m={k: v.clone() for k, v in
                      tree_paths(new["opt"]["m"]).items()})
        ostep = TST.make_train_step(cfg, "xpeft", lr=data["lr"], accum=accum)
        onew, omet = ostep(state0, data["batch"], noise)
        got["one"] = dict(loss=float(omet["loss"]),
                          grad_norm=float(omet["grad_norm"]),
                          m=tree_paths(onew["opt"]["m"]))
        out["plain"][accum] = got
    fz = sstate["frozen"]
    out["frozen_blocks"] = sum(isinstance(v, SH.Sharded)
                               for v in tree_leaves(fz))
    out["frozen_bytes"] = sum(SH.local(v).numel() * v.element_size()
                              for v in tree_leaves(fz))
    out["frozen_one_bytes"] = sum(v.numel() * v.element_size()
                                  for v in tree_leaves(state0["frozen"]))

    # -------------------------------------------------------- checkpoints
    ck = {"frozen": fz, "roster": mr}
    CheckpointManager(os.path.join(tmp, "mesh"), mesh=mesh).save(3, ck)
    if rank == 0:
        CheckpointManager(os.path.join(tmp, "one")).save(
            3, {"frozen": state0["frozen"], "roster": one})
    dist.barrier()
    whole = {"frozen": state0["frozen"], "roster": one}
    mgr = CheckpointManager(os.path.join(tmp, "mesh"))
    m12 = surviving_mesh(("data", "model"), (2, 2), "data", 1, "cpu")
    m11 = surviving_mesh(("data", "model"), (1, 2), "model", 1, "cpu")
    restored = {}
    for name, mm in (("1x2", m12), ("1x1", m11)):
        sh = {"frozen": SH.to_shardings(
                  SH.param_specs(whole["frozen"], {"data": 1, "model": 2}
                                 if name == "1x2" else {"data": 1,
                                                        "model": 1},
                                 fsdp=False), mm),
              "roster": SH.to_shardings(SH.leading_axis_specs(
                  whole["roster"], {"data": 1}), mm)}
        if SH.in_mesh(mm):
            got = mgr.restore(3, whole, shardings=sh)
            restored[name] = (tree_bitwise(got, whole), sum(
                isinstance(v, SH.Sharded) for v in tree_leaves(got)))
    restored["none"] = (tree_bitwise(mgr.restore(3, whole), whole), 0)
    out["restored"] = restored

    # ------------------------------------------------------------ reshard
    m41 = make_test_mesh((4, 1), ("data", "model"))
    moved = {}
    for name, mm in (("4x1", m41), ("1x2", m12)):
        sizes = SH.axis_sizes(mm)
        sh = {"frozen": SH.to_shardings(SH.param_specs(
                  whole["frozen"], sizes, fsdp=False), mm),
              "roster": SH.to_shardings(SH.leading_axis_specs(
                  whole["roster"], sizes), mm)}
        new = reshard_state(ck, sh)
        if SH.in_mesh(mm):
            moved[name] = (tree_bitwise(new, whole), sum(
                isinstance(v, SH.Sharded) for v in tree_leaves(new)))
        else:
            moved[name] = (all(v is None for v in tree_leaves(new)), 0)
    out["reshard"] = moved
    dist.barrier()
    dist.destroy_process_group()
    torch.save(out, sys.argv[5] % rank)
''')


def _noise(key, cfg, mb):
    """JAX's Gumbel draws of a step's key, as the step takes them."""
    ka, kb = jax.random.split(key)
    shape = (mb, cfg.num_layers, cfg.xpeft.num_adapters)
    return tuple(torch.tensor(np.asarray(jax.random.gumbel(k, shape)))
                 for k in (ka, kb))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def mesh_runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh_train")
    cfg = reduce_for_smoke(get_config("qwen1.5-0.5b")).with_xpeft(
        max_profiles=P)
    jstate = jax.jit(JST.init_train_state, static_argnums=(1, 2))(
        jax.random.key(0), cfg, "xpeft")
    batch = JMarkov(cfg.vocab_size, P, seed=0).sample(0, B, T)
    key = jax.random.key(11)
    jax_out = {}
    for accum in (1, 2):
        jnew, jm = jax.jit(JST.make_train_step(cfg, "xpeft", lr=LR,
                                               accum=accum))(
            jstate, jax.tree.map(jnp.asarray, batch), key)
        jax_out[accum] = dict(loss=float(jm["loss"]),
                              grad_norm=float(jm["grad_norm"]),
                              m=_np(jnew["opt"]["m"]))
    data = dict(state=bridge.to_torch(_np(jstate)), batch=batch, B=B,
                lr=LR, noise={a: _noise(key, cfg, B // a) for a in (1, 2)})
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
    return dict(ranks=ranks, jax=jax_out, tmp=tmp)


def test_gang_step_bitwise_one_device(mesh_runs):
    for out in mesh_runs["ranks"]:
        assert out["gang_sharded"]
        assert out["gang_bitwise"]
        assert out["gang_params"]
        got, want = out["gang_host"]
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        assert want["nonfinite"][3] > 0 and want["active"].tolist() == \
            [True, True, False, True]
        for gm, om in zip(*out["gang_metrics"]):
            assert sorted(gm) == sorted(om)
            for k in om:
                np.testing.assert_allclose(gm[k], om[k], rtol=1e-6,
                                           err_msg=k)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


@pytest.mark.parametrize("accum", [1, 2])
def test_plain_step_matches_one_device_and_jax(mesh_runs, accum):
    jx = mesh_runs["jax"][accum]
    jm = {"/".join(str(getattr(p, "key", p)) for p in path): np.asarray(v)
          for path, v in jax.tree_util.tree_leaves_with_path(jx["m"])}
    for out in mesh_runs["ranks"]:
        got = out["plain"][accum]
        one = got["one"]
        assert _rel(got["loss"], one["loss"]) <= 1e-6
        assert _rel(got["grad_norm"], one["grad_norm"]) <= 1e-6
        assert sorted(got["m"]) == sorted(one["m"]) == sorted(jm)
        for k, v in got["m"].items():
            assert _rel(v.numpy(), one["m"][k].numpy()) <= 1e-6, k
            assert _rel(v.numpy(), jm[k]) <= 1e-5, k
        assert _rel(got["loss"], jx["loss"]) <= 1e-5
        assert _rel(got["grad_norm"], jx["grad_norm"]) <= 1e-5


def test_frozen_tree_held_as_blocks(mesh_runs):
    for out in mesh_runs["ranks"]:
        assert out["frozen_blocks"] > 0
        assert 0 < out["frozen_bytes"] < out["frozen_one_bytes"]


def test_mesh_checkpoint_equals_one_device_save(mesh_runs):
    import json
    tmp = mesh_runs["tmp"]
    step = "step_%010d" % 3
    with np.load(tmp / "mesh" / step / "state.npz") as a, \
            np.load(tmp / "one" / step / "state.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].dtype == b[k].dtype and a[k].tobytes() == \
                b[k].tobytes(), k
    metas = [json.load(open(tmp / d / step / "MANIFEST.json"))
             for d in ("mesh", "one")]
    assert metas[0]["dtypes"] == metas[1]["dtypes"]


def test_checkpoint_restores_on_other_meshes(mesh_runs):
    ranks = mesh_runs["ranks"]
    for r, out in enumerate(ranks):
        got = out["restored"]
        assert got["none"][0]
        if r < 2:
            assert got["1x2"][0] and got["1x2"][1] > 0
        else:
            assert "1x2" not in got
        if r == 0:
            assert got["1x1"] == (True, 0)


def test_reshard_onto_smaller_and_other_meshes(mesh_runs):
    for r, out in enumerate(mesh_runs["ranks"]):
        assert out["reshard"]["4x1"][0] and out["reshard"]["4x1"][1] > 0
        assert out["reshard"]["1x2"][0]
        if r < 2:
            assert out["reshard"]["1x2"][1] > 0


FLOWS = {"plain": ["--steps", "3"],
         "onboard": ["--onboard", "--profiles", "4", "--roster-slots", "2",
                     "--graduate-min-steps", "2", "--graduate-max-steps",
                     "3", "--log-every", "2", "--seq", "8"]}


@pytest.fixture(scope="module")
def launches(tmp_path_factory):
    """Both flows of ``launch/train.py`` in one process and under
    ``torch.distributed.run --nproc-per-node 2 ... --mesh
    2x1:data,model``, the four runs at once."""
    tmp = tmp_path_factory.mktemp("mesh_launch")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1")
    procs = {}
    for flow, args in FLOWS.items():
        for nproc in (1, 2):
            pre = [] if nproc == 1 else [
                "-m", "torch.distributed.run", "--standalone",
                "--nproc-per-node", str(nproc)]
            post = [] if nproc == 1 else ["--mesh", "2x1:data,model"]
            if flow == "onboard":
                post += ["--store-out", str(tmp / f"s{nproc}.npz")]
            procs[flow, nproc] = subprocess.Popen(
                [sys.executable] + pre + ["-m", "repro_torch.launch.train",
                                          "--smoke", "--device", "cpu"]
                + args + post, cwd=ROOT, env=env, stdout=subprocess.PIPE,
                stderr=subprocess.PIPE, text=True)
    out = {}
    for key, p in procs.items():
        stdout, stderr = p.communicate(timeout=240)
        assert p.returncode == 0, stderr[-3000:]
        out[key] = stdout.splitlines()
    return out, tmp


@pytest.mark.parametrize("flow", list(FLOWS))
def test_launcher_trains_on_a_mesh(flow, launches):
    """``torch.distributed.run --nproc-per-node 2 -m
    repro_torch.launch.train --mesh 2x1:data,model``: the plain flow's
    final loss line and the onboarding flow's store file equal the
    one-process launcher's."""
    outs, tmp = launches
    key = "final loss" if flow == "plain" else "onboarding done"
    lines = [[x for x in outs[flow, n] if x.startswith(key)]
             for n in (1, 2)]
    assert len(lines[0]) == 1 and lines[0] == lines[1], outs
    if flow == "onboard":
        assert (tmp / "s1.npz").read_bytes() == (tmp / "s2.npz").read_bytes()
