"""The port's expert-parallel MoE path (``models/moe.py``'s ``_moe_ep``,
JAX's ``_moe_shard_map``) on gloo ranks on the CPU, against its local
path, JAX's ``_moe_local`` and JAX's ``_moe_shard_map``.

Reduced qwen3-moe-30b-a3b with JAX's test's ``num_experts=8``,
``top_k=2`` (d=64, per-expert d_ff 32, float32), JAX's weights
(``init_moe(key(3))``) and x [8, 16, 64] from ``key(4)``, at capacity
factors 8.0 (nothing dropped) and 0.25 (routes dropped). One spawn of
four ranks holds:

- on a 1x2 (data, model) mesh (ranks 0 and 1, each a "model" peer with 4
  experts): the EP output, aux, dropped route set and gradients (loss
  sum(y^2) + 0.01 aux, in x, the router and each peer's experts) against
  the port's local path on the same x, and the output and gradients
  against JAX's ``_moe_local`` and ``jax.grad``;
- on a 2x2 mesh (each data rank its 4 rows of x): the same against the
  local path on the rank's rows, and the output and aux against JAX's
  ``_moe_shard_map`` on a 2x2 mesh of 4 fake CPU devices (one subprocess,
  as ``tests/test_distributed.py`` runs it);
- on 1x2, an xpeft train step's loss and mask-table gradients with the
  frozen tree as "model" blocks (each layer a checkpoint, recomputed in
  the backward) and the backward run on a thread of its own, as the
  card's autograd runs it, against one device;
- one serving drain on 2x2 at ``capacity_factor=64`` (nothing dropped):
  reduced qwen3-moe-30b-a3b (2 layers), 3 profiles, 6 requests, the
  experts held as "model" blocks and the EP path taken, against the
  one-device engine.

Tolerances, stated before any run:
- EP against the port's local path: output within 1e-6 of the output's
  largest element (each peer sums its own routes in ascending expert id
  and the peers' partial sums are added in rank order); the dropped
  route sets equal; aux within 1e-6 (on 2x2, of the mean of the data
  shards' local aux); gradients within 1e-5 of each leaf's largest
  element.
- EP against JAX (``_moe_local`` on 1x2, ``_moe_shard_map`` on 2x2):
  output and gradients within 1e-5 of the largest element, aux within
  1e-6.
- the train step: loss within 1e-6 relative, gradients within 1e-5 of
  each leaf's largest element.
- the served greedy tokens equal the one-device engine's.
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
from repro.models import moe as JMOE
from repro_torch import bridge

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
ARCH = "qwen3-moe-30b-a3b"
CFS = (8.0, 0.25)
B, T = 8, 16

JAX_SHARD_MAP = textwrap.dedent(r'''
    import os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import sys
    sys.path.insert(0, "src")
    import numpy as np
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P
    from repro.configs import get_config, reduce_for_smoke
    from repro.distributed import ctx
    from repro.launch.mesh import make_mesh_compat
    from repro.models.moe import init_moe, moe_apply

    base = reduce_for_smoke(get_config("qwen3-moe-30b-a3b")).with_(
        num_experts=8, top_k=2)
    p = init_moe(jax.random.key(3), base, jnp.float32)
    x = jnp.asarray(np.load(sys.argv[1]))
    mesh = make_mesh_compat((2, 2), ("data", "model"))
    out = {}
    for cf in (8.0, 0.25):
        cfg = base.with_(capacity_factor=cf)
        with ctx.mesh_context(mesh):
            xs = jax.device_put(x, NamedSharding(mesh, P(("data",), None,
                                                         None)))
            y, aux = jax.jit(lambda pp, xx: moe_apply(pp, xx, cfg))(p, xs)
        out[f"y{cf}"], out[f"aux{cf}"] = np.asarray(y), np.asarray(aux)
    np.savez(sys.argv[2], **out)
''')

WORKER = textwrap.dedent(r'''
    import contextlib
    import sys
    import numpy as np
    import torch
    import torch.distributed as dist
    rank, world = int(sys.argv[1]), int(sys.argv[2])
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(sys.argv[3], world),
                            rank=rank, world_size=world)
    from torch.distributed.device_mesh import DeviceMesh
    from repro_torch.configs import get_config, reduce_for_smoke
    from repro_torch.core import xpeft as XP
    from repro_torch.core.profiles import ProfileStore
    from repro_torch.distributed import ctx as CTX
    from repro_torch.distributed import sharding as SH
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models import init_lm
    from repro_torch.models import moe as MOE
    from repro_torch.serve import Request, ServeEngine

    data = torch.load(sys.argv[4], weights_only=False)
    base = reduce_for_smoke(get_config("qwen3-moe-30b-a3b")).with_(
        num_experts=8, top_k=2)
    m12 = DeviceMesh("cpu", torch.arange(2).reshape(1, 2),
                     mesh_dim_names=("data", "model"))
    mesh = make_test_mesh((2, 2), ("data", "model"))
    calls = {"ep": 0}
    ep, ranks_fn = MOE._moe_ep, MOE.ranks

    def counted(*a, **k):
        calls["ep"] += 1
        return ep(*a, **k)
    MOE._moe_ep = counted
    drops = []

    def recorded(topi, C, E):
        pos, keep = ranks_fn(topi, C, E)
        drops.append({(t, int(e)) for t, (row, k) in enumerate(
            zip(topi.tolist(), keep.tolist())) for e, ok in zip(row, k)
            if not ok})
        return pos, keep
    MOE.ranks = recorded

    def run(x, mm, cf):
        cfg = base.with_(capacity_factor=cf)
        p = {k: v.clone().requires_grad_(True)
             for k, v in data["params"].items()}
        xt = torch.from_numpy(x).requires_grad_(True)
        drops.clear()
        with CTX.mesh_context(mm) if mm is not None \
                else contextlib.nullcontext():
            y, aux = MOE.moe_apply(p, xt, cfg)
        (torch.sum(y ** 2) + 0.01 * aux).backward()
        grads = {k: v.grad for k, v in p.items()}
        grads["x"] = xt.grad
        return dict(y=y.detach(), aux=float(aux), grads=grads,
                    drops=set().union(*drops))

    out = {"1x2": {}, "2x2": {}}
    x = data["x"]
    for cf in data["cfs"]:
        if SH.in_mesh(m12):
            before = calls["ep"]
            got = run(x, m12, cf)
            assert calls["ep"] == before + 1
            out["1x2"][cf] = dict(ep=got, local=run(x, None, cf),
                                  peer=m12.get_local_rank("model"))
        dr = mesh.get_local_rank("data")
        rows = x[dr * (len(x) // 2):(dr + 1) * (len(x) // 2)]
        out["2x2"][cf] = dict(ep=run(rows, mesh, cf),
                              local=run(rows, None, cf), data_rank=dr,
                              peer=mesh.get_local_rank("model"))

    # an xpeft train step's loss and gradients on 1x2 with the frozen
    # tree as "model" blocks, its backward on a thread of its own (as the
    # card's autograd runs it: the layers recomputed there must find the
    # mesh context again), against one device
    if SH.in_mesh(m12):
        import threading
        from repro_torch.data import MarkovLM
        from repro_torch.train import steps as ST
        from repro_torch.utils.tree import tree_map
        cfg = base.with_(capacity_factor=8.0)
        state = ST.init_train_state(cfg, "xpeft", seed=0, device="cpu")
        batch = {k: torch.as_tensor(v) for k, v in MarkovLM(
            cfg.vocab_size, 4, seed=0).sample(0, 4, 16).items()}
        noise = ST._draws(torch.Generator().manual_seed(5), cfg, 4, "cpu")

        def step_grads(st, mm):
            leaves = tree_map(lambda p: p.detach().requires_grad_(True),
                              st["trainable"])
            with CTX.mesh_context(mm) if mm is not None \
                    else contextlib.nullcontext():
                total, _ = ST.loss_for_batch(st["frozen"], leaves, batch,
                                             cfg, "xpeft", noise)
            t = threading.Thread(target=total.backward)
            t.start()
            t.join()
            return float(total), {k: v.grad for k, v in
                                  leaves["table"].items()}
        before = calls["ep"]
        out["train_1x2"] = dict(
            mesh=step_grads(ST.shard_train_state(state, m12), m12),
            one=step_grads(state, None), ep_calls=calls["ep"] - before)

    # one serving drain at capacity_factor 64 on 2x2, against one device
    cfg = base.with_(capacity_factor=64.0)
    params = init_lm(cfg, seed=0, device="cpu")
    table = XP.init_profile_table(cfg.with_xpeft(max_profiles=3), seed=0)
    xp = cfg.xpeft
    store = ProfileStore(cfg.num_layers, xp.num_adapters, xp.bottleneck,
                         xp.mask_type, xp.k)
    for pid in range(3):
        store.add_profile(pid, {k: v[pid] for k, v in table.items()})

    def drain(mm):
        eng = ServeEngine(cfg, params, store, max_slots=4, max_seq=48,
                          sync_every=4, mesh=mm)
        reqs = [Request(uid=i, prompt=np.random.default_rng(i).integers(
                    0, cfg.vocab_size, 3 + 2 * i), profile_id=i % 3,
                        max_new_tokens=8 if i % 3 == 0 else 3)
                for i in range(6)]
        eng.run_until_drained(list(reqs))
        return eng, {r.uid: list(map(int, r.generated)) for r in reqs}
    before = calls["ep"]
    eng, toks = drain(mesh)
    out["serve"] = dict(tokens=toks, ep_calls=calls["ep"] - before,
                        expert_block=isinstance(
                            eng.params["blocks"]["moe"]["ew_g"], SH.Sharded))
    if rank == 0:
        out["serve"]["one"] = drain(None)[1]
    dist.barrier()
    dist.destroy_process_group()
    torch.save(out, sys.argv[5] % rank)
''')


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


@pytest.fixture(scope="module")
def ep_runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("moe_ep")
    base = reduce_for_smoke(get_config(ARCH)).with_(num_experts=8, top_k=2)
    p = JMOE.init_moe(jax.random.key(3), base, jnp.float32)
    x = np.asarray(jax.random.normal(jax.random.key(4),
                                     (B, T, base.d_model)))
    np.save(tmp / "x.npy", x)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    env.pop("XLA_FLAGS", None)
    jsub = subprocess.Popen(
        [sys.executable, "-c", JAX_SHARD_MAP, str(tmp / "x.npy"),
         str(tmp / "jax_sm.npz")], cwd=ROOT, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    torch.save(dict(params=bridge.to_torch(jax.tree.map(np.asarray, p)),
                    x=x, cfs=CFS), tmp / "data.pt")
    procs = [subprocess.Popen(
        [sys.executable, "-c", WORKER, str(r), "4", str(tmp / "store"),
         str(tmp / "data.pt"), str(tmp / "out%d.pt")],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(4)]
    # JAX's local path and jax.grad on the whole x, meanwhile
    jlocal = {}
    for cf in CFS:
        cfg = base.with_(capacity_factor=cf)

        def loss(pp, xx):
            y, aux = JMOE._moe_local(pp, xx, cfg)
            return jnp.sum(y ** 2) + 0.01 * aux

        y, aux = JMOE._moe_local(p, jnp.asarray(x), cfg)
        gp, gx = jax.grad(loss, argnums=(0, 1))(p, jnp.asarray(x))
        jlocal[cf] = dict(y=np.asarray(y), aux=float(aux),
                          grads=dict({k: np.asarray(v) for k, v in
                                      gp.items()}, x=np.asarray(gx)))
    for rank, proc in enumerate(procs):
        _, err = proc.communicate(timeout=300)
        if proc.returncode:
            pytest.fail(f"rank {rank} exited {proc.returncode}:\n"
                        f"{err[-6000:]}")
    _, err = jsub.communicate(timeout=300)
    assert jsub.returncode == 0, err[-3000:]
    with np.load(tmp / "jax_sm.npz") as z:
        jsm = {k: z[k] for k in z.files}
    ranks = [torch.load(tmp / f"out{r}.pt", weights_only=False)
             for r in range(4)]
    return dict(ranks=ranks, jax_local=jlocal, jax_sm=jsm)


def _check_grads(ep, want, peer, n_exp=4, what=""):
    """EP's gradients against ``want`` (the local path's or JAX's): x and
    the router whole; the experts on this peer's rows, zero elsewhere."""
    for k in ("x", "router"):
        assert _rel(ep["grads"][k], want[k]) <= 1e-5, (what, k)
    lo = peer * n_exp
    for k in ("ew_g", "ew_u", "ew_d"):
        g = np.asarray(ep["grads"][k])
        assert _rel(g[lo:lo + n_exp], np.asarray(want[k])[lo:lo + n_exp]) \
            <= 1e-5, (what, k)
        assert not np.delete(g, np.s_[lo:lo + n_exp], axis=0).any(), k
        assert np.abs(g[lo:lo + n_exp]).max() > 0, k


@pytest.mark.parametrize("cf", CFS)
def test_ep_on_1x2_matches_local_and_jax(ep_runs, cf):
    jl = ep_runs["jax_local"][cf]
    for out in ep_runs["ranks"][:2]:
        got = out["1x2"][cf]
        ep, loc = got["ep"], got["local"]
        assert _rel(ep["y"], loc["y"]) <= 1e-6
        assert abs(ep["aux"] - loc["aux"]) <= 1e-6
        assert ep["drops"] == loc["drops"]
        assert (len(ep["drops"]) > 0) == (cf < 1.0)
        _check_grads(ep, {k: v.numpy() for k, v in loc["grads"].items()},
                     got["peer"], what="local")
        assert _rel(ep["y"], jl["y"]) <= 1e-5
        assert abs(ep["aux"] - jl["aux"]) <= 1e-6
        _check_grads(ep, jl["grads"], got["peer"], what="jax")
    assert all(not out["1x2"] for out in ep_runs["ranks"][2:])


@pytest.mark.parametrize("cf", CFS)
def test_ep_on_2x2_matches_local_and_jax_shard_map(ep_runs, cf):
    ranks = ep_runs["ranks"]
    jy, jaux = ep_runs["jax_sm"][f"y{cf}"], float(ep_runs["jax_sm"][
        f"aux{cf}"])
    # the mean of the data shards' local aux (ranks 0 and 2 hold shards 0
    # and 1)
    local_aux = np.mean([ranks[r]["2x2"][cf]["local"]["aux"]
                         for r in (0, 2)])
    for out in ranks:
        got = out["2x2"][cf]
        ep, loc = got["ep"], got["local"]
        dr = got["data_rank"]
        assert _rel(ep["y"], loc["y"]) <= 1e-6
        assert ep["drops"] == loc["drops"]
        assert abs(ep["aux"] - local_aux) <= 1e-6
        _check_grads(ep, {k: v.numpy() for k, v in loc["grads"].items()},
                     got["peer"], what="local")
        rows = jy[dr * (B // 2):(dr + 1) * (B // 2)]
        assert _rel(ep["y"], rows) <= 1e-5
        assert abs(ep["aux"] - jaux) <= 1e-6


def test_ep_train_step_with_backward_on_another_thread(ep_runs):
    for out in ep_runs["ranks"][:2]:
        got = out["train_1x2"]
        (ml, mg), (ol, og) = got["mesh"], got["one"]
        # EP in every layer's forward and again in its recompute
        assert got["ep_calls"] == 2 * 2
        assert abs(ml - ol) <= 1e-6 * abs(ol)
        for k in og:
            assert mg[k] is not None and _rel(mg[k], og[k]) <= 1e-5, k
    assert all("train_1x2" not in out for out in ep_runs["ranks"][2:])


def test_ep_serving_drain_equals_one_device(ep_runs):
    ranks = ep_runs["ranks"]
    one = ranks[0]["serve"]["one"]
    assert all(len(t) in (3, 8) for t in one.values())
    for out in ranks:
        assert out["serve"]["tokens"] == one
        assert out["serve"]["expert_block"]
        assert out["serve"]["ep_calls"] > 0
