"""The port's ServeEngine on a 2x2 (data, model) mesh of four gloo ranks
on the CPU, against its own one-device engine and JAX's windowed engine.

One spawn of four ranks (``python -c``, a ``FileStore`` under the test's
tmp dir, so parallel test workers share no port) runs every path once:
windowed composed, ``decode_fused`` (the plain versions on the CPU),
per-step masks, continuous with preemptions (a pool of 8 pages, 4 per
data shard, each shard holding one max-length request), an int8 bank, a
heterogeneous bank with prefix rows, speculation at gamma 3, and the two
layouts that keep state whole over "data": 3 slots (no even split) and a
6-page pool with preemptions (shards of 3 pages would not hold a
max-length request's 4). Rank 0
also drains each path on the one-device engine in the same process.
Reduced qwen1.5-0.5b at float32 with JAX's weights and profile logits
carried across by the bridge; 4 slots, max_seq 64, sync_every 4.

Contracts: every path's greedy tokens BITWISE equal to the one-device
engine's, on every rank; the admission entries (the profile cache's
aggregated Â/B̂, typed leaves, quantized records) byte-equal;
``serve_stats()["devices"] == 4``; resident bytes per device below the
one-device figure; the windowed mesh tokens equal JAX's one-device
windowed engine's.
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
from repro.core import xpeft as JXP
from repro.core.profiles import ProfileStore as JStore
from repro.models import init_lm as jinit_lm
from repro.serve.engine import Request as JRequest
from repro.serve.engine import ServeEngine as JEngine
from repro_torch import bridge

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
ARCH = "qwen1.5-0.5b"
ENGINE = dict(max_slots=4, max_seq=64, sync_every=4, page_size=16)
HETERO = dict(num_adapters=12, bottleneck=4, k=4, max_profiles=8,
              bank_spec=(("bottleneck", 4), ("lora", 4), ("ia3", 2),
                         ("prefix", 2)),
              prefix_tokens=2)
# path -> (params set, cfg options, xpeft options, store options, engine
# options, requests, long requests' new tokens)
PATHS = {
    "windowed": ("base", {}, {}, {}, {}, 6, 20),
    "decode_fused": ("base", {"decode_fused": True}, {}, {}, {}, 6, 20),
    "per_step": ("base", {}, {}, {}, {"precompute": False}, 6, 20),
    # uids 0 and 6, both long, meet on data shard 0
    "continuous": ("base", {}, {}, {},
                   {"continuous": True, "max_pages": 8}, 8, 50),
    "int8": ("base", {}, {"bank_quant": "int8"}, {"quant": "int8"}, {}, 6,
             20),
    "hetero": ("hetero", {}, {}, {"bank_spec": HETERO["bank_spec"]},
               {"continuous": True}, 6, 30),
    "spec": ("base", {"spec_enable": True, "spec_gamma": 3}, {}, {},
             {"continuous": True}, 6, 20),
    # 3 slots do not split over data=2: every rank holds and steps all
    "slots_whole": ("base", {}, {}, {}, {"max_slots": 3}, 6, 20),
    # 6 pages split into shards of 3, short of a max-length request's 4:
    # the pool stays whole while the slots split
    "pool_whole": ("base", {}, {}, {},
                   {"continuous": True, "max_pages": 6}, 8, 50),
    # mask-entry pools below the slot count, held whole on every rank: 2
    # entries (a multiple of data=2) and 3 (not one)
    "mask_pages_2": ("base", {}, {}, {},
                     {"continuous": True, "mask_pages": 2}, 8, 20),
    "mask_pages_3": ("base", {}, {}, {},
                     {"continuous": True, "mask_pages": 3}, 8, 20),
}
# the serve_stats() keys a mesh engine's admissions must equal one
# device's in
STATS = ("device_steps", "prefill_batches", "stranded_slot_steps",
         "mask_entries", "scheduler", "preemptions")


# ``tests/test_torch_serve_continuous.py``'s workload: per-uid seeded
# prompts of 3-12 tokens, 3 profiles, every third request long (run by the
# workers and by this module)
REQUESTS = textwrap.dedent('''
    def skewed_requests(cls, vocab, n=6, *, long_new=20):
        reqs = []
        for i in range(n):
            r = np.random.default_rng(i)
            T = int(r.integers(3, 13))
            reqs.append(cls(uid=i, prompt=r.integers(0, vocab, T),
                            profile_id=i % 3,
                            max_new_tokens=long_new if i % 3 == 0 else 2))
        return reqs
''')
exec(REQUESTS)

WORKER = REQUESTS + textwrap.dedent(r'''
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
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.serve import Request, ServeEngine

    data = torch.load(sys.argv[4], weights_only=False)
    ENGINE, PATHS, STATS = data["engine"], data["paths"], data["stats"]
    mesh = make_test_mesh((2, 2), ("data", "model"))

    def drain(name, mesh):
        which, cfg_kw, xkw, skw, ekw, n, long_new = PATHS[name]
        cfg = reduce_for_smoke(get_config(data["arch"])).with_xpeft(
            **data["xpeft"][which]).with_(**cfg_kw).with_xpeft(**xkw)
        xp = cfg.xpeft
        store = ProfileStore(cfg.num_layers, xp.num_adapters, xp.bottleneck,
                             "hard", xp.k, **skw)
        for pid, row in enumerate(data["rows"][which]):
            store.add_profile(pid, row)
        eng = ServeEngine(cfg, data["params"][which], store, mesh=mesh,
                          **dict(ENGINE, **ekw))
        reqs = skewed_requests(Request, cfg.vocab_size, n,
                               long_new=long_new)
        eng.run_until_drained(list(reqs))
        assert all(r.done for r in reqs)
        return eng, reqs

    out = {}
    for name in PATHS:
        eng, reqs = drain(name, mesh)
        st = eng.serve_stats()
        got = dict(tokens={r.uid: list(map(int, r.generated)) for r in reqs},
                   prefix=[getattr(r, "prefix_len", 0) for r in reqs],
                   devices=st["devices"], preemptions=st.get("preemptions"),
                   bytes=eng.resident_bytes_per_device()["total"],
                   stats={k: st.get(k) for k in STATS},
                   pool_rows=None if eng.mask_alloc is None else {
                       k: v.shape[0] for k, v in eng.masks["pool"].items()})
        if rank == 0:
            one, one_reqs = drain(name, None)
            one_st = one.serve_stats()
            got["one_stats"] = {k: one_st.get(k) for k in STATS}
            got["one_tokens"] = {r.uid: list(map(int, r.generated))
                                 for r in one_reqs}
            got["one_bytes"] = one.resident_bytes_per_device()["total"]
            mine, ref = eng.profile_cache._entries, one.profile_cache._entries
            got["entries"] = len(ref)
            got["entries_equal"] = sorted(mine) == sorted(ref) and all(
                sorted(mine[p]) == sorted(ref[p]) and all(
                    torch.equal(mine[p][k].reshape(-1).view(torch.uint8),
                                ref[p][k].reshape(-1).view(torch.uint8))
                    for k in ref[p]) for p in ref)
        out[name] = got
        dist.barrier()
    dist.destroy_process_group()
    torch.save(out, sys.argv[5] % rank)
''')


def _setup(xpeft_kw=None):
    cfg = reduce_for_smoke(get_config(ARCH))
    if xpeft_kw:
        cfg = cfg.with_xpeft(**xpeft_kw)
    key = jax.random.key(0)
    params = jax.jit(jinit_lm, static_argnums=1)(key, cfg)
    table = jax.tree.map(np.asarray, JXP.init_profile_table(key, cfg))
    rows = [{k: np.array(v[pid]) for k, v in table.items()}
            for pid in range(3)]
    return cfg, params, rows


def _craft_prefix(rows, xp):
    """Profile 1 selects no prefix slot, profile 2 one on even layers
    only (``tests/test_torch_serve_continuous.py``'s crafting)."""
    off, cnt = next((o, c) for t, o, c in xp.segments() if t == "prefix")
    for m in ("mA", "mB"):
        rows[1][m][:, off:off + cnt] = -30.0
        rows[2][m][1::2, off:off + cnt] = -30.0
        rows[2][m][0::2, off] = 30.0


@pytest.fixture(scope="module")
def mesh_runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh_serve")
    cfg, params, rows = _setup()
    hcfg, hparams, hrows = _setup(HETERO)
    _craft_prefix(hrows, hcfg.xpeft)
    data = dict(
        arch=ARCH, engine=ENGINE, paths=PATHS, stats=STATS,
        xpeft={"base": {}, "hetero": HETERO},
        params={k: bridge.to_torch(jax.tree.map(np.asarray, p))
                for k, p in (("base", params), ("hetero", hparams))},
        rows={"base": rows, "hetero": hrows})
    torch.save(data, tmp / "data.pt")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    procs = [subprocess.Popen(
        [sys.executable, "-c", WORKER, str(r), "4", str(tmp / "store"),
         str(tmp / "data.pt"), str(tmp / "out%d.pt")],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(4)]
    for rank, p in enumerate(procs):
        _, err = p.communicate(timeout=300)
        if p.returncode:
            pytest.fail(f"rank {rank} exited {p.returncode}:\n{err[-6000:]}")
    ranks = [torch.load(tmp / f"out{r}.pt", weights_only=False)
             for r in range(4)]
    # JAX's one-device windowed engine on the same weights and requests
    js = JStore(cfg.num_layers, cfg.xpeft.num_adapters,
                cfg.xpeft.bottleneck, "hard", cfg.xpeft.k)
    for pid, row in enumerate(rows):
        js.add_profile(pid, row)
    eng = JEngine(cfg, params, js, **{k: v for k, v in ENGINE.items()
                                      if k != "page_size"})
    jreqs = skewed_requests(JRequest, cfg.vocab_size)
    eng.run_until_drained(list(jreqs))
    return dict(ranks=ranks,
                jax={r.uid: list(map(int, r.generated)) for r in jreqs})


@pytest.mark.parametrize("path", list(PATHS))
def test_mesh_tokens_equal_one_device(mesh_runs, path):
    ranks = mesh_runs["ranks"]
    got = ranks[0][path]
    assert got["tokens"] == got["one_tokens"]
    assert all(r[path]["tokens"] == got["tokens"] for r in ranks)
    assert all(r[path]["prefix"] == got["prefix"] for r in ranks)


@pytest.mark.parametrize("path", list(PATHS))
def test_mesh_entries_devices_and_bytes(mesh_runs, path):
    got = mesh_runs["ranks"][0][path]
    assert got["entries_equal"]
    # per-step serving caches no aggregate; every other path admitted
    # each of the 3 profiles once
    assert got["entries"] == (0 if path == "per_step" else 3)
    assert all(r[path]["devices"] == 4 for r in mesh_runs["ranks"])
    assert 0 < got["bytes"] < got["one_bytes"]


def test_mesh_continuous_preempts_within_shards(mesh_runs):
    """The 8-page pool splits into two 4-page shards; two long requests
    on one shard outgrow it and the youngest swaps out to the host, to
    resume wherever a slot frees."""
    assert mesh_runs["ranks"][0]["continuous"]["preemptions"] > 0


def test_mesh_whole_pool_preempts(mesh_runs):
    """With the pool whole on every rank and the slots split, a preempted
    slot's rows come from the rank that stepped it."""
    assert mesh_runs["ranks"][0]["pool_whole"]["preemptions"] > 0


@pytest.mark.parametrize("path", ["mask_pages_2", "mask_pages_3"])
def test_mesh_entry_pool_decides_as_one_device(mesh_runs, path):
    """Entries fewer than slots: the pool is held whole on every rank and
    its uncoloured allocator refuses, requeues and promotes exactly as
    one device's does (a pool split by shard would refuse an admission
    one device accepts)."""
    ranks = mesh_runs["ranks"]
    got, n = ranks[0][path], int(path[-1])
    assert all(r[path]["stats"] == got["one_stats"] for r in ranks)
    assert got["stats"]["mask_entries"]["n_pages"] == n
    assert got["stats"]["mask_entries"]["oom_events"] > 0
    assert got["stats"]["scheduler"]["requeued"] > 0
    assert all(set(r[path]["pool_rows"].values()) == {n} for r in ranks)
    # one entry per slot keeps the split layout: 2 of 4 slots a data rank
    assert set(ranks[0]["continuous"]["pool_rows"].values()) == {2}


def test_mesh_hetero_prefix_rows(mesh_runs):
    assert set(mesh_runs["ranks"][0]["hetero"]["prefix"]) == {0, 2}


def test_mesh_windowed_equals_jax(mesh_runs):
    assert mesh_runs["ranks"][0]["windowed"]["tokens"] == mesh_runs["jax"]


def test_launcher_serves_on_a_mesh():
    """``torchrun ... -m repro_torch.launch.serve --mesh 2x1:data,model``
    on the CPU: rank 0 prints the per-device resident bytes and the same
    tokens as the one-process launcher."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1")
    base = ["-m", "repro_torch.launch.serve", "--smoke", "--device", "cpu"]
    outs = [subprocess.run(
        [sys.executable] + pre + base + post, cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=240)
        for pre, post in (([], []), (
            ["-m", "torch.distributed.run", "--standalone",
             "--nproc-per-node", "2"], ["--mesh", "2x1:data,model"]))]
    for out in outs:
        assert out.returncode == 0, out.stderr[-3000:]
    one, mesh = (o.stdout.splitlines() for o in outs)
    assert any("resident B/device" in line for line in mesh)
    toks = [[line for line in lines if line.startswith("  req ")]
            for lines in (one, mesh)]
    assert toks[0] and toks[0] == toks[1]
