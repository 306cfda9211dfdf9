"""``chip_smoke.py``'s phase 15 (multi-device serving) on the card; run
alone:

    python3 tools/mesh_phase.py

Builds the kernels, turns TF32 off as ``chip_smoke.py`` does and runs
``phase_mesh`` on qwen1.5-0.5b at full width and ``chip_smoke.CUT_LAYERS``
of its 24 layers (bf16, random weights from seed 0, bank N=256, b=64,
k=50, 4 profiles, phase 4's 8 requests of 16 new tokens, 4 slots,
max_seq 128, sync_every 8):

(a) a world-1 NCCL process group in this process and the mesh
    ``1x1:data,model`` on it: composed, ``decode_fused``, continuous
    (pages of 16) and int8 each served with ``mesh=None`` and then on the
    mesh, every kernel counter set to 0 just before the mesh drain. The
    mesh run's tokens bitwise the ``mesh=None`` run's; #1 and #2 launched
    on the composed and continuous mesh runs, #8 on ``decode_fused``'s, #5
    and #6 on int8's. The group is destroyed afterwards.
(b) two processes on the one card over gloo (NCCL refuses two ranks on one
    device), the mesh ``2x1:data,model`` (``B_MESHES``; its 1x2 drain left out
    for the call's time: gloo's gathers through the host made it ~30 s; phase
    16 (c) still runs the 1x2 mesh): first gloo's ``all_gather`` and
    ``all_reduce`` run on CUDA tensors and their results are checked (a build
    that refuses them fails the phase); then the composed drain of the first
    wave's 4 requests (a windowed wave decodes alone, so its tokens are those
    requests' in (a)), every kernel counter set to 0 just before it, whose
    tokens must equal (a)'s ``mesh=None`` composed run bitwise on both ranks
    and which must launch #1 and #2 on each rank, and a decode step measured:
    host ms (host clock, synchronised), device ms and kernels (torch.profiler,
    the card only) and the bytes each rank received in gathers, per step; the
    resident bytes per device against one device's.

Every failed check raises. Prints one JSON line of its numbers last.
Without a card it exits non-zero.
"""
import json
import os
import socket
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if HERE not in sys.path:
    sys.path.insert(0, HERE)

import chip_smoke as cs  # noqa: E402

# the kernels each (a) path must launch on the mesh
MUST_LAUNCH = {
    "composed": ("mask_aggregate_batched", "fused_adapter_batched"),
    "decode_fused": ("mask_aggregate_batched", "decode_block_fused"),
    "continuous": ("mask_aggregate_batched", "fused_adapter_batched"),
    "int8": ("mask_aggregate_quant_batched", "fused_adapter_quant_batched"),
}
B_MESHES = ((2, 1),)
B_TIMEOUT_S = 300


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def setup(torch, cfg, dev):
    """The weights, store and requests every run of the phase serves."""
    from repro_torch.core import xpeft as XP
    from repro_torch.core.profiles import ProfileStore
    from repro_torch.models import init_lm
    from repro_torch.serve import Request

    params = init_lm(cfg, seed=0, device=dev)
    xp = cfg.xpeft
    table = XP.init_profile_table(cfg.with_xpeft(max_profiles=4), seed=0)
    stores = {}
    for quant in ("none", "int8"):
        kw = {} if quant == "none" else dict(quant=quant)
        stores[quant] = ProfileStore(cfg.num_layers, xp.num_adapters,
                                     xp.bottleneck, xp.mask_type, xp.k, **kw)
        for pid in range(4):
            stores[quant].add_profile(pid, {k: v[pid]
                                            for k, v in table.items()})
    return params, stores, lambda: cs.make_requests(Request, cfg.vocab_size)


PATHS = {  # (cfg options, xpeft options, engine options)
    "composed": ({}, {}, {}),
    "decode_fused": ({"decode_fused": True}, {}, {}),
    "continuous": ({}, {}, {"continuous": True, "page_size": 16}),
    "int8": ({}, {"bank_quant": "int8"}, {}),
}


def drain(torch, cfg, params, stores, requests, path, mesh, n=8):
    """One path's drain of the first ``n`` requests: (tokens by uid,
    engine, seconds)."""
    from repro_torch.serve import ServeEngine

    cfg_kw, xkw, ekw = PATHS[path]
    run_cfg = cfg.with_(**cfg_kw).with_xpeft(**xkw)
    eng = ServeEngine(run_cfg, params,
                      stores[run_cfg.xpeft.bank_quant], max_slots=4,
                      max_seq=128, sync_every=8, mesh=mesh, **ekw)
    reqs = requests()[:n]
    t = time.perf_counter()
    eng.run_until_drained(list(reqs))
    if cfg_dev(params) == "cuda":
        torch.cuda.synchronize()
    dt = time.perf_counter() - t
    assert all(r.done and len(r.generated) == 16 for r in reqs)
    return {r.uid: [int(t) for t in r.generated] for r in reqs}, eng, dt


def cfg_dev(params) -> str:
    return params["embed"].device.type


def part_a(torch, cfg, params, stores, requests, dev):
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_mesh

    if dev == "cuda":
        torch.cuda.set_device(0)
    dist.init_process_group("nccl" if dev == "cuda" else "gloo",
                            init_method=f"tcp://127.0.0.1:{free_port()}",
                            rank=0, world_size=1)
    counters = cs.kernel_counters()
    out, ref_tokens = {}, None
    try:
        mesh = make_mesh((1, 1), ("data", "model"), dev)
        for path in PATHS:
            one, one_eng, one_dt = drain(torch, cfg, params, stores,
                                         requests, path, None)
            for fn in counters.values():
                fn.launches = 0
            got, eng, dt = drain(torch, cfg, params, stores, requests, path,
                                 mesh)
            launches = {k: fn.launches for k, fn in counters.items()}
            st = eng.serve_stats()
            cs.log(f"phase 15 (a) {path} on 1x1:data,model (nccl): tokens "
                   f"bitwise mesh=None {got == one}; {dt:.3f}s (mesh=None "
                   f"{one_dt:.3f}s); devices {st['devices']}; launches "
                   f"{launches}")
            assert got == one, path
            assert st["devices"] == 1
            for name in MUST_LAUNCH[path]:
                assert launches[name] > 0, (path, name, launches)
            out[path] = dict(launches=launches, seconds=dt,
                             one_seconds=one_dt, bitwise=True)
            if path == "composed":
                ref_tokens = one
                out["one_device_bytes"] = \
                    one_eng.resident_bytes_per_device()["total"]
    finally:
        dist.destroy_process_group()
    return out, ref_tokens


def gloo_on_cuda(torch, dist, rank):
    """gloo's ``all_gather`` and ``all_reduce`` on CUDA tensors, their
    results checked; a build that refuses them raises here."""
    x = torch.full((1,), float(rank + 1), device="cuda")
    outs = [torch.empty_like(x) for _ in range(dist.get_world_size())]
    dist.all_gather(outs, x)
    assert [float(o) for o in outs] == [1.0, 2.0], outs
    dist.all_reduce(x)
    assert float(x) == 3.0, x
    if rank == 0:
        cs.log("  gloo took all_gather and all_reduce on CUDA tensors")


def step_numbers(torch, eng, requests, dev, steps=4):
    """A decode step of a fresh admission of 4 requests after 2 warm-up
    steps: host ms (host clock, synchronised), device ms and kernels
    (torch.profiler, the card only) and bytes received in gathers, per
    step."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.distributed import sharding as SH

    eng.submit(requests()[:4])
    eng.admit_many(eng.scheduler.next_batch(4))
    for _ in range(2):
        eng.step()
    eng.sync()
    sync = torch.cuda.synchronize if dev == "cuda" else (lambda: None)
    sync()
    b0 = SH.all_gather.bytes
    acts = [ProfilerActivity.CUDA] if dev == "cuda" else \
        [ProfilerActivity.CPU]
    with profile(activities=acts) as prof:
        t = time.perf_counter()
        for _ in range(steps):
            eng.step()
        eng.sync()
        sync()
        host = (time.perf_counter() - t) / steps * 1e3
    rows = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    dev_ms = sum(e.self_device_time_total for e in rows) / 1e3 / steps
    kernels = sum(e.count for e in rows) / steps
    if dev == "cuda":
        assert dev_ms > 0, "the profiler traced no kernel"
    return dict(host_ms=host, device_ms=dev_ms, kernels=kernels,
                gathered_bytes=(SH.all_gather.bytes - b0) / steps)


def worker(rank, port, dev, cfg, ref_tokens, one_bytes, out_path):
    """One rank of (b): gloo over 2 processes, each mesh of B_MESHES."""
    import torch
    import torch.distributed as dist

    from repro_torch.kernels import _build
    from repro_torch.launch.mesh import make_mesh

    if dev == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.cuda.set_device(0)
        _build.load_library()
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=2)
    if dev == "cuda":
        gloo_on_cuda(torch, dist, rank)
    params, stores, requests = setup(torch, cfg, dev)
    counters = cs.kernel_counters()
    out = {}
    for shape in B_MESHES:
        name = "x".join(map(str, shape)) + ":data,model"
        mesh = make_mesh(shape, ("data", "model"), dev)
        for fn in counters.values():
            fn.launches = 0
        got, eng, dt = drain(torch, cfg, params, stores, requests,
                             "composed", mesh, n=4)
        launches = {k: fn.launches for k, fn in counters.items()}
        assert got == {u: ref_tokens[u] for u in got}, (rank, name)
        if dev == "cuda":   # the wrappers count only on the card
            for k in MUST_LAUNCH["composed"]:
                assert launches[k] > 0, (rank, name, k, launches)
        st = eng.serve_stats()
        assert st["devices"] == 2
        rb = eng.resident_bytes_per_device()
        nums = step_numbers(torch, eng, requests, dev)
        out[name] = dict(seconds=dt, bitwise=True, resident=rb,
                         one_device_bytes=one_bytes, launches=launches,
                         **nums)
        assert rb["total"] < one_bytes, (name, rb, one_bytes)
        if rank == 0:
            cs.log(f"phase 15 (b) {name} (gloo): tokens bitwise (a)'s "
                   f"mesh=None run; launches {launches}; drain {dt:.3f}s; "
                   f"resident {rb['total']} B/device vs {one_bytes} on one "
                   f"device ({rb}); a decode step: host {nums['host_ms']:.2f}"
                   f" ms, device {nums['device_ms']:.4f} ms in "
                   f"{nums['kernels']:.0f} kernels, "
                   f"{nums['gathered_bytes'] / 1e6:.2f} MB gathered")
        del eng
    dist.barrier()
    dist.destroy_process_group()
    if rank == 0:
        with open(out_path, "w") as f:
            json.dump(out, f)


def part_b(torch, cfg, ref_tokens, one_bytes, dev):
    import torch.multiprocessing as mp

    path = os.path.join(HERE, "build", "mesh_phase_b.json")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    ctx = mp.get_context("spawn")
    port = free_port()
    procs = [ctx.Process(target=worker, args=(r, port, dev, cfg, ref_tokens,
                                              one_bytes, path))
             for r in range(2)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + B_TIMEOUT_S
    try:
        for p in procs:
            p.join(max(deadline - time.monotonic(), 1))
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(10)
    codes = [p.exitcode for p in procs]
    assert codes == [0, 0], f"phase 15 (b) ranks exited {codes}"
    with open(path) as f:
        return json.load(f)


def phase_mesh(torch, cfg=None, dev="cuda"):
    from repro_torch.configs import get_config

    t0 = time.perf_counter()
    cfg = cfg or get_config("qwen1.5-0.5b").with_(num_layers=cs.CUT_LAYERS)
    params, stores, requests = setup(torch, cfg, dev)
    a, ref_tokens = part_a(torch, cfg, params, stores, requests, dev)
    one_bytes = a.pop("one_device_bytes")
    del params, stores
    if dev == "cuda":
        torch.cuda.empty_cache()
    t_a = time.perf_counter() - t0
    b = part_b(torch, cfg, ref_tokens, one_bytes, dev)
    out = dict(a=a, b=b, one_device_bytes=one_bytes,
               runs={k: v["launches"] for k, v in a.items()},
               runs_b={k: v["launches"] for k, v in b.items()},
               seconds=time.perf_counter() - t0, seconds_a=t_a)
    cs.log(f"phase 15: {out['seconds']:.1f}s ((a) {t_a:.1f}s)")
    return out


def main():
    import torch
    if not torch.cuda.is_available():
        print("mesh_phase: needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(HERE, "src"))
    from repro_torch.kernels import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = cs.nvidia_smi()
    cs.log(f"device: {torch.cuda.get_device_name(0)} | {smi}")
    t = time.perf_counter()
    _build.build(verbose=False)
    _build.load_library()
    cs.log(f"build {time.perf_counter() - t:.1f}s")
    out = phase_mesh(torch)
    cs.log(smi)
    cs.log(json.dumps(out, default=str))
    return 0


if __name__ == "__main__":
    sys.exit(main())
