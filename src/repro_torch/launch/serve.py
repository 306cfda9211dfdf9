"""Serving launcher: windowed multi-profile inference on the port's engine.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen1.5-0.5b \
      --requests 8 --slots 4 --sync-every 8          # on the card
  PYTHONPATH=src python -m repro_torch.launch.serve --smoke --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --smoke --device cpu \
      --no-precompute       # per-step mask serving (the paper's path)
  PYTHONPATH=src python -m repro_torch.launch.serve \
      --metrics-json /tmp/m.json --trace /tmp/t.json   # observability
  PYTHONPATH=src torchrun --standalone --nproc-per-node 4 \
      -m repro_torch.launch.serve --smoke --device cpu \
      --mesh 2x2:data,model          # a data x model mesh of 4 processes

Builds the model with random weights from seed 0, adds hard-mask
profiles to a ``ProfileStore`` and drains the requests through the
``ServeEngine``. Runs on the card unless ``--device cpu`` is passed.
``--mesh`` serves on a mesh of the processes ``torchrun`` starts (NCCL
on the card, gloo on the CPU, or ``--backend``); every rank drains the
same requests and rank 0 prints, with its per-device resident bytes.
``--metrics-json`` / ``--trace`` attach an observability bundle and write
its counters and p50/p95/p99 histograms, and a Chrome trace (Perfetto),
at exit.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen1.5-0.5b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-seq", type=int, default=128)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--profiles", type=int, default=4)
    ap.add_argument("--sync-every", type=int, default=8,
                    help="decode steps between host syncs (device-resident "
                    "slot state; 1 = a round trip per token)")
    ap.add_argument("--cache-mb", type=int, default=64,
                    help="profile-cache capacity in MiB (0 disables)")
    ap.add_argument("--no-precompute", action="store_true",
                    help="per-step mask serving: aggregate the masks "
                    "against the bank in every layer of every step instead "
                    "of once at admission (greedy tokens equal)")
    ap.add_argument("--mesh", default="",
                    help="serve on a mesh, e.g. 2x2:data,model (one "
                    "process per device, started by torchrun)")
    ap.add_argument("--backend", default=None,
                    help="process-group backend of --mesh (default: nccl "
                    "on cuda, gloo on cpu)")
    from repro_torch import obs as OBS
    OBS.add_cli_args(ap)  # --metrics-json PATH, --trace PATH
    args = ap.parse_args(argv)

    from repro_torch.configs import get_config, reduce_for_smoke
    from repro_torch.core import xpeft as XP
    from repro_torch.core.profiles import ProfileStore
    from repro_torch.models import init_lm
    from repro_torch.serve import Request, ServeEngine
    from repro_torch.utils import resolve_device

    device = resolve_device(args.device)
    mesh, rank = None, 0
    if args.mesh:
        from repro_torch.launch import mesh as MESH
        rank = MESH.init_distributed(device, args.backend)
        if device.type == "cuda":
            device = torch.device("cuda", torch.cuda.current_device())
        mesh = MESH.parse_mesh(args.mesh, device.type)
    say = print if rank == 0 else (lambda *a, **k: None)
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = reduce_for_smoke(cfg)
    params = init_lm(cfg, seed=0, device=device)

    xp = cfg.xpeft
    store = ProfileStore(cfg.num_layers, xp.num_adapters, xp.bottleneck,
                         xp.mask_type, xp.k)
    table = XP.init_profile_table(cfg.with_xpeft(max_profiles=args.profiles),
                                  seed=0)
    for pid in range(args.profiles):
        store.add_profile(pid, {k: v[pid] for k, v in table.items()})
    say(f"profiles: {args.profiles} x {store.bytes_per_profile()} B each "
          f"(masks, byte-level)")

    obs = OBS.from_cli_args(args)
    eng = ServeEngine(cfg, params, store, max_slots=args.slots,
                      max_seq=args.max_seq, sync_every=args.sync_every,
                      cache_bytes=args.cache_mb << 20,
                      precompute=not args.no_precompute, mesh=mesh,
                      obs=obs)
    if mesh is not None:
        rb = eng.resident_bytes_per_device()
        say(f"mesh {args.mesh}: {rb['total']} resident B/device (params "
            f"{rb['params']}, cache {rb['cache']})")
    rng = np.random.default_rng(0)
    reqs = [Request(uid=i,
                    prompt=rng.integers(0, cfg.vocab_size,
                                        size=rng.integers(4, 17)),
                    profile_id=i % args.profiles,
                    max_new_tokens=args.max_new)
            for i in range(args.requests)]
    t0 = time.perf_counter()
    steps = eng.run_until_drained(list(reqs))
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.perf_counter() - t0
    toks = sum(len(r.generated) for r in reqs)
    where = torch.cuda.get_device_name(device) if device.type == "cuda" \
        else "cpu"
    say(f"served {len(reqs)} requests / {toks} tokens in {steps} engine "
          f"steps, {dt:.3f}s ({toks / dt:.1f} tok/s on {where}, first-call "
          "costs included)")
    st = eng.serve_stats()
    say(f"profile cache: hit rate {st['profile_cache']['hit_rate']}, "
          f"{st['profile_cache']['entries']} entries / "
          f"{st['profile_cache']['bytes']} B; "
          f"prefill occupancy {st['prefill_occupancy']} over "
          f"{st['prefill_batches']} batches; "
          f"{st['syncs_per_token']} host syncs/token "
          f"(sync_every={st['sync_every']})")
    for r in reqs[:3]:
        say(f"  req {r.uid} (profile {r.profile_id}): {r.generated}")
    if obs is not None:
        obs.export(args.metrics_json or None, args.trace or None)
        cats = obs.tracer.category_counts()
        ttft = obs.metrics.snapshot()["histograms"].get("serve.ttft_us", {})
        say(f"obs: {sum(cats.values())} trace events {cats}; TTFT p50 "
              f"{ttft.get('p50', 0.0)} us, p95 {ttft.get('p95', 0.0)} us")
    if mesh is not None:
        import torch.distributed as dist
        dist.destroy_process_group()
    return reqs, eng


if __name__ == "__main__":
    main()
