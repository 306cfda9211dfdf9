"""Training launcher: the paper's loop, and the profile lifecycle.

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen1.5-0.5b \\
      --mode xpeft --steps 100 --batch 8 --seq 64 --ckpt-dir CK  # the card
  PYTHONPATH=src python -m repro_torch.launch.train --smoke --device cpu \\
      --steps 3

``--onboard`` switches to the lifecycle: stream ``--profiles`` P >> S
profiles through an S-slot roster (``train/roster.py``), graduating
converged profiles into a ProfileStore written to ``--store-out``:

  PYTHONPATH=src python -m repro_torch.launch.train --onboard --smoke \\
      --device cpu --profiles 6 --roster-slots 2 --store-out S.npz \\
      --ckpt-dir CK

Both flows run through ``Trainer``: metrics buffered on the device and
fetched once per ``--log-every`` window, checkpoints every
``--ckpt-every`` steps under ``--ckpt-dir`` (``--resume`` continues from
the newest one that verifies), a preemption signal checkpoints and stops.
``--metrics-json`` / ``--trace`` export the obs bundle's counters and a
Chrome trace. The plain flow draws ``MarkovLM.sample(step, batch, seq)``
through a ``ShardedLoader``, with the Gumbel noise from a
``torch.Generator`` seeded ``--seed + 1``. Runs on the card unless
``--device cpu`` is passed.

``--mesh 2x1:data,model`` trains on a mesh of the processes ``torchrun``
starts (NCCL on the card, gloo on the CPU, or ``--backend``), both flows:

  PYTHONPATH=src python -m torch.distributed.run --standalone \\
      --nproc-per-node 2 -m repro_torch.launch.train --smoke --device cpu \\
      --mesh 2x1:data,model [--onboard]

The plain flow holds the frozen tree as "model" blocks and each rank's
``ShardedLoader`` draws its rows of the batch (``host_id`` the rank's
data index, ``num_hosts`` the data size); ``--onboard`` puts the
roster's slots over "data". Every rank runs the same loop; rank 0 prints
and writes the checkpoints and the store.
"""
from __future__ import annotations

import argparse
import contextlib

import torch


def parse_args(argv=None):
    from repro_torch import obs as OBS

    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen1.5-0.5b")
    ap.add_argument("--mode", default="xpeft",
                    choices=["xpeft", "adapter", "head_only"])
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--profiles", type=int, default=8)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-runnable)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--mesh", default="",
                    help="train on a mesh, e.g. 2x1:data,model (one "
                         "process per device, started by torchrun)")
    ap.add_argument("--backend", default=None,
                    help="process-group backend of --mesh (default: nccl "
                         "on the card, gloo on the CPU)")
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    # --onboard: the profile lifecycle (roster / onboarding / gang step)
    ap.add_argument("--onboard", action="store_true",
                    help="stream --profiles through a roster, graduating "
                         "converged profiles into --store-out")
    ap.add_argument("--roster-slots", type=int, default=4)
    ap.add_argument("--per-slot-batch", type=int, default=4)
    ap.add_argument("--num-labels", type=int, default=0,
                    help="add a classification head (0 = LM objective)")
    ap.add_argument("--graduate-min-steps", type=int, default=20)
    ap.add_argument("--graduate-max-steps", type=int, default=80)
    ap.add_argument("--target-loss", type=float, default=None)
    ap.add_argument("--target-acc", type=float, default=None)
    ap.add_argument("--ema-decay", type=float, default=0.9)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--store-out", default="")
    OBS.add_cli_args(ap)  # --metrics-json PATH, --trace PATH
    return ap.parse_args(argv)


def setup_mesh(args):
    """(device, mesh) of a run: with ``--mesh``, the process joins the
    group ``torchrun`` describes and the mesh is built over it."""
    from repro_torch.utils import resolve_device

    device = resolve_device(args.device)
    if not args.mesh:
        return device, None
    from repro_torch.launch import mesh as MESH

    MESH.init_distributed(device, args.backend)
    if device.type == "cuda":
        device = torch.device("cuda", torch.cuda.current_device())
    return device, MESH.parse_mesh(args.mesh, device.type)


def _say(mesh):
    from repro_torch.distributed import sharding as SH

    return print if mesh is None or SH.is_lead(mesh) else \
        (lambda *a, **k: None)


def _config(args):
    from repro_torch.configs import get_config, reduce_for_smoke

    cfg = get_config(args.arch)
    return reduce_for_smoke(cfg) if args.smoke else cfg


def _report_obs(obs, args) -> None:
    if obs is not None:
        obs.export(args.metrics_json or None, args.trace or None)
        print(f"obs: {sum(obs.tracer.category_counts().values())} trace "
              f"events {obs.tracer.category_counts()}")


def build(args, device=None, mesh=None):
    """(cfg, state, step, source, generator) of a plain run; on a mesh the
    state's frozen tree held as this rank's blocks."""
    from repro_torch.data import MarkovLM
    from repro_torch.train.steps import (init_train_state, make_train_step,
                                         shard_train_state)
    from repro_torch.utils import resolve_device

    device = resolve_device(args.device if device is None else device)
    cfg = _config(args).with_xpeft(max_profiles=max(args.profiles, 2))
    state = init_train_state(cfg, args.mode, seed=args.seed, device=device)
    if mesh is not None:
        state = shard_train_state(state, mesh)
    step = make_train_step(cfg, args.mode, lr=args.lr, mesh=mesh)
    source = MarkovLM(cfg.vocab_size, args.profiles, seed=args.seed)
    gen = torch.Generator(device=device).manual_seed(args.seed + 1)
    return cfg, state, step, source, gen


def run(args, observe=None, preemption=None, device=None, mesh=None):
    """The plain training loop through ``Trainer``: ``args.steps`` steps
    over ``ShardedLoader(MarkovLM, batch, seq)`` (after a resume,
    ``args.steps`` more). ``observe(i, state)``, if given, returns a
    context manager entered around step i, given the state before it
    (timers, profilers); ``preemption`` a ``PreemptionHandler`` (the
    command line installs one); ``mesh`` a mesh the process group already
    holds (``setup_mesh``). Returns dict(cfg, state, step, source,
    generator, history, trainer), the history one record of host floats
    per step."""
    from repro_torch import obs as OBS
    from repro_torch.data import ShardedLoader
    from repro_torch.train.steps import _batch_share
    from repro_torch.train.trainer import Trainer

    cfg, state, step, source, gen = build(args, device, mesh)
    host, hosts, _ = (0, 1, ()) if mesh is None else _batch_share(mesh)
    if args.batch % hosts:
        raise ValueError(f"--batch {args.batch} does not split over "
                         f"{hosts} data ranks")
    obs = OBS.from_cli_args(args)
    observe = observe or (lambda i, state: contextlib.nullcontext())
    holder = {}

    def observed(state, batch, rng):
        with observe(holder["trainer"].step, state):
            return step(state, batch, rng)

    trainer = Trainer(observed, state,
                      ShardedLoader(source, args.batch, args.seq,
                                    host_id=host, num_hosts=hosts),
                      ckpt_dir=args.ckpt_dir or None,
                      ckpt_every=args.ckpt_every,
                      preemption=preemption, rng=gen, obs=obs, mesh=mesh)
    holder["trainer"] = trainer
    if args.resume and trainer.try_resume():
        _say(mesh)(f"resumed from step {trainer.step}")
    hist = trainer.run(args.steps)
    if trainer.lead:
        _report_obs(obs, args)
    return dict(cfg=cfg, state=trainer.state, step=step, source=source,
                generator=trainer.rng, history=hist, trainer=trainer)


def run_onboarding(args, device=None, mesh=None):
    """--onboard: stream P >> S profiles through an S-slot roster and
    graduate converged profiles into a ProfileStore (the train -> serve
    loop); on a mesh the roster's slots over "data". Returns the
    trainer."""
    from repro_torch import obs as OBS
    from repro_torch.data import MarkovLM, ProfileClassification
    from repro_torch.distributed.fault import PreemptionHandler
    from repro_torch.train import GraduationPolicy
    from repro_torch.train.onboarding import build_onboarding_run

    obs = OBS.from_cli_args(args)
    cfg = _config(args)
    if args.num_labels:
        cfg = cfg.with_(num_labels=args.num_labels)
        source = ProfileClassification(cfg.vocab_size, cfg.num_labels,
                                       num_profiles=args.profiles,
                                       seed=args.seed)
    else:
        source = MarkovLM(cfg.vocab_size, args.profiles, seed=args.seed)
    policy = GraduationPolicy(
        min_steps=args.graduate_min_steps, max_steps=args.graduate_max_steps,
        ema_decay=args.ema_decay,
        target_loss=args.target_loss, target_acc=args.target_acc)
    trainer, _ = build_onboarding_run(
        cfg, source, range(args.profiles), slots=args.roster_slots,
        per_slot=args.per_slot_batch, seq_len=args.seq, policy=policy,
        lr=args.lr, seed=args.seed,
        device=args.device if device is None else device, mesh=mesh,
        store_path=args.store_out or None,
        ckpt_dir=args.ckpt_dir or None, ckpt_every=args.ckpt_every,
        preemption=PreemptionHandler(), log_every=args.log_every, obs=obs)
    scheduler, store = trainer.scheduler, trainer.scheduler.store
    say = _say(mesh)
    if args.resume and trainer.try_resume():
        say(f"resumed onboarding from step {trainer.step}: "
            f"{scheduler.stats()}")
    trainer.run_until_drained(max_steps=args.steps)
    st = scheduler.stats()
    say(f"onboarding done at step {trainer.step}: "
          f"{st['graduated']} graduated, {st['evicted']} evicted, "
        f"{st['quarantined']} quarantined, {st['in_training']} in "
        f"training, {st['pending']} pending, host syncs/step "
        f"{trainer.host_syncs / max(trainer.step, 1):.3f}")
    if args.store_out and trainer.lead:
        store.save(args.store_out)
        say(f"wrote {args.store_out}: {len(store.profile_ids())} profiles, "
            f"{store.bytes_per_profile()} B/profile (masks)")
    if trainer.lead:
        _report_obs(obs, args)
    if st["graduated"] == 0:
        raise SystemExit("onboarding graduated zero profiles")
    if not scheduler.finished():
        # the --steps backstop cut the stream short: in-slot and queued
        # profiles never reached the store, which must not look like
        # success
        raise SystemExit(
            f"onboarding truncated by --steps {args.steps}: "
            f"{st['in_training']} profiles still in slots, "
            f"{st['pending']} pending; raise --steps (or --resume from "
            "the checkpoint) to finish the stream")
    return trainer


def main(argv=None):
    args = parse_args(argv)
    device, mesh = setup_mesh(args)
    try:
        if args.onboard:
            return run_onboarding(args, device, mesh)
        from repro_torch.distributed.fault import PreemptionHandler

        out = run(args, preemption=PreemptionHandler(), device=device,
                  mesh=mesh)
        hist = out["history"]
        if hist:
            _say(mesh)(f"final loss {hist[-1]['loss']:.4f} after step "
                       f"{hist[-1]['step']} (grad norm "
                       f"{hist[-1]['grad_norm']:.4f}; stragglers "
                       f"{out['trainer'].watchdog.slow_steps})")
        return out
    finally:
        if mesh is not None:
            import torch.distributed as dist
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
