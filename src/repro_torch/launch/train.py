"""Training launcher: the plain (single-device) path of the paper's loop.

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen1.5-0.5b \\
      --mode xpeft --steps 100 --batch 8 --seq 64          # on the card
  PYTHONPATH=src python -m repro_torch.launch.train --smoke --device cpu \\
      --steps 3

Builds the frozen model and the mode's trainables from ``--seed``, then
runs ``make_train_step`` over ``MarkovLM.sample(step, batch, seq)``, the
single-host batches of the JAX launcher's loader, with the Gumbel noise
drawn from a ``torch.Generator`` seeded ``--seed + 1``, and prints the
final loss. Runs on the card unless ``--device cpu`` is passed. The
sharded mesh, checkpoints, resume, the onboarding flow and observability
exports raise ``NotImplementedError`` naming their ROADMAP item.
"""
from __future__ import annotations

import argparse
import contextlib

import torch

# flag -> what it needs, for the flags this launcher refuses
_NOT_PORTED = {
    "mesh": "sharded training (ROADMAP queue 1, item 11)",
    "ckpt_dir": "checkpoints and the Trainer (ROADMAP queue 1, item 8)",
    "resume": "checkpoints and the Trainer (ROADMAP queue 1, item 8)",
    "onboard": "the onboarding lifecycle (ROADMAP queue 1, item 8)",
    # JAX exports training metrics and traces only through its Trainer
    "metrics_json": "observability exports through the Trainer (ROADMAP "
                    "queue 1, item 8)",
    "trace": "observability exports through the Trainer (ROADMAP queue 1, "
             "item 8)",
}


def parse_args(argv=None):
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
    ap.add_argument("--mesh", default="")
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--onboard", action="store_true")
    ap.add_argument("--metrics-json", default="")
    ap.add_argument("--trace", default="")
    args = ap.parse_args(argv)
    for flag, what in _NOT_PORTED.items():
        if getattr(args, flag):
            raise NotImplementedError(
                f"--{flag.replace('_', '-')}: {what} is not ported")
    return args


def build(args):
    """(cfg, state, step, source, generator) of a run."""
    from repro_torch.configs import get_config, reduce_for_smoke
    from repro_torch.data import MarkovLM
    from repro_torch.train.steps import init_train_state, make_train_step
    from repro_torch.utils import resolve_device

    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = reduce_for_smoke(cfg)
    cfg = cfg.with_xpeft(max_profiles=max(args.profiles, 2))
    state = init_train_state(cfg, args.mode, seed=args.seed, device=device)
    step = make_train_step(cfg, args.mode, lr=args.lr)
    source = MarkovLM(cfg.vocab_size, args.profiles, seed=args.seed)
    gen = torch.Generator(device=device).manual_seed(args.seed + 1)
    return cfg, state, step, source, gen


def run(args, observe=None):
    """The training loop: ``args.steps`` steps. ``observe(i, state)``, if
    given, returns a context manager entered around step i, given the
    state before it (timers, profilers). Returns dict(cfg, state, step,
    source, generator, history), the history one metrics dict per step."""
    cfg, state, step, source, gen = build(args)
    observe = observe or (lambda i, state: contextlib.nullcontext())
    history = []
    for i in range(args.steps):
        batch = source.sample(i, args.batch, args.seq)
        with observe(i, state):
            state, metrics = step(state, batch, gen)
        history.append(metrics)
    return dict(cfg=cfg, state=state, step=step, source=source,
                generator=gen, history=history)


def main(argv=None):
    args = parse_args(argv)
    out = run(args)
    hist = out["history"]
    if hist:
        print(f"final loss {float(hist[-1]['loss']):.4f} after "
              f"{len(hist)} steps (grad norm "
              f"{float(hist[-1]['grad_norm']):.4f})")
    return out


if __name__ == "__main__":
    main()
