"""The float32 gradient floor of rwkv6-7b's xpeft train step on the card:
how far the port's float32 gradients, on the card and on the CPU, lie
from its own float64 gradients (``chip_smoke.float64_everywhere``) over
several Gumbel and batch draws, at the card-vs-CPU step's config (2
layers at full width, 8 profiles, B=8 T=64) with the vocab at 8,192 and
at the full 65,536.

    python3 tools/grad_floor.py

At random init RWKV's float32 gradients are ill-conditioned and their
rounding error varies with the draw, so ``tools/recurrent_phase.py``
holds its card-vs-CPU float32 step under twice the largest distance
printed here (``RWKV_GRAD_REL_L2``): two float32 runs each within it of
float64 lie within twice it of each other. Prints one line per draw and
a JSON line of the largest readings last. Without a card it exits
non-zero.
"""
import json
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# (noise seed, MarkovLM seed): the first is chip_smoke's own draw
DRAWS = ((1, 0), (2, 0), (3, 1), (4, 2), (5, 3))
VOCABS = (8192, 65536)


def main():
    import torch
    if not torch.cuda.is_available():
        print("grad_floor: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(HERE, "src"))
    sys.path.insert(0, HERE)
    import chip_smoke as cs
    from repro_torch.configs import get_config
    from repro_torch.core import masks as M
    from repro_torch.data import MarkovLM
    from repro_torch.train import steps as ST
    from repro_torch.utils.tree import tree_map

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cs.log(f"device: {cs.nvidia_smi()} | torch {torch.__version__} cuda "
           f"{torch.version.cuda}")
    worst = {}
    for vocab in VOCABS:
        cfg = get_config("rwkv6-7b").with_(
            num_layers=2, dtype="float32", vocab_size=vocab) \
            .with_xpeft(max_profiles=8)
        state = ST.init_train_state(cfg, "xpeft", seed=0, device="cuda")
        with cs.float64_everywhere(torch):
            st64 = tree_map(lambda t: t.double() if t.is_floating_point()
                            else t, state)
        for nseed, bseed in DRAWS:
            batch = MarkovLM(vocab, 8, seed=bseed).sample(0, 8, 64)
            gen = torch.Generator(device="cuda").manual_seed(nseed)
            shape = (8, cfg.num_layers, cfg.xpeft.num_adapters)
            noise = tuple(M.gumbel(shape, generator=gen, device="cuda")
                          for _ in range(2))
            g = {dev: cs.train_step_grads(torch, cfg, state, batch, noise,
                                          dev)["grads"]["table"]
                 for dev in ("cuda", "cpu")}
            with cs.float64_everywhere(torch):
                g64 = cs.train_step_grads(
                    torch, cfg, st64, batch,
                    tuple(n.double() for n in noise), "cuda")
                g64 = g64["grads"]["table"]
            row = {k: dict(card=cs.rel_l2(g["cuda"][k], g64[k]),
                           cpu=cs.rel_l2(g["cpu"][k], g64[k]),
                           card_vs_cpu=cs.rel_l2(g["cuda"][k], g["cpu"][k]))
                   for k in g64}
            cs.log(f"V={vocab} noise {nseed} batch {bseed}: " + "; ".join(
                f"{k} card {v['card']:.3e} CPU {v['cpu']:.3e} card vs "
                f"CPU {v['card_vs_cpu']:.3e}" for k, v in row.items()))
            for v in row.values():
                for side, x in v.items():
                    worst[side] = max(worst.get(side, 0.0), x)
        del state, st64
        torch.cuda.empty_cache()
    floor = max(worst["card"], worst["cpu"])
    cs.log(f"largest float32 distance from float64: {floor:.3e} (twice: "
           f"{2 * floor:.3e}); largest card vs CPU {worst['card_vs_cpu']:.3e}")
    print(json.dumps(dict(worst, floor=floor)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
