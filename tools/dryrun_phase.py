"""``chip_smoke.py``'s phase 17: the dry run's bytes against the card's
allocator, and ``cfg.remat``'s three modes on the card.

    python3 tools/dryrun_phase.py

(a) qwen1.5-0.5b at full width and depth (bank N=256, b=64), a decode
    step of 4 slots over a 2,048-position cache with admission-time Â/B̂
    (the dry run's ``precomputed_adapters`` masks). The dry run
    (``launch/dryrun.py``'s ``run_cell`` on meta, a fake world of one
    rank: a 1x1 mesh) gives the resident bytes of the params, bank and
    cache; the same trees placed on the card must add exactly that many
    bytes to ``torch.cuda.memory_allocated()``, within 512 B per leaf (the
    allocator rounds each block up to 512 B). The card's decode step (the
    CUDA kernels in place of the plain versions the dry run counted) is
    run with every kernel counter at 0 just before it; its peak above what
    it was handed, over the dry run's ``peak_bytes_per_dev``, is printed,
    not asserted.
(b) qwen1.5-0.5b at full width and depth, xpeft, B=8 T=64, bf16: one
    gradient and three steps with ``remat`` none, full and dots from the
    same state, batches and Gumbel draws. Loss and every trainable
    gradient must be bitwise equal across the three; where the card does
    not give that, they are held to phase 7's bounds (loss 1e-4 relative,
    gradients 1e-3 relative L2) and the run says so. Each mode's peak
    memory above the frozen weights and ms per step are printed.

Without a card it exits non-zero. Its numbers are one JSON line last.
"""
import json
import os
import statistics
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCH = "qwen1.5-0.5b"
SLOTS, CACHE = 4, 2048
B, T, PROFILES, STEPS = 8, 64, 8, 3
MODES = ("none", "full", "dots")
ALLOC_ROUND = 512
DEV = "cuda"     # a CPU rehearsal sets "cpu" (and stubs torch.cuda)


def _leaves(tree):
    from repro_torch.utils.tree import tree_leaves
    return tree_leaves(tree)


def _bytes(tree):
    return sum(t.numel() * t.element_size() for t in _leaves(tree))


def phase_a(torch, cs):
    """(a): resident bytes, dry run against the allocator; the decode
    step's peak against the dry run's."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import dryrun as DR
    from repro_torch.models import model as MDL
    from repro_torch.serve.steps import greedy_next, make_decode_step

    cfg = get_config(ARCH)
    shape = ShapeConfig("decode_2k", CACHE, SLOTS, "decode")
    vspec = DR.VARIANTS["precomputed_adapters"]
    t0 = time.perf_counter()
    dry = DR.run_cell(cfg, shape, {"data": 1, "model": 1}, vspec=vspec)
    dry_s = time.perf_counter() - t0
    dev = torch.device(DEV)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    params = MDL.init_lm(cfg, device=dev)
    cache = MDL.init_cache(cfg, SLOTS, CACHE, device=dev)
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated() - base
    n_leaves = len(_leaves(params)) + len(_leaves(cache))
    exact = _bytes(params) + _bytes(cache)
    over = held - dry["resident_bytes"]
    cs.log(f"phase 17 (a): {ARCH} L={cfg.num_layers} d={cfg.d_model}, "
           f"{SLOTS} slots x {CACHE} positions: dry-run resident "
           f"{dry['resident_bytes']} B (its run {dry_s:.2f}s, "
           f"{dry['counter'].ops} ops), allocator {held} B for "
           f"{n_leaves} leaves ({over} B over, limit "
           f"{ALLOC_ROUND * n_leaves}); the trees' own bytes {exact}")
    assert dry["resident_bytes"] == exact, (dry["resident_bytes"], exact)
    assert 0 <= over < ALLOC_ROUND * n_leaves, over
    # the card's decode step with the kernels, on the same inputs' shapes
    g = torch.Generator(device=dev).manual_seed(17)
    xp, L, d = cfg.xpeft, cfg.num_layers, cfg.d_model
    dt = MDL.torch_dtype(cfg.dtype)
    masks = {"a_hat": 0.02 * torch.randn((SLOTS, L, d, xp.bottleneck),
                                         generator=g, device=dev).to(dt),
             "b_hat": 0.02 * torch.randn((SLOTS, L, xp.bottleneck, d),
                                         generator=g, device=dev).to(dt),
             "ln_scale": torch.ones((SLOTS, L, xp.bottleneck), device=dev),
             "ln_bias": torch.zeros((SLOTS, L, xp.bottleneck), device=dev)}
    tokens = torch.randint(0, cfg.vocab_size, (SLOTS, 1), generator=g,
                           device=dev, dtype=torch.int32)
    decode = make_decode_step(cfg)
    counters = cs.kernel_counters()
    with torch.no_grad():
        greedy_next(decode(params, tokens, cache, CACHE - 1,
                           profile_masks=masks)[0])     # warm
        torch.cuda.synchronize()
        for f in counters.values():
            f.launches = 0
        torch.cuda.reset_peak_memory_stats()
        handed = torch.cuda.memory_allocated()
        nxt = greedy_next(decode(params, tokens, cache, CACHE - 1,
                                 profile_masks=masks)[0])
        torch.cuda.synchronize()
    launches = {k: f.launches for k, f in counters.items()}
    step_peak = torch.cuda.max_memory_allocated() - handed
    ratio = step_peak / dry["counter"].peak_bytes
    assert nxt.shape == (SLOTS,)
    assert launches["fused_adapter_batched"] == L, launches
    cs.log(f"  decode step: card peak {step_peak} B above what it was "
           f"handed, dry run {dry['counter'].peak_bytes} B (plain "
           f"versions): ratio {ratio:.4f}; launches {launches}")
    del params, cache, masks
    torch.cuda.empty_cache()
    return {"resident_bytes_dry": dry["resident_bytes"],
            "resident_bytes_allocator": held, "leaves": n_leaves,
            "over_bytes": over, "dry_run_s": dry_s,
            "dry_peak_bytes": dry["counter"].peak_bytes,
            "card_step_peak_bytes": step_peak, "peak_ratio": ratio,
            "dry_flops": dry["counter"].flops, "launches": launches}


def _rel_l2(a, b):
    a, b = a.double(), b.double()
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


def phase_b(torch, cs):
    """(b): a gradient and three steps per remat mode, bitwise across
    modes (or phase 7's bounds), each mode's peak and ms per step."""
    from repro_torch.configs import get_config
    from repro_torch.core import masks as M
    from repro_torch.data import MarkovLM
    from repro_torch.train import steps as TST
    from repro_torch.utils.tree import tree_map

    dev = torch.device(DEV)
    cfg = get_config(ARCH).with_xpeft(max_profiles=PROFILES)
    state = TST.init_train_state(cfg, "xpeft", device=dev)
    src = MarkovLM(cfg.vocab_size, PROFILES, seed=0)
    g = torch.Generator(device=dev).manual_seed(7)
    shape = (B, cfg.num_layers, cfg.xpeft.num_adapters)
    noise = [tuple(M.gumbel(shape, generator=g, device=dev)
                   for _ in range(2)) for _ in range(STEPS)]
    batches = [src.sample(i, B, T) for i in range(STEPS)]
    runs = {}
    for mode in MODES:
        mcfg = cfg.with_(remat=mode)
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        batch = {k: torch.as_tensor(v).to(dev) for k, v in
                 batches[0].items()}
        grads, metrics = TST.grads_for_batch(
            state["frozen"], state["trainable"], batch, mcfg, "xpeft",
            noise[0])
        st = {"frozen": state["frozen"],
              "trainable": tree_map(torch.clone, state["trainable"]),
              "opt": tree_map(torch.clone, state["opt"])}
        step = TST.make_train_step(mcfg, "xpeft", lr=1e-3)
        losses, ms = [], []
        for i in range(STEPS):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            st, m = step(st, batches[i], noise[i])
            b.record()
            torch.cuda.synchronize()
            ms.append(a.elapsed_time(b))
            losses.append(m["loss"])
        peak = torch.cuda.max_memory_allocated() - held
        runs[mode] = dict(grads=grads, loss=metrics["loss"], losses=losses,
                          trainable=st["trainable"], ms=ms, peak=peak)
        del st
    ref = runs["none"]
    bitwise, worst_loss, worst_grad = True, 0.0, 0.0
    for mode in ("full", "dots"):
        r = runs[mode]
        pairs = [(r["loss"], ref["loss"])] + list(zip(r["losses"],
                                                      ref["losses"]))
        gpairs = list(zip(_leaves(r["grads"]), _leaves(ref["grads"]))) \
            + list(zip(_leaves(r["trainable"]), _leaves(ref["trainable"])))
        same = all(torch.equal(x, y) for x, y in pairs + gpairs)
        bitwise = bitwise and same
        worst_loss = max([worst_loss] + [
            abs(float(x) - float(y)) / max(abs(float(y)), 1e-30)
            for x, y in pairs])
        worst_grad = max([worst_grad] + [_rel_l2(x, y) for x, y in gpairs])
    out = {"bitwise": bitwise, "worst_loss_rel": worst_loss,
           "worst_grad_rel_l2": worst_grad, "batch": B, "seq": T,
           "steps": STEPS}
    for mode in MODES:
        r = runs[mode]
        out[mode] = {"peak_memory_bytes": r["peak"],
                     "ms_per_step": statistics.median(r["ms"]),
                     "ms_per_step_all": r["ms"],
                     "losses": [float(x) for x in r["losses"]]}
        cs.log(f"phase 17 (b): remat {mode:4s}: peak {r['peak'] / 2**30:.3f}"
               f" GiB above the {cfg.name} state held, ms/step "
               + " ".join(f"{v:.2f}" for v in r["ms"])
               + f", losses " + " ".join(f"{float(x):.6f}"
                                          for x in r["losses"]))
    cs.log(f"  remat none/full/dots bitwise: {bitwise} (worst loss rel "
           f"{worst_loss:.3e}, worst gradient / new-trainable rel L2 "
           f"{worst_grad:.3e})")
    if not bitwise:
        # ROADMAP queue 3 item: held to phase 7's bounds, nothing loosened
        assert worst_loss <= cs.TRAIN_LOSS_RTOL, worst_loss
        assert worst_grad <= cs.TRAIN_GRAD_REL_L2, worst_grad
    assert runs["full"]["peak"] < runs["none"]["peak"]
    return out


def phase_dryrun(torch):
    """Phase 17: (a) then (b); its numbers."""
    sys.path.insert(0, HERE)
    import chip_smoke as cs
    t0 = time.perf_counter()
    a = phase_a(torch, cs)
    b = phase_b(torch, cs)
    return {"a": a, "b": b, "seconds": time.perf_counter() - t0}


def main():
    import torch
    if not torch.cuda.is_available():
        print("dryrun_phase: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(HERE, "src"))
    sys.path.insert(0, HERE)
    import chip_smoke as cs
    from repro_torch.kernels import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cs.log(f"device: {cs.nvidia_smi()} | torch {torch.__version__} cuda "
           f"{torch.version.cuda}")
    _build.build()
    _build.load_library()
    out = phase_dryrun(torch)
    cs.log(json.dumps({"dryrun": out}, default=str))
    return 0


if __name__ == "__main__":
    sys.exit(main())
