"""``chip_smoke.py``'s phase 16 (multi-device training) on the card; run
alone:

    python3 tools/mesh_train_phase.py

Builds the kernels, turns TF32 off as ``chip_smoke.py`` does and runs
``phase_mesh_train``: bf16, random weights from seed 0, bank N=256, b=64,
k=50.

(a) qwen1.5-0.5b at full width and ``chip_smoke.MESH_TRAIN_LAYERS`` layers on a
    world-1 NCCL group in this process, mesh ``1x1:data,model``: one gang
    step (4 slots x 4 examples x T=32) and one plain xpeft step (B=8,
    T=64), each BITWISE its ``mesh=None`` step (the roster, the new
    trainables and moments, the loss). The group is destroyed afterwards.
(d, reference) in this process, before any spawn and freed after:
    qwen3-moe-30b-a3b at full width on its first ``MOE_LAYERS`` of 48
    layers, one forward (B=4, T=64) with every layer's routing recorded,
    and the same model at ``MOE_TRAIN_LAYERS`` layers in float32 (phase
    7's precision and depth) for one xpeft train step (B=4, T=64).
Then ONE spawn of two processes on the one card over gloo (NCCL refuses
two ranks on one device), gloo's collectives checked on CUDA tensors
first, runs:
(b) the elastic drill at 2x1 with JAX's drill numbers and T=32 (4
    profiles through 4 slots, 2 examples a slot, graduation at 3-5 steps,
    lr 5e-2): one gang step against one device (rank 0 steps a one-device
    roster on the same rows and draws), in bf16 (where they part, the
    first roster leaf and the first aten op of the forward apart are
    named) and in float32, phase 7's precision, where its bounds hold;
    an unfailed run (rank 0 writes its store); a run checkpointed at
    step 4 and stopped at step 6;
(c) 1x2: the plain xpeft step with the frozen tree at rest as "model"
    blocks (gathered a layer at a time, again in the backward), against
    rank 0's ``mesh=None`` step in phase 7's bounds; resident and peak
    bytes per rank against one device's, bytes gathered, host ms (host
    clock, synchronised) and device ms (torch.profiler, the card only) a
    step;
(d) 1x2, expert parallel: the MoE forward against the reference under
    phase 12's routing rule (each token's first routing flip lies on a
    reference router-logit gap of at most ``ROUTE_GAP_FACTOR`` x its max
    |d router logit|), the float32 train step against the reference in
    phase 7's bounds, and each rank's expert bytes half of one device's.
Back in this process, (b) goes on in a new world of one process: the
checkpoint resumed on ``surviving_mesh(("data", "model"), (2, 1),
"data", 1)`` through ``restore(shardings=)``, run to the end; its store
byte-equal to the unfailed run's where the 2x1 gang step is bitwise one
device (else the first tensor where they part is named and phase 7's
bounds hold on the step); then that store served on the 1x1 mesh, #1 and
#2 counted, its tokens bitwise its ``mesh=None`` drain.

Every failed check raises. Prints one JSON line of its numbers last.
Without a card it exits non-zero.
"""
import gc
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if HERE not in sys.path:
    sys.path.insert(0, HERE)
TOOLS = os.path.join(HERE, "tools")
if TOOLS not in sys.path:
    sys.path.insert(0, TOOLS)

import chip_smoke as cs  # noqa: E402
import mesh_phase  # noqa: E402

MOE_LAYERS = 8
MOE_TRAIN_LAYERS = 2
ROUTE_GAP_FACTOR = 2.0      # phase 12's routing rule
GANG = dict(S=4, m=4, T=32)
PLAIN = dict(B=8, T=64)
MOE_BATCH = dict(B=4, T=64)
DRILL = dict(profiles=4, slots=4, per_slot=2, seq=32, min_steps=3,
             max_steps=5, lr=5e-2, ckpt_every=4, stop=6)
SPAWN_TIMEOUT_S = 600
OUT = os.path.join(HERE, "build", "mesh_train")


def qwen_cfg():
    from repro_torch.configs import get_config
    return get_config("qwen1.5-0.5b").with_(num_layers=cs.MESH_TRAIN_LAYERS) \
        .with_xpeft(max_profiles=8)


def moe_cfg(layers, dtype="bfloat16"):
    from repro_torch.configs import get_config
    return get_config("qwen3-moe-30b-a3b").with_(
        num_layers=layers, dtype=dtype).with_xpeft(max_profiles=8)


def sync(torch, dev):
    if dev == "cuda":
        torch.cuda.synchronize()


def bitwise(torch, a, b) -> bool:
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(
        a.reshape(-1).view(torch.uint8), b.reshape(-1).view(torch.uint8))


def first_part(torch, a, b):
    """The first leaf (``tree_paths`` order) where two trees part, with
    its max |d|, or None where every leaf is bitwise equal."""
    from repro_torch.distributed import sharding as SH
    from repro_torch.utils.tree import tree_paths

    pa, pb = tree_paths(a), tree_paths(b)
    for k in pa:
        x, y = SH.whole(pa[k]), SH.whole(pb[k])
        if not bitwise(torch, x, y):
            return k, (x.double() - y.double()).abs().max().item()
    return None


# ------------------------------------------------------------------ steps

def gang_batch(cfg, S, m, T, step=0):
    import numpy as np
    r = np.random.default_rng(1000 + step)
    toks = r.integers(0, cfg.vocab_size, (S, m, T + 1))
    return {"tokens": toks[..., :-1], "labels": toks[..., 1:]}


def gang_step(torch, cfg, frozen, mesh, dev, S, m, T):
    """One gang step over a roster of S admitted profiles (the roster on
    ``mesh``'s "data" rows): (roster state, metrics)."""
    from repro_torch.train import steps as ST
    from repro_torch.train.roster import Roster, init_roster_state

    roster = Roster(cfg, 2, S, device=dev, mesh=mesh)
    rstate = roster.place(init_roster_state(cfg, S, seed=3, device=dev))
    for slot in range(S):
        roster.admit(rstate, slot, slot)
    gen = torch.Generator(device=dev).manual_seed(11)
    _, met = ST.make_gang_step(cfg, lr=5e-2, mesh=mesh)(
        {"frozen": frozen, "roster": rstate}, gang_batch(cfg, S, m, T), gen)
    return rstate, {k: float(v) for k, v in met.items()}


def plain_batch(cfg, B, T):
    from repro_torch.data import MarkovLM
    return MarkovLM(cfg.vocab_size, 8, seed=0).sample(0, B, T)


def plain_step(torch, cfg, state, mesh, dev, B, T):
    """One xpeft step; on a mesh the state from ``shard_train_state`` and
    this rank's "data" rows of the batch: (new state, metrics,
    the clipped gradient m / (1 - b1))."""
    from repro_torch.train import steps as ST
    from repro_torch.train.steps import _batch_share

    batch = plain_batch(cfg, B, T)
    if mesh is not None:
        idx, n, _ = _batch_share(mesh)
        batch = {k: v[idx * (B // n):(idx + 1) * (B // n)]
                 for k, v in batch.items()}
    gen = torch.Generator(device=dev).manual_seed(1)
    new, met = ST.make_train_step(cfg, "xpeft", lr=1e-3, mesh=mesh)(
        state, batch, gen)
    grads = {k: v / 0.1 for k, v in new["opt"]["m"]["table"].items()}
    return new, {k: float(v) for k, v in met.items()}, grads


def step_bounds(torch, got, want, gg, wg, label, say=True):
    """Phase 7's step bounds: loss within TRAIN_LOSS_RTOL, each gradient
    leaf within TRAIN_GRAD_REL_L2 relative L2 (the k-hot selection: both
    steps draw the same noise onto the same logits); ``say`` logs them."""
    loss_err = abs(got["loss"] - want["loss"])
    rel = {k: cs.rel_l2(gg[k].float().cpu(), wg[k].float().cpu())
           for k in wg}
    if say:
        cs.log(f"  {label}: loss {got['loss']:.6f} vs {want['loss']:.6f} "
               f"|d| {loss_err:.3e} (tol "
               f"{cs.TRAIN_LOSS_RTOL * abs(want['loss']):.3e}); grad "
               "relative L2 " + ", ".join(f"{k} {v:.3e}"
                                          for k, v in rel.items())
               + f" (tol {cs.TRAIN_GRAD_REL_L2})")
    assert loss_err <= cs.TRAIN_LOSS_RTOL * abs(want["loss"]), label
    assert all(v <= cs.TRAIN_GRAD_REL_L2 for v in rel.values()), (label,
                                                                   rel)
    return dict(loss_abs_err=loss_err, grad_rel_l2=rel)


# --------------------------------------------------------------- part (a)

def part_a(torch, cfg, dev):
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import init_lm
    from repro_torch.train import steps as ST

    if dev == "cuda":
        torch.cuda.set_device(0)
    dist.init_process_group("nccl" if dev == "cuda" else "gloo",
                            init_method="tcp://127.0.0.1:"
                                        f"{mesh_phase.free_port()}",
                            rank=0, world_size=1)
    out = {}
    try:
        mesh = make_mesh((1, 1), ("data", "model"), dev)
        frozen = init_lm(cfg, seed=0, device=dev)
        runs = [gang_step(torch, cfg, frozen, mm, dev, **GANG)
                for mm in (None, mesh)]
        part = first_part(torch, runs[1][0], runs[0][0])
        cs.log(f"phase 16 (a) gang step {GANG} on 1x1:data,model (nccl): "
               f"roster bitwise mesh=None {part is None}; loss "
               f"{runs[1][1]['loss']:.6f}")
        assert part is None and runs[0][1] == runs[1][1], part
        out["gang_bitwise"] = True
        del frozen, runs
        state = ST.init_train_state(cfg, "xpeft", seed=0, device=dev)
        one = plain_step(torch, cfg, state, None, dev, **PLAIN)
        got = plain_step(torch, cfg, ST.shard_train_state(state, mesh), mesh,
                         dev, **PLAIN)
        part = first_part(torch, {k: got[0][k] for k in ("trainable", "opt")},
                          {k: one[0][k] for k in ("trainable", "opt")})
        cs.log(f"phase 16 (a) plain step {PLAIN} on 1x1: trainables and "
               f"moments bitwise mesh=None {part is None}; loss "
               f"{got[1]['loss']:.6f} vs {one[1]['loss']:.6f}")
        assert part is None and got[1] == one[1], part
        out["plain_bitwise"] = True
    finally:
        dist.destroy_process_group()
    return out


# ------------------------------------------------------- (d) the reference

class RouteLog:
    """Every ``models/moe.py`` ``route`` call's router logits and selected
    experts, in call order (one per MoE layer and forward)."""

    def __init__(self):
        from repro_torch.models import moe as MOE
        self.MOE, self.route0, self.calls = MOE, MOE.route, []

        def route(router, x2, k):
            gates, probs, topw, topi = self.route0(router, x2, k)
            self.calls.append((gates.detach().float().cpu(),
                               topi.detach().cpu()))
            return gates, probs, topw, topi
        MOE.route = route

    def close(self):
        self.MOE.route = self.route0


def routing_rule(got, want, k):
    """Phase 12's rule on one forward: per token, the first layer whose
    selected set differs must sit on a reference gap g_(k) - g_(k+1) of at
    most ROUTE_GAP_FACTOR x the token's max |d router logit| there."""
    assert len(got) == len(want)
    first, checked = {}, []
    for layer, ((ga, ta), (gb, tb)) in enumerate(zip(got, want)):
        diff = (ta.sort(-1).values != tb.sort(-1).values).any(-1)
        for tok in diff.nonzero().flatten().tolist():
            if tok in first:
                continue
            first[tok] = layer
            top = gb[tok].sort(descending=True).values
            gap = (top[k - 1] - top[k]).item()
            dg = (ga[tok] - gb[tok]).abs().max().item()
            checked.append(dict(token=tok, layer=layer, gap=gap,
                                max_d_gate=dg,
                                ok=gap <= ROUTE_GAP_FACTOR * dg))
    return dict(tokens=int(got[0][1].shape[0]), flipped=len(first),
                flips=checked, ok=all(c["ok"] for c in checked))


def moe_batch(cfg):
    from repro_torch.data import MarkovLM
    return MarkovLM(cfg.vocab_size, 8, seed=2).sample(
        0, MOE_BATCH["B"], MOE_BATCH["T"])


def moe_forward(torch, cfg, params, dev):
    """One bare forward of the MoE batch under a route log: (hidden on
    the host, the log's calls)."""
    from repro_torch.models import model as MDL

    toks = torch.as_tensor(moe_batch(cfg)["tokens"]).to(dev)
    log = RouteLog()
    try:
        with torch.no_grad():
            hidden, _, _ = MDL.forward(params, toks, cfg)
    finally:
        log.close()
    return hidden.float().cpu(), log.calls


def moe_reference(torch, dev, cfg, cfg2, path):
    """(d)'s ``mesh=None`` runs in this process (the bf16 forward at
    ``cfg``, the float32 train step at ``cfg2``), saved to ``path``."""
    from repro_torch.models import init_lm
    from repro_torch.train import steps as ST

    t = time.perf_counter()
    params = init_lm(cfg, seed=0, device=dev)
    experts = sum(params["blocks"]["moe"][k].numel()
                  * params["blocks"]["moe"][k].element_size()
                  for k in ("ew_g", "ew_u", "ew_d"))
    hidden, calls = moe_forward(torch, cfg, params, dev)
    del params
    state = ST.init_train_state(cfg2, "xpeft", seed=0, device=dev)
    _, met, grads = plain_step(torch, cfg2, state, None, dev, **MOE_BATCH)
    del state
    torch.save(dict(hidden=hidden, calls=calls, expert_bytes=experts,
                    train=met, grads={k: v.cpu() for k, v in grads.items()}),
               path)
    if dev == "cuda":
        torch.cuda.empty_cache()
    cs.log(f"phase 16 (d) reference: {cfg.name} {cfg.num_layers} layers "
           f"bf16 forward, {cfg2.num_layers} layers float32 train step, "
           f"{time.perf_counter() - t:.1f}s; experts {experts} B on one "
           "device")


# ------------------------------------------------------------ the workers

def drill(cfg, dev, mesh, ckpt_dir=None, store_path=None):
    """JAX's elastic drill on ``mesh`` (T=32): the onboarding trainer."""
    from repro_torch.data import MarkovLM
    from repro_torch.train import GraduationPolicy
    from repro_torch.train.onboarding import build_onboarding_run

    D = DRILL
    policy = GraduationPolicy(min_steps=D["min_steps"],
                              max_steps=D["max_steps"], target_acc=2.0)
    trainer, _ = build_onboarding_run(
        cfg, MarkovLM(cfg.vocab_size, D["profiles"], seed=1),
        range(D["profiles"]), slots=D["slots"], per_slot=D["per_slot"],
        seq_len=D["seq"], policy=policy, lr=D["lr"], seed=0, device=dev,
        mesh=mesh, ckpt_dir=ckpt_dir, ckpt_every=D["ckpt_every"],
        store_path=store_path, log_every=2)
    return trainer


def step_numbers(torch, fn, dev, steps=3, warm=True):
    """Host ms (host clock, synchronised) and device ms and kernels
    (torch.profiler, the card only) a call of ``fn``, and the bytes this
    rank received in gathers a call, after one warm-up call (``warm``)."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.distributed import sharding as SH

    if warm:
        fn()
    sync(torch, dev)
    b0 = SH.all_gather.bytes
    acts = [ProfilerActivity.CUDA] if dev == "cuda" else \
        [ProfilerActivity.CPU]
    with profile(activities=acts) as prof:
        t = time.perf_counter()
        for _ in range(steps):
            fn()
        sync(torch, dev)
        host = (time.perf_counter() - t) / steps * 1e3
    rows = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    dev_ms = sum(e.self_device_time_total for e in rows) / 1e3 / steps
    if dev == "cuda":
        assert dev_ms > 0, "the profiler traced no kernel"
    return dict(host_ms=host, device_ms=dev_ms,
                kernels=sum(e.count for e in rows) / steps,
                gathered_bytes=(SH.all_gather.bytes - b0) / steps)


def tree_bytes(tree, local=True):
    from repro_torch.distributed import sharding as SH
    from repro_torch.utils.tree import tree_leaves
    return sum((SH.local(v).numel() if local else v.numel())
               * v.element_size() for v in tree_leaves(tree))


class OpLog:
    """A dispatch mode keeping every floating-point aten op's output (a
    copy) in call order."""

    def __init__(self, torch):
        from torch.utils._python_dispatch import TorchDispatchMode

        outs = self.outs = []

        class Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                out = func(*args, **(kwargs or {}))
                if isinstance(out, torch.Tensor) and out.is_floating_point():
                    outs.append((str(func), out.detach().clone()))
                return out
        self.mode = Mode()


def _align(a, b, ranks):
    """``b`` cut to ``a``'s rows where it is ``a`` with one dim ``ranks``
    times longer (a 2x1 rank's first share of it), ``b`` itself where the
    shapes agree, else None."""
    if a.shape == b.shape:
        return b
    if a.dim() != b.dim():
        return None
    dims = [d for d in range(a.dim()) if a.shape[d] != b.shape[d]]
    if len(dims) != 1 or b.shape[dims[0]] != ranks * a.shape[dims[0]]:
        return None
    return b.narrow(dims[0], 0, a.shape[dims[0]])


def first_op_apart(torch, cfg, frozen, dev, S, m, T, ranks=2):
    """The gang step's forward and backward on a 2x1 rank's slots (S /
    ranks of them: its GEMMs at S / ranks x m x T rows) against the whole
    roster's (S slots) on one device, aten op by op: the first op whose
    output (this rank's share of it) parts, with its max |d| and whether
    the forward or the backward ran it, or None."""
    from repro_torch.train.roster import Roster, init_roster_state
    from repro_torch.train.steps import _draws, gang_loss_and_grads

    roster = Roster(cfg, 2, S, device=dev)
    rstate = init_roster_state(cfg, S, seed=3, device=dev)
    for slot in range(S):
        roster.admit(rstate, slot, slot)
    batch = gang_batch(cfg, S, m, T)
    noise = _draws(torch.Generator(device=dev).manual_seed(11), cfg, S * m,
                   dev)

    def run(rows):
        loc = {k: rstate[k] for k in ("trainable", "active")}
        loc = {"trainable": {"table": {k: v[:rows] for k, v in
                                       loc["trainable"]["table"].items()}},
               "active": loc["active"][:rows]}
        part = {k: torch.as_tensor(v[:rows]).to(dev)
                for k, v in batch.items()}
        log = OpLog(torch)
        with log.mode:
            gang_loss_and_grads(frozen, loc, part, cfg,
                                tuple(x[:rows * m] for x in noise))
        # the mode's class keeps its list until a cyclic collection: hand
        # the copies out and leave it empty
        outs = list(log.outs)
        log.outs.clear()
        return outs

    small, big = run(S // ranks), run(S)
    for i, ((op, a), (_, b)) in enumerate(zip(small, big)):
        # a scalar sums over every slot the run holds (the total loss)
        b = _align(a, b, ranks) if a.dim() else None
        if b is not None and not bitwise(torch, a.contiguous(),
                                         b.contiguous()):
            return dict(index=i, ops=len(small), op=op, shape=list(a.shape),
                        max_abs=(a.double() - b.double()).abs().max()
                        .item())
    return None


def gang_vs_one(torch, cfg, dev, rank, mesh, label, hold):
    """One drill-shaped gang step on ``mesh`` against one device (rank 0
    steps a one-device roster on the same rows and draws): whether the
    rosters are bitwise equal, the first leaf apart, the step's loss and
    gradient distances; phase 7's bounds asserted where ``hold``."""
    from repro_torch.models import init_lm

    shape = (DRILL["slots"], DRILL["per_slot"], DRILL["seq"])
    frozen = init_lm(cfg, seed=0, device=dev)
    got, met = gang_step(torch, cfg, frozen, mesh, dev, *shape)
    got = _whole(got)   # every rank gathers
    out = {}
    if rank == 0:
        one, ome = gang_step(torch, cfg, frozen, None, dev, *shape)
        part = first_part(torch, got, one)
        out = dict(bitwise=part is None, leaf_apart=part,
                   metrics=dict(mesh=met, one=ome))
        # the clipped gradients, read from the first moment (m = (1 - b1)
        # g); the k-hot selection: the same noise on the same logits
        gg = {k: v / 0.1 for k, v in got["opt"]["m"]["table"].items()}
        wg = {k: v / 0.1 for k, v in one["opt"]["m"]["table"].items()}
        out["loss_abs_err"] = abs(met["loss"] - ome["loss"])
        out["grad_rel_l2"] = {k: cs.rel_l2(gg[k].float().cpu(),
                                           wg[k].float().cpu()) for k in wg}
        if part is not None:
            out["op_apart"] = first_op_apart(torch, cfg, frozen, dev,
                                             *shape)
        cs.log(f"phase 16 (b) {label}: one gang step at 2x1 (gloo, "
               f"{shape[0]} slots x {shape[1]} x T={shape[2]}): roster "
               f"bitwise one device {part is None}"
               + ("" if part is None else
                  f"; first leaf apart {part[0]} max|d| {part[1]:.3e}; "
                  f"first aten op apart (forward, then backward) "
                  f"{out['op_apart']}")
               + f"; loss |d| {out['loss_abs_err']:.3e}, grad relative L2 "
               + ", ".join(f"{k} {v:.3e}"
                           for k, v in out["grad_rel_l2"].items()))
        if hold:
            step_bounds(torch, met, ome, gg, wg,
                        f"{label} 2x1 gang step vs one device")
    return out


def part_b(torch, cfg, dev, rank, mesh):
    """(b) on the 2x1 mesh: one gang step against one device (bf16, and
    in float32, where phase 7 holds its bounds), the unfailed drill and
    the failed one."""
    out = {"gang": gang_vs_one(torch, cfg, dev, rank, mesh, "bf16", False)}
    if rank == 0:
        out["gang_bitwise"] = out["gang"]["bitwise"]
    out["gang_f32"] = gang_vs_one(torch, cfg.with_(dtype="float32"), dev,
                                  rank, mesh, "float32", True)
    gc.collect()
    if dev == "cuda":
        torch.cuda.empty_cache()
    t = time.perf_counter()
    ref = drill(cfg, dev, mesh)
    ref.run_until_drained(max_steps=200)
    if rank == 0:
        ref.scheduler.store.save(os.path.join(OUT, "unfailed.npz"))
    out["unfailed_steps"] = ref.step
    out["unfailed_graduated"] = len(ref.scheduler.graduated)
    out["unfailed_s"] = time.perf_counter() - t
    del ref
    ckpt = os.path.join(OUT, "ckpt")
    t1 = drill(cfg, dev, mesh, ckpt_dir=ckpt,
               store_path=os.path.join(ckpt, "store.npz"))
    t1.run(DRILL["stop"])
    out["failed_at"] = t1.step
    out["latest"] = t1.mgr.latest_step()
    assert out["latest"] == DRILL["ckpt_every"], out
    del t1
    return out


def _whole(tree):
    from repro_torch.distributed import sharding as SH
    from repro_torch.utils.tree import tree_map
    return tree_map(SH.whole, tree)


def part_c(torch, cfg, dev, rank, mesh):
    """(c) on the 1x2 mesh: the plain step with the frozen tree as
    "model" blocks against one device. Peaks are each process's whole
    allocation (its state and the step)."""
    from repro_torch.train import steps as ST

    out = {}
    state = ST.init_train_state(cfg, "xpeft", seed=0, device=dev)
    one_bytes = tree_bytes(state)
    if rank == 0:
        if dev == "cuda":
            torch.cuda.reset_peak_memory_stats()
        new, met, grads = plain_step(torch, cfg, state, None, dev, **PLAIN)
        one = ({k: new[k] for k in ("trainable", "opt")}, met, grads)
        del new
        if dev == "cuda":
            out["one_peak_bytes"] = torch.cuda.max_memory_allocated()
    sstate = ST.shard_train_state(state, mesh)
    del state
    if dev == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    got = plain_step(torch, cfg, sstate, mesh, dev, **PLAIN)
    if dev == "cuda":
        out["peak_bytes"] = torch.cuda.max_memory_allocated()
    out["resident_bytes"] = tree_bytes(sstate)
    out["one_device_bytes"] = one_bytes
    assert out["resident_bytes"] < one_bytes, out
    if rank == 0:
        part = first_part(torch, {k: got[0][k] for k in ("trainable", "opt")},
                          one[0])
        out["bitwise"] = part is None
        out["bounds"] = step_bounds(torch, got[1], one[1], got[2], one[2],
                                    "1x2 plain step vs one device")
    gen = torch.Generator(device=dev).manual_seed(1)
    step = ST.make_train_step(cfg, "xpeft", lr=1e-3, mesh=mesh)
    batch = plain_batch(cfg, **PLAIN)
    # the step above warmed every path up
    out.update(step_numbers(torch, lambda: step(sstate, batch, gen), dev,
                            steps=1, warm=False))
    if rank == 0:
        cs.log(f"phase 16 (c) plain step {PLAIN} at 1x2 (gloo), frozen "
               f"tree as model blocks: bitwise one device {out['bitwise']}; "
               f"resident {out['resident_bytes']} B/rank vs "
               f"{one_bytes} on one device; peak "
               f"{out.get('peak_bytes')} B/rank vs "
               f"{out.get('one_peak_bytes')}; a step: host "
               f"{out['host_ms']:.2f} ms, device {out['device_ms']:.3f} ms "
               f"in {out['kernels']:.0f} kernels, "
               f"{out['gathered_bytes'] / 1e6:.2f} MB gathered")
    return out


def part_d(torch, dev, rank, mesh, ref_path, cfg, cfg2):
    """(d) on the 1x2 mesh, expert parallel, against the reference."""
    from repro_torch.distributed import ctx as CTX
    from repro_torch.distributed import sharding as SH
    from repro_torch.models import init_lm
    from repro_torch.train import steps as ST

    ref = torch.load(ref_path, weights_only=False)
    out = {}
    params = init_lm(cfg, seed=0, device=dev)
    params = SH.place(params, SH.param_specs(params, mesh, fsdp=False),
                      mesh)
    moe = params["blocks"]["moe"]
    out["expert_bytes"] = tree_bytes({k: moe[k] for k in
                                      ("ew_g", "ew_u", "ew_d")})
    assert 2 * out["expert_bytes"] == ref["expert_bytes"], out
    with CTX.mesh_context(mesh):
        hidden, calls = moe_forward(torch, cfg, params, dev)
    del params, moe
    if dev == "cuda":
        torch.cuda.empty_cache()
    rule = routing_rule(calls, ref["calls"], cfg.top_k)
    d = (hidden.double() - ref["hidden"].double())
    out["forward"] = dict(rule, hidden_max_abs=d.abs().max().item(),
                          hidden_rel_l2=(d.norm() / ref["hidden"].double()
                                         .norm()).item())
    assert rule["ok"], rule["flips"]
    assert torch.isfinite(hidden).all()
    state = ST.shard_train_state(
        ST.init_train_state(cfg2, "xpeft", seed=0, device=dev), mesh)
    _, met, grads = plain_step(torch, cfg2, state, mesh, dev, **MOE_BATCH)
    out["train"] = step_bounds(torch, met, ref["train"], grads,
                               ref["grads"], "1x2 expert-parallel MoE "
                               "step vs one device", say=rank == 0)
    del state
    if rank == 0:
        f = out["forward"]
        cs.log(f"phase 16 (d) {cfg.name} at 1x2 (gloo), expert "
               f"parallel: experts {out['expert_bytes']} B/rank vs "
               f"{ref['expert_bytes']} on one device; forward of "
               f"{f['tokens']} tokens x {cfg.num_layers} layers: "
               f"{f['flipped']} tokens' routing parts (rule holds), hidden max|d| "
               f"{f['hidden_max_abs']:.3e}, relative L2 "
               f"{f['hidden_rel_l2']:.3e}")
    return out


def worker(rank, port, dev, qcfg, ref_path, mcfg, mcfg2, out_path):
    """One rank of the spawn: gloo over 2 processes, (b), (c), (d)."""
    import torch
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_mesh

    from repro_torch.kernels import _build

    if dev == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.cuda.set_device(0)
        _build.load_library()
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=2)
    if dev == "cuda":
        mesh_phase.gloo_on_cuda(torch, dist, rank)
    out = {}
    t = time.perf_counter()
    out["b"] = part_b(torch, qcfg, dev, rank,
                      make_mesh((2, 1), ("data", "model"), dev))
    out["b_s"] = time.perf_counter() - t
    mesh12 = make_mesh((1, 2), ("data", "model"), dev)
    t = time.perf_counter()
    out["c"] = part_c(torch, qcfg, dev, rank, mesh12)
    out["c_s"] = time.perf_counter() - t
    t = time.perf_counter()
    out["d"] = part_d(torch, dev, rank, mesh12, ref_path, mcfg, mcfg2)
    out["d_s"] = time.perf_counter() - t
    dist.barrier()
    dist.destroy_process_group()
    if rank == 0:
        with open(out_path, "w") as f:
            json.dump(out, f, default=str)


def spawn(torch, dev, qcfg, ref_path, mcfg, mcfg2):
    import torch.multiprocessing as mp

    path = os.path.join(OUT, "spawn.json")
    ctx = mp.get_context("spawn")
    port = mesh_phase.free_port()
    procs = [ctx.Process(target=worker, args=(r, port, dev, qcfg, ref_path,
                                              mcfg, mcfg2, path))
             for r in range(2)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + SPAWN_TIMEOUT_S
    try:
        for p in procs:
            p.join(max(deadline - time.monotonic(), 1))
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(10)
    codes = [p.exitcode for p in procs]
    assert codes == [0, 0], f"phase 16 ranks exited {codes}"
    with open(path) as f:
        return json.load(f)


# ------------------------------------------------------ (b)'s new world

def part_resume(torch, cfg, dev, b):
    """(b) in a new world of one process: resume on the surviving mesh,
    run to the end, compare the store, serve it on the 1x1 mesh."""
    import torch.distributed as dist

    from repro_torch.core.profiles import ProfileStore
    from repro_torch.distributed.fault import surviving_mesh
    from repro_torch.serve import Request, ServeEngine

    if dev == "cuda":
        torch.cuda.set_device(0)
    dist.init_process_group("nccl" if dev == "cuda" else "gloo",
                            init_method="tcp://127.0.0.1:"
                                        f"{mesh_phase.free_port()}",
                            rank=0, world_size=1)
    out = {}
    try:
        mesh = surviving_mesh(("data", "model"), (2, 1), "data", 1, dev)
        ckpt = os.path.join(OUT, "ckpt")
        t2 = drill(cfg, dev, mesh, ckpt_dir=ckpt,
                   store_path=os.path.join(ckpt, "store.npz"))
        assert t2.try_resume()
        out["resumed_at"] = t2.step
        t2.run_until_drained(max_steps=200)
        store = t2.scheduler.store
        ref = ProfileStore.load(os.path.join(OUT, "unfailed.npz"))
        same = store.profile_ids() == ref.profile_ids() and all(
            sorted(store._rec[p]) == sorted(ref._rec[p]) and all(
                store._rec[p][k].tobytes() == ref._rec[p][k].tobytes()
                for k in ref._rec[p]) for p in ref.profile_ids())
        out["store_equal_unfailed"] = same
        out["graduated"] = store.profile_ids()
        cs.log(f"phase 16 (b) resumed at step {out['resumed_at']} in a new "
               f"world of one process on surviving_mesh (2,1) -> "
               f"{dict(zip(mesh.mesh_dim_names, mesh.shape))}: store "
               f"byte-equal to the unfailed 2x1 run's {same}")
        if b["gang_bitwise"]:
            assert same, "the stores part where the gang step is bitwise"
        assert len(out["graduated"]) == DRILL["profiles"], out
        counters = cs.kernel_counters()
        frozen = t2.state["frozen"]
        runs = {}
        for name, mm in (("one", None), ("mesh", mesh)):
            eng = ServeEngine(cfg, frozen, store, max_slots=4, max_seq=128,
                              sync_every=8, mesh=mm)
            reqs = cs.make_requests(Request, cfg.vocab_size)
            for fn in counters.values():
                fn.launches = 0
            eng.run_until_drained(list(reqs))
            sync(torch, dev)
            runs[name] = ({r.uid: [int(x) for x in r.generated]
                           for r in reqs},
                          {k: fn.launches for k, fn in counters.items()})
        out["served_bitwise"] = runs["mesh"][0] == runs["one"][0]
        out["launches"] = runs["mesh"][1]
        cs.log(f"phase 16 (b) the resumed store served on the 1x1 mesh: "
               f"tokens bitwise mesh=None {out['served_bitwise']}; "
               f"launches {out['launches']}")
        assert out["served_bitwise"]
        if dev == "cuda":   # the wrappers count only on the card
            for k in ("mask_aggregate_batched", "fused_adapter_batched"):
                assert out["launches"][k] > 0, (k, out["launches"])
    finally:
        dist.destroy_process_group()
    return out


def phase_mesh_train(torch, qcfg=None, mcfg=None, mcfg2=None, dev="cuda"):
    """The phase; ``qcfg`` (qwen1.5-0.5b), ``mcfg`` (the MoE forward's)
    and ``mcfg2`` (the MoE train step's) default to the sizes above."""
    import shutil

    t0 = time.perf_counter()
    qcfg = qcfg or qwen_cfg()
    mcfg = mcfg or moe_cfg(MOE_LAYERS)
    mcfg2 = mcfg2 or moe_cfg(MOE_TRAIN_LAYERS, "float32")
    shutil.rmtree(OUT, ignore_errors=True)
    os.makedirs(OUT)
    a = part_a(torch, qcfg, dev)
    t_a = time.perf_counter() - t0
    ref_path = os.path.join(OUT, "moe_ref.pt")
    moe_reference(torch, dev, mcfg, mcfg2, ref_path)
    t_ref = time.perf_counter() - t0 - t_a
    spawned = spawn(torch, dev, qcfg, ref_path, mcfg, mcfg2)
    t_spawn = time.perf_counter() - t0 - t_a - t_ref
    resumed = part_resume(torch, qcfg, dev, spawned["b"])
    out = dict(a=a, b=dict(spawned["b"], **resumed), c=spawned["c"],
               d=spawned["d"],
               runs={"served_resumed_1x1": resumed["launches"]},
               seconds=time.perf_counter() - t0,
               seconds_parts=dict(a=t_a, d_reference=t_ref, spawn=t_spawn,
                                  b=spawned["b_s"], c=spawned["c_s"],
                                  d=spawned["d_s"]))
    shutil.rmtree(OUT, ignore_errors=True)
    cs.log(f"phase 16: {out['seconds']:.1f}s ({out['seconds_parts']})")
    return out


def main():
    import torch
    if not torch.cuda.is_available():
        print("mesh_train_phase: needs a CUDA card", file=sys.stderr)
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
    out = phase_mesh_train(torch)
    cs.log(smi)
    cs.log(json.dumps(out, default=str))
    return 0


if __name__ == "__main__":
    sys.exit(main())
