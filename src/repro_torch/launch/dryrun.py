"""Multi-pod dry run: the port of ``repro.launch.dryrun``, one cell per
(arch x shape x mesh) on ``meta`` tensors over a fake process group.

Proves the distribution layout is coherent without a card: abstract state
on the ``meta`` device (shapes and dtypes, nothing allocated, nothing
drawn), then two readings per cell.

1. ``memory.state_bytes_per_dev_analytic``: JAX's number exactly. The
   params (or the xpeft train state), plus the cache for a serving cell,
   laid out by ``param_specs`` (with the variant's ``fsdp``,
   ``overrides`` and ``logical_map``) and ``cache_specs`` on the
   production mesh's ``{axis: size}`` ((16, 16) or (2, 16, 16)), through
   ``sharded_bytes_per_device``.
2. The run. A ``fake`` process group of 256 or 512 ranks in this one
   process (``dist.init_process_group("fake")``: every collective
   returns at once and moves nothing) and a ``DeviceMesh`` over it. Rank
   0's blocks are laid out on meta as the port really holds them:
   serving under the engine's ``serving_param_specs``, training under
   ``shard_train_state``; the cache whole on rank 0 for its rows, as the
   engine keeps it. The prefill, decode or train step then runs under
   ``ctx.mesh_context`` at rank 0's rows of the global batch (the whole
   batch where it does not divide over pod x data, as JAX's token spec
   and the train step's batch split define it), counted by
   ``analysis.op_cost.OpCounter``. The process group is destroyed after
   every cell.

The record keeps JAX's keys where they have a counterpart:

- ``trace_s`` in place of ``compile_s``: the seconds to build the cell's
  state and run its step on meta. ``xla_cost_flops_unscaled`` (XLA's own
  FLOP count, which visits a loop body once) has none and is dropped.
- ``flops_per_dev``, ``bytes_per_dev``, ``collective_bytes_per_dev`` and
  ``collectives``: ``op_cost``'s counts of rank 0's step, the
  counterpart of JAX's ``hlo_cost.analyze`` of the compiled module. On
  meta every kernel wrapper takes its plain version, so these are the
  plain versions' ops, not the CUDA kernels'; bytes are eager mode's
  unfused traffic.
- ``memory``: ``argument_bytes`` (the step's arguments as rank 0 holds
  them), ``output_bytes`` (what the step returns) and ``alias_bytes``
  (the outputs that share an argument's storage: the serving cache
  written in place, the train state's frozen tree handed back) mean
  what JAX's do; ``temp_bytes`` has no counterpart and is None. Added:
  ``resident_bytes_per_dev`` (rank 0's params, bank and cache or train
  state, as held) and ``peak_bytes_per_dev`` (the most bytes of storages
  the step allocated alive at once, above the resident ones).
- ``roofline``: ``analysis.roofline_terms`` on the H100's constants;
  ``model_flops_per_dev``: ``analysis.model_flops(..., "xpeft")``;
  ``useful_flops_ratio`` as JAX's. Added: ``dot_flops_per_dev``, the
  products' share of ``flops_per_dev`` (eager mode's elementwise ops count
  a FLOP per element, as ``hlo_cost.py``'s model does, and are many).
- ``notes``: where the variant's levers do not reach the run. The port's
  activations carry no GSPMD hint (``ctx.hint`` returns its tensor), so
  ``act_rules`` change nothing that runs; the spec levers (``fsdp``,
  ``overrides``, ``logical_map``) change the analytic bytes, while the run
  keeps the port's one layout.

The port's layout gathers each layer's model-sharded weights whole and
runs it on every rank, so every rank of one data shard repeats the same
compute: at 16 x 16 the per-device FLOPs come out ~16x JAX's split and
``useful_flops_ratio`` near 1/16 (ROADMAP queue 1, item 11).

Usage (any host, no card):
  python -m repro_torch.launch.dryrun --arch all --shape all --mesh both
  python -m repro_torch.launch.dryrun --arch dbrx-132b --shape train_4k \\
      --mesh single --variant remat_dots
"""
from __future__ import annotations

import argparse
import contextlib
import functools
import json
import math
import os
import time
import traceback

import torch
import torch.distributed as dist
from torch.utils._pytree import tree_leaves

from repro_torch.analysis import model_flops, roofline_terms
from repro_torch.analysis.op_cost import OpCounter, analyze
from repro_torch.configs import (ASSIGNED_ARCHS, get_config, get_shape,
                                 shapes_for)
from repro_torch.distributed import ctx as CTX
from repro_torch.distributed import sharding as SH
from repro_torch.models import model as MDL
from repro_torch.serve.engine import serving_param_specs
from repro_torch.serve.steps import (greedy_next, make_decode_step,
                                     make_prefill_step)
from repro_torch.train.steps import (init_train_state, make_train_step,
                                     shard_train_state)

META = torch.device("meta")
# the products among the counted ops (``dot_flops_per_dev``)
DOT_OPS = ("aten.mm", "aten.addmm", "aten.bmm", "aten.baddbmm")

# ----------------------------------------------------------------------------
# Variants (JAX's hillclimb levers, baseline first)
# ----------------------------------------------------------------------------
VARIANTS = {
    "baseline": {},
    "remat_dots": {"cfg": {"remat": "dots"}},
    "remat_none": {"cfg": {"remat": "none"}},
    "no_fsdp": {"fsdp": False},
    "precomputed_adapters": {"precomputed": True},
    "sparse_k_agg": {"sparse_agg": True},
    "soft_masks": {"xpeft": {"mask_type": "soft"}},
    "bank_n_shard": {"overrides": {"bank_a": ("tp_n", None, None),
                                   "bank_b": ("tp_n", None, None)},
                     "logical_map": {"tp_n": "model"}},
    "seq_sp": {"seq_sp": True},
    "cp_qseq": {"act_rules": {"q_seq": "model", "kv_seq": None}},
    "cp_qseq_remat_dots": {"act_rules": {"q_seq": "model", "kv_seq": None},
                           "cfg": {"remat": "dots"}},
    "kv_f8": {"cfg": {"cache_dtype": "float8_e4m3fn"}},
    "precomputed_kv_f8": {"precomputed": True,
                          "cfg": {"cache_dtype": "float8_e4m3fn"}},
    "no_tp": {
        "logical_map": {"vocab": None, "heads": None, "kv_heads": None,
                        "mlp": None, "expert": None, "tp_d": None,
                        "mlp_fsdp": "data"},
        "act_rules": {"batch": ("pod", "data", "model"), "heads": None,
                      "kv_heads": None, "kv_seq": None, "mlp": None,
                      "vocab": None, "expert": None},
    },
    "no_tp_remat_dots": {
        "cfg": {"remat": "dots"},
        "logical_map": {"vocab": None, "heads": None, "kv_heads": None,
                        "mlp": None, "expert": None, "tp_d": None,
                        "mlp_fsdp": "data"},
        "act_rules": {"batch": ("pod", "data", "model"), "heads": None,
                      "kv_heads": None, "kv_seq": None, "mlp": None,
                      "vocab": None, "expert": None},
    },
}


def cell_config(arch: str, variant: str = "baseline", xpeft_n: int = 256):
    """The cell's config, as JAX's ``lower_cell`` builds it."""
    vspec = VARIANTS[variant]
    cfg = get_config(arch)
    if cfg.name != "bert-base-xpeft":
        cfg = cfg.with_xpeft(num_adapters=xpeft_n, bottleneck=64)
    if "cfg" in vspec:
        cfg = cfg.with_(**vspec["cfg"])
    if "xpeft" in vspec:
        cfg = cfg.with_xpeft(**vspec["xpeft"])
    return cfg


def production_axes(multi_pod: bool) -> dict:
    """``launch/mesh.py``'s production mesh as ``{axis: size}``."""
    if multi_pod:
        return {"pod": 2, "data": 16, "model": 16}
    return {"data": 16, "model": 16}


def _sh_kw(vspec) -> dict:
    return {k: vspec[k] for k in ("overrides", "logical_map") if k in vspec}


def cache_len(cfg, shape) -> int:
    """The cache's positions: the sequence plus a frontend's prefix rows."""
    return shape.seq_len + (cfg.num_prefix_tokens or 0)


@functools.lru_cache(maxsize=8)
def abstract_state(cfg, kind: str) -> dict:
    """The meta tree of a cell's state: the xpeft train state (``kind``
    "train") or the params. Meta tensors hold no data: one tree serves
    every shape and mesh of a config."""
    if kind == "train":
        return init_train_state(cfg, "xpeft", device=META)
    return MDL.init_lm(cfg, device=META)


def state_bytes_per_dev_analytic(cfg, shape, sizes, *, fsdp=True,
                                 overrides=None, logical_map=None) -> int:
    """JAX's ``state_bytes``: the xpeft train state (a train cell) or the
    params plus the cache of the global batch (a serving cell), each leaf
    laid out by JAX's spec functions on ``sizes``."""
    kw = dict(fsdp=fsdp, overrides=overrides, logical_map=logical_map)
    if shape.kind == "train":
        state = abstract_state(cfg, "train")
        return SH.sharded_bytes_per_device(
            state, SH.param_specs(state, sizes, **kw), sizes)
    params = abstract_state(cfg, "serve")
    total = SH.sharded_bytes_per_device(
        params, SH.param_specs(params, sizes, **kw), sizes)
    B = shape.global_batch
    cache = MDL.init_cache(cfg, B, cache_len(cfg, shape), device=META)
    return total + SH.sharded_bytes_per_device(
        cache, SH.cache_specs(cache, sizes, cfg, B), sizes)


def rows_per_rank(batch: int, sizes) -> int:
    """Rank 0's rows of a global batch: its block over pod x data where
    the batch divides, else the whole batch."""
    n = math.prod(sizes[a] for a in ("pod", "data") if a in sizes)
    return batch // n if batch % n == 0 and batch >= n else batch


# ----------------------------------------------------------------------------
# The fake world
# ----------------------------------------------------------------------------

@contextlib.contextmanager
def fake_mesh(sizes: dict):
    """A ``DeviceMesh`` of ``sizes`` over a ``fake`` process group of as
    many ranks, this process rank 0; the group destroyed on exit."""
    # an internal module of torch: imported here only, never at import
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("the dry run needs a process without a process "
                           "group: it starts a fake one of its own")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=math.prod(sizes.values()))
    try:
        yield init_device_mesh("cpu", tuple(sizes.values()),
                               mesh_dim_names=tuple(sizes))
    finally:
        dist.destroy_process_group()


def _meta(shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device=META)


def _tensors(tree) -> list:
    """A tree's tensors as held (a ``Sharded`` leaf's block)."""
    return [t for t in tree_leaves(tree, is_leaf=lambda x: isinstance(
        x, SH.Sharded)) for t in [SH.local(t)] if torch.is_tensor(t)]


def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in _tensors(tree))


def serve_masks(cfg, rows: int, vspec) -> dict:
    """The step's per-request masks for ``rows`` rows: the on-the-fly mask
    weights (JAX's decode and prefill input), the admission-time Â/B̂
    (``precomputed``) or the k-sparse weights (``sparse_agg``)."""
    xp = cfg.xpeft
    L, N, b, d, k = (cfg.num_layers, xp.num_adapters, xp.bottleneck,
                     cfg.d_model, xp.k)
    ln = {"ln_scale": _meta((rows, L, b)), "ln_bias": _meta((rows, L, b))}
    if vspec.get("precomputed"):
        dt = MDL.torch_dtype(cfg.dtype)
        return dict(ln, a_hat=_meta((rows, L, d, b), dt),
                    b_hat=_meta((rows, L, b, d), dt))
    if vspec.get("sparse_agg"):
        i32 = torch.int32
        return dict(ln, idx_a=_meta((rows, L, k), i32),
                    w_a=_meta((rows, L, k)), idx_b=_meta((rows, L, k), i32),
                    w_b=_meta((rows, L, k)))
    return dict(ln, w_a=_meta((rows, L, N)), w_b=_meta((rows, L, N)))


def _serve_cell(cfg, shape, mesh, vspec):
    """(the step as a thunk, its arguments, the resident trees) of a
    prefill or decode cell on rank 0."""
    params = abstract_state(cfg, "serve")
    params = SH.place(params, serving_param_specs(params, mesh), mesh)
    rows = rows_per_rank(shape.global_batch, SH.axis_sizes(mesh))
    cache = MDL.init_cache(cfg, rows, cache_len(cfg, shape), device=META)
    masks = serve_masks(cfg, rows, vspec)
    if shape.kind == "prefill":
        tokens = _meta((rows, shape.seq_len), torch.int32)
        prefix = None
        if cfg.num_prefix_tokens:
            prefix = _meta((rows, cfg.num_prefix_tokens, cfg.d_model),
                           MDL.torch_dtype(cfg.dtype))
        prefill = make_prefill_step(cfg)

        def run():
            logits, out = prefill(params, tokens, cache, profile_masks=masks,
                                  prefix_embeds=prefix)
            return greedy_next(logits), out
        args = (params, tokens, cache, masks, prefix)
    else:
        tokens = _meta((rows, 1), torch.int32)
        decode = make_decode_step(cfg)
        # the last position: the step attends the whole cache
        pos = cache_len(cfg, shape) - 1

        def run():
            logits, out = decode(params, tokens, cache, pos,
                                 profile_masks=masks)
            return greedy_next(logits), out
        args = (params, tokens, cache, masks)
    return run, args, (params, cache)


def _train_cell(cfg, shape, mesh):
    state = shard_train_state(abstract_state(cfg, "train"), mesh)
    rows = rows_per_rank(shape.global_batch, SH.axis_sizes(mesh))
    T, i32 = shape.seq_len, torch.int32
    batch = {"tokens": _meta((rows, T), i32),
             "labels": _meta((rows,) if cfg.num_labels else (rows, T), i32),
             "profile_ids": _meta((rows,), i32)}
    if cfg.num_prefix_tokens:
        batch["prefix_embeds"] = _meta(
            (rows, cfg.num_prefix_tokens, cfg.d_model),
            MDL.torch_dtype(cfg.dtype))
    # the step's Gumbel draws, whole: each rank takes its rows' noise
    noise = tuple(_meta((shape.global_batch, cfg.num_layers,
                         cfg.xpeft.num_adapters)) for _ in range(2))
    step = make_train_step(cfg, "xpeft", lr=1e-5, mesh=mesh)

    def run():
        return step(state, batch, noise)
    return run, (state, batch, noise), state


def _storages(tree) -> set:
    return {t.untyped_storage()._cdata for t in _tensors(tree)}


def run_cell(cfg, shape, sizes, *, vspec=None) -> dict:
    """Rank 0's step of one cell on meta over a fake world of ``sizes``:
    {"counter", "resident_bytes", "argument_bytes", "output_bytes",
    "alias_bytes", "rows"}."""
    vspec = vspec or {}
    with fake_mesh(sizes) as mesh:
        if shape.kind == "train":
            run, args, resident = _train_cell(cfg, shape, mesh)
        else:
            run, args, resident = _serve_cell(cfg, shape, mesh, vspec)
        counter = OpCounter(memory=True)
        with CTX.mesh_context(mesh), counter:
            out = run()
        aliased = _storages(args)
        alias_bytes = sum(t.numel() * t.element_size() for t in _tensors(out)
                          if t.untyped_storage()._cdata in aliased)
        return {"counter": counter, "resident_bytes": _nbytes(resident),
                "argument_bytes": _nbytes(args), "output_bytes": _nbytes(out),
                "alias_bytes": alias_bytes,
                "rows": rows_per_rank(shape.global_batch, sizes)}


# ----------------------------------------------------------------------------
# Cells
# ----------------------------------------------------------------------------

def _notes(vspec, shape) -> list:
    notes = []
    if shape.global_batch == 1:
        notes.append("B=1: JAX hints the sequence over data here; the "
                     "port's rank 0 runs the whole batch")
    if "act_rules" in vspec or vspec.get("seq_sp"):
        notes.append("act_rules change GSPMD activation hints only; the "
                     "port's ctx.hint returns its tensor unchanged, so the "
                     "run equals the baseline's")
    if any(k in vspec for k in ("fsdp", "overrides", "logical_map")):
        notes.append("the spec levers (fsdp, overrides, logical_map) enter "
                     "state_bytes_per_dev_analytic; the run keeps the "
                     "port's layout (serving_param_specs / "
                     "shard_train_state)")
    return notes


def lower_cell(arch: str, shape_name: str, multi_pod: bool,
               variant: str = "baseline", xpeft_n: int = 256) -> dict:
    """One cell's record (JAX's ``lower_cell``'s keys where they have a
    counterpart; module docstring)."""
    vspec = VARIANTS[variant]
    cfg = cell_config(arch, variant, xpeft_n)
    shape = get_shape(shape_name)
    sizes = production_axes(multi_pod)
    ndev = math.prod(sizes.values())
    state_bytes = state_bytes_per_dev_analytic(
        cfg, shape, sizes, fsdp=vspec.get("fsdp", True), **_sh_kw(vspec))
    t0 = time.time()
    got = run_cell(cfg, shape, sizes, vspec=vspec)
    trace_s = time.time() - t0
    an = analyze(got["counter"])
    flops, acc_bytes, colls = an["flops"], an["bytes"], an["collectives"]
    mflops = model_flops(cfg, shape, ndev, workload="xpeft")
    return {
        "arch": arch, "shape": shape_name,
        "mesh": "2x16x16" if multi_pod else "16x16",
        "variant": variant, "ok": True,
        "trace_s": round(trace_s, 2),
        "num_devices": ndev,
        "rows_per_dev": got["rows"],
        "ops": got["counter"].ops,
        "memory": {
            "argument_bytes": got["argument_bytes"],
            "output_bytes": got["output_bytes"],
            "temp_bytes": None,
            "alias_bytes": got["alias_bytes"],
            "state_bytes_per_dev_analytic": int(state_bytes),
            "resident_bytes_per_dev": got["resident_bytes"],
            "peak_bytes_per_dev": got["counter"].peak_bytes,
        },
        "flops_per_dev": flops,
        "dot_flops_per_dev": sum(got["counter"].by_op.get(k, [0.0])[0]
                                 for k in DOT_OPS),
        "bytes_per_dev": acc_bytes,
        "collective_bytes_per_dev": colls["total"],
        "collectives": {k: int(v) for k, v in colls.items()},
        "roofline": roofline_terms(flops, acc_bytes, colls["total"]),
        "model_flops_per_dev": mflops,
        "useful_flops_ratio": (mflops / flops) if flops else 0.0,
        "notes": _notes(vspec, shape),
    }


# ----------------------------------------------------------------------------
# CLI
# ----------------------------------------------------------------------------

def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--variant", default="baseline", choices=list(VARIANTS))
    ap.add_argument("--xpeft-n", type=int, default=256)
    ap.add_argument("--out", default="artifacts/dryrun")
    args = ap.parse_args(argv)

    archs = list(ASSIGNED_ARCHS) if args.arch == "all" \
        else args.arch.split(",")
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]
    os.makedirs(args.out, exist_ok=True)

    n_ok = n_fail = 0
    for arch in archs:
        cfg = get_config(arch)
        shapes = [s.name for s in shapes_for(cfg)] \
            if args.shape == "all" else args.shape.split(",")
        for shape_name in shapes:
            for multi in meshes:
                tag = f"{arch}_{shape_name}_{'multi' if multi else 'single'}" \
                      f"_{args.variant}"
                path = os.path.join(args.out, tag + ".json")
                try:
                    rec = lower_cell(arch, shape_name, multi, args.variant,
                                     args.xpeft_n)
                    n_ok += 1
                    print(f"OK   {tag}: trace={rec['trace_s']}s "
                          f"dom={rec['roofline']['dominant']} "
                          f"flops/dev={rec['flops_per_dev']:.3e} "
                          f"useful={rec['useful_flops_ratio']:.4f}")
                except Exception as e:  # noqa: BLE001
                    # a cell's failure is its record; the sweep goes on
                    rec = {"arch": arch, "shape": shape_name,
                           "mesh": "2x16x16" if multi else "16x16",
                           "variant": args.variant, "ok": False,
                           "error": f"{type(e).__name__}: {e}",
                           "traceback": traceback.format_exc()[-4000:]}
                    n_fail += 1
                    print(f"FAIL {tag}: {type(e).__name__}: {e}")
                with open(path, "w") as f:
                    json.dump(rec, f, indent=1)
    print(f"dry-run complete: {n_ok} ok, {n_fail} failed")
    return 0 if n_fail == 0 else 1


if __name__ == "__main__":
    raise SystemExit(main())
