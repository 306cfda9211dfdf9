"""The port's dry run (``launch/dryrun.py``) and op counter
(``analysis/op_cost.py``) against the JAX package's, on the CPU; init on
``meta``; a float8 KV cache.

Stated before any run:
- ``init_lm``, ``init_train_state`` and ``init_cache`` on ``device="meta"``
  give the CPU init's tree paths, shapes and dtypes for every config
  (reduced), and the CPU draws for a fixed seed are the ones before meta
  init existed (their sha256, pinned from the parent tree);
- ``state_bytes_per_dev_analytic`` and ``model_flops_per_dev`` equal JAX's
  integers for every ``ASSIGNED_ARCHS`` x ``shapes_for`` x {16x16,
  2x16x16} cell, for ``baseline`` and the variants that change specs or
  the cache (``no_fsdp``, ``bank_n_shard``, ``no_tp``, ``kv_f8``). JAX's
  side: ``jax.eval_shape`` of its inits and its spec functions on a stub
  mesh, no compile; JAX's variants read from its source (importing its
  dry run would set 512 host devices for this process);
- ``tests/test_dryrun.py``'s two cells run whole through ``python -m
  repro_torch.launch.dryrun`` and pass JAX's assertions;
- exact counts: a tiny qwen decode and prefill step's dot FLOPs equal the
  closed-form sum of 2·M·N·K over its products; on a 2x2 fake mesh the
  all-gather bytes of a decode step equal the result bytes of the
  leaves it gathers, summed from their specs;
- a reduced composed prefill + decode with a float8_e4m3fn cache equals
  JAX's: the cache bytes equal, the logits within rtol = atol = 1e-5.
"""
import ast
import functools
import hashlib
import json
import os
import subprocess
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.analysis import roofline as JRL
from repro.configs import get_config, reduce_for_smoke
from repro.distributed import sharding as JSH
from repro.models import model as JMDL
from repro.serve import steps as JSS
from repro.train import steps as JST
from repro_torch import bridge
from repro_torch.analysis import op_cost as OC
from repro_torch.configs import ASSIGNED_ARCHS, list_archs, shapes_for
from repro_torch.configs import get_config as tget_config
from repro_torch.configs import reduce_for_smoke as treduce
from repro_torch.distributed import sharding as TSH
from repro_torch.launch import dryrun as DR
from repro_torch.models import model as MDL
from repro_torch.serve import steps as TSS
from repro_torch.serve.engine import serving_param_specs
from repro_torch.train import steps as TST
from repro_torch.utils.tree import tree_paths

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# XLA:CPU's backend optimizations off: compiles ~2x faster, rounding far
# below the tolerances here
_FAST = {"xla_backend_optimization_level": 0,
         "xla_llvm_disable_expensive_passes": True}


def _run(f, *args):
    return jax.jit(f).lower(*args).compile(compiler_options=_FAST)(*args)


class _Mesh:
    """JAX's spec functions read only ``mesh.shape``."""

    def __init__(self, shape):
        self.shape = shape


# ----------------------------------------------------------------------------
# init on meta
# ----------------------------------------------------------------------------

def _same_tree(meta, cpu):
    pm, pc = tree_paths(meta), tree_paths(cpu)
    assert sorted(pm) == sorted(pc)
    for k in pc:
        assert pm[k].device.type == "meta", k
        assert (pm[k].shape, pm[k].dtype) == (pc[k].shape, pc[k].dtype), k


def _digest(tree) -> str:
    h = hashlib.sha256()
    for k, v in sorted(tree_paths(tree).items()):
        h.update(k.encode())
        h.update(v.reshape(-1).contiguous().view(torch.uint8).numpy()
                 .tobytes())
    return h.hexdigest()[:16]


# sha256 of the CPU init at seed 3, taken on the tree before meta init
DRAWS = {("qwen1.5-0.5b", "xpeft"): "1e434a5a565691b7",
         ("qwen1.5-0.5b", "adapter"): "0237e9d4c50234ee",
         ("bert-base-xpeft", "xpeft"): "5971579072cc4afd",
         ("bert-base-xpeft", "adapter"): "b09e8e6cd93de967",
         ("bert-base-xpeft", "head_only"): "745faf3b8cc2884b",
         ("zamba2-1.2b", "xpeft"): "68090e6e2382fdb2",
         ("zamba2-1.2b", "adapter"): "9a529bcc263e55e2"}


def test_init_on_meta_matches_cpu_and_cpu_draws_unchanged():
    for arch in list_archs():
        cfg = treduce(tget_config(arch))
        _same_tree(MDL.init_lm(cfg, device="meta"),
                   MDL.init_lm(cfg, device="cpu"))
        for mode in ("xpeft", "adapter", "full"):
            _same_tree(TST.init_train_state(cfg, mode, device="meta"),
                       TST.init_train_state(cfg, mode, device="cpu"))
        _same_tree(MDL.init_cache(cfg, 3, 16, device="meta"),
                   MDL.init_cache(cfg, 3, 16, device="cpu"))
    for (arch, mode), want in DRAWS.items():
        cfg = treduce(tget_config(arch))
        assert _digest(TST.init_train_state(cfg, mode, seed=3,
                                            device="cpu")) == want


# ----------------------------------------------------------------------------
# analytic bytes and model FLOPs against JAX's dry run
# ----------------------------------------------------------------------------

def _jax_variants():
    """JAX's ``VARIANTS``, read from its source."""
    path = os.path.join(ROOT, "src", "repro", "launch", "dryrun.py")
    tree = ast.parse(open(path).read())
    for node in tree.body:
        if isinstance(node, ast.Assign) \
                and getattr(node.targets[0], "id", None) == "VARIANTS":
            return ast.literal_eval(node.value)
    raise AssertionError("no VARIANTS in JAX's dry run")


JV = _jax_variants()
SPEC_VARIANTS = ("baseline", "no_fsdp", "bank_n_shard", "no_tp", "kv_f8")


def test_variants_equal_jax():
    assert DR.VARIANTS == JV


@functools.lru_cache(maxsize=None)
def _jax_abstract(cfg, kind):
    key = jax.random.key(0)
    if kind == "train":
        return jax.eval_shape(
            lambda k: JST.init_train_state(k, cfg, "xpeft"), key)
    return jax.eval_shape(lambda k: JMDL.init_lm(k, cfg), key)


def _jax_state_bytes(arch, shape, multi, variant):
    """JAX's ``lower_cell``'s ``state_bytes``, with no compile."""
    vspec = JV[variant]
    cfg = get_config(arch).with_xpeft(num_adapters=256, bottleneck=64)
    if "cfg" in vspec:
        cfg = cfg.with_(**vspec["cfg"])
    mesh = _Mesh(DR.production_axes(multi))
    kw = dict(fsdp=vspec.get("fsdp", True),
              **{k: vspec[k] for k in ("overrides", "logical_map")
                 if k in vspec})
    if shape.kind == "train":
        state = _jax_abstract(cfg, "train")
        return JSH.sharded_bytes_per_device(
            state, JSH.param_specs(state, mesh, **kw), mesh), cfg
    params = _jax_abstract(cfg, "serve")
    n = JSH.sharded_bytes_per_device(
        params, JSH.param_specs(params, mesh, **kw), mesh)
    B = shape.global_batch
    cache = jax.eval_shape(lambda: JMDL.init_cache(
        cfg, B, shape.seq_len + (cfg.num_prefix_tokens or 0)))
    return n + JSH.sharded_bytes_per_device(
        cache, JSH.cache_specs(cache, mesh, cfg, B), mesh), cfg


@pytest.mark.parametrize("variant", SPEC_VARIANTS)
def test_state_bytes_and_model_flops_equal_jax(variant):
    vspec = DR.VARIANTS[variant]
    n = 0
    for arch in ASSIGNED_ARCHS:
        cfg = DR.cell_config(arch, variant)
        for shape in shapes_for(tget_config(arch)):
            for multi in (False, True):
                want, jcfg = _jax_state_bytes(arch, shape, multi, variant)
                sizes = DR.production_axes(multi)
                got = DR.state_bytes_per_dev_analytic(
                    cfg, shape, sizes, fsdp=vspec.get("fsdp", True),
                    **DR._sh_kw(vspec))
                assert got == want, (arch, shape.name, multi)
                ndev = 512 if multi else 256
                assert DR.model_flops(cfg, shape, ndev, workload="xpeft") \
                    == JRL.model_flops(jcfg, shape, ndev, workload="xpeft")
                n += 1
    assert n == 2 * sum(len(shapes_for(tget_config(a)))
                        for a in ASSIGNED_ARCHS)


# ----------------------------------------------------------------------------
# the CLI on JAX's two cells
# ----------------------------------------------------------------------------

CELLS = (("qwen1.5-0.5b", "decode_32k", "single", 256),
         ("rwkv6-7b", "long_500k", "multi", 512))


@pytest.fixture(scope="module", autouse=True)
def cli_runs(tmp_path_factory):
    """The two CLI cells, started when the module's first test starts so
    that they run beside its other tests; killed at its end if still
    running. (the processes, their output directory)"""
    out = tmp_path_factory.mktemp("dryrun")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    procs = [subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
         "--shape", shape, "--mesh", mesh, "--out", str(out)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env,
        cwd=ROOT) for arch, shape, mesh, _ in CELLS]
    try:
        yield procs, out
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.communicate()


def test_cli_cells_pass_jax_assertions(cli_runs):
    procs, tmp_path = cli_runs
    for p, (arch, shape, mesh, ndev) in zip(procs, CELLS):
        out, err = p.communicate(timeout=300)
        assert p.returncode == 0, (out + err)[-3000:]
        rec = json.load(open(tmp_path / f"{arch}_{shape}_{mesh}_baseline"
                             ".json"))
        assert rec["ok"] and rec["num_devices"] == ndev
        assert rec["flops_per_dev"] > 0
        assert rec["roofline"]["dominant"] in ("compute", "memory",
                                               "collective")
        assert rec["memory"]["state_bytes_per_dev_analytic"] < 16e9
        assert rec["memory"]["peak_bytes_per_dev"] > 0
        assert 0 < rec["useful_flops_ratio"] < 1


# ----------------------------------------------------------------------------
# the op counter's exact counts
# ----------------------------------------------------------------------------

def _tiny():
    cfg = treduce(tget_config("qwen1.5-0.5b"))
    return cfg, MDL.init_lm(cfg, device="cpu")


def _masks(cfg, B):
    xp, L = cfg.xpeft, cfg.num_layers
    g = torch.Generator().manual_seed(1)
    return {"w_a": torch.rand((B, L, xp.num_adapters), generator=g),
            "w_b": torch.rand((B, L, xp.num_adapters), generator=g),
            "ln_scale": torch.ones((B, L, xp.bottleneck)),
            "ln_bias": torch.zeros((B, L, xp.bottleneck))}


def _dot_flops(cfg, B, T, S):
    """2·M·N·K over the step's products: per layer the QKV and output
    projections, scores and values over S keys, the GLU MLP, the on-the-fly
    aggregation of Â and B̂ and the adapter's two products; the head on
    the last position."""
    d, H, KV, hd, ff = (cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                        cfg.head_dim, cfg.d_ff)
    N, b = cfg.xpeft.num_adapters, cfg.xpeft.bottleneck
    layer = (2 * B * T * d * (H + 2 * KV) * hd + 2 * B * T * H * hd * d
             + 2 * (2 * B * H * T * S * hd) + 3 * (2 * B * T * d * ff)
             + 2 * (2 * B * N * d * b) + 2 * (2 * B * T * d * b))
    return cfg.num_layers * layer + 2 * B * d * cfg.vocab_size


def _dots(counter):
    return sum(v[0] for k, v in counter.by_op.items()
               if k in ("aten.mm", "aten.addmm", "aten.bmm", "aten.baddbmm"))


@pytest.mark.parametrize("kind", ["prefill", "decode"])
def test_dot_flops_equal_closed_form(kind):
    cfg, params = _tiny()
    B, T, S = 3, 8, 24
    cache = MDL.init_cache(cfg, B, S, device="cpu")
    masks = _masks(cfg, B)
    tokens = torch.randint(0, cfg.vocab_size, (B, T if kind == "prefill"
                                               else 1))
    with torch.no_grad(), OC.OpCounter() as c:
        if kind == "prefill":
            TSS.make_prefill_step(cfg)(params, tokens, cache,
                                       profile_masks=masks)
        else:
            TSS.make_decode_step(cfg)(params, tokens, cache, 5,
                                      profile_masks=masks)
    assert _dots(c) == _dot_flops(cfg, B, tokens.shape[1], S)


def _gathered(whole_bytes, spec, sizes):
    """Result bytes of ``sharding.gather`` of one block: an all-gather per
    named axis, the minor one first, each result the block grown by that
    axis."""
    n = int(np.prod([sizes[a] for e in spec if e
                     for a in (e if isinstance(e, tuple) else (e,))]))
    cur, total = whole_bytes // n, 0
    for e in spec:
        for a in reversed(e if isinstance(e, tuple) else (e,) if e else ()):
            cur *= sizes[a]
            total += cur
    return total


def test_fake_mesh_all_gather_bytes_equal_the_gathered_specs():
    cfg = treduce(tget_config("qwen1.5-0.5b"))
    sizes = {"data": 2, "model": 2}
    B = 4
    params = MDL.init_lm(cfg, device="meta")
    specs = serving_param_specs(params, sizes)
    L = cfg.num_layers
    want = 0
    for name, x in tree_paths(params).items():
        spec = specs
        for part in name.split("/"):
            spec = spec[part]
        nb = x.numel() * x.element_size()
        if not any(spec):
            continue
        if name.startswith(("blocks/", "xpeft_bank/")):
            want += L * _gathered(nb // L, spec[1:], sizes)
        elif name == "embed":
            # the rows lookup gathers each rank's hits: [B, 1, d] a rank
            want += sizes["model"] * B * cfg.d_model * x.element_size()
        else:
            want += _gathered(nb, spec, sizes)
    with DR.fake_mesh(sizes) as mesh:
        placed = TSH.place(params, specs, mesh)
        cache = MDL.init_cache(cfg, B, 16, device="meta")
        masks = {k: v.to("meta") for k, v in _masks(cfg, B).items()}
        tokens = torch.empty((B, 1), dtype=torch.int32, device="meta")
        with torch.no_grad(), OC.OpCounter() as c:
            TSS.make_decode_step(cfg)(placed, tokens, cache, 3,
                                      profile_masks=masks)
    got = OC.collective_bytes(c)
    assert got["all-gather"] == want > 0
    assert got["total"] == want
    assert OC.analyze(c)["collectives"]["total"] == want


def test_exports_and_attribute():
    c = OC.OpCounter(sites=True)
    cfg, params = _tiny()
    tokens = torch.zeros((2, 1), dtype=torch.int32)
    with torch.no_grad(), c:
        TSS.make_decode_step(cfg)(params, tokens,
                                  MDL.init_cache(cfg, 2, 8, device="cpu"), 0,
                                  profile_masks=_masks(cfg, 2))
    top = OC.attribute(c, top=5, key="flops")
    assert len(top) == 5 and top == sorted(top, reverse=True)
    # the projections' and the head's products, at their own functions
    sites = {(op, site) for _, op, site in top}
    assert ("aten.bmm", "models/attention.py:attention") in sites
    assert ("aten.mm", "models/model.py:lm_logits") in sites
    assert sum(v for v, _, _ in OC.attribute(c, top=10 ** 6,
                                             key="flops")) == c.flops
    with pytest.raises(ValueError):
        OC.attribute(OC.OpCounter())


# ----------------------------------------------------------------------------
# a float8 KV cache
# ----------------------------------------------------------------------------

def test_float8_cache_decode_matches_jax():
    cfg = reduce_for_smoke(get_config("qwen1.5-0.5b")).with_(
        cache_dtype="float8_e4m3fn")
    tcfg = treduce(tget_config("qwen1.5-0.5b")).with_(
        cache_dtype="float8_e4m3fn")
    params = MDL.init_lm(tcfg, device="cpu")
    jparams = jax.tree.map(jnp.asarray, bridge.to_numpy(params))
    B, T, S = 2, 6, 16
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg.vocab_size, (B, T)).astype(np.int32)
    nxt = rng.integers(0, cfg.vocab_size, (B, 1)).astype(np.int32)
    jcache = JMDL.init_cache(cfg, B, S)
    jl1, jcache = _run(JSS.make_prefill_step(cfg), jparams, toks, jcache)
    jl2, jcache = _run(JSS.make_decode_step(cfg), jparams, nxt, jcache, T)
    cache = MDL.init_cache(tcfg, B, S, device="cpu")
    assert cache["k"].dtype == torch.float8_e4m3fn
    with torch.no_grad():
        l1, cache = TSS.make_prefill_step(tcfg)(params, torch.from_numpy(toks),
                                                cache)
        l2, cache = TSS.make_decode_step(tcfg)(params, torch.from_numpy(nxt),
                                               cache, T)
    for k in ("k", "v"):
        np.testing.assert_array_equal(
            cache[k].view(torch.uint8).numpy(),
            np.asarray(jcache[k]).view(np.uint8), err_msg=k)
    for got, want in ((l1, jl1), (l2, jl2)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-5)
