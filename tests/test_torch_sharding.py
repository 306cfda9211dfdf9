"""The port's sharding rules, mesh grammar and hint resolution against
the JAX package's, in one process with no process group.

``spec_for`` / ``param_specs`` on every leaf of every configuration at
full size (leaves from ``jax.eval_shape`` of JAX's init, so nothing is
allocated; the quantized banks' leaves too), for three mesh shapes, fsdp
on and off, with and without overrides; ``cache_specs``,
``paged_cache_specs``, ``batch_specs`` and ``leading_axis_specs`` on
reduced shapes; ``sharded_bytes_per_device`` and its three raises;
``parse_mesh``'s grammar and errors; ``ctx``'s resolution for the
activation shapes of the model's hint sites. The port's functions read
only ``.shape`` (and ``.dtype``), so JAX's ShapeDtypeStructs go into
both. Specs compare as tuples of entries.
"""
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs import get_config, list_archs, reduce_for_smoke
from repro.distributed import ctx as JCTX
from repro.distributed import sharding as JSH
from repro.launch import mesh as JMESH
from repro.models import init_cache as jinit_cache
from repro.models import init_lm as jinit_lm
from repro.quant import schemes as JQS
from repro_torch.distributed import ctx as TCTX
from repro_torch.distributed import sharding as TSH
from repro_torch.launch import mesh as TMESH

MESHES = ({"data": 4, "model": 2}, {"data": 16, "model": 16},
          {"pod": 2, "data": 16, "model": 16})
OVERRIDES = ({"attn/wq": ("tp_d", None, None)},
             {"mlp/wd": (None, "tp_d"), "bank_b": ("mlp", None, None)})


class _Mesh:
    """JAX's sharding functions read only ``mesh.shape``."""

    def __init__(self, shape):
        self.shape = shape


def _norm(spec):
    """A spec as a tuple of entries, a one-axis tuple as its name."""
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e
                 for e in spec)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}" if prefix else str(k)))
        return out
    return {prefix: tree}


def _abstract(arch):
    cfg = get_config(arch)
    params = jax.eval_shape(lambda: jinit_lm(jax.random.key(0), cfg))
    trees = {"params": params}
    bank = params.get("xpeft_bank")
    if bank is not None and "bank_a" in bank:
        for scheme in ("int8", "int4"):
            trees[scheme] = jax.eval_shape(
                lambda b, s=scheme: JQS.quantize_bank(
                    b, s, group=cfg.xpeft.quant_group), bank)
    return trees


@pytest.fixture(scope="module")
def abstract():
    return {arch: _abstract(arch) for arch in list_archs()}


@pytest.mark.parametrize("arch", list_archs())
def test_spec_for_every_leaf_matches_jax(abstract, arch):
    n = 0
    for tree in abstract[arch].values():
        for path, leaf in _flat(tree).items():
            for axes in MESHES:
                sizes = {k: v for k, v in axes.items() if k != "pod"}
                for fsdp in (True, False):
                    for ov in (None,) + OVERRIDES:
                        want = JSH.spec_for(path, leaf.shape, sizes,
                                            fsdp=fsdp, overrides=ov)
                        got = TSH.spec_for(path, leaf.shape, sizes,
                                           fsdp=fsdp, overrides=ov)
                        assert _norm(got) == _norm(want), (path, axes, fsdp)
                        n += 1
    assert n >= 13 * 3 * 2 * 3


@pytest.mark.parametrize("axes", MESHES, ids=["4x2", "16x16", "2x16x16"])
@pytest.mark.parametrize("fsdp", [True, False])
def test_param_specs_match_jax(abstract, axes, fsdp):
    for arch, trees in abstract.items():
        for tree in trees.values():
            want = _flat(JSH.param_specs(tree, _Mesh(axes), fsdp=fsdp))
            got = _flat(TSH.param_specs(tree, axes, fsdp=fsdp))
            assert {k: _norm(v) for k, v in got.items()} == \
                {k: _norm(v) for k, v in want.items()}, arch


def _sds(shape, dtype=jnp.float32):
    return jax.ShapeDtypeStruct(shape, dtype)


@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "rwkv6-7b", "zamba2-1.2b",
                                  "gemma3-27b"])
@pytest.mark.parametrize("batch", [1, 4, 8])
def test_cache_specs_match_jax(arch, batch):
    cfg = reduce_for_smoke(get_config(arch))
    cache = jax.eval_shape(lambda: jinit_cache(cfg, batch, 64))
    for axes in MESHES[:1] + ({"data": 2, "model": 4}, {"model": 2}):
        want = _flat(JSH.cache_specs(cache, _Mesh(axes), cfg, batch))
        got = _flat(TSH.cache_specs(cache, axes, cfg, batch))
        assert {k: _norm(v) for k, v in got.items()} == \
            {k: _norm(v) for k, v in want.items()}, axes


@pytest.mark.parametrize("slots", [2, 4, 6])
def test_paged_cache_and_slot_specs_match_jax(slots):
    from repro.serve import pages as JPG
    cfg = reduce_for_smoke(get_config("qwen1.5-0.5b"))
    template = jax.eval_shape(lambda: jinit_cache(cfg, slots, 64))
    paged = jax.eval_shape(lambda: JPG.make_paged_cache(template, 8, 16,
                                                        slots))
    slot_state = {"last_tok": _sds((slots,), jnp.int32),
                  "tok_buf": _sds((slots, 8), jnp.int32),
                  "masks": {"a_hat": _sds((slots, 2, 64, 4)),
                            "odd": _sds((5,)), "s": _sds(())}}
    for axes in ({"data": 2, "model": 2}, {"data": 4}, {"model": 2}):
        want = _flat(JSH.paged_cache_specs(paged, _Mesh(axes), cfg, slots))
        got = _flat(TSH.paged_cache_specs(paged, axes, cfg, slots))
        assert {k: _norm(v) for k, v in got.items()} == \
            {k: _norm(v) for k, v in want.items()}
        want = _flat(JSH.leading_axis_specs(slot_state, _Mesh(axes)))
        got = _flat(TSH.leading_axis_specs(slot_state, axes))
        assert {k: _norm(v) for k, v in got.items()} == \
            {k: _norm(v) for k, v in want.items()}


def test_batch_specs_match_jax():
    batch = {"tokens": _sds((8, 16), jnp.int32),
             "labels": _sds((8, 16), jnp.int32),
             "one": _sds((1, 32), jnp.int32), "odd": _sds((3, 5))}
    for axes in MESHES + ({"data": 8},):
        want = _flat(JSH.batch_specs(batch, _Mesh(axes), 8))
        got = _flat(TSH.batch_specs(batch, axes, 8))
        assert {k: _norm(v) for k, v in got.items()} == \
            {k: _norm(v) for k, v in want.items()}, axes


def test_sharded_bytes_per_device_matches_jax(abstract):
    for axes in MESHES:
        for arch, trees in abstract.items():
            tree = trees["params"]
            want_specs = JSH.param_specs(tree, _Mesh(axes), fsdp=True)
            got_specs = TSH.param_specs(tree, axes, fsdp=True)
            assert TSH.sharded_bytes_per_device(tree, got_specs, axes) == \
                JSH.sharded_bytes_per_device(tree, want_specs, axes), arch


@pytest.mark.parametrize("case", ["missing", "short", "unknown"])
def test_sharded_bytes_per_device_raises_as_jax(case):
    axes = {"data": 4, "model": 2}
    tree = {"a": _sds((8, 64)), "b": _sds((3,))}
    specs, match = {
        "missing": ({"a": ("data", None)}, "exactly one spec"),
        "short": ({"a": ("data",), "b": (None,)}, "full rank"),
        "unknown": ({"a": ("pod", None), "b": (None,)}, "mesh axis"),
    }[case]
    with pytest.raises(ValueError, match=match):
        JSH.sharded_bytes_per_device(
            tree, {k: jax.sharding.PartitionSpec(*v)
                   for k, v in specs.items()}, axes)
    with pytest.raises(ValueError, match=match):
        TSH.sharded_bytes_per_device(
            tree, {k: TSH.P(*v) for k, v in specs.items()}, axes)
    got = TSH.sharded_bytes_per_device(
        tree, {"a": TSH.P("data", "model"), "b": TSH.P(None)}, axes)
    assert got == (8 * 64 * 4) // 8 + 3 * 4


def test_placement_roundtrip_without_a_group():
    """``shard`` cuts each rank's block; concatenating the blocks of
    every rank in order gives the whole tensor back bitwise."""
    class _Rank:
        def __init__(self, ranks):
            self.ranks = ranks
            self.mesh_dim_names, self.shape = ("data", "model"), (2, 3)

        def get_local_rank(self, axis):
            return self.ranks[axis]

    x = torch.arange(2 * 6 * 5, dtype=torch.float32).reshape(2, 6, 5)
    spec = TSH.P(None, ("data", "model"), None)
    blocks = [TSH.shard(x, spec, _Rank({"data": d, "model": m}))
              for d in range(2) for m in range(3)]
    assert all(b.shape == (2, 1, 5) for b in blocks)
    assert torch.equal(torch.cat(blocks, dim=1), x)
    assert TSH.global_meta(blocks[0], spec, _Rank({})).shape == x.shape


@pytest.mark.parametrize("spec", ["", "4x2:data,model", "2x16x16:pod,data,"
                                  "model", "8:data", "4x2", "4x2:data",
                                  "ax2:data,model", "4x2:data,model:x"])
def test_parse_mesh_grammar_matches_jax(monkeypatch, spec):
    """JAX's parse_mesh with its mesh constructor spied (this process
    has one CPU device): the same (shape, axes), or the same error."""
    monkeypatch.setattr(JMESH, "make_mesh_compat",
                        lambda shape, axes: (shape, axes))
    want = got = jax_err = port_err = None
    try:
        want = JMESH.parse_mesh(spec)
    except ValueError as e:
        jax_err = str(e)
    try:
        got = TMESH.parse_mesh_spec(spec)
    except ValueError as e:
        port_err = str(e)
    assert port_err == jax_err
    if jax_err is None:
        assert got == want


def test_make_mesh_refuses_a_world_of_another_size():
    with pytest.raises(ValueError, match="needs 4 processes"):
        TMESH.make_mesh((2, 2), ("data", "model"), "cpu")


# the model's hint sites (``src/repro/models/*.py``) at qwen1.5-0.5b's
# and its MQA / MoE variants' activation shapes: (logical dims, shape)
HINTS = [
    ((None, "batch", "kv_heads", "kv_seq", None), (24, 8, 16, 128, 64)),
    ((None, "batch", "kv_heads", "kv_seq", None), (24, 8, 1, 128, 64)),
    (("batch", None, "heads", None), (8, 64, 16, 64)),
    (("batch", "q_seq", None, None), (8, 64, 16, 64)),
    (("batch", "kv_heads", "kv_seq", None), (8, 16, 128, 64)),
    (("batch", "kv_heads", "kv_seq", None), (8, 1, 128, 64)),
    (("batch", "kv_heads", "kv_seq", None), (1, 24, 4096, 64)),
    (("batch", None, "mlp"), (8, 64, 2816)),
    (("batch", None, "mlp"), (8, 64, 2817)),
    (("batch", "seq", "embed"), (8, 64, 1024)),
    (("batch", "seq", "embed"), (3, 64, 1024)),
    (("batch", "seq", "vocab"), (8, 64, 151936)),
    (("expert", None, None), (128, 40, 2048)),
    (("expert", None, "mlp"), (128, 40, 768)),
]


@pytest.mark.parametrize("axes", MESHES + ({"data": 8}, {"model": 4}),
                         ids=["4x2", "16x16", "2x16x16", "8", "m4"])
def test_hint_resolution_matches_jax(monkeypatch, axes):
    monkeypatch.setattr(jax.sharding, "NamedSharding",
                        lambda mesh, spec: spec)
    monkeypatch.setattr(jax.lax, "with_sharding_constraint",
                        lambda x, spec: spec)
    for rules in (None, {"seq": "data"}):
        with JCTX.mesh_context(_Mesh(axes), act_rules=rules):
            want = [JCTX.hint(_sds(shape), *dims) for dims, shape in HINTS]
            jsize = {a: JCTX.axis_size(a) for a in ("pod", "data", "model")}
        with TCTX.mesh_context(axes, act_rules=rules):
            got = [TCTX.hint_spec(shape, *dims) for dims, shape in HINTS]
            x = torch.zeros(2, 3)
            assert TCTX.hint(x, "batch", None) is x
            assert TCTX.active_mesh() == axes
            tsize = {a: TCTX.axis_size(a) for a in ("pod", "data", "model")}
        assert [_norm(g) for g in got] == [_norm(w) for w in want]
        assert tsize == jsize
    assert TCTX.active_mesh() is None and TCTX.axis_size("data") == 1
    assert TCTX.hint_spec((2, 3), "batch", None) is None
