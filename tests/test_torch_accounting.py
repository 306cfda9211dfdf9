"""The port's memory accounting behind the paper's Table 1 and its small
tree helpers, against the JAX package's, on the CPU.

``adapter_bytes``, ``trainable_params_per_profile``, ``bytes_per_profile``
and ``ProfileStore.total_bytes`` (hard, soft and quantized stores, with
and without the LN affines) give JAX's integers at every config's full
size; ``param_count``/``param_bytes`` of the bridged reduced qwen params
equal JAX's on its own; ``map_with_paths`` gives JAX's paths;
``tree_zeros_like`` keeps dtypes; ``init_xpeft_state`` has JAX's shapes
and dtypes (plain and heterogeneous banks) and defaults to the card;
``param_shardings`` is ``to_shardings(param_specs(...))``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import utils as JU
from repro.configs import get_config, reduce_for_smoke
from repro.core import masks as JM
from repro.core import xpeft as JXP
from repro.core.profiles import ProfileStore as JStore
from repro.distributed import sharding as JSH
from repro.models import init_lm as jinit_lm
from repro_torch import bridge
from repro_torch import utils as TU
from repro_torch.configs import get_config as tget_config
from repro_torch.configs import list_archs
from repro_torch.configs import reduce_for_smoke as treduce
from repro_torch.core import masks as TM
from repro_torch.core import xpeft as TXP
from repro_torch.core.profiles import ProfileStore as TStore
from repro_torch.distributed import sharding as TSH

HETERO = dict(num_adapters=12, bottleneck=4, k=4, max_profiles=8,
              bank_spec=(("bottleneck", 4), ("lora", 4), ("ia3", 2),
                         ("prefix", 2)),
              prefix_tokens=2)


class _Mesh:
    """JAX's ``param_specs`` reads only ``mesh.shape``."""

    def __init__(self, shape):
        self.shape = shape


@pytest.mark.parametrize("arch", list_archs())
def test_table1_integers_equal_jax(arch):
    cfg, xp = get_config(arch), get_config(arch).xpeft
    L, N, b, d = cfg.num_layers, xp.num_adapters, xp.bottleneck, cfg.d_model
    for itemsize in (2, 4):
        assert TM.adapter_bytes(d, b, L, itemsize) == \
            JM.adapter_bytes(d, b, L, itemsize)
    assert TM.adapter_bytes(d, b, L) == JM.adapter_bytes(d, b, L)
    assert TM.trainable_params_per_profile(N, b, L) == \
        JM.trainable_params_per_profile(N, b, L)
    rng = np.random.default_rng(0)
    rows = [{"mA": rng.standard_normal((L, N)).astype(np.float32),
             "mB": rng.standard_normal((L, N)).astype(np.float32),
             "ln_scale": np.ones((L, b), np.float32),
             "ln_bias": np.zeros((L, b), np.float32)} for _ in range(3)]
    for mask_type in ("hard", "soft"):
        assert TM.bytes_per_profile(N, L, mask_type) == \
            JM.bytes_per_profile(N, L, mask_type)
        for quant in ("none", "int8", "int4"):
            kw = dict(mask_type=mask_type, k=xp.k, quant=quant,
                      bank_spec=xp.bank_spec)
            ts, js = TStore(L, N, b, **kw), JStore(L, N, b, **kw)
            assert ts.total_bytes() == js.total_bytes() == 0
            for pid, row in enumerate(rows):
                ts.add_profile(pid, row)
                js.add_profile(pid, row)
            for include_ln in (False, True):
                assert ts.total_bytes(include_ln) == \
                    js.total_bytes(include_ln) == \
                    3 * ts.bytes_per_profile(include_ln)


@pytest.fixture(scope="module")
def qwen():
    cfg = reduce_for_smoke(get_config("qwen1.5-0.5b"))
    params = jax.jit(jinit_lm, static_argnums=1)(jax.random.key(0), cfg)
    return params, bridge.to_torch(jax.tree.map(np.asarray, params))


def test_param_count_and_bytes_equal_jax(qwen):
    params, tparams = qwen
    assert TU.param_count(tparams) == JU.param_count(params)
    assert TU.param_bytes(tparams) == JU.param_bytes(params)
    bf16 = TU.tree_zeros_like({"w": torch.ones(3, 5, dtype=torch.bfloat16),
                               "n": [torch.ones(7, dtype=torch.int8)]})
    assert TU.param_count(bf16) == 22
    assert TU.param_bytes(bf16) == 3 * 5 * 2 + 7
    # an optional leaf (None) is no leaf, as in JAX's pytrees
    w = np.ones((3, 5), np.float32)
    jtree, ttree = {"w": jnp.asarray(w), "b": None}, \
        {"w": torch.from_numpy(w), "b": None}
    assert TU.param_count(ttree) == JU.param_count(jtree) == 15
    assert TU.param_bytes(ttree) == JU.param_bytes(jtree) == 60
    assert TU.tree_zeros_like(ttree)["b"] is None


def test_map_with_paths_equals_jax(qwen):
    params, tparams = qwen
    want = JU.tree_paths(JU.map_with_paths(
        lambda p, x, y: (p, JU.leaf_name(p), x.shape == y.shape),
        params, params))
    got = TU.tree_paths(TU.map_with_paths(
        lambda p, x, y: (p, TU.leaf_name(p), tuple(x.shape) == y.shape),
        tparams, {k: v for k, v in params.items()}))
    assert list(got) == list(want)
    assert got == want
    # lists nest as JAX's sequence keys
    tree = {"a": [1, {"b": 2}], "c": 3}
    assert TU.tree_paths(TU.map_with_paths(lambda p, x: p, tree)) == \
        JU.tree_paths(JU.map_with_paths(lambda p, x: p, tree))


def test_tree_zeros_like_keeps_dtypes(qwen):
    _, tparams = qwen
    zeros = TU.tree_zeros_like(tparams)
    for path, x in TU.tree_paths(tparams).items():
        z = TU.tree_paths(zeros)[path]
        assert z.dtype == x.dtype and z.shape == x.shape
        assert z.device == x.device and not z.any()


def _shapes(tree, jax_tree):
    got = {p: (tuple(x.shape), str(x.dtype).replace("torch.", ""))
           for p, x in TU.tree_paths(tree).items()}
    want = {p: (tuple(x.shape), str(x.dtype))
            for p, x in JU.tree_paths(jax_tree).items()}
    return got, want


@pytest.mark.parametrize("hetero", [False, True], ids=["plain", "hetero"])
def test_init_xpeft_state_shapes_equal_jax(hetero):
    cfg = reduce_for_smoke(get_config("qwen1.5-0.5b"))
    tcfg = treduce(tget_config("qwen1.5-0.5b"))
    if hetero:
        cfg, tcfg = cfg.with_xpeft(**HETERO), tcfg.with_xpeft(**HETERO)
    for dtype in ("float32", "bfloat16"):
        c, tc = cfg.with_(dtype=dtype), tcfg.with_(dtype=dtype)
        want = jax.eval_shape(lambda: JXP.init_xpeft_state(
            jax.random.key(0), c))
        got = TXP.init_xpeft_state(tc, seed=3, device="cpu")
        assert sorted(got) == ["bank", "profiles"]
        g, w = _shapes(got, want)
        assert g == w
        again = TXP.init_xpeft_state(tc, seed=3, device="cpu")
        assert all(torch.equal(x, TU.tree_paths(again)[p])
                   for p, x in TU.tree_paths(got).items())


def test_init_xpeft_state_defaults_to_the_card():
    cfg = treduce(tget_config("qwen1.5-0.5b"))
    if torch.cuda.is_available():
        state = TXP.init_xpeft_state(cfg)
        assert all(x.is_cuda for x in TU.tree_paths(state).values())
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TXP.init_xpeft_state(cfg)


def _flat(tree, prefix=""):
    """{path: leaf} over nested dicts only (a spec is a tuple leaf)."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}" if prefix else str(k)))
        return out
    return {prefix: tree}


def _norm(spec):
    """A spec as a tuple of entries, a one-axis tuple as its name."""
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e
                 for e in spec)


def test_param_shardings_are_sharded_param_specs(qwen):
    params, tparams = qwen
    for axes in ({"data": 4, "model": 2}, {"data": 2, "model": 2}):
        got = _flat(TSH.param_shardings(tparams, axes, fsdp=True))
        specs = _flat(TSH.param_specs(tparams, axes, fsdp=True))
        want = _flat(JSH.param_specs(params, _Mesh(axes), fsdp=True))
        assert sorted(got) == sorted(specs) == sorted(want)
        for path, sh in got.items():
            assert isinstance(sh, TSH.Sharding) and sh.mesh == axes
            assert tuple(sh.spec) == tuple(specs[path])
            assert _norm(sh.spec) == _norm(want[path]), path
