"""The port's mixture-of-experts block against the JAX package's.

Config: ``reduce_for_smoke(get_config("qwen3-moe-30b-a3b"))`` (d=64,
E=8 experts, top-2, per-expert d_ff 32, float32) at capacity_factor 8.0
(nothing dropped) and 0.25 (routes dropped), with JAX's ``init_moe``
weights carried across by ``repro_torch.bridge``; JAX runs
``_moe_local`` on the CPU (no mesh). Tolerance: rtol = atol = 1e-5 at
float32, as ``tests/test_torch_model.py``. The routing is held exactly:
each token's selected expert set and the dropped (token, expert) set are
equal, computed by the port's ``route``/``ranks`` and by JAX's own ops
(``lax.top_k``, the stable argsort, ``searchsorted``) as
``repro/models/moe.py:55-79`` runs them. Gradients (router, experts,
x) are held as ``tests/test_torch_train.py`` holds gradients: rtol 1e-4,
atol 1e-6 x the leaf's largest |gradient| (a loss of summed squares
gives gradients of ~20, whose fp32 sums in other orders part by a few
1e-5).
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

hypothesis = pytest.importorskip("hypothesis")
from hypothesis import given, settings, strategies as st  # noqa: E402

from repro.configs import get_config, reduce_for_smoke  # noqa: E402
from repro.models import model as JMDL  # noqa: E402
from repro.models import moe as JMOE  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_config as tget_config  # noqa: E402
from repro_torch.configs import reduce_for_smoke as treduce  # noqa: E402
from repro_torch.models import model as TMDL  # noqa: E402
from repro_torch.models import moe as TMOE  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)
ARCH = "qwen3-moe-30b-a3b"
CAPACITY = [8.0, 0.25]


def _cfgs(cf, impl="sort"):
    return tuple(c.with_(capacity_factor=cf, moe_impl=impl)
                 for c in (reduce_for_smoke(get_config(ARCH)),
                           treduce(tget_config(ARCH))))


@pytest.fixture(scope="module")
def weights():
    cfg, _ = _cfgs(8.0)
    p = JMOE.init_moe(jax.random.key(0), cfg, jnp.float32)
    x = np.random.default_rng(1).normal(
        size=(2, 16, cfg.d_model)).astype(np.float32)
    return p, bridge.to_torch(jax.tree.map(np.asarray, p)), x


def _jax_routing(p, x, cfg):
    """JAX's selected sets and kept flags, by ``moe.py``'s own ops."""
    n = x.shape[0] * x.shape[1]
    x2 = jnp.asarray(x).reshape(n, -1)
    gates = jnp.einsum("td,de->te", x2.astype(jnp.float32), p["router"])
    _, topi = jax.lax.top_k(jax.nn.softmax(gates, axis=-1), cfg.top_k)
    C = JMOE.capacity(n, cfg)
    eids = topi.reshape(-1)
    order = jnp.argsort(eids)
    se = eids[order]
    starts = jnp.searchsorted(se, jnp.arange(cfg.num_experts))
    pos = jnp.arange(n * cfg.top_k) - starts[se]
    kept = np.zeros(n * cfg.top_k, bool)
    kept[np.asarray(order)] = np.asarray(pos < C)
    return np.asarray(topi), kept.reshape(n, cfg.top_k)


def _sets(topi, kept):
    sel = {(t, int(e)) for t, row in enumerate(topi) for e in row}
    dropped = {(t, int(e)) for t, (row, k) in enumerate(zip(topi, kept))
               for e, ok in zip(row, k) if not ok}
    return sel, dropped


@pytest.mark.parametrize("impl", ["sort", "dense"])
@pytest.mark.parametrize("cf", CAPACITY)
def test_moe_apply_matches_jax(weights, cf, impl):
    p, tp, x = weights
    cfg, tcfg = _cfgs(cf, impl)
    jy, jaux = JMOE._moe_local(p, jnp.asarray(x), cfg)
    ty, taux = TMOE.moe_apply(tp, torch.from_numpy(x), tcfg)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(float(taux), float(jaux), **TOL)
    # routing: the selected sets and the dropped routes equal JAX's
    jsel, jdrop = _sets(*_jax_routing(p, x, cfg))
    n = x.shape[0] * x.shape[1]
    _, _, _, topi = TMOE.route(tp["router"], torch.from_numpy(x).reshape(
        n, -1), tcfg.top_k)
    _, kept = TMOE.ranks(topi, TMOE.capacity(n, tcfg), tcfg.num_experts)
    tsel, tdrop = _sets(topi.numpy(), kept.numpy())
    assert tsel == jsel and tdrop == jdrop
    assert (len(tdrop) > 0) == (cf < 1.0)


def test_drops_leave_zeros_where_every_route_dropped(weights):
    """A token whose every route overflows gets exactly 0 (the residual
    carries it), as JAX's masked scatter-add leaves it."""
    p, tp, x = weights
    cfg, tcfg = _cfgs(0.25)
    n = x.shape[0] * x.shape[1]
    topi, kept = _jax_routing(p, x, cfg)
    ty, _ = TMOE.moe_apply(tp, torch.from_numpy(x), tcfg)
    ty = ty.reshape(n, -1).numpy()
    none = ~kept.any(1)
    assert none.any()
    assert (ty[none] == 0).all() and (np.abs(ty[~none]).sum(1) > 0).all()
    jy, _ = JMOE._moe_local(p, jnp.asarray(x), cfg)
    assert (np.asarray(jy).reshape(n, -1)[none] == 0).all()


def test_top_k_ties_select_jax_sets():
    """Tied router probabilities: the selected sets are JAX's (lax.top_k
    prefers the lower index; the port's stable sort does too)."""
    cfg, tcfg = _cfgs(8.0)
    E, d = cfg.num_experts, cfg.d_model
    router = np.zeros((d, E), np.float32)
    router[0, :] = [0.5, 0.5, 0.5, 0.2, 0.2, 0.9, 0.9, 0.1]
    router[1, :] = [0.3, 0.3, 0.3, 0.3, 0.3, 0.3, 0.3, 0.3]
    x = np.zeros((1, 3, d), np.float32)
    x[0, 0, 0] = 1.0
    x[0, 1, 1] = 1.0
    x[0, 2, 0] = 0.5
    p = JMOE.init_moe(jax.random.key(0), cfg, jnp.float32)
    p = dict(p, router=jnp.asarray(router))
    tp = bridge.to_torch(jax.tree.map(np.asarray, p))
    jsel, jdrop = _sets(*_jax_routing(p, x, cfg))
    _, _, _, topi = TMOE.route(tp["router"], torch.from_numpy(x[0]),
                               tcfg.top_k)
    _, kept = TMOE.ranks(topi, TMOE.capacity(3, tcfg), E)
    assert _sets(topi.numpy(), kept.numpy()) == (jsel, jdrop)


@given(st.integers(1, 8192), st.sampled_from([(8, 2), (128, 8), (16, 4)]),
       st.sampled_from([0.25, 1.0, 1.25, 8.0, 64.0]))
@settings(max_examples=40, deadline=None)
def test_capacity_formula_matches_jax(n, ek, cf):
    E, k = ek
    cfg, tcfg = (c.with_(num_experts=E, top_k=k) for c in _cfgs(cf))
    assert TMOE.capacity(n, tcfg) == JMOE.capacity(n, cfg)


def _close_grad(got, want, what):
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4,
                               atol=1e-6 * np.abs(want).max(), err_msg=what)


@pytest.mark.parametrize("cf", CAPACITY)
def test_grads_match_jax_grad(weights, cf):
    """``tests/test_moe.py::test_grad_flows_through_router``'s loss,
    sum(y^2) + 0.01 aux: the gradients in the router, the three expert
    banks and x against ``jax.grad``."""
    p, tp, x = weights
    cfg, tcfg = _cfgs(cf)

    def jloss(params, xx):
        y, aux = JMOE.moe_apply(params, xx, cfg)
        return jnp.sum(y ** 2) + 0.01 * aux

    jg, jgx = jax.grad(jloss, argnums=(0, 1))(p, jnp.asarray(x))
    tp = {k: v.clone().requires_grad_(True) for k, v in tp.items()}
    tx = torch.from_numpy(x).requires_grad_(True)
    y, aux = TMOE.moe_apply(tp, tx, tcfg)
    (torch.sum(y ** 2) + 0.01 * aux).backward()
    for k in ("router", "ew_g", "ew_u", "ew_d"):
        assert float(tp[k].grad.abs().sum()) > 0, k
        _close_grad(tp[k].grad, jg[k], k)
    _close_grad(tx.grad, jgx, "x")


@pytest.mark.parametrize("cf", CAPACITY)
def test_two_calls_bitwise_equal(weights, cf):
    _, tp, x = weights
    _, tcfg = _cfgs(cf)
    a = TMOE.moe_apply(tp, torch.from_numpy(x), tcfg)
    b = TMOE.moe_apply(tp, torch.from_numpy(x), tcfg)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def test_init_tree_matches_jax():
    cfg, tcfg = _cfgs(1.25)
    jp = JMOE.init_moe(jax.random.key(0), cfg, jnp.float32)
    tp = TMOE.init_moe(tcfg, torch.float32,
                       generator=torch.Generator().manual_seed(0),
                       device="cpu")
    assert sorted(tp) == sorted(jp)
    for k in jp:
        assert tuple(tp[k].shape) == jp[k].shape, k
        assert tp[k].dtype == torch.float32
    bf = TMOE.init_moe(tcfg, torch.bfloat16,
                       generator=torch.Generator().manual_seed(0),
                       device="cpu")
    assert bf["router"].dtype == torch.float32
    assert bf["ew_g"].dtype == torch.bfloat16


@pytest.mark.parametrize("arch", ["qwen3-moe-30b-a3b", "dbrx-132b"])
def test_moe_configs_supported_with_jax_init_tree(arch):
    """Both MoE configs pass ``check_supported`` at full size, and the
    port's ``init_lm`` builds JAX's tree (blocks["moe"] in place of
    "mlp", the router in fp32) at the reduced size."""
    TMDL.check_supported(tget_config(arch))
    cfg, tcfg = reduce_for_smoke(get_config(arch)), treduce(tget_config(arch))
    jp = jax.eval_shape(lambda: JMDL.init_lm(jax.random.key(0), cfg))
    tp = TMDL.init_lm(tcfg, seed=0, device="cpu")
    jl = jax.tree_util.tree_leaves_with_path(jp)
    tl = jax.tree_util.tree_leaves_with_path(tp)
    assert [jax.tree_util.keystr(p) for p, _ in jl] == \
        [jax.tree_util.keystr(p) for p, _ in tl]
    for (path, j), (_, t) in zip(jl, tl):
        assert tuple(t.shape) == j.shape, path
        assert str(t.dtype).split(".")[-1] == str(j.dtype), path
    assert "mlp" not in tp["blocks"]
    assert tp["blocks"]["moe"]["router"].dtype == torch.float32
