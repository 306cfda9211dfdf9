"""The port's chunked gated linear attention (``models/linear_attn.py``)
against the JAX package's on the CPU.

The same seeded numpy inputs go through ``repro.models.linear_attn`` and
the port: ``gla_chunked`` with and without the RWKV bonus, from a zero
and from a carried state, at the reduced test configs' chunk (8) and at
the full configs' (128) over ragged and exact lengths, at strong decay
(``lw`` at ``LW_MIN``: finite, no overflow, held to the float64
recurrence), and ``gla_decode_step``
continuing a chunked prefix. At chunk 8 the tolerance is ``TOL`` (rtol =
atol = 1e-5); at chunk 128 the intra-chunk products run over 16-token
sub-tiles whose factors reach e^(16 |lw|), and the two packages sum those
products in other orders, so those cases hold to ``TOL_WIDE`` (rtol =
atol = 1e-4, the JAX test's own bound against the naive recurrence).
At strong decay JAX's gradient is nan (its masked sub-tile factors
overflow) and the port's is finite, equal to the float64 recurrence's; at
moderate decay and chunk 128 the port's gradient equals ``jax.grad``'s
and the float64 recurrence's.
Both packages refuse T=20 at chunk 128 (a 20-token chunk does not split
into 16-token sub-tiles): JAX with a TypeError from its reshape, the
port with a ValueError naming the domain.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.models import linear_attn as J
from repro_torch.models import linear_attn as P

TOL = dict(rtol=1e-5, atol=1e-5)
TOL_WIDE = dict(rtol=1e-4, atol=1e-4)


def _inputs(seed, B=2, H=2, T=32, dk=8, dv=8, strong=False, state=False):
    rng = np.random.default_rng(seed)
    f = np.float32
    q, k = (rng.normal(size=(B, H, T, dk)).astype(f) for _ in range(2))
    v = rng.normal(size=(B, H, T, dv)).astype(f)
    scale = 3.0 if strong else 0.3
    lw = (-scale * np.exp(rng.normal(size=(B, H, T, dk)))).astype(f)
    u = (0.5 * rng.normal(size=(H, dk))).astype(f)
    s0 = rng.normal(size=(B, H, dk, dv)).astype(f) if state else None
    return q, k, v, lw, u, s0


def _both(fn_j, fn_p, arrays, **kw):
    jout = fn_j(*(None if a is None else jnp.asarray(a) for a in arrays),
                **{k: None if v is None else jnp.asarray(v)
                   for k, v in kw.items()})
    pout = fn_p(*(None if a is None else torch.from_numpy(np.array(a))
                  for a in arrays),
                **{k: None if v is None else torch.from_numpy(v)
                   for k, v in kw.items()})
    return jout, pout


@pytest.mark.parametrize("bonus", [False, True])
@pytest.mark.parametrize("T,chunk,state", [
    (32, 8, False), (32, 8, True), (7, 8, True), (16, 128, True),
    (128, 128, True), (256, 128, True), (48, 128, False)])
def test_chunked_matches_jax(T, chunk, state, bonus):
    q, k, v, lw, u, s0 = _inputs(T * 7 + chunk, T=T, state=state)
    (jo, js), (to, ts) = _both(
        lambda *a, **kw: J.gla_chunked(*a, chunk=chunk, **kw),
        lambda *a, **kw: P.gla_chunked(*a, chunk=chunk, **kw),
        (q, k, v, lw), bonus=u if bonus else None, state=s0)
    tol = TOL if chunk <= P.SUBTILE else TOL_WIDE
    assert to.dtype == torch.float32 and ts.dtype == torch.float32
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), **tol)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), **tol)


def test_bf16_output_takes_v_dtype():
    """fp32 inside, the output cast to v's dtype (the state stays fp32),
    the same bf16 values as JAX's to one bf16 step."""
    import ml_dtypes
    q, k, v, lw, u, _ = _inputs(3, T=16)
    jo, js = J.gla_chunked(*(jnp.asarray(a, jnp.bfloat16) for a in
                             (q, k, v, lw)), chunk=8, bonus=jnp.asarray(u))
    to, ts = P.gla_chunked(*(torch.from_numpy(a).to(torch.bfloat16)
                             for a in (q, k, v, lw)), chunk=8,
                           bonus=torch.from_numpy(u))
    assert to.dtype == torch.bfloat16 and ts.dtype == torch.float32
    np.testing.assert_allclose(
        to.float().numpy(), np.asarray(jo).astype(ml_dtypes.bfloat16)
        .astype(np.float32), rtol=2 ** -7, atol=1e-5)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), **TOL)


def naive64(q, k, v, lw, bonus):
    """The recurrence token by token in float64 (the JAX test's
    ``naive``): the truth both chunked forms approximate."""
    q, k, v = (a.astype(np.float64) for a in (q, k, v))
    lw = np.clip(lw.astype(np.float64), P.LW_MIN, -1e-6)
    S = np.zeros(q.shape[:2] + (q.shape[-1], v.shape[-1]))
    out = []
    for t in range(q.shape[2]):
        kv = k[:, :, t, :, None] * v[:, :, t, None, :]
        out.append(np.einsum("bhk,bhkv->bhv", q[:, :, t],
                             S + bonus[None, :, :, None] * kv))
        S = S * np.exp(lw[:, :, t])[..., None] + kv
    return np.stack(out, 2), S


@pytest.mark.parametrize("chunk", [32, 128])
def test_strong_decay_stays_finite(chunk):
    """lw at LW_MIN over whole chunks: the sub-tiling keeps every factor
    under e^80, so nothing overflows. The port holds to the float64
    recurrence within ``TOL_WIDE``; JAX's own output lies 1.5e-3 from it
    here (its CPU products of e^{+-80} factors round further), so the
    port holds to JAX within 2e-3."""
    q, k, v, lw, u, _ = _inputs(1, T=128, strong=True)
    lw = np.full_like(lw, 4 * P.LW_MIN)     # clamped to LW_MIN inside
    (jo, js), (to, ts) = _both(
        lambda *a, **kw: J.gla_chunked(*a, chunk=chunk, **kw),
        lambda *a, **kw: P.gla_chunked(*a, chunk=chunk, **kw),
        (q, k, v, lw), bonus=u)
    assert torch.isfinite(to).all() and torch.isfinite(ts).all()
    no, ns = naive64(q, k, v, lw, u)
    np.testing.assert_allclose(to.numpy(), no, **TOL_WIDE)
    np.testing.assert_allclose(ts.numpy(), ns, **TOL_WIDE)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=2e-3,
                               atol=2e-3)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), **TOL_WIDE)


def test_strong_random_decay_matches_jax():
    """The JAX test's strong decay (3 x a log-normal per channel), T=64
    at chunk 32, bonus form: the port against JAX at ``TOL_WIDE``."""
    q, k, v, lw, u, _ = _inputs(5, T=64, strong=True)
    (jo, js), (to, ts) = _both(
        lambda *a, **kw: J.gla_chunked(*a, chunk=32, **kw),
        lambda *a, **kw: P.gla_chunked(*a, chunk=32, **kw),
        (q, k, v, lw), bonus=u)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), **TOL_WIDE)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), **TOL_WIDE)


@pytest.mark.parametrize("bonus", [False, True])
def test_decode_step_matches_jax_and_continues_chunked(bonus):
    q, k, v, lw, u, _ = _inputs(2, T=33)
    b = u if bonus else None
    (_, jpre), (_, tpre) = _both(
        lambda *a, **kw: J.gla_chunked(*a, chunk=16, **kw),
        lambda *a, **kw: P.gla_chunked(*a, chunk=16, **kw),
        tuple(a[:, :, :32] for a in (q, k, v, lw)), bonus=b)
    (jo, js), (to, ts) = _both(
        lambda *a, **kw: J.gla_decode_step(*a, **kw),
        lambda *a, **kw: P.gla_decode_step(*a, **kw),
        tuple(a[:, :, 32] for a in (q, k, v, lw)) + (np.asarray(jpre),),
        bonus=b)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), **TOL)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), **TOL)
    # the port's own decode step from its own prefix == its chunked pass
    full, s_full = P.gla_chunked(*(torch.from_numpy(a) for a in
                                   (q, k, v, lw)), chunk=11,
                                 bonus=None if b is None else
                                 torch.from_numpy(b))
    o, s = P.gla_decode_step(*(torch.from_numpy(a[:, :, 32]) for a in
                               (q, k, v, lw)), tpre,
                             bonus=None if b is None else torch.from_numpy(b))
    np.testing.assert_allclose(o.numpy(), full[:, :, -1].numpy(), **TOL)
    np.testing.assert_allclose(s.numpy(), s_full.numpy(), **TOL)


def test_grad_through_strong_decay_is_finite():
    """At strong decay the sub-tile pairs above the diagonal overflow
    (e^{5 x 48} at a chunk of 64): JAX computes those masked factors, so
    its forward is finite but its gradient nan (0 * inf); the port's
    forward equals JAX's and its gradient is finite and equals the float64
    recurrence's autograd gradient within 1e-3 (JAX's own bound at strong
    decay: the e^{+-80} sub-tile factors' exponents carry 80 x fp32's
    rounding)."""
    import jax
    q, k, v, _, u, _ = _inputs(6, B=1, T=64)
    lw = np.full_like(q, 4 * P.LW_MIN)
    gj = jax.grad(lambda a: J.gla_chunked(
        a, *(jnp.asarray(t) for t in (k, v, lw)), chunk=64)[0].sum())(
            jnp.asarray(q))
    assert not np.isfinite(np.asarray(gj)).all()
    tq = torch.from_numpy(q).requires_grad_(True)
    o, _ = P.gla_chunked(tq, *(torch.from_numpy(t) for t in (k, v, lw)),
                         chunk=64)
    jo, _ = J.gla_chunked(*(jnp.asarray(t) for t in (q, k, v, lw)),
                          chunk=64)
    # JAX's forward at constant LW_MIN: within 2e-3 (see the test above)
    np.testing.assert_allclose(o.detach().numpy(), np.asarray(jo),
                               rtol=2e-3, atol=2e-3)
    o.sum().backward()
    q64 = torch.from_numpy(q).double().requires_grad_(True)
    kv = torch.from_numpy(k).double()[..., :, None] \
        * torch.from_numpy(v).double()[..., None, :]
    S, total = torch.zeros(q.shape[:2] + (8, 8), dtype=torch.float64), 0
    for t in range(q.shape[2]):
        S = S * float(np.exp(P.LW_MIN)) + kv[:, :, t]
        total = total + (q64[:, :, t, None, :] @ S).sum()
    total.backward()
    assert torch.isfinite(tq.grad).all()
    np.testing.assert_allclose(tq.grad.numpy(), q64.grad.numpy(),
                               rtol=1e-3, atol=1e-3)


def _naive_torch64(q, k, v, lw, bonus, s0):
    """``naive64`` in torch float64, differentiable, from state s0."""
    lw = lw.clamp(P.LW_MIN, -1e-6)
    S, out = s0, []
    for t in range(q.shape[2]):
        kv = k[:, :, t, :, None] * v[:, :, t, None, :]
        if bonus is None:
            S = S * torch.exp(lw[:, :, t])[..., None] + kv
            out.append(torch.einsum("bhk,bhkv->bhv", q[:, :, t], S))
        else:
            out.append(torch.einsum("bhk,bhkv->bhv", q[:, :, t],
                                    S + bonus[None, :, :, None] * kv))
            S = S * torch.exp(lw[:, :, t])[..., None] + kv
    return torch.stack(out, 2), S


@pytest.mark.parametrize("bonus", [False, True])
def test_grad_at_chunk_128_matches_jax_grad(bonus):
    """Moderate decay (``_inputs``' 0.3 x a log-normal), T=256 at chunk
    128 from a carried state: 8 sub-tiles and the inter-chunk carry, where
    JAX's gradient is finite. The gradient in q, k, v, lw, the bonus and
    the state of sum(o * R1) + sum(S * R2) against ``jax.grad`` and the
    float64 recurrence's autograd, each within rtol 1e-4 and atol 1e-5 x
    the leaf's max |g|: each package's float32 gradient lies up to 3.7e-6
    x max |g| from float64 here (the sub-tile factors summed in other
    orders), so two such runs lie within twice that."""
    import jax
    q, k, v, lw, u, s0 = _inputs(41, T=256, state=True)
    rng = np.random.default_rng(9)
    r1 = rng.normal(size=v.shape).astype(np.float32)
    r2 = rng.normal(size=s0.shape).astype(np.float32)
    b = u if bonus else None

    def jloss(q, k, v, lw, s0, u):
        o, s = J.gla_chunked(q, k, v, lw, chunk=128,
                             bonus=u if bonus else None, state=s0)
        return (o * r1).sum() + (s * r2).sum()

    jg = jax.grad(jloss, argnums=tuple(range(6)))(
        *(jnp.asarray(a) for a in (q, k, v, lw, s0, u)))
    names = ("q", "k", "v", "lw", "s0", "u")[:6 if bonus else 5]
    for dtype, fn in ((torch.float32, None), (torch.float64, _naive_torch64)):
        ts = [torch.from_numpy(a).to(dtype).requires_grad_(True)
              for a in (q, k, v, lw, s0, u)]
        if fn is None:
            o, s = P.gla_chunked(*ts[:4], chunk=128,
                                 bonus=ts[5] if bonus else None, state=ts[4])
        else:
            o, s = fn(*ts[:4], ts[5] if bonus else None, ts[4])
        ((o * torch.from_numpy(r1).to(dtype)).sum()
         + (s * torch.from_numpy(r2).to(dtype)).sum()).backward()
        grads = [t.grad.numpy() for t in ts[:len(names)]]
        if fn is None:
            port = grads
        else:
            f64 = grads
    for i, name in enumerate(names):
        want = np.asarray(jg[i])
        assert np.isfinite(want).all() and np.abs(want).max() > 0, name
        for ref, what in ((want, "jax.grad"), (f64[i], "float64")):
            np.testing.assert_allclose(
                port[i], ref, rtol=1e-4, atol=1e-5 * np.abs(ref).max(),
                err_msg=f"{name} vs {what}")


@pytest.mark.parametrize("T", [20, 100, 130])
def test_both_refuse_what_does_not_sub_tile(T):
    q, k, v, lw, u, _ = _inputs(4, T=T)
    with pytest.raises(TypeError):
        J.gla_chunked(*(jnp.asarray(a) for a in (q, k, v, lw)), chunk=128,
                      bonus=jnp.asarray(u))
    with pytest.raises(ValueError, match="sub-tiles"):
        P.gla_chunked(*(torch.from_numpy(a) for a in (q, k, v, lw)),
                      chunk=128, bonus=torch.from_numpy(u))
    assert [P.chunk_for(t, 128) for t in (5, 7, 16, 32, 48, 128, 256)] == \
        [5, 7, 16, 32, 48, 128, 128]
