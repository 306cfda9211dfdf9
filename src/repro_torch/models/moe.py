"""Mixture-of-Experts with sort-based capacity dispatch.

The port of ``repro.models.moe``: the local path (``_moe_local``) and the
expert-parallel path (``_moe_shard_map``), taken under JAX's condition
(``ep_mesh``: an active mesh with a "model" axis dividing the experts,
``moe_impl="sort"``). Layouts are JAX's: ``router [d, E]`` in fp32,
``ew_g``/``ew_u [E, d, ff]``, ``ew_d [E, ff, d]``.

Expert parallelism, as JAX's: the tokens are the rank's batch rows,
whole over "model", and each "model" peer holds E / model experts (a
block, or its slice of whole weights). Every peer routes all its tokens
(the capacity from its own token count), dispatches onto its own
experts, combines their outputs in the fixed order below, and one sum
over "model" (gathered, added in rank order) combines the peers; under
autograd the aux is averaged over the batch axes. For the gradient the
tokens enter the experts, and the route weights the combine, through
Megatron's f (identity forward, the gradient summed over "model"
backward), and the peer sum's backward is the identity: every peer then
holds the whole gradient of x and of the router, and its experts' own.

Routing follows ``moe.py:55-95`` op for op: fp32 router logits, softmax,
``top_k``, the weights renormalised by their sum; with
``moe_impl="sort"`` the routes are stably argsorted by expert id, each
route's rank within its expert found through ``searchsorted``, and every
route ranked at or past the capacity ``C`` (``capacity``) dropped. The
expert GEMMs run over the ``[E, C, d]`` buffer, empty rows included, as
plain ``torch.bmm`` (JAX leaves them to XLA).

Determinism, on the card as on the CPU:

- ``top_k`` is the first k of a stable descending sort, so tied
  probabilities select the lower expert ids, as ``jax.lax.top_k`` does
  (``torch.topk`` promises no tie order);
- the drop is an explicit validity mask: a dropped route's destination is
  a scratch row past the buffer's ``E * C`` rows, which no GEMM reads, and
  its combine reads an all-zero row (torch has no ``mode="drop"``);
- every index write (dispatch, ranks, the combine's backward) writes or
  adds each kept row once, so no float atomics decide a value;
- the combine sums each token's k weighted expert outputs one at a time
  into zeros, in ascending expert id, in ``y``'s dtype: the stable
  expert-sorted order in which JAX's scatter-add ``out.at[st].add`` meets
  a token's routes;
- the dispatch broadcasts each token to its k routes, so the backward sums
  a token's k row gradients in one fixed-order reduction (no scatter-add).
"""
from __future__ import annotations

import torch

from repro_torch.distributed import ctx as CTX
from repro_torch.distributed import sharding as SH
from repro_torch.models.common import activation, dense_init


def init_moe(cfg, dtype, *, generator: torch.Generator, device) -> dict:
    d, ff, E = cfg.d_model, cfg.d_ff, cfg.num_experts
    kw = dict(generator=generator, device=device)
    return {
        "router": dense_init((d, E), d, torch.float32, **kw),
        "ew_g": dense_init((E, d, ff), d, dtype, **kw),
        "ew_u": dense_init((E, d, ff), d, dtype, **kw),
        "ew_d": dense_init((E, ff, d), ff, dtype, **kw),
    }


def capacity(tokens: int, cfg) -> int:
    c = int(tokens * cfg.top_k * cfg.capacity_factor / cfg.num_experts)
    return max(cfg.top_k, min(tokens, c))


def route(router, x2, k: int):
    """x2 [n, d] -> (gates [n, E] fp32 router logits, probs [n, E], topw
    [n, k] renormalised, topi [n, k] in descending probability)."""
    gates = x2.float() @ router
    probs = torch.softmax(gates, dim=-1)
    topw, topi = torch.sort(probs, dim=-1, descending=True, stable=True)
    topw, topi = topw[:, :k], topi[:, :k]
    topw = topw / torch.clamp(topw.sum(-1, keepdim=True), min=1e-9)
    return gates, probs, topw, topi


def ranks(topi, C: int, E: int):
    """Each route's rank within its expert, in the stable expert-sorted
    order (token-major [n, k]), and whether it fits the capacity C."""
    n, k = topi.shape
    eids = topi.reshape(-1)
    order = torch.argsort(eids, stable=True)
    se = eids[order]
    starts = torch.searchsorted(se, torch.arange(E, device=se.device,
                                                 dtype=se.dtype))
    pos = torch.arange(n * k, device=se.device) - starts[se]
    # back to token-major order; ``order`` is a permutation
    pos = torch.empty_like(pos).scatter_(0, order, pos).view(n, k)
    return pos, pos < C


def ep_mesh(cfg):
    """The active mesh where JAX's ``moe_apply`` takes the expert-parallel
    path (a "model" axis dividing the experts, ``moe_impl="sort"``), else
    None."""
    mesh = CTX.active_mesh()
    if mesh is None or cfg.moe_impl != "sort" or not cfg.num_experts:
        return None
    m = SH.axis_sizes(mesh).get("model")
    return mesh if m and cfg.num_experts % m == 0 else None


def moe_apply(params, x, cfg):
    """x [B, T, d] -> ([B, T, d], aux): the expert-parallel path under
    ``ep_mesh``, else the local path."""
    mesh = ep_mesh(cfg)
    if mesh is not None:
        return _moe_ep(params, x, cfg, mesh)
    return _moe_local(params, x, cfg)


def _moe_local(params, x, cfg):
    B, T, d = x.shape
    n, E, k = B * T, cfg.num_experts, cfg.top_k
    x2 = x.reshape(n, d)
    act = activation(cfg.act)
    _, probs, topw, topi = route(params["router"], x2, k)

    if cfg.moe_impl == "dense":
        # reference path: every expert on every token
        g = torch.einsum("td,edf->tef", x2, params["ew_g"])
        u = torch.einsum("td,edf->tef", x2, params["ew_u"])
        y_all = torch.einsum("tef,efd->ted", act(g) * u, params["ew_d"])
        comb = torch.zeros((n, E), dtype=torch.float32,
                           device=x.device).scatter(1, topi, topw)
        y = torch.einsum("te,ted->td", comb.to(y_all.dtype), y_all)
        return y.reshape(B, T, d), aux_loss(probs, topi, E)

    C = capacity(n, cfg)
    pos, keep = ranks(topi, C, E)
    out = _dispatch(x2, topw, topi, pos, keep, params, C, 0, E, act)
    return out.reshape(B, T, d), aux_loss(probs, topi, E)


def _dispatch(x2, topw, topi, pos, keep, experts, C: int, lo: int,
              n_exp: int, act):
    """The sort dispatch onto experts [lo, lo + n_exp) (``experts``' leaves
    hold exactly those), their GEMMs and the combine of their routes:
    [n, d], zero rows for tokens routed elsewhere."""
    n, k = topi.shape
    d = x2.shape[1]
    # kept routes' buffer rows; dropped and foreign ones go to the scratch
    # row n_exp * C
    mine = keep & (topi >= lo) & (topi < lo + n_exp)
    dest = torch.where(mine, (topi - lo) * C + pos, n_exp * C)
    rows = x2[:, None, :].expand(n, k, d).reshape(n * k, d)
    buf = x2.new_zeros((n_exp * C + 1, d)).index_put((dest.reshape(-1),),
                                                      rows)
    buf = buf[:n_exp * C].view(n_exp, C, d)
    g = torch.bmm(buf, experts["ew_g"])
    u = torch.bmm(buf, experts["ew_u"])
    y = torch.bmm(act(g) * u, experts["ew_d"])
    y = torch.cat([y.reshape(n_exp * C, d), y.new_zeros((1, d))])

    # each token's routes in ascending expert id, summed one at a time
    perm = torch.argsort(topi, dim=1)
    dest = torch.gather(dest, 1, perm)
    w = torch.gather(topw, 1, perm).to(y.dtype)
    # index_select: its backward adds each kept row's gradient once (the
    # scratch row, which dropped routes share, is sliced off); advanced
    # indexing's backward sorts every index first, 1.4 ms a layer at
    # 4,096 routes on the card
    contrib = y.index_select(0, dest.reshape(-1)).view(n, k, d) \
        * w[..., None]
    out = torch.zeros((n, d), dtype=y.dtype, device=y.device)
    for j in range(k):
        out = out + contrib[:, j]
    return out


class _CopyToModel(torch.autograd.Function):
    """Megatron's f over "model": the identity forward, the gradient
    summed over the "model" peers (in rank order) backward."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return SH.rank_sum(g.contiguous(), ctx.mesh, "model"), None


class _SumOverModel(torch.autograd.Function):
    """Megatron's g over "model": the peers' partial outputs summed in
    rank order forward, the identity backward."""

    @staticmethod
    def forward(ctx, x, mesh):
        return SH.rank_sum(x, mesh, "model")

    @staticmethod
    def backward(ctx, g):
        return g, None


class _MeanOverBatch(torch.autograd.Function):
    """A scalar averaged over the batch axes forward (JAX's ``pmean``), the
    identity backward: each rank's loss then carries its own rows' aux
    gradient, which the train step's gradient mean averages."""

    @staticmethod
    def forward(ctx, x, mesh):
        sizes = SH.axis_sizes(mesh)
        for a in SH.batch_axes(mesh):
            if sizes[a] > 1:
                x = SH.rank_sum(x, mesh, a) / sizes[a]
        return x

    @staticmethod
    def backward(ctx, g):
        return g, None


def _expert_slice(w, lo: int, n_exp: int):
    """A peer's experts of an expert leaf: the leaf itself where it is
    the peer's block, else its rows [lo, lo + n_exp)."""
    return w if w.shape[0] == n_exp else w[lo:lo + n_exp]


def _moe_ep(params, x, cfg, mesh):
    """JAX's ``_moe_shard_map`` on this rank's tokens and its "model"
    peer's experts."""
    B, T, d = x.shape
    n, E, k = B * T, cfg.num_experts, cfg.top_k
    n_exp = E // SH.axis_sizes(mesh)["model"]
    lo = mesh.get_local_rank("model") * n_exp
    experts = {key: _expert_slice(params[key], lo, n_exp)
               for key in ("ew_g", "ew_u", "ew_d")}
    x2 = x.reshape(n, d)
    _, probs, topw, topi = route(params["router"], x2, k)
    C = capacity(n, cfg)
    pos, keep = ranks(topi, C, E)
    out = _dispatch(_CopyToModel.apply(x2, mesh),
                    _CopyToModel.apply(topw, mesh), topi, pos, keep,
                    experts, C, lo, n_exp, activation(cfg.act))
    out = _SumOverModel.apply(out, mesh)
    aux = aux_loss(probs, topi, E)
    if torch.is_grad_enabled():
        # training: every rank steps in lockstep. Serving drops the aux,
        # and its data ranks' forwards do not run in step (each admits its
        # own slots), so it makes no collective across them
        aux = _MeanOverBatch.apply(aux, mesh)
    return out.reshape(B, T, d), aux


def aux_loss(probs, topi, E: int):
    """Switch-style load-balance loss: E * sum(f_e * p_e)."""
    # one-hot by comparison: F.one_hot checks its indices on the host
    hot = (topi[:, :1] == torch.arange(E, device=topi.device)).to(
        torch.float32)
    return E * torch.sum(hot.mean(0) * probs.mean(0))
