"""GPipe pipeline parallelism over a mesh axis with point-to-point sends.

The port of ``repro.distributed.pipeline``: stage s holds layers
[s*L/S, (s+1)*L/S); microbatches stream through the stages on an
(M + S - 1)-step schedule, each step a ring shift of activations from
stage s to s+1 (``dist.batch_isend_irecv`` over the axis's group), and
the last stage's outputs go to every stage at the end. The ring shift is
an autograd function whose backward shifts the gradient the other way,
and the final combine (a SUM all-reduce of the last stage's outputs and
the others' zeros) passes each rank's gradient straight back, the
gradient of one loss computed alike on every rank. (``torch.distributed
.nn``'s all-reduce would all-reduce the gradients too, S times the
gradient of that one loss.) So a backward through ``pipeline_apply``
runs the GPipe backward schedule; stage bodies recompute their
activations under ``torch.utils.checkpoint``, as JAX's
``jax.checkpoint``.
"""
from __future__ import annotations

import torch
import torch.distributed as dist
from torch.utils.checkpoint import checkpoint

from repro_torch.utils.tree import tree_map


def _shift(x, group, step: int):
    """Send ``x`` to the rank ``step`` places on in the ring and return
    what the rank ``step`` places back sent."""
    n, me = dist.get_world_size(group), dist.get_rank(group)
    send = x.contiguous()
    recv = torch.empty_like(send)
    ops = [dist.P2POp(dist.isend, send,
                      dist.get_global_rank(group, (me + step) % n), group),
           dist.P2POp(dist.irecv, recv,
                      dist.get_global_rank(group, (me - step) % n), group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return recv


class _RingShift(torch.autograd.Function):
    """Stage s -> s+1 forward; the gradient goes s+1 -> s."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _shift(x, group, 1)

    @staticmethod
    def backward(ctx, g):
        return _shift(g, ctx.group, -1), None


class _Combine(torch.autograd.Function):
    """The sum over the group forward; each rank's gradient as it is."""

    @staticmethod
    def forward(ctx, x, group):
        x = x.clone()
        dist.all_reduce(x, op=dist.ReduceOp.SUM, group=group)
        return x

    @staticmethod
    def backward(ctx, g):
        return g, None


def pipeline_apply(stage_fn, stage_params, x_micro, mesh,
                   axis: str = "pod"):
    """Run microbatches through pipeline stages laid out on ``axis``.

    stage_fn(params_one_stage, x_mb) -> y_mb (same shape).
    stage_params: nested dict stacked on a leading S dim (S = the axis's
    size); each rank applies its own stage, ``[rank on the axis]``.
    x_micro: [M, mb, ...] microbatches, the same on every stage.
    Returns y_micro [M, mb, ...] on every stage.
    """
    group = mesh.get_group(axis)
    S = dist.get_world_size(group)
    idx = mesh.get_local_rank(axis)
    M = x_micro.shape[0]
    params = tree_map(lambda a: a[idx], stage_params)
    # JAX's selects: every step's shift and stage stay in every rank's
    # graph, so the backward's shifts pair up on all ranks in one order
    first = torch.tensor(idx == 0, device=x_micro.device)
    last = torch.tensor(idx == S - 1, device=x_micro.device)
    zero = torch.zeros_like(x_micro[0])
    outs = [None] * M
    send = zero
    for t in range(M + S - 1):
        recv = _RingShift.apply(send, group)
        x_in = torch.where(first, x_micro[min(t, M - 1)], recv)
        y = checkpoint(stage_fn, params, x_in, use_reentrant=False)
        if t >= S - 1:
            # the last stage commits microbatch t - (S - 1)
            outs[t - (S - 1)] = torch.where(last, y, zero)
        send = y
    # the last stage's outputs to every stage: the others add zeros
    return _Combine.apply(torch.stack(outs), group)


def stack_stages(layer_params, num_stages: int):
    """[L, ...] stacked layer params -> [S, L/S, ...] per-stage stacks."""
    def re(a):
        L = a.shape[0]
        assert L % num_stages == 0, (L, num_stages)
        return a.reshape((num_stages, L // num_stages) + tuple(a.shape[1:]))
    return tree_map(re, layer_params)
