"""Distributed-optimization collectives: int8 gradient compression with
error feedback for the slow-tier all-reduce.

The port of ``repro.distributed.collectives`` over a
``torch.distributed`` process group (a mesh dimension's:
``mesh.get_group(axis)``) in place of a ``shard_map`` axis name. The
arithmetic is JAX's: an all-reduce MAX agrees the scale (one scalar),
each rank quantizes to int8 on that scale, and an all-reduce SUM of the
int8 values in int32 carries the payload (a quarter of fp32's bytes on a
link that moves int8; gloo and NCCL sum int32, so the wire carries
int32 here).
"""
from __future__ import annotations

import torch
import torch.distributed as dist


def quantize_int8(x, scale):
    return torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)


def dequantize_int8(q, scale):
    return q.to(torch.float32) * scale


def _scale(x, group):
    amax = x.abs().max().reshape(1)
    dist.all_reduce(amax, op=dist.ReduceOp.MAX, group=group)
    return torch.clamp(amax, min=1e-12)[0] / 127.0


def _int_sum(q, group):
    s = q.to(torch.int32)
    dist.all_reduce(s, op=dist.ReduceOp.SUM, group=group)
    return s


def compressed_psum(x, group):
    """The sum of ``x`` over ``group``'s ranks with an int8 payload: a
    MAX all-reduce of max|x| agrees the scale, then the int8 values sum
    in int32."""
    x = x.to(torch.float32)
    scale = _scale(x, group)
    s = _int_sum(quantize_int8(x, scale), group)
    return s.to(torch.float32) * scale


def compressed_psum_ef(x, err, group):
    """Error-feedback variant: returns (sum, new_err). ``err`` is this
    rank's residual carried across steps; the quantization bias goes
    back in at the next step."""
    x = x.to(torch.float32) + err
    scale = _scale(x, group)
    q = quantize_int8(x, scale)
    new_err = x - dequantize_int8(q, scale)
    s = _int_sum(q, group)
    return s.to(torch.float32) * scale, new_err


def tree_compressed_psum_ef(grads, errs, group):
    """``compressed_psum_ef`` over every leaf of a nested dict."""
    if isinstance(grads, dict):
        pairs = {k: tree_compressed_psum_ef(grads[k], errs[k], group)
                 for k in grads}
        return ({k: v[0] for k, v in pairs.items()},
                {k: v[1] for k, v in pairs.items()})
    return compressed_psum_ef(grads, errs, group)
