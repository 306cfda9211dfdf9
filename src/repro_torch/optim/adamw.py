"""AdamW + schedules (paper: AdamW, linear decay), the port of
``repro.optim.adamw``.

The optimizer state mirrors the param tree: ``{"m", "v"}`` in fp32 and
``step`` an int32 scalar tensor, the JAX package's tree, so a state
carried across by ``repro_torch.bridge`` continues in either package. The
arithmetic is JAX's, in fp32 (bias corrections ``b1 ** step`` included).
The slot-packed row variants (``*_rows``, ``clip_by_row_norm``) come with
the gang step, ROADMAP queue 1, item 8.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.utils.tree import tree_leaves, tree_map


def linear_decay_schedule(base_lr: float, total_steps: int,
                          warmup_steps: int = 0) -> Callable:
    """step -> lr (an fp32 scalar tensor): linear warm-up over
    ``warmup_steps``, then linear decay to 0 at ``total_steps``."""
    def sched(step):
        step = torch.as_tensor(step).to(torch.float32)
        warm = torch.clamp(step / max(warmup_steps, 1), max=1.0)
        frac = torch.clamp((total_steps - step)
                           / max(total_steps - warmup_steps, 1), 0.0, 1.0)
        return base_lr * torch.where(step < warmup_steps, warm, frac)
    return sched


def adamw_init(params) -> dict:
    """Zero moments in fp32 beside each leaf, and step 0 (int32)."""
    def zeros(t):
        return tree_map(lambda x: torch.zeros(x.shape, dtype=torch.float32,
                                              device=x.device), t)
    dev = tree_leaves(params)[0].device
    return {"m": zeros(params), "v": zeros(params),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def clip_by_global_norm(grads, max_norm: float):
    """(grads scaled to a global L2 norm of at most ``max_norm``, the norm
    before clipping as an fp32 scalar)."""
    gn = torch.sqrt(sum(torch.sum(torch.square(g.float()))
                        for g in tree_leaves(grads)))
    scale = torch.clamp(max_norm / torch.clamp(gn, min=1e-9), max=1.0)
    return tree_map(lambda g: g * scale.to(g.dtype), grads), gn


def adamw_update(grads, opt_state, params, *, lr, b1=0.9, b2=0.999,
                 eps=1e-8, weight_decay=0.0):
    """Returns (new_params, new_opt_state). ``lr`` may be a schedule of the
    step or a scalar. Each leaf updates in fp32 and is cast back to its
    param's dtype."""
    step = opt_state["step"] + 1
    lr_t = lr(step) if callable(lr) else lr
    s = step.to(torch.float32)
    c1 = 1 - torch.tensor(b1, dtype=torch.float32, device=s.device) ** s
    c2 = 1 - torch.tensor(b2, dtype=torch.float32, device=s.device) ** s

    def upd(g, m, v, p):
        g32 = g.float()
        m_new = b1 * m + (1 - b1) * g32
        v_new = b2 * v + (1 - b2) * torch.square(g32)
        delta = (m_new / c1) / (torch.sqrt(v_new / c2) + eps)
        if weight_decay:
            delta = delta + weight_decay * p.float()
        return ((p.float() - lr_t * delta).to(p.dtype), m_new, v_new)

    out = tree_map(upd, grads, opt_state["m"], opt_state["v"], params)

    def pick(i):
        return tree_map(lambda o: o[i], out)
    return pick(0), {"m": pick(1), "v": pick(2), "step": step}
