"""AdamW + schedules (paper: AdamW, linear decay), the port of
``repro.optim.adamw``.

The optimizer state mirrors the param tree: ``{"m", "v"}`` in fp32 and
``step`` an int32 scalar tensor, the JAX package's tree, so a state
carried across by ``repro_torch.bridge`` continues in either package. The
arithmetic is JAX's, in fp32 (bias corrections ``b1 ** step`` included).
The slot-packed row variants (``adamw_init_rows``, ``clip_by_row_norm``,
``adamw_update_rows``) serve the roster's gang step: every leaf is
``[S, ...]`` with the slot axis first, and ``step`` is per row.
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


def adamw_init_rows(params, num_rows: int) -> dict:
    """Row-packed optimizer state for slot-axis tables (the training
    roster): moments mirror the ``[S, ...]`` leaves, and ``step`` is PER
    ROW ([S] int32), so bias correction restarts from zero when a slot is
    re-admitted for a new profile."""
    def zeros(t):
        return tree_map(lambda x: torch.zeros(x.shape, dtype=torch.float32,
                                              device=x.device), t)
    dev = tree_leaves(params)[0].device
    return {"m": zeros(params), "v": zeros(params),
            "step": torch.zeros((num_rows,), dtype=torch.int32, device=dev)}


def _bcast_rows(x, like):
    """Broadcast a per-row [S] vector over a [S, ...] leaf."""
    return x.reshape((x.shape[0],) + (1,) * (like.ndim - 1))


def clip_by_row_norm(grads, max_norm: float):
    """Per-row global-norm clip over slot-packed grads (axis 0 = slot):
    each row is clipped against its OWN norm across all leaves, so one
    slot's gradient spike never rescales another slot's update. Returns
    (clipped grads, the [S] norms before clipping)."""
    sq = [torch.sum(torch.square(g.float()), dim=tuple(range(1, g.ndim)))
          for g in tree_leaves(grads)]
    gn = torch.sqrt(sum(sq))
    scale = torch.clamp(max_norm / torch.clamp(gn, min=1e-9), max=1.0)
    return tree_map(lambda g: g * _bcast_rows(scale, g).to(g.dtype),
                    grads), gn


def adamw_update_rows(grads, opt_state, params, active, *, lr, b1=0.9,
                      b2=0.999, eps=1e-8, weight_decay=0.0):
    """Slot-packed AdamW: every leaf is [S, ...], ``active`` a [S] bool.
    Rows where ``active`` is False keep their params AND moments bit for
    bit (a zero gradient through plain Adam would still decay m and v);
    the per-row ``step`` advances only for active rows. Returns
    (new_params, new_opt_state)."""
    step = opt_state["step"] + active.to(torch.int32)
    lr_t = lr(step) if callable(lr) else lr
    # inactive rows have step 0: clamp so the bias corrections never hit
    # zero (their values are discarded by the where below)
    s = torch.clamp(step, min=1).to(torch.float32)
    c1 = 1 - torch.tensor(b1, dtype=torch.float32, device=s.device) ** s
    c2 = 1 - torch.tensor(b2, dtype=torch.float32, device=s.device) ** s

    def upd(g, m, v, p):
        g32 = g.float()
        m_new = b1 * m + (1 - b1) * g32
        v_new = b2 * v + (1 - b2) * torch.square(g32)
        delta = (m_new / _bcast_rows(c1, g)) \
            / (torch.sqrt(v_new / _bcast_rows(c2, g)) + eps)
        if weight_decay:
            delta = delta + weight_decay * p.float()
        lt = _bcast_rows(lr_t, g) if getattr(lr_t, "ndim", 0) else lr_t
        p_new = (p.float() - lt * delta).to(p.dtype)
        a = _bcast_rows(active, g)
        return (torch.where(a, p_new, p), torch.where(a, m_new, m),
                torch.where(a, v_new, v))

    out = tree_map(upd, grads, opt_state["m"], opt_state["v"], params)

    def pick(i):
        return tree_map(lambda o: o[i], out)
    return pick(0), {"m": pick(1), "v": pick(2), "step": step}


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
