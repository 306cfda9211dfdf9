"""Feed-forward blocks: GLU (SwiGLU/GeGLU) and vanilla (BERT-style).

Plain products stay ``torch.matmul``, as the JAX package leaves them to
XLA; the layouts are ``repro.models.mlp``'s (``wg/wu [d, ff]``,
``wd [ff, d]``).
"""
from __future__ import annotations

import torch

from repro_torch.models.common import activation, dense_init


def init_mlp(cfg, dtype, *, generator: torch.Generator, device) -> dict:
    d, ff = cfg.d_model, cfg.d_ff
    kw = dict(generator=generator, device=device)
    if cfg.mlp_type == "glu":
        return {
            "wg": dense_init((d, ff), d, dtype, **kw),
            "wu": dense_init((d, ff), d, dtype, **kw),
            "wd": dense_init((ff, d), ff, dtype, **kw),
        }
    return {
        "w1": dense_init((d, ff), d, dtype, **kw),
        "b1": torch.zeros((ff,), dtype=torch.float32, device=device),
        "w2": dense_init((ff, d), ff, dtype, **kw),
        "b2": torch.zeros((d,), dtype=torch.float32, device=device),
    }


def mlp_apply(params, x, cfg):
    act = activation(cfg.act)
    if cfg.mlp_type == "glu":
        g = x @ params["wg"]
        u = x @ params["wu"]
        return (act(g) * u) @ params["wd"]
    h = x @ params["w1"] + params["b1"].to(x.dtype)
    return act(h) @ params["w2"] + params["b2"].to(x.dtype)
