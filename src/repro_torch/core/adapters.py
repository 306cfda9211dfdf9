"""Shared adapter bank: N Pfeiffer bottleneck adapters per PLM block.

The bank is ONE tensor per submodule, in ``repro.core.adapters``' layout:
``bank_a [L, N, d, b]`` (down-proj) and ``bank_b [L, N, b, d]`` (up-proj).
Heterogeneous (typed-segment) banks wait for ROADMAP queue 1, item 7.
"""
from __future__ import annotations

import math

import torch


def init_adapter_bank(num_layers: int, num_adapters: int, d: int, b: int,
                      dtype=torch.bfloat16, *, generator: torch.Generator,
                      device) -> dict:
    """Random adapter bank (the paper's LTH/supermask setting): down-proj
    N(0, 1/d), up-proj N(0, 0.02^2), drawn in fp32 on ``device`` one leaf
    at a time and cast once."""
    def draw(shape, scale):
        w = torch.randn(shape, generator=generator, device=device,
                        dtype=torch.float32)
        return w.mul_(scale).to(dtype)

    return {"bank_a": draw((num_layers, num_adapters, d, b),
                           1.0 / math.sqrt(d)),
            "bank_b": draw((num_layers, num_adapters, b, d), 0.02)}
