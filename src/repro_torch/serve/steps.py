"""Serving step helpers."""
from __future__ import annotations

import torch


def greedy_next(logits):
    """[B, T, V] logits -> [B] int32 argmax of the last position (ties to
    the lowest index, as ``jnp.argmax``)."""
    return torch.argmax(logits[:, -1, :], dim=-1).to(torch.int32)
