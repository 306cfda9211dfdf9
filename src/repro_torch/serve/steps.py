"""Serving steps: prefill (forward + KV cache build) and decode (one token
against the cache), the port of ``repro.serve.steps``.

``make_prefill_step`` is how a frontend config's ``prefix_embeds`` (vision
patches, audio frames) reach a cached forward: the prefix rows go into
the cache at positions [0, P) in front of the prompt, and decoding goes on
at ``cache_pos = P + T``. The engine, like JAX's, takes no prefix
embeddings.
"""
from __future__ import annotations

import torch

from repro_torch.models import model as MDL


def make_prefill_step(cfg):
    def prefill(params, tokens, cache, profile_masks=None,
                prefix_embeds=None):
        """tokens [B,T] (and prefix_embeds [B,P,d]) written into ``cache``
        from position 0 -> (logits [B,1,V] of the last position, cache)."""
        hidden, cache, _ = MDL.forward(
            params, tokens, cfg, prefix_embeds=prefix_embeds,
            profile_masks=profile_masks, cache=cache, cache_pos=0)
        logits = MDL.lm_logits(params, hidden[:, -1:, :], cfg)
        return logits, cache
    return prefill


def make_decode_step(cfg):
    def decode(params, tokens, cache, cache_pos, profile_masks=None):
        """tokens [B,1] at ``cache_pos`` (a scalar, or [B] per slot) ->
        (logits [B,1,V], cache)."""
        hidden, cache, _ = MDL.forward(
            params, tokens, cfg, profile_masks=profile_masks,
            cache=cache, cache_pos=cache_pos)
        logits = MDL.lm_logits(params, hidden, cfg)
        return logits, cache
    return decode


def greedy_next(logits):
    """[B, T, V] logits -> [B] int32 argmax of the last position (ties to
    the lowest index, as ``jnp.argmax``)."""
    return torch.argmax(logits[:, -1, :], dim=-1).to(torch.int32)
