"""Deterministic synthetic multi-profile data.

The port's own copy of ``repro.data.synthetic``, line for line: numpy only,
so both packages draw identical batches from a seed. Two families, both
profile-conditioned so they exercise exactly what X-PEFT personalizes:

- MarkovLM: per-profile sparse bigram transition tables -> profile-dependent
  next-token structure. A model that adapts per profile reaches lower loss
  than any single shared model — the LM analogue of LaMP.
- ProfileClassification: per-profile random linear teachers over
  bag-of-token-features -> (tokens, label, profile_id), the GLUE/LaMP
  classification proxy used by the paper-claim benchmarks.

Everything is hash-seeded and stateless: batch(step) is reproducible from
(seed, step).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


def _rng(*parts) -> np.random.Generator:
    seed = 0x9E3779B97F4A7C15
    for p in parts:
        seed = ((seed ^ (abs(hash(int(p))) & 0xFFFFFFFFFFFFFFFF))
                * 0xBF58476D1CE4E5B9) & 0xFFFFFFFFFFFFFFFF
    return np.random.default_rng(seed % (2 ** 63))


@dataclass
class MarkovLM:
    vocab_size: int
    num_profiles: int
    branch: int = 4          # candidate successors per token per profile
    seed: int = 0

    def _table(self, profile: int) -> np.ndarray:
        g = _rng(self.seed, 1, profile)
        return g.integers(0, self.vocab_size,
                          size=(self.vocab_size, self.branch))

    def sample(self, step: int, batch: int, seq_len: int,
               profile_ids=None):
        """Returns dict(tokens [B,T], labels [B,T], profile_ids [B])."""
        g = _rng(self.seed, 2, step)
        if profile_ids is None:
            profile_ids = g.integers(0, self.num_profiles, size=(batch,))
        toks = np.empty((batch, seq_len), np.int32)
        for i, pid in enumerate(np.asarray(profile_ids)):
            tbl = self._table(int(pid))
            gi = _rng(self.seed, 3, step, i)
            t = np.empty(seq_len, np.int32)
            t[0] = gi.integers(0, self.vocab_size)
            choices = gi.integers(0, self.branch, size=seq_len)
            for j in range(1, seq_len):
                t[j] = tbl[t[j - 1], choices[j]]
            toks[i] = t
        labels = np.concatenate([toks[:, 1:], toks[:, :1]], axis=1)
        return {"tokens": toks, "labels": labels,
                "profile_ids": np.asarray(profile_ids, np.int32)}


@dataclass
class ProfileClassification:
    vocab_size: int
    num_labels: int
    num_profiles: int
    seed: int = 0

    def _teacher(self, profile: int) -> np.ndarray:
        g = _rng(self.seed, 11, profile)
        return g.normal(size=(self.vocab_size, self.num_labels))

    def sample(self, step: int, batch: int, seq_len: int, profile_ids=None):
        g = _rng(self.seed, 12, step)
        if profile_ids is None:
            profile_ids = g.integers(0, self.num_profiles, size=(batch,))
        toks = g.integers(0, self.vocab_size, size=(batch, seq_len))
        labels = np.empty((batch,), np.int32)
        for i, pid in enumerate(np.asarray(profile_ids)):
            W = self._teacher(int(pid))
            counts = np.bincount(toks[i], minlength=self.vocab_size)
            labels[i] = int(np.argmax(counts @ W))
        return {"tokens": toks.astype(np.int32), "labels": labels,
                "profile_ids": np.asarray(profile_ids, np.int32)}
