"""Deterministic synthetic multi-profile data (numpy only) and the
sharded, resumable loader over it."""
from repro_torch.data.synthetic import (  # noqa: F401
    MarkovLM,
    ProfileClassification,
)
from repro_torch.data.loader import ShardedLoader  # noqa: F401
