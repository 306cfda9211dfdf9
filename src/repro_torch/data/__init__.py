"""Deterministic synthetic multi-profile data (numpy only)."""
from repro_torch.data.synthetic import (  # noqa: F401
    MarkovLM,
    ProfileClassification,
)
