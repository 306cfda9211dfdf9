"""Atomic, async, keep-last-k checkpoints with exact resume."""
from repro_torch.checkpoint.manager import CheckpointManager  # noqa: F401
