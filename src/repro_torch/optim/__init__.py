"""Optimizer substrate, from scratch, as the JAX package's."""
from repro_torch.optim.adamw import (  # noqa: F401
    adamw_init,
    adamw_update,
    clip_by_global_norm,
    linear_decay_schedule,
)
