"""Optimizer substrate, from scratch, as the JAX package's."""
from repro_torch.optim.adamw import (  # noqa: F401
    adamw_init,
    adamw_init_rows,
    adamw_update,
    adamw_update_rows,
    clip_by_global_norm,
    clip_by_row_norm,
    linear_decay_schedule,
)
