"""Model substrate: the transformer LM over stacked layers."""
from repro_torch.models.model import (  # noqa: F401
    forward,
    init_cache,
    init_lm,
    lm_logits,
)
