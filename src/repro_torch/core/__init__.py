"""X-PEFT core: adapter bank, masks, admission aggregation, profile store."""
from repro_torch.core import adapters, masks, profiles, xpeft  # noqa: F401
