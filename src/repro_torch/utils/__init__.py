"""Small shared utilities: padding buckets, device resolution."""
from repro_torch.utils.device import (  # noqa: F401
    PLAIN_DEVICES, generator, resolve_device)
from repro_torch.utils.padding import pow2_bucket, pow2_count  # noqa: F401
