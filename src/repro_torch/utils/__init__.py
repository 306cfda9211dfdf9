"""Small shared utilities: padding buckets, device resolution."""
from repro_torch.utils.device import resolve_device  # noqa: F401
from repro_torch.utils.padding import pow2_bucket, pow2_count  # noqa: F401
