"""Small shared utilities: tree helpers, padding buckets, device
resolution."""
from repro_torch.utils.device import (  # noqa: F401
    PLAIN_DEVICES, generator, resolve_device)
from repro_torch.utils.padding import pow2_bucket, pow2_count  # noqa: F401
from repro_torch.utils.tree import (  # noqa: F401
    leaf_name, map_with_path, map_with_paths, merge_trees, param_bytes,
    param_count, tree_paths, tree_zeros_like)
