"""Distribution layer: sharding rules and placement, the mesh context,
compressed collectives, the GPipe pipeline, and the fault hooks of the
training loop with its elastic resize (``fault.py``)."""
from repro_torch.distributed import ctx  # noqa: F401
from repro_torch.distributed.sharding import (  # noqa: F401
    P,
    Sharded,
    Sharding,
    batch_specs,
    cache_specs,
    constrain_leading,
    gather,
    leading_axis_specs,
    paged_cache_specs,
    param_specs,
    place,
    shard,
    sharded_bytes_per_device,
    to_shardings,
)
