"""Record integrity: crc32 checksums over profile records."""
from repro_torch.resilience.integrity import (  # noqa: F401
    RecordIntegrityError, array_crc, record_crc)
