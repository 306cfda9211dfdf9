"""Resilience layer: seeded fault injection, retry/degrade primitives, and
record/checkpoint integrity (the port of ``repro.resilience``).

- `faults.py`     — `FaultPlan`: a seeded, declarative chaos plan injected
                    behind thin seams (ServeEngine admission hydration,
                    ProfileStore corruption, the gang step's gradient
                    poisoning, checkpoint truncation).
                    `None` everywhere = production behavior, zero overhead.
- `retry.py`      — `retry_with_backoff` + `RetryPolicy`: deadline-bounded
                    jittered exponential backoff (admission hydration).
- `integrity.py`  — crc32 checksums over store records / checkpoint
                    payloads and the error types the hot paths catch
                    (`RecordIntegrityError`, `CheckpointCorruptError`).

Every profile is a tiny mask over ONE shared frozen PLM, so the bare PLM
(a zero-adapter mask) is always resident and always valid: a hydration
failure degrades a request to it instead of failing the wave.
"""
from repro_torch.resilience.faults import (FaultPlan, InjectedFault,
                                           InjectedHydrationError)
from repro_torch.resilience.integrity import (CheckpointCorruptError,
                                              RecordIntegrityError,
                                              array_crc, file_crc,
                                              record_crc)
from repro_torch.resilience.retry import RetryPolicy, retry_with_backoff

__all__ = [
    "FaultPlan", "InjectedFault", "InjectedHydrationError",
    "RecordIntegrityError", "CheckpointCorruptError",
    "array_crc", "record_crc", "file_crc",
    "RetryPolicy", "retry_with_backoff",
]
