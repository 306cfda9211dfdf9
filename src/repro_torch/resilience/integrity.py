"""Profile-record integrity: crc32 checksums + the error type.

Checksums cover dtype, shape, AND payload bytes, so a bit flip, a
truncation, and a silent dtype change are all detected. Same function as
``repro.resilience.integrity`` (byte-equal checksums on byte-equal
records); the checkpoint half waits for the training slice.
"""
from __future__ import annotations

import zlib
from typing import Dict

import numpy as np


class RecordIntegrityError(Exception):
    """A ProfileStore record failed its checksum (or is quarantined)."""

    def __init__(self, pid: int, keys, reason: str = "checksum mismatch"):
        self.pid = int(pid)
        self.keys = tuple(keys)
        super().__init__(f"profile {pid}: {reason} ({', '.join(self.keys)})")


def array_crc(arr: np.ndarray) -> int:
    """crc32 of one array's dtype + shape + contiguous payload bytes."""
    a = np.ascontiguousarray(arr)
    head = f"{a.dtype.str}:{a.shape}".encode()
    return zlib.crc32(a.tobytes(), zlib.crc32(head)) & 0xFFFFFFFF


def record_crc(rec: Dict[str, np.ndarray]) -> Dict[str, int]:
    """Per-field checksums for one profile record."""
    return {k: array_crc(np.asarray(v)) for k, v in rec.items()}
