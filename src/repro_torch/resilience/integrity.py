"""Record / checkpoint integrity: crc32 checksums + the error types.

Checksums cover dtype, shape, AND payload bytes, so a bit flip, a
truncation, and a silent dtype change are all detected. Same functions as
``repro.resilience.integrity`` (byte-equal checksums on byte-equal
records and files).
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


class CheckpointCorruptError(Exception):
    """A checkpoint payload failed its manifest checksum / size check."""


def array_crc(arr: np.ndarray) -> int:
    """crc32 of one array's dtype + shape + contiguous payload bytes."""
    a = np.ascontiguousarray(arr)
    head = f"{a.dtype.str}:{a.shape}".encode()
    return zlib.crc32(a.tobytes(), zlib.crc32(head)) & 0xFFFFFFFF


def record_crc(rec: Dict[str, np.ndarray]) -> Dict[str, int]:
    """Per-field checksums for one profile record."""
    return {k: array_crc(np.asarray(v)) for k, v in rec.items()}


def file_crc(path: str, chunk: int = 1 << 20):
    """(crc32, nbytes) of a file, streamed — checkpoint payloads."""
    crc, n = 0, 0
    with open(path, "rb") as f:
        while True:
            buf = f.read(chunk)
            if not buf:
                break
            crc = zlib.crc32(buf, crc)
            n += len(buf)
    return crc & 0xFFFFFFFF, n
