"""Device resolution for the port's entry points: the card by default."""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means the card. A CUDA device that is absent raises: the
    port never falls back to the CPU quietly; pass ``device="cpu"``."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "a CUDA device was requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run on the host")
    return dev


# devices whose tensors the kernel wrappers hand to their plain versions:
# the host, and ``meta`` (shapes and dtypes only: the dry run)
PLAIN_DEVICES = ("cpu", "meta")


def generator(device, seed: int):
    """A ``torch.Generator`` on ``device`` seeded with ``seed``; None on
    ``meta``, where nothing is drawn (a meta tensor carries a shape and
    a dtype only)."""
    dev = torch.device(device)
    if dev.type == "meta":
        return None
    return torch.Generator(device=dev).manual_seed(seed)
