"""Device meshes on ``torch.distributed``: the port of
``repro.launch.mesh``.

Single pod: (data=16, model=16). Multi-pod: (pod=2, data=16, model=16);
the pod axis carries only gradient all-reduce (or pipeline stages).

One process per device. ``init_distributed`` joins the process group
``torchrun`` describes in its environment (NCCL on ``cuda``, gloo on
``cpu``, unless the caller names a backend); a mesh is then a
``DeviceMesh`` over that group whose size must equal the world size.
``parse_mesh_spec`` is the ``--mesh`` grammar alone, a pure function.
Nothing here runs at import.
"""
from __future__ import annotations

import os
from typing import Optional, Tuple

import torch
import torch.distributed as dist


def parse_mesh_spec(spec: str) -> Optional[Tuple[tuple, tuple]]:
    """``"4x2:data,model"`` -> ((4, 2), ("data", "model")), or None for
    ``""``: shape "4x2" crossed with axis names "data,model", with JAX's
    error messages."""
    if not spec:
        return None
    try:
        shape_s, axes_s = spec.split(":")
        shape = tuple(int(x) for x in shape_s.split("x"))
        axes = tuple(a for a in axes_s.split(",") if a)
    except ValueError as e:
        raise ValueError(f"bad --mesh {spec!r}; want e.g. 4x2:data,model") \
            from e
    if len(shape) != len(axes):
        raise ValueError(f"--mesh {spec!r}: {len(shape)} dims for "
                         f"{len(axes)} axis names")
    return shape, axes


def init_distributed(device, backend: Optional[str] = None) -> int:
    """Join the process group ``torchrun`` describes (``RANK``,
    ``WORLD_SIZE``, ``MASTER_ADDR``/``MASTER_PORT``, ``LOCAL_RANK``) and
    return this process's rank; a process already in a group keeps it.
    NCCL on a ``cuda`` device and gloo on ``cpu``, unless ``backend`` is
    named. On ``cuda`` the process takes card ``LOCAL_RANK`` modulo the
    cards present."""
    device = torch.device(device)
    if not dist.is_initialized():
        if device.type == "cuda":
            local = int(os.environ.get("LOCAL_RANK", "0"))
            torch.cuda.set_device(local % torch.cuda.device_count())
        dist.init_process_group(
            backend or ("nccl" if device.type == "cuda" else "gloo"))
    return dist.get_rank()


def make_mesh(shape, axes, device_type: str = "cuda"):
    """A ``DeviceMesh`` of ``shape`` named ``axes`` over the initialized
    process group, which must hold exactly prod(shape) processes."""
    from torch.distributed.device_mesh import init_device_mesh

    need = 1
    for s in shape:
        need *= s
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world != need:
        raise ValueError(f"mesh {tuple(shape)} needs {need} processes, the "
                         f"process group has {world}")
    return init_device_mesh(device_type, tuple(shape),
                            mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device_type)


def make_test_mesh(shape=(2, 2), axes=("data", "model"),
                   device_type: str = "cpu"):
    """Small mesh for tests (needs exactly prod(shape) processes)."""
    return make_mesh(shape, axes, device_type)


def parse_mesh(spec: str, device_type: str = "cuda"):
    """``"4x2:data,model"`` -> DeviceMesh (or None for ``""``): the one
    ``--mesh`` grammar every launcher shares."""
    parsed = parse_mesh_spec(spec)
    if parsed is None:
        return None
    return make_mesh(*parsed, device_type)
