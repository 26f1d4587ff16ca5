"""Production and local device meshes (torch DeviceMesh).

Functions, not module-level constants: importing this module touches no
process group.  The production meshes keep the reference's shapes, so the
dry-run's grid matches it cell for cell; the dry-run builds them over a
fake process group of 256 or 512 ranks.
"""
from __future__ import annotations

import torch

from ..kernels.ops import resolve_device


def _mesh(device: str, shape: tuple, names: tuple):
    from torch.distributed.device_mesh import DeviceMesh
    dev = resolve_device(device)
    return DeviceMesh(dev.type, torch.arange(
        int(torch.tensor(shape).prod())).reshape(shape),
        mesh_dim_names=names)


def make_production_mesh(*, multi_pod: bool = False, device="cuda"):
    """Single pod: 16x16 = 256 devices ('data', 'model').
    Multi-pod:  2x16x16 = 512 devices ('pod', 'data', 'model').
    Needs a default process group of that many ranks."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(device, shape, axes)


def make_local_mesh(model: int = 1, device="cuda"):
    """(world // model, model) ('data', 'model') mesh over the ranks of
    the default process group, on the card unless device="cpu" (CUDA
    asked for and missing raises)."""
    import torch.distributed as dist
    n = dist.get_world_size()
    if n % model:
        raise ValueError(f"world {n} does not split into model={model}")
    return _mesh(device, (n // model, model), ("data", "model"))
