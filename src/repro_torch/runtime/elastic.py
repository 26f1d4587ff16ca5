"""Fault tolerance: elastic re-meshing, step retry.

Failure model: a pod (or slice) drops out mid-run.  The recovery path:

  1. the launcher catches the step failure (`run_with_retries`),
  2. a smaller mesh is built over the surviving ranks (`shrink_mesh` —
     pod 0's ranks, or half of the first axis),
  3. state is restored from the last checkpoint onto the new mesh
     (`Checkpointer.restore(shardings=)`; checkpoints hold global
     arrays, so each rank takes its shard of each leaf) or an in-memory
     tree is `reshard`ed,
  4. training resumes; the deterministic index-based data pipeline
     (data.lm_data) makes the replayed batches identical on any host —
     no data-loader state to recover.
"""
from __future__ import annotations

import logging
import time

import torch

from ..models.param import PS, placements
from ..tree import tree_map

log = logging.getLogger(__name__)


def shrink_mesh(mesh, drop_axis: str = "pod"):
    """A DeviceMesh over the survivors of `mesh` (a DeviceMesh, or
    anything with its `mesh` rank tensor, `mesh_dim_names` and
    `device_type`): without `drop_axis` and pod 0's ranks where the mesh
    has that axis, else half of the first axis.  It is built in the
    current default process group, whose ranks must include the
    survivors'."""
    from torch.distributed.device_mesh import DeviceMesh
    names = list(mesh.mesh_dim_names)
    ranks = mesh.mesh
    if drop_axis in names:
        i = names.index(drop_axis)
        ranks = ranks.select(i, 0)              # keep pod 0's ranks
        names.pop(i)
    else:
        ranks = ranks[: ranks.shape[0] // 2]
    return DeviceMesh(mesh.device_type, ranks.contiguous(),
                      mesh_dim_names=tuple(names))


def place(x, mesh, spec: PS):
    """One leaf onto `mesh` at `spec`: a DTensor on that mesh is
    redistributed; any other tensor or array is a global value of which
    each rank takes its shard (no communication: every rank holds it)."""
    from torch.distributed.tensor import DTensor, distribute_tensor
    pl = placements(spec, mesh)
    if isinstance(x, DTensor):
        if x.device_mesh == mesh:
            return x.redistribute(mesh, pl)
        x = x.full_tensor()
    x = torch.as_tensor(x)
    if not x.is_meta:                     # the dry-run's shapes stay meta
        x = x.to(mesh.device_type)
    return distribute_tensor(x, mesh, pl, src_data_rank=None)


def reshard(tree, mesh, pspecs):
    """Every leaf of `tree` placed on `mesh` by the congruent spec tree."""
    return tree_map(lambda x, s: place(x, mesh, s), tree, pspecs)


def run_with_retries(step_fn, max_retries: int = 3, on_failure=None):
    """Execute step_fn(); on failure invoke on_failure(attempt) (e.g.
    restore-from-checkpoint + re-mesh) and retry."""
    for attempt in range(max_retries + 1):
        try:
            return step_fn()
        except Exception as e:                       # noqa: BLE001
            if attempt == max_retries:
                raise
            log.warning("step failed (%s); recovery attempt %d",
                        e, attempt + 1)
            if on_failure is not None:
                on_failure(attempt)
            time.sleep(0.01)
    raise RuntimeError("unreachable")
