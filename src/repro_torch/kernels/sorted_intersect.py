"""Batched id-list intersection of the connectivity check (paper Alg. 3):
bindings of ``csrc/intersect_any.cu``.

For pairs p < P, a [P, A] and b [P, B] (int32, -1 padded, rows in any
order):

    hit[p] = 1 iff the valid (>= 0) entries of a[p] and b[p] intersect

The CUDA kernel replaces
``repro.kernels.sorted_intersect.intersect_any_pallas``; its plain versions
are ``ref.intersect_any_sorted`` and the compare oracle
``ref.intersect_any_ref``.

``intersect_any_ragged_cuda`` runs the same test over ragged rows of valid
ids, pair p's rows ``a_ids[a_off[p]:a_off[p+1]]`` and
``b_ids[b_off[p]:b_off[p+1]]`` (any order, duplicates allowed), so no
padding is read or uploaded.  Its plain version is
``ref.intersect_any_ragged_ref``.  Both entry points count as launches of
``KERNEL``.
"""
from __future__ import annotations

import torch

from ._build import INT, PTR, CudaKernel, check_cuda_int32, ptr

RAGGED = "intersect_any_ragged"
KERNEL = CudaKernel("intersect_any", "intersect_any",
                    [PTR, INT, PTR, INT, INT, PTR],
                    entries={RAGGED: [PTR, INT, PTR, PTR, INT, PTR, INT,
                                      PTR]})


def intersect_any_cuda(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """hit [P] int32 for contiguous int32 CUDA tensors a [P, A], b [P, B]."""
    check_cuda_int32(a, b)
    if a.dim() != 2 or b.dim() != 2 or a.shape[0] != b.shape[0]:
        raise ValueError("expected a [P, A] and b [P, B]")
    p = a.shape[0]
    out = torch.empty(p, dtype=torch.int32, device=a.device)
    if p:
        KERNEL.launch(ptr(a), a.shape[1], ptr(b), b.shape[1], p, ptr(out))
    return out


def intersect_any_ragged_cuda(a_ids: torch.Tensor, a_off: torch.Tensor,
                              b_ids: torch.Tensor,
                              b_off: torch.Tensor) -> torch.Tensor:
    """hit [P] int32 for contiguous int32 CUDA tensors: ids [N] and
    offsets [P + 1] of each side.  The offsets' values are not read on
    the host; the kernel clips them to the ids."""
    check_cuda_int32(a_ids, a_off, b_ids, b_off)
    if any(t.dim() != 1 for t in (a_ids, a_off, b_ids, b_off)):
        raise ValueError("expected 1-D ids and offsets")
    if a_off.shape != b_off.shape or a_off.shape[0] < 1:
        raise ValueError("expected a_off and b_off of one length P + 1 >= 1")
    if max(a_ids.shape[0], b_ids.shape[0]) >= 1 << 31:
        raise ValueError("at most 2^31 - 1 ids a side")
    p = a_off.shape[0] - 1
    out = torch.empty(p, dtype=torch.int32, device=a_ids.device)
    if p:
        KERNEL.launch(ptr(a_ids), a_ids.shape[0], ptr(a_off), ptr(b_ids),
                      b_ids.shape[0], ptr(b_off), p, ptr(out), symbol=RAGGED)
    return out
