"""Batched id-list intersection of the connectivity check (paper Alg. 3):
binding of ``csrc/intersect_any.cu``.

For pairs p < P, a [P, A] and b [P, B] (int32, -1 padded, rows in any
order):

    hit[p] = 1 iff the valid (>= 0) entries of a[p] and b[p] intersect

The CUDA kernel replaces
``repro.kernels.sorted_intersect.intersect_any_pallas``; its plain versions
are ``ref.intersect_any_sorted`` and the compare oracle
``ref.intersect_any_ref``.
"""
from __future__ import annotations

import torch

from ._build import INT, PTR, CudaKernel, check_cuda_int32, ptr

KERNEL = CudaKernel("intersect_any", "intersect_any",
                    [PTR, INT, PTR, INT, INT, PTR])


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
