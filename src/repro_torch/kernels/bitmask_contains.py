"""Bloom signature containment of the gStore-style prefilter: binding of
``csrc/bitmask_contains.cu``.

For candidate signatures cand [C, W] and a query signature query [W], both
32-bit words held as int32 bit patterns:

    ok[c] = 1 iff (query & ~cand[c]) == 0 in every word

The CUDA kernel replaces
``repro.kernels.bitmask_contains.bitmask_contains_pallas``; its plain
version is ``ref.bitmask_contains_ref``.
"""
from __future__ import annotations

import ctypes

import torch

from ._build import INT, PTR, CudaKernel, check_cuda_int32, ptr

KERNEL = CudaKernel("bitmask_contains", "bitmask_contains",
                    [PTR, INT, INT, ctypes.c_longlong, PTR, PTR])


def bitmask_contains_cuda(cand: torch.Tensor,
                          query: torch.Tensor) -> torch.Tensor:
    """ok [C] int32.  cand may be a row slice (``sigs[lo:hi]``) of a
    larger table: the kernel reads from the slice's own address with its
    row stride."""
    check_cuda_int32(query)
    if cand.dim() != 2 or query.shape != cand.shape[1:]:
        raise ValueError("expected cand [C, W] and query [W]")
    if cand.device != query.device or cand.dtype != torch.int32:
        raise TypeError(f"expected int32 cand on {query.device}")
    if cand.shape[1] > 1 and cand.stride(1) != 1:
        raise ValueError("expected the words of a row to be contiguous")
    c, w = cand.shape
    out = torch.empty(c, dtype=torch.int32, device=cand.device)
    if c:
        KERNEL.launch(ptr(cand), c, w, ctypes.c_longlong(cand.stride(0)),
                      ptr(query), ptr(out))
    return out
