"""Merge probe of the sort-merge join: binding of ``csrc/merge_probe.cu``.

For ascending int32 key arrays a and b (the packed join keys of both
sides, invalid rows carrying the per-side sentinels), every a-key gets the
half-open range of equal b-keys:

    start[i] = #{j : b[j] <  a[i]}     (== searchsorted left)
    cnt[i]   = #{j : b[j] == a[i]}     (== right - left)

The CUDA kernel replaces ``repro.kernels.merge_probe.merge_probe_pallas``;
its plain version is ``ref.merge_probe_sorted``.  ``ops.merge_probe``
dispatches between them by device.
"""
from __future__ import annotations

import torch

from ._build import INT, PTR, CudaKernel, check_cuda_int32, ptr

KERNEL = CudaKernel("merge_probe", "merge_probe",
                    [PTR, INT, PTR, INT, PTR, PTR])


def merge_probe_cuda(a_keys: torch.Tensor, b_keys: torch.Tensor):
    """(start [A], cnt [A]) int32 for contiguous int32 CUDA key arrays."""
    check_cuda_int32(a_keys, b_keys)
    na, nb = a_keys.shape[0], b_keys.shape[0]
    start = torch.empty(na, dtype=torch.int32, device=a_keys.device)
    cnt = torch.empty(na, dtype=torch.int32, device=a_keys.device)
    if na:
        KERNEL.launch(ptr(a_keys), na, ptr(b_keys), nb, ptr(start), ptr(cnt))
    return start, cnt
