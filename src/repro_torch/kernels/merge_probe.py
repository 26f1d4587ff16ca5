"""Merge probe of the sort-merge join: binding of ``csrc/merge_probe.cu``.

For ascending int32 key arrays a and b (the packed join keys of both
sides, invalid rows carrying the per-side sentinels), every a-key gets the
half-open range of equal b-keys:

    start[i] = #{j : b[j] <  a[i]}     (== searchsorted left)
    cnt[i]   = #{j : b[j] == a[i]}     (== right - left)

The CUDA source replaces ``repro.kernels.merge_probe.merge_probe_pallas``
with a merge-path kernel, and runs a bisection kernel (one thread per
a-key, two binary searches of b) for probes below ``BISECT_BELOW``
merged items; one launch either way, one launch counter.  The plain
version is ``ref.merge_probe_sorted``; ``ops.merge_probe`` dispatches
between the kernels and it by device.
"""
from __future__ import annotations

import torch

from ._build import INT, PTR, CudaKernel, check_cuda_int32, ptr

KERNEL = CudaKernel("merge_probe", "merge_probe",
                    [PTR, INT, PTR, INT, PTR, PTR, INT])

# the kernels of the source: the merge path, and the bisection kernel
# that a launch below BISECT_BELOW merged items (na + nb) runs instead
METHODS = {"path": 1, "bisect": 2}
BISECT_BELOW = 1 << 13


def merge_probe_cuda(a_keys: torch.Tensor, b_keys: torch.Tensor,
                     method: str | None = None):
    """(start [A], cnt [A]) int32 for contiguous int32 CUDA key arrays.
    method: "path" or "bisect" forces a kernel (to hold and time each
    against the other); None chooses by size."""
    check_cuda_int32(a_keys, b_keys)
    na, nb = a_keys.shape[0], b_keys.shape[0]
    if method is None:
        method = "bisect" if na + nb < BISECT_BELOW else "path"
    code = METHODS[method]
    start = torch.empty(na, dtype=torch.int32, device=a_keys.device)
    cnt = torch.empty(na, dtype=torch.int32, device=a_keys.device)
    if na:
        KERNEL.launch(ptr(a_keys), na, ptr(b_keys), nb, ptr(start), ptr(cnt),
                      code)
    return start, cnt
