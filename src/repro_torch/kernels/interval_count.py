"""Gather + interval count of the neighborhood check (paper Alg. 1):
binding of ``csrc/interval_count.cu``.

For the NI tensor ids [N, cap] (rows ascending, -1 padded at the tail),
candidate node ids cands [C] and keyword intervals lo, hi [J]:

    counts[c, j] = #{b < lens[cands[c]] : lo[j] <= ids[cands[c], b] < hi[j]}

with the gather fused into the kernel.  ``lens`` [N] (optional) is each
row's stored length, ``min(count, cap)`` of the NI entry: the kernel then
searches only that prefix.  Without it the whole row is searched.  The CUDA kernel replaces
``repro.kernels.interval_count.interval_count_pallas`` together with the
gather of ``repro.core.signature._gather_count``; its plain version is
``ref.interval_count_gather_ref``.
"""
from __future__ import annotations

import torch

from ._build import INT, PTR, CudaKernel, check_cuda_int32, ptr

KERNEL = CudaKernel("interval_count", "interval_count",
                    [PTR, INT, PTR, PTR, INT, PTR, PTR, INT, PTR])


def interval_count_cuda(ids: torch.Tensor, cands: torch.Tensor,
                        lo: torch.Tensor, hi: torch.Tensor,
                        lens: torch.Tensor | None = None) -> torch.Tensor:
    """counts [C, J] int32.  Every cands entry must index a row of ids;
    lens, when given, is [N] with each row's stored length."""
    check_cuda_int32(ids, cands, lo, hi,
                     *(() if lens is None else (lens,)))
    if ids.dim() != 2 or lo.shape != hi.shape:
        raise ValueError("expected ids [N, cap] and lo, hi of one shape")
    if lens is not None and lens.shape != ids.shape[:1]:
        raise ValueError("expected lens [N] beside ids [N, cap]")
    c, j = cands.shape[0], lo.shape[0]
    out = torch.empty((c, j), dtype=torch.int32, device=ids.device)
    if c and j:
        KERNEL.launch(ptr(ids), ids.shape[1],
                      PTR(None) if lens is None else ptr(lens),
                      ptr(cands), c, ptr(lo), ptr(hi), j, ptr(out))
    return out
