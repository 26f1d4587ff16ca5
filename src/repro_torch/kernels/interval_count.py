"""Gather + interval count of the neighborhood check (paper Alg. 1), and
the whole check of one query node: bindings of ``csrc/interval_count.cu``.

For the NI tensor ids [N, cap] (rows ascending, -1 padded at the tail),
candidate node ids cands [C] and keyword intervals lo, hi [J]:

    counts[c, j] = #{b < lens[cands[c]] : lo[j] <= ids[cands[c], b] < hi[j]}

with the gather fused into the kernel.  ``lens`` [N] (optional) is each
row's stored length, ``min(count, cap)`` of the NI entry: the kernel then
searches only that prefix.  Without it the whole row is searched.  The CUDA kernel replaces
``repro.kernels.interval_count.interval_count_pallas`` together with the
gather of ``repro.core.signature._gather_count``; its plain version is
``ref.interval_count_gather_ref``.

``interval_check_cuda`` runs the check of one query node in one launch of
the same source: every candidate of the contiguous range lo..hi-1 against
every (direction, distance) segment (``ref.CheckSegment``), with the
verdict, one byte per candidate, as its only output.  Its plain version is
``ref.interval_check_ref``.  Both entry points count as launches of
``KERNEL``.
"""
from __future__ import annotations

import ctypes

import torch

from ._build import INT, PTR, CudaKernel, check_cuda_int32, ptr
from .ref import CheckSegment

KERNEL = CudaKernel("interval_count", "interval_count",
                    [PTR, INT, PTR, PTR, INT, PTR, PTR, INT, PTR],
                    entries={"interval_check":
                             [PTR, INT, INT, PTR, INT, INT, PTR]})

# csrc/interval_count.cu: segments per launch, and their flags
MAX_SEGMENTS = 16
_FIRST, _CHECK = 1, 2


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


def interval_check_cuda(segments: list[CheckSegment], lo: int,
                        hi: int) -> torch.Tensor:
    """ok [hi - lo] bool on the segments' device: the verdict of
    ``ref.interval_check_ref`` in one launch.  Every segment's tensors lie
    on one CUDA device; candidates lo..hi-1 index rows of each entry."""
    dev = segments[0].ids.device
    if len(segments) > MAX_SEGMENTS:
        raise ValueError(f"at most {MAX_SEGMENTS} segments a launch, got "
                         f"{len(segments)}")
    header, data = [], []
    for seg in segments:
        check_cuda_int32(seg.ids, *(() if seg.lens is None else (seg.lens,)))
        n = seg.ids.shape[0]
        if seg.ids.device != dev or seg.overflow.device != dev:
            raise ValueError("expected every segment on one CUDA device")
        if seg.ids.dim() != 2 or seg.overflow.shape != (n,) \
                or seg.overflow.dtype not in (torch.bool, torch.uint8) \
                or not seg.overflow.is_contiguous() \
                or (seg.lens is not None and seg.lens.shape != (n,)):
            raise ValueError("expected ids [N, cap], lens [N] int32 and "
                             "overflow [N] bool")
        if not 0 <= lo <= hi <= n:
            raise ValueError(f"candidates {lo}..{hi} outside the {n} rows")
        flags = _FIRST * bool(seg.first) + _CHECK * (seg.need is not None)
        header += [seg.ids.data_ptr(),
                   0 if seg.lens is None else seg.lens.data_ptr(),
                   seg.overflow.data_ptr(), seg.ids.shape[1], flags,
                   len(seg.lo), len(data), 0]
        data += [*map(int, seg.lo), *map(int, seg.hi),
                 *(() if seg.need is None else map(int, seg.need))]
    hdr = (ctypes.c_longlong * len(header))(*header)
    data_dev = torch.tensor(data, dtype=torch.int32).to(dev)
    ok = torch.empty(hi - lo, dtype=torch.uint8, device=dev)
    if hi > lo:
        KERNEL.launch(ctypes.cast(hdr, PTR), len(segments),
                      max(len(s.lo) for s in segments), ptr(data_dev), lo,
                      hi - lo, ptr(ok), symbol="interval_check")
    return ok.view(torch.bool)
