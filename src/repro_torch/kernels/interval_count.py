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
every (direction, distance) segment (``ref.CheckSegment``).  Its output is
the verdict, one byte per candidate, written in place into a given pass
mask row, and the passes and the passes with an overflowed row, added to
a counter pair on the device.  The segments' bounds
and needs (``check_words``) come packed in one device buffer, so a
template's nodes share one upload.  Its plain version is
``ref.interval_check_ref``.  Both entry points count as launches of
``KERNEL``.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from ._build import INT, PTR, CudaKernel, check_cuda_int32, ptr, upload
from .ref import CheckSegment

KERNEL = CudaKernel("interval_count", "interval_count",
                    [PTR, INT, PTR, PTR, INT, PTR, PTR, INT, PTR],
                    entries={"interval_check":
                             [PTR, INT, INT, PTR, INT, INT, PTR, PTR]})

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


def check_words(segments) -> np.ndarray:
    """The int32 words the node check reads of its segments, in order: a
    segment's lo[J], hi[J], then need[J] where it has one."""
    parts = [p for seg in segments
             for p in (seg.lo, seg.hi, *(() if seg.need is None
                                         else (seg.need,)))]
    return np.concatenate([np.asarray(p, dtype=np.int64)
                           for p in parts]).astype(np.int32)


def _mask_view(out, lo: int, hi: int, dev) -> torch.Tensor:
    """out[lo:hi] of a [N] pass mask row, or a new [hi - lo] verdict."""
    if out is None:
        return torch.empty(hi - lo, dtype=torch.bool, device=dev)
    if out.device != dev or out.dtype != torch.bool or out.dim() != 1 \
            or not out.is_contiguous() or out.shape[0] < hi:
        raise ValueError(f"expected a contiguous [N >= {hi}] bool row on "
                         f"{dev}, got {out.dtype} {tuple(out.shape)} on "
                         f"{out.device}")
    return out[lo:hi]


def interval_check_cuda(segments: list[CheckSegment], lo: int, hi: int, *,
                        out: torch.Tensor | None = None,
                        tally: torch.Tensor | None = None,
                        data: torch.Tensor | None = None,
                        data_at: int = 0) -> torch.Tensor:
    """ok [hi - lo] bool on the segments' device: the verdict of
    ``ref.interval_check_ref`` in one launch.  Every segment's tensors lie
    on one CUDA device; candidates lo..hi-1 index rows of each entry.

    out: a [N] bool pass mask row; the verdict goes to out[lo:hi], which is
    returned, and the rest of the row is not touched.  tally: two int32
    counters on the device, to which the launch adds the candidates that
    passed and those that passed with an overflowed row in any segment
    (without it, two counters of the call's own).
    data, data_at: a device int32 buffer holding ``check_words(segments)``
    from word data_at on; without it the words are uploaded here."""
    dev = segments[0].ids.device
    if len(segments) > MAX_SEGMENTS:
        raise ValueError(f"at most {MAX_SEGMENTS} segments a launch, got "
                         f"{len(segments)}")
    header, at = [], data_at if data is not None else 0
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
        j = len(seg.lo)
        header += [seg.ids.data_ptr(),
                   0 if seg.lens is None else seg.lens.data_ptr(),
                   seg.overflow.data_ptr(), seg.ids.shape[1], flags, j, at,
                   0]
        at += (2 + (seg.need is not None)) * j
    if data is None:
        data = upload(check_words(segments), dev)
    elif data.device != dev or data.dtype != torch.int32 \
            or data.dim() != 1 or data.shape[0] < at:
        raise ValueError(f"expected int32 data of at least {at} words on "
                         f"{dev}")
    if tally is None:
        tally = torch.zeros(2, dtype=torch.int32, device=dev)
    check_cuda_int32(tally)
    if tally.device != dev or tally.numel() < 2:
        raise ValueError("expected two int32 counters on the device")
    hdr = (ctypes.c_longlong * len(header))(*header)
    ok = _mask_view(out, lo, hi, dev)
    if hi > lo:
        KERNEL.launch(ctypes.cast(hdr, PTR), len(segments),
                      max(len(s.lo) for s in segments), ptr(data), lo,
                      hi - lo, ptr(ok), ptr(tally), symbol="interval_check")
    return ok
