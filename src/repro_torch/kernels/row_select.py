"""Row selection of the joins layer: binding of ``csrc/row_select.cu``, and
the plain versions the CPU runs.

A selection keeps the items of an input that pass a predicate, in input
order, and writes them into a [cap, width] int32 table padded with -1:

  edge     the edges (src, dst) with pred == pred_id (any when -1), each
           endpoint passing its spec (a [N] bool mask or a (lo, hi)
           interval), and src == dst for a query self-loop (then src alone);
  distinct the rows [n, k] whose column 0 is valid (>= 0) and whose marked
           column pairs differ (the injective filter);
  masked   the rows r < len(keep) of a [n, k] table with keep[r].

Each is a ``Selection``: its ``total`` is a 0-d count on the device, which
the caller reads once (through ``obs.trace.to_host``) to size the output;
``rows(cap)`` then writes the kept rows.  On CUDA the count is one launch
and ``rows`` one more.  The plain versions compose torch ops (a mask, its
sum, ``compact_indices`` and a gather); the kernel is tested against them.
"""
from __future__ import annotations

import ctypes

import torch

from ._build import INT, PTR, CudaKernel, check_cuda_int32, ptr
from .fused_join import compact_indices

LL = ctypes.c_longlong

# the five entries of csrc/row_select.cu count as launches of one kernel
KERNEL = CudaKernel(
    "row_select", "edge_count",
    [PTR, PTR, PTR, LL, INT, INT, PTR, LL, LL, PTR, LL, LL, PTR],
    entries={"row_count": [PTR, LL, INT, PTR, PTR],
             "mask_count": [PTR, LL, INT, PTR],
             "edge_compact": [PTR, PTR, LL, INT, PTR, LL, PTR],
             "row_compact": [PTR, LL, INT, PTR, LL, PTR]})
MAX_K = 64          # MAX_K of csrc/row_select.cu: columns of a row_count row
MIN_TILE = 512      # the smallest tile of csrc/row_select.cu, in items


class Selection:
    """The items a count pass kept: ``total`` (a 0-d tensor on the input's
    device) and ``rows(cap)``, the kept rows in input order in
    [cap, width] int32, rows from the total on -1 (kept rows past cap are
    cut)."""
    __slots__ = ("total", "_write")

    def __init__(self, total: torch.Tensor, write):
        self.total = total
        self._write = write

    def rows(self, cap: int) -> torch.Tensor:
        return self._write(int(cap))


# ------------------------------ plain ---------------------------------- #
def _pass(spec, ids: torch.Tensor) -> torch.Tensor:
    """Endpoint pass test: a full-[N] bool mask, or a (lo, hi) interval
    pair — wildcard candidate sets stay intervals so no [N] mask is ever
    materialized for them."""
    if isinstance(spec, tuple):
        return (ids >= spec[0]) & (ids < spec[1])
    return spec[ids]


def _gather_kept(rows, keep, cap):
    n = rows.shape[0]
    idx = compact_indices(keep, cap, n)
    safe = torch.clamp(idx, max=n - 1)
    return rows[safe].masked_fill((idx >= n)[:, None], -1)


def edge_select_ref(src, dst, pred, pred_id: int, spec_src, spec_dst,
                    self_loop: bool) -> Selection:
    mask = _pass(spec_src, src) & _pass(spec_dst, dst)
    if pred_id >= 0:
        mask = mask & (pred == pred_id)
    if self_loop:
        mask = mask & (src == dst)
    e = src.shape[0]

    def write(cap):
        idx = compact_indices(mask, cap, e)
        safe = torch.clamp(idx, max=e - 1)
        pad = (idx >= e)[:, None]
        if self_loop:
            return src[safe][:, None].masked_fill(pad, -1)
        return torch.stack([src[safe], dst[safe]], dim=1).masked_fill(pad, -1)
    return Selection(mask.sum(), write)


def distinct_select_ref(rows, pairs) -> Selection:
    keep = rows[:, 0] >= 0                  # padding rows never survive
    for i, j in pairs:
        keep &= rows[:, i] != rows[:, j]
    return Selection(keep.sum(), lambda cap: _gather_kept(rows, keep, cap))


def masked_select_ref(rows, keep) -> Selection:
    n = keep.shape[0]
    if n != rows.shape[0]:
        keep = torch.cat([keep, torch.zeros(rows.shape[0] - n,
                                            dtype=torch.bool,
                                            device=keep.device)])
    return Selection(keep.sum(), lambda cap: _gather_kept(rows, keep, cap))


# ------------------------------- CUDA ---------------------------------- #
def _scratch(n: int, device) -> torch.Tensor:
    # [total, ticket, ceil(n / 32) bitmap words, one offset a tile]
    return torch.empty(2 + (n + 31) // 32 + max(1, -(-n // MIN_TILE)),
                       dtype=torch.int32, device=device)


def _spec_args(spec, device):
    """(mask pointer, lo, hi) of an endpoint spec: a null mask takes the
    interval."""
    if isinstance(spec, tuple):
        return PTR(None), LL(int(spec[0])), LL(int(spec[1]))
    if spec.device != device or spec.dtype != torch.bool \
            or spec.dim() != 1 or not spec.is_contiguous():
        raise ValueError(f"expected a contiguous [N] bool mask on {device}, "
                         f"got {spec.dtype} {tuple(spec.shape)} on "
                         f"{spec.device}")
    return ptr(spec), LL(0), LL(0)


def edge_select_cuda(src, dst, pred, pred_id: int, spec_src, spec_dst,
                     self_loop: bool) -> Selection:
    check_cuda_int32(src, dst, pred)
    n = src.shape[0]
    if dst.shape != (n,) or pred.shape != (n,):
        raise ValueError("expected src, dst and pred of one length")
    ms, lo_s, hi_s = _spec_args(spec_src, src.device)
    md, lo_d, hi_d = _spec_args(spec_dst, src.device)
    scratch = _scratch(n, src.device)
    KERNEL.launch(ptr(src), ptr(dst), ptr(pred), LL(n), int(pred_id),
                  int(self_loop), ms, lo_s, hi_s, md, lo_d, hi_d,
                  ptr(scratch), symbol="edge_count")
    width = 1 if self_loop else 2

    def write(cap):
        out = torch.empty((cap, width), dtype=torch.int32, device=src.device)
        KERNEL.launch(ptr(src), ptr(dst), LL(n), width, ptr(scratch), LL(cap),
                      ptr(out), symbol="edge_compact")
        return out
    return Selection(scratch[0], write)


def _rows_selection(rows, n, scratch) -> Selection:
    k = rows.shape[1]

    def write(cap):
        out = torch.empty((cap, k), dtype=torch.int32, device=rows.device)
        KERNEL.launch(ptr(rows), LL(n), k, ptr(scratch), LL(cap), ptr(out),
                      symbol="row_compact")
        return out
    return Selection(scratch[0], write)


def _check_rows(rows):
    check_cuda_int32(rows)
    if rows.dim() != 2 or rows.shape[1] < 1:
        raise ValueError(f"expected rows [n, k >= 1], got {tuple(rows.shape)}")


def distinct_select_cuda(rows, pairs) -> Selection:
    _check_rows(rows)
    n, k = rows.shape
    if k > MAX_K:
        raise ValueError(f"expected at most {MAX_K} columns, got {k}")
    masks = [0] * k
    for i, j in pairs:
        if not 0 <= i < j < k:
            raise ValueError(f"expected column pairs i < j of rows [n, {k}], "
                             f"got {(i, j)}")
        masks[i] |= 1 << j
    words = (ctypes.c_ulonglong * k)(*masks)
    scratch = _scratch(n, rows.device)
    KERNEL.launch(ptr(rows), LL(n), k, ctypes.cast(words, PTR), ptr(scratch),
                  symbol="row_count")
    return _rows_selection(rows, n, scratch)


def masked_select_cuda(rows, keep) -> Selection:
    _check_rows(rows)
    n = keep.shape[0]
    if keep.device != rows.device or keep.dtype != torch.bool \
            or keep.dim() != 1 or not keep.is_contiguous() \
            or n > rows.shape[0]:
        raise ValueError(f"expected a contiguous bool mask of at most "
                         f"{rows.shape[0]} entries on {rows.device}")
    scratch = _scratch(n, rows.device)
    KERNEL.launch(ptr(keep), LL(n), rows.shape[1], ptr(scratch),
                  symbol="mask_count")
    return _rows_selection(rows, n, scratch)
